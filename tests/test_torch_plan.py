"""The port's planner (``autodist_tpu_torch/plan``) against the JAX
package's (``tests/test_plan.py``'s cases, each held to JAX where both
packages answer the same question).

- **Search**: under ``helpers/torch_auto.py``'s equal constants and its
  seeded slates (RandomAxisPartitionAR draws from a seed on both sides),
  seed for seed the port's beam search visits as many candidates as JAX's,
  its winner's Strategy JSON equals JAX's (device names aside) and every
  ``StrategyCost`` field matches to 1e-9, with the same provenance (seed
  table, best seed, winner origin, trajectory, bucket sizes, mesh
  recommendation), for the zoo at small widths on one node of 8, four
  nodes of 4 and a {data 2, model 4} mesh; so does a calibrated search. The
  genome projections of every slate member are JAX's. ``TestSearch``'s own
  cases (winner never worse than the lossless slate, determinism, complete
  provenance, no data-1 mesh recommendation) run on the port.
- **Calibration**: the component fit, the scalar fallback (one point, few
  points), direct attribution, ``prediction_error``, the keep-best refit of
  ``calibrate_from_records`` and the files it writes equal JAX's on the
  same records; ``topology_key`` names the card; save/load round trips.
- **Cache**: a hit with zero search, each kind of miss (shapes, resources,
  version), the corrupt-entry fallback (loud, never fatal), the dry-run
  rejection of a drifted plan (a one-GPU spec, which this process holds),
  the skipped dry run counted as not validated; model fingerprints equal
  JAX's.
- **Wiring**: ``AutoDist(strategy_builder="plan")``, the Plan-built step
  trains on the CPU and its first loss equals JAX's Plan-built step's on
  parameters carried over with ``params_from_jax``; ``explain_provenance``
  renders JAX's lines from the same provenance; ``record_from_profiler``
  and ``record_from_attribution`` equal JAX's; ``tune(device="cpu")``
  returns a ``plan_calibration``; the ``--selftest`` CLI.
"""
import dataclasses
import hashlib
import importlib
import io
import json
import logging as pylogging
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from autodist_tpu import model_item as jmi
from autodist_tpu import plan as jplan
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import cost_model as jcm
from autodist_tpu.strategy import explain as jexplain
from autodist_tpu_torch import api as tapi
from autodist_tpu_torch import const
from autodist_tpu_torch import plan
from autodist_tpu_torch.model_item import ModelItem, OptimizerSpec
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.models.convert import params_from_jax
from autodist_tpu_torch.plan import calibrate as tcal
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import AllReduce, CostModel, PSLoadBalancing, Zero1
from autodist_tpu_torch.strategy.cost_model import candidate_slate
from autodist_tpu_torch.strategy import cost_model as tcm
from autodist_tpu_torch.strategy import explain as texplain
from helpers import torch_auto as ta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_SHAPES = {"w1": (64, 64), "w2": (64, 32), "b": (64,)}
COST_FIELDS = [f.name for f in dataclasses.fields(tcm.StrategyCost)]

JSEARCH = importlib.import_module("autodist_tpu.plan.search")
TSEARCH = importlib.import_module("autodist_tpu_torch.plan.search")


def _item(shapes, opt="sgd"):
    params = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    return ModelItem.from_params(params_from_jax(params, device="cpu"),
                                 optimizer_spec=OptimizerSpec(opt))


def _spec(gpus=8, **extra):
    return ResourceSpec(resource_dict={
        "nodes": [{"address": "localhost", "gpus": gpus, "chief": True}], **extra})


def _json(strategy, tpu_to_gpu=False):
    d = strategy.to_json()
    d["id"] = d["path"] = ""
    text = json.dumps(d)
    return json.loads(text.replace(":TPU:", ":GPU:") if tpu_to_gpu else text)


@pytest.fixture
def seeded_slates(monkeypatch):
    """Both searches seeded from ``ta.slates()`` (fresh builders a call)."""
    monkeypatch.setattr(JSEARCH, "candidate_slate", lambda *a, **kw: ta.slates()[0])
    monkeypatch.setattr(TSEARCH, "candidate_slate", lambda *a, **kw: ta.slates()[1])


def _assert_costs_equal(tc, jc, what=""):
    for f in COST_FIELDS:
        np.testing.assert_allclose(getattr(tc, f), getattr(jc, f), rtol=1e-9, atol=0,
                                   err_msg=f"{what} {f}")
    assert tc.feasible == jc.feasible


def _assert_provenance_equal(tp, jp):
    for key in ("n_visited", "beam_width", "generations", "search_seed", "best_seed",
                "bucket_sizes_visited", "screen_rejected"):
        assert tp[key] == jp[key], key
    assert sorted(tp["seeds"]) == sorted(jp["seeds"])
    for name, row in jp["seeds"].items():
        assert tp["seeds"][name]["feasible"] == row["feasible"], name
        for k in ("predicted_s", "per_chip_gb"):
            assert tp["seeds"][name][k] == pytest.approx(row[k], rel=1e-9), (name, k)
    for k, v in jp["winner"].items():
        if isinstance(v, float):
            assert tp["winner"][k] == pytest.approx(v, rel=1e-9), k
        else:
            assert tp["winner"][k] == v, k
    assert tp["improvement_vs_best_seed"] == pytest.approx(jp["improvement_vs_best_seed"],
                                                           rel=1e-9, abs=1e-12)
    assert [(t["generation"], t["visited"]) for t in tp["trajectory"]] == \
        [(t["generation"], t["visited"]) for t in jp["trajectory"]]
    for t, j in zip(tp["trajectory"], jp["trajectory"]):
        assert t["best_predicted_s"] == pytest.approx(j["best_predicted_s"], rel=1e-9)
    assert tp["why"] == jp["why"]
    if "mesh" in jp:
        assert tp["mesh"]["chosen"] == jp["mesh"]["chosen"]
        assert tp["mesh"]["current"] == jp["mesh"]["current"]
        assert sorted(tp["mesh"]["candidates"]) == sorted(jp["mesh"]["candidates"])


# ---------------------------------------------------------------------- search
@pytest.mark.parametrize("mesh", sorted(ta.MESHES))
@pytest.mark.parametrize("model", sorted(ta.ZOO))
def test_search_equals_jax(model, mesh, seeded_slates):
    jitem, titem = ta.items(model)
    jrs, trs = ta.specs(mesh)
    for seed in (0, 3):
        jr = JSEARCH.PlanSearch(jitem, jrs, JSEARCH.SearchConfig(seed=seed,
                                                                 search_mesh=True)).run()
        tr = TSEARCH.PlanSearch(titem, trs, TSEARCH.SearchConfig(seed=seed,
                                                                 search_mesh=True)).run()
        assert tr.n_visited == jr.n_visited, seed
        assert _json(tr.strategy) == _json(jr.strategy, tpu_to_gpu=True), seed
        _assert_costs_equal(tr.cost, jr.cost, f"{model} {mesh} {seed}")
        assert [dataclasses.astuple(g) for g in tr.genome.genes] == \
            [dataclasses.astuple(g) for g in jr.genome.genes]
        assert tr.genome.bucket_bytes == jr.genome.bucket_bytes
        _assert_provenance_equal(tr.provenance, jr.provenance)


@pytest.mark.parametrize("model", ["bert_base", "resnet", "ncf"])
def test_calibrated_search_equals_jax(model, seeded_slates):
    """The same calibration (fitted by each package from the same records)
    steers both searches to the same winner at the same calibrated cost."""
    jitem, titem = ta.items(model)
    jrs, trs = ta.specs("4x4")
    jm = jcm.CostModel(jitem, jrs)
    jrecs = []
    for i, (name, b) in enumerate(ta.slates()[0]):
        cost = jm.strategy_cost(b.build(jitem, jrs))
        measured = 4e-3 + 3.0 * cost.comm_s + 0.5 * cost.update_s + 2.0 * cost.latency_s
        jrecs.append(jplan.CalibrationRecord.from_cost(cost, measured * (1 + 0.01 * (i % 3)),
                                                       name=name))
    trecs = [plan.CalibrationRecord.from_json(r.to_json()) for r in jrecs]
    jc = jplan.TopologyCalibration.fit(jrecs, device="d", topology="t")
    tc = plan.TopologyCalibration.fit(trecs, device="d", topology="t")
    jr = JSEARCH.PlanSearch(jitem, jrs, calibration=jc).run()
    tr = TSEARCH.PlanSearch(titem, trs, calibration=tc).run()
    assert tr.n_visited == jr.n_visited
    assert _json(tr.strategy) == _json(jr.strategy, tpu_to_gpu=True)
    _assert_costs_equal(tr.cost, jr.cost, model)
    tcal_, jcal_ = tr.provenance["calibration"], jr.provenance["calibration"]
    assert tcal_["predicted_calibrated_s"] == pytest.approx(
        jcal_["predicted_calibrated_s"], rel=1e-9)
    assert tcal_["n_points"] == jcal_["n_points"]


@pytest.mark.parametrize("model", sorted(ta.ZOO))
def test_genome_projection_equals_jax(model):
    """Every slate member projects onto JAX's genome and renders back to a
    Strategy whose nodes validate against the model."""
    jitem, titem = ta.items(model)
    jrs, trs = ta.specs("data2xmodel4")
    for (name, jb), (_, tb) in zip(*ta.slates()):
        jg = jplan.strategy_to_genome(jb.build(jitem, jrs), jitem, jrs)
        tg = plan.strategy_to_genome(tb.build(titem, trs), titem, trs)
        assert [dataclasses.astuple(g) for g in tg] == [dataclasses.astuple(g) for g in jg], name
        assert tg.bucket_bytes == jg.bucket_bytes
        rendered = plan.genome_to_strategy(tg, titem, trs)
        assert _json(rendered) == _json(jplan.genome_to_strategy(jg, jitem, jrs),
                                        tpu_to_gpu=True), name
        for node in rendered.node_config:
            node.validate_against_shape(titem.var(node.var_name).shape)


def test_genome_roundtrip_through_slate():
    item, spec = _item(DEFAULT_SHAPES), _spec()
    for name, builder in candidate_slate(full=True):
        strategy = builder.build(item, spec)
        rendered = plan.genome_to_strategy(plan.strategy_to_genome(strategy, item, spec),
                                           item, spec)
        assert len(rendered.node_config) == len(item.trainable_variables), name
        for node in rendered.node_config:
            node.validate_against_shape(item.var(node.var_name).shape)


def test_winner_never_worse_than_lossless_slate():
    from autodist_tpu_torch.kernel.compressor import is_active_compressor
    from autodist_tpu_torch.strategy.ir import iter_synchronizers

    item, spec = _item(DEFAULT_SHAPES, opt="adam"), _spec()
    result = plan.PlanSearch(item, spec, plan.SearchConfig(seed=3)).run()
    cm = CostModel(item, spec)
    for name, builder in candidate_slate(full=True):
        built = builder.build(item, spec)
        if any(is_active_compressor(getattr(s, "compressor", "") or "")
               for n in built.node_config for s in iter_synchronizers(n)):
            continue
        assert result.cost.total_s <= cm.strategy_cost(built).total_s * (1 + 1e-9), name


def test_search_is_deterministic_for_a_seed():
    item, spec = _item(DEFAULT_SHAPES), _spec()
    r1 = plan.PlanSearch(item, spec, plan.SearchConfig(seed=11)).run()
    r2 = plan.PlanSearch(item, spec, plan.SearchConfig(seed=11)).run()
    assert r1.genome == r2.genome and r1.cost.total_s == r2.cost.total_s


def test_provenance_is_json_serializable_and_complete():
    item, spec = _item(DEFAULT_SHAPES), _spec()
    result = plan.PlanSearch(item, spec, plan.SearchConfig(search_mesh=True)).run()
    prov = json.loads(json.dumps(result.provenance))
    for key in ("n_visited", "seeds", "best_seed", "winner", "trajectory", "why", "mesh"):
        assert key in prov, key
    assert prov["n_visited"] >= 20


def test_mesh_sweep_never_recommends_trivial_data_axis():
    item, spec = _item(DEFAULT_SHAPES), _spec(gpus=8)
    result = plan.PlanSearch(item, spec, plan.SearchConfig(search_mesh=True)).run()
    assert result.provenance["mesh"]["candidates"]
    for label in result.provenance["mesh"]["candidates"]:
        assert "data=1," not in label


# ----------------------------------------------------------------- calibrate
def _records(model="bert_base", mesh="4x4", truth=None, n=None):
    """(JAX records, port records) of the seeded slate's costs against a
    measured time from ``truth``; the port's built from its own cost model
    (equal to JAX's to 1e-9)."""
    truth = truth or {"base": 3e-3, "comm_s": 1.8, "update_s": 1.25, "latency_s": 1.0,
                      "act_sync_s": 1.0, "gather_s": 1.5}
    jitem, titem = ta.items(model)
    jrs, trs = ta.specs(mesh)
    jm, tm = jcm.CostModel(jitem, jrs), CostModel(titem, trs)
    out = ([], [])
    for i, ((name, jb), (_, tb)) in enumerate(zip(*ta.slates())):
        jc, tc = jm.strategy_cost(jb.build(jitem, jrs)), tm.strategy_cost(tb.build(titem, trs))
        for mod, cost, recs in ((jplan, jc, out[0]), (plan, tc, out[1])):
            measured = truth["base"] + sum(v * getattr(cost, k) for k, v in truth.items()
                                           if k != "base")
            recs.append(mod.CalibrationRecord.from_cost(
                cost, measured * (1.0 + 0.01 * ((i % 3) - 1)), name=name))
    return (out[0][:n], out[1][:n]) if n else out


def _assert_calibrations_equal(tc, jc):
    assert set(tc.coefficients) == set(jc.coefficients)
    for k, v in jc.coefficients.items():
        assert tc.coefficients[k] == pytest.approx(v, rel=1e-7, abs=1e-12), k
    assert tc.base_s == pytest.approx(jc.base_s, rel=1e-7, abs=1e-15)
    assert tc.n_points == jc.n_points and tc.topology == jc.topology
    for k in ("error_before", "error_after"):
        a, b = getattr(tc, k), getattr(jc, k)
        assert (math.isnan(a) and math.isnan(b)) or a == pytest.approx(b, rel=1e-7, abs=1e-12)


@pytest.mark.parametrize("case", ["component", "scalar_few", "single", "direct",
                                  "direct_only", "noisy_negative"])
def test_fit_equals_jax(case):
    jrecs, trecs = _records()
    if case == "scalar_few":
        jrecs, trecs = jrecs[:4], trecs[:4]
    elif case == "single":
        jrecs, trecs = jrecs[:1], trecs[:1]
    elif case in ("direct", "direct_only"):
        if case == "direct_only":
            jrecs, trecs = jrecs[:3], trecs[:3]
        for j, t in zip(jrecs, trecs):
            j.measured_components = t.measured_components = {"comm_s": 0.7 * j.comm_s}
    elif case == "noisy_negative":
        # A measured time that falls as the wire grows: the component fit
        # is rejected for the scalar form.
        for j, t in zip(jrecs, trecs):
            j.measured_s = t.measured_s = max(1e-3, 0.05 - 5.0 * j.comm_s)
    # Identical inputs to the fit: the port's records from JAX's JSON.
    trecs_same = [plan.CalibrationRecord.from_json(r.to_json()) for r in jrecs]
    jc = jplan.TopologyCalibration.fit(jrecs, device="dev", topology="topo")
    tc = plan.TopologyCalibration.fit(trecs_same, device="dev", topology="topo")
    _assert_calibrations_equal(tc, jc)
    # ... and from the port's own costs, equal to JAX's to 1e-9.
    _assert_calibrations_equal(plan.TopologyCalibration.fit(trecs, device="dev",
                                                            topology="topo"), jc)
    assert plan.prediction_error(trecs_same, tc) == pytest.approx(
        jplan.prediction_error(jrecs, jc), rel=1e-9, abs=1e-15)
    assert plan.prediction_error(trecs_same, None) == pytest.approx(
        jplan.prediction_error(jrecs, None), rel=1e-12)
    if case == "component":
        assert tc.error_after < tc.error_before and tc.base_s > 0
    if case == "single":
        assert tc.predict_s(trecs[0]) == pytest.approx(trecs[0].measured_s)


def test_fit_reduces_error_on_replayed_profile():
    item, spec = _item(DEFAULT_SHAPES, opt="adam"), _spec()
    truth = {"base": 3e-3, "comm_s": 1.8, "update_s": 1.25, "latency_s": 1.0,
             "act_sync_s": 1.0}
    cm = CostModel(item, spec)
    records = []
    for i, (name, builder) in enumerate(candidate_slate(full=True)):
        cost = cm.strategy_cost(builder.build(item, spec))
        measured = truth["base"] + sum(truth[k] * getattr(cost, k) for k in truth
                                       if k != "base")
        records.append(plan.CalibrationRecord.from_cost(
            cost, measured * (1.0 + 0.01 * ((i % 3) - 1)), name=name))
    calib = plan.TopologyCalibration.fit(records)
    after = plan.prediction_error(records, calib)
    assert after < plan.prediction_error(records, None)
    assert calib.error_after == after and calib.base_s > 0


def test_save_load_roundtrip_and_files_equal_jax(tmp_path):
    jrecs, _ = _records()
    trecs = [plan.CalibrationRecord.from_json(r.to_json()) for r in jrecs]
    jc = jplan.TopologyCalibration.fit(jrecs, device="test", topology="t8")
    tc = plan.TopologyCalibration.fit(trecs, device="test", topology="t8")
    jpath = jc.save(str(tmp_path / "j" / "c.json"), records=jrecs)
    tpath = tc.save(str(tmp_path / "t" / "c.json"), records=trecs)
    loaded = plan.TopologyCalibration.load(tpath)
    assert loaded.coefficients == tc.coefficients and loaded.n_points == tc.n_points
    assert len(tcal.load_records(tpath)) == len(trecs)
    # Each package reads the other's file as its own.
    _assert_calibrations_equal(plan.TopologyCalibration.load(jpath), jc)
    _assert_calibrations_equal(jplan.TopologyCalibration.load(tpath), jc)
    with open(jpath) as f, open(tpath) as g:
        jdoc, tdoc = json.load(f), json.load(g)
    assert jdoc["records"] == tdoc["records"] and sorted(jdoc) == sorted(tdoc)


def test_corrupt_calibration_file_degrades_to_none(tmp_path):
    path = tmp_path / "c.json"
    path.write_text("{not json")
    assert plan.TopologyCalibration.load(str(path)) is None
    assert tcal.load_records(str(path)) == []


def test_topology_key_equals_jax_and_names_the_card():
    for chips, mesh in ((8, None), (4, None), (8, {"data": 4, "model": 2})):
        extra = {"mesh": mesh} if mesh else {}
        node = [{"address": "localhost", "chips": chips, "chief": True}]
        jrs = JResourceSpec(resource_dict={"nodes": node, **extra})
        trs = ResourceSpec(resource_dict={"nodes": node, **extra})
        for kind in ("TPU v5e", "NVIDIA H100 80GB HBM3"):
            assert plan.topology_key(trs, kind) == jplan.topology_key(jrs, kind)
    keys = {plan.topology_key(_spec(gpus=8), "x"), plan.topology_key(_spec(gpus=4), "x"),
            plan.topology_key(_spec(gpus=8, mesh={"data": 4, "model": 2}), "x")}
    assert len(keys) == 3
    # Without a runtime name the spec's card names the topology.
    card = _spec(gpus=1, gpu={"device": "NVIDIA H100 80GB HBM3"})
    assert plan.topology_key(card) == "nvidia_h100_80gb_hbm3-c1-1"
    assert plan.topology_key(_spec(gpus=1)) == "unknown-c1-1"


def test_scalar_fallback_on_few_points():
    item, spec = _item(DEFAULT_SHAPES), _spec()
    cost = CostModel(item, spec).strategy_cost(AllReduce().build(item, spec))
    calib = plan.TopologyCalibration.fit([plan.CalibrationRecord.from_cost(
        cost, cost.total_s + 1e-3)])
    assert calib.predict_s(cost) == pytest.approx(cost.total_s + 1e-3)


def test_calibrate_from_records_keep_best_equals_jax(tmp_path):
    """Good records, then a refit on adversarial ones: both packages keep
    the persisted coefficients, record the rejected fit and merge the
    records alike."""
    jrecs, trecs = _records()
    jrs, trs = ta.specs("4x4")
    bad = lambda recs: [dataclasses.replace(r, measured_s=r.measured_s * (5.0 if i % 2 else 0.2),
                                            name=f"bad{i}")
                        for i, r in enumerate(recs)]  # noqa: E731
    out = {}
    for tag, mod, recs, spec in (("j", jplan, jrecs, jrs), ("t", plan, trecs, trs)):
        d = str(tmp_path / tag)
        first = mod.calibrate_from_records(recs, spec, device_kind="card", directory=d)
        second = mod.calibrate_from_records(bad(recs), spec, device_kind="card", directory=d)
        with open(os.path.join(d, f"calibration-{first.topology}.json")) as f:
            out[tag] = (first, second, json.load(f))
    jf, js, jdoc = out["j"]
    tf, ts, tdoc = out["t"]
    assert tf.topology == jf.topology == "card-c16-data16"
    _assert_calibrations_equal(tf, jf)
    _assert_calibrations_equal(ts, js)
    assert len(tdoc["rejected_fits"]) == len(jdoc["rejected_fits"]) == 1
    assert [r["name"] for r in tdoc["records"]] == [r["name"] for r in jdoc["records"]]
    assert tdoc["n_points"] == jdoc["n_points"] == len(jrecs) * 2


def test_record_from_profiler_and_attribution_equal_jax():
    jrecs, trecs = _records(n=1)
    report = {"step_wall_s": 0.012, "dispatch_gap_s": 0.004, "steps_per_window": 4.0,
              "flops_per_step": 1e9, "bytes_per_step": 1e6}

    class Wire:
        def calibration_components(self):
            return {"comm_s": 0.002, "overlap_s": 0.0, "not_a_component": 1.0}

    jcost = jcm.StrategyCost(**{k: getattr(jrecs[0], k, 0.0) for k in (
        "comm_s", "update_s", "latency_s", "act_sync_s", "gather_s", "overlap_s")},
        per_chip_bytes=1.0, hbm_bytes=2.0, n_collectives=3)
    tcost = tcm.StrategyCost(**{k: getattr(trecs[0], k, 0.0) for k in (
        "comm_s", "update_s", "latency_s", "act_sync_s", "gather_s", "overlap_s")},
        per_chip_bytes=1.0, hbm_bytes=2.0, n_collectives=3)
    for jfn, tfn, args in ((jplan.record_from_profiler, plan.record_from_profiler, ()),
                           (jplan.calibrate.record_from_attribution,
                            plan.record_from_attribution, (Wire(),))):
        j = jfn(report, jcost, *args, name="AllReduce")
        t = tfn(report, tcost, *args, name="AllReduce")
        tj, jj = t.to_json(), j.to_json()
        assert sorted(tj) == sorted(jj)
        for k, v in jj.items():
            assert tj[k] == (pytest.approx(v, rel=1e-9) if isinstance(v, float) else v), k
    rec = plan.record_from_profiler(report, tcost, name="AllReduce")
    assert rec.measured_s == 0.012 and rec.dispatch_gap_s == pytest.approx(0.001)
    assert rec.predicted_s == pytest.approx(tcost.total_s)


# --------------------------------------------------------------------- cache
def _planner(tmp_path, **cfg):
    cfg.setdefault("cache_dir", str(tmp_path / "cache"))
    cfg.setdefault("calibration", None)
    return plan.Plan(plan.PlanConfig(**cfg))


def _grab():
    records = []

    class Grab(pylogging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    return records, Grab(level=pylogging.WARNING), pylogging.getLogger("autodist_tpu_torch")


@pytest.mark.parametrize("gpus,validated", [(8, False), (1, True)])
def test_identical_question_hits_with_zero_search(tmp_path, gpus, validated):
    """A hit skips the search and re-serializes byte for byte; its dry run
    lowers where this process (world size 1) holds the spec's GPUs, and is
    skipped (not validated) elsewhere."""
    item, spec = _item(DEFAULT_SHAPES), _spec(gpus=gpus)
    p1 = _planner(tmp_path)
    s1 = p1.build(item, spec)
    assert p1.last_result["cache_hit"] is False and p1.last_result["n_visited"] >= 20
    with open(os.path.join(p1.last_result["path"], "strategy.json"), "rb") as f:
        stored = f.read()
    p2 = _planner(tmp_path)
    s2 = p2.build(item, spec)
    assert p2.last_result["cache_hit"] is True and p2.last_result["n_visited"] == 0
    assert p2.last_result["validated"] is validated
    assert p2.cache.stats == {"hits": 1, "misses": 0, "invalidated": 0}
    assert s1.to_json() == s2.to_json()
    assert json.dumps(s2.to_json(), indent=2, sort_keys=True).encode() == stored


def test_changed_variable_shapes_miss(tmp_path):
    spec = _spec()
    _planner(tmp_path).build(_item(DEFAULT_SHAPES), spec)
    p2 = _planner(tmp_path)
    p2.build(_item({**DEFAULT_SHAPES, "w1": (128, 64)}), spec)
    assert p2.last_result["cache_hit"] is False and p2.cache.stats["misses"] == 1


def test_changed_resource_spec_misses(tmp_path):
    item = _item(DEFAULT_SHAPES)
    _planner(tmp_path).build(item, _spec())
    p2 = _planner(tmp_path)
    p2.build(item, _spec(gpu={"nvlink_gbps": 123.0}))
    assert p2.last_result["cache_hit"] is False


def test_version_bump_misses(tmp_path):
    item, spec = _item(DEFAULT_SHAPES), _spec()
    assert plan.plan_key(item, spec, version="0.1.0") != plan.plan_key(item, spec,
                                                                      version="0.2.0")
    import autodist_tpu_torch

    assert plan.plan_key(item, spec) == plan.plan_key(item, spec,
                                                      version=autodist_tpu_torch.__version__)
    cache = plan.PlanCache(cache_dir=str(tmp_path / "c"))
    cache.put(item, spec, plan.search(item, spec).strategy, version="0.1.0")
    assert cache.get(item, spec, version="0.1.0") is not None
    assert cache.get(item, spec, version="0.2.0") is None


def test_model_fingerprint_equals_jax():
    for model in sorted(ta.ZOO):
        jitem, titem = ta.items(model)
        assert plan.model_fingerprint(titem) == jplan.model_fingerprint(jitem), model


def test_corrupt_entry_falls_back_loudly(tmp_path):
    item, spec = _item(DEFAULT_SHAPES), _spec()
    p = _planner(tmp_path)
    p.build(item, spec)
    entry = os.path.join(p.config.cache_dir, os.listdir(p.config.cache_dir)[0])
    with open(os.path.join(entry, "strategy.json"), "w") as f:
        f.write("{torn")
    p2 = _planner(tmp_path)
    records, grab, logger = _grab()
    logger.addHandler(grab)
    try:
        strategy = p2.build(item, spec)  # must not raise
    finally:
        logger.removeHandler(grab)
    assert strategy.node_config
    assert p2.last_result["cache_hit"] is False and p2.cache.stats["invalidated"] == 1
    assert any("falling back to a fresh search" in m for m in records)
    # The corrupt entry was evicted and replaced by the fresh winner.
    p3 = _planner(tmp_path)
    p3.build(item, spec)
    assert p3.last_result["cache_hit"] is True


def test_dryrun_validation_rejects_drifted_plan(tmp_path):
    """A cached plan whose partitioner no longer matches the model (drift
    the key missed) is evicted by the dry run, not crashing the build: a
    one-GPU spec, which this process holds."""
    item, spec = _item(DEFAULT_SHAPES), _spec(gpus=1)
    p = _planner(tmp_path)
    p.build(item, spec)
    entry = os.path.join(p.config.cache_dir, os.listdir(p.config.cache_dir)[0])
    spath = os.path.join(entry, "strategy.json")
    with open(spath) as f:
        doc = json.load(f)
    doc["node_config"][0]["partitioner"] = "1,1,1,7"  # wrong rank
    raw = json.dumps(doc, indent=2, sort_keys=True).encode()
    with open(spath, "wb") as f:
        f.write(raw)
    # The checksum kept consistent, so only the dry run can catch it.
    mpath = os.path.join(entry, "meta.json")
    with open(mpath) as f:
        meta = json.load(f)
    meta["strategy_sha256"] = hashlib.sha256(raw).hexdigest()
    with open(mpath, "w") as f:
        json.dump(meta, f)
    p2 = _planner(tmp_path)
    strategy = p2.build(item, spec)  # must not raise
    assert p2.last_result["cache_hit"] is False and p2.cache.stats["invalidated"] == 1
    assert strategy.node_config


def test_default_cache_dir_is_the_ports(tmp_path, monkeypatch):
    monkeypatch.delenv("AUTODIST_PLAN_CACHE", raising=False)
    assert plan.default_cache_dir() == os.path.join(const.DEFAULT_PLAN_DIR, "cache")
    assert const.DEFAULT_PLAN_DIR.startswith(const.DEFAULT_WORKING_DIR)
    monkeypatch.setenv("AUTODIST_PLAN_CACHE", str(tmp_path / "pc"))
    assert plan.default_cache_dir() == str(tmp_path / "pc")
    assert tcal.default_calibration_dir() == const.DEFAULT_PLAN_DIR


# ----------------------------------------------------------------- wiring
def test_autodist_accepts_plan_by_name(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTODIST_PLAN_CACHE", str(tmp_path / "pc"))
    tapi.AutoDist.reset_default()
    try:
        ad = tapi.AutoDist(strategy_builder="plan", device="cpu")
        assert isinstance(ad.strategy_builder, plan.Plan)
        assert ad.strategy_builder.cache.cache_dir == str(tmp_path / "pc")
    finally:
        tapi.AutoDist.reset_default()


def _jax_plan_loss(js, jparams, jbatch, tmp_path, steps):
    """JAX's Plan-built step (its AutoDist on the 8-device test mesh)."""
    from autodist_tpu.api import AutoDist as JAutoDist

    JAutoDist.reset_default()
    try:
        jad = JAutoDist(strategy_builder=jplan.Plan(jplan.PlanConfig(
            cache_dir=str(tmp_path / "jcache"), calibration=None)))
        jstep = jad.build(js.loss_fn, jparams, jbatch,
                          optimizer=jmi.OptimizerSpec("sgd", {"learning_rate": 0.1}))
        _, jm = jstep.run(jstep.init(jparams), jbatch, steps)
        return np.asarray(jm["loss"])
    finally:
        JAutoDist.reset_default()


@pytest.mark.parametrize("model", ["mlp", "transformer"])
def test_plan_builds_a_trainable_step(model, tmp_path):
    """The Plan-built step trains on the CPU; its first loss equals JAX's
    Plan-built step's on the same parameters and batch (the first loss is
    the strategy-independent forward)."""
    from autodist_tpu.models import get_model as jax_get_model
    from helpers import torch_dist as td

    kw = dict(ta.ZOO[model], **({"attention_impl": "dot", "dtype": "float32"}
                                 if model == "transformer" else {}))
    js = jax_get_model(model, **kw)
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.3).astype(s.dtype),
                           jax.eval_shape(js.init, jax.random.PRNGKey(0)))
    jbatch = jax.tree.map(np.asarray, js.example_batch(ta.BATCH))
    jloss = _jax_plan_loss(js, jparams, jbatch, tmp_path, 3)

    spec = get_model_spec(model, **kw)
    tapi.AutoDist.reset_default()
    try:
        ad = tapi.AutoDist(strategy_builder=plan.Plan(plan.PlanConfig(
            cache_dir=str(tmp_path / "tcache"), calibration=None)), device="cpu")
        tparams = params_from_jax(jparams, device="cpu")
        step = ad.build(spec.loss_fn, tparams, td.to_torch(jbatch),
                        optimizer=OptimizerSpec("sgd", {"learning_rate": 0.1}))
        assert ad.strategy_builder.last_result["cache_hit"] is False
        _, m = step.run(step.init(tparams), td.to_torch(jbatch), 3)
    finally:
        tapi.AutoDist.reset_default()
    loss = m["loss"].numpy()
    assert np.isfinite(loss).all() and loss[-1] < loss[0]
    np.testing.assert_allclose(loss[0], jloss[0], rtol=2e-5)


def _jax_provenance():
    jitem, _ = ta.items("resnet")
    jrs, _ = ta.specs("4x4")
    calib = jplan.TopologyCalibration(base_s=1e-3, device="NVIDIA H100 80GB HBM3",
                                      n_points=7, error_before=0.5, error_after=0.1)
    return JSEARCH.PlanSearch(jitem, jrs, JSEARCH.SearchConfig(search_mesh=True),
                              calibration=calib).run().provenance


@pytest.mark.parametrize("source", ["jax", "port", "empty"])
def test_explain_renders_provenance(source, tmp_path):
    """The same provenance renders the same lines in both packages."""
    if source == "jax":
        prov = _jax_provenance()
    elif source == "port":
        planner = _planner(tmp_path, search_mesh=True)
        planner.build(_item(DEFAULT_SHAPES), _spec())
        prov = planner.last_result["provenance"]
    else:
        prov = {}
    tout, jout = io.StringIO(), io.StringIO()
    texplain.explain_provenance(prov, out=tout)
    jexplain.explain_provenance(prov, out=jout)
    assert tout.getvalue() == jout.getvalue()
    if source != "empty":
        text = tout.getvalue()
        assert "candidates visited" in text and "winner:" in text and "why:" in text


def test_explain_cli_renders_a_cache_entry(tmp_path):
    planner = _planner(tmp_path)
    planner.build(_item(DEFAULT_SHAPES), _spec())
    record = os.path.join(planner.last_result["path"], "provenance.json")
    with open(record) as f:
        stored = json.load(f)
    assert stored["n_visited"] == planner.last_result["n_visited"]
    want = io.StringIO()
    texplain.explain_provenance(stored, out=want)
    for path in (planner.config.cache_dir, planner.last_result["path"], record):
        out = io.StringIO()
        assert texplain.main(["--plan-provenance", path], out=out) == 0
        assert out.getvalue() == want.getvalue()


def test_tune_returns_plan_calibration(tmp_path, monkeypatch):
    monkeypatch.setattr(const, "DEFAULT_WORKING_DIR", str(tmp_path))
    monkeypatch.setattr(const, "DEFAULT_PLAN_DIR", str(tmp_path / "plan"))
    spec = get_model_spec("mlp")
    params = spec.init(0, device="cpu")
    batch = spec.example_batch(16, device="cpu")
    cands = [("AllReduce", AllReduce()), ("Zero1", Zero1()),
             ("PSLoadBalancing", PSLoadBalancing())]
    tapi.AutoDist.reset_default()
    try:
        ad = tapi.AutoDist(device="cpu")
        ad.tune(spec.loss_fn, params, batch, candidates=cands, window=2)
        rec = ad.last_tune_results
    finally:
        tapi.AutoDist.reset_default()
    pc = rec["plan_calibration"]
    assert isinstance(pc, plan.TopologyCalibration)
    assert pc.n_points == 3 and pc.device == "cpu" and pc.topology == "cpu-c0-1"
    assert math.isfinite(pc.error_before) and math.isfinite(pc.error_after)
    path = os.path.join(str(tmp_path / "plan"), "calibration-cpu-c0-1.json")
    assert plan.TopologyCalibration.load(path).n_points == 3
    assert [r.name for r in tcal.load_records(path)] == [n for n, _ in cands]
    # Plan("auto") on this process finds it.
    assert plan.Plan(plan.PlanConfig(cache_dir=None))._calibration(
        ad.resource_spec).n_points == 3


def test_selftest_cli():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "autodist_tpu_torch.plan", "--selftest"],
                          capture_output=True, text=True, timeout=240, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["ok"] is True and line["candidates_visited"] >= 20
    assert line["cache_hit_byte_identical"] is True and line["dryrun_validated"] is True
    assert line["calibration_err_after"] < line["calibration_err_before"]
    assert len(line["bucket_sizes_visited"]) >= 2
