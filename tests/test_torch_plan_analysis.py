"""Port parity: the plan-level analysis the planner stands on
(``autodist_tpu_torch/analysis``: ``degradation_check``, ``screen_strategy``,
``screen_schedule``, ``analyze_plan``) against the JAX package's.

The seeded defects of ``tests/test_analysis.py`` (``TestSeededDefects``'
SLH003 and SLM001, ``TestScreenStrategy``, ``TestScheduleScreen``,
``TestCacheAnalyzerValidation``) run through both packages on the same
model, strategy and cluster, and give the same findings: codes, severities
and variables (messages too, but for the async-PS screen, whose wording
names the port's lockstep step). The plans are the port's on
``Mesh.logical`` against JAX's on the test mesh's devices. Under
``helpers/torch_auto.py``'s equal constants, both screens return the same
findings for every slate member of the zoo on every mesh, with and without
gradient buckets, and the schedule screen's estimates are equal.

The plan cache's analyzer validation (``dryrun_lowers``) runs where this
process's world size (1) equals the spec's GPU count: a one-GPU spec here,
where the JAX tests have an 8-device mesh.
"""
import copy
import dataclasses
import importlib
import io
import logging as pylogging

import jax
import numpy as np
import pytest

from autodist_tpu import analysis as janalysis
from autodist_tpu import model_item as jmi
from autodist_tpu.analysis.sched import _screen_schedule as _jscreen
from autodist_tpu.kernel import GraphTransformer as JGraphTransformer
from autodist_tpu.kernel import build_mesh as jbuild_mesh
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import ir as jir
from autodist_tpu.strategy.base import StrategyCompiler as JCompiler
from autodist_tpu.strategy.zero1_strategy import Zero1 as JZero1
from autodist_tpu_torch import analysis
from autodist_tpu_torch import model_item as tmi
from autodist_tpu_torch.analysis.sched import _screen_schedule
from autodist_tpu_torch.kernel import GraphTransformer, Mesh
from autodist_tpu_torch.models.convert import params_from_jax
from autodist_tpu_torch.plan.cache import PlanCache, dryrun_lowers
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import ir
from autodist_tpu_torch.strategy.base import StrategyCompiler, reduction_devices
from autodist_tpu_torch.strategy.zero1_strategy import Zero1
from helpers import torch_auto as ta

N = 8


def _specs(n=N, **hw):
    """(JAX spec, port spec) of one node of ``n`` with ``hw`` in both
    spellings (``hbm_gb``)."""
    node = [{"address": "localhost", "chips": n, "chief": True}]
    return (JResourceSpec(resource_dict={"nodes": node, **({"tpu": hw} if hw else {})}),
            ResourceSpec(resource_dict={"nodes": node, **({"gpu": hw} if hw else {})}))


def _key(findings, message=True):
    return [(f.code, f.severity, f.var, f.pass_name) + ((f.message,) if message else ())
            for f in findings]


@pytest.fixture(scope="module")
def zero1_setup():
    """The zero1 mlp of ``tests/test_analysis.py`` (in_dim 64, hidden 64,
    4 classes, Adam), its numpy parameters in both packages, the Zero1
    strategy and both plans at data 8."""
    js = jax_get_model("mlp", in_dim=8 * N, hidden=(8 * N,), num_classes=4)
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(s.dtype),
                           jax.eval_shape(js.init, jax.random.PRNGKey(0)))
    jitem = jmi.ModelItem.from_params(jparams, optimizer_spec=jmi.OptimizerSpec(
        "adam", {"learning_rate": 1e-3}))
    titem = tmi.ModelItem.from_params(params_from_jax(jparams, device="cpu"),
                                      optimizer_spec=tmi.OptimizerSpec(
                                          "adam", {"learning_rate": 1e-3}))
    jrs, trs = _specs()
    jstrategy = JCompiler(jitem).compile(JZero1().build(jitem, jrs))
    tstrategy = StrategyCompiler(titem).compile(Zero1().build(titem, trs))
    jplan = JGraphTransformer(jstrategy, jitem, jbuild_mesh(jrs, devices=jax.devices()[:N])
                              ).transform()
    tplan = GraphTransformer(tstrategy, titem, Mesh.logical({"data": N})).transform()
    return dict(jitem=jitem, titem=titem, jstrategy=jstrategy, tstrategy=tstrategy,
                jplan=jplan, tplan=tplan)


def _jplan(s, strategy):
    jrs, _ = _specs()
    return JGraphTransformer(strategy, s["jitem"], jbuild_mesh(
        jrs, devices=jax.devices()[:N])).transform()


def _tplan(s, strategy):
    return GraphTransformer(strategy, s["titem"], Mesh.logical({"data": N})).transform()


# ----------------------------------------------------------------- SLH003
def test_clean_zero1_plan_analyzes_clean_in_both(zero1_setup):
    s = zero1_setup
    jrs, trs = _specs()
    jr = janalysis.analyze_plan(s["jplan"], strategy=s["jstrategy"], resource_spec=jrs,
                                optimizer="adam", model_item=s["jitem"])
    tr = analysis.analyze_plan(s["tplan"], strategy=s["tstrategy"], resource_spec=trs,
                               optimizer="adam", model_item=s["titem"])
    assert jr.ok and tr.ok and _key(tr.findings) == _key(jr.findings) == []
    assert tr.tables["memory"]["state_gb_per_chip"] == pytest.approx(
        jr.tables["memory"]["state_gb_per_chip"], rel=1e-12)


def test_degradation_drift_is_slh003(zero1_setup):
    s = zero1_setup
    jdrift, tdrift = _jplan(s, s["jstrategy"]), _tplan(s, s["tstrategy"])
    name = next(n for n, vp in jdrift.var_plans.items() if vp.degradations)
    assert tdrift.var_plans[name].degradations == jdrift.var_plans[name].degradations
    jdrift.var_plans[name].shard_update = True
    tdrift.var_plans[name].shard_update = True
    jr = janalysis.analyze_plan(jdrift, strategy=s["jstrategy"])
    tr = analysis.analyze_plan(tdrift, strategy=s["tstrategy"])
    assert "SLH003" in tr.codes(), tr.render()
    assert _key(tr.findings) == _key(jr.findings)
    assert "drifted" in " | ".join(f.message for f in tr.findings)


@pytest.mark.parametrize("case", ["unknown_reason", "dropped_active", "undeclared"])
def test_degradation_check_cases_equal_jax(zero1_setup, case):
    """Each branch of the check: a reason outside the vocabulary, a
    requested and clean ZeRO-1 rendered without ``shard_update``, and a
    quiet degradation left undeclared (a warning)."""
    s = zero1_setup
    jp, tp = _jplan(s, s["jstrategy"]), _tplan(s, s["tstrategy"])
    active = next(n for n, vp in jp.var_plans.items() if vp.shard_update)
    degraded = next(n for n, vp in jp.var_plans.items() if vp.degradations)
    for p in (jp, tp):
        if case == "unknown_reason":
            p.var_plans[degraded].degradations = ("cosmic_rays",)
        elif case == "dropped_active":
            p.var_plans[active].shard_update = False
        else:
            p.var_plans[degraded].degradations = ()
    jf = janalysis.degradation_check(jp, s["jstrategy"])
    tf = analysis.degradation_check(tp, s["tstrategy"])
    assert tf and _key(tf) == _key(jf)
    if case == "undeclared":
        assert [f.severity for f in tf] == ["warning"]


def test_hbm_overcommit_is_slm001(zero1_setup):
    s = zero1_setup
    jtiny, ttiny = _specs(hbm_gb=1e-5)
    jr = janalysis.analyze_plan(s["jplan"], resource_spec=jtiny, optimizer="adam")
    tr = analysis.analyze_plan(s["tplan"], resource_spec=ttiny, optimizer="adam")
    assert tr.codes() == ("SLM001",) and _key(tr.findings) == _key(jr.findings)


# ----------------------------------------------------------------- SLS001
def _w_items():
    w = np.zeros((64, 64), np.float32)
    return (jmi.ModelItem.from_params({"w": w}),
            tmi.ModelItem.from_params(params_from_jax({"w": w}, device="cpu")))


def _both(nodes):
    """The same node configs as (JAX Strategy, port Strategy)."""
    out = []
    for mod in (jir, ir):
        def conv(n, mod=mod):
            sync = (mod.PSSynchronizer(**dataclasses.asdict(n.synchronizer))
                    if isinstance(n.synchronizer, ir.PSSynchronizer)
                    else mod.AllReduceSynchronizer(**dataclasses.asdict(n.synchronizer)))
            return mod.NodeConfig(n.var_name, sync, partitioner=n.partitioner,
                                  part_config=[conv(p) for p in n.part_config])
        out.append(mod.Strategy(node_config=[conv(n) for n in nodes]))
    return out


SCREEN_CASES = {
    "unknown_var_and_part_table": [
        ir.NodeConfig("ghost", ir.AllReduceSynchronizer()),
        ir.NodeConfig("w", ir.AllReduceSynchronizer(), partitioner="4,1",
                      part_config=[ir.NodeConfig("w/p0", ir.AllReduceSynchronizer())])],
    "async_ps": [ir.NodeConfig("w", ir.PSSynchronizer(sync=False))],
    "oversharded_axis": [ir.NodeConfig("w", ir.AllReduceSynchronizer(),
                                       partitioner="128,1")],
    "axis_out_of_range": [ir.NodeConfig("w", ir.AllReduceSynchronizer(),
                                        partitioner="1,1,4")],
    "two_active_axes": [ir.NodeConfig("w", ir.AllReduceSynchronizer(),
                                      partitioner="2,2")],
    "mixed_part_syncs": [ir.NodeConfig(
        "w", ir.AllReduceSynchronizer(), partitioner="2,1",
        part_config=[ir.NodeConfig("w/p0", ir.AllReduceSynchronizer()),
                     ir.NodeConfig("w/p1", ir.PSSynchronizer())])],
}


@pytest.mark.parametrize("case", sorted(SCREEN_CASES))
def test_screen_strategy_equals_jax(case):
    jitem, titem = _w_items()
    jrs, trs = _specs()
    js, ts = _both(SCREEN_CASES[case])
    jf, tf = janalysis.screen_strategy(js, jitem, jrs), analysis.screen_strategy(ts, titem, trs)
    assert tf, case
    # Messages the lowering's fold and the partitioner grammar raise are
    # each package's own wording; the screen's own messages are JAX's,
    # but for the async-PS one, which names the port's lockstep step.
    assert _key(tf, message=False) == _key(jf, message=False)
    own = {"oversharded_axis", "axis_out_of_range"}
    if case in own:
        assert _key(tf) == _key(jf)
    if case == "async_ps":
        assert "async PS" in tf[0].message
    if case == "unknown_var_and_part_table":
        assert [f.code for f in tf] == ["SLS001", "SLS001"]
        assert tf[0].message == jf[0].message


def test_clean_strategy_screens_clean():
    from autodist_tpu_torch.strategy import AllReduce

    _, titem = _w_items()
    _, trs = _specs()
    assert analysis.screen_strategy(AllReduce().build(titem, trs), titem, trs) == []


def test_search_rejects_screened_seeds_before_pricing(monkeypatch):
    """A slate seed the screen rejects never enters the pool, in either
    package, and the provenance records it alike (equal constants)."""
    jitem, titem = _w_items()
    jrs, trs = ta.specs("1x8")
    jsm = importlib.import_module("autodist_tpu.plan.search")
    tsm = importlib.import_module("autodist_tpu_torch.plan.search")

    def bad_builder(mod):
        class BadBuilder:
            def build(self, mi, rs):
                return mod.Strategy(node_config=[
                    mod.NodeConfig("w", mod.PSSynchronizer(sync=False))])
        return BadBuilder()

    jslate, tslate = ta.slates()
    monkeypatch.setattr(jsm, "candidate_slate",
                        lambda *a, **kw: jslate + [("BadSeed", bad_builder(jir))])
    monkeypatch.setattr(tsm, "candidate_slate",
                        lambda *a, **kw: tslate + [("BadSeed", bad_builder(ir))])
    jres = jsm.PlanSearch(jitem, jrs, jsm.SearchConfig(generations=1)).run()
    tres = tsm.PlanSearch(titem, trs, tsm.SearchConfig(generations=1)).run()
    assert tres.provenance["screen_rejected"] == jres.provenance["screen_rejected"]
    assert tres.provenance["screen_rejected"].get("BadSeed") == ["SLS001"]
    assert "BadSeed" not in tres.provenance["seeds"]
    assert tres.n_visited == jres.n_visited


# --------------------------------------------------------- SLO001, SLM003
def _degenerate(mod, item, spec, dest):
    s = mod.Strategy(id="degenerate")
    s.graph_config.bucket_bytes = 1 << 20
    for var in item.trainable_variables:
        s.node_config.append(mod.NodeConfig(
            var_name=var.name, synchronizer=mod.PSSynchronizer(reduction_destination=dest)))
    return s


def test_degenerate_bucketing_is_slo001(zero1_setup):
    s = zero1_setup
    jrs, trs = _specs()
    dest = reduction_devices(trs)[0]
    jf = janalysis.screen_schedule(_degenerate(jir, s["jitem"], jrs, dest), s["jitem"], jrs)
    tf = analysis.screen_schedule(_degenerate(ir, s["titem"], trs, dest), s["titem"], trs)
    assert [f.code for f in tf] == ["SLO001"] and _key(tf) == _key(jf)
    assert "no variable is bucket-eligible" in tf[0].message.lower()


def test_bucket_transient_is_slm003(zero1_setup):
    s = zero1_setup
    jb, tb = copy.deepcopy(s["jstrategy"]), copy.deepcopy(s["tstrategy"])
    jb.graph_config.bucket_bytes = tb.graph_config.bucket_bytes = 4096
    jrs, trs = _specs()
    jest, test_ = _jscreen(jb, s["jitem"], jrs), _screen_schedule(tb, s["titem"], trs)
    for f in ("state_bytes", "transient_bytes", "n_buckets", "n_eligible"):
        assert getattr(test_, f) == getattr(jest, f), f
    assert test_.transient_bytes > 0 and test_.n_buckets >= 2
    # Capacity between state and state + transient: the totals fit, the
    # bucketed peak does not.
    cap_gb = (test_.state_bytes + test_.transient_bytes / 2) / 0.75 / 1e9
    jbetween, tbetween = _specs(hbm_gb=cap_gb)
    tf = analysis.screen_schedule(tb, s["titem"], tbetween)
    assert [f.code for f in tf] == ["SLM003"]
    assert _key(tf, message=False) == _key(
        janalysis.screen_schedule(jb, s["jitem"], jbetween), message=False)
    tr = analysis.analyze_plan(_tplan(s, tb), strategy=tb, resource_spec=tbetween,
                               optimizer="adam", model_item=s["titem"])
    jr = janalysis.analyze_plan(_jplan(s, jb), strategy=jb, resource_spec=jbetween,
                                optimizer="adam", model_item=s["jitem"])
    assert "SLM003" in tr.codes() and tr.codes() == jr.codes()
    assert analysis.screen_schedule(s["tstrategy"], s["titem"], tbetween) == []


def test_search_screen_rejects_schedule_defect(zero1_setup, monkeypatch):
    s = zero1_setup
    jrs, trs = ta.specs("1x8")
    dest = reduction_devices(trs)[0]
    jsm = importlib.import_module("autodist_tpu.plan.search")
    tsm = importlib.import_module("autodist_tpu_torch.plan.search")

    def seed(strategy):
        class BadSeed:
            def build(self, mi, rs):
                return copy.deepcopy(strategy)
        return BadSeed()

    jslate, tslate = ta.slates()
    monkeypatch.setattr(jsm, "candidate_slate", lambda *a, **kw: jslate + [
        ("DegenerateBucketed", seed(_degenerate(jir, s["jitem"], jrs, dest)))])
    monkeypatch.setattr(tsm, "candidate_slate", lambda *a, **kw: tslate + [
        ("DegenerateBucketed", seed(_degenerate(ir, s["titem"], trs, dest)))])
    jres = jsm.PlanSearch(s["jitem"], jrs, jsm.SearchConfig(generations=1)).run()
    tres = tsm.PlanSearch(s["titem"], trs, tsm.SearchConfig(generations=1)).run()
    rejected = tres.provenance["screen_rejected"]
    assert rejected.get("DegenerateBucketed") == ["SLO001"]
    assert rejected == jres.provenance["screen_rejected"]
    assert "DegenerateBucketed" not in tres.provenance["seeds"]
    assert tres.n_visited == jres.n_visited


@pytest.mark.parametrize("mesh", sorted(ta.MESHES))
@pytest.mark.parametrize("model", sorted(ta.ZOO))
def test_screens_equal_jax_over_the_slate(model, mesh):
    """Every slate member of the zoo, unbucketed and at two bucket sizes,
    and on a memory between its state and its bucketed peak: the same
    screen findings and schedule estimates in both packages."""
    jitem, titem = ta.items(model)
    jrs, trs = ta.specs(mesh)
    jslate, tslate = ta.slates()
    for (name, jb), (_, tb) in zip(jslate, tslate):
        js, ts = jb.build(jitem, jrs), tb.build(titem, trs)
        assert _key(analysis.screen_strategy(ts, titem, trs)) == _key(
            janalysis.screen_strategy(js, jitem, jrs)), name
        for bucket in (0, 4096, 1 << 20):
            js.graph_config.bucket_bytes = ts.graph_config.bucket_bytes = bucket
            jest, test_ = _jscreen(js, jitem, jrs), _screen_schedule(ts, titem, trs)
            assert _key(test_.findings) == _key(jest.findings), (name, bucket)
            for f in ("state_bytes", "transient_bytes", "n_buckets", "n_eligible"):
                assert getattr(test_, f) == pytest.approx(getattr(jest, f), rel=1e-12), \
                    (name, bucket, f)
            if test_.transient_bytes > 0:
                cap = (test_.state_bytes + test_.transient_bytes / 2) / 0.75 / 1e9
                jtight, ttight = ta.specs(mesh, hbm_gb=cap)
                tf = analysis.screen_schedule(ts, titem, ttight)
                assert [f.code for f in tf] == ["SLM003"]
                assert _key(tf, message=False) == _key(
                    janalysis.screen_schedule(js, jitem, jtight), message=False)


# ------------------------------------------- the cache's analyzer validation
def _one_gpu(**hw):
    return ResourceSpec(resource_dict={
        "nodes": [{"address": "localhost", "gpus": 1, "chief": True}],
        **({"gpu": hw} if hw else {})})


def _grab_warnings():
    buf = io.StringIO()
    handler = pylogging.StreamHandler(buf)
    return buf, handler, pylogging.getLogger("autodist_tpu_torch")


def test_overcommitted_entry_evicted_with_finding(zero1_setup, tmp_path):
    titem = zero1_setup["titem"]
    strategy = StrategyCompiler(titem).compile(Zero1().build(titem, _one_gpu()))
    cache = PlanCache(cache_dir=str(tmp_path / "cache"), validate=True)
    cache.put(titem, _one_gpu(), strategy)
    entry = cache.get(titem, _one_gpu())
    assert entry is not None and entry.validated  # a clean entry lowers and passes
    tiny = _one_gpu(hbm_gb=1e-5)
    cache.put(titem, tiny, strategy)
    buf, handler, logger = _grab_warnings()
    logger.addHandler(handler)
    try:
        entry = cache.get(titem, tiny)
    finally:
        logger.removeHandler(handler)
    assert entry is None
    assert cache.stats["invalidated"] == 1
    assert "SLM001" in buf.getvalue()


def test_dryrun_lowers_raises_analysis_error(zero1_setup):
    titem = zero1_setup["titem"]
    strategy = StrategyCompiler(titem).compile(Zero1().build(titem, _one_gpu()))
    with pytest.raises(analysis.AnalysisError) as ei:
        dryrun_lowers(strategy, titem, _one_gpu(hbm_gb=1e-5))
    assert "SLM001" in str(ei.value)
    assert dryrun_lowers(strategy, titem, _one_gpu()) is True
    # A spec of 8 GPUs from a process of world size 1: skipped, not validated.
    assert dryrun_lowers(zero1_setup["tstrategy"], titem, _specs()[1]) is False


def test_cache_evicts_schedule_finding(zero1_setup, tmp_path):
    titem = zero1_setup["titem"]
    spec = _one_gpu()
    cache = PlanCache(cache_dir=str(tmp_path / "cache"), validate=True)
    cache.put(titem, spec, _degenerate(ir, titem, spec, reduction_devices(spec)[0]))
    buf, handler, logger = _grab_warnings()
    logger.addHandler(handler)
    try:
        entry = cache.get(titem, spec)
    finally:
        logger.removeHandler(handler)
    assert entry is None
    assert cache.stats["invalidated"] == 1
    assert "SLO001" in buf.getvalue()
