"""The port's ``Auto`` builder and ``AutoDist.tune`` against the JAX
package's.

- Under equal constants (``helpers/torch_auto.py``), ``Auto``'s Strategy
  JSON equals JAX's ``Auto``'s for the zoo at small widths on one node of
  8, four nodes of 4 and a {data 2, model 4} mesh: the sparse models
  (LM1B, NCF, the MoE, the transformers' tables) go to Parallax, the dense
  ones to the cost model's pick; so does the heuristic mode
  (``cost_model=False``), and the memory-pressure fallback.
- ``strategy.from_name("Auto")`` and ``AutoDist(strategy_builder="Auto")``
  build; ``"Plan"`` raises, naming ROADMAP.md.
- ``AutoDist.tune`` on the CPU: every candidate timed, the fastest measured
  wins, a failing candidate is skipped, the calibration is written.
"""
import json
import math
import os

import pytest
import torch

from autodist_tpu import strategy as jstrat
from autodist_tpu_torch import api as tapi
from autodist_tpu_torch import const
from autodist_tpu_torch import strategy as tstrat
from autodist_tpu_torch.model_item import ModelItem, OptimizerSpec
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.ir import AllReduceSynchronizer, PSSynchronizer
from helpers import torch_auto as ta


def _json(strategy, tpu_to_gpu=False):
    d = strategy.to_json()
    d["id"] = d["path"] = ""
    text = json.dumps(d)
    return json.loads(text.replace(":TPU:", ":GPU:") if tpu_to_gpu else text)


@pytest.mark.parametrize("mesh", sorted(ta.MESHES))
@pytest.mark.parametrize("model", sorted(ta.ZOO))
def test_auto_strategy_json_equals_jax(model, mesh):
    jitem, titem = ta.items(model)
    jrs, trs = ta.specs(mesh)
    got = tstrat.from_name("Auto").build(titem, trs)
    want = jstrat.from_name("Auto").build(jitem, jrs)
    assert _json(got) == _json(want, tpu_to_gpu=True)
    if titem.sparse_variables:
        assert _json(got) == _json(tstrat.Parallax().build(titem, trs))


@pytest.mark.parametrize("model", sorted(ta.ZOO))
def test_heuristic_mode_equals_jax(model):
    jitem, titem = ta.items(model)
    jrs, trs = ta.specs("1x8")
    got = tstrat.Auto(cost_model=False).build(titem, trs)
    want = jstrat.Auto(cost_model=False).build(jitem, jrs)
    assert _json(got) == _json(want, tpu_to_gpu=True)


def test_auto_respects_memory_pressure():
    jitem, titem = ta.items("mlp")
    for hbm in (1e-4, 16.0):
        jrs, trs = ta.specs("1x8", hbm_gb=hbm)
        got = tstrat.Auto().build(titem, trs)
        assert _json(got) == _json(jstrat.Auto().build(jitem, jrs), tpu_to_gpu=True)
    # Nothing fits a 0.1 MB card: the smallest footprint wins, not plain AR.
    item = ModelItem.from_params({"w": torch.zeros(8192, 8192), "b": torch.zeros(8192)},
                                 optimizer_spec=OptimizerSpec("adam"))
    spec = ResourceSpec(resource_dict={"nodes": [{"address": "localhost", "gpus": 8}],
                                       "gpu": {"hbm_gb": 1.0}})
    s = tstrat.Auto().build(item, spec)
    assert not all(isinstance(n.synchronizer, AllReduceSynchronizer) and not n.partitioner
                   and not n.synchronizer.shard_update for n in s.node_config)


def test_from_name_auto_and_plan():
    assert isinstance(tstrat.from_name("Auto"), tstrat.Auto)
    assert "Auto" in tstrat.BUILTIN_BUILDERS
    for name in ("Plan", "plan"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
            tstrat.from_name(name)


@pytest.mark.parametrize("model,want", [("ncf", PSSynchronizer), ("mlp", None)])
def test_autodist_auto_builds_and_trains(model, want):
    spec = get_model_spec(model, **ta.ZOO[model])
    params = spec.init(0, device="cpu")
    batch = spec.example_batch(ta.BATCH, device="cpu")
    tapi.AutoDist.reset_default()
    try:
        ad = tapi.AutoDist(strategy_builder="Auto", device="cpu")
        step = ad.build(spec.loss_fn, params, batch)
        state, m = step.run(step.init(params), batch, 2)
        assert torch.isfinite(m["loss"]).all()
        syncs = {type(n.synchronizer) for n in ad.strategy.node_config}
        if want is PSSynchronizer:    # Parallax: the tables on a PS
            assert PSSynchronizer in syncs and AllReduceSynchronizer in syncs
    finally:
        tapi.AutoDist.reset_default()


class _Broken:
    """A builder that fails: tune must skip it."""

    def build(self, model_item, resource_spec):
        raise RuntimeError("this candidate does not build")


def test_tune_picks_fastest_and_writes_calibration(tmp_path, monkeypatch):
    monkeypatch.setattr(const, "DEFAULT_WORKING_DIR", str(tmp_path))
    spec = get_model_spec("mlp")
    params = spec.init(0, device="cpu")
    batch = spec.example_batch(16, device="cpu")
    tapi.AutoDist.reset_default()
    try:
        ad = tapi.AutoDist(device="cpu")
        cands = [("AllReduce", tstrat.AllReduce()), ("broken", _Broken()),
                 ("PSLoadBalancing", tstrat.PSLoadBalancing()), ("Zero1", tstrat.Zero1())]
        step = ad.tune(spec.loss_fn, params, batch, candidates=cands, window=2)
        rec = ad.last_tune_results
        measured = rec["measured"]
        assert set(measured) == {n for n, _ in cands}
        assert math.isinf(measured["broken"])
        best = min((n for n in measured if math.isfinite(measured[n])), key=measured.get)
        assert rec["selected"] == best
        assert ad.strategy_builder is dict(cands)[best] and ad._built is step
        assert set(rec["table"]) == {"AllReduce", "PSLoadBalancing", "Zero1"}
        for row in rec["table"].values():
            assert row["measured_s"] > 0 and row["predicted_s"] >= 0
        assert rec["calibration_path"] == os.path.join(str(tmp_path), "calibration.json")
        assert os.path.exists(rec["calibration_path"])
        assert rec["calibration"].n_points == 3 and rec["calibration"].device == "cpu"
        state, m = step.run(step.init(params), batch, 1)
        assert torch.isfinite(m["loss"]).all()
        # Given a path, the calibration goes there.
        ad.tune(spec.loss_fn, params, batch, candidates=cands[:1], window=1,
                calibration_path=str(tmp_path / "elsewhere" / "cal.json"))
        assert os.path.exists(tmp_path / "elsewhere" / "cal.json")
    finally:
        tapi.AutoDist.reset_default()
