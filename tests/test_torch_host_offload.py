"""Port parity of host offload (``host_offload=False | True |
"from_strategy"``) against the JAX package, on the CPU.

- The plan's per-variable ``offload`` flags and its ``describe()`` equal
  JAX's on an 8-way data axis, with JAX's gate forced open as
  ``tests/test_host_offload.py`` forces it (its CPU runtime cannot stream):
  ``True`` offloads every PS variable and no AllReduce one;
  ``"from_strategy"`` follows host-CPU reduction destinations, the shard
  table over the node's destination.
- An invalid mode raises ``ValueError`` naming ``host_offload``, as JAX's.
- An offloaded step on ``device="cpu"`` (the host is the device: each step
  streams between two CPU tensors) equals the resident step bitwise over
  five Adam steps, loss by loss and leaf by leaf, optimizer slots included;
  the offloaded leaves stay the same host tensors across steps, and
  ``evaluate`` and ``logical_params`` read them. JAX's own tests never run
  an offloaded step off the TPU, so the reference here is the port's
  resident step.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import autodist_tpu.kernel.lowering as jlowering
import autodist_tpu.strategy as jstrat
from autodist_tpu.kernel import GraphTransformer as JGraphTransformer
from autodist_tpu.kernel import build_mesh as jbuild_mesh
from autodist_tpu.model_item import ModelItem as JModelItem
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import ir as jir
from autodist_tpu_torch import api
from autodist_tpu_torch import strategy as tstrat
from autodist_tpu_torch.kernel import GraphTransformer, Mesh
from autodist_tpu_torch.model_item import ModelItem, OptimizerSpec
from autodist_tpu_torch.models.convert import flatten_params
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import ir as tir


def problem():
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((8, 1)).astype(np.float32),
              "b": np.zeros((1,), np.float32)}
    batch = {"x": rng.standard_normal((16, 8)).astype(np.float32),
             "y": rng.standard_normal((16, 1)).astype(np.float32)}
    return params, batch


def loss_fn(params, batch):
    pred = batch["x"] @ params["w"] + params["b"]
    return ((pred - batch["y"]) ** 2).mean()


def _t(tree):
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in tree.items()}


def plans(builder, host_offload, kwargs=None):
    """(JAX plan, port plan) of a builder on an 8-way data axis."""
    params, _ = problem()
    kwargs = kwargs or {}
    rs = {"nodes": [{"address": "localhost", "chips": 8, "chief": True}]}
    jrs = JResourceSpec(resource_dict=rs)
    jitem = JModelItem.from_params(params)
    jcompiled = jstrat.StrategyCompiler(jitem).compile(
        getattr(jstrat, builder)(**kwargs).build(jitem, jrs))
    jplan = JGraphTransformer(jcompiled, jitem, jbuild_mesh(jrs, devices=jax.devices()[:8]),
                              host_offload=host_offload).transform()
    titem = ModelItem.from_params(_t(params))
    tcompiled = tstrat.StrategyCompiler(titem).compile(
        getattr(tstrat, builder)(**kwargs).build(titem, ResourceSpec(resource_dict=rs)))
    tplan = GraphTransformer(tcompiled, titem, Mesh.logical({"data": 8}),
                             host_offload=host_offload).transform()
    return jplan, tplan


@pytest.fixture
def gate_open(monkeypatch):
    monkeypatch.setattr(jlowering, "_memory_kinds_supported", lambda mesh: True)


@pytest.mark.parametrize("mode", (False, True, "from_strategy"))
@pytest.mark.parametrize("builder", ("PS", "PSLoadBalancing", "PartitionedPS",
                                     "UnevenPartitionedPS", "AllReduce", "Zero1"))
def test_plan_flags_match_jax(builder, mode, gate_open):
    jplan, tplan = plans(builder, mode)
    want = {n: p.offload for n, p in jplan.var_plans.items()}
    assert {n: p.offload for n, p in tplan.var_plans.items()} == want
    assert tplan.has_offload == jplan.has_offload == (bool(mode) and "PS" in builder)
    assert tplan.describe() == jplan.describe()


def _nodes(ir, w_dest, b_dest, shard_dests=None):
    w = ir.NodeConfig("w", ir.PSSynchronizer(reduction_destination=w_dest))
    if shard_dests:
        w.partitioner = f"{len(shard_dests)},1"
        w.part_config = [ir.NodeConfig(f"w/part_{i}", ir.PSSynchronizer(
            reduction_destination=d)) for i, d in enumerate(shard_dests)]
    return [w, ir.NodeConfig("b", ir.PSSynchronizer(reduction_destination=b_dest))]


@pytest.mark.parametrize("case", ("node", "shard_table"))
def test_from_strategy_follows_destinations_like_jax(case, gate_open):
    """A TPU/GPU destination stays on the device, a CPU one is offloaded;
    the shard table decides over a stale node-level destination."""
    params, _ = problem()
    shards = ["h:TPU:0", "h:TPU:0"] if case == "shard_table" else None
    w_dest = "h:CPU:0" if case == "shard_table" else "localhost:TPU:0"
    jplan = JGraphTransformer(
        jir.Strategy(node_config=_nodes(jir, w_dest, "localhost:CPU:0", shards)),
        JModelItem.from_params(params), JMesh(np.array(jax.devices()), ("data",)),
        host_offload="from_strategy").transform()
    tplan = GraphTransformer(
        tir.Strategy(node_config=_nodes(tir, w_dest, "localhost:CPU:0", shards)),
        ModelItem.from_params(_t(params)), Mesh.logical({"data": 8}),
        host_offload="from_strategy").transform()
    for name in ("w", "b"):
        assert tplan.plan_for(name).offload == jplan.plan_for(name).offload, name
    assert not tplan.plan_for("w").offload and tplan.plan_for("b").offload


def test_invalid_offload_mode_rejected():
    params, _ = problem()
    with pytest.raises(ValueError, match="host_offload") as err:
        GraphTransformer(tir.Strategy(), ModelItem.from_params(_t(params)),
                         Mesh.logical({"data": 8}), host_offload="always")
    with pytest.raises(ValueError) as jerr:
        JGraphTransformer(jir.Strategy(), JModelItem.from_params(params),
                          JMesh(np.array(jax.devices()), ("data",)), host_offload="always")
    assert str(err.value) == str(jerr.value)


def _train(builder, host_offload, steps=5):
    params, batch = problem()
    api.AutoDist.reset_default()
    ad = api.AutoDist(strategy_builder=builder, device="cpu")
    step = ad.build(loss_fn, _t(params), _t(batch), host_offload=host_offload,
                    optimizer=OptimizerSpec("adam", {"learning_rate": 0.05}))
    state = step.init(_t(params))
    held = [id(t) for t in flatten_params(state.params).values()]
    slots = [id(t) for t in state.opt_state["mu"] + state.opt_state["nu"]]
    losses = []
    for _ in range(steps):
        state, m = step(state, _t(batch))
        losses.append(float(m["loss"]))
    assert held == [id(t) for t in flatten_params(state.params).values()]
    assert slots == [id(t) for t in state.opt_state["mu"] + state.opt_state["nu"]]
    return step, state, losses, float(step.evaluate(state, _t(batch))["loss"])


@pytest.mark.parametrize("mode", (True, "from_strategy"))
@pytest.mark.parametrize("builder", ("PSLoadBalancing", "PartitionedPS"))
def test_offloaded_cpu_step_equals_resident_bitwise(builder, mode):
    step, state, losses, evaluated = _train(getattr(tstrat, builder)(), mode)
    assert step.plan.has_offload and step.offloaded == {"w", "b"}
    _, rstate, rlosses, revaluated = _train(getattr(tstrat, builder)(), False)
    assert losses == rlosses and evaluated == revaluated
    logical, resident = (flatten_params(s) for s in (step.logical_params(state),
                                                     step.logical_params(rstate)))
    for name, t in resident.items():
        assert torch.equal(logical[name], t), name
    for key in ("mu", "nu"):
        for got, want in zip(state.opt_state[key], rstate.opt_state[key]):
            assert torch.equal(got, want), key
    assert state.opt_state["count"] == rstate.opt_state["count"] == 5
