"""Port parity of the gradient compressors (``kernel/compressor.py``) at one
rank, against the JAX package's on the same numpy inputs and state.

- Each compressor's ``step`` three times in a row, its state carried (the
  JAX side in a ``shard_map`` over one CPU device, as
  ``tests/test_compressor.py`` runs it; the port without a group, where
  every collective is the identity): the synced gradient and the new state
  bitwise equal for None, Horovod, Horovod-EF and TopK (casts, one rank's
  sums and a scatter into zeros round the same), PowerSGD within 1e-5 of
  each tensor's largest entry (matmuls and QR sum in another order; JAX's
  initial ``q`` carried over, since torch cannot draw threefry). TopK's data has no ties in
  magnitude, so both sides select the same entries.
- ``wire_factor`` equal to JAX's at the shapes and ``nshards`` of
  ``tests/test_compressor.py`` (pure arithmetic).
- The registry, the aliases and ``is_active_compressor`` as JAX's.
- ``AllReduce(compressor=X)`` for every compressor and alias through
  ``AutoDist.build`` on one device: three SGD steps against JAX's step on a
  one-device mesh from the same params and compressor state, parameters
  within rtol 2e-5 / atol 2e-6 (``tests/test_e2e_numeric.py``'s), and the
  plan's predicted wire.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autodist_tpu.kernel import DistributedTrainStep as JStep
from autodist_tpu.kernel import GraphTransformer as JGraphTransformer
from autodist_tpu.kernel import build_mesh as jbuild_mesh
from autodist_tpu.kernel import compressor as jc
from autodist_tpu.model_item import ModelItem as JModelItem
from autodist_tpu.model_item import OptimizerSpec as JOptimizerSpec
from autodist_tpu.model_item import VarItem as JVarItem
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu.strategy import StrategyCompiler as JStrategyCompiler
from autodist_tpu.utils.compat import shard_map
from autodist_tpu_torch import api
from autodist_tpu_torch.kernel import compressor as tc
from autodist_tpu_torch.kernel import degrade
from autodist_tpu_torch.model_item import OptimizerSpec, VarItem
from autodist_tpu_torch.models.convert import comp_state_from_jax
from autodist_tpu_torch.runtime.process_group import Collectives
from autodist_tpu_torch.strategy import from_name

NAMES = ("NoneCompressor", "HorovodCompressor", "HorovodCompressorEF",
         "PowerSGDCompressor", "TopKCompressor")
EXACT = {"NoneCompressor", "HorovodCompressor", "HorovodCompressorEF", "TopKCompressor"}
POWERSGD_REL = 1e-5
PARAM_RTOL, PARAM_ATOL = 2e-5, 2e-6
SHAPES = ((128, 64), (3, 4, 5, 6), (40,))          # TopK's min_size 4096: the first


def _jax_step(comp, grad, local, shared):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    P = jax.sharding.PartitionSpec
    f = shard_map(lambda g, l, s: comp.step(g, l, s, axis="data", nshards=1), mesh=mesh,
                  in_specs=(P(), P(), P()), out_specs=(P(), P(), P()),
                  axis_names={"data"}, check_vma=False)
    return jax.tree.map(np.asarray, f(jnp.asarray(grad), local, shared))


def _t(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x, copy=True)), tree)


def _close(got, want, name, what):
    got, want = np.asarray(got), np.asarray(want)
    if name in EXACT:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= POWERSGD_REL, f"{what}: {err} of the largest entry"


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", NAMES)
def test_step_matches_jax_at_one_rank(name, shape):
    rng = np.random.default_rng(7)
    jcomp, tcomp = jc.get_compressor(name), tc.get_compressor(name)
    jvar = JVarItem(name="v", shape=shape, dtype="float32")
    jlocal, jshared = jcomp.init_local(jvar), jcomp.init_shared(jvar)
    tvar = VarItem(name="v", shape=shape, dtype="float32")
    tlocal = tcomp.init_local(tvar)
    assert sorted(tlocal) == sorted(jlocal)
    assert sorted(tcomp.init_shared(tvar)) == sorted(jshared)
    tshared = _t(jax.tree.map(np.asarray, jshared))      # JAX's q carried over
    coll = Collectives(None)
    for i in range(3):
        grad = rng.standard_normal(shape).astype(np.float32)
        jout, jlocal, jshared = _jax_step(jcomp, grad, jlocal, jshared)
        tout, tlocal, tshared = tcomp.step(torch.from_numpy(grad), tlocal, tshared, coll)
        _close(tout.numpy(), jout, name, f"step {i} output")
        for k in jlocal:
            _close(tlocal[k].numpy(), jlocal[k], name, f"step {i} local {k}")
        for k in jshared:
            _close(tshared[k].numpy(), jshared[k], name, f"step {i} shared {k}")
        assert tout.dtype == torch.float32 and tuple(tout.shape) == shape


def test_ef_residual_is_the_bf16_rounding():
    """residual = inp - fp32(bf16(inp)), bitwise, and the output the bf16
    rounding of inp."""
    rng = np.random.default_rng(1)
    comp = tc.HorovodCompressorEF()
    local = comp.init_local(VarItem(name="v", shape=(64, 32), dtype="float32"))
    grad = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    out, local, _ = comp.step(grad, local, {}, Collectives(None))
    assert torch.equal(out, grad.to(torch.bfloat16).float())
    assert torch.equal(local["residual"], grad - grad.to(torch.bfloat16).float())
    assert local["residual"].abs().max() > 0


WIRE_CASES = [
    ("PowerSGDCompressor", {"rank": 2}, (256, 64), 1),
    ("PowerSGDCompressor", {"rank": 2}, (256, 8, 8), 1),
    ("PowerSGDCompressor", {"rank": 8}, (4, 2), 1),
    ("PowerSGDCompressor", {"rank": 2}, (128,), 1),
    ("PowerSGDCompressor", {"rank": 2}, (2, 2), 1),
    ("HorovodCompressor", {}, (256, 64), 1),
    ("HorovodCompressorEF", {}, (256, 64), 8),
    ("NoneCompressor", {}, (256, 64), 1),
    ("TopKCompressor", {"ratio": 0.01, "min_size": 4096}, (128, 64), 8),
    ("TopKCompressor", {"ratio": 0.01, "min_size": 4096}, (128, 64), 1),
    ("TopKCompressor", {"ratio": 0.01, "min_size": 4096}, (16, 16), 8),
    ("TopKCompressor", {"ratio": 0.5, "min_size": 1}, (64,), 4),
]


@pytest.mark.parametrize("name,kwargs,shape,n", WIRE_CASES,
                         ids=[f"{c[0]}-{'x'.join(map(str, c[2]))}-n{c[3]}"
                              for c in WIRE_CASES])
def test_wire_factor_matches_jax(name, kwargs, shape, n):
    got = getattr(tc, name)(**kwargs).wire_factor(shape, nshards=n)
    assert got == getattr(jc, name)(**kwargs).wire_factor(shape, nshards=n)


def test_registry_aliases_and_active_predicate():
    for alias, name in (("bf16", "HorovodCompressor"), ("ef", "HorovodCompressorEF"),
                        ("powersgd", "PowerSGDCompressor"), ("topk", "TopKCompressor"),
                        ("none", "NoneCompressor")):
        assert type(tc.get_compressor(alias)).__name__ == name
        assert tc.canonical_compressor_name(alias) == jc.canonical_compressor_name(alias)
    for name in NAMES:
        assert type(tc.get_compressor(name)).__name__ == type(jc.get_compressor(name)).__name__
    with pytest.raises(ValueError, match="unknown compressor"):
        tc.get_compressor("Gzip")
    for name in ("", None, "none", "NoneCompressor", "bf16", "ef", "powersgd", "topk",
                 *NAMES):
        assert degrade.is_active_compressor(name) == jc.is_active_compressor(name), name
    with pytest.raises(ValueError, match="ratio"):
        tc.TopKCompressor(ratio=0.0)


def _problem():
    rng = np.random.default_rng(3)
    params = {"w": (rng.standard_normal((128, 64)) * 0.1).astype(np.float32),
              "b": rng.standard_normal((64,)).astype(np.float32)}
    batch = (rng.standard_normal((16, 128)).astype(np.float32),
             rng.standard_normal((16, 64)).astype(np.float32))
    return params, batch


def _jax_loss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] + params["b"] - y) ** 2)


def _torch_loss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] + params["b"] - y) ** 2)


@pytest.mark.parametrize("compressor", NAMES + ("bf16", "ef", "powersgd", "topk", "none"))
def test_allreduce_compressor_trains_like_jax_on_one_device(compressor):
    params, batch = _problem()
    opt = {"learning_rate": 0.05}
    rs = JResourceSpec(resource_dict={"nodes": [
        {"address": "localhost", "chips": 1, "chief": True}]})
    item = JModelItem.from_params(params, optimizer_spec=JOptimizerSpec("sgd", opt))
    strategy = JStrategyCompiler(item).compile(JAllReduce(compressor=compressor).build(item, rs))
    plan = JGraphTransformer(strategy, item, jbuild_mesh(rs, devices=jax.devices()[:1])
                             ).transform()
    jstep = JStep(plan, _jax_loss, optax.sgd(0.05))
    jstate = jstep.init(params)
    comp0 = jax.tree.map(np.asarray, jstate.comp_state)
    jlosses = []
    for _ in range(3):
        jstate, m = jstep(jstate, batch)
        jlosses.append(float(m["loss"]))

    api.AutoDist.reset_default()
    ad = api.AutoDist(strategy_builder=from_name("AllReduce", compressor=compressor),
                      device="cpu")
    tparams, tbatch = _t(params), _t(batch)
    step = ad.build(_torch_loss, tparams, tbatch, optimizer=OptimizerSpec("sgd", opt))
    active = tc.is_active_compressor(compressor)
    assert step.manual == active
    assert sorted(step.compressors) == (["b", "w"] if active else [])
    state = step.init(tparams)
    state.comp_state = comp_state_from_jax(comp0, rank=0, device="cpu")
    losses = []
    for _ in range(3):
        state, m = step(state, tbatch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(state.params[k].detach().numpy(),
                                   np.asarray(jstate.params[k]), rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)
    jcomp = jax.tree.map(np.asarray, jstate.comp_state)
    for name, st in state.comp_state.items():
        for part in ("local", "shared"):
            for k, t in st[part].items():
                want = jcomp[name][part][k]
                np.testing.assert_allclose(t.numpy(), want[0] if part == "local" else want,
                                           rtol=1e-4, atol=1e-5, err_msg=f"{name} {part} {k}")
    canonical = tc.canonical_compressor_name(compressor)
    want_wire = {"NoneCompressor": {"all_reduce": 2}, "HorovodCompressor": {"all_reduce": 2},
                 "HorovodCompressorEF": {"all_reduce": 2},
                 "PowerSGDCompressor": {"all_reduce": 3},
                 "TopKCompressor": {"all_reduce": 1, "all_gather": 2}}[canonical]
    predicted = ad.plan.collectives_per_step()
    assert {k: v for k, v in predicted.items() if v} == want_wire
