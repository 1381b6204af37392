"""Port parity of bounded staleness on the synchronous PS path
(``sync=True, staleness=K``), at one rank, against the JAX package.

``tests/test_staleness.py``'s cases on its linear loss (the gradient is the
batch mean, independent of w; plain SGD): the port's step and JAX's
(through ``AutoDist.build`` on both sides) each held to
the hand-computed delayed trajectory within rtol 1e-6 (the JAX test's;
JAX on its 8-device test mesh, where the scalar is replicated):

- exactly K steps of delay, zero gradient for the first K;
- ``staleness=0`` is synchronous;
- the ``[K, ...]`` buffer in the state, oldest gradient first;
- delay composed with momentum equals optax fed the delayed gradients.

Then PS, PSLoadBalancing and PartitionedPS with ``staleness=2`` on the
dense and embedding models, and Parallax on the embedding one of ``helpers/torch_dist.py``, four Adam
steps: parameters against JAX's one-device step within rtol 2e-5 / atol
2e-6, the delay buffers against JAX's (carried to the port's layout by
``convert.stale_state_from_jax``) within the same.
"""
import jax
import numpy as np
import optax
import pytest
import torch

from autodist_tpu import api as japi
from autodist_tpu import model_item as jmi
from autodist_tpu import strategy as jstrat
from autodist_tpu.kernel import DistributedTrainStep as JStep
from autodist_tpu.kernel import GraphTransformer as JGT
from autodist_tpu.kernel import build_mesh as jbuild_mesh
from autodist_tpu.model_item import OptimizerSpec as JOptimizerSpec
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu_torch import api as tapi
from autodist_tpu_torch import strategy as tstrat
from autodist_tpu_torch.model_item import OptimizerSpec
from autodist_tpu_torch.models.convert import flatten_params, stale_state_from_jax
from helpers import torch_dist as td
from helpers import torch_dist_worker as worker

LR = 0.5


def _jax_loss(params, batch):
    return (batch["x"] * params["w"]).mean()


def _torch_loss(params, batch):
    return (batch["x"] * params["w"]).mean()


def _builds(builder, opt=("sgd", {"learning_rate": LR}), w0=10.0):
    """(JAX step, port step, params) of the linear problem (JAX on the
    8-device mesh, as its own test)."""
    params = {"w": np.array(w0, np.float32)}
    batch0 = {"x": np.zeros((8,), np.float32)}
    japi.AutoDist.reset_default()
    jad = japi.AutoDist(resource_spec=JResourceSpec(resource_dict={"nodes": [
        {"address": "localhost", "chips": 8, "chief": True}]}),
        strategy_builder=getattr(jstrat, builder[0])(**builder[1]))
    jstep = jad.build(_jax_loss, params, batch0, optimizer=JOptimizerSpec(*opt))
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()
    tad = tapi.AutoDist(strategy_builder=getattr(tstrat, builder[0])(**builder[1]),
                        device="cpu")
    tstep = tad.build(_torch_loss, td.to_torch(params), td.to_torch(batch0),
                      optimizer=OptimizerSpec(*opt))
    return jstep, tstep, params


def _run(jstep, tstep, params, values):
    """The two steps over batches of the given values: per step the JAX
    and port w, and the final states."""
    jstate, tstate = jstep.init(params), tstep.init(td.to_torch(params))
    out = []
    for v in values:
        jstate, _ = jstep(jstate, {"x": np.full((8,), v, np.float32)})
        tstate, _ = tstep(tstate, {"x": torch.full((8,), v)})
        out.append((float(jstate.params["w"]), float(tstate.params["w"].detach())))
    return out, jstate, tstate


def test_staleness_delays_updates_exactly_k_steps():
    k = 2
    jstep, tstep, params = _builds(("PS", {"staleness": k}))
    assert tstep.plan.var_plans["w"].staleness == k
    got, _, _ = _run(jstep, tstep, params, [1.0, 2.0, 3.0, 4.0])
    want = [10.0]
    for g in [0.0, 0.0, 1.0, 2.0]:               # the gradients of 2 steps ago
        want.append(want[-1] - LR * g)
    for (jw, tw), w in zip(got, want[1:]):
        np.testing.assert_allclose(jw, w, rtol=1e-6)
        np.testing.assert_allclose(tw, w, rtol=1e-6)


def test_zero_staleness_is_synchronous():
    jstep, tstep, params = _builds(("PS", {"staleness": 0}))
    got, _, tstate = _run(jstep, tstep, params, [3.0])
    assert tstate.stale_state == {}
    np.testing.assert_allclose(got[0], [10.0 - LR * 3.0] * 2, rtol=1e-6)


def test_stale_buffer_in_state():
    k = 3
    jstep, tstep, params = _builds(("PSLoadBalancing", {"staleness": k}))
    _, jstate, tstate = _run(jstep, tstep, params, [5.0, 7.0])
    assert set(tstate.stale_state) == {"w"}
    assert tuple(tstate.stale_state["w"].shape) == (k,)
    np.testing.assert_allclose(tstate.stale_state["w"].numpy(), [0.0, 5.0, 7.0])
    np.testing.assert_array_equal(tstate.stale_state["w"].numpy(),
                                  np.asarray(jstate.stale_state["w"]))


def test_staleness_with_momentum_matches_manual_optax():
    opt = ("momentum", {"learning_rate": 0.1, "momentum": 0.9})
    jstep, tstep, params = _builds(("PS", {"staleness": 1}), opt=opt, w0=1.0)
    gs = [0.0, 2.0, 4.0]
    got, _, _ = _run(jstep, tstep, params, gs)
    tx = optax.sgd(0.1, momentum=0.9)
    ref = {"w": np.array(1.0, np.float32)}
    state = tx.init(ref)
    for (jw, tw), g in zip(got, [0.0] + gs[:-1]):
        upd, state = tx.update({"w": np.array(g, np.float32)}, state, ref)
        ref = optax.apply_updates(ref, upd)
        np.testing.assert_allclose(jw, float(ref["w"]), rtol=1e-6)
        np.testing.assert_allclose(tw, float(ref["w"]), rtol=1e-6)


#: Parallax puts only sparse variables on PS: the embedding model's table.
CASES = [(b, m) for b in ("PS", "PSLoadBalancing", "PartitionedPS")
         for m in ("dense", "embed")] + [("Parallax", "embed")]


@pytest.mark.parametrize("builder,model", CASES, ids=[f"{b}-{m}" for b, m in CASES])
def test_stale_builders_match_jax(builder, model):
    np_inputs = td.inputs()
    params, batch = np_inputs[model]
    c = dict(td.case(f"{builder}/{model}", model, builder, {"staleness": 2}, "adam"), steps=4)
    rs = JResourceSpec(resource_dict={"nodes": [
        {"address": "localhost", "chips": 1, "chief": True}]})
    jopt = JOptimizerSpec(c["opt"], dict(c["opt_kwargs"]))
    jloss = td.JAX_LOSSES[model]
    item = jmi.ModelItem.from_params(params, optimizer_spec=jopt, loss_fn=jloss,
                                     example_batch=batch)
    strategy = jstrat.StrategyCompiler(item).compile(
        jstrat.from_name(builder, staleness=2).build(item, rs))
    plan = JGT(strategy, item, jbuild_mesh(rs, devices=jax.devices()[:1])).transform()
    jstep = JStep(plan, jloss, jopt.make())
    jstate = jstep.init(params)
    for _ in range(c["steps"]):
        jstate, _ = jstep(jstate, batch)

    tparams, tbatch = td.to_torch(params), td.to_torch(batch)
    ad, step, state, losses, _, _ = worker.train(c, tparams, tbatch)
    stale = {n for n, p in ad.plan.var_plans.items() if p.staleness}
    want_stale = {n for n, p in plan.var_plans.items() if p.staleness}
    assert stale == want_stale and stale
    td.assert_params_close({k: v.detach().numpy() for k, v in
                            flatten_params(step.logical_params(state)).items()},
                           td.flat_np(jax.tree.map(np.asarray, jstep.logical_params(jstate))),
                           what=builder)
    renderings = {n: ad.plan.rendering(n) for n in ad.plan.var_plans}
    carried = stale_state_from_jax(jax.tree.map(np.asarray, jstate.stale_state), renderings,
                                   device="cpu")
    for name, buf in state.stale_state.items():
        np.testing.assert_allclose(buf.numpy(), carried[name].numpy(), rtol=td.PARAM_RTOL,
                                   atol=td.PARAM_ATOL, err_msg=name)
