"""Port parity of the host-driven asynchronous PS (``sync=False``;
``runtime/async_ps.py``) against the JAX package's ``AsyncPSTrainer``.

- ``tests/test_async_ps.py``'s ``round_robin`` cases, push for push on the
  same numpy batches: one worker equals sequential SGD, and two workers
  reproduce the stale schedule (worker 1's gradient one version behind).
  The port's losses, lags, workers and parameters against JAX's trainer
  within rtol 1e-6 (one worker) and 1e-5 (two; the JAX test's), and
  against a hand simulation with the port's own pieces.
- Adam through a checkpoint-style resume: a fresh trainer adopting a state
  that went through numpy continues the uninterrupted trajectory.
- SSP at the server: a push more than K versions stale is rejected and
  applies nothing.
- ``AutoDist.build`` routes uniformly ``sync=False`` strategies to the
  trainer (one worker a replica, the strategy's staleness, no plan), and
  rejects mixed strategies and ``host_offload`` / ``grad_accum_steps`` /
  ``remat`` with the JAX package's messages; ``compute_dtype`` composes.
- The threaded schedule on 4 workers with ``staleness=2``: every push
  lands, the lag stays within the bound, versions count the pushes and the
  loss falls.
- A stress run of 16 threads (more than the cores) with a 1 µs switch
  interval on a loss whose gradient does not depend on the parameters:
  after N pushes the parameter is exactly ``-N x lr x g`` (powers of two),
  which a lost or doubled update would break; the run joins within its
  timeout.
"""
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autodist_tpu.runtime.async_ps import AsyncPSTrainer as JAsyncPSTrainer
from autodist_tpu_torch import api
from autodist_tpu_torch.model_item import Optimizer
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime.async_ps import (AsyncPSTrainer, AsyncServerState,
                                                 ParamServer)
from autodist_tpu_torch.strategy import PS, Parallax


def jax_quad_loss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] + params["b"] - y) ** 2)


def quad_loss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] + params["b"] - y) ** 2)


def make_batches(n, seed=0, d=4):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(d, 1)).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.normal(size=(8, d)).astype(np.float32)
        y = x @ w_true + 0.01 * rng.normal(size=(8, 1)).astype(np.float32)
        out.append((x, y))
    return out


def np_params(d=4):
    return {"w": np.zeros((d, 1), np.float32), "b": np.zeros((1,), np.float32)}


def torch_params(d=4):
    return {k: torch.from_numpy(v) for k, v in np_params(d).items()}


def torch_batches(batches):
    return [tuple(torch.from_numpy(a) for a in b) for b in batches]


@pytest.mark.parametrize("n_workers,lr,rtol", [(1, 0.1, 1e-6), (2, 0.05, 1e-5)])
def test_round_robin_matches_jax_push_for_push(n_workers, lr, rtol):
    batches = make_batches(8, seed=3)
    jtr = JAsyncPSTrainer(jax_quad_loss, optax.sgd(lr), n_workers=n_workers,
                          schedule="round_robin")
    js, jm = jtr.run(jtr.init(jax.tree.map(jnp.asarray, np_params())),
                     lambda tick: batches[len(batches) - 1 - tick], len(batches))
    tb = torch_batches(batches)
    tr = AsyncPSTrainer(quad_loss, Optimizer("sgd", learning_rate=lr), n_workers=n_workers,
                        schedule="round_robin", device="cpu")
    ts, tm = tr.run(tr.init(torch_params()), lambda tick: tb[len(tb) - 1 - tick], len(tb))
    assert ts.version == js.version == len(batches)
    np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=rtol)
    np.testing.assert_array_equal(tm["lag"], jm["lag"])
    np.testing.assert_array_equal(tm["worker"], jm["worker"])
    assert tm["max_lag"] == jm["max_lag"] == n_workers - 1
    for k in ("w", "b"):
        np.testing.assert_allclose(ts.params[k].numpy(), np.asarray(js.params[k]), rtol=rtol,
                                   atol=1e-7)

    # The same schedule by hand with the port's pieces.
    opt = Optimizer("sgd", learning_rate=lr)
    params = torch_params()
    slots = opt.init(list(params.values()))
    tick, version, losses, lags = len(tb), 0, [], []
    while tick > 0:
        snap, snap_version, grads = params, version, []
        for _ in range(min(n_workers, tick)):
            tick -= 1
            grads.append(tr.value_and_grad(snap, tb[len(tb) - 1 - tick], torch.device("cpu")))
        for loss, g in grads:
            losses.append(float(loss))
            lags.append(version - snap_version)
            with torch.no_grad():
                ups = opt.update([g["b"], g["w"]], slots, [params["b"], params["w"]])
            params = {"b": params["b"] + ups[0], "w": params["w"] + ups[1]}
            version += 1
    assert tm["loss"].tolist() == np.asarray(losses, np.float32).tolist()
    assert tm["lag"].tolist() == lags
    for k in ("w", "b"):
        assert torch.equal(ts.params[k], params[k])


def test_resume_from_serialized_state_matches_uninterrupted():
    tb = torch_batches(make_batches(6))
    full = AsyncPSTrainer(quad_loss, Optimizer("adam", learning_rate=0.05), n_workers=1,
                          schedule="round_robin", device="cpu")
    s_full, _ = full.run(full.init(torch_params()), lambda t: tb[5 - t], 6)
    first = AsyncPSTrainer(quad_loss, Optimizer("adam", learning_rate=0.05), n_workers=1,
                           schedule="round_robin", device="cpu")
    s, _ = first.run(first.init(torch_params()), lambda t: tb[2 - t], 3)

    def through_numpy(tree):
        if isinstance(tree, dict):
            return {k: through_numpy(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [through_numpy(v) for v in tree]
        return torch.from_numpy(tree.numpy().copy()) if torch.is_tensor(tree) else tree

    restored = AsyncServerState(params=through_numpy(s.params),
                                opt_state=through_numpy(s.opt_state), version=s.version)
    second = AsyncPSTrainer(quad_loss, Optimizer("adam", learning_rate=0.05), n_workers=1,
                            schedule="round_robin", device="cpu")
    s2, _ = second.run(restored, lambda t: tb[5 - t], 3)
    assert s2.version == s_full.version == 6
    for k in ("w", "b"):
        assert torch.equal(s2.params[k], s_full.params[k])


def test_ssp_drops_over_stale_push():
    server = ParamServer(torch_params(), Optimizer("sgd", learning_rate=0.1), staleness=1,
                         device="cpu")
    tr = AsyncPSTrainer(quad_loss, Optimizer("sgd", learning_rate=0.1), n_workers=1,
                        device="cpu")
    _, g = tr.value_and_grad(server.state.params, torch_batches(make_batches(1))[0],
                             torch.device("cpu"))
    assert server.push(g, 0, worker=0) == 1
    assert server.push(g, 0, worker=0) == 2       # lag 1 == K: applied
    before = {k: v.clone() for k, v in server.state.params.items()}
    assert server.push(g, 0, worker=0) == -1      # lag 2 > K: rejected
    assert server.state.version == 2
    for k, v in before.items():
        assert torch.equal(server.state.params[k], v)


def test_default_device_is_the_card():
    """Built directly, the trainer and the server default to CUDA and raise
    without it: nothing falls back to the CPU."""
    tx = Optimizer("sgd", learning_rate=0.1)
    if torch.cuda.is_available():
        assert AsyncPSTrainer(quad_loss, tx, n_workers=1).device.type == "cuda"
        assert ParamServer(torch_params(), tx).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AsyncPSTrainer(quad_loss, tx, n_workers=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ParamServer(torch_params(), tx)


def _autodist(builder):
    api.AutoDist.reset_default()
    return api.AutoDist(resource_spec=ResourceSpec(resource_dict={"nodes": [
        {"address": "localhost", "gpus": 4, "chief": True}]}), strategy_builder=builder,
        device="cpu")


def test_api_routes_sync_false_to_async_trainer():
    ad = _autodist(PS(sync=False, staleness=3))
    batch = torch_batches(make_batches(1))[0]
    step = ad.build(quad_loss, torch_params(), batch)
    assert isinstance(step, AsyncPSTrainer)
    assert step.staleness == 3 and step.n_workers == 4     # one worker a replica
    assert ad.plan is None
    state, metrics = step.run(step.init(torch_params()), lambda tick: batch, 4)
    assert state.version == 4
    assert np.isfinite(metrics["loss"]).all()


def test_api_rejects_mixed_and_spmd_only_knobs():
    params = {"dense": torch.zeros((8, 4)), "embed": torch.zeros((16, 4))}

    def loss_fn(p, batch):
        idx, y = batch
        return torch.mean((p["embed"][idx] @ p["dense"][:4] - y) ** 2)

    batch = (torch.zeros((8,), dtype=torch.int64), torch.zeros((8, 4)))
    with pytest.raises(NotImplementedError, match="mixing sync and async"):
        _autodist(Parallax(sync=False)).build(loss_fn, params, batch,
                                              sparse_names=("embed",))
    batch = torch_batches(make_batches(1))[0]
    for kwargs, what in (({"grad_accum_steps": 4}, "grad_accum_steps"),
                         ({"host_offload": True}, "host_offload"),
                         ({"remat": True}, "remat")):
        with pytest.raises(NotImplementedError, match=what):
            _autodist(PS(sync=False)).build(quad_loss, torch_params(), batch, **kwargs)


def test_async_composes_with_compute_dtype():
    def cast_loss(params, batch):
        x, y = (t.to(params["w"].dtype) for t in batch)   # JAX promotes; torch does not
        return torch.mean((x @ params["w"] + params["b"] - y).float() ** 2)

    batch = torch_batches(make_batches(1))[0]
    ad = _autodist(PS(sync=False))
    step = ad.build(cast_loss, torch_params(), batch, compute_dtype="bfloat16")
    state, metrics = step.run(step.init(torch_params()), lambda tick: batch, 4)
    assert state.params["w"].dtype == torch.float32          # master weights
    assert np.isfinite(metrics["loss"]).all()
    with pytest.raises(ValueError, match="floating"):
        ad.build(cast_loss, torch_params(), batch, compute_dtype="int8")


def test_threaded_run_respects_staleness_bound_and_trains():
    batches = torch_batches(make_batches(32, seed=5))
    tr = AsyncPSTrainer(quad_loss, Optimizer("sgd", learning_rate=0.05), n_workers=4,
                        staleness=2, schedule="threads", device="cpu")
    state, metrics = tr.run(tr.init(torch_params()),
                            lambda tick: batches[tick % len(batches)], 32)
    assert state.version == 32 and len(metrics["loss"]) == 32
    assert metrics["max_lag"] <= 2
    assert sorted(set(metrics["worker"].tolist())) <= [0, 1, 2, 3]
    assert metrics["loss"][-1] < metrics["loss"][0] * 0.5


@pytest.mark.parametrize("staleness", [0, 2])
def test_threaded_stress_loses_no_update(staleness):
    def const_loss(params, batch):
        return (batch * params["w"]).mean()               # d/dw = mean(batch) = 1

    pushes, lr = 64, 0.125
    tr = AsyncPSTrainer(const_loss, Optimizer("sgd", learning_rate=lr), n_workers=16,
                        staleness=staleness, schedule="threads", device="cpu")
    state = tr.init({"w": torch.zeros(())})
    out = {}
    previous = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runner = threading.Thread(target=lambda: out.update(
            zip(("state", "metrics"), tr.run(state, lambda tick: torch.ones(8), pushes))))
        runner.start()
        runner.join(timeout=120)
    finally:
        sys.setswitchinterval(previous)
    assert not runner.is_alive()
    assert out["state"].version == pushes == len(out["metrics"]["loss"])
    assert float(out["state"].params["w"]) == -pushes * lr
    if staleness:
        assert out["metrics"]["max_lag"] <= staleness
