"""Multi-rank tests of the port: the toy models, gloo ranks and JAX's step.

- ``inputs()``: the ``tests/test_e2e_numeric.py`` models (a dense
  regression, an embedding lookup) and a masked-mean variant, with params
  and a global batch of 16 drawn from a seeded numpy generator. Their
  widths are chosen so that every rendering shows at 4 ranks: ``b`` (5,)
  pads to 8 when partitioned, the 26-row table pads to 28 when row-sharded
  and falls back to its 8-wide axis when partitioned.
- ``run_ranks``: starts ``world`` worker processes
  (``torch_dist_worker.py``) on a gloo group at ``file://<tmp>/pg`` with a
  group timeout, waits with a join timeout that kills them all and fails
  the test, and returns each rank's results.
- ``jax_train``: the JAX package's step on a mesh of the first ``n`` CPU
  devices (``build_mesh(rs, devices=jax.devices()[:n])``).
"""
from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from autodist_tpu import model_item as jmi
from autodist_tpu import strategy as jstrat
from autodist_tpu.kernel import DistributedTrainStep as JStep
from autodist_tpu.kernel import GraphTransformer as JGraphTransformer
from autodist_tpu.kernel import build_mesh as jbuild_mesh
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec

WORKER = Path(__file__).with_name("torch_dist_worker.py")
REPO = Path(__file__).resolve().parents[2]
JOIN_TIMEOUT_S = 150.0
BATCH, DIN, DOUT, VOCAB, EDIM = 16, 12, 5, 26, 8
PARAM_RTOL, PARAM_ATOL = 2e-5, 2e-6          # tests/test_e2e_numeric.py's

#: (id, builder, kwargs): every ported builder, AllReduce and Zero1 also
#: with buckets small enough to make several.
BUILDERS = [
    ("PS", "PS", {}),
    ("PS-proxy", "PS", {"local_proxy_variable": True}),
    ("PSLoadBalancing", "PSLoadBalancing", {}),
    ("PartitionedPS", "PartitionedPS", {}),
    ("UnevenPartitionedPS", "UnevenPartitionedPS", {}),
    ("AllReduce", "AllReduce", {"chunk_size": 2}),
    ("AllReduce-buckets", "AllReduce", {"chunk_size": 2, "bucket_bytes": 64}),
    ("PartitionedAR", "PartitionedAR", {}),
    ("RandomAxisPartitionAR", "RandomAxisPartitionAR", {"seed": 3}),
    ("Parallax", "Parallax", {}),
    ("Zero1", "Zero1", {}),
    ("Zero1-buckets", "Zero1", {"bucket_bytes": 64}),
]

#: (id, optimizer, kwargs, clip_norm, steps): SGD one step, the rest three.
#: adafactor factors from 4 on, so the toy widths take its factored path.
OPTIMIZERS = {
    "sgd": ("sgd", {"learning_rate": 0.05}, None, 1),
    "adam": ("adam", {"learning_rate": 1e-2}, None, 3),
    "lamb": ("lamb", {"learning_rate": 1e-2, "weight_decay": 0.01}, None, 3),
    "adafactor": ("adafactor", {"learning_rate": 1e-2, "min_dim_size_to_factor": 4},
                  None, 3),
    "clip_norm": ("sgd", {"learning_rate": 0.05}, 0.5, 3),
}


# ------------------------------------------------------------------ models
def jax_dense_loss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] + params["b"] - y) ** 2)


def jax_embed_loss(params, batch):
    ids, y = batch
    pred = (jnp.take(params["embedding"], ids, axis=0) @ params["w"]).squeeze(-1)
    return jnp.mean((pred - y) ** 2)


def jax_masked_loss(params, batch):
    x, y, mask = batch
    err = jnp.mean((x @ params["w"] + params["b"] - y) ** 2, axis=-1)
    return jnp.sum(err * mask) / jnp.sum(mask)


JAX_LOSSES = {"dense": jax_dense_loss, "embed": jax_embed_loss, "masked": jax_masked_loss}


def jax_resnet_loss(depth):
    """JAX's ResNet loss in fp32."""
    import importlib

    from autodist_tpu.models import layers as JL

    JR = importlib.import_module("autodist_tpu.models.resnet")

    def loss(params, batch):
        return JL.softmax_xent(JR.forward(params, batch["images"], depth,
                                          dtype=jnp.float32), batch["labels"])
    return loss


def inputs(seed: int = 0):
    """``{model: (params, batch)}`` as numpy trees (batches are tuples)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    dense = {"w": normal(DIN, DOUT), "b": normal(DOUT)}
    x, y = normal(BATCH, DIN), normal(BATCH, DOUT)
    embed = {"embedding": normal(VOCAB, EDIM), "w": normal(EDIM, 1)}
    ids = rng.integers(0, VOCAB, BATCH).astype(np.int64)
    mask = (rng.random(BATCH) < 0.6).astype(np.float32)
    return {"dense": (dense, (x, y)), "embed": (embed, (ids, normal(BATCH))),
            "masked": (dense, (x, y, mask))}


def to_torch(tree):
    """numpy tree -> torch tree on the CPU (dicts, tuples)."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True))


def flat_np(tree, prefix=""):
    """Nested dict -> {"a/b": np.ndarray} in sorted-key order."""
    out = {}
    for k in sorted(tree):
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(tree[k], dict):
            out.update(flat_np(tree[k], name))
        else:
            out[name] = np.asarray(tree[k])
    return out


def assert_params_close(got, want, rtol=PARAM_RTOL, atol=PARAM_ATOL, what=""):
    """Two flat ``{name: array}`` dicts, leaf by leaf."""
    assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
    for name in want:
        np.testing.assert_allclose(np.asarray(got[name]), np.asarray(want[name]),
                                   rtol=rtol, atol=atol, err_msg=f"{what} {name}")


# ------------------------------------------------------------------ ranks
def run_ranks(tmp_path: Path, inputs_by_model, cases, world: int = 4,
              timeout_s: float = JOIN_TIMEOUT_S, worker: Path = WORKER):
    """Run ``cases`` on ``world`` gloo ranks of ``worker`` (same command
    line as ``torch_dist_worker.py``); each rank's results."""
    job = tmp_path / "job.pt"
    torch.save({"inputs": inputs_by_model, "cases": cases}, job)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(worker), str(job), str(r), str(world),
                               str(tmp_path / "pg"), str(tmp_path)],
                              env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    tails = {r: (tmp_path / f"rank{r}.log").read_text()[-3000:] for r in range(world)}
    assert not hung, f"ranks {hung} did not finish within {timeout_s} s: {tails}"
    bad = {r: p.returncode for r, p in enumerate(procs) if p.returncode != 0}
    assert not bad, f"ranks failed {bad}: {tails}"
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


def case(cid, model, builder, kwargs, opt, **extra):
    name, opt_kwargs, clip, steps = OPTIMIZERS[opt]
    return dict(id=cid, model=model, builder=builder, builder_kwargs=kwargs, opt=name,
                opt_kwargs=opt_kwargs, clip_norm=clip, steps=steps, **extra)


# -------------------------------------------------------------------- JAX
def jax_train(c, params, batch, loss_fn, n: int = 4, evaluate: bool = False):
    """(losses, logical params[, loss of the trained state]) of JAX's step
    on an ``n``-device mesh."""
    rs = JResourceSpec(resource_dict={"nodes": [
        {"address": "localhost", "chips": n, "chief": True}]})
    opt = jmi.OptimizerSpec(c["opt"], dict(c["opt_kwargs"]), clip_norm=c["clip_norm"])
    item = jmi.ModelItem.from_params(params, optimizer_spec=opt, loss_fn=loss_fn,
                                     example_batch=batch)
    strategy = jstrat.from_name(c["builder"], **c["builder_kwargs"]).build(item, rs)
    strategy = jstrat.StrategyCompiler(item).compile(strategy)
    plan = JGraphTransformer(strategy, item, jbuild_mesh(rs, devices=jax.devices()[:n])
                             ).transform()
    step = JStep(plan, loss_fn, opt.make(), grad_accum_steps=c.get("accum", 1))
    state, losses = step.init(params), []
    for _ in range(c["steps"]):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    out = losses, jax.tree.map(np.asarray, step.logical_params(state))
    return out + (float(step.evaluate(state, batch)["loss"]),) if evaluate else out


def wire_counts(counts) -> dict:
    """The gradient + parameter collectives of one step, by kind."""
    out = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0}
    for purpose in ("grad", "param"):
        for kind, k in counts.get(purpose, {}).items():
            out[kind] += k
    return out


def one_process(c, params, batch):
    """(losses, flat params) of the port's step in this process (no group)."""
    from helpers import torch_dist_worker as worker
    from autodist_tpu_torch.models.convert import flatten_params

    _, step, state, losses, _, _ = worker.train(c, params, batch)
    return losses, {k: v.detach().numpy() for k, v in
                    flatten_params(step.logical_params(state)).items()}


def check_case(c, results, np_inputs, torch_inputs):
    """A case's 4 ranks against each other (bitwise), JAX's 4-device step
    and the port's one-process step (both within the e2e tolerances), and
    each step's gradient and parameter wire against the plan's prediction.
    adafactor's statistics over a zero-padded variable take the padding in
    (as JAX's do), so with padding the one-process step is not the same
    computation and only JAX's 4-device step is compared."""
    got = results[0][c["id"]]
    for rank, res in enumerate(results[1:], 1):
        for name, value in got["params"].items():
            np.testing.assert_array_equal(res[c["id"]]["params"][name], value,
                                          err_msg=f"rank {rank} {name}")
    params, batch = np_inputs[c["model"]]
    jlosses, jparams = jax_train(c, params, batch, JAX_LOSSES[c["model"]])
    assert_params_close(got["params"], flat_np(jparams), what="vs JAX 4-device")
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    if not (c["opt"] == "adafactor" and got["padded"]):
        losses, one = one_process(c, *torch_inputs[c["model"]])
        assert_params_close(got["params"], one, what="vs one process")
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for counts in got["collectives"]:
        assert wire_counts(counts) == got["predicted"], (counts, got["predicted"])
        assert counts["metric"] == {"all_reduce": 1}
