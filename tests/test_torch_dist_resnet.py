"""Port parity of the multi-rank step on ResNet, with BatchNorm global or
local as JAX's step has it (4 gloo ranks, one process each, on the CPU).

A small ResNet-18 (fp32, width 8, 32 px, 10 classes, global batch 16: 4
images a rank), two SGD steps under AllReduce, AllReduce with buckets,
Zero1 and PartitionedPS. BatchNorm takes the global batch's statistics
where JAX's step is one GSPMD program (AllReduce, PartitionedPS: two
all-reduces per BatchNorm a step, and the port's one-process step agrees)
and this rank's where JAX runs its manual sync (buckets, Zero1: none); the
two modes give different losses, and each is held to JAX's 4-device step.

ResNet's fp32 gradients at initialisation move with summation order
(``tests/test_torch_resnet.py``), far more with 4-image statistics: JAX's
own update moves by 0.19% (relative L2) when it runs again with each
rank's rows reversed (the same statistics, summed in another order), where
the 16-image global statistics move it by 5e-6. So the port is held to
twice JAX's own spread: the whole update (params after minus before)
within twice that relative L2 distance, every element within rtol 1e-5
and an atol of the larger of lr x steps x 1e-4 (that file's bound) and
twice the largest element change the reversal makes, the losses within
1e-5 and twice the reversal's change of the loss; the wire as the plan
predicts.
"""
import importlib

import jax
import numpy as np
import pytest

from autodist_tpu_torch.models.convert import params_from_jax
from helpers import torch_dist as td
from test_torch_dist_models import as_np, filled

JR = importlib.import_module("autodist_tpu.models.resnet")
DEPTH, WIDTH, CLASSES, IMAGE, BATCH = 18, 8, 10, 32, 16
LR, STEPS, RANKS = 0.01, 2, 4
BUILDERS = [("AllReduce", "AllReduce", {}),
            ("AllReduce-buckets", "AllReduce", {"bucket_bytes": 4096}),
            ("Zero1", "Zero1", {}), ("PartitionedPS", "PartitionedPS", {})]
GLOBAL_BN = {"AllReduce", "PartitionedPS"}
CASES = [dict(id=bid, model="resnet", zoo="resnet", depth=DEPTH, builder=b,
              builder_kwargs=kw, opt="sgd", opt_kwargs={"learning_rate": LR},
              clip_norm=None, steps=STEPS) for bid, b, kw in BUILDERS]


def _inputs():
    params = filled(jax.eval_shape(lambda k: JR.init_params(k, DEPTH, CLASSES, width=WIDTH),
                                   jax.random.PRNGKey(0)), 2)
    return params, as_np(JR.image_example_batch(IMAGE, CLASSES)(BATCH))


def _reversed_in_blocks(batch):
    return {k: v.reshape((RANKS, -1) + v.shape[1:])[:, ::-1].reshape(v.shape)
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params, batch = _inputs()
    torch_inputs = {"resnet": (params_from_jax(params, device="cpu"), td.to_torch(batch))}
    results = td.run_ranks(tmp_path_factory.mktemp("ranks"), torch_inputs, CASES)
    return results, (params, batch), torch_inputs


def _rel_update(a, b, start):
    """Relative L2 distance of two updates ``a - start`` and ``b - start``."""
    num = sum(float(np.sum((a[n] - b[n]) ** 2)) for n in b)
    return np.sqrt(num / sum(float(np.sum((b[n] - start[n]) ** 2)) for n in b))


def _close(got, want, spread, start, what):
    assert _rel_update(got, want, start) <= 2 * _rel_update(spread, want, start), what
    atol = max(LR * 1e-4 * STEPS,
               2 * max(float(np.max(np.abs(spread[n] - w))) for n, w in want.items()))
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=atol,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("c", CASES, ids=lambda c: c["id"])
def test_resnet_matches_jax_with_batchnorm_global_or_local(c, runs):
    results, (params, batch), torch_inputs = runs
    got = results[0][c["id"]]
    for res in results[1:]:
        for name, value in got["params"].items():
            np.testing.assert_array_equal(res[c["id"]]["params"][name], value, err_msg=name)
    loss = td.jax_resnet_loss(DEPTH)
    jlosses, jparams = td.jax_train(c, params, batch, loss)
    slosses, spread = td.jax_train(c, params, _reversed_in_blocks(batch), loss)
    jparams, spread, start = td.flat_np(jparams), td.flat_np(spread), td.flat_np(params)
    _close(got["params"], jparams, spread, start, "vs JAX")
    loss_atol = 2 * float(np.max(np.abs(np.subtract(slosses, jlosses))))
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5, atol=loss_atol)
    assert got["manual"] == (c["id"] not in GLOBAL_BN)
    batchnorms = sum(1 for n in got["params"] if n.endswith("/scale"))
    for counts in got["collectives"]:
        assert td.wire_counts(counts) == got["predicted"]
        want = {"all_reduce": 2 * batchnorms} if c["id"] in GLOBAL_BN else {}
        assert counts.get("stats", {}) == want
    if not got["manual"]:
        losses, one = td.one_process(c, *torch_inputs["resnet"])
        _close(one, jparams, spread, start, "one process vs JAX")
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)


def test_batchnorm_modes_differ(runs):
    """Local and global statistics are different computations here (4
    images a rank against 16): the parity above holds each to JAX."""
    results = runs[0][0]
    glob = results["AllReduce"]["losses"][1]
    for bid in ("AllReduce-buckets", "Zero1"):
        local = results[bid]["losses"][1]
        assert abs(local - glob) > 1e-4 * abs(glob), (bid, local, glob)
