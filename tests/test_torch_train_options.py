"""Port parity: gradient accumulation and rematerialisation.

- ``grad_accum_steps`` k = 2 and 4: 3 steps of the fp32 causal transformer
  through ``AutoDist(AllReduce).build(..., grad_accum_steps=k)`` against the
  JAX package's with the same k (its 8-device CPU mesh): losses within 1e-5,
  final params within 1e-5 absolute + 1e-4 relative. BatchNorm's statistics
  are per micro-batch in both packages, so a ResNet-18 step with k = 2 is
  held to the JAX package's step with k = 2 (its gradients at ResNet-18's
  bounds, 1e-4 + 1e-3), and differs from the k = 1 step. A batch that k
  does not divide raises ``ValueError`` in both packages; a broadcast leaf
  goes to every micro-step whole; an aux output averages like the loss.
- ``remat``: ``True``, each of the six ``jax.checkpoint_policies`` names and
  ``TransformerConfig.remat`` (transformer and MoE) give the non-remat loss
  and gradients on the CPU to 1e-6 relative, and 3 steps with ``remat=True``
  give the JAX package's remat run to the tolerances above. Each policy
  saves the products that JAX's policy of that name saves (``dot_general``
  with and without batch dims, ``conv_general_dilated``), recorded on a
  ResNet-18 and the dot-attention transformer. An unknown policy raises
  ``ValueError`` in both packages.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from autodist_tpu import api as japi
from autodist_tpu import strategy as jstrat
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.models import layers as JL
from autodist_tpu_torch import api as tapi
from autodist_tpu_torch import strategy as tstrat
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models import resnet as R
from autodist_tpu_torch.models.convert import (flatten_params, params_from_jax,
                                               params_to_numpy, unflatten_params)
from test_torch_zoo import fill_params

JR = importlib.import_module("autodist_tpu.models.resnet")

LM = dict(vocab_size=101, num_layers=2, d_model=64, num_heads=2, d_ff=128, max_seq_len=32,
          attention_impl="dot")
MOE = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=2, d_ff=64, max_seq_len=16,
           num_experts=4)
LOSS_TOL, PARAM_ATOL, PARAM_RTOL, REMAT_RTOL = 1e-5, 1e-5, 1e-4, 1e-6
POLICIES = (True, "nothing_saveable", "everything_saveable", "dots_saveable",
            "checkpoint_dots", "dots_with_no_batch_dims_saveable",
            "checkpoint_dots_with_no_batch_dims")


@pytest.fixture(autouse=True)
def _fresh_autodist():
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()
    yield
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()


def _lm(model="transformer", **extra):
    overrides = dict(LM if model == "transformer" else MOE, **extra)
    jspec = jax_get_model(model, dtype=jnp.float32, **overrides)
    tspec = get_model_spec(model, dtype="float32", **overrides)
    jparams = fill_params(jspec)
    return jspec, jparams, tspec, params_from_jax(jparams, device="cpu")


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten_params(tree).items()}


def _assert_params(got, want):
    got, want = _flat_np(got), _flat_np(want)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=name)


def _both_runs(jspec, jparams, tspec, tparams, batch_size, steps=3, **build):
    jbatch = jspec.example_batch(batch_size)
    tbatch = tspec.example_batch(batch_size, device="cpu")
    jstep = japi.AutoDist(strategy_builder=jstrat.AllReduce()).build(
        jspec.loss_fn, jparams, jbatch, **build)
    jstate, jm = jstep.run(jstep.init(jparams), jbatch, steps)
    tstep = tapi.AutoDist(strategy_builder=tstrat.AllReduce(), device="cpu").build(
        tspec.loss_fn, tparams, tbatch, **build)
    tstate, tm = tstep.run(tstep.init(tparams), tbatch, steps)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    _assert_params(params_to_numpy(tstep.logical_params(tstate)),
                   jax.tree.map(np.asarray, jstep.logical_params(jstate)))
    return tm


# ------------------------------------------------------ gradient accumulation
@pytest.mark.parametrize("k", [2, 4])
def test_grad_accum_matches_jax_with_the_same_k(k):
    jspec, jparams, tspec, tparams = _lm()
    _both_runs(jspec, jparams, tspec, tparams, 8, grad_accum_steps=k)


def test_grad_accum_resnet_is_per_micro_batch_like_jax():
    depth, lr = 18, 0.01            # the default optimizer: SGD at 0.01
    shapes = jax.eval_shape(lambda key: JR.init_params(key, depth, 10, width=8),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)

    def fill(path, leaf):                   # unit scales, zero biases, He kernels
        if len(leaf.shape) == 1:
            one = "scale" in jax.tree_util.keystr(path)
            return (np.ones if one else np.zeros)(leaf.shape, np.float32)
        std = np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    jparams = jax.tree_util.tree_map_with_path(fill, shapes)
    tparams = params_from_jax(jparams, device="cpu")
    jbatch = JR.image_example_batch(32, 10)(16)
    tbatch = {k: torch.from_numpy(v.copy()) for k, v in jbatch.items()}

    def jloss(p, b):
        return JL.softmax_xent(JR.forward(p, b["images"], depth, dtype=jnp.float32),
                               b["labels"])

    def tloss(p, b):
        return L.softmax_xent(R.forward(p, b["images"], depth, dtype=torch.float32),
                              b["labels"])

    # JAX's k = 2: its AutoDist step with grad_accum_steps=2 (one step, SGD
    # at 0.01, the default of both packages).
    jstep = japi.AutoDist(strategy_builder=jstrat.AllReduce()).build(
        jloss, jparams, jbatch, grad_accum_steps=2)
    jstate, jm = jstep.run(jstep.init(jparams), jbatch, 1)
    step = tapi.AutoDist(strategy_builder=tstrat.AllReduce(), device="cpu").build(
        tloss, tparams, tbatch, grad_accum_steps=2)
    state, metrics = step.run(step.init(tparams), tbatch, 1)
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"][0]), rtol=LOSS_TOL)
    # Each step's gradient, (p0 - p1) / lr, held at ResNet-18's gradient
    # bounds (tests/test_torch_resnet.py: 1e-4 absolute + 1e-3 relative).
    start = _flat_np(jparams)
    got = _flat_np(params_to_numpy(step.logical_params(state)))
    want = _flat_np(jax.tree.map(np.asarray, jstep.logical_params(jstate)))
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose((start[name] - got[name]) / lr,
                                   (start[name] - want[name]) / lr, atol=1e-4, rtol=1e-3,
                                   err_msg=name)
    # Per micro-batch statistics: not the full-batch (k = 1) loss.
    full = jax.jit(jloss)(jparams, jbatch)
    assert abs(metrics["loss"].item() - float(full)) > 1e-3


def test_grad_accum_broadcast_leaves_aux_and_indivisible_batches():
    seen = []

    def loss(p, b):
        seen.append((tuple(b["x"].shape), tuple(b["scale"].shape)))
        value = ((p["w"] * b["scale"] - b["x"]) ** 2).mean()
        return value, {"x_sum": b["x"].sum(), "half": torch.tensor(0.5, dtype=torch.float16)}

    params = {"w": torch.ones((3,))}
    batch = {"x": torch.arange(12.0).reshape(4, 3), "scale": torch.full((1, 3), 2.0)}
    step = tapi.AutoDist(strategy_builder="AllReduce", device="cpu").build(
        loss, params, batch, has_aux=True, grad_accum_steps=2)
    _, m = step.run(step.init(params), batch, 1)
    assert seen[-2:] == [((2, 3), (1, 3)), ((2, 3), (1, 3))]
    # The aux averages as a + x/k from zeros, in at least fp32.
    assert m["aux"]["x_sum"].item() == pytest.approx((15.0 + 51.0) / 2)
    assert m["aux"]["half"].dtype == torch.float32 and m["aux"]["half"].item() == 0.5
    with pytest.raises(ValueError, match="divisible"):
        step.run(step.init(params), {"x": torch.zeros((5, 3)), "scale": batch["scale"]}, 1)

    jspec, jparams, tspec, tparams = _lm()
    jstep = japi.AutoDist(strategy_builder=jstrat.AllReduce()).build(
        jspec.loss_fn, jparams, jspec.example_batch(6), grad_accum_steps=4)
    with pytest.raises(ValueError, match="divisible"):
        jstep.run(jstep.init(jparams), jspec.example_batch(6), 1)
    tapi.AutoDist.reset_default()
    tstep = tapi.AutoDist(strategy_builder="AllReduce", device="cpu").build(
        tspec.loss_fn, tparams, tspec.example_batch(6, device="cpu"), grad_accum_steps=4)
    with pytest.raises(ValueError, match="divisible"):
        tstep.run(tstep.init(tparams), tspec.example_batch(6, device="cpu"), 1)
    with pytest.raises(ValueError, match=">= 1"):
        tapi.AutoDist.reset_default()
        tapi.AutoDist(device="cpu").build(tspec.loss_fn, tparams, grad_accum_steps=0)


# ----------------------------------------------------------------------- remat
def _loss_and_grads(loss_fn, params, batch):
    flat = {k: v.clone().requires_grad_(True) for k, v in flatten_params(params).items()}
    loss = loss_fn(unflatten_params(flat), batch)
    return loss.item(), torch.autograd.grad(loss, list(flat.values()))


def _assert_same(a, b):
    (la, ga), (lb, gb) = a, b
    np.testing.assert_allclose(la, lb, rtol=REMAT_RTOL)
    for x, y in zip(ga, gb):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=REMAT_RTOL, atol=1e-12)


@pytest.mark.parametrize("policy", POLICIES, ids=str)
@pytest.mark.parametrize("impl", ["dot", "flash"])
def test_remat_policies_give_the_plain_loss_and_grads(policy, impl):
    *_, tspec, tparams = _lm(attention_impl=impl, max_seq_len=128)
    batch = tspec.example_batch(2, device="cpu")
    plain = _loss_and_grads(tspec.loss_fn, tparams, batch)
    _assert_same(_loss_and_grads(tapi._remat(tspec.loss_fn, policy), tparams, batch), plain)


# aten op -> the JAX primitive of the same product and its params.
_NO_BATCH = {"dimension_numbers": (((1,), (0,)), ((), ()))}
JAX_PRODUCTS = {
    "aten.mm.default": (jax.lax.dot_general_p, _NO_BATCH),
    "aten.addmm.default": (jax.lax.dot_general_p, _NO_BATCH),
    "aten.bmm.default": (jax.lax.dot_general_p,
                         {"dimension_numbers": (((2,), (1,)), ((0,), (0,)))}),
    "aten.convolution.default": (jax.lax.conv_general_dilated_p, {}),
}


def _saved_ops(policy, loss_fn, params, batch, monkeypatch):
    """``{op name: saved?}`` of the ops the policy decides in the forward
    (``True`` and ``"nothing_saveable"`` decide none: all recomputed)."""
    decided = {}
    real = tapi.create_selective_checkpoint_contexts

    def spy(policy_fn):
        def recording(ctx, op, *args, **kwargs):
            out = policy_fn(ctx, op, *args, **kwargs)
            if not ctx.is_recompute:
                decided.setdefault(str(op), set()).add(out == CheckpointPolicy.MUST_SAVE)
            return out
        return real(recording)

    monkeypatch.setattr(tapi, "create_selective_checkpoint_contexts", spy)
    _loss_and_grads(tapi._remat(loss_fn, policy), params, batch)
    assert all(len(v) == 1 for v in decided.values()), decided
    return {op: v.pop() for op, v in decided.items()}


@pytest.mark.parametrize("policy", POLICIES, ids=str)
def test_remat_policies_save_the_products_jax_saves(policy, monkeypatch):
    cnn = get_model_spec("resnet", depth=18, image_size=32, num_classes=10)
    *_, lm, lm_params = _lm(attention_impl="dot", max_seq_len=32)
    saved = {**_saved_ops(policy, cnn.loss_fn, cnn.init(0, device="cpu"),
                          cnn.example_batch(2, device="cpu"), monkeypatch),
             **_saved_ops(policy, lm.loss_fn, lm_params, lm.example_batch(2, device="cpu"),
                          monkeypatch)}
    jax_saves = getattr(jax.checkpoint_policies,
                        "nothing_saveable" if policy is True else policy)
    if policy in (True, "nothing_saveable"):
        assert saved == {}                  # no policy runs: every op recomputed
    else:   # each kind of product was decided (these models make no addmm)
        assert set(JAX_PRODUCTS) - {"aten.addmm.default"} <= set(saved)
    for op, keep in saved.items():
        if op in JAX_PRODUCTS:
            prim, params = JAX_PRODUCTS[op]
            assert keep == jax_saves(prim, **params), op
        else:
            assert keep == (policy == "everything_saveable"), op


@pytest.mark.parametrize("model", ["transformer", "moe_transformer"])
def test_config_remat_checkpoints_each_block_with_the_same_result(model):
    *_, tspec, tparams = _lm(model)
    *_, rspec, _ = _lm(model, remat=True)
    assert rspec.config.remat and not tspec.config.remat
    batch = tspec.example_batch(4, device="cpu")
    _assert_same(_loss_and_grads(rspec.loss_fn, tparams, batch),
                 _loss_and_grads(tspec.loss_fn, tparams, batch))


@pytest.mark.parametrize("remat", [True, "dots_saveable"])
def test_remat_three_steps_match_jax(remat):
    jspec, jparams, tspec, tparams = _lm()
    _both_runs(jspec, jparams, tspec, tparams, 8, remat=remat)


def test_unknown_remat_policy_raises_in_both_packages():
    jspec, jparams, tspec, tparams = _lm()
    with pytest.raises(ValueError, match="remat policy"):
        japi.AutoDist(strategy_builder=jstrat.AllReduce()).build(
            jspec.loss_fn, jparams, jspec.example_batch(8), remat="save_some")
    with pytest.raises(ValueError, match="remat policy"):
        tapi.AutoDist(strategy_builder="AllReduce", device="cpu").build(
            tspec.loss_fn, tparams, tspec.example_batch(8, device="cpu"), remat="save_some")
