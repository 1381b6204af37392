"""Port parity: the CNN layers, ResNet and its training path.

The JAX package and the port run side by side on the CPU, on the same
numpy-seeded inputs and on JAX weights carried over with
``params_from_jax``. Everything runs in fp32, where the two differ only in
summation order, except where a bf16 case says otherwise:

- ``conv`` (k in 1/3/7, stride 1/2, odd and even sizes), ``max_pool`` and
  ``space_to_depth_stem``: 1e-5 absolute and relative, forward and
  gradients;
- ``batchnorm`` forward and backward against the JAX custom VJP: fp32 1e-5;
  bf16 2e-2 (each side rounds its output to bf16 once, 2^-8 relative, at
  |values| up to about 3); the clamp regime as ``tests/test_models.py``
  checks it; precomputed column sums against a second reduction: 1e-5;
- ResNet-18 at ``width=8``, 32 px, 10 classes, batch 16: loss 1e-5
  relative, gradients 1e-4 absolute + 1e-3 relative;
- ResNet-50 at the same size: its fp32 gradients at initialisation are
  ill-conditioned. Reversing the batch, which changes only the order of
  the sums, moves JAX's own whole gradient by several percent (relative
  L2). So the whole gradient is held to twice JAX's own spread under the
  batch reversal, measured in the test; the loss, a batch average that
  moves far less, to 1e-3; and the head's gradient (the whole forward, but
  no backward through BatchNorm) to 1e-3;
- the ``ModelItem`` VarItem list and AllReduce's ``Strategy`` JSON: equal;
- 3 SGD steps of ``AutoDist(AllReduce, device="cpu")`` against a
  one-device JAX loop (``jax.value_and_grad`` plus the SGD update on
  unsharded arrays; BatchNorm normalises over the whole batch on both
  sides) at depth 18: losses 1e-5 relative, final params 1e-5 relative
  plus lr x steps x the gradients' 1e-4;
- the fused 1x1-conv op's calls per forward, counted by a spy: 36 at depth
  50, 3 at depth 18;
- bf16 against fp32 (ResNet-50, ``width=16``, 64 px, batch 4, the port's
  own weights in both packages): at initialisation the model amplifies
  rounding with depth, and the JAX model's bf16 logits land far (over 1%,
  relative L2) from its fp32 logits. The port's bf16 logits must stay
  within twice the JAX model's drift from fp32, and the two fp32 forwards
  within 1e-3 of each other.

The ``cuda``-marked test runs the model on the card at 224 px at every
depth and skips here.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu import model_item as jmi
from autodist_tpu import strategy as jstrat
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.models import layers as JL
from autodist_tpu.resource_spec import ResourceSpec as JaxResourceSpec
from autodist_tpu_torch import api as tapi
from autodist_tpu_torch import model_item as tmi
from autodist_tpu_torch import strategy as tstrat
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models import resnet as R
from autodist_tpu_torch.models.convert import (flatten_params, params_from_jax,
                                               params_to_numpy, unflatten_params)
from autodist_tpu_torch.ops import fused_conv_stats as fcs
from autodist_tpu_torch.resource_spec import ResourceSpec

JR = importlib.import_module("autodist_tpu.models.resnet")

TOL = 1e-5
LOSS_TOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4, 1e-3
SMALL = dict(width=8, num_classes=10)
IMAGE, BATCH = 32, 16
SPEC_YML = """
nodes:
  - address: 10.0.0.1
    chips: 2
    chief: true
"""


@pytest.fixture(autouse=True)
def _fresh_autodist():
    tapi.AutoDist.reset_default()
    yield
    tapi.AutoDist.reset_default()


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a, requires_grad=False):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_(requires_grad)


def _assert_close(got, want, atol=TOL, rtol=TOL, name=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=rtol,
                               err_msg=name)


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3, 7])
def test_conv_same_padding_matches_jax(k, stride, size):
    rng = _rng(k * 100 + stride * 10 + size)
    x = rng.standard_normal((2, size, size + 1, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    g = rng.standard_normal((2, -(-size // stride), -(-(size + 1) // stride), 5)
                            ).astype(np.float32)
    want, vjp = jax.vjp(lambda xx, ww: JL.conv({"kernel": ww}, xx, stride=stride), x, w)
    want_dx, want_dw = vjp(g)
    tx, tw = _t(x, True), _t(w, True)
    got = L.conv({"kernel": tw}, tx, stride=stride)
    assert tuple(got.shape) == want.shape
    got.backward(_t(g))
    _assert_close(got, want)
    _assert_close(tx.grad, want_dx, name="dx")
    _assert_close(tw.grad, want_dw, name="dw")


@pytest.mark.parametrize("size", [7, 8])
@pytest.mark.parametrize("stride", [1, 2])
def test_fused_1x1_conv_batchnorm_matches_jax(stride, size):
    """The fused path (strided slice, product + sums, batchnorm from the
    sums) against JAX's conv then batchnorm, forward and gradients."""
    rng = _rng(stride * 10 + size)
    x = rng.standard_normal((2, size, size, 16)).astype(np.float32)
    w = rng.standard_normal((1, 1, 16, 8)).astype(np.float32)
    bn = {"scale": rng.random(8).astype(np.float32), "bias": rng.random(8).astype(np.float32)}
    out = -(-size // stride)
    g = rng.standard_normal((2, out, out, 8)).astype(np.float32)

    def jfn(xx, ww, pp):
        return JL.batchnorm(pp, JL.conv({"kernel": ww}, xx, stride=stride))

    want, vjp = jax.vjp(jfn, x, w, bn)
    want_dx, want_dw, want_dbn = vjp(g)
    tx, tw = _t(x, True), _t(w, True)
    tbn = {k: _t(v, True) for k, v in bn.items()}
    got = L.conv_batchnorm({"kernel": tw}, tbn, tx, stride, compute_dtype=torch.float32)
    got.backward(_t(g))
    _assert_close(got, want)
    _assert_close(tx.grad, want_dx, name="dx")
    _assert_close(tw.grad, want_dw, name="dw")
    for k in bn:
        _assert_close(tbn[k].grad, want_dbn[k], name=k)


@pytest.mark.parametrize("size", [7, 8, 112])
@pytest.mark.parametrize("window,stride", [(3, 2), (3, 1), (2, 2)])
def test_max_pool_matches_jax(window, stride, size):
    rng = _rng(size + window * 7 + stride)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    want, vjp = jax.vjp(lambda xx: JL.max_pool(xx, window, stride), x)
    tx = _t(x, True)
    got = L.max_pool(tx, window, stride)
    assert tuple(got.shape) == want.shape
    g = rng.standard_normal(want.shape).astype(np.float32)
    got.backward(_t(g))
    _assert_close(got, want)
    _assert_close(tx.grad, vjp(g)[0], name="dx")


def test_space_to_depth_stem_matches_jax_and_the_7x7_conv():
    rng = _rng(3)
    images = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    kernel = rng.standard_normal((7, 7, 3, 8)).astype(np.float32)
    want = JL.space_to_depth_stem({"kernel": kernel}, images, jnp.float32)
    got = L.space_to_depth_stem({"kernel": _t(kernel)}, _t(images), torch.float32)
    _assert_close(got, want)
    direct = L.conv({"kernel": _t(kernel)}, _t(images), stride=2)
    _assert_close(got, direct.detach().numpy())


def _bn_inputs(dtype):
    rng = _rng(11)
    x = (rng.standard_normal((8, 4, 4, 6)) * 2.0 + 0.5).astype(np.float32)
    p = {"scale": rng.random(6).astype(np.float32), "bias": rng.random(6).astype(np.float32)}
    dy = rng.standard_normal((8, 4, 4, 6)).astype(np.float32)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return x, p, dy, jdt, getattr(torch, dtype)


def _torch_bn_vjp(fn, x, p, dy, tdt, **kw):
    tx = _t(x).to(tdt).requires_grad_(True)
    tp = {k: _t(v, True) for k, v in p.items()}
    y = fn(tp, tx, **kw)
    y.backward(_t(dy).to(tdt))
    return y, tx.grad, {k: v.grad for k, v in tp.items()}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_batchnorm_matches_jax_custom_vjp(dtype, tol):
    x, p, dy, jdt, tdt = _bn_inputs(dtype)
    want, vjp = jax.vjp(JL.batchnorm, p, jnp.asarray(x, jdt))
    want_dp, want_dx = vjp(jnp.asarray(dy, jdt))
    for fn in (L.batchnorm, L._batchnorm_autodiff):
        y, dx, dp = _torch_bn_vjp(fn, x, p, dy, tdt)
        assert y.dtype == tdt and dx.dtype == tdt
        _assert_close(y, np.asarray(want, np.float32), tol, tol, "y")
        _assert_close(dx, np.asarray(want_dx, np.float32), tol, tol, "dx")
        for k in p:
            _assert_close(dp[k], want_dp[k], tol, tol, k)


def test_batchnorm_with_precomputed_sums_matches_reduction():
    # BatchNormFn given the column sums, as conv_batchnorm gives it the
    # fused op's, against batchnorm's own reduction.
    x, p, dy, _, tdt = _bn_inputs("float32")
    rows = _t(x).reshape(-1, 6).double()
    stats = (rows.sum(0).float(), (rows * rows).sum(0).float())

    def with_sums(q, tx):
        return L.BatchNormFn.apply(q["scale"], q["bias"], tx, 1e-5, *stats)

    y, dx, dp = _torch_bn_vjp(with_sums, x, p, dy, tdt)
    want_y, want_dx, want_dp = _torch_bn_vjp(L.batchnorm, x, p, dy, tdt)
    _assert_close(y, want_y.detach().numpy())
    _assert_close(dx, want_dx.numpy(), name="dx")
    for k in p:
        _assert_close(dp[k], want_dp[k].numpy(), name=k)


def test_batchnorm_clamp_regime_matches_jax_and_autodiff():
    # Constant channel value 100: true var 0, the one-pass fp32 var < 0 on
    # some channels. Where the clamp engages, dx reduces to
    # scale·inv·(dy − E[dy]), free of the mean, and must agree with JAX and
    # with autograd through the plain version. y = (x − mean)·inv there, with
    # inv = eps^-1/2 = 316: the two packages' means may differ by 2 ulps of
    # 100 (1.5e-5), so y agrees with JAX to 316 x 1.5e-5 < 5e-3, and with
    # the port's own plain version (the same mean) to 1e-4.
    rng = _rng(5)
    x = (np.full((8, 4, 4, 32), 100.0) + rng.standard_normal((8, 4, 4, 32)) * 1e-4
         ).astype(np.float32)
    p = {"scale": np.ones(32, np.float32), "bias": np.zeros(32, np.float32)}
    dy = rng.standard_normal(x.shape).astype(np.float32)
    want, vjp = jax.vjp(JL.batchnorm, p, jnp.asarray(x))
    want_dp, want_dx = vjp(jnp.asarray(dy))
    y, dx, dp = _torch_bn_vjp(L.batchnorm, x, p, dy, torch.float32)
    y_a, dx_a, dp_a = _torch_bn_vjp(L._batchnorm_autodiff, x, p, dy, torch.float32)
    x32 = jnp.asarray(x)
    j_raw = np.asarray((x32 ** 2).mean((0, 1, 2)) - x32.mean((0, 1, 2)) ** 2)
    tx = _t(x)
    t_raw = ((tx * tx).mean((0, 1, 2)) - tx.mean((0, 1, 2)) ** 2).numpy()
    clamped = (j_raw < 0) & (t_raw < 0)
    assert clamped.any(), "test setup: clamp regime not reached in both packages"
    _assert_close(y, y_a.detach().numpy(), 1e-4, 1e-4, "y vs autodiff")
    _assert_close(y.detach().numpy()[..., clamped], np.asarray(want)[..., clamped],
                  5e-3, 0, "y vs jax")
    for ref in (np.asarray(want_dx), dx_a.numpy()):
        got, ref = dx.numpy()[..., clamped], ref[..., clamped]
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    _assert_close(dp["bias"], want_dp["bias"], 1e-6, 1e-5, "bias")
    _assert_close(dp["bias"], dp_a["bias"].numpy(), 1e-6, 1e-5, "bias vs autodiff")


def test_dense_promotes_mixed_dtypes_like_jax():
    rng = _rng(9)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    k = rng.standard_normal((16, 4)).astype(np.float32)
    want = JL.dense({"kernel": jnp.asarray(k), "bias": jnp.zeros(4)},
                    jnp.asarray(x, jnp.bfloat16))
    got = L.dense({"kernel": _t(k), "bias": torch.zeros(4)}, _t(x).to(torch.bfloat16))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _assert_close(got, want)
    same = L.dense({"kernel": _t(k).bfloat16()}, _t(x).bfloat16())
    assert same.dtype == torch.bfloat16


# -------------------------------------------------------------------- model
def _pair(depth):
    """(JAX params, port params): the JAX tree's structure (``eval_shape`` of
    its ``init_params``, which compiles nothing) filled from numpy with the
    same scales (He-normal kernels, unit BatchNorm scales, zero biases),
    carried over with ``params_from_jax``."""
    shapes = jax.eval_shape(lambda k: JR.init_params(k, depth, SMALL["num_classes"],
                                                     width=SMALL["width"]),
                            jax.random.PRNGKey(0))
    rng = _rng(depth)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return np.ones(leaf.shape, np.float32)
        if "bias" in name:
            return np.zeros(leaf.shape, np.float32)
        std = np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    jparams = jax.tree_util.tree_map_with_path(fill, shapes)
    return jparams, params_from_jax(jparams, device="cpu")


def _batches():
    jbatch = JR.image_example_batch(IMAGE, SMALL["num_classes"])(BATCH)
    tbatch = get_model_spec("resnet", image_size=IMAGE,
                            num_classes=SMALL["num_classes"]).example_batch(BATCH,
                                                                            device="cpu")
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k].numpy(), jbatch[k])
    return jbatch, tbatch


def _jax_loss32(depth):
    def loss(params, batch):
        return JL.softmax_xent(JR.forward(params, batch["images"], depth,
                                          dtype=jnp.float32), batch["labels"])
    return loss


def _torch_loss32(depth):
    def loss(params, batch):
        return L.softmax_xent(R.forward(params, batch["images"], depth,
                                        dtype=torch.float32), batch["labels"])
    return loss


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(depth):
    return jax.jit(jax.value_and_grad(_jax_loss32(depth)))


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten_params(tree).items()}


def _rel(got, want, names=None):
    """Relative L2 distance of two flat gradient dicts (over ``names``)."""
    names = list(want) if names is None else names
    num = sum(((got[n] - want[n]) ** 2).sum() for n in names)
    return float(np.sqrt(num / sum((want[n] ** 2).sum() for n in names)))


@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_loss_and_grads_match_jax(depth):
    jparams, tparams = _pair(depth)
    jbatch, tbatch = _batches()
    vg = _jax_value_and_grad(depth)
    jloss, jgrads = vg(jparams, jbatch)
    flat = {k: v.clone().requires_grad_(True) for k, v in flatten_params(tparams).items()}
    loss = _torch_loss32(depth)(unflatten_params(flat), tbatch)
    got = dict(zip(flat, (g.numpy() for g in torch.autograd.grad(loss, list(flat.values())))))
    want = _flat_np(jgrads)
    assert list(got) == list(want)
    if depth == 18:
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], atol=GRAD_ATOL,
                                       rtol=GRAD_RTOL, err_msg=name)
        return
    # Depth 50: the bounds of the module docstring.
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-3)
    head = [n for n in want if n.startswith("head/")]
    assert _rel(got, want, head) <= 1e-3
    flip = {k: v[::-1].copy() for k, v in jbatch.items()}
    spread = _rel(_flat_np(vg(jparams, flip)[1]), want)
    assert 0 < _rel(got, want) <= 2 * spread


def test_resnet_spec_params_and_batch_match_jax():
    for depth in (18, 50):
        jspec = jax_get_model("resnet", depth=depth)
        tspec = get_model_spec("resnet", depth=depth)
        assert tspec.name == jspec.name == f"resnet{depth}"
        assert tspec.flops_per_example == jspec.flops_per_example
        jparams, _ = _pair(depth)
        tparams = R.init_params(1, depth, SMALL["num_classes"], width=SMALL["width"],
                                device="cpu")
        want = {k: v.shape for k, v in _flat_np(jparams).items()}
        assert {k: tuple(v.shape) for k, v in flatten_params(tparams).items()} == want
    _batches()
    with pytest.raises(ValueError, match="unsupported resnet depth"):
        R.init_params(0, 42, 10, device="cpu")


def test_var_items_and_strategy_json_match_jax(tmp_path):
    jparams, tparams = _pair(50)
    jbatch, tbatch = _batches()
    jspec = jax_get_model("resnet", image_size=IMAGE, num_classes=SMALL["num_classes"])
    tspec = get_model_spec("resnet", image_size=IMAGE, num_classes=SMALL["num_classes"])
    jitem = jmi.ModelItem.from_params(jparams, loss_fn=jspec.loss_fn, example_batch=jbatch)
    titem = tmi.ModelItem.from_params(tparams, loss_fn=tspec.loss_fn, example_batch=tbatch)

    def rows(item):
        return [(v.name, tuple(v.shape), v.dtype, v.trainable, v.sparse_update,
                 v.byte_size) for v in item.variables]

    assert rows(titem) == rows(jitem)
    assert not titem.sparse_variables and titem.batch_size == jitem.batch_size == BATCH

    spec_file = tmp_path / "spec.yml"
    spec_file.write_text(SPEC_YML)
    jstrategy = jstrat.AllReduce().build(jitem, JaxResourceSpec(str(spec_file)))
    tstrategy = tstrat.AllReduce().build(titem, ResourceSpec(str(spec_file)))
    want, got = jstrategy.to_json(), tstrategy.to_json()
    for d in (want, got):
        d["id"] = d["path"] = ""
    import json

    assert got == json.loads(json.dumps(want).replace(":TPU:", ":GPU:"))


def test_three_autodist_sgd_steps_match_one_device_jax():
    depth, lr, steps = 18, 0.01, 3
    jparams, tparams = _pair(depth)
    jbatch, tbatch = _batches()
    vg = _jax_value_and_grad(depth)
    want_losses, p = [], jparams
    for _ in range(steps):
        loss, grads = vg(p, jbatch)
        want_losses.append(float(loss))
        p = jax.tree.map(lambda a, g: a - lr * g, p, grads)

    ad = tapi.AutoDist(strategy_builder=tstrat.AllReduce(), device="cpu")
    step = ad.build(_torch_loss32(depth), tparams, tbatch)
    state, metrics = step.run(step.init(tparams), tbatch, steps)
    np.testing.assert_allclose(metrics["loss"].numpy(), want_losses, rtol=LOSS_TOL)
    got = _flat_np(params_to_numpy(step.logical_params(state)))
    want = _flat_np(jax.tree.map(np.asarray, p))
    assert list(got) == list(want)
    for name in want:
        # Params move by lr x gradient, so they carry the gradients'
        # tolerance scaled by lr on top of their own rounding.
        np.testing.assert_allclose(got[name], want[name], atol=lr * GRAD_ATOL * steps,
                                   rtol=TOL, err_msg=name)


def test_bf16_drift_from_fp32_is_the_jax_models():
    tparams = R.init_params(5, 50, 10, width=16, device="cpu")
    jparams = params_to_numpy(tparams)
    images = get_model_spec("resnet", image_size=64).example_batch(4, device="cpu")["images"]
    jimages = images.numpy()
    jax_logits = {dt: np.asarray(jax.jit(lambda: JR.forward(jparams, jimages, 50, dtype=dt))())
                  for dt in (jnp.bfloat16, jnp.float32)}
    with torch.no_grad():
        port = {dt: R.forward(tparams, images, 50, dtype=dt).numpy()
                for dt in (torch.bfloat16, torch.float32)}

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    jax_drift = rel(jax_logits[jnp.bfloat16], jax_logits[jnp.float32])
    assert 0.01 < jax_drift                      # the setup shows the amplification
    assert rel(port[torch.bfloat16], port[torch.float32]) <= 2 * jax_drift
    assert rel(port[torch.float32], jax_logits[jnp.float32]) <= 1e-3


@pytest.mark.parametrize("depth,launches", [(50, 36), (18, 3)])
def test_fused_conv_launches_per_forward(depth, launches, monkeypatch):
    calls = []
    plain = fcs.fused_matmul_stats

    def spy(x, w):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return plain(x, w)

    monkeypatch.setattr(fcs, "fused_matmul_stats", spy)
    _, tparams = _pair(depth)
    _, tbatch = _batches()
    R.forward(tparams, tbatch["images"], depth)
    assert len(calls) == launches == R.fused_launches_per_forward(depth)
    assert all(k % 8 == 0 and n % 8 == 0 for (_, k), (_, n) in calls)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [18, 34, 50, 101, 152])
def test_cuda_model_hands_the_kernel_only_shapes_it_takes(depth):
    """At full width and 224 px every fused conv of the model launches the
    kernel (a shape it did not take would raise ValueError)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    spec = get_model_spec("resnet", depth=depth)
    params = spec.init(0, device="cuda")
    batch = spec.example_batch(2, device="cuda")
    fcs.fused_matmul_stats.launches = 0
    logits = R.forward(params, batch["images"], depth)
    torch.cuda.synchronize()
    assert fcs.fused_matmul_stats.launches == R.fused_launches_per_forward(depth)
    assert logits.shape == (2, 1000) and torch.isfinite(logits).all()
