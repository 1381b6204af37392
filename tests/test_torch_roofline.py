"""Port parity: the roofline walk (``utils/roofline.py``) against the JAX
package's jaxpr walk (``autodist_tpu/utils/roofline.py``).

The same inputs (numpy, from a seed; parameters carried over with
``params_from_jax``) go through both packages' ``traffic_bounds``:

- the hand counts of ``tests/test_roofline.py``: one dot (768 + 128 bytes),
  two chained dots (768 + 64 + 128 + 2 x 128) and the elementwise chain
  (8 x 16 x 4 + 4), exactly;
- the value and gradient of the zoo ``mlp`` and of the dot-attention
  ``transformer`` and ``bert_base`` at toy widths: FLOPs exactly equal
  (both count 2 x MACs of every product);
- ResNet-18: the forward's FLOPs exactly; JAX's walk over-counts the weight
  gradient convolutions (``autodist_tpu/utils/roofline.py:74-81``), so of
  the backward only the ratio is printed and JAX's is held to be the larger;
- ``roofline_times`` equal to JAX's on the same bounds.

A kernel's plain version stands in for it inside the walk: its FLOPs are
the plain version's, its bytes the kernel's (``kernel_bytes``).
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.utils import roofline as jroofline
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.models.convert import flatten_params, params_from_jax, unflatten_params
from autodist_tpu_torch.ops import flash_attention as fa
from autodist_tpu_torch.ops import fused_conv_stats as fcs
from autodist_tpu_torch.utils import roofline
from helpers import torch_dist as td

TOY = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4, d_ff=64, max_seq_len=16,
           attention_impl="dot")
#: (zoo name, overrides, dtype-taking): the models held to JAX's count.
MODELS = [("mlp", dict(in_dim=16, hidden=(32,), num_classes=4), False),
          ("transformer", TOY, True),
          ("bert_base", TOY, True)]


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def filled(shapes, seed):
    """The JAX tree of ``shapes`` filled from a numpy seed."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda leaf: (rng.standard_normal(leaf.shape) * 0.1).astype(leaf.dtype),
                        shapes)


def _pair(name, overrides, dtyped):
    kw = dict(overrides, dtype=jnp.float32) if dtyped else dict(overrides)
    jspec = jax_get_model(name, **kw)
    tspec = get_model_spec(name, **(dict(overrides, dtype="float32") if dtyped else overrides))
    params = filled(jax.eval_shape(jspec.init, jax.random.PRNGKey(0)), 3)
    batch = jax.tree.map(np.asarray, jspec.example_batch(4))
    return jspec, tspec, params, batch


def _value_and_grad(loss_fn):
    """The port's counterpart of ``jax.value_and_grad(loss_fn)`` over a
    flat parameter dict."""
    def vg(flat, batch):
        loss = loss_fn(unflatten_params(flat), batch)
        return loss, torch.autograd.grad(loss, [t for t in flat.values() if t.requires_grad])
    return vg


def _flat(params):
    return {k: v.requires_grad_(v.is_floating_point())
            for k, v in flatten_params(params_from_jax(params, device="cpu")).items()}


# -------------------------------------------------------------- hand counts
def test_single_dot_bounds_hand_computed():
    rng = np.random.default_rng(0)
    x, w = _normal(rng, 8, 16), _normal(rng, 16, 4)
    got = roofline.traffic_bounds(lambda a, b: a @ b, torch.from_numpy(x), torch.from_numpy(w))
    want = jroofline.traffic_bounds(lambda a, b: a @ b, jnp.asarray(x), jnp.asarray(w))
    assert got["flops"] == want["flops"] == 2 * 8 * 16 * 4
    assert got["lower_bytes"] == want["lower_bytes"] == 768 + 128
    assert got["upper_bytes"] == want["upper_bytes"] == 768 + 128
    assert got["arg_bytes"] == want["arg_bytes"] and got["out_bytes"] == want["out_bytes"]


def test_chained_dots_count_intermediate_materialization():
    rng = np.random.default_rng(1)
    xs = [_normal(rng, 8, 16), _normal(rng, 16, 4), _normal(rng, 4, 4)]
    got = roofline.traffic_bounds(lambda x, w1, w2: (x @ w1) @ w2,
                                  *[torch.from_numpy(a) for a in xs])
    want = jroofline.traffic_bounds(lambda x, w1, w2: (x @ w1) @ w2,
                                    *[jnp.asarray(a) for a in xs])
    assert got["lower_bytes"] == want["lower_bytes"] == 768 + 64 + 128 + 2 * 128
    assert got["flops"] == want["flops"]
    assert got["lower_bytes"] <= got["upper_bytes"]


def test_elementwise_chain_fuses_in_lower_bound():
    x = _normal(np.random.default_rng(2), 8, 16)
    got = roofline.traffic_bounds(lambda a: torch.tanh(torch.exp(a) + 1.0).sum(),
                                  torch.from_numpy(x))
    want = jroofline.traffic_bounds(lambda a: jnp.tanh(jnp.exp(a) + 1.0).sum(), jnp.asarray(x))
    assert got["lower_bytes"] == want["lower_bytes"] == 8 * 16 * 4 + 4
    assert got["upper_bytes"] > got["lower_bytes"]
    assert got["flops"] == want["flops"] == 0


def test_walk_runs_on_meta_tensors_and_reads_no_values():
    seen = []

    def fn(x):
        seen.append(x.device.type)
        return x.sum()

    out = roofline.traffic_bounds(fn, np.ones((3, 5), np.float32))
    assert seen == ["meta"] and out["arg_bytes"] == 60 and out["out_bytes"] == 4


@pytest.mark.parametrize("flops,nbytes", [(197e12, 1), (1, 819e9)])
def test_roofline_times_pick_binding_side(flops, nbytes):
    bounds = {"flops": flops, "lower_bytes": nbytes, "upper_bytes": nbytes}
    got = roofline.roofline_times(bounds, peak_flops=197e12, bw_bytes_per_s=819e9)
    want = jroofline.roofline_times(bounds, peak_flops=197e12, bw_bytes_per_s=819e9)
    assert got == want
    assert got["t_roofline_s"] == pytest.approx(1.0)


# --------------------------------------------------------- value and grad
@pytest.mark.parametrize("name,overrides,dtyped", MODELS, ids=[m[0] for m in MODELS])
def test_value_and_grad_flops_equal_jax(name, overrides, dtyped):
    jspec, tspec, params, batch = _pair(name, overrides, dtyped)
    want = jroofline.traffic_bounds(jax.value_and_grad(jspec.loss_fn), params, batch)
    got = roofline.traffic_bounds(_value_and_grad(tspec.loss_fn), _flat(params),
                                  td.to_torch(batch))
    assert got["flops"] == want["flops"] > 0
    fwd_j = jroofline.traffic_bounds(jspec.loss_fn, params, batch)["flops"]
    fwd = roofline.traffic_bounds(lambda p, b: tspec.loss_fn(unflatten_params(p), b),
                                  _flat(params), td.to_torch(batch))["flops"]
    assert fwd == fwd_j


def test_resnet_forward_flops_exact_backward_ratio():
    overrides = dict(depth=18, num_classes=10, image_size=32)
    jspec = jax_get_model("resnet", **overrides)
    tspec = get_model_spec("resnet", **overrides)
    params = filled(jax.eval_shape(jspec.init, jax.random.PRNGKey(0)), 5)
    batch = jax.tree.map(np.asarray, jspec.example_batch(2))
    fwd_j = jroofline.traffic_bounds(jspec.loss_fn, params, batch)["flops"]
    fwd = roofline.traffic_bounds(lambda p, b: tspec.loss_fn(unflatten_params(p), b),
                                  _flat(params), td.to_torch(batch))["flops"]
    assert fwd == fwd_j > 0
    vg_j = jroofline.traffic_bounds(jax.value_and_grad(jspec.loss_fn), params, batch)["flops"]
    vg = roofline.traffic_bounds(_value_and_grad(tspec.loss_fn), _flat(params),
                                 td.to_torch(batch))["flops"]
    print(f"resnet18 value-and-grad FLOPs: JAX walk / port = {vg_j / vg:.4f}")
    assert vg_j >= vg > fwd


# ------------------------------------------------------------------ kernels
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernels_count_plain_flops_and_kernel_bytes(causal):
    b, s, h, d = 2, 128, 2, 64
    q = torch.empty(b, s, h, d)
    row = torch.empty(b, h, s)
    full = fa.kernel_flops(q, "fwd", False) // 2     # one product over every score
    for kind, fn, args, products in (
            ("fwd", fa.flash_fwd, (q, q, q), 2),
            ("dkdv", fa.flash_dkdv, (q, q, q, q, row, row), 4),
            ("dq", fa.flash_dq, (q, q, q, q, row, row), 3)):
        got = roofline.traffic_bounds(lambda *a: fn(*a, causal=causal), *args)
        # The plain version computes every score and masks (causal too).
        assert got["flops"] == products * full, kind
        assert got["upper_bytes"] == fa.kernel_bytes(q, kind), kind
        if not causal:
            assert got["flops"] == fa.kernel_flops(q, kind, False), kind


def test_flash_attention_backward_counts_the_recomputation():
    b, s, h, d = 2, 128, 2, 64
    q, k, v = (torch.empty(b, s, h, d, requires_grad=True) for _ in range(3))

    def vg(q, k, v):
        out = fa.flash_attention(q, k, v)
        return torch.autograd.grad(out.sum(), (q, k, v))

    got = roofline.traffic_bounds(vg, q, k, v)["flops"]
    assert got == sum(fa.kernel_flops(q, kind, False) for kind in ("fwd", "dkdv", "dq"))


def test_fused_conv_stats_counts_its_product_and_bytes():
    x, w = torch.empty(256, 64), torch.empty(64, 32)
    got = roofline.traffic_bounds(fcs.fused_matmul_stats, x, w)
    assert got["flops"] == fcs.kernel_flops(x, w)
    assert got["upper_bytes"] == fcs.kernel_bytes(x, w)
    # Its outputs are the program's: nothing materialises in between.
    assert got["lower_bytes"] == got["arg_bytes"] + got["out_bytes"]


def test_kernel_call_outside_a_walk_is_the_plain_call():
    x, w = torch.randn(8, 4), torch.randn(4, 3)
    y, s1, s2 = fcs.fused_matmul_stats(x, w)
    py, p1, p2 = fcs.fused_matmul_stats_plain(x, w)
    assert torch.equal(y, py) and torch.equal(s1, p1) and torch.equal(s2, p2)


def test_kernel_call_on_another_thread_is_not_counted_in_a_walk():
    """A walk is its thread's: a kernel's plain run on another thread (a
    server's, a user's) adds nothing to it and leaves its byte count on."""
    q, x = torch.randn(1, 128, 1, 64), torch.empty(4, 4, device="meta")
    walk = roofline.OpWalk()
    with walk:
        t = threading.Thread(target=fa.flash_fwd, args=(q, q, q))
        t.start()
        t.join()
        assert walk.flops == walk.unfused_bytes == walk._in_kernel == 0
        torch.mm(x, x)
    assert walk.flops == 2 * 4 ** 3 and walk.unfused_bytes == 3 * 16 * 4
