"""Port parity: the fused 1x1-conv product + BatchNorm statistics op.

The port's plain version ``fused_matmul_stats_plain`` against the JAX
script ``examples/benchmark/fused_conv_stats.py`` (imported the way
``tests/test_ops.py`` does): its Pallas kernel in interpret mode
(``block_m=512``) and its ``xla_matmul_stats``, on the same numpy-seeded
x ``(2048, 64)`` and w ``(64, 128)``. Tolerances:

- y: in bf16 one bf16 step (2^-7 relative), since the two round fp32 sums
  taken in different orders; plus, in both dtypes, 1e-5 of the sum of the
  products' magnitudes ``|x| @ |w|`` for the summation order itself;
- s1, s2: 1e-5 of the sum of their terms' magnitudes, ``sum |y32|`` and
  ``sum y32²`` (fp32 sums over the rows taken in different orders).

``FusedConvStatsFn``'s ``dx``/``dw`` are held against autograd through the
plain version in fp64 (1e-10) and ``gradcheck``. The ``cuda``-marked cases
hold the CUDA kernel against the plain version on the card (a ragged M,
K = N from 64 to 2048, bf16 and fp32; a repeated launch bitwise equal) and
skip here. There the summation-order terms take the worst-case bound of a
sum of n fp32 terms in any order, ``n * 2^-24`` of the terms' magnitudes,
for each side: ``2K * 2^-24`` for y, and 1e-4 for the sums (the kernel adds
at most 16 x 32 rows in a chain, then about 60 partials: under 600 terms).
"""
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu_torch.ops import fused_conv_stats as fcs

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "examples", "benchmark"))
from fused_conv_stats import fused_matmul_stats, xla_matmul_stats  # noqa: E402

STEP_BF16 = 2.0 ** -7
TOL = 1e-5


def _inputs(seed, m=2048, k=64, n=128):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


def _check_y(got, want, x, w, rtol, sum_tol=TOL):
    got, want = (np.asarray(t, np.float64) for t in (got, want))
    scale = np.abs(np.asarray(x, np.float64)) @ np.abs(np.asarray(w, np.float64))
    err = np.abs(got - want)
    bound = rtol * np.maximum(np.abs(got), np.abs(want)) + sum_tol * scale
    assert (err <= bound).all(), f"y: max err {err.max()}"


def _check_stats(got, want, terms, name, tol=TOL):
    scale = np.abs(terms).sum(0)
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= tol * scale).all(), f"{name}: max err/scale {(err / scale).max()}"


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_matches_jax_pallas_interpret_and_xla(dtype):
    x, w = _inputs(0)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tx, tw = torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w).to(
        getattr(torch, dtype))
    np.testing.assert_array_equal(tx.float().numpy(), np.asarray(jx, np.float32))
    y, s1, s2 = fcs.fused_matmul_stats_plain(tx, tw)
    assert y.dtype == tx.dtype and s1.dtype == s2.dtype == torch.float32
    x32, w32 = np.asarray(jx, np.float64), np.asarray(jw, np.float64)
    y32 = x32 @ w32
    rtol = STEP_BF16 if dtype == "bfloat16" else 0.0
    for impl in (lambda a, b: fused_matmul_stats(a, b, block_m=512, interpret=True),
                 xla_matmul_stats):
        jy, js1, js2 = impl(jx, jw)
        _check_y(y.float().numpy(), np.asarray(jy, np.float32), x32, w32, rtol)
        _check_stats(s1.numpy(), js1, y32, "s1")
        _check_stats(s2.numpy(), js2, y32 * y32, "s2")


def test_wrapper_runs_the_plain_version_off_cuda():
    x, w = (torch.from_numpy(a) for a in _inputs(1, 300, 16, 24))
    fcs.fused_matmul_stats.launches = 0
    for got, want in zip(fcs.fused_matmul_stats(x, w), fcs.fused_matmul_stats_plain(x, w)):
        assert torch.equal(got, want)
    meta = fcs.fused_matmul_stats(x.to("meta"), w.to("meta"))
    assert [tuple(t.shape) for t in meta] == [(300, 24), (24,), (24,)]
    assert fcs.fused_matmul_stats.launches == 0


def test_autograd_matches_the_plain_version_in_fp64():
    x, w = (torch.from_numpy(a).double() for a in _inputs(2, 64, 16, 8))
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((64, 8)))
    leaves = [t.clone().requires_grad_(True) for t in (x, w)]
    y, s1, s2 = fcs.FusedConvStatsFn.apply(*leaves)
    assert not s1.requires_grad and not s2.requires_grad
    got = torch.autograd.grad(y, leaves, g)
    ref = [t.clone().requires_grad_(True) for t in (x, w)]
    want = torch.autograd.grad(fcs.fused_matmul_stats_plain(*ref)[0], ref, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-10, rtol=1e-10)
    assert torch.autograd.gradcheck(lambda a, b: fcs.FusedConvStatsFn.apply(a, b)[0],
                                    [t[:8, :8].clone().requires_grad_(True) for t in (x, w)])


def test_shapes_the_kernel_does_not_take_raise():
    ok = torch.zeros((16, 64)), torch.zeros((64, 32))
    fcs.check_kernel_args(*ok)
    cases = [
        ((torch.zeros((16, 60)), torch.zeros((60, 32))), "multiples of 8"),
        ((torch.zeros((16, 64)), torch.zeros((64, 36))), "multiples of 8"),
        ((torch.zeros((0, 64)), torch.zeros((64, 32))), "M must be positive"),
        ((torch.zeros((16, 64)), torch.zeros((32, 32))), "disagree on K"),
        ((torch.zeros((16, 64)), torch.zeros((64, 32), dtype=torch.bfloat16)), "float32"),
        ((torch.zeros((16, 64), dtype=torch.float16), torch.zeros((64, 32),
                                                                 dtype=torch.float16)),
         "float32"),
        ((torch.zeros((64, 16)).T, torch.zeros((64, 32))), "contiguous"),
        ((torch.zeros((2, 16, 64)), torch.zeros((64, 32))), r"\[M, K\]"),
    ]
    for (x, w), match in cases:
        with pytest.raises(ValueError, match=match):
            fcs.check_kernel_args(x, w)


def test_tiling_and_yardsticks():
    # ResNet-50's first bottleneck shape at batch 128, 224 px.
    m, k, n = 128 * 56 * 56, 64, 256
    x, w = torch.empty((m, k), dtype=torch.bfloat16, device="meta"), torch.empty(
        (k, n), dtype=torch.bfloat16, device="meta")
    assert fcs.tiles_per_block(m, n) == 11               # 3136 x 4 tiles / 1056
    assert fcs.tiles_per_block(1000, 64) == 1
    huge = 1 << 30
    assert math.ceil(math.ceil(huge / 128) / fcs.tiles_per_block(huge, 64)) <= 65535
    nbytes, flops = fcs.kernel_bytes(x, w), fcs.kernel_flops(x, w)
    assert nbytes == (m * k + k * n + m * n) * 2 + 8 * n
    assert flops == 2 * m * k * n
    bound_ms = max(nbytes / 3.35e12, flops / 989e12) * 1e3
    assert abs(bound_ms - 0.0767) < 1e-3 and nbytes / 3.35e12 > flops / 989e12


CUDA_SHAPES = [(1000, 64, 64), (4097, 256, 128), (300, 2048, 2048), (25088, 64, 256),
               (6272, 512, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,k,n", CUDA_SHAPES, ids=[f"{m}x{k}x{n}" for m, k, n in CUDA_SHAPES])
def test_cuda_kernel_matches_plain_version(m, k, n, dtype):
    """The kernel against its plain version on the same card inputs, with
    the tolerances above, and a second launch bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    x, w = (torch.from_numpy(a).to("cuda", dt) for a in _inputs(4, m, k, n))
    x = x.abs()                       # post-ReLU activations, as in the model
    before = fcs.fused_matmul_stats.launches
    y, s1, s2 = fcs.fused_matmul_stats(x, w)
    again = fcs.fused_matmul_stats(x, w)
    torch.cuda.synchronize()
    assert fcs.fused_matmul_stats.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip((y, s1, s2), again))
    py, p1, p2 = fcs.fused_matmul_stats_plain(x, w)
    rtol = STEP_BF16 if dtype == "bfloat16" else 0.0
    x64, w64 = x.double().cpu().numpy(), w.double().cpu().numpy()
    _check_y(y.float().cpu().numpy(), py.float().cpu().numpy(), x64, w64, rtol,
             sum_tol=2 * k * 2.0 ** -24)
    y32 = x64 @ w64
    _check_stats(s1.cpu().numpy(), p1.cpu().numpy(), y32, "s1", tol=1e-4)
    _check_stats(s2.cpu().numpy(), p2.cpu().numpy(), y32 * y32, "s2", tol=1e-4)
