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
plain version in fp64 (1e-10) and ``gradcheck``. The bf16 CUDA kernel's
column sums are emulated here in fp32 in its own order (a thread's two rows,
an xor tree over 8 lanes, 8 warps in order, the run of M tiles, the
partials over 32 lanes and a 5-level tree) and held to the same tolerances.
The ``cuda``-marked cases hold the CUDA kernel against the plain version on
the card (ragged M, K = N from 64 to 2048, ResNet-50's main and deepest
shapes, bf16 and fp32; a repeated launch bitwise equal) and skip here.
There the summation-order terms take the worst-case bound of a sum of n
fp32 terms in any order, ``n * 2^-24`` of the terms' magnitudes, for each
side: ``2K * 2^-24`` for y, and 1e-4 for the sums, which holds while no term
goes through more than 1e-4 / 2^-24 = 1,677 additions
(``fcs.chain_length``).
"""
import collections
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from autodist_tpu_torch.models import resnet as rn
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
    # ResNet-50's first bottleneck shape at batch 128, 224 px: one 256-wide N
    # tile, so x is read once; 3136 M tiles over 131 blocks of 24.
    m, k, n = 128 * 56 * 56, 64, 256
    x, w = torch.empty((m, k), dtype=torch.bfloat16, device="meta"), torch.empty(
        (k, n), dtype=torch.bfloat16, device="meta")
    assert [fcs.block_n(v) for v in (8, 24, 64, 72, 128, 200, 256, 512, 2048)] == [
        64, 64, 64, 128, 128, 256, 256, 256, 256]
    assert fcs.tiles_per_block(m, n) == 24 and fcs.groups(m, n) == 131
    # N = 1024: 4 N tiles share the SMs, 33 runs of 6 tiles each: 132 blocks.
    assert fcs.tiles_per_block(25088, 1024) == 6 and fcs.groups(25088, 1024) == 33
    assert fcs.tiles_per_block(1000, 64) == 1 and fcs.groups(1000, 64) == 8
    # Runs stop at MAX_RUN tiles however large M grows.
    huge = 1 << 30
    assert fcs.tiles_per_block(huge, 64) == fcs.MAX_RUN == 512
    assert fcs.groups(huge, 64) == huge // 128 // 512
    # The fp32 FMA kernel keeps its own schedule: 64-wide N tiles, about
    # eight blocks an SM, at most 65535 groups.
    assert fcs.tiles_per_block(m, n, torch.float32) == 11      # 3136 x 4 tiles / 1056
    assert fcs.groups(huge, 64, torch.float32) <= 65535
    nbytes, flops = fcs.kernel_bytes(x, w), fcs.kernel_flops(x, w)
    assert nbytes == (m * k + k * n + m * n) * 2 + 8 * n
    assert flops == 2 * m * k * n
    bound_ms = max(nbytes / 3.35e12, flops / 989e12) * 1e3
    assert abs(bound_ms - 0.0767) < 1e-3 and nbytes / 3.35e12 > flops / 989e12


@pytest.mark.parametrize("shape", [s for s, _ in chip_smoke.CONV_SHAPES],
                         ids=["x".join(map(str, s)) for s, _ in chip_smoke.CONV_SHAPES])
def test_smem_plan_fits_and_keeps_w_resident_where_it_fits(shape):
    """The shared-memory plan at each ResNet-50 shape: within the 227 KB a
    block may have, a ring of 3 to 6 stages, w resident exactly when all its
    K chunks fit beside 3 stages (so always at K <= 128, for every N)."""
    _, k, n = shape
    plan = fcs.smem_plan(k, n)
    assert plan["bn"] == fcs.block_n(n) and plan["k_chunks"] == math.ceil(k / 64)
    assert plan["smem"] <= 232448 and 3 <= plan["stages"] <= 6
    w_all = plan["k_chunks"] * plan["bn"] * 128
    epilogue = 2 * plan["bn"] * 128 + 2 * 8 * plan["bn"] * 4
    fits = w_all + 3 * 128 * 128 + epilogue + 104 + 1024 <= 232448
    assert plan["resident"] == int(fits)
    if k <= 128:
        assert plan["resident"]


def test_resnet50_forward_launches_the_smoke_shapes():
    """chip_smoke's CONV_SHAPES are the 1x1 convs of the port's ResNet-50
    forward at batch 128, 224 px (traced on meta tensors), with their
    launches: 15 shapes, 36 launches."""
    params = rn.init_params(0, 50, 1000, device="cpu")
    params = torch.utils._pytree.tree_map(lambda t: t.to("meta"), params)
    seen = collections.Counter()
    apply = fcs.FusedConvStatsFn.apply

    def record(x, w):
        seen[(x.shape[0], x.shape[1], w.shape[1])] += 1
        return apply(x, w)

    fcs.FusedConvStatsFn.apply = record
    try:
        rn.forward(params, torch.empty((128, 224, 224, 3), device="meta"), 50)
    finally:
        fcs.FusedConvStatsFn.apply = apply
    assert dict(seen) == dict(chip_smoke.CONV_SHAPES)
    assert sum(seen.values()) == rn.fused_launches_per_forward(50) == 36


@pytest.mark.parametrize("m,n", [s[::2] for s, _ in chip_smoke.CONV_SHAPES]
                         + [(1 << 30, 64), (1 << 30, 2048), (2 ** 31 - 1, 256)])
def test_chain_length_stays_under_the_sum_tolerance(m, n):
    """No term of s1 or s2 goes through more than 1e-4 / 2^-24 additions in
    the bf16 kernel, at ResNet-50's shapes (45 at most) and at a huge M
    (1040 at M = 2^30); the fp32 kernel at ResNet-50's shapes."""
    chain = fcs.chain_length(m, n)
    assert chain * 2.0 ** -24 <= chip_smoke.CONV_STAT_TOL
    if m < 1 << 30:
        assert chain <= 45
        assert fcs.chain_length(m, n, torch.float32) * 2.0 ** -24 <= chip_smoke.CONV_STAT_TOL
    elif m == 1 << 30:
        assert chain == 1040


def _emulated_sums(y32, per):
    """s1, s2 of the fp32 product ``y32 [M, N]`` summed as the bf16 kernel
    sums them, in fp32: per 128-row tile, thread (warp w, lane group i)
    adds rows 16w + i and 16w + i + 8; an xor tree adds the 8 lane groups;
    the 8 warps add in order; each run of ``per`` tiles chains its tile
    sums; the partials of the runs add over 32 lanes in order, then in a
    5-level tree."""
    f32 = np.float32
    m, n = y32.shape
    tiles = math.ceil(m / 128)
    y = np.zeros((tiles * 128, n), f32)
    y[:m] = y32
    y = y.reshape(tiles, 8, 2, 8, n)                    # tile, warp, +8, lane group
    pair = [y[:, :, 0] + y[:, :, 1], y[:, :, 0] * y[:, :, 0] + y[:, :, 1] * y[:, :, 1]]
    out = []
    for v in pair:                                        # [tiles, 8 warps, 8 groups, n]
        for step in (1, 2, 4):                            # lanes xor 4, 8, 16
            v = v + v[:, :, np.arange(8) ^ step]
        v = v[:, :, 0]
        tile_sum = v[:, 0]
        for w in range(1, 8):
            tile_sum = tile_sum + v[:, w]
        groups_ = math.ceil(tiles / per)
        part = np.zeros((groups_, n), f32)
        for g in range(groups_):
            run = np.zeros(n, f32)
            for t in range(g * per, min(g * per + per, tiles)):
                run = run + tile_sum[t]
            part[g] = run
        lanes = np.zeros((32, n), f32)
        for lane in range(32):
            for g in range(lane, groups_, 32):
                lanes[lane] = lanes[lane] + part[g]
        for s in (16, 8, 4, 2, 1):
            lanes[:s] = lanes[:s] + lanes[s:2 * s]
        out.append(lanes[0])
    return out


@pytest.mark.parametrize("per", [1, 3, None])
def test_kernel_summation_order_matches_jax_pallas_interpret_and_plain(per):
    """The bf16 kernel's summation order, emulated in fp32 on the product of
    bf16 inputs (exact in fp32 up to the product's own rounding), against the
    JAX Pallas kernel in interpret mode, its ``xla_matmul_stats`` and the
    port's plain version, within the tolerances above. M = 5120 gives 40
    tiles: 40 runs of one tile (more than the 32 lanes), 14 runs of 3, or
    the wrapper's schedule."""
    m, k, n = 5120, 64, 128
    x, w = _inputs(5, m, k, n)
    jx, jw = jnp.asarray(np.abs(x), "bfloat16"), jnp.asarray(w, "bfloat16")
    x64, w64 = np.asarray(jx, np.float64), np.asarray(jw, np.float64)
    y64 = x64 @ w64
    per = per or fcs.tiles_per_block(m, n)
    s1, s2 = _emulated_sums(y64.astype(np.float32), per)
    for impl in (lambda a, b: fused_matmul_stats(a, b, block_m=512, interpret=True),
                 xla_matmul_stats):
        _, js1, js2 = impl(jx, jw)
        _check_stats(s1, js1, y64, "s1")
        _check_stats(s2, js2, y64 * y64, "s2")
    tx = torch.from_numpy(x64.astype(np.float32)).to(torch.bfloat16)
    tw = torch.from_numpy(w64.astype(np.float32)).to(torch.bfloat16)
    _, p1, p2 = fcs.fused_matmul_stats_plain(tx, tw)
    _check_stats(s1, p1.numpy(), y64, "s1")
    _check_stats(s2, p2.numpy(), y64 * y64, "s2")
    assert fcs.chain_length(m, n) == 11 + fcs.tiles_per_block(m, n) + math.ceil(
        fcs.groups(m, n) / 32) + 5


CUDA_SHAPES = [(1000, 64, 64), (4097, 256, 128), (300, 2048, 2048), (25088, 64, 256),
               (6272, 512, 128), (401408, 64, 256), (6272, 2048, 512)]


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
