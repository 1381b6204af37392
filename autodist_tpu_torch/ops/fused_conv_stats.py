"""Fused 1x1-conv product + BatchNorm statistics (PyTorch port).

The port of ``examples/benchmark/fused_conv_stats.py``: a 1x1 convolution over
NHWC activations is the product ``x [M, K] @ w [K, N]`` with ``M = N*H*W``,
and the BatchNorm that follows it needs the per-column sum and sum of squares
of that output. One kernel computes all three:

- ``y = (x @ w)`` accumulated in fp32, rounded to x's dtype;
- ``s1 = sum_rows(y32)`` and ``s2 = sum_rows(y32 * y32)`` in fp32, from the
  unrounded fp32 product.

The bf16 kernel, the main path's, is a Hopper design: TMA copies into a ring
of shared-memory stages, ``wgmma`` from a producer warp and two consumer
warpgroups, and the statistics taken from the accumulator registers (see the
source's header). fp32 inputs take an FMA kernel, off the main path.

:func:`fused_matmul_stats_plain` is the plain PyTorch version, the JAX
script's ``xla_matmul_stats``. :func:`fused_matmul_stats` launches the CUDA
kernel of ``csrc/fused_conv_stats.cu`` (which replaces the Pallas TPU kernel
``_kernel``) on CUDA tensors and counts the launch, or raises; on CPU and meta
tensors it runs the plain version, because there is no kernel to run there.
:class:`FusedConvStatsFn` makes it differentiable in ``x`` and ``w``.

The schedule (:func:`block_n`, :func:`tiles_per_block`, :func:`smem_plan`)
mirrors the kernel's so that the CPU tests reach it, and
:func:`chain_length` gives the longest addition chain of the column sums,
on which the kernel's tolerance rests.
"""
from __future__ import annotations

import ctypes
import math

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: Rows of an M tile (both kernels); the fp32 kernel's N tile.
BLOCK_M, BLOCK_N = 128, 64
#: The H100 SXM's streaming multiprocessors: the bf16 kernel runs one block
#: on each (its shared memory fills an SM).
SMS = 132
#: At most this many M tiles a bf16 block carries its sums across, so that
#: the longest addition chain stays near a thousand terms even at M = 2^30.
MAX_RUN = 512
#: fp32 kernel: enough blocks to give each SM about eight, at most 16 tiles
#: a block, at most 65535 groups (the grid's y limit).
_FP32_TARGET_BLOCKS = 1056
_FP32_MAX_PER_BLOCK = 16
_FP32_MAX_GROUPS = 65535
# The bf16 kernel's shared memory (csrc/fused_conv_stats.cu::make_plan).
_SMEM_LIMIT = 232448
_SMEM_USABLE = _SMEM_LIMIT - 1024
_X_STAGE = BLOCK_M * 128
_BOX = 64 * 128
_MIN_STAGES, _MAX_STAGES = 3, 6
_BARRIERS = 8 * (2 * _MAX_STAGES + 1)


def fused_matmul_stats_plain(x, w):
    """``(y, s1, s2)``: ``y32 = x @ w`` with both widened to at least fp32,
    ``y = y32`` in x's dtype, ``s1``/``s2`` the column sums of ``y32`` and
    ``y32 * y32`` (the JAX script's ``xla_matmul_stats``). A bf16 x bf16
    product is exact in fp32, so this is the kernel's product up to
    summation order."""
    acc = torch.promote_types(x.dtype, torch.float32)
    y32 = x.to(acc) @ w.to(acc)
    return y32.to(x.dtype), y32.sum(0), (y32 * y32).sum(0)


# ------------------------------------------------------------- CUDA kernel
def check_kernel_args(x, w) -> None:
    """Raise ``ValueError`` on anything the CUDA kernel does not take."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"x must be [M, K] and w [K, N], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    (m, k), (k_w, n) = x.shape, w.shape
    if k != k_w:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} disagree on K")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"x and w must both be float32 or bfloat16, got {x.dtype} "
                         f"and {w.dtype}")
    if m < 1 or k % 8 or n % 8 or k < 8 or n < 8:
        raise ValueError(f"shape x {tuple(x.shape)} @ w {tuple(w.shape)}: M must be "
                         "positive and K, N positive multiples of 8")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def block_n(n: int) -> int:
    """Columns of the bf16 kernel's N tile: 64, 128 or 256, the least that
    covers N up to 256, so that x is read from device memory once."""
    return 64 if n <= 64 else 128 if n <= 128 else 256


def tiles_per_block(m: int, n: int, dtype=torch.bfloat16) -> int:
    """M tiles each block walks (its run). bf16: as many as spread the M
    tiles of each N tile over the 132 SMs in one wave, at most
    :data:`MAX_RUN`. fp32: about eight blocks an SM, at most 16 tiles, at
    most 65535 groups."""
    tiles_m = math.ceil(m / BLOCK_M)
    if dtype == torch.bfloat16:
        tiles_n = math.ceil(n / block_n(n))
        return max(1, min(MAX_RUN, math.ceil(tiles_m / max(1, SMS // tiles_n))))
    tiles_n = math.ceil(n / BLOCK_N)
    per = max(1, min(_FP32_MAX_PER_BLOCK, tiles_m * tiles_n // _FP32_TARGET_BLOCKS))
    return max(per, math.ceil(tiles_m / _FP32_MAX_GROUPS))


def groups(m: int, n: int, dtype=torch.bfloat16) -> int:
    """Runs along M: rows of the ``[groups, N]`` partials."""
    return math.ceil(math.ceil(m / BLOCK_M) / tiles_per_block(m, n, dtype))


def smem_plan(k: int, n: int) -> dict:
    """The bf16 kernel's shared memory at ``(k, n)``: N tile ``bn``, 64-deep
    K chunks, ring ``stages``, whether w stays ``resident`` for the run
    (when it fits beside at least 3 stages), and the dynamic ``smem`` bytes.
    Mirrors ``make_plan`` in the CUDA source (``chip_smoke.py`` compares)."""
    bn = block_n(n)
    k_chunks = math.ceil(k / 64)
    w_chunk = bn // 64 * _BOX
    epilogue = 2 * w_chunk + 2 * 8 * bn * 4
    room = _SMEM_USABLE - epilogue - _BARRIERS
    w_all = k_chunks * w_chunk
    resident = int((room - w_all) // _X_STAGE >= _MIN_STAGES)
    if resident:
        stages = min(_MAX_STAGES, (room - w_all) // _X_STAGE)
        smem = stages * _X_STAGE + w_all
    else:
        stages = min(_MAX_STAGES, room // (_X_STAGE + w_chunk))
        smem = stages * (_X_STAGE + w_chunk)
    return dict(bn=bn, k_chunks=k_chunks, stages=stages, resident=resident,
                smem=smem + epilogue + _BARRIERS + 1024)


def chain_length(m: int, n: int, dtype=torch.bfloat16) -> int:
    """The most additions any product term goes through on its way into s1
    or s2 (one more for the square in s2 is inside the first step). A sum of
    terms in any order is within ``chain * 2^-24`` of their magnitudes, so
    ``chip_smoke.py``'s 1e-4 on the sums needs this under about 1,677.

    bf16: 1 (a thread's two rows of a tile) + 3 (xor shuffles over 8 lanes)
    + 7 (8 warps in order) + the run + the partials, ``ceil(groups / 32)``
    per lane, then a 5-level tree. fp32: each thread adds 32 rows of every
    tile of its run, then 3 (4 row groups) + the partials."""
    per, g = tiles_per_block(m, n, dtype), groups(m, n, dtype)
    partials = math.ceil(g / 32) + 5
    if dtype == torch.bfloat16:
        return 1 + 3 + 7 + per + partials
    return 32 * per + 3 + partials


def _kernel():
    from autodist_tpu_torch.ops import _build

    fn = _build.load("fused_conv_stats").fused_conv_stats
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def build_kernel() -> None:
    """Compile (or load) the CUDA library now instead of at first launch."""
    _kernel()


def built_plan(k: int, n: int) -> dict:
    """The CUDA library's own :func:`smem_plan` at ``(k, n)`` (builds it)."""
    from autodist_tpu_torch.ops import _build

    fn = _build.load("fused_conv_stats").fused_conv_stats_plan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = None
    out = (ctypes.c_int * 5)()
    fn(k, n, out)
    return dict(zip(("bn", "k_chunks", "stages", "resident", "smem"), out))


def fused_matmul_stats(x, w):
    """``(y [M, N] in x's dtype, s1 [N] fp32, s2 [N] fp32)``. CUDA tensors
    launch ``fused_conv_stats`` (counted in ``fused_matmul_stats.launches``)
    or raise; CPU and meta tensors run :func:`fused_matmul_stats_plain`."""
    if x.device.type in ("cpu", "meta"):
        return fused_matmul_stats_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"fused_matmul_stats: unsupported device {x.device}")
    check_kernel_args(x, w)
    (m, k), n = x.shape, w.shape[1]
    per = tiles_per_block(m, n, x.dtype)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    part = torch.empty((2, groups(m, n, x.dtype), n), dtype=torch.float32, device=x.device)
    s1 = torch.empty((n,), dtype=torch.float32, device=x.device)
    s2 = torch.empty((n,), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fn = _kernel()
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(), s1.data_ptr(),
                s2.data_ptr(), m, k, n, _DTYPE_CODE[x.dtype], per, stream)
    if rc != 0:
        raise RuntimeError(f"fused_conv_stats launch failed: cudaError {rc}")
    fused_matmul_stats.launches += 1
    return y, s1, s2


#: Launches of the CUDA kernel (CPU calls and plain runs are not counted).
fused_matmul_stats.launches = 0


# ------------------------------------------------------------------ autograd
class FusedConvStatsFn(torch.autograd.Function):
    """``(y, s1, s2) = fused_matmul_stats(x, w)``, differentiable through
    ``y``: ``dx = dy @ w^T`` and ``dw = x^T @ dy`` in the compute dtype, as
    plain products (the JAX package leaves the conv's backward to XLA; the
    Pallas kernel has none). ``s1`` and ``s2`` are not differentiable: the
    BatchNorm backward that consumes them carries the whole derivative
    through the batch mean and variance itself."""

    @staticmethod
    def forward(ctx, x, w):
        y, s1, s2 = fused_matmul_stats(x, w)
        ctx.save_for_backward(x, w)
        ctx.mark_non_differentiable(s1, s2)
        return y, s1, s2

    @staticmethod
    def backward(ctx, dy, _ds1, _ds2):
        x, w = ctx.saved_tensors
        dx = dy @ w.T if ctx.needs_input_grad[0] else None
        dw = x.T @ dy if ctx.needs_input_grad[1] else None
        return dx, dw


def kernel_bytes(x, w) -> int:
    """Bytes the kernel must move: x and w read once, y written once in x's
    dtype, and the two fp32 sums written once."""
    (m, k), n = x.shape, w.shape[1]
    return (m * k + k * n + m * n) * x.element_size() + 8 * n


def kernel_flops(x, w) -> int:
    """Multiply-adds x 2 of the product (the sums add O(M*N), left out)."""
    (m, k), n = x.shape, w.shape[1]
    return 2 * m * k * n


__all__ = ["fused_matmul_stats_plain", "fused_matmul_stats", "FusedConvStatsFn",
           "check_kernel_args", "block_n", "tiles_per_block", "groups", "smem_plan",
           "chain_length", "build_kernel", "built_plan", "kernel_bytes", "kernel_flops",
           "BLOCK_M", "BLOCK_N", "SMS", "MAX_RUN"]
