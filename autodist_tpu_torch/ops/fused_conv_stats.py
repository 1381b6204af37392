"""Fused 1x1-conv product + BatchNorm statistics (PyTorch port).

The port of ``examples/benchmark/fused_conv_stats.py``: a 1x1 convolution over
NHWC activations is the product ``x [M, K] @ w [K, N]`` with ``M = N*H*W``,
and the BatchNorm that follows it needs the per-column sum and sum of squares
of that output. One kernel computes all three:

- ``y = (x @ w)`` accumulated in fp32, rounded to x's dtype;
- ``s1 = sum_rows(y32)`` and ``s2 = sum_rows(y32 * y32)`` in fp32, from the
  unrounded fp32 product.

:func:`fused_matmul_stats_plain` is the plain PyTorch version, the JAX
script's ``xla_matmul_stats``. :func:`fused_matmul_stats` launches the CUDA
kernel of ``csrc/fused_conv_stats.cu`` (which replaces the Pallas TPU kernel
``_kernel``) on CUDA tensors and counts the launch, or raises; on CPU and meta
tensors it runs the plain version, because there is no kernel to run there.
:class:`FusedConvStatsFn` makes it differentiable in ``x`` and ``w``.
"""
from __future__ import annotations

import ctypes
import math

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: The kernel's tile: 128 rows of M by 64 columns of N.
BLOCK_M, BLOCK_N = 128, 64
#: Enough blocks to give each of the H100's 132 SMs about eight.
_TARGET_BLOCKS = 1056
_MAX_PER_BLOCK = 16
_MAX_GROUPS = 65535


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


def tiles_per_block(m: int, n: int) -> int:
    """M tiles each block walks: enough blocks to fill the card, at most 16
    tiles, and at most 65535 groups (the grid's y limit)."""
    tiles_m, tiles_n = math.ceil(m / BLOCK_M), math.ceil(n / BLOCK_N)
    per = max(1, min(_MAX_PER_BLOCK, tiles_m * tiles_n // _TARGET_BLOCKS))
    return max(per, math.ceil(tiles_m / _MAX_GROUPS))


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
    per = tiles_per_block(m, n)
    groups = math.ceil(math.ceil(m / BLOCK_M) / per)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    part = torch.empty((2, groups, n), dtype=torch.float32, device=x.device)
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
           "check_kernel_args", "tiles_per_block", "build_kernel", "kernel_bytes",
           "kernel_flops", "BLOCK_M", "BLOCK_N"]
