"""Functional NN layers shared by the model zoo (PyTorch port).

Pure functions over explicit param dicts, with the JAX package's layouts
kept at the surface so parameters carry over unchanged: a dense kernel is
``[in, out]`` (``y = x @ kernel``), an embedding table ``[vocab, dim]``,
activations of the CNN layers NHWC and conv kernels HWIO. Initialisers draw
from an explicit ``torch.Generator`` on an explicit device. They do not
reproduce ``jax.random``'s numbers (tests carry JAX parameters over with
:mod:`autodist_tpu_torch.models.convert`).

Convolutions and pooling run PyTorch's NCHW operators on channels-last views
of the NHWC tensors (no copy). ``"SAME"`` padding is XLA's: ``total =
max((out - 1) * stride + window - size, 0)``, the smaller half at the start,
so a stride-2 3x3 window over 56 pixels pads (0, 1), not (1, 1).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from autodist_tpu_torch.ops import fused_conv_stats as fcs
from autodist_tpu_torch.runtime import process_group as pg


# ------------------------------------------------------------------ initializers
def _fans(shape) -> Tuple[int, int]:
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def glorot(gen: torch.Generator, shape, device=None, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, device=device, dtype=dtype)
    return u * (2.0 * limit) - limit


def normal(gen: torch.Generator, shape, stddev=0.02, device=None,
           dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=device, dtype=dtype) * stddev


def he_normal(gen: torch.Generator, shape, device=None, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    std = math.sqrt(2.0 / fan_in)
    return torch.randn(shape, generator=gen, device=device, dtype=dtype) * std


# ------------------------------------------------------------------------ dense
def dense_init(gen, in_dim: int, out_dim: int, use_bias: bool = True,
               device=None):
    p = {"kernel": glorot(gen, (in_dim, out_dim), device=device)}
    if use_bias:
        p["bias"] = torch.zeros((out_dim,), device=device)
    return p


def dense(p, x, *, compute_dtype=None):
    """``x @ kernel (+ bias)``: both operands cast to ``compute_dtype``, the
    bias cast to the product's dtype (the JAX package's order). Without
    ``compute_dtype``, mixed operands promote as in JAX (bf16 features times
    an fp32 kernel multiply in fp32)."""
    k = p["kernel"]
    if compute_dtype is None and x.dtype != k.dtype:
        compute_dtype = torch.promote_types(x.dtype, k.dtype)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        k = k.to(compute_dtype)
    y = x @ k
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


# -------------------------------------------------------------------- layernorm
def layernorm_init(dim: int, device=None):
    return {"scale": torch.ones((dim,), device=device),
            "bias": torch.zeros((dim,), device=device)}


def layernorm(p, x, eps: float = 1e-6):
    # Normalize in fp32 regardless of compute dtype, then cast back.
    x32 = x.to(torch.float32)
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


# -------------------------------------------------------------------- embedding
def embedding_init(gen, vocab: int, dim: int, stddev: float = 0.02,
                   device=None):
    return {"embedding": normal(gen, (vocab, dim), stddev, device=device)}


def embedding_lookup(p, ids):
    """Row gather — the sparse-update read that ``ModelItem``'s trace marks
    (an ``aten.index`` of the table). Unlike ``jnp.take`` (which fills
    out-of-range rows with NaN), an out-of-range id raises here: callers
    clamp positions first."""
    return p["embedding"][ids.long()]


# ------------------------------------------------------------------------- conv
def conv_init(gen, kh: int, kw: int, cin: int, cout: int, device=None):
    return {"kernel": he_normal(gen, (kh, kw, cin, cout), device=device)}


def _same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pads(x, window: Tuple[int, int], stride: int, padding: str):
    if padding == "SAME":
        return tuple(_same_pads(x.shape[1 + i], window[i], stride) for i in range(2))
    if padding == "VALID":
        return (0, 0), (0, 0)
    raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")


def _conv_nhwc(x, k, stride: int, pads):
    """NHWC ``x`` by HWIO ``k`` with explicit ``((top, bottom), (left,
    right))`` padding, through ``F.conv2d`` on channels-last views."""
    (top, bottom), (left, right) = pads
    xc = x.permute(0, 3, 1, 2)              # NCHW view of NHWC memory
    if top == bottom and left == right:
        conv_pad = (top, left)
    else:
        xc = F.pad(xc, (left, right, top, bottom))
        conv_pad = (0, 0)
    wc = k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(xc.contiguous(memory_format=torch.channels_last), wc,
                 stride=stride, padding=conv_pad)
    return y.permute(0, 2, 3, 1)


def conv(p, x, stride: int = 1, padding: str = "SAME", *, compute_dtype=None):
    """NHWC conv; kernel HWIO; ``padding`` "SAME" or "VALID"."""
    k = p["kernel"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        k = k.to(compute_dtype)
    return _conv_nhwc(x, k, stride, _pads(x, tuple(k.shape[:2]), stride, padding))


# ---------------------------------------------------------------------- pooling
def max_pool(x, window: int, stride: int, padding: str = "SAME"):
    """NHWC max pool; ``"SAME"`` pads with ``-inf`` (JAX's init value)."""
    (top, bottom), (left, right) = _pads(x, (window, window), stride, padding)
    xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)


def avg_pool(x, window: int, stride: int, padding: str = "SAME"):
    """NHWC count-normalised average pool (the JAX package's): each window's
    sum divided by the number of its taps inside the map, so border windows
    of ``"SAME"`` divide by fewer than ``window²``. ``"SAME"`` pads can be
    uneven, so the map is padded with zeros explicitly and divided by the
    pooled count map. The sum is rounded to x's dtype once and then divided
    (JAX's order); PyTorch accumulates it in fp32 before that rounding."""
    (top, bottom), (left, right) = _pads(x, (window, window), stride, padding)
    xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    summed = F.avg_pool2d(xc, window, stride, divisor_override=1)
    if padding == "VALID":
        return (summed / (window * window)).permute(0, 2, 3, 1)
    ones = F.pad(torch.ones((1, 1) + tuple(x.shape[1:3]), dtype=x.dtype, device=x.device),
                 (left, right, top, bottom))
    counts = F.avg_pool2d(ones, window, stride, divisor_override=1)
    return (summed / counts).permute(0, 2, 3, 1)


def space_to_depth_stem(stem_conv, images, dtype):
    """The weight-equivalent stem: the 7x7/s2 conv on 3 channels as a 4x4/s1
    conv on 12 channels over the 2x2 space-to-depth input (the JAX
    package's MLPerf transform; even H and W). The 7x7 kernel, padded to 8
    taps, reshapes exactly to ``[4, 4, 12, cout]``; in block space the
    receptive field is blocks ``[i - 1, i + 2]``: pad 1 low, 2 high."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)

    k = stem_conv["kernel"]                                  # [7, 7, 3, cout]
    k = F.pad(k, (0, 0, 0, 0, 0, 1, 0, 1))                   # [8, 8, 3, cout]
    kh, kw, cin, cout = k.shape
    k = k.reshape(kh // 2, 2, kw // 2, 2, cin, cout)
    k = k.permute(0, 2, 1, 3, 4, 5).reshape(kh // 2, kw // 2, 4 * cin, cout)
    return _conv_nhwc(x.to(dtype), k.to(dtype), 1, ((1, 2), (1, 2)))


# -------------------------------------------------------------------- batchnorm
def batchnorm_init(dim: int, device=None):
    return {"scale": torch.ones((dim,), device=device),
            "bias": torch.zeros((dim,), device=device)}


def _channel_axes(x):
    return tuple(range(x.dim() - 1))


def _batchnorm_autodiff(p, x, eps: float = 1e-5):
    """The one-pass forward differentiated by autograd: the plain version
    that :class:`BatchNormFn` is held against (the JAX package keeps it for
    the same purpose)."""
    x32 = x.to(torch.float32)
    axes = _channel_axes(x)
    mean = x32.mean(axes)
    # Clamp: E[x²]−E[x]² cancels catastrophically for high-mean/low-variance
    # channels and can come out slightly negative, which rsqrt turns to NaN.
    var = torch.clamp((x32 * x32).mean(axes) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    return (((x32 - mean) * (p["scale"] * inv)) + p["bias"]).to(x.dtype)


def _batchnorm_core_fwd(scale, bias, x, eps, stats=None, coll=None):
    """``(y, residuals)``. ``stats`` are optional precomputed fp32 column
    sums ``(sum x, sum x²)`` over the N·H·W rows, used instead of reducing
    ``x`` again. With ``coll`` (a ``Collectives``) the sums add over its
    group, one all-reduce, and the statistics are the global batch's."""
    x32 = x.to(torch.float32)
    n = x.numel() // x.shape[-1]
    if stats is None:
        axes = _channel_axes(x)
        stats = (x32.sum(axes), (x32 * x32).sum(axes))
    if coll is not None:
        both = torch.stack(stats)
        coll.all_reduce(both, "stats")
        stats, n = both.unbind(0), n * coll.size
    mean = stats[0] / n
    var_raw = stats[1] / n - mean * mean
    inv = torch.rsqrt(torch.clamp(var_raw, min=0.0) + eps)
    # The mean is subtracted in fp32 before the cast, so high-mean /
    # low-variance channels cancel exactly.
    y = (((x32 - mean) * (scale * inv)) + bias).to(x.dtype)
    # Residuals beyond x are per-channel vectors; the clamp mask lets the
    # backward drop the variance term where the clamp froze it.
    return y, (x, mean, inv, scale, var_raw > 0.0)


def _batchnorm_core_bwd(res, dy, coll=None):
    """``(dscale, dbias, dx)``: ``dx = (γ·inv)·(dy − E[dy] − x̂·E[dy·x̂])``,
    with the variance term dropped per channel where the clamp engaged.
    With ``coll`` the two sums of ``dx`` add over its group (one
    all-reduce) and ``E`` is over the global batch; ``dscale`` and
    ``dbias`` stay this rank's sums, which the gradient sync averages."""
    x, mean, inv, scale, var_live = res
    axes = _channel_axes(x)
    n = float(x.numel() // x.shape[-1])
    dy32 = dy.to(torch.float32)
    x_hat = (x.to(torch.float32) - mean) * inv
    sum_dy = dy32.sum(axes)
    sum_dy_xhat = (dy32 * x_hat).sum(axes)
    dscale, dbias = sum_dy_xhat, sum_dy
    if coll is not None:
        both = torch.stack((sum_dy, sum_dy_xhat))
        coll.all_reduce(both, "stats")
        (sum_dy, sum_dy_xhat), n = both.unbind(0), n * coll.size
    var_term = torch.where(var_live, sum_dy_xhat / n, torch.zeros_like(sum_dy_xhat))
    dx = (scale * inv) * (dy32 - sum_dy / n - x_hat * var_term)
    return dscale, dbias, dx.to(x.dtype)


class BatchNormFn(torch.autograd.Function):
    """The JAX package's ``_batchnorm_core`` custom VJP: saves only ``(x,
    mean, inv, scale, mask)``; the backward is one reduction pass and one
    elementwise pass. Optional ``s1``/``s2`` are precomputed column sums.
    Inside ``runtime.process_group.batch_stats_over(coll)`` (the
    distributed step's GSPMD semantics) the statistics and the backward's
    sums are reduced over the group."""

    @staticmethod
    def forward(ctx, scale, bias, x, eps, s1, s2):
        stats = None if s1 is None else (s1, s2)
        ctx.coll = pg.batch_stats()
        y, res = _batchnorm_core_fwd(scale, bias, x, eps, stats, ctx.coll)
        ctx.save_for_backward(*res)
        return y

    @staticmethod
    def backward(ctx, dy):
        dscale, dbias, dx = _batchnorm_core_bwd(ctx.saved_tensors, dy, ctx.coll)
        return dscale, dbias, dx, None, None, None


def batchnorm(p, x, eps: float = 1e-5, stats: Optional[Tuple] = None):
    """Training-mode batch norm over N, H, W (batch statistics only; running
    averages are an inference concern). Statistics reduce in fp32 in one
    pass, ``E[x²] − E[x]²`` clamped at 0, from the column sums ``(sum x,
    sum x²)`` over the N·H·W rows (given as ``stats``, or reduced here).
    They are this process's batch's, or the global batch's inside the
    distributed step's GSPMD semantics (:class:`BatchNormFn`)."""
    s1, s2 = stats if stats is not None else (None, None)
    return BatchNormFn.apply(p["scale"], p["bias"], x, eps, s1, s2)


def conv_batchnorm(conv_p, bn_p, x, stride: int = 1, *, compute_dtype=None):
    """``batchnorm(bn_p, conv(conv_p, x, stride))``. A 1x1 conv runs as the
    fused product + statistics op (``ops/fused_conv_stats.py``) over the
    ``[N·H·W, C]`` rows, and the batchnorm takes its sums. Its ``"SAME"``
    padding is 0 at any size, so a stride-2 1x1 conv reads the taps
    ``(2i, 2j)``: a strided slice, then the op."""
    k = conv_p["kernel"]
    if tuple(k.shape[:2]) != (1, 1):
        return batchnorm(bn_p, conv(conv_p, x, stride, compute_dtype=compute_dtype))
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        k = k.to(compute_dtype)
    if stride > 1:
        x = x[:, ::stride, ::stride, :]
    b, h, w, c = x.shape
    y, s1, s2 = fcs.FusedConvStatsFn.apply(x.contiguous().reshape(-1, c),
                                           k.reshape(c, -1))
    return batchnorm(bn_p, y.reshape(b, h, w, -1), stats=(s1, s2))


# ----------------------------------------------------------------------- losses
def per_token_xent(logits, labels):
    """Per-position cross-entropy (fp32 logsumexp), no reduction."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - label_logit


def softmax_xent(logits, labels):
    """Mean cross-entropy over every position."""
    return per_token_xent(logits, labels).mean()


def sigmoid_xent(logits, labels):
    """Mean binary cross-entropy on logits, in fp32, in the stable form
    ``max(l, 0) − l·y + log1p(exp(−|l|))``."""
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))
