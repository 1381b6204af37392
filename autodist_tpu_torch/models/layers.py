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

Under tensor parallelism the params are ``DTensor``s on the model axis.
``DTensor``'s own convolution takes a weight only replicated, so a conv,
the stem and the fused 1x1 conv + BatchNorm run on each rank's blocks
through ``local_map`` (:func:`_split_conv`, :func:`conv_batchnorm`), and
BatchNorm and pooling on the rank's channel block of an activation split
on the channel (:func:`_channelwise`).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from autodist_tpu_torch.ops import fused_conv_stats as fcs
from autodist_tpu_torch.runtime import process_group as pg
from autodist_tpu_torch.utils.placement import placement_list, split_of


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
    clamp positions first. A ``DTensor`` table split by rows (tensor
    parallelism shards the vocab axis, as JAX's plan does) is read
    vocab-parallel (:func:`_vocab_parallel_lookup`), where indexing would
    gather the whole table. A table whose rows the step split over the data
    axis (``kernel/sparse.py``'s ``RowSplitTable``) reads the touched rows
    only (its ``SparseRowLookup``)."""
    from autodist_tpu_torch.kernel.sparse import RowSplitTable

    table = p["embedding"]
    if isinstance(table, RowSplitTable):
        return table.lookup(ids, wrap=True)
    if _split_by_rows(table):
        return _vocab_parallel_lookup(table, ids.long())
    return table[ids.long()]


def _split_by_rows(t) -> bool:
    """A ``DTensor`` split by rows over one dim of its mesh."""
    from torch.distributed.tensor import Shard

    split = split_of(t)
    return split is not None and split.placement == Shard(0)


def _rows_held(table, ids, lo: int):
    """This rank's part of a row gather: the rows of ``table`` (rows ``lo``
    on of the whole) that ``ids`` name, zeros for the others. An index
    read, as the whole table's is: on a one-rank mesh its backward sums a
    row's gradients in the same order as the plain lookup's."""
    local = ids - lo
    held = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(held, local, torch.zeros_like(local))]
    return rows * held[..., None].to(rows.dtype)


def _vocab_parallel_lookup(table, ids):
    """Megatron's vocab-parallel embedding on a table split by rows
    (``Shard(0)`` on one mesh dim): each rank gathers the rows it holds
    (``local_map``), the partial sums are all-reduced once over that dim.
    The same values as the whole table's gather (one nonzero term a row),
    in any torch version's ``DTensor``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh, split = table.device_mesh, split_of(table)
    rep = placement_list(mesh, None, Replicate())
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, rep, run_check=False)
    lo = split.coord * (table.shape[0] // split.size)
    lookup = local_map(_rows_held, out_placements=placement_list(mesh, split.dim, Partial()),
                       in_placements=(placement_list(mesh, split.dim, Shard(0)), rep, None),
                       redistribute_inputs=True)
    return lookup(table, ids, lo).redistribute(mesh, rep)


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
    pads = _pads(x, tuple(k.shape[:2]), stride, padding)
    return _split_conv(lambda xs, ks: _conv_nhwc(xs, ks, stride, pads), x, k)


# ------------------------------------------------- convolutions on split weights
def _split_conv(fn, x, k):
    """``fn(x, k)``, a convolution of NHWC ``x`` by HWIO ``k``, on each rank's
    blocks when ``k`` is a ``DTensor`` (``local_map``; ``DTensor``'s own
    convolution rule takes a weight only replicated, so a split weight
    would be gathered every forward), on the mesh dim ``k`` is split on
    (replicated on the others):

    - column (``k`` ``Shard(3)``): ``x`` whole, the output ``Shard(3)`` on
      the channel; ``x``'s gradient a partial sum over the ranks;
    - row (``k`` ``Shard(2)``): ``x``'s channel block ``Shard(3)``, the
      output a ``Partial`` sum, which the BatchNorm after it reduces;
    - whole: ``x`` and ``k`` gathered, the output replicated."""
    split = split_of(k)
    if split is None:
        return fn(x, k)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    def on(placement):
        return placement_list(k.device_mesh, split.dim, placement)

    rep, chan, cin = on(Replicate()), on(Shard(3)), on(Shard(2))
    # The placements of (x, k), of their gradients, and of the output: the
    # column route, the row route, else whole.
    ins, grads, out = {
        Shard(3): ((rep, chan), (on(Partial()), chan), chan),
        Shard(2): ((chan, cin), (chan, cin), on(Partial())),
    }.get(split.placement, ((rep, rep), (rep, rep), rep))
    return local_map(fn, out_placements=out, in_placements=ins, in_grad_placements=grads,
                     redistribute_inputs=True)(x, k)


def _channelwise(fn, x, *vectors):
    """``fn(x, *vectors)`` for an op that works channel by channel on NHWC
    ``x`` with per-channel ``vectors`` (BatchNorm, pooling). On a
    ``DTensor`` it runs through ``local_map`` on the rank's channel block
    (``Shard(3)``, the vectors' block ``Shard(0)``, on the mesh dim ``x``
    is split on) when ``x`` is split on the channel or is a row-split
    conv's ``Partial`` sum (reduce-scattered first: per-channel statistics
    are never taken from a partial sum), and on the whole otherwise."""
    split = split_of(x)
    if split is None:
        return fn(x, *vectors)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    channel = Shard(x.dim() - 1)
    mesh = x.device_mesh
    if split.placement == channel or isinstance(split.placement, Partial):
        act, vec = (placement_list(mesh, split.dim, channel),
                    placement_list(mesh, split.dim, Shard(0)))
    else:
        act = vec = placement_list(mesh, None, Replicate())
    return local_map(fn, out_placements=act, in_placements=(act,) + (vec,) * len(vectors),
                     redistribute_inputs=True)(x, *vectors)


# ---------------------------------------------------------------------- pooling
def max_pool(x, window: int, stride: int, padding: str = "SAME"):
    """NHWC max pool; ``"SAME"`` pads with ``-inf`` (JAX's init value). Per
    channel on a split activation (:func:`_channelwise`)."""
    return _channelwise(lambda xs: _max_pool(xs, window, stride, padding), x)


def _max_pool(x, window: int, stride: int, padding: str):
    (top, bottom), (left, right) = _pads(x, (window, window), stride, padding)
    xc = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(xc, window, stride).permute(0, 2, 3, 1)


def avg_pool(x, window: int, stride: int, padding: str = "SAME"):
    """NHWC count-normalised average pool (the JAX package's): each window's
    sum divided by the number of its taps inside the map, so border windows
    of ``"SAME"`` divide by fewer than ``window²``. ``"SAME"`` pads can be
    uneven, so the map is padded with zeros explicitly and divided by the
    pooled count map. The sum is rounded to x's dtype once and then divided
    (JAX's order); PyTorch accumulates it in fp32 before that rounding. Per
    channel on a split activation (:func:`_channelwise`)."""
    return _channelwise(lambda xs: _avg_pool(xs, window, stride, padding), x)


def _avg_pool(x, window: int, stride: int, padding: str):
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
    receptive field is blocks ``[i - 1, i + 2]``: pad 1 low, 2 high. Both
    transforms keep each input and output channel's taps together, so a
    split kernel runs them on its block (:func:`_split_conv`)."""
    return _split_conv(lambda x, k: _s2d_conv(x, k, dtype), images, stem_conv["kernel"])


def _s2d_conv(images, k, dtype):
    b, h, w, c = images.shape
    x = images.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)

    k = F.pad(k, (0, 0, 0, 0, 0, 1, 0, 1))                   # [8, 8, cin, cout]
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


def batchnorm(p, x, eps: float = 1e-5):
    """Training-mode batch norm over N, H, W (batch statistics only; running
    averages are an inference concern). Statistics reduce in fp32 in one
    pass, ``E[x²] − E[x]²`` clamped at 0, from the column sums ``(sum x,
    sum x²)`` over the N·H·W rows. They are this process's batch's, or the
    global batch's inside the distributed step's GSPMD semantics
    (:class:`BatchNormFn`). On a ``DTensor`` split on the channel, each rank
    normalises its channel block with its block of the scale and bias
    (:func:`_channelwise`)."""
    return _channelwise(lambda xs, scale, bias: BatchNormFn.apply(scale, bias, xs, eps,
                                                                  None, None),
                        x, p["scale"], p["bias"])


def _fused_product(x, k, stride: int, cols=None):
    """``(y, s1, s2)`` of the 1x1 conv of :func:`conv_batchnorm` on plain
    tensors: ``y`` NHWC, the fp32 column sums over its N·H·W rows; ``cols``
    = (lo, hi) launches on those output columns of ``k`` only."""
    if stride > 1:
        x = x[:, ::stride, ::stride, :]
    b, h, w, c = x.shape
    kernel = k.reshape(c, -1)
    if cols is not None:
        kernel = kernel[:, cols[0]:cols[1]].contiguous()
    rows = x.contiguous().reshape(-1, c)
    if torch.compiler.is_exporting():           # ops/library.py: the kernel as an op
        y, s1, s2 = torch.ops.autodist_tpu_torch.fused_matmul_stats(rows, kernel)
    else:
        y, s1, s2 = fcs.FusedConvStatsFn.apply(rows, kernel)
    return y.reshape(b, h, w, -1), s1, s2


def _fused_conv_bn(x, k, scale, bias, stride: int, cols=None):
    """The 1x1 conv + BatchNorm of :func:`conv_batchnorm` on plain tensors."""
    y, s1, s2 = _fused_product(x, k, stride, cols)
    return BatchNormFn.apply(scale, bias, y, 1e-5, s1, s2)


def fused_block(split_dim: Optional[int], n: int, rank: int, size: int
                ) -> Tuple[str, Tuple[int, int]]:
    """How :func:`conv_batchnorm` runs a 1x1 HWIO kernel with ``n`` output
    columns split on ``split_dim`` (None: replicated) over ``size`` ranks,
    and the output columns ``[lo, hi)`` that rank ``rank`` launches the
    fused op on: ``"column"`` (on ``cout``, dim 3: the rank's ``Shard``
    block, ``torch.chunk``'s) and ``"row"`` (on ``cin``, dim 2, ``size``
    dividing ``n``: the gathered kernel's ``n / size`` block) launch on a
    block, ``"whole"`` on all ``n``."""
    if split_dim == 3:
        step = -(-n // size)
        return "column", (min(rank * step, n), min((rank + 1) * step, n))
    if split_dim == 2 and n % size == 0:
        return "row", (rank * n // size, (rank + 1) * n // size)
    return "whole", (0, n)


def conv_batchnorm(conv_p, bn_p, x, stride: int = 1, *, compute_dtype=None):
    """``batchnorm(bn_p, conv(conv_p, x, stride))``. A 1x1 conv runs as the
    fused product + statistics op (``ops/fused_conv_stats.py``) over the
    ``[N·H·W, C]`` rows, and the batchnorm takes its sums. Its ``"SAME"``
    padding is 0 at any size, so a stride-2 1x1 conv reads the taps
    ``(2i, 2j)``: a strided slice, then the op.

    On a split kernel (``local_map``) every rank launches the op on its
    block of output columns, so the statistics it returns are those of
    whole columns of the summed product: under a column split (``cout``)
    on the whole ``x`` and its ``[K, N/m]`` block; under a row split
    (``cin``) on the gathered ``x`` and the gathered kernel's column block
    (the product of a ``cin`` block is a partial sum, whose column sums
    are not the statistics of the sum). Either way the output is split on
    the channel, the BatchNorm takes its scale and bias block, and the
    sums are of the fp32 product before rounding."""
    k = conv_p["kernel"]
    if tuple(k.shape[:2]) != (1, 1):
        return batchnorm(bn_p, conv(conv_p, x, stride, compute_dtype=compute_dtype))
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        k = k.to(compute_dtype)
    split = split_of(k)
    if split is None:
        return _fused_conv_bn(x, k, bn_p["scale"], bn_p["bias"], stride)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    where = split.placement
    route, cols = fused_block(where.dim if isinstance(where, Shard) else None, k.shape[3],
                              split.coord, split.size)
    cols = cols if route == "row" else None

    def on(placement):
        return placement_list(k.device_mesh, split.dim, placement)

    rep, part, vec, chan = on(Replicate()), on(Partial()), on(Shard(0)), on(Shard(3))
    # The placements of (x, k, scale, bias), of their gradients, and of the
    # output. x's gradient from a column block is a partial sum.
    ins, grads, out = {
        "column": ((rep, chan, vec, vec), (part, chan, vec, vec), chan),
        "row": ((rep, rep, vec, vec), (part, part, vec, vec), chan),
        "whole": ((rep,) * 4, (rep,) * 4, rep),
    }[route]
    fn = local_map(lambda xs, ks, scale, bias: _fused_conv_bn(xs, ks, scale, bias, stride,
                                                              cols),
                   out_placements=out, in_placements=ins, in_grad_placements=grads,
                   redistribute_inputs=True)
    return fn(x, k, bn_p["scale"], bn_p["bias"])


# ----------------------------------------------------------------------- losses
def per_token_xent(logits, labels):
    """Per-position cross-entropy (fp32 logsumexp), no reduction. On a
    two-dim shard mesh the label's logit is read vocab-parallel
    (:func:`_vocab_parallel_label`): ``DTensor``'s gather rule keeps one
    mask for a partial sum over two mesh dims and fails there."""
    logits = logits.to(torch.float32)
    split = split_of(logits)
    if split is not None and split.dim is not None and logits.device_mesh.ndim > 1:
        from torch.distributed.tensor import Shard

        mesh = logits.device_mesh
        logits = logits.redistribute(mesh, placement_list(mesh, split.dim,
                                                          Shard(logits.dim() - 1)))
        return torch.logsumexp(logits, dim=-1) - _vocab_parallel_label(logits, labels,
                                                                       split.dim)
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels.long()[..., None])
    # Subtract, then drop the label axis: a vocab-split DTensor's gather
    # reduces its masked partial only at the gather's own shape.
    return (logz[..., None] - label_logit)[..., 0]


def _label_held(logits, labels, lo: int):
    """This rank's part of each label's logit: ``logits`` holds the vocab
    columns ``lo`` on, zeros for the labels it does not hold."""
    local = labels.long() - lo
    held = (local >= 0) & (local < logits.shape[-1])
    picked = torch.gather(logits, -1, torch.where(held, local, torch.zeros_like(local))[..., None])
    return picked[..., 0] * held.to(logits.dtype)


def _vocab_parallel_label(logits, labels, dim: int):
    """Each label's logit from ``logits`` split over the vocab on mesh dim
    ``dim``: each rank picks the labels it holds (``local_map``), the
    partial sums add over that dim."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    rep = placement_list(mesh, None, Replicate())
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, rep, run_check=False)
    per = -(-logits.shape[-1] // mesh.size(dim))
    pick = local_map(_label_held, out_placements=placement_list(mesh, dim, Partial()),
                     in_placements=(placement_list(mesh, dim, Shard(logits.dim() - 1)),
                                    rep, None), redistribute_inputs=True)
    return pick(logits, labels, per * mesh.get_local_rank(dim)).redistribute(mesh, rep)


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
