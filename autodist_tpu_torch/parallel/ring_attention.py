"""Ring attention and Ulysses all-to-all sequence parallelism (PyTorch port
of the JAX package's ``parallel/ring_attention.py``).

Long-context attention over a mesh ``seq`` axis, one process per device:

- **Ring attention** (Liu et al., arXiv 2310.01889): Q stays put, K/V chunks
  rotate to the next rank of the seq group (``batch_isend_irecv``); each
  step merges a chunk's attention into fp32 online-softmax accumulators
  (:func:`_chunk_merge`, plain tensor code: JAX computes it with ``einsum``,
  not Pallas). The rotation is an autograd function whose backward is the
  reverse rotation, so the backward is itself a ring; only the merge is
  checkpointed, so recomputation never issues a collective.
- **Ulysses** (DeepSpeed-Ulysses, arXiv 2309.14509): two all-to-alls carry
  ``[B, S/n, H, D]`` to ``[B, S, H/n, D]`` and back, with
  ``lax.all_to_all(..., tiled=True)``'s order, so each rank runs the flash
  kernels (``ops/flash_attention.py``) on its head group over the whole
  sequence. Each all-to-all's backward is the other one. Needs
  ``heads % n == 0``.

The ``*_local`` forms take this rank's chunk and the seq group. The wrappers
:func:`ring_attention` / :func:`ulysses_attention` take the whole sequence,
identical on every rank of the seq group (the rest of the model computes
redundantly on each, as GSPMD's replication does): they take this rank's
chunk with a split whose backward all-gathers the chunk gradients, and put
the output back whole with an all-gather whose backward takes this rank's
chunk. Every seq rank then holds the whole, true gradient, as a replicated
JAX array does. On a trivial seq axis they run plain flash attention; a
meta tensor (the capture's shape trace) takes the same shape-only path.

Beside a model or expert axis (tensor parallelism), q, k and v arrive as
``DTensor``s on the shard mesh, split on the heads dim as
``flash_attention`` receives them: the wrappers then run through
``local_map`` on each rank's head group (``Shard(2)`` on the dims where q
is split on its heads, ``Replicate`` on the others), over the seq group of the ranks that share this rank's data, model
and expert coordinates. Ulysses then needs the heads a rank holds
divisible by the seq axis, and the flash kernels see ``H / (model · seq)``
heads over the whole sequence.

Inside a pipeline stage (``parallel/pipeline.py`` on a pipe axis larger
than 1) a seq axis larger than 1 raises ``ValueError``, as the JAX
package's does: its ``shard_map`` over ``seq`` cannot open inside the one
over ``pipe``.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from autodist_tpu_torch import const
from autodist_tpu_torch.api import resolve_mesh
from autodist_tpu_torch.ops import flash_attention as fa_ops
from autodist_tpu_torch.runtime.process_group import _all_gather, exchange

_NEG_INF = -1e30
_NEED_MESH = "ring/ulysses attention"
#: Whether a pipelined stage runs in this context (``pipeline_stage``).
_in_stage = contextvars.ContextVar("autodist_pipeline_stage", default=False)


@contextlib.contextmanager
def pipeline_stage():
    """The block a pipelined stage function runs in: a seq-parallel
    attention inside it raises (see the module docstring)."""
    token = _in_stage.set(True)
    try:
        yield
    finally:
        _in_stage.reset(token)


# ----------------------------------------------------------------- ring core
def _chunk_merge(q, k, v, q_off: int, k_off: int, causal: bool, scale: float, m, l, acc):
    """Merge one K/V chunk into online-softmax stats.

    q: [b, cq, h, d]; k, v: [b, ck, h, d]; m, l: [b, h, cq, 1]; acc:
    [b, h, cq, d] (fp32). Offsets are the chunks' global sequence positions.
    The logits and ``p·v`` are fp32 products of the operands (JAX's
    ``preferred_element_type=jnp.float32``); ``p`` is rounded to ``v``'s
    dtype before the second product, as JAX does."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        cq, ck = q.shape[1], k.shape[1]
        rows = q_off + torch.arange(cq, device=q.device)[:, None]
        cols = k_off + torch.arange(ck, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full_like(s, _NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return m_new, l_new, acc_new


class _Rotate(torch.autograd.Function):
    """K and V to the next rank of the ring (``lax.ppermute`` by +1); the
    backward rotates their gradients back (-1)."""

    @staticmethod
    def forward(ctx, k, v, group):
        ctx.group = group
        return _rotate(group, 1, k, v)

    @staticmethod
    def backward(ctx, gk, gv):
        gk, gv = _rotate(ctx.group, -1, gk, gv)
        return gk, gv, None


def _rotate(group, shift: int, *xs):
    n, r = dist.get_world_size(group), dist.get_rank(group)
    xs = [x.contiguous() for x in xs]
    out = [torch.empty_like(x) for x in xs]
    exchange(group, [(x, (r + shift) % n) for x in xs],
             [(o, (r - shift) % n) for o in out])
    return tuple(out)


class _Pass(torch.autograd.Function):
    """The stats unchanged, with K/V's gradient as zeros: a skipped
    causal chunk keeps its rotation in the backward graph, so every rank
    runs every reverse rotation."""

    @staticmethod
    def forward(ctx, m, l, acc, k, v):
        ctx.kv = [(x.shape, x.dtype, x.device) for x in (k, v)]
        return m.view_as(m), l.view_as(l), acc.view_as(acc)

    @staticmethod
    def backward(ctx, gm, gl, gacc):
        gk, gv = (torch.zeros(shape, dtype=dtype, device=device)
                  for shape, dtype, device in ctx.kv)
        return gm, gl, gacc, gk, gv


def _seq_group(axis_name: str, group):
    if group is not None:
        return group
    return resolve_mesh(None, _NEED_MESH).axis_group(axis_name, required=True)


def ring_attention_local(q, k, v, causal: bool = False,
                         axis_name: str = const.MESH_AXIS_SEQ, group=None):
    """Ring attention on this rank's chunks: q, k, v ``[batch, seq_local,
    heads, head_dim]``, this rank's block of the global sequence along the
    seq group (``group``, default: the default AutoDist's ``axis_name``
    group). Returns this rank's output chunk, shaped like q.

    Rotation ``t`` brings chunk ``(r - t) mod n``; with ``causal`` the
    chunks above the diagonal (index > r) are not merged, the ring still
    rotates (and rotates back in the backward on every rank); the last
    rotation, which would only restore the layout, is not made."""
    group = _seq_group(axis_name, group)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    b, c, h, d = q.shape
    scale = 1.0 / (d ** 0.5)
    m = torch.full((b, h, c, 1), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, c, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, c, d), dtype=torch.float32, device=q.device)
    k_t, v_t = k, v
    for t in range(n):
        kv_idx = (r - t) % n
        if not causal or kv_idx <= r:
            m, l, acc = checkpoint(_chunk_merge, q, k_t, v_t, r * c, kv_idx * c, causal,
                                   scale, m, l, acc, use_reentrant=False)
        elif torch.is_grad_enabled() and (k_t.requires_grad or v_t.requires_grad):
            m, l, acc = _Pass.apply(m, l, acc, k_t, v_t)
        if t < n - 1:
            k_t, v_t = _Rotate.apply(k_t, v_t, group)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l_safe).to(q.dtype)              # [b, h, c, d]
    return out.permute(0, 2, 1, 3)                # [b, c, h, d]


# -------------------------------------------------------------- ulysses core
def _seq_to_heads(x, group):
    """[b, s/n, h, d] -> [b, s, h/n, d]: head group j goes to rank j, what
    arrives is concatenated along the sequence in rank order."""
    n = dist.get_world_size(group)
    b, c, h, d = x.shape
    send = x.reshape(b, c, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 0, 2, 3, 4).reshape(b, n * c, h // n, d)


def _heads_to_seq(x, group):
    """[b, s, h/n, d] -> [b, s/n, h, d]: sequence chunk j goes to rank j,
    what arrives is concatenated along the heads in rank order."""
    n = dist.get_world_size(group)
    b, s, hn, d = x.shape
    send = x.reshape(b, n, s // n, hn, d).permute(1, 0, 2, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * hn, d)


class _AllToAll(torch.autograd.Function):
    """One of the two re-shardings; its backward is the other."""

    @staticmethod
    def forward(ctx, x, group, to_heads: bool):
        ctx.group, ctx.to_heads = group, to_heads
        return (_seq_to_heads if to_heads else _heads_to_seq)(x, group)

    @staticmethod
    def backward(ctx, g):
        back = _heads_to_seq if ctx.to_heads else _seq_to_heads
        return back(g.contiguous(), ctx.group), None, None


def ulysses_attention_local(q, k, v, causal: bool = False,
                            axis_name: str = const.MESH_AXIS_SEQ, group=None):
    """All-to-all sequence parallelism on this rank's chunks: re-shards
    ``[b, seq/n, h, d]`` to ``[b, seq, h/n, d]``, runs flash attention on
    the head group, re-shards back."""
    group = _seq_group(axis_name, group)
    n = dist.get_world_size(group)
    h = q.shape[2]
    if h % n != 0:
        raise ValueError(
            f"ulysses attention needs the heads a rank holds ({h}: all of them, or "
            f"heads / model under a model split) divisible by the seq-axis size ({n}); use ring attention for this "
            "shape")
    qf, kf, vf = (_AllToAll.apply(x, group, True) for x in (q, k, v))
    o = fa_ops.flash_attention(qf, kf, vf, causal=causal)
    return _AllToAll.apply(o.contiguous(), group, False)


# ------------------------------------------------------------------ wrappers
class _TakeChunk(torch.autograd.Function):
    """This rank's sequence chunk of q, k and v (whole on every rank); the
    backward all-gathers the chunk gradients, so each rank holds the whole
    gradient (no sum: the ranks' inputs are one replicated value)."""

    @staticmethod
    def forward(ctx, q, k, v, group):
        ctx.group = group
        n, r = dist.get_world_size(group), dist.get_rank(group)
        c = q.shape[1] // n
        return tuple(x[:, r * c:(r + 1) * c].contiguous() for x in (q, k, v))

    @staticmethod
    def backward(ctx, gq, gk, gv):
        return (*(_gather_seq(g, ctx.group) for g in (gq, gk, gv)), None)


def _gather_seq(x, group):
    """The group's chunks of ``x`` concatenated along dim 1, in rank order."""
    n = dist.get_world_size(group)
    front = x.movedim(1, 0).contiguous()
    out = front.new_empty((front.shape[0] * n,) + tuple(front.shape[1:]))
    _all_gather(out, front, group=group)
    return out.movedim(0, 1)


class _GatherChunks(torch.autograd.Function):
    """The whole output on every rank; the backward takes this rank's
    chunk of the (replicated) output gradient."""

    @staticmethod
    def forward(ctx, o, group):
        ctx.group = group
        return _gather_seq(o, group)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        c = g.shape[1] // n
        return g[:, r * c:(r + 1) * c].contiguous(), None


def _whole_to_chunks(fn_local, q, k, v, causal: bool, axis_name: str, group):
    """``fn_local`` on this rank's chunk of the whole q, k and v, the
    output put back whole (plain tensors)."""
    qs, ks, vs = _TakeChunk.apply(q, k, v, group)
    o = fn_local(qs, ks, vs, causal=causal, axis_name=axis_name, group=group)
    return _GatherChunks.apply(o, group)


def _seq_sharded(fn_local, q, k, v, causal: bool, mesh, axis_name: str):
    if _in_stage.get():
        size = getattr(resolve_mesh(mesh), "shape", {}).get(axis_name, 1)
        if size > 1:
            raise ValueError(
                f"ring/ulysses attention over mesh axis {axis_name!r}={size} inside a "
                "pipeline stage: a stage runs on its pipe rank alone, as in the JAX "
                "package, whose shard_map over the seq axis cannot open inside the one "
                "over the pipe axis; use a seq axis of 1 with a pipe axis, or build the "
                "model without a pipeline")
    if q.is_meta:
        # The capture's shape trace: no collective on meta tensors.
        return fa_ops.flash_attention(q, k, v, causal=causal)
    mesh = resolve_mesh(mesh, _NEED_MESH)
    axis_size = mesh.shape.get(axis_name, 1)
    if axis_size <= 1:
        return fa_ops.flash_attention(q, k, v, causal=causal)
    if q.shape[1] % axis_size != 0:
        raise ValueError(f"sequence length {q.shape[1]} not divisible by mesh axis "
                         f"{axis_name!r}={axis_size}")
    group = mesh.axis_group(axis_name, required=True)
    run = functools.partial(_whole_to_chunks, fn_local, axis_name=axis_name, group=group)
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        from autodist_tpu_torch.utils.placement import on_head_groups

        run = on_head_groups(run, q)
    return run(q, k, v, causal)


def ring_attention(q, k, v, causal: bool = False, mesh=None,
                   axis_name: str = const.MESH_AXIS_SEQ):
    """Ring attention on the whole ``[B, S, H, D]`` sequence (identical on
    every rank of the seq group) over ``mesh``'s seq axis (default: the
    default AutoDist's mesh); plain flash attention when that axis is
    trivial, so models can enable it unconditionally."""
    return _seq_sharded(ring_attention_local, q, k, v, causal, mesh, axis_name)


def ulysses_attention(q, k, v, causal: bool = False, mesh=None,
                      axis_name: str = const.MESH_AXIS_SEQ):
    """Ulysses (all-to-all) sequence-parallel attention on the whole
    sequence, as :func:`ring_attention`."""
    return _seq_sharded(ulysses_attention_local, q, k, v, causal, mesh, axis_name)
