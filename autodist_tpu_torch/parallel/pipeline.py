"""Pipeline parallelism over a mesh ``pipe`` axis (PyTorch port of the JAX
package's ``parallel/pipeline.py``).

One process per device: rank ``s`` of the pipe group runs stage ``s`` of a
stacked ``[S, ...]`` stage stack, and microbatches stream through the
stages, activations going stage to stage by point-to-point ops on the pipe
group (the JAX package's ``ppermute``). Stage ``s`` computes microbatch
``m`` at tick ``t = s + m``, so a run is ``n_micro + S - 1`` ticks with the
bubble fraction ``(S-1)/(n_micro+S-1)``. A tick whose microbatch is out of
range computes nothing here (JAX's SPMD scan computes it and masks it
out); every send still meets its receive, at the end of the same tick on
both stages.

The stage function must be shape- and dtype-preserving (``[mb, ...] ->
[mb, ...]``), which transformer block stacks are. Embedding and head layers
stay outside the pipelined region.

Three schedules, with the JAX package's values and gradients:

- ``gpipe``: the forward keeps each microbatch's stage graph; the backward
  runs the reverse pipeline over them (all microbatches' residuals live
  between the phases);
- ``1f1b``: the forward keeps only each microbatch's stage-boundary input;
  the backward recomputes each stage's vector-Jacobian product from it;
- the interleaved 1F1B loop of :func:`pipeline_value_and_grad`: one loop
  whose every tick does a forward and a backward, the loss inside the
  pipelined region, a ring of ``R = 2S - 1`` boundary inputs: live
  activations O(S), independent of ``n_micro``.

Gradient conventions. Every rank of the pipe group calls with the same
``x`` and the same stacked params, as a replicated JAX array. The output
is whole on every rank; its cotangent is the same on every rank, and the
last stage takes its own (JAX's ``g * n_stages`` undoes a ``shard_map``
transpose that divides a replicated output's cotangent by the axis size;
this port divides nothing, so it multiplies nothing). The stacked params'
gradient is this rank's stage slice, zero elsewhere: summed over the pipe
group it is JAX's. ``x``'s gradient is whole on every rank (stage 0's,
broadcast), as JAX's psum of a replicated input's cotangents is.

:class:`PipelineTrainStep` is the ``DistributedTrainStep``-shaped surface
(``AutoDist.build_pipeline``): a rank holds its stage's slice of the params
and of the optimizer slots, microbatches its own rows of the batch (each
data rank its block), and averages the stage gradients over the data
group. JAX microbatches the global batch; for row-wise stages and mean
losses over equal microbatches the two give the same loss and gradients.

Beside other wide axes, stage parameters are replicated over every axis
but ``pipe`` (JAX's ``_stage_spec``): the ranks of a model, expert or seq
axis run their stage whole, each on the same data block. A stage that
calls ``ring_attention`` or ``ulysses_attention`` on a seq axis larger than
1 raises ``ValueError``, as the JAX package's does.
"""
from __future__ import annotations

import functools
import weakref
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from autodist_tpu_torch import const
from autodist_tpu_torch.api import resolve_mesh
from autodist_tpu_torch.models.convert import (flatten_params, map_params, map_tree,
                                               unflatten_params)
from autodist_tpu_torch.parallel.ring_attention import pipeline_stage
from autodist_tpu_torch.runtime.process_group import _all_gather, exchange, peer

SCHEDULES = ("gpipe", "1f1b")


# ------------------------------------------------------------------- trees
def _leaves(tree) -> List[torch.Tensor]:
    return list(flatten_params(tree).values()) if isinstance(tree, dict) else [tree]


def _rebuild(tree, leaves):
    if not isinstance(tree, dict):
        return leaves[0]
    return unflatten_params(dict(zip(flatten_params(tree), leaves)))


def _micro(x, n_micro: int):
    b = x.shape[0]
    if b % n_micro != 0:
        raise ValueError(f"batch {b} not divisible by n_microbatches {n_micro}")
    return x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))


def _micro_tree(tree, n_micro: int):
    return None if tree is None else map_tree(lambda a: _micro(a, n_micro), tree)


def _index_tree(tree, m: int):
    return None if tree is None else map_tree(lambda a: a[m], tree)


def _head(loss_head, out, tgt):
    return loss_head(out) if tgt is None else loss_head(out, tgt)


# ------------------------------------------------------------------- mesh
def _pipe_axis_size(mesh, axis_name: str) -> int:
    return 1 if mesh is None else mesh.shape.get(axis_name, 1)


def _check_stages(n_stages: int, axis_size: int, axis_name: str) -> None:
    if axis_size != n_stages:
        raise ValueError(f"stage dim ({n_stages}) must equal mesh axis {axis_name!r} "
                         f"size ({axis_size})")


def _n_stages(stacked_params) -> int:
    return _leaves(stacked_params)[0].shape[0]


def _sequential(stage_fn, stacked_params, x):
    """The stages one after another on the whole batch (no pipe axis)."""
    for s in range(_n_stages(stacked_params)):
        x = stage_fn(map_params(lambda a, i=s: a[i], stacked_params), x)
    return x


def _broadcast(t, src: int, group) -> torch.Tensor:
    dist.broadcast(t, src=peer(group, src), group=group)
    return t


# ----------------------------------------------------------- the pipeline
class _Ring:
    """One rank's place in the pipeline: stage ``s`` of ``S`` on the pipe
    group, ``M`` microbatches."""

    def __init__(self, stage_fn: Callable, n_micro: int, n_stages: int, group):
        self.stage_fn, self.M, self.S, self.group = _staged(stage_fn), n_micro, n_stages, group
        self.s = dist.get_rank(group)

    def fwd_valid(self, t: int) -> bool:
        return 0 <= t - self.s < self.M

    def bwd_micro(self, r: int) -> int:
        """The microbatch this stage handles at reverse tick ``r``."""
        return r - (self.S - 1 - self.s)

    def forward_ticks(self, micro, step: Callable) -> list:
        """Run the forward ticks: ``step(m, inp) -> out`` computes (and may
        record) stage ``s`` on microbatch ``m``; returns the last stage's
        outputs by microbatch (Nones elsewhere)."""
        s, S, M = self.s, self.S, self.M
        outputs, state = [None] * M, None
        for t in range(M + S - 1):
            out = None
            if self.fwd_valid(t):
                m = t - s
                out = step(m, micro[m] if s == 0 else state)
                if s == S - 1:
                    outputs[m] = out
            sends = [(out.contiguous(), s + 1)] if out is not None and s < S - 1 else []
            recvs = []
            if s > 0 and self.fwd_valid(t + 1):
                state = torch.empty_like(micro[0])
                recvs = [(state, s - 1)]
            exchange(self.group, sends, recvs)
        return outputs

    def gather_output(self, outputs, like) -> torch.Tensor:
        """The last stage's outputs, whole, on every rank of the pipe group."""
        if self.s == self.S - 1:
            full = torch.cat(outputs)
            if full.shape != like.shape or full.dtype != like.dtype:
                raise ValueError(f"stage_fn must preserve shape and dtype: "
                                 f"{tuple(like.shape)} {like.dtype} -> "
                                 f"{tuple(full.shape)} {full.dtype}")
        else:
            full = torch.empty_like(like)
        return _broadcast(full.contiguous(), self.S - 1, self.group)

    def backward_ticks(self, g, vjp: Callable):
        """The reverse pipeline: the last stage injects the output
        cotangent of microbatch ``r`` at reverse tick ``r``, cotangents ride
        the reverse rotation; ``vjp(m, g_out) -> g_inp`` runs stage ``s``'s
        backward on microbatch ``m``. Returns stage 0's input cotangents by
        microbatch (Nones elsewhere)."""
        s, S, M = self.s, self.S, self.M
        g_micro = _micro(g, M)
        gx, g_state = [None] * M, None
        for r in range(M + S - 1):
            m = self.bwd_micro(r)
            g_inp = None
            if 0 <= m < M:
                g_inp = vjp(m, g_micro[m] if s == S - 1 else g_state)
                if s == 0:
                    gx[m] = g_inp
            sends = [(g_inp.contiguous(), s - 1)] if g_inp is not None and s > 0 else []
            recvs = []
            if s < S - 1 and 0 <= self.bwd_micro(r + 1) < M:
                g_state = torch.empty_like(g_micro[0])
                recvs = [(g_state, s + 1)]
            exchange(self.group, sends, recvs)
        return gx

    def whole_input_grad(self, gx: list, like) -> torch.Tensor:
        """Stage 0's input cotangent, whole, on every rank."""
        full = torch.cat(gx) if self.s == 0 else torch.empty_like(like)
        return _broadcast(full.contiguous(), 0, self.group)


def _staged(stage_fn):
    """``stage_fn`` run as a pipelined stage (``pipeline_stage``)."""
    @functools.wraps(stage_fn)
    def wrapped(params, h):
        with pipeline_stage():
            return stage_fn(params, h)
    return wrapped


#: The stage shapes :func:`_check_stage` has passed, per owner (a stage
#: function or a PipelineTrainStep).
_STAGES_CHECKED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _check_stage(stage_fn, params, x, n_micro: int, mesh, owner=None) -> None:
    """On a mesh with a seq axis larger than 1, run the stage once on meta
    tensors shaped as a microbatch, so that a seq-parallel attention in it
    raises (``pipeline_stage``) on every rank before any point-to-point op
    (a rank that raised mid-pipeline would leave its peers waiting). Once
    per ``owner`` (default ``stage_fn``) and shape: the answer does not
    change between steps. A stage whose ops do not run on meta tensors is
    left to its first real call."""
    seq = 1 if mesh is None else mesh.shape.get(const.MESH_AXIS_SEQ, 1)
    if seq <= 1:
        return
    key = (seq, n_micro, tuple(x.shape), x.dtype,
           tuple((tuple(t.shape), t.dtype) for t in _leaves(params)))
    try:
        seen = _STAGES_CHECKED.setdefault(stage_fn if owner is None else owner, set())
    except TypeError:                     # an owner that takes no weak reference
        seen = set()
    if key in seen:
        return
    meta = map_params(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), params)
    h = torch.empty((x.shape[0] // n_micro,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device="meta")
    try:
        with torch.no_grad(), pipeline_stage():
            stage_fn(meta, h)
    except (NotImplementedError, RuntimeError):
        pass
    seen.add(key)


def _stage_vjp(stage_fn, p_tree, p_req, inp, g_out, acc):
    """Stage backward from a boundary input: recompute, then the gradients
    of the input and of the params (added into ``acc``)."""
    with torch.enable_grad():
        inp = inp.detach().requires_grad_(True)
        out = stage_fn(p_tree, inp)
        grads = torch.autograd.grad(out, [inp] + [p for p in p_req if p is not None],
                                    g_out, allow_unused=True)
    _accumulate(acc, p_req, grads[1:])
    return grads[0]


def _accumulate(acc, p_req, grads) -> None:
    it = iter(grads)
    for i, p in enumerate(p_req):
        if p is None:
            continue
        g = next(it)
        if g is not None:
            acc[i] = g if acc[i] is None else acc[i] + g


def _detached(params: List[torch.Tensor], every: bool = False):
    """Leaves of their own for a stage's backward: those that need a
    gradient (``every``: each floating one) require one; the others are
    None in the second list."""
    leaves = [p.detach().requires_grad_(p.is_floating_point() if every else p.requires_grad)
              for p in params]
    return leaves, [p if p.requires_grad else None for p in leaves]


class _PipelineFn(torch.autograd.Function):
    """``pipeline_apply`` on one rank: the forward ticks (keeping stage
    graphs under ``gpipe``, boundary inputs under ``1f1b``), the whole
    output broadcast from the last stage; the backward is the reverse
    pipeline."""

    @staticmethod
    def forward(ctx, ring: _Ring, schedule: str, tree, x, *params):
        ctx.ring, ctx.schedule, ctx.tree = ring, schedule, tree
        micro = _micro(x.detach(), ring.M)
        leaves, p_req = _detached(list(params))
        p_tree = _rebuild(tree, leaves)
        kept = [None] * ring.M

        def step(m, inp):
            if schedule == "1f1b":
                kept[m] = inp
                return ring.stage_fn(p_tree, inp).detach()
            with torch.enable_grad():
                leaf = inp.detach().requires_grad_(True)
                out = ring.stage_fn(p_tree, leaf)
            kept[m] = (leaf, out)
            return out.detach()

        outputs = ring.forward_ticks(micro, step)
        if schedule == "1f1b":
            ctx.save_for_backward(*params, *[k for k in kept if k is not None])
            ctx.saved_at = [m for m, k in enumerate(kept) if k is not None]
        else:
            ctx.kept, ctx.p_req = kept, p_req
        return ring.gather_output(outputs, x)

    @staticmethod
    def backward(ctx, g):
        ring = ctx.ring
        if ctx.schedule == "1f1b":
            saved = ctx.saved_tensors
            n = len(saved) - len(ctx.saved_at)
            leaves, p_req = _detached(list(saved[:n]))
            boundary = dict(zip(ctx.saved_at, saved[n:]))
            p_tree = _rebuild(ctx.tree, leaves)
            acc = [None] * n

            def vjp(m, g_out):
                return _stage_vjp(ring.stage_fn, p_tree, p_req, boundary.pop(m), g_out, acc)
        else:
            p_req, kept = ctx.p_req, ctx.kept
            acc = [None] * len(p_req)

            def vjp(m, g_out):
                leaf, out = kept[m]
                kept[m] = None
                grads = torch.autograd.grad(out, [leaf] + [p for p in p_req if p is not None],
                                            g_out, allow_unused=True)
                _accumulate(acc, p_req, grads[1:])
                return grads[0]

        gx = ring.backward_ticks(g.contiguous(), vjp)
        ctx.kept = None
        # The stages preserve shape and dtype: g is shaped like x.
        gx_whole = ring.whole_input_grad(gx, g) if ctx.needs_input_grad[3] else None
        return (None, None, None, gx_whole, *acc)


def pipeline_apply_local(stage_params, x, stage_fn: Callable, n_microbatches: int,
                         n_stages: int, axis_name: str = const.MESH_AXIS_PIPE,
                         group=None):
    """GPipe on this rank: ``stage_params`` is this stage's slice (no
    leading stage dim), ``x`` the whole batch, the same on every pipe rank;
    ``group`` the pipe group (default: the default AutoDist's
    ``axis_name`` group). Returns the whole output on every rank."""
    return _pipeline_local(stage_params, x, stage_fn=stage_fn, n_micro=n_microbatches,
                           n_stages=n_stages, group=group, axis_name=axis_name)


def _pipeline_local(stage_params, x, *, stage_fn, n_micro: int, n_stages: int, group=None,
                    axis_name: str = const.MESH_AXIS_PIPE, schedule: str = "gpipe"):
    if group is None:
        mesh = resolve_mesh(None, "pipeline_apply_local")
        group = mesh.axis_group(axis_name, required=True)
    _check_stages(n_stages, dist.get_world_size(group), axis_name)
    _micro(x, n_micro)                    # the divisibility check, before any P2P
    if not torch.is_grad_enabled():
        return _forward_only(stage_fn, stage_params, x, n_micro, n_stages, group)
    ring = _Ring(stage_fn, n_micro, n_stages, group)
    return _PipelineFn.apply(ring, schedule, stage_params, x, *_leaves(stage_params))


def _forward_only(stage_fn, stage_params, x, n_micro: int, n_stages: int, group):
    """The pipelined forward without a graph (evaluation, ``no_grad``)."""
    ring = _Ring(stage_fn, n_micro, n_stages, group)
    with torch.no_grad():
        outputs = ring.forward_ticks(_micro(x, n_micro),
                                     lambda m, inp: stage_fn(stage_params, inp))
        return ring.gather_output(outputs, x)


def pipeline_apply(stage_fn: Callable, stacked_params, x, n_microbatches: int, mesh=None,
                   axis_name: str = const.MESH_AXIS_PIPE, remat_stages: bool = False,
                   schedule: str = "gpipe"):
    """Apply a pipelined stage stack to ``x`` (the whole batch, the same on
    every rank of the pipe group).

    ``stacked_params``: a tree whose leaves carry a leading ``[S]`` stage
    dim; rank ``s`` of the pipe group runs slice ``s``. Without a pipe
    axis wider than 1 the stages run one after another, same math, no
    communication. ``remat_stages=True`` checkpoints each stage
    (``torch.utils.checkpoint``): the backward keeps boundary activations
    only, at one more stage forward. ``schedule``: ``"gpipe"`` or
    ``"1f1b"`` (see the module docstring); for the interleaved loop, whose
    live activations stay O(S), use :func:`pipeline_value_and_grad`."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    owner = stage_fn
    if remat_stages:
        stage_fn = _remat(stage_fn)
    mesh = resolve_mesh(mesh)
    n_stages = _n_stages(stacked_params)
    axis_size = _pipe_axis_size(mesh, axis_name)
    if axis_size <= 1:
        return _sequential(stage_fn, stacked_params, x)
    _check_stages(n_stages, axis_size, axis_name)
    group = mesh.axis_group(axis_name, required=True)
    s = dist.get_rank(group)
    local = map_params(lambda a: a[s], stacked_params)
    _check_stage(stage_fn, local, x, n_microbatches, mesh, owner)
    return _pipeline_local(local, x, stage_fn=stage_fn, n_micro=n_microbatches,
                           n_stages=n_stages, group=group, schedule=schedule)


def _remat(stage_fn):
    @functools.wraps(stage_fn)
    def wrapped(params, h):
        return checkpoint(stage_fn, params, h, use_reentrant=False)
    return wrapped


# ------------------------------------------------- interleaved 1F1B loop
def _1f1b_interleaved_local(stage_fn, loss_head, n_micro: int, n_stages: int, group):
    """The fully interleaved 1F1B loop on this rank: stage ``s`` forwards
    microbatch ``m`` at tick ``t = s + m`` and backwards it at ``t = 2(S-1)
    + m - s``; the last stage turns a microbatch around in the tick its
    forward ends. A boundary input lives ``2(S-1-s)`` ticks, so a ring of
    ``R = 2S-1`` slots holds them all. Stage interiors are recomputed in
    the backward.

    Returns ``run(params, x, targets) -> (loss, grads, gx)``: the mean loss
    over microbatches (on every rank), this stage's parameter gradients
    (a list in ``params``' leaf order) and ``x``'s whole cotangent (on
    every rank)."""
    S, R = n_stages, 2 * n_stages - 1
    stage_fn = _staged(stage_fn)

    def run(params, x, targets):
        s = dist.get_rank(group)
        M = n_micro
        micro = _micro(x.detach(), M)
        tgt_micro = _micro_tree(targets, M)
        leaves, p_req = _detached(_leaves(params), every=True)
        p_tree = _rebuild(params, leaves)
        ring: List[Optional[torch.Tensor]] = [None] * R
        acc = [None] * len(leaves)
        gx = [None] * M
        loss_acc = torch.zeros((), dtype=torch.float32, device=x.device)
        fwd_state = bwd_state = g_self = None
        for t in range(M + 2 * (S - 1)):
            m_f, out = t - s, None
            if 0 <= m_f < M:
                inp = micro[m_f] if s == 0 else fwd_state
                with torch.no_grad():
                    out = stage_fn(p_tree, inp)
                ring[t % R] = inp
                if s == S - 1:
                    with torch.enable_grad():
                        o = out.detach().requires_grad_(True)
                        loss_m = _head(loss_head, o, _index_tree(tgt_micro, m_f))
                        (g_self,) = torch.autograd.grad(loss_m, o)
                    loss_acc = loss_acc + loss_m.detach().float()
            m_b, g_inp = t - 2 * (S - 1) + s, None
            if 0 <= m_b < M:
                g_out = g_self if s == S - 1 else bwd_state
                saved = ring[(t - 2 * (S - 1) + 2 * s) % R]
                g_inp = _stage_vjp(stage_fn, p_tree, p_req, saved, g_out, acc)
                if s == 0:
                    gx[m_b] = g_inp
            sends, recvs = [], []
            if out is not None and s < S - 1:
                sends.append((out.contiguous(), s + 1))
            if g_inp is not None and s > 0:
                sends.append((g_inp.contiguous(), s - 1))
            if s > 0 and 0 <= t + 1 - s < M:
                fwd_state = torch.empty_like(micro[0])
                recvs.append((fwd_state, s - 1))
            if s < S - 1 and 0 <= t + 1 - 2 * (S - 1) + s < M:
                bwd_state = torch.empty_like(micro[0])
                recvs.append((bwd_state, s + 1))
            exchange(group, sends, recvs)
        loss = loss_acc if s == S - 1 else torch.zeros_like(loss_acc)
        dist.all_reduce(loss, group=group)
        grads = [torch.zeros_like(p) if a is None else a / M for a, p in zip(acc, leaves)]
        gx_whole = torch.cat(gx) if s == 0 else torch.zeros_like(x)
        dist.all_reduce(gx_whole, group=group)
        return loss / M, grads, gx_whole / M

    return run


def _sequential_value_and_grad(stage_fn, stacked_params, x, loss_head, n_micro, targets):
    """The sequential fallback: the mean microbatch loss by plain autograd."""
    leaves, _ = _detached(_leaves(stacked_params), every=True)
    xx = x.detach().requires_grad_(x.is_floating_point())
    with torch.enable_grad():
        out = _sequential(stage_fn, _rebuild(stacked_params, leaves), xx)
        outs, tgts = _micro(out, n_micro), _micro_tree(targets, n_micro)
        loss = torch.stack([_head(loss_head, outs[m], _index_tree(tgts, m)).float()
                            for m in range(n_micro)]).mean()
        wrt = leaves + ([xx] if xx.requires_grad else [])
        grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, wrt)]
    gx = grads[len(leaves)] if xx.requires_grad else None
    return loss.detach(), grads[:len(leaves)], gx


def pipeline_value_and_grad(stage_fn: Callable, stacked_params, x, loss_head: Callable,
                            n_microbatches: int, targets=None, mesh=None,
                            axis_name: str = const.MESH_AXIS_PIPE):
    """Loss and gradients of a pipelined stage stack in one interleaved
    1F1B loop: live activations O(S) a rank, independent of
    ``n_microbatches``.

    ``loss_head(out_microbatch[, target_microbatch]) -> scalar`` is the
    per-microbatch mean loss at the last stage (targets, when given, are
    batched like ``x`` on dim 0 and microbatched with it). Returns
    ``(loss, stacked_grads, gx)``: the mean over microbatches,
    ``stacked_grads`` shaped like ``stacked_params`` (this rank's stage
    slice; zero elsewhere under a pipe axis, see the module docstring) and
    ``x``'s cotangent. Without a pipe axis wider than 1 the stages run one
    after another under plain autograd."""
    mesh = resolve_mesh(mesh)
    n_stages = _n_stages(stacked_params)
    axis_size = _pipe_axis_size(mesh, axis_name)
    if axis_size <= 1:
        loss, grads, gx = _sequential_value_and_grad(stage_fn, stacked_params, x, loss_head,
                                                     n_microbatches, targets)
        return loss, _rebuild(stacked_params, grads), gx
    _check_stages(n_stages, axis_size, axis_name)
    group = mesh.axis_group(axis_name, required=True)
    s = dist.get_rank(group)
    local = map_params(lambda a: a[s], stacked_params)
    _micro(x, n_microbatches)
    _check_stage(stage_fn, local, x, n_microbatches, mesh)
    run = _1f1b_interleaved_local(stage_fn, loss_head, n_microbatches, n_stages, group)
    loss, grads, gx = run(local, x, targets)
    stacked = []
    for g, p in zip(grads, _leaves(stacked_params)):
        full = torch.zeros_like(p)
        full[s] = g
        stacked.append(full)
    return loss, _rebuild(stacked_params, stacked), gx


# ----------------------------------------------------------------- train step
class PipelineTrainStep:
    """``DistributedTrainStep``-shaped surface over a pipelined stage stack
    (``AutoDist.build_pipeline``): ``init / __call__ / run / evaluate``,
    backed by the interleaved 1F1B loop of :func:`pipeline_value_and_grad`
    over the mesh's pipe axis, the batch split over its data axis.

    ``batch`` is ``(x, targets)`` (``targets=None`` for a ``loss_head`` of
    the output alone). A rank holds its stage's slice ``[1, ...]`` of the
    stacked params and of the optimizer slots (the whole stack without a
    pipe axis); the optimizer sees each leaf as a block of the ``[S, ...]``
    stack, so global norms and factored statistics sum over the pipe group.
    ``logical_params`` gathers the stack. ``donate_state=False`` leaves the
    state passed in unchanged (the update works on a copy)."""

    def __init__(self, stage_fn: Callable, loss_head: Callable, tx, n_microbatches: int,
                 mesh=None, axis_name: str = const.MESH_AXIS_PIPE,
                 donate_state: bool = True):
        self.stage_fn = stage_fn
        self.loss_head = loss_head
        self.tx = tx
        self.n_microbatches = n_microbatches
        self.mesh = resolve_mesh(mesh, "PipelineTrainStep")
        self.axis_name = axis_name
        self._donate = donate_state
        self.n_stages = _pipe_axis_size(self.mesh, axis_name)
        self.group = (self.mesh.axis_group(axis_name, required=True)
                      if self.n_stages > 1 else None)
        self.stage = dist.get_rank(self.group) if self.group is not None else 0
        self.n_data, self.data_rank = self.mesh.data_size, self.mesh.data_rank
        self.data_group = self.mesh.group if self.n_data > 1 else None

    # ----------------------------------------------------------- helpers
    def _layout(self, leaves):
        if self.group is None:
            return None
        return [(0, (self.n_stages,) + tuple(p.shape[1:]), "pipe") for p in leaves]

    def _psum(self, t: torch.Tensor, lay) -> torch.Tensor:
        """A stage block's partial sum over the pipe group."""
        dist.all_reduce(t, group=self.group)
        return t

    def _local_rows(self, tree):
        """This data rank's block of every batched leaf."""
        n, r = self.n_data, self.data_rank

        def rows(t):
            t = t.to(self.mesh.device)
            if n == 1:
                return t
            if t.shape[0] % n:
                raise ValueError(f"global batch {t.shape[0]} not divisible by the data "
                                 f"axis {n}")
            per = t.shape[0] // n
            return t[r * per:(r + 1) * per]

        return None if tree is None else map_tree(rows, tree)

    def _data_mean(self, t: torch.Tensor) -> torch.Tensor:
        if self.data_group is not None:
            dist.all_reduce(t, group=self.data_group)
            t = t / self.n_data
        return t

    def _value_and_grad(self, params, x, targets):
        if self.group is None:
            return _sequential_value_and_grad(self.stage_fn, params, x, self.loss_head,
                                              self.n_microbatches, targets)[:2]
        _micro(x, self.n_microbatches)
        _check_stage(self._stage, params, x, self.n_microbatches, self.mesh, self)
        run = _1f1b_interleaved_local(self._stage, self.loss_head, self.n_microbatches,
                                      self.n_stages, self.group)
        loss, grads, _ = run(params, x, targets)
        return loss, grads

    def _stage(self, params, h):
        """The stage function on this rank's ``[1, ...]`` slice."""
        return self.stage_fn(map_params(lambda a: a[0], params), h)

    # --------------------------------------------------------------- api
    def init(self, stacked_params):
        """The train state: this stage's slice of ``stacked_params`` (every
        leaf ``[S, ...]``) on the mesh's device, and its optimizer slots."""
        from autodist_tpu_torch.kernel.lowering import TrainState

        dev, s = self.mesh.device, self.stage
        if self.group is not None:
            _check_stages(_n_stages(stacked_params), self.n_stages, self.axis_name)
            params = map_params(lambda a: a[s:s + 1].detach().to(dev).clone(),
                                stacked_params)
        else:
            params = map_params(lambda a: a.detach().to(dev).clone(), stacked_params)
        leaves = _leaves(params)
        return TrainState(step=0, params=params,
                          opt_state=self.tx.init(leaves, self._layout(leaves)))

    def _update(self, state, batch):
        x, targets = batch
        x, targets = self._local_rows(x), self._local_rows(targets)
        loss, grads = self._value_and_grad(state.params, x, targets)
        if self.data_group is not None:
            flat = torch.cat([g.reshape(-1) for g in grads])
            flat = self._data_mean(flat)
            grads = [c.view_as(g) for c, g in
                     zip(flat.split([g.numel() for g in grads]), grads)]
        leaves = _leaves(state.params)
        with torch.no_grad():
            updates = self.tx.update(grads, state.opt_state, leaves,
                                     layout=self._layout(leaves),
                                     psum=self._psum if self.group is not None else None)
            for p, u in zip(leaves, updates):
                p.add_(u.to(p.dtype))
        state.step += 1
        return state, {"loss": self._data_mean(loss.detach())}

    @staticmethod
    def _copy(state):
        from autodist_tpu_torch.kernel.lowering import TrainState

        def clone(tree):
            if isinstance(tree, torch.Tensor):
                return tree.clone()
            if isinstance(tree, dict):
                return {k: clone(v) for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(clone(v) for v in tree)
            return tree

        return TrainState(step=state.step, params=clone(state.params),
                          opt_state=clone(state.opt_state))

    def __call__(self, state, batch):
        if not self._donate:
            state = self._copy(state)
        return self._update(state, batch)

    def run(self, state, batch, n_steps: int):
        """``n_steps`` steps on one batch; metrics stacked per step
        (``metrics["loss"].shape == (n_steps,)``)."""
        if not self._donate:
            state = self._copy(state)
        losses = []
        for _ in range(n_steps):
            state, m = self._update(state, batch)
            losses.append(m["loss"])
        return state, {"loss": torch.stack(losses)}

    def evaluate(self, state, batch):
        """Mean microbatched loss, no gradients or state mutation."""
        x, targets = batch
        x, targets = self._local_rows(x), self._local_rows(targets)
        M = self.n_microbatches
        with torch.no_grad():
            if self.group is None:
                out = _sequential(self.stage_fn, state.params, x)
            else:
                _check_stage(self._stage, state.params, x, M, self.mesh, self)
                out = _forward_only(self._stage, state.params, x, M, self.n_stages,
                                    self.group)
            outs, tgts = _micro(out, M), _micro_tree(targets, M)
            loss = torch.stack([_head(self.loss_head, outs[m], _index_tree(tgts, m)).float()
                                for m in range(M)]).mean()
        return {"loss": self._data_mean(loss)}

    def logical_params(self, state):
        """The whole ``[S, ...]`` stack of every leaf (gathered over the
        pipe group)."""
        if self.group is None:
            return state.params

        def gather(t):
            out = t.new_empty((self.n_stages,) + tuple(t.shape[1:]))
            _all_gather(out, t.contiguous(), group=self.group)
            return out

        leaves = _leaves(state.params)
        return _rebuild(state.params, [gather(t) for t in leaves])
