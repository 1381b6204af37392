"""Bucketed gradient sync that overlaps the backward (PyTorch port of
``kernel/bucketing.py``).

**Assignment** (:func:`assign_buckets`): the eligible variables, walked in
reverse model order (the backward produces the last layers' gradients
first), fill buckets greedily up to ``bucket_bytes``; a bucket closes once
it reaches the target. Eligible are the variables whose gradient sync is a
plain mean all-reduce or a ZeRO-1 reduce-scatter; PS variables and those
claimed by a sharded rendering (compressed, expert, partitioned, sparse)
are not (:func:`plan_exclusion_reasons` on a lowered plan,
:func:`bucket_exclusion_reasons` on shapes and mesh degrees, the cost
model's entry point).

**Emission** (:class:`BucketSync`): a hook on each bucketed gradient target
(``Tensor.register_hook``, which fires under ``torch.autograd.grad``)
records the gradient; once every gradient of bucket ``i`` and every bucket
before it has arrived, the bucket's collectives launch asynchronously, one
for each kind over a flat buffer: a sum all-reduce of its plain variables'
gradients (divided by the group size after the wait) and a reduce-scatter
of its ZeRO-1 variables' gradients divided by the group size (laid out so
rank ``r``'s block holds every variable's ``r``-th slice). Launching in
bucket order keeps every rank's collectives in one order. After the
backward, buckets still open (a gradient that did not reach its target —
an unused variable — counts as zeros) launch in order, and every launch is
waited on before the update.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

#: Every reason a variable stays out of the buckets, in emission order.
EXCLUSION_REASONS = ("nontrainable", "ps", "compressed", "expert", "partitioned", "sparse")


def bucket_exclusion_reasons(
    shape: Sequence[int], *, trainable: bool = True, is_ps: bool = False,
    sparse_update: bool = False, expert: bool = False, part_axis: Optional[int] = None,
    compressor: str = "NoneCompressor", n_data: int = 1, n_model: int = 1,
    n_expert: int = 1,
) -> Tuple[str, ...]:
    """Why a variable would stay out of the buckets, from its shape and the
    mesh degrees alone (no plan), in :data:`EXCLUSION_REASONS` order; empty
    = eligible. The renderings that claim a variable away from the plain
    all-reduce or ZeRO-1 reduce-scatter are the ZeRO-1 degradation
    predicate's (``kernel/degrade.py``): its ``scalar`` and
    ``non_divisible`` reasons do not exclude (such a variable syncs by a
    plain all-reduce, which buckets)."""
    from autodist_tpu_torch.kernel.degrade import zero1_degradation_reasons

    shared = zero1_degradation_reasons(
        shape, sparse_update=sparse_update, expert=expert, part_axis=part_axis,
        compressor=compressor, n_data=n_data, n_model=n_model, n_expert=n_expert)
    reasons = (["nontrainable"] if not trainable else []) + (["ps"] if is_ps else [])
    reasons += [r for r in ("compressed", "expert", "partitioned", "sparse") if r in shared]
    return tuple(r for r in EXCLUSION_REASONS if r in reasons)


def plan_exclusion_reasons(var_plan) -> Tuple[str, ...]:
    """Why a lowered ``VarPlan``'s variable stays out of the buckets, in
    :data:`EXCLUSION_REASONS` order; empty = eligible (its sync is a plain
    mean all-reduce or a ZeRO-1 reduce-scatter)."""
    from autodist_tpu_torch.kernel.degrade import is_active_compressor
    from autodist_tpu_torch.kernel.lowering import SyncKind

    reasons = []
    if not var_plan.var.trainable:
        reasons.append("nontrainable")
    if var_plan.kind is SyncKind.PS:
        reasons.append("ps")
    if is_active_compressor(var_plan.compressor):
        reasons.append("compressed")
    if not var_plan.shard_update and var_plan.storage_dim is not None:
        if var_plan.var.expert:
            reasons.append("expert")
        elif var_plan.var.sparse_update:
            reasons.append("sparse")
        else:
            reasons.append("partitioned")
    return tuple(r for r in EXCLUSION_REASONS if r in reasons)


def assign_buckets(sized_names: Sequence[Tuple[str, int]],
                   bucket_bytes: int) -> Tuple[Tuple[str, ...], ...]:
    """``(name, bytes)`` in model order -> buckets, walked in reverse: a
    bucket closes once its bytes reach ``bucket_bytes`` (an oversized
    variable gets its own). Deterministic; every name lands once."""
    if bucket_bytes <= 0 or not sized_names:
        return ()
    buckets, current, acc = [], [], 0
    for name, nbytes in reversed(list(sized_names)):
        current.append(name)
        acc += max(int(nbytes), 0)
        if acc >= bucket_bytes:
            buckets.append(tuple(current))
            current, acc = [], 0
    if current:
        buckets.append(tuple(current))
    return tuple(buckets)


class BucketSync:
    """One step's bucketed gradient sync over ``coll`` (a
    ``runtime.process_group.Collectives``). ``buckets`` hold variable
    names; ``zero1_dims`` maps a ZeRO-1 variable to its scatter dim."""

    def __init__(self, coll, buckets: Sequence[Sequence[str]], zero1_dims: Dict[str, int]):
        self.coll = coll
        self.buckets = [tuple(b) for b in buckets]
        self.zero1_dims = zero1_dims
        self.bucket_of = {name: i for i, b in enumerate(self.buckets) for name in b}
        self.grads: Dict[str, torch.Tensor] = {}
        self.missing = [len(b) for b in self.buckets]
        self.launched = 0
        self.pending: List[tuple] = []
        self.handles: list = []

    def hook(self, targets: Dict[str, torch.Tensor]) -> None:
        """Register the gradient hooks on each bucketed variable's target."""
        for name, t in targets.items():
            if name in self.bucket_of:
                self.handles.append(t.register_hook(self._record(name)))

    def _record(self, name: str):
        def fn(grad):
            self.grads[name] = grad
            self.missing[self.bucket_of[name]] -= 1
            self._launch_ready()
        return fn

    def _launch_ready(self) -> None:
        while self.launched < len(self.buckets) and self.missing[self.launched] == 0:
            self._launch(self.launched)
            self.launched += 1

    def _launch(self, i: int) -> None:
        names = self.buckets[i]
        plain = [n for n in names if n not in self.zero1_dims]
        zero1 = [n for n in names if n in self.zero1_dims]
        n = self.coll.size
        if plain:
            flat = torch.cat([self.grads[m].reshape(-1) for m in plain])
            work = self.coll.all_reduce(flat, "grad", async_op=True)
            self.pending.append(("plain", plain, flat, work))
        if zero1:
            fronts = [self.grads[m].movedim(self.zero1_dims[m], 0) for m in zero1]
            flat = torch.cat([f.reshape(n, -1) for f in fronts], dim=1).reshape(-1) / n
            out, work = self.coll.reduce_scatter_flat(flat, "grad", async_op=True)
            self.pending.append(("zero1", zero1, (out, fronts), work))

    def finish(self, targets: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Launch what is still open (unused gradients as zeros), wait for
        every bucket, and return each bucketed variable's synced gradient:
        the mean (plain) or this rank's mean slice along its dim (ZeRO-1)."""
        for h in self.handles:
            h.remove()
        for name in self.bucket_of:
            if name not in self.grads:
                self.grads[name] = torch.zeros_like(targets[name])
                self.missing[self.bucket_of[name]] -= 1
        self._launch_ready()
        out = {}
        n = self.coll.size
        for kind, names, payload, work in self.pending:
            work.wait()
            if kind == "plain":
                payload.div_(n)
                offset = 0
                for m in names:
                    g = self.grads[m]
                    out[m] = payload[offset:offset + g.numel()].view(g.shape)
                    offset += g.numel()
            else:
                flat, fronts = payload
                offset = 0
                for m, f in zip(names, fronts):
                    k = f.numel() // n
                    shard = flat[offset:offset + k].view((f.shape[0] // n,) + tuple(f.shape[1:]))
                    out[m] = shard.movedim(0, self.zero1_dims[m])
                    offset += k
        return out
