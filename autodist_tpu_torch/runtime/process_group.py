"""Join the ``torch.distributed`` process group (PyTorch port of the JAX
package's ``runtime/cluster.py`` ``jax.distributed.initialize`` step).

One process per device: rank ``r`` trains on ``cuda:LOCAL_RANK`` (or the
CPU when asked). :func:`join` forms the group from the ``torchrun``
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
``MASTER_PORT``) or from an explicit ``init_method``, on ``nccl`` for CUDA
and ``gloo`` for ``device="cpu"``, always with a timeout. At world size 1
it does nothing unless asked explicitly. Nothing falls back: a CUDA run
without NCCL, or a group that does not form, raises.

:class:`Collectives` is the one place the port's collectives are issued:
mean and sum all-reduces, reduce-scatter and all-gather along any dim
(moved to the front and made contiguous, as NCCL splits dim 0), and the
broadcast of ``init``. Each call adds one to ``counts[purpose][kind]`` and
the bytes it hands the collective to ``nbytes[purpose][kind]`` (an
all-gather: the bytes it gathers), the largest one call's in
``largest[purpose][kind]``. Without a group every call is the
identity and counts nothing. :meth:`Collectives.over` gives the same
counters over another group (a mesh's model axis), and
:meth:`Collectives.count_dtensor` counts, by kind under a purpose, the
collectives that ``DTensor`` issues itself in a block (its redistributions
over the model and expert axes).
"""
from __future__ import annotations

import contextlib
import datetime
import os
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0

_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def peer(group, index: int) -> int:
    """The global rank of ``group``'s rank ``index``."""
    return dist.get_global_rank(group, index)


def exchange(group, sends, recvs) -> None:
    """One batch of point-to-point ops on ``group``: ``sends`` and
    ``recvs`` are ``(tensor, group rank)`` pairs; waits for all of them."""
    ops = [dist.P2POp(dist.isend, t, peer(group, r), group) for t, r in sends]
    ops += [dist.P2POp(dist.irecv, t, peer(group, r), group) for t, r in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def join(device: torch.device, init_method: Optional[str] = None,
         world_size: Optional[int] = None, rank: Optional[int] = None,
         timeout_s: float = DEFAULT_TIMEOUT_S):
    """The default group of this process, formed if need be, or ``None`` at
    world size 1 without an explicit request (``init_method`` or
    ``world_size`` given). An existing group must use ``device``'s backend."""
    want = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise RuntimeError(f"the process group runs {have!r} but device "
                               f"{str(device)!r} needs {want!r}")
        return dist.group.WORLD
    explicit = init_method is not None or world_size is not None
    env_world = int(os.environ.get("WORLD_SIZE", "1"))
    if not explicit and env_world <= 1:
        return None
    if want == "nccl" and not dist.is_nccl_available():
        raise RuntimeError("a CUDA process group needs NCCL, which this torch lacks")
    world_size = env_world if world_size is None else int(world_size)
    rank = int(os.environ.get("RANK", "0")) if rank is None else int(rank)
    if device.type == "cuda":
        torch.cuda.set_device(local_device(device, rank))
    dist.init_process_group(want, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def local_device(device: torch.device, rank: int = 0) -> torch.device:
    """This rank's device: a CUDA device with an index as given, else
    ``cuda:LOCAL_RANK`` (else ``rank`` modulo the visible cards); the CPU
    as given."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else rank % torch.cuda.device_count()
    return torch.device("cuda", index)


def leave() -> None:
    """Destroy the default group, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


class Collectives:
    """Collectives over the data group, counted by purpose and kind."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group) if group is not None else 1
        self.counts: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
        self.nbytes: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
        self.largest: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))

    def over(self, group) -> "Collectives":
        """Collectives over ``group`` that add to this object's counters."""
        other = Collectives(group)
        other.counts, other.nbytes, other.largest = self.counts, self.nbytes, self.largest
        return other

    @contextlib.contextmanager
    def count_dtensor(self, purpose: str, axes: Optional[Dict[str, tuple]] = None
                      ) -> Iterator[None]:
        """Count the collectives ``DTensor`` issues within the block
        (forward and backward alike) by kind under ``purpose``, or under the
        name of the axis in ``axes`` (axis name -> the global ranks of its
        group) whose ranks the collective's group holds
        (``torch.distributed.tensor.debug.CommDebugMode``'s view of the
        functional collectives; bytes are not recorded). Ranks, not
        groups, decide: ``DTensor`` may run a collective on another group
        of the same ranks (that of an equal mesh it met before)."""
        mode = _group_counts()
        with mode:
            yield
        by_ranks = {r: ax for ax, r in (axes or {}).items()}
        for (op, group), n in mode.by_group.items():
            namespace, _, name = str(op).rpartition(".")
            if "functional" not in namespace:
                continue        # this class's own collectives, counted where issued
            where = by_ranks.get(_group_ranks(group), purpose) if group else purpose
            self.counts[where][_DTENSOR_KINDS.get(name, name)] += n

    def _count(self, purpose: str, kind: str, t: torch.Tensor) -> None:
        nbytes = t.numel() * t.element_size()
        self.counts[purpose][kind] += 1
        self.nbytes[purpose][kind] += nbytes
        self.largest[purpose][kind] = max(self.largest[purpose][kind], nbytes)

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        return {p: dict(k) for p, k in self.counts.items()}

    def bytes_snapshot(self) -> Dict[str, Dict[str, int]]:
        return {p: dict(k) for p, k in self.nbytes.items()}

    def all_reduce(self, t: torch.Tensor, purpose: str, mean: bool = False,
                   async_op: bool = False):
        """In-place sum (``mean``: then divided by the group size) of ``t``
        over the group. ``async_op`` returns the work handle (the division
        is then the caller's)."""
        if self.group is None:
            return None
        self._count(purpose, "all_reduce", t)
        work = dist.all_reduce(t, group=self.group, async_op=async_op)
        if async_op:
            return work
        if mean:
            t.div_(self.size)
        return t

    def reduce_scatter(self, t: torch.Tensor, dim: int, purpose: str,
                       mean: bool = True) -> torch.Tensor:
        """This rank's block along ``dim`` of the group's mean of ``t`` (its
        sum when not ``mean``)."""
        if self.group is None:
            return t
        self._count(purpose, "reduce_scatter", t)
        front = t.movedim(dim, 0)
        front = (front / self.size if mean else front).contiguous()
        out = front.new_empty((front.shape[0] // self.size,) + tuple(front.shape[1:]))
        _reduce_scatter(out, front, group=self.group)
        return out.movedim(0, dim)

    def reduce_scatter_flat(self, flat: torch.Tensor, purpose: str, async_op: bool = False):
        """Sum-reduce-scatter of a flat buffer laid out rank block by rank
        block; returns ``(out, work)``."""
        out = flat.new_empty(flat.numel() // self.size)
        self._count(purpose, "reduce_scatter", flat)
        work = _reduce_scatter(out, flat, group=self.group, async_op=async_op)
        return out, work

    def all_gather(self, t: torch.Tensor, dim: int, purpose: str) -> torch.Tensor:
        """The group's blocks of ``t`` concatenated along ``dim``."""
        if self.group is None:
            return t
        front = t.movedim(dim, 0).contiguous()
        out = front.new_empty((front.shape[0] * self.size,) + tuple(front.shape[1:]))
        self._count(purpose, "all_gather", out)
        _all_gather(out, front, group=self.group)
        return out.movedim(0, dim)

    def broadcast(self, t: torch.Tensor, purpose: str) -> torch.Tensor:
        """``t`` overwritten in place by rank 0's."""
        if self.group is None:
            return t
        self._count(purpose, "broadcast", t)
        dist.broadcast(t, src=dist.get_global_rank(self.group, 0)
                       if self.group is not dist.group.WORLD else 0, group=self.group)
        return t


def _group_counts():
    """A ``CommDebugMode`` that also counts each collective by ``(op, the
    name of the process group it ran on)`` (``by_group``): the native
    functional collectives take the group's name as their last string
    argument."""
    from torch.distributed.tensor.debug import CommDebugMode

    class GroupCounts(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.by_group: Dict[tuple, int] = defaultdict(int)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            before = dict(self.comm_counts)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            grown = {op: n - before.get(op, 0) for op, n in self.comm_counts.items()
                     if n != before.get(op, 0)}
            if grown:
                names = [a for a in list(args) + list((kwargs or {}).values())
                         if isinstance(a, str)]
                for op, n in grown.items():
                    self.by_group[(op, names[-1] if names else None)] += n
            return out

    return GroupCounts()


def _group_ranks(name: str) -> Optional[tuple]:
    """The global ranks of the process group of ``name`` (None when no
    group has that name)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    try:
        return tuple(dist.get_process_group_ranks(_resolve_process_group(name)))
    except (KeyError, RuntimeError, ValueError, TypeError, AttributeError):
        return None


#: ``DTensor``'s functional collectives -> this module's kinds.
_DTENSOR_KINDS = {"all_reduce": "all_reduce", "all_gather_into_tensor": "all_gather",
                  "reduce_scatter_tensor": "reduce_scatter",
                  "all_to_all_single": "all_to_all", "broadcast": "broadcast"}

_stats: Optional[Collectives] = None


@contextlib.contextmanager
def batch_stats_over(coll: Optional[Collectives]) -> Iterator[None]:
    """Within the block, layers that reduce over the batch (BatchNorm)
    reduce their statistics over ``coll``'s group: the JAX package's
    GSPMD step, where a batch mean is over the global batch."""
    global _stats
    prev, _stats = _stats, coll
    try:
        yield
    finally:
        _stats = prev


def batch_stats() -> Optional[Collectives]:
    """The group batch statistics reduce over, or ``None`` (local)."""
    return _stats
