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
all-gather: the bytes it gathers). Without a group every call is the
identity and counts nothing.
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

    def _count(self, purpose: str, kind: str, t: torch.Tensor) -> None:
        self.counts[purpose][kind] += 1
        self.nbytes[purpose][kind] += t.numel() * t.element_size()

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

    def reduce_scatter(self, t: torch.Tensor, dim: int, purpose: str) -> torch.Tensor:
        """This rank's block along ``dim`` of the group's mean of ``t``."""
        if self.group is None:
            return t
        self._count(purpose, "reduce_scatter", t)
        front = (t.movedim(dim, 0) / self.size).contiguous()
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
