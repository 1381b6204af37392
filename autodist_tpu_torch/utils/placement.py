"""A ``DTensor``'s split on a shard mesh of one or two dims.

The step's split variables live on the shard mesh (``kernel/mesh.py``'s
``Mesh.shard_mesh``: the wide ``model`` and/or ``expert`` dims), each split
on at most one dim of it and replicated on the others, as the JAX package's
plans split each variable over at most one axis; so are the activations the
models compute from them. :func:`split_of` reads that one split and
:func:`placement_list` builds the full placement lists that ``local_map``
and ``DTensor.from_local`` take, so the model code reads the same on a
one-dim and a two-dim mesh. :func:`on_head_groups` runs an attention on
each rank's heads with one rule for the flash, dot, ring and Ulysses
routes.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Union


class Split(NamedTuple):
    """A tensor's one split: the mesh dim (None: replicated on every dim),
    its placement there, this rank's coordinate on that dim and its size."""

    dim: Optional[int]
    placement: Any
    coord: int
    size: int


def split_of(t) -> Optional[Split]:
    """The :class:`Split` of a ``DTensor`` (its first placement that is not
    ``Replicate``); None for a plain tensor."""
    placements = getattr(t, "placements", None)
    if placements is None:
        return None
    from torch.distributed.tensor import Replicate

    mesh = t.device_mesh
    for i, p in enumerate(placements):
        if not p.is_replicate():
            return Split(i, p, mesh.get_local_rank(i), mesh.size(i))
    return Split(None, Replicate(), 0, 1)


def placement_list(mesh, dim: Union[int, str, None], placement) -> list:
    """``placement`` on mesh dim ``dim`` (an index or a dim name; None:
    on none) and ``Replicate`` on the others."""
    from torch.distributed.tensor import Replicate

    if isinstance(dim, str):
        dim = mesh.mesh_dim_names.index(dim)
    return [placement if i == dim else Replicate() for i in range(mesh.ndim)]


def on_head_groups(fn, q):
    """``fn(q, k, v, causal)`` under ``local_map`` on each rank's heads of
    the ``DTensor`` q ``[B, S, H, D]``: ``Shard(2)`` on the mesh dims where
    q is split on its heads, ``Replicate`` on the others (so heads that are
    whole over the expert ranks stay whole there), for q, k, v and the
    output."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    heads = [Shard(2) if p == Shard(2) else Replicate() for p in q.placements]
    return local_map(fn, out_placements=heads, in_placements=(heads, heads, heads, None),
                     redistribute_inputs=True)
