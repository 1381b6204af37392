"""Device mesh from a ResourceSpec (PyTorch port of ``kernel/mesh.py``).

One process per device: a :class:`Mesh` is the logical axis sizes
(row-major over ``axis_names``: rank ``r``'s coordinates are ``r``'s digits
in the axis sizes), this process's rank, its device and the
``torch.distributed`` groups it trains over. The spec's GPU count must
equal the group's world size, or :func:`build_mesh` raises. Planning reads
only the axis sizes, so :meth:`Mesh.logical` gives a mesh of any size
without a group, for plans and their tests.

Besides the batch (``data``) axis, any of ``model`` (tensor parallelism),
``expert`` (expert parallelism), ``seq`` (ring / Ulysses attention,
``parallel/``) and ``pipe`` (pipeline stages) may be larger than 1, in any
mix. Such a mesh carries one ``torch.distributed`` ``DeviceMesh`` over the
world group (``device_mesh``) whose dims are the batch axis and every other
axis larger than 1, in ``axis_names`` order. Its subgroups are the mesh's
groups:

- ``group``, the data group: the ranks that share this rank's coordinate
  on every other axis, over which the gradients are synced. The batch is
  sharded over the data axis only, as the JAX package's ``data_sharding``
  does: the ranks of one model, expert, seq or pipe group see the same
  rows;
- :meth:`Mesh.axis_group` of ``seq`` or ``pipe``: the ranks that share
  every coordinate but that one, ordered by it;
- :meth:`Mesh.shard_mesh`: the sub-mesh of the wide ``model`` and/or
  ``expert`` dims (:attr:`Mesh.shard_axes`), one dim or two, on which
  split variables live as ``DTensor``s.

Ranks along a seq or pipe axis hold every parameter whole and split the
work of one data block (the seq ranks compute the rest of the model
redundantly, as GSPMD's replication does); stage parameters are replicated
over every axis but ``pipe``, as the JAX package's ``_stage_spec`` does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime import process_group as pg
from autodist_tpu_torch.utils.device import resolve_device

AXES = (const.MESH_AXIS_DATA, const.MESH_AXIS_MODEL)
#: Axes with a role other than carrying the batch (the JAX package's
#: ``const.ALL_MESH_AXES`` minus ``data``).
NON_DATA_AXES = (const.MESH_AXIS_MODEL, const.MESH_AXIS_SEQ, const.MESH_AXIS_EXPERT,
                 const.MESH_AXIS_PIPE)
#: The non-data axes a parameter can be sharded over in the port.
SHARD_AXES = (const.MESH_AXIS_MODEL, const.MESH_AXIS_EXPERT)
#: The non-data axes that split one data block's work over ranks through
#: a group of their own (``parallel/``).
GROUP_AXES = (const.MESH_AXIS_SEQ, const.MESH_AXIS_PIPE)


@dataclass(frozen=True)
class Mesh:
    """Named logical axes (row-major over ``axis_names``), this process's
    rank and device, the group of the data axis and, with any other axis
    larger than 1, the ``DeviceMesh`` over the batch axis and those axes
    (the module docstring)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Any = field(default=None, compare=False)
    device_mesh: Any = field(default=None, compare=False)
    world_group: Any = field(default=None, compare=False)

    @classmethod
    def logical(cls, shape: Dict[str, int], device="cpu") -> "Mesh":
        """A mesh of ``shape`` with no group: enough to plan on."""
        shape = dict(shape)
        for ax in AXES:
            shape.setdefault(ax, 1)         # after the given axes, as JAX's mesh_shape
        return cls(axis_names=tuple(shape), shape=shape, device=torch.device(device))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """This process's devices: one."""
        return (self.device,)

    @property
    def data_axis(self) -> str:
        return data_axis(self)

    @property
    def data_size(self) -> int:
        return self.shape[self.data_axis]

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on each axis (row-major)."""
        out, r = {}, self.rank
        for ax in reversed(self.axis_names):
            out[ax] = r % self.shape[ax]
            r //= self.shape[ax]
        return {ax: out[ax] for ax in self.axis_names}

    @property
    def data_rank(self) -> int:
        """This rank's block of the batch: its data-axis coordinate."""
        return self.coords[self.data_axis]

    @property
    def shard_axes(self) -> Tuple[str, ...]:
        """The model and/or expert axes larger than 1, in ``axis_names``
        order: the dims of :meth:`shard_mesh` (0, 1 or 2 of them)."""
        return tuple(ax for ax in self.axis_names
                     if ax in SHARD_AXES and self.shape[ax] > 1)

    def axis_group(self, name: str, required: bool = False):
        """The process group of the ranks that share this rank's coordinate
        on every axis but ``name`` (an axis larger than 1), ordered by
        their coordinate on it; None without one, or a ValueError when
        ``required``."""
        dims = getattr(self.device_mesh, "mesh_dim_names", None) or ()
        group = self.device_mesh.get_group(name) if name in dims else None
        if group is None and required:
            raise ValueError(f"mesh axis {name!r}={self.shape.get(name, 1)} has no process "
                             "group (a logical mesh plans only)")
        return group

    def shard_mesh(self):
        """The ``DeviceMesh`` of :attr:`shard_axes` this rank lies on: one
        dim or two (None without a group or a shard axis)."""
        axes = self.shard_axes
        if self.device_mesh is None or not axes:
            return None
        return self.device_mesh[axes if len(axes) > 1 else axes[0]]


def _data_axis_name(names: Sequence[str], sizes: Dict[str, int]) -> str:
    """The axis carrying the batch: ``data`` when it has degree > 1, else
    the first other axis of degree > 1 without a known non-data role, else
    ``data``; without a ``data`` axis, the first axis without such a role."""
    if const.MESH_AXIS_DATA not in names:
        for ax in names:
            if ax not in NON_DATA_AXES:
                return ax
        raise ValueError(f"mesh axes {tuple(names)} contain no axis that can carry "
                         f"the batch; include '{const.MESH_AXIS_DATA}' (size 1 for "
                         "pure model parallelism)")
    if sizes[const.MESH_AXIS_DATA] > 1:
        return const.MESH_AXIS_DATA
    for ax in names:
        if ax not in NON_DATA_AXES and sizes[ax] > 1:
            return ax
    return const.MESH_AXIS_DATA


def data_axis(mesh: Mesh) -> str:
    """The batch axis name (the JAX package's ``kernel/mesh.py::data_axis``)."""
    return _data_axis_name(mesh.axis_names, mesh.shape)


def _check_axes(shape: Dict[str, int], batch_axis: str) -> None:
    """Raise for a wide axis other than the batch one and the known roles
    (the port renders any mix of those)."""
    other = {ax: d for ax, d in shape.items()
             if d > 1 and ax != batch_axis and ax not in SHARD_AXES + GROUP_AXES}
    if other:
        raise NotImplementedError(f"mesh axes {other} beside the batch axis "
                                  f"{batch_axis!r} are not ported; see ROADMAP.md")


def build_mesh(resource_spec: Optional[ResourceSpec] = None, device=None,
               group=None, axes: Sequence[str] = AXES) -> Mesh:
    """The logical mesh over ``axes`` of this process: its rank in
    ``group`` (world size 1 without one) and its device, ``cuda:LOCAL_RANK``
    (``device`` default ``"cuda"``) or the CPU. The spec's axis sizes (its
    ``mesh:`` block in any row-major order, the other ``axes`` of size 1)
    must multiply to the world size. With an axis other than the batch one
    larger than 1, the ``DeviceMesh`` of the batch axis and every such axis
    is built over ``group`` (every rank calls this) and the mesh's groups
    are its subgroups (the module docstring)."""
    dev = resolve_device(device)
    world = torch.distributed.get_world_size(group) if group is not None else 1
    rank = torch.distributed.get_rank(group) if group is not None else 0
    if resource_spec is None:
        shape = {ax: 1 for ax in axes}
        shape[tuple(axes)[0]] = world
    else:
        shape = resource_spec.mesh_shape(tuple(axes))
    n = math.prod(shape.values())
    if n != world:
        raise ValueError(f"mesh shape {shape} needs {n} processes but the group has "
                         f"{world} ({dev.type}): resource spec and runtime disagree")
    names = tuple(shape)
    batch_axis = _data_axis_name(names, shape)
    _check_axes(shape, batch_axis)
    device = pg.local_device(dev, rank)
    mesh = Mesh(axis_names=names, shape=dict(shape), rank=rank, device=device,
                group=group, world_group=group)
    dims = tuple(ax for ax in names if ax == batch_axis or shape[ax] > 1)
    wide = [ax for ax in dims if ax != batch_axis]
    if not wide:
        return mesh
    if group is None:
        raise ValueError(f"mesh axes {wide} larger than 1 need a process group")
    from torch.distributed.device_mesh import DeviceMesh

    # Row-major over every axis; the axes of size 1 drop out of the grid.
    grid = torch.arange(world).reshape([shape[ax] for ax in dims])
    dmesh = DeviceMesh(device.type, grid, mesh_dim_names=dims)
    data = dmesh.get_group(batch_axis)
    if any(ax in GROUP_AXES for ax in wide):
        # A first collective with every rank of each group: NCCL's
        # point-to-point batches need one before their first use.
        for g in [data] + [dmesh.get_group(ax) for ax in wide if ax in GROUP_AXES]:
            torch.distributed.all_reduce(torch.zeros(1, device=device), group=g)
    return Mesh(axis_names=names, shape=dict(shape), rank=rank, device=device,
                group=data, device_mesh=dmesh, world_group=group)
