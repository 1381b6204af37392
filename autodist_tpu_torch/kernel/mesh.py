"""Device mesh from a ResourceSpec (PyTorch port of ``kernel/mesh.py``).

One process per device: a :class:`Mesh` is the logical axis sizes
(row-major over ``axis_names``: rank ``r``'s coordinates are ``r``'s digits
in the axis sizes), this process's rank, its device and the
``torch.distributed`` groups it trains over. The spec's GPU count must
equal the group's world size, or :func:`build_mesh` raises. Planning reads
only the axis sizes, so :meth:`Mesh.logical` gives a mesh of any size
without a group, for plans and their tests.

Besides the batch (``data``) axis, one of ``model`` (tensor parallelism)
or ``expert`` (expert parallelism) may be larger than 1. Such a mesh
carries a ``torch.distributed`` ``DeviceMesh`` of two dims, the data axis
and that axis (``device_mesh``), whose data-dim subgroup is ``group``: the
ranks that share this rank's model (or expert) coordinate, over which the
gradients are synced. The batch is sharded over the data axis only, as the
JAX package's ``data_sharding`` does: the ranks of one model group see the
same rows.

Instead, one of ``seq`` (ring / Ulysses attention, ``parallel/``) or
``pipe`` (pipeline stages) may be larger than 1 beside the data axis.
:func:`build_mesh` then forms two subgroups of the world group: that axis's
group (:meth:`Mesh.axis_group`: the ranks sharing this rank's data
coordinate) and the data group (``group``: the ranks sharing this rank's
seq or pipe coordinate), so the gradient sync and ``data_rank`` keep their
meaning. A seq or pipe axis beside a wide model or expert axis, ``seq``
with ``pipe``, and a mesh with both ``model`` and ``expert`` larger than 1
raise ``NotImplementedError`` (ROADMAP.md).
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
    rank and device, the group of the data axis and, with a model or
    expert axis, the ``DeviceMesh`` over (data axis, that axis); with a
    seq or pipe axis, that axis's group (``axis_groups``)."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Any = field(default=None, compare=False)
    device_mesh: Any = field(default=None, compare=False)
    world_group: Any = field(default=None, compare=False)
    axis_groups: Dict[str, Any] = field(default_factory=dict, compare=False)

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
    def shard_axis(self) -> Optional[str]:
        """The model or expert axis when it is larger than 1, else None."""
        wide = [ax for ax in SHARD_AXES if self.shape.get(ax, 1) > 1]
        return wide[0] if wide else None

    @property
    def group_axis(self) -> Optional[str]:
        """The seq or pipe axis when it is larger than 1, else None."""
        wide = [ax for ax in GROUP_AXES if self.shape.get(ax, 1) > 1]
        return wide[0] if wide else None

    def axis_group(self, name: str, required: bool = False):
        """The process group of the ranks that share this rank's coordinate
        on every axis but ``name`` (a seq or pipe axis larger than 1),
        ordered by their coordinate on it; None without one, or a
        ValueError when ``required``."""
        group = self.axis_groups.get(name)
        if group is None and required:
            raise ValueError(f"mesh axis {name!r}={self.shape.get(name, 1)} has no process "
                             "group (a logical mesh plans only)")
        return group

    def shard_mesh(self):
        """The one-dim ``DeviceMesh`` of :attr:`shard_axis` this rank lies
        on (None without one)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh[self.shard_axis]


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
    """Raise for the axes the port does not render: a wide axis other than
    the batch one and the known roles, ``model`` and ``expert`` both wide,
    or a wide ``seq`` or ``pipe`` axis beside another wide non-data axis."""
    other = {ax: d for ax, d in shape.items()
             if d > 1 and ax != batch_axis and ax not in SHARD_AXES + GROUP_AXES}
    if other:
        raise NotImplementedError(f"mesh axes {other} beside the batch axis "
                                  f"{batch_axis!r} are not ported; see ROADMAP.md")
    wide = [ax for ax in SHARD_AXES if shape.get(ax, 1) > 1]
    if len(wide) > 1:
        raise NotImplementedError(f"a mesh with both {wide} larger than 1 is not "
                                  "ported yet; see ROADMAP.md")
    grouped = [ax for ax in GROUP_AXES if shape.get(ax, 1) > 1]
    if grouped and len(wide + grouped) > 1:
        raise NotImplementedError(f"a mesh with {wide + grouped} larger than 1 together "
                                  "is not ported yet; see ROADMAP.md (Queue 1 item 5)")


def build_mesh(resource_spec: Optional[ResourceSpec] = None, device=None,
               group=None, axes: Sequence[str] = AXES) -> Mesh:
    """The logical mesh over ``axes`` of this process: its rank in
    ``group`` (world size 1 without one) and its device, ``cuda:LOCAL_RANK``
    (``device`` default ``"cuda"``) or the CPU. The spec's axis sizes (its
    ``mesh:`` block in any row-major order, the other ``axes`` of size 1)
    must multiply to the world size. With a model or expert axis larger
    than 1 the ``DeviceMesh`` of the data axis and that axis is built over
    ``group`` (every rank calls this) and the data group is its subgroup;
    with a seq or pipe axis larger than 1, that axis's group and the data
    group are subgroups of ``group``."""
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
    if mesh.group_axis is not None:
        return _with_axis_groups(mesh, batch_axis)
    wide = mesh.shard_axis
    if wide is None:
        return mesh
    if group is None:
        raise ValueError(f"mesh axis {wide}={shape[wide]} needs a process group")
    from torch.distributed.device_mesh import DeviceMesh

    grid = torch.arange(world).reshape([shape[ax] for ax in names])
    grid = grid.permute(names.index(batch_axis), names.index(wide),
                        *[i for i, ax in enumerate(names) if ax not in (batch_axis, wide)])
    grid = grid.reshape(shape[batch_axis], shape[wide])
    dmesh = DeviceMesh(device.type, grid, mesh_dim_names=(batch_axis, wide))
    return Mesh(axis_names=names, shape=dict(shape), rank=rank, device=device,
                group=dmesh.get_group(batch_axis), device_mesh=dmesh, world_group=group)


def _with_axis_groups(mesh: Mesh, batch_axis: str) -> Mesh:
    """``mesh`` with its seq or pipe axis's group and, as ``group``, the
    data group: two enumerations of subgroups of the world group (every
    rank forms every subgroup, in the same order)."""
    axis = mesh.group_axis
    if mesh.world_group is None:
        raise ValueError(f"mesh axis {axis}={mesh.shape[axis]} needs a process group")
    names = mesh.axis_names
    grid = torch.arange(mesh.size).reshape([mesh.shape[ax] for ax in names])

    def along(ax: str):
        # One list per coordinate of the other axes: the ranks along ``ax``.
        lines = grid.movedim(names.index(ax), -1).reshape(-1, mesh.shape[ax])
        return [line.tolist() for line in lines]

    own, _ = torch.distributed.new_subgroups_by_enumeration(along(axis))
    data, _ = torch.distributed.new_subgroups_by_enumeration(along(batch_axis))
    for g in (own, data):
        # A first collective with every rank of the group: NCCL's
        # point-to-point batches need one before their first use.
        torch.distributed.all_reduce(torch.zeros(1, device=mesh.device), group=g)
    return Mesh(axis_names=names, shape=dict(mesh.shape), rank=mesh.rank,
                device=mesh.device, group=data, world_group=mesh.world_group,
                axis_groups={axis: own})
