"""Device mesh from a ResourceSpec (PyTorch port of ``kernel/mesh.py``).

One process per device: a :class:`Mesh` is the logical axis sizes plus this
process's rank, its device and the ``torch.distributed`` group the data
axis spans (``None`` in a single process). The spec's GPU count must equal
the group's world size, or :func:`build_mesh` raises. Planning reads only
the axis sizes, so :meth:`Mesh.logical` gives a mesh of any size without a
group, for plans and their tests. An axis other than ``data`` larger than
1 (``model``, ``expert``) raises ``NotImplementedError``: tensor and expert
parallelism are not ported yet (ROADMAP.md).
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
NON_DATA_AXES = (const.MESH_AXIS_MODEL, "seq", const.MESH_AXIS_EXPERT, "pipe")


@dataclass(frozen=True)
class Mesh:
    """Named logical axes (row-major over ``axis_names``), this process's
    rank and device, and the group of the data axis."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Any = field(default=None, compare=False)

    @classmethod
    def logical(cls, shape: Dict[str, int], device="cpu") -> "Mesh":
        """A mesh of ``shape`` with no group: enough to plan on."""
        shape = {**{ax: 1 for ax in AXES}, **dict(shape)}
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


def build_mesh(resource_spec: Optional[ResourceSpec] = None, device=None,
               group=None) -> Mesh:
    """The logical ("data", "model") mesh of this process: its rank in
    ``group`` (world size 1 without one) and its device, ``cuda:LOCAL_RANK``
    (``device`` default ``"cuda"``) or the CPU. The spec's axis sizes must
    multiply to the world size."""
    dev = resolve_device(device)
    world = torch.distributed.get_world_size(group) if group is not None else 1
    rank = torch.distributed.get_rank(group) if group is not None else 0
    if resource_spec is None:
        shape = {ax: 1 for ax in AXES}
        shape[AXES[0]] = world
    else:
        shape = resource_spec.mesh_shape(AXES)
    n = math.prod(shape.values())
    if n != world:
        raise ValueError(f"mesh shape {shape} needs {n} processes but the group has "
                         f"{world} ({dev.type}): resource spec and runtime disagree")
    mesh = Mesh(axis_names=tuple(shape), shape=dict(shape), rank=rank,
                device=pg.local_device(dev, rank), group=group)
    wide = {ax: d for ax, d in shape.items() if ax != mesh.data_axis and d > 1}
    if wide:
        raise NotImplementedError(f"mesh axes {wide} (tensor/expert parallelism) are "
                                  "not ported yet; see ROADMAP.md")
    return mesh
