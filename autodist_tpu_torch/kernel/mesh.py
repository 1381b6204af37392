"""Device mesh from a ResourceSpec (PyTorch port of ``kernel/mesh.py``).

This slice runs in one process, so the mesh is a plain object: the local
devices, the axis names and their sizes. The spec's device count must match
what this process sees. A ``torch.distributed`` DeviceMesh comes with the
multi-device runtime slice (ROADMAP.md).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.utils.device import resolve_device

AXES = (const.MESH_AXIS_DATA, const.MESH_AXIS_MODEL)


@dataclass(frozen=True)
class Mesh:
    """Devices laid out over named axes (row-major over ``axis_names``)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]

    @property
    def size(self) -> int:
        return len(self.devices)


def build_mesh(resource_spec: Optional[ResourceSpec] = None, device=None) -> Mesh:
    """The logical ("data", "model") mesh over this process's devices: every
    CUDA device (``device`` default ``"cuda"``), or the one CPU for
    ``"cpu"``. The spec puts all its GPUs on "data"; that count must equal
    the devices seen."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devices = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    else:
        devices = (dev,)
    if resource_spec is None:
        shape = {ax: 1 for ax in AXES}
        shape[AXES[0]] = len(devices)
    else:
        shape = resource_spec.mesh_shape(AXES)
    n = math.prod(shape.values())
    if n != len(devices):
        raise ValueError(f"mesh shape {shape} needs {n} devices but this process "
                         f"sees {len(devices)} ({dev.type}): resource spec and "
                         "runtime disagree")
    return Mesh(devices=devices, axis_names=tuple(shape), shape=dict(shape))
