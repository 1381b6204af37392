"""Resource model: describe a GPU cluster (PyTorch port).

The port's copy of the JAX package's ``resource_spec.py``, with GPUs where
it has TPU chips. The file shape is the same (and the original AutoDist's)::

    nodes:
      - address: 10.0.0.1
        gpus: 4          # "chips" accepted, for specs written for the JAX package
        chief: true
      - address: 10.0.0.2
        gpus: 4

Devices read ``<address>:GPU:<i>`` (and ``<address>:CPU:0`` for a host), as
in the original AutoDist, numbered chief first, then by address: rank ``r``
of a ``torch.distributed`` group is the ``r``-th of :attr:`gpu_devices`.
An optional ``mesh:`` block names the logical axis sizes (``{data: 4}``);
it must cover every GPU, and an axis other than ``data`` larger than 1
raises at mesh build (the TensorParallel slice, ROADMAP.md). The JAX
package's TPU topology and HBM tables and its per-node ``cpus``/``ssh``
entries are not ported; the cost model that reads them is in ROADMAP.md.
"""
from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass
from enum import Enum
from typing import Dict, List, Optional, Sequence

from autodist_tpu_torch.utils.device import resolve_device

_LOOPBACK_ADDRESSES = ("localhost", "127.0.0.1", "0.0.0.0", "::1")
DEFAULT_GPUS_PER_HOST = 4


class DeviceType(Enum):
    """Device kinds (the original AutoDist's DeviceType{CPU,GPU})."""

    CPU = "CPU"
    GPU = "GPU"


@dataclass(frozen=True)
class DeviceSpec:
    """One addressable device: ``<host-address>:<type>:<index>``."""

    host_address: str
    device_type: DeviceType = DeviceType.GPU
    device_index: int = 0

    def name_string(self) -> str:
        return f"{self.host_address}:{self.device_type.value}:{self.device_index}"


@dataclass
class NodeSpec:
    """One host in the cluster (a ``nodes:`` entry)."""

    address: str
    gpus: int = DEFAULT_GPUS_PER_HOST
    chief: bool = False


class ResourceSpec:
    """Parsed cluster description + derived logical mesh shape. Construct
    from a YAML file, a dict, or the local runtime
    (:meth:`from_local_devices`)."""

    def __init__(self, resource_file: Optional[str] = None,
                 resource_dict: Optional[dict] = None):
        if resource_file is not None and resource_dict is not None:
            raise ValueError("pass either resource_file or resource_dict, not both")
        if resource_file is not None:
            import yaml  # only a spec file needs it

            with open(resource_file, "r", encoding="utf-8") as f:
                resource_dict = yaml.safe_load(f) or {}
            if not isinstance(resource_dict, dict):
                raise ValueError(f"resource spec {resource_file!r} must be a YAML "
                                 f"mapping, got {type(resource_dict).__name__}")
        self._nodes: List[NodeSpec] = []
        for entry in (resource_dict or {}).get("nodes", []) or []:
            gpus = entry.get("gpus", entry.get("chips", DEFAULT_GPUS_PER_HOST))
            self._nodes.append(NodeSpec(address=str(entry["address"]), gpus=int(gpus),
                                        chief=bool(entry.get("chief", False))))
        if not self._nodes:
            self._nodes.append(NodeSpec(address="localhost", chief=True))
        mesh = (resource_dict or {}).get("mesh")
        self._mesh_override: Optional[Dict[str, int]] = (
            {str(k): int(v) for k, v in mesh.items()} if mesh else None)
        # If no node is marked chief, the first is.
        if not any(n.chief for n in self._nodes):
            self._nodes[0].chief = True
        self._validate()

    def _validate(self) -> None:
        chiefs = [n for n in self._nodes if n.chief]
        if len(chiefs) != 1:
            raise ValueError(f"exactly one chief required, got {len(chiefs)}")
        addrs = [n.address for n in self._nodes]
        if len(set(addrs)) != len(addrs):
            raise ValueError(f"duplicate node addresses in resource spec: {addrs}")
        if len(self._nodes) > 1 and any(a in _LOOPBACK_ADDRESSES for a in addrs):
            raise ValueError("multi-node resource specs cannot contain loopback addresses")
        if any(n.gpus < 0 for n in self._nodes):
            raise ValueError("gpus must be >= 0")
        if self._mesh_override and \
                math.prod(self._mesh_override.values()) != max(self.num_gpus, 1):
            raise ValueError(f"mesh override {self._mesh_override} does not cover "
                             f"{self.num_gpus} gpus")

    # ------------------------------------------------------------- properties
    @property
    def nodes(self) -> List[NodeSpec]:
        return list(self._nodes)

    @property
    def num_gpus(self) -> int:
        return sum(n.gpus for n in self._nodes)

    def _ordered_nodes(self) -> List[NodeSpec]:
        # Chief first, then by address: every process agrees on numbering.
        return sorted(self._nodes, key=lambda n: (not n.chief, n.address))

    @property
    def gpu_devices(self) -> List[DeviceSpec]:
        """All GPUs as DeviceSpecs, chief-first then sorted by address."""
        return [DeviceSpec(n.address, DeviceType.GPU, i)
                for n in self._ordered_nodes() for i in range(n.gpus)]

    @property
    def cpu_devices(self) -> List[DeviceSpec]:
        """Host CPU devices (PS reduction destinations), one per node."""
        return [DeviceSpec(n.address, DeviceType.CPU, 0) for n in self._ordered_nodes()]

    def mesh_shape(self, axes: Sequence[str] = ("data",)) -> Dict[str, int]:
        """A logical mesh shape covering every GPU: the ``mesh:`` override
        (the other requested axes of size 1), else all on the first axis
        (data parallelism), the others of size 1."""
        if self._mesh_override:
            shape = dict(self._mesh_override)
            for ax in axes:
                shape.setdefault(ax, 1)
            return shape
        shape = {ax: 1 for ax in axes}
        shape[axes[0] if axes else "data"] = max(self.num_gpus, 1)
        return shape

    # ------------------------------------------------------- constructors/io
    @classmethod
    def from_local_devices(cls, device=None, world_size: int = 1) -> "ResourceSpec":
        """This host as a one-node spec of ``world_size`` device slots, one
        per rank of the process group (``device`` default ``"cuda"``; raises
        without CUDA). On the CPU a single process has no GPU at all, so the
        host CPU is the one replica; ``world_size > 1`` CPU ranks each stand
        for one slot."""
        dev = resolve_device(device)
        gpus = world_size if dev.type == "cuda" or world_size > 1 else 0
        return cls(resource_dict={"nodes": [{"address": "localhost", "gpus": gpus,
                                             "chief": True}]})

    def to_dict(self) -> dict:
        d = {"nodes": [{"address": n.address, "gpus": n.gpus, "chief": n.chief}
                       for n in self._nodes]}
        if self._mesh_override:
            d["mesh"] = dict(self._mesh_override)
        return d

    def fingerprint(self) -> str:
        """Stable hash of the spec, part of strategy ids so a strategy built
        for one cluster is never silently reused on another."""
        blob = json.dumps(self.to_dict(), sort_keys=True).encode()
        return hashlib.md5(blob).hexdigest()[:8]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"ResourceSpec(nodes={len(self._nodes)}, gpus={self.num_gpus})"
