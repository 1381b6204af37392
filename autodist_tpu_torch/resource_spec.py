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
An optional ``mesh:`` block names the logical axis sizes (``{data: 4,
model: 2}``); it must cover every GPU.

Where the JAX package describes a TPU slice (``TPUTopology``: ICI and DCN
bandwidths, an HBM table by TPU generation), the port describes a GPU node
(:class:`GPUNode`), which the strategy cost model reads: the intra-node
group's bandwidth (NVLink, or PCIe on a node without it), the inter-node
network per GPU, HBM capacity and bandwidth, and the host's latency a
collective call over an intra- or an inter-node group. An optional
``gpu:`` block overrides any field::

    gpu:
      device: NVIDIA H100 80GB HBM3   # torch.cuda.get_device_name
      nvlink_gbps: 3600               # 0: no NVLink, the node's GPUs talk over PCIe
      pcie_gbps: 512
      network_gbps: 400               # also read from ``network_bandwidth``
      hbm_gb: 85.9                    # GB of 1e9 bytes (80 GiB)
      hbm_gb_per_s: 3350
      intra_latency_us: 128
      inter_latency_us: 128

Bandwidths on the wire are Gbit/s in one direction, HBM GB (1e9 bytes)
and GB/s. The
JAX package's per-node ``cpus``/``ssh`` entries are not ported.
"""
from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass, fields
from enum import Enum
from typing import Dict, List, Optional, Sequence, Tuple

from autodist_tpu_torch.utils.device import resolve_device

_LOOPBACK_ADDRESSES = ("localhost", "127.0.0.1", "0.0.0.0", "::1")
DEFAULT_GPUS_PER_HOST = 4

# Spec-sheet figures of the H100 SXM node the port targets, in Gbit/s one
# way. NVIDIA H100 Tensor Core GPU datasheet: NVLink 900 GB/s (18 NVLink 4
# links, both directions together), so 450 GB/s each way; PCIe Gen5 x16
# 128 GB/s both ways, 64 GB/s each way. DGX H100 datasheet: one 400 Gb/s
# ConnectX-7 (NDR InfiniBand) port per GPU.
DEFAULT_NVLINK_GBPS = 450.0 * 8
DEFAULT_PCIE_GBPS = 64.0 * 8
DEFAULT_NETWORK_GBPS = 400.0
# The host's time a collective call (µs): about 128 µs a NCCL call on one
# H100 (tools/torch_dist_profile.py, ResNet-50 under Zero1: 268 calls a step
# added 34.45 ms). Across nodes it is not measured yet: the same figure.
DEFAULT_INTRA_LATENCY_US = 128.0
DEFAULT_INTER_LATENCY_US = 128.0

# HBM capacity (GB of 1e9 bytes) and bandwidth (GB/s) by substring of
# torch.cuda.get_device_name(), from NVIDIA's datasheets (H100: SXM 80 GB
# HBM3 at 3.35 TB/s, PCIe 80 GB HBM2e at 2.0 TB/s, NVL 94 GB at 3.9 TB/s;
# H200 141 GB at 4.8 TB/s; A100 SXM4 80 GB at 2,039 GB/s, 40 GB at 1,555
# GB/s, PCIe 80 GB at 1,935 GB/s, 40 GB at 1,555 GB/s; L40S 48 GB at 864
# GB/s; L4 24 GB at 300 GB/s). A datasheet's capacity is binary (an
# "80 GB" H100 holds 80 GiB; torch.cuda.get_device_properties reads 85.0e9
# bytes of it), so each is scaled by GIB into the decimal GB that hbm_gb
# and the cost model use. Looked up longest key first, case-insensitively.
GIB = 2 ** 30 / 1e9
HBM_BY_DEVICE = {
    "H100 80GB HBM3": (80.0 * GIB, 3350.0),
    "H100 PCIe": (80.0 * GIB, 2000.0),
    "H100 NVL": (94.0 * GIB, 3900.0),
    "H200": (141.0 * GIB, 4800.0),
    "A100-SXM4-80GB": (80.0 * GIB, 2039.0),
    "A100-SXM4-40GB": (40.0 * GIB, 1555.0),
    "A100 80GB PCIe": (80.0 * GIB, 1935.0),
    "A100-PCIE-40GB": (40.0 * GIB, 1555.0),
    "L40S": (48.0 * GIB, 864.0),
    "L4": (24.0 * GIB, 300.0),
}
# An unknown or unnamed card is taken to be the smallest entry, so the cost
# model's memory check stays conservative (as the JAX package's is).
DEFAULT_HBM = min(HBM_BY_DEVICE.values())


def hbm_spec_for_name(name: Optional[str]) -> Tuple[float, float]:
    """(HBM GB, HBM GB/s) of a ``torch.cuda.get_device_name()`` string:
    the longest :data:`HBM_BY_DEVICE` key it contains, else
    :data:`DEFAULT_HBM`."""
    name = (name or "").lower()
    for key in sorted(HBM_BY_DEVICE, key=len, reverse=True):
        if key.lower() in name:
            return HBM_BY_DEVICE[key]
    return DEFAULT_HBM


@dataclass
class GPUNode:
    """One node's hardware, the figures the cost model plans with: the
    intra-node group's bandwidth (NVLink, or PCIe when ``nvlink_gbps`` is
    0), the inter-node network per GPU, HBM (``None``: from
    :data:`HBM_BY_DEVICE` by ``device``) and the host's latency a
    collective call."""

    device: Optional[str] = None
    nvlink_gbps: float = DEFAULT_NVLINK_GBPS
    pcie_gbps: float = DEFAULT_PCIE_GBPS
    network_gbps: float = DEFAULT_NETWORK_GBPS
    hbm_gb: Optional[float] = None
    hbm_gb_per_s: Optional[float] = None
    intra_latency_us: float = DEFAULT_INTRA_LATENCY_US
    inter_latency_us: float = DEFAULT_INTER_LATENCY_US

    @classmethod
    def from_dict(cls, d: dict, network_bandwidth=None) -> "GPUNode":
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown gpu: keys {unknown}; known: {sorted(known)}")
        kw = {k: (str(v) if k == "device" else float(v))
              for k, v in d.items() if v is not None}
        if "network_gbps" not in kw and network_bandwidth is not None:
            kw["network_gbps"] = float(network_bandwidth)
        return cls(**kw)

    def to_dict(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)
                if getattr(self, f.name) is not None}

    @property
    def intra_node_gbps(self) -> float:
        """The intra-node group's bandwidth: NVLink, else PCIe."""
        return self.nvlink_gbps if self.nvlink_gbps > 0 else self.pcie_gbps

    @property
    def hbm_bytes(self) -> float:
        gb = self.hbm_gb if self.hbm_gb is not None else hbm_spec_for_name(self.device)[0]
        return gb * 1e9

    @property
    def hbm_bandwidth_bytes(self) -> float:
        gbs = (self.hbm_gb_per_s if self.hbm_gb_per_s is not None
               else hbm_spec_for_name(self.device)[1])
        return gbs * 1e9


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
        self._gpu = GPUNode.from_dict((resource_dict or {}).get("gpu") or {},
                                      (resource_dict or {}).get("network_bandwidth"))
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

    @property
    def num_nodes(self) -> int:
        return len(self._nodes)

    @property
    def gpu(self) -> GPUNode:
        """The node model (every node alike)."""
        return self._gpu

    @property
    def network_bandwidth(self) -> float:
        """Inter-node bandwidth a GPU, Gbit/s (the reference's per-node
        ``network_bandwidth``; the JAX package's DCN figure)."""
        return self._gpu.network_gbps

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
        without CUDA). On CUDA the card's name and memory come from
        ``torch.cuda.get_device_properties`` (``gpu: device, hbm_gb``). On
        the CPU a single process has no GPU at all, so the host CPU is the
        one replica; ``world_size > 1`` CPU ranks each stand for one
        slot."""
        dev = resolve_device(device)
        gpus = world_size if dev.type == "cuda" or world_size > 1 else 0
        d = {"nodes": [{"address": "localhost", "gpus": gpus, "chief": True}]}
        if dev.type == "cuda":
            import torch

            props = torch.cuda.get_device_properties(dev)
            d["gpu"] = {"device": props.name, "hbm_gb": props.total_memory / 1e9}
        return cls(resource_dict=d)

    def to_dict(self) -> dict:
        d = {"nodes": [{"address": n.address, "gpus": n.gpus, "chief": n.chief}
                       for n in self._nodes],
             "gpu": self._gpu.to_dict()}
        if self._mesh_override:
            d["mesh"] = dict(self._mesh_override)
        return d

    def fingerprint(self) -> str:
        """Stable hash of the spec, part of strategy ids so a strategy built
        for one cluster is never silently reused on another."""
        blob = json.dumps(self.to_dict(), sort_keys=True).encode()
        return hashlib.md5(blob).hexdigest()[:8]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ResourceSpec(nodes={len(self._nodes)}, gpus={self.num_gpus}, "
                f"device={self._gpu.device})")
