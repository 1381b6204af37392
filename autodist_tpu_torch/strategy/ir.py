"""Strategy IR: the explicit, serializable per-variable parallelization plan.

The port's copy of the JAX package's ``strategy/ir.py`` (itself the original
AutoDist's ``strategy.proto`` / ``synchronizers.proto``): dataclasses with a
JSON round trip, field for field the same, so a strategy serialized by
either package reads in the other. What each field means at lowering time
in this port is in ``kernel/lowering.py`` (compressors, ``shard_update``,
staleness, bucketing, host offload) and ``runtime/async_ps.py``
(``sync=False``, routed there by ``AutoDist.build``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Union

from autodist_tpu_torch import const
from autodist_tpu_torch.utils import logging


# --------------------------------------------------------------------------- #
# Synchronizers
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class PSSynchronizer:
    """Centralized-reduction sync config: the variable's update happens at
    ``reduction_destination`` (a DeviceSpec string, e.g. "10.0.0.1:CPU:0")."""

    reduction_destination: str = ""
    local_replication: bool = False  # keep a device-local cached copy (proxy variable)
    sync: bool = True                # False: asynchronous PS
    staleness: int = 0               # bounded staleness in steps (0 = fully sync)


class AllReduceSpec:
    """Transport hint for the all-reduce. The values are the JAX package's
    (AUTO | ICI | DCN), kept so strategies interchange; the port has one
    device per mesh so far and reads none of them."""

    AUTO = "AUTO"
    ICI = "ICI"
    DCN = "DCN"
    VALID = (AUTO, ICI, DCN)


@dataclass(frozen=True)
class AllReduceSynchronizer:
    """All-reduce sync config: transport hint, gradient compressor,
    collective fusion ``group``, and ``shard_update`` (ZeRO-1 weight-update
    sharding)."""

    spec: str = AllReduceSpec.AUTO
    compressor: str = "NoneCompressor"
    group: int = 0
    shard_update: bool = False

    def __post_init__(self):
        if self.spec not in AllReduceSpec.VALID:
            raise ValueError(f"invalid all-reduce spec {self.spec!r}")
        if not isinstance(self.shard_update, bool):
            raise ValueError(f"shard_update must be a bool, got {self.shard_update!r}")


Synchronizer = Union[PSSynchronizer, AllReduceSynchronizer]

_SYNCHRONIZER_TYPES = {
    "PSSynchronizer": PSSynchronizer,
    "AllReduceSynchronizer": AllReduceSynchronizer,
}


# --------------------------------------------------------------------------- #
# Node / graph config
# --------------------------------------------------------------------------- #
@dataclass
class NodeConfig:
    """Per-variable plan. ``partitioner`` ``"1,4,1"`` shards axis 1 four
    ways; ``part_config`` may carry one NodeConfig per shard."""

    var_name: str
    synchronizer: Synchronizer = field(default_factory=AllReduceSynchronizer)
    partitioner: str = ""
    part_config: List["NodeConfig"] = field(default_factory=list)

    @property
    def partition_axes(self) -> List[int]:
        """Parsed partitioner string, empty if unpartitioned."""
        if not self.partitioner:
            return []
        return [int(x) for x in self.partitioner.split(",")]

    @property
    def active_partition_axis(self) -> Optional[int]:
        """Index of the single sharded axis (grammar: one axis > 1)."""
        active = [i for i, n in enumerate(self.partition_axes) if n > 1]
        if not active:
            return None
        if len(active) > 1:
            raise ValueError(f"partitioner {self.partitioner!r} for {self.var_name!r} "
                             "has more than one active axis")
        return active[0]

    @property
    def num_shards(self) -> int:
        ax = self.active_partition_axis
        return self.partition_axes[ax] if ax is not None else 1

    def validate_against_shape(self, shape) -> None:
        axes = self.partition_axes
        if axes and len(axes) != len(shape):
            raise ValueError(f"partitioner {self.partitioner!r} rank {len(axes)} != "
                             f"var {self.var_name!r} rank {len(shape)}")


def iter_synchronizers(node: NodeConfig):
    """The node's synchronizer, then each shard's: the walk every reader
    of a node's sync settings takes (a shard's settings override the
    node's)."""
    yield node.synchronizer
    for p in node.part_config:
        yield p.synchronizer


@dataclass
class GraphConfig:
    """Graph-wide config: the data-parallel replica set (device strings) and
    the gradient-bucketing target in bytes (0 = off)."""

    replicas: List[str] = field(default_factory=list)
    bucket_bytes: int = 0

    def __post_init__(self):
        if self.bucket_bytes < 0:
            raise ValueError(f"bucket_bytes must be >= 0, got {self.bucket_bytes}")


# --------------------------------------------------------------------------- #
# Strategy
# --------------------------------------------------------------------------- #
def _sync_to_json(s: Synchronizer) -> dict:
    return {"type": type(s).__name__, **dataclasses.asdict(s)}


def _sync_from_json(d: dict) -> Synchronizer:
    d = dict(d)
    cls = _SYNCHRONIZER_TYPES[d.pop("type")]
    return cls(**d)


def _node_to_json(n: NodeConfig) -> dict:
    return {"var_name": n.var_name, "synchronizer": _sync_to_json(n.synchronizer),
            "partitioner": n.partitioner,
            "part_config": [_node_to_json(p) for p in n.part_config]}


def _node_from_json(d: dict) -> NodeConfig:
    return NodeConfig(var_name=d["var_name"],
                      synchronizer=_sync_from_json(d["synchronizer"]),
                      partitioner=d.get("partitioner", ""),
                      part_config=[_node_from_json(p) for p in d.get("part_config", [])])


@dataclass
class Strategy:
    """The serialized artifact shipped chief -> workers. Ids carry a
    timestamp and the resource-spec fingerprint, so a strategy built for one
    cluster is never silently loaded on another."""

    node_config: List[NodeConfig] = field(default_factory=list)
    graph_config: GraphConfig = field(default_factory=GraphConfig)
    id: str = ""
    path: str = ""

    @classmethod
    def new_id(cls, fingerprint: str = "") -> str:
        ts = time.strftime("%Y%m%dT%H%M%S")
        suffix = f"-{fingerprint}" if fingerprint else ""
        return f"{ts}{suffix}-{os.getpid()}"

    def to_json(self) -> dict:
        return {
            "id": self.id,
            "path": self.path,
            "node_config": [_node_to_json(n) for n in self.node_config],
            "graph_config": {"replicas": list(self.graph_config.replicas),
                             "bucket_bytes": int(self.graph_config.bucket_bytes)},
        }

    @classmethod
    def from_json(cls, d: dict) -> "Strategy":
        gc = d.get("graph_config", {})
        return cls(id=d.get("id", ""), path=d.get("path", ""),
                   node_config=[_node_from_json(n) for n in d.get("node_config", [])],
                   graph_config=GraphConfig(replicas=list(gc.get("replicas", [])),
                                            bucket_bytes=int(gc.get("bucket_bytes", 0))))

    def serialize(self, path: Optional[str] = None) -> str:
        """Write to ``<strategy_dir>/<id>``."""
        if not self.id:
            self.id = self.new_id()
        if path is None:
            os.makedirs(const.DEFAULT_STRATEGY_DIR, exist_ok=True)
            path = os.path.join(const.DEFAULT_STRATEGY_DIR, self.id)
        self.path = path
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
        logging.debug("serialized strategy %s -> %s", self.id, path)
        return path

    @classmethod
    def deserialize(cls, strategy_id: Optional[str] = None,
                    path: Optional[str] = None) -> "Strategy":
        """Load by id from the strategy dir, or from an explicit path."""
        if path is None:
            if not strategy_id:
                raise ValueError("need strategy_id or path")
            path = os.path.join(const.DEFAULT_STRATEGY_DIR, strategy_id)
        with open(path, "r", encoding="utf-8") as f:
            s = cls.from_json(json.load(f))
        s.path = path
        return s
