"""Strategy builder interface + compiler (PyTorch port of ``strategy/base.py``).

A ``StrategyBuilder`` maps (ModelItem x ResourceSpec) -> ``Strategy``; the
``StrategyCompiler`` prunes node configs of non-trainable variables and
validates the rest against the model.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List

from autodist_tpu_torch.model_item import ModelItem, VarItem
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.ir import NodeConfig, Strategy
from autodist_tpu_torch.utils import logging


def byte_size_load_fn(var: VarItem) -> float:
    """Byte-size load metric of PS load balancing."""
    return float(var.byte_size)


def check_sync_supported(sync: bool) -> None:
    """Reject asynchronous PS (``sync=False``) in the lowering: one train
    step, which every rank runs in lockstep, has no rendering of a worker
    that does not wait. ``AutoDist.build`` routes uniformly ``sync=False``
    strategies to the host-driven ``runtime.async_ps.AsyncPSTrainer``
    instead; ``sync=True, staleness=K`` is the deterministic bounded
    staleness inside the step. The builders accept both, as the JAX
    package's do."""
    if not sync:
        raise NotImplementedError(
            "sync=False (asynchronous PS) has no rendering in the train step: its "
            "ranks run in lockstep. Build through AutoDist.build, which routes "
            "async strategies to the host-driven AsyncPSTrainer "
            "(autodist_tpu_torch.runtime.async_ps) — or use sync=True with "
            "staleness=K for deterministic bounded staleness inside the step.")


def min_divisor_shards(n: int) -> int:
    """Smallest divisor of ``n`` above 1 (``n`` itself when prime; 1 below
    2): the original AutoDist's ``get_num_shards``."""
    if n < 2:
        return 1
    for i in range(2, n):
        if n % i == 0:
            return i
    return n


def min_non_divisor_shards(n: int) -> int:
    """Smallest integer of at least 2 that does not divide ``n`` (1 below
    2): the uneven-split policy (3 for ``n == 2``, as the JAX package)."""
    if n < 2:
        return 1
    for i in range(2, n + 2):
        if n % i > 0:
            return i
    return n  # pragma: no cover - n + 1 never divides n


def part_name(var_name: str, i: int) -> str:
    """Name of shard ``i`` of a partitioned variable."""
    return f"{var_name}/part_{i}"


def replica_devices(resource_spec: ResourceSpec) -> List[str]:
    """The data-parallel replica set: every GPU, plus the host CPU of any
    GPU-less node."""
    out = [d.name_string() for d in resource_spec.gpu_devices]
    gpuless = {n.address for n in resource_spec.nodes if n.gpus == 0}
    out.extend(d.name_string() for d in resource_spec.cpu_devices
               if d.host_address in gpuless)
    return out


def reduction_devices(resource_spec: ResourceSpec) -> List[str]:
    """PS reduction destinations: one host CPU per node."""
    return [d.name_string() for d in resource_spec.cpu_devices]


class StrategyBuilder(ABC):
    """Analyze model + resources, emit a Strategy."""

    @abstractmethod
    def build(self, model_item: ModelItem, resource_spec: ResourceSpec) -> Strategy:
        """Generate the strategy."""
        raise NotImplementedError

    def _new_strategy(self, resource_spec: ResourceSpec) -> Strategy:
        s = Strategy(id=Strategy.new_id(resource_spec.fingerprint()))
        s.graph_config.replicas = replica_devices(resource_spec)
        return s


class StrategyCompiler:
    """Prune + validate a strategy against the model."""

    def __init__(self, model_item: ModelItem):
        self._model_item = model_item

    def compile(self, strategy: Strategy) -> Strategy:
        trainable = {v.name for v in self._model_item.trainable_variables}
        kept: List[NodeConfig] = []
        for node in strategy.node_config:
            if node.var_name not in trainable:
                logging.debug("pruning node config for non-trainable %r", node.var_name)
                continue
            node.validate_against_shape(self._model_item.var(node.var_name).shape)
            if node.partitioner and node.part_config and \
                    len(node.part_config) != node.num_shards:
                raise ValueError(f"{node.var_name!r}: {len(node.part_config)} part "
                                 f"configs but partitioner {node.partitioner!r} "
                                 f"implies {node.num_shards}")
            kept.append(node)
        missing = trainable - {n.var_name for n in kept}
        if missing:
            raise ValueError(f"strategy has no node config for trainable vars: "
                             f"{sorted(missing)}")
        strategy.node_config = kept
        return strategy
