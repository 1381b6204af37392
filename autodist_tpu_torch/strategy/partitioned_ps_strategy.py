"""Partitioned PS: shard each variable along axis 0 across destinations
(PyTorch port of ``strategy/partitioned_ps_strategy.py``)."""
from math import ceil
from typing import Dict

from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.model_item import ModelItem, VarItem
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import (
    StrategyBuilder, byte_size_load_fn, min_divisor_shards, part_name, reduction_devices)
from autodist_tpu_torch.strategy.ir import NodeConfig, PSSynchronizer, Strategy


class PartitionedPS(StrategyBuilder):
    """Shard count = smallest divisor above 1 of dim 0; shards placed on the
    least-loaded destinations, round-robin when they outnumber them. With
    one reduction destination nothing is partitioned, unless
    ``AUTODIST_IS_TESTING`` is set."""

    def __init__(self, local_proxy_variable: bool = False, sync: bool = True,
                 staleness: int = 0):
        self._local_proxy_variable = local_proxy_variable
        self._sync = sync
        self._staleness = staleness
        self.loads: Dict[str, float] = {}

    def build(self, model_item: ModelItem, resource_spec: ResourceSpec) -> Strategy:
        expr = self._new_strategy(resource_spec)
        self.loads = {ps: 0.0 for ps in reduction_devices(resource_spec)}
        expr.node_config = [self._gen_node_config(v) for v in model_item.trainable_variables]
        return expr

    def get_num_shards(self, var: VarItem) -> int:
        if not var.shape:
            return 1
        return min_divisor_shards(var.shape[0])

    def _gen_node_config(self, var: VarItem) -> NodeConfig:
        if len(self.loads) <= 1 and not ENV.AUTODIST_IS_TESTING.val:
            num_shards = 1
        else:
            num_shards = self.get_num_shards(var)
        sorted_ps = sorted(self.loads, key=self.loads.get)
        if num_shards > len(self.loads):
            sorted_ps = sorted_ps * ceil(num_shards / len(self.loads))
        min_ps = sorted_ps[:num_shards]
        for ps in min_ps:
            self.loads[ps] += byte_size_load_fn(var) / num_shards

        def sync(dest: str) -> PSSynchronizer:
            return PSSynchronizer(reduction_destination=dest,
                                  local_replication=self._local_proxy_variable,
                                  sync=self._sync, staleness=self._staleness)

        node = NodeConfig(var_name=var.name, synchronizer=sync(min_ps[0]))
        if num_shards > 1:
            partition_list = [1] * len(var.shape)
            partition_list[0] = min(num_shards, var.shape[0])
            node.partitioner = ",".join(map(str, partition_list))
            node.part_config = [NodeConfig(var_name=part_name(var.name, i),
                                           synchronizer=sync(min_ps[i]))
                                for i in range(num_shards)]
        return node
