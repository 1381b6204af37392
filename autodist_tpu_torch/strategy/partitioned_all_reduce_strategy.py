"""Partitioned AllReduce: shard along axis 0 (smallest divisor), all-reduce
each shard, group ids advancing per shard (PyTorch port of
``strategy/partitioned_all_reduce_strategy.py``)."""
from autodist_tpu_torch.model_item import ModelItem, VarItem
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import StrategyBuilder, min_divisor_shards, part_name
from autodist_tpu_torch.strategy.ir import AllReduceSynchronizer, NodeConfig, Strategy


class PartitionedAR(StrategyBuilder):
    """Partition axis 0, then all-reduce each shard in its own group."""

    def __init__(self, chunk_size: int = 128):
        if chunk_size < 1:
            raise ValueError("The chunk_size must be greater than zero.")
        self.chunk_size = chunk_size

    def build(self, model_item: ModelItem, resource_spec: ResourceSpec) -> Strategy:
        expr = self._new_strategy(resource_spec)
        var_counter = 0
        for var in model_item.trainable_variables:
            node, num_shards = self._gen_node_config(var, var_counter)
            var_counter += num_shards
            expr.node_config.append(node)
        return expr

    @staticmethod
    def get_num_shards(var: VarItem) -> int:
        if not var.shape:
            return 1
        return min_divisor_shards(var.shape[0])

    def _gen_node_config(self, var: VarItem, var_counter: int):
        num_shards = self.get_num_shards(var)
        group = var_counter // self.chunk_size
        if num_shards <= 1:
            return NodeConfig(var_name=var.name,
                              synchronizer=AllReduceSynchronizer(group=group)), num_shards
        partition_list = [1] * len(var.shape)
        partition_list[0] = min(num_shards, var.shape[0])
        node = NodeConfig(
            var_name=var.name, synchronizer=AllReduceSynchronizer(group=group),
            partitioner=",".join(map(str, partition_list)),
            part_config=[NodeConfig(var_name=part_name(var.name, i),
                                    synchronizer=AllReduceSynchronizer(
                                        group=(var_counter + i) // self.chunk_size))
                         for i in range(num_shards)])
        return node, num_shards
