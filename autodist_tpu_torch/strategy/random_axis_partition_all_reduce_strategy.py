"""Random-axis partitioned AllReduce (PyTorch port of
``strategy/random_axis_partition_all_reduce_strategy.py``): like
PartitionedAR, but a dense variable shards a random axis longer than 1 and
a sparse one axis 0. The draw is ``np.random.RandomState(seed)``'s, so a
seed gives the JAX package's Strategy JSON."""
from typing import Optional, Tuple

import numpy as np

from autodist_tpu_torch.model_item import ModelItem, VarItem
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import StrategyBuilder, min_divisor_shards, part_name
from autodist_tpu_torch.strategy.ir import AllReduceSynchronizer, NodeConfig, Strategy


class RandomAxisPartitionAR(StrategyBuilder):
    """Partition a random axis longer than 1, then all-reduce each shard."""

    def __init__(self, chunk_size: int = 128, seed: Optional[int] = None):
        if chunk_size < 1:
            raise ValueError("The chunk_size must be greater than zero.")
        self.chunk_size = chunk_size
        self._rng = np.random.RandomState(seed)

    def build(self, model_item: ModelItem, resource_spec: ResourceSpec) -> Strategy:
        expr = self._new_strategy(resource_spec)
        var_counter = 0
        for var in model_item.trainable_variables:
            node, num_shards = self._gen_node_config(var, var_counter)
            var_counter += num_shards
            expr.node_config.append(node)
        return expr

    def get_num_shards_and_axis(self, var: VarItem) -> Tuple[int, int]:
        if not var.shape:
            return 1, 0
        non_one_dim = [i for i, d in enumerate(var.shape) if d > 1]
        if not non_one_dim:
            return 1, 0
        if var.sparse_update:
            axis = 0
        else:
            axis = non_one_dim[int(self._rng.randint(0, len(non_one_dim)))]
        return min_divisor_shards(var.shape[axis]), axis

    def _gen_node_config(self, var: VarItem, var_counter: int):
        num_shards, axis = self.get_num_shards_and_axis(var)
        group = var_counter // self.chunk_size
        if num_shards <= 1:
            return NodeConfig(var_name=var.name,
                              synchronizer=AllReduceSynchronizer(group=group)), num_shards
        partition_list = [1] * len(var.shape)
        partition_list[axis] = num_shards
        node = NodeConfig(
            var_name=var.name, synchronizer=AllReduceSynchronizer(group=group),
            partitioner=",".join(map(str, partition_list)),
            part_config=[NodeConfig(var_name=part_name(var.name, i),
                                    synchronizer=AllReduceSynchronizer(
                                        group=(var_counter + i) // self.chunk_size))
                         for i in range(num_shards)])
        return node, num_shards
