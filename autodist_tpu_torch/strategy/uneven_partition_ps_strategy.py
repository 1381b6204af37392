"""Uneven partitioned PS: shard count = smallest non-divisor of dim 0
(PyTorch port of ``strategy/uneven_partition_ps_strategy.py``). The
lowering takes the largest divisible axis instead, or pads."""
from autodist_tpu_torch.model_item import VarItem
from autodist_tpu_torch.strategy.base import min_non_divisor_shards
from autodist_tpu_torch.strategy.partitioned_ps_strategy import PartitionedPS


class UnevenPartitionedPS(PartitionedPS):
    """PartitionedPS's placement with uneven shard counts."""

    def get_num_shards(self, var: VarItem) -> int:
        if not var.shape:
            return 1
        return min_non_divisor_shards(var.shape[0])
