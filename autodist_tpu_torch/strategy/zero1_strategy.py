"""Zero1: gradient all-reduce with weight-update sharding (ZeRO-1, arXiv
2004.13336; PyTorch port of ``strategy/zero1_strategy.py``). Every dense
variable of at least ``min_bytes`` asks for ``shard_update``: the lowering
reduce-scatters its gradient, updates this rank's slice with slice-shaped
optimizer slots and all-gathers the new values. Sparse-update variables
keep the plain all-reduce config (the lowering row-shards them)."""
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import StrategyBuilder
from autodist_tpu_torch.strategy.ir import AllReduceSynchronizer, NodeConfig, Strategy


class Zero1(StrategyBuilder):
    """AllReduce with reduce-scatter / sharded update / all-gather."""

    def __init__(self, chunk_size: int = 128, all_reduce_spec: str = "AUTO",
                 min_bytes: int = 0, bucket_bytes: int = 0):
        if chunk_size < 1:
            raise ValueError("The chunk_size must be greater than zero.")
        if min_bytes < 0:
            raise ValueError("min_bytes must be >= 0.")
        if bucket_bytes < 0:
            raise ValueError("bucket_bytes must be >= 0.")
        self.chunk_size = chunk_size
        self.all_reduce_spec = all_reduce_spec
        self.min_bytes = min_bytes
        self.bucket_bytes = bucket_bytes

    def build(self, model_item: ModelItem, resource_spec: ResourceSpec) -> Strategy:
        expr = self._new_strategy(resource_spec)
        expr.graph_config.bucket_bytes = self.bucket_bytes
        expr.node_config = [
            NodeConfig(var_name=v.name,
                       synchronizer=AllReduceSynchronizer(
                           spec=self.all_reduce_spec, group=i // self.chunk_size,
                           shard_update=not v.sparse_update and v.byte_size >= self.min_bytes))
            for i, v in enumerate(model_item.trainable_variables)
        ]
        return expr
