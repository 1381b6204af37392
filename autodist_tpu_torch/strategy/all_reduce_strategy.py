"""AllReduce strategy: every variable synced by gradient all-reduce (PyTorch
port of ``strategy/all_reduce_strategy.py``).

Variables fall into collective groups of ``chunk_size`` consecutive
variables (in the JAX leaf order, so the groups agree with the JAX
package's). On one device the lowering runs the plain update.
"""
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import StrategyBuilder
from autodist_tpu_torch.strategy.ir import AllReduceSynchronizer, NodeConfig, Strategy


class AllReduce(StrategyBuilder):
    """Gradient all-reduce for every trainable variable."""

    def __init__(self, chunk_size: int = 128, all_reduce_spec: str = "AUTO",
                 compressor: str = "NoneCompressor", bucket_bytes: int = 0):
        if chunk_size < 1:
            raise ValueError("The chunk_size must be greater than zero.")
        if bucket_bytes < 0:
            raise ValueError("bucket_bytes must be >= 0.")
        self.chunk_size = chunk_size
        self.all_reduce_spec = all_reduce_spec
        self.compressor = compressor
        self.bucket_bytes = bucket_bytes

    def build(self, model_item: ModelItem, resource_spec: ResourceSpec) -> Strategy:
        expr = self._new_strategy(resource_spec)
        expr.graph_config.bucket_bytes = self.bucket_bytes
        expr.node_config = [
            NodeConfig(var_name=v.name,
                       synchronizer=AllReduceSynchronizer(
                           spec=self.all_reduce_spec, compressor=self.compressor,
                           group=i // self.chunk_size))
            for i, v in enumerate(model_item.trainable_variables)
        ]
        return expr
