"""Parallax: dense variables on AllReduce, sparse-update ones on
load-balanced PS without a proxy (PyTorch port of
``strategy/parallax_strategy.py``)."""
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import byte_size_load_fn, reduction_devices
from autodist_tpu_torch.strategy.ir import (
    AllReduceSynchronizer, NodeConfig, PSSynchronizer, Strategy)
from autodist_tpu_torch.strategy.ps_lb_strategy import PSLoadBalancing


class Parallax(PSLoadBalancing, AllReduce):
    """Per-variable dense/sparse dispatch."""

    def __init__(self, chunk_size: int = 128, local_proxy_variable: bool = False,
                 sync: bool = True, staleness: int = 0,
                 all_reduce_spec: str = "AUTO", compressor: str = "NoneCompressor"):
        PSLoadBalancing.__init__(self, local_proxy_variable, sync, staleness)
        AllReduce.__init__(self, chunk_size, all_reduce_spec, compressor)

    def build(self, model_item: ModelItem, resource_spec: ResourceSpec) -> Strategy:
        expr = self._new_strategy(resource_spec)
        self.loads = {ps: 0.0 for ps in reduction_devices(resource_spec)}
        for idx, var in enumerate(model_item.trainable_variables):
            if not var.sparse_update:
                sync = AllReduceSynchronizer(spec=self.all_reduce_spec,
                                             compressor=self.compressor,
                                             group=idx // self.chunk_size)
            else:
                min_ps = min(self.loads, key=self.loads.get)
                self.loads[min_ps] += byte_size_load_fn(var)
                sync = PSSynchronizer(reduction_destination=min_ps, local_replication=False,
                                      sync=self._sync, staleness=self._staleness)
            expr.node_config.append(NodeConfig(var_name=var.name, synchronizer=sync))
        return expr
