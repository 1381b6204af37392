"""PS with greedy byte-size load balancing — the default strategy (PyTorch
port of ``strategy/ps_lb_strategy.py``)."""
from typing import Dict

from autodist_tpu_torch.model_item import ModelItem, VarItem
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import StrategyBuilder, byte_size_load_fn, reduction_devices
from autodist_tpu_torch.strategy.ir import NodeConfig, PSSynchronizer, Strategy


class PSLoadBalancing(StrategyBuilder):
    """Greedy bin-packing of variables onto reduction destinations by bytes."""

    def __init__(self, local_proxy_variable: bool = False, sync: bool = True,
                 staleness: int = 0):
        self._local_proxy_variable = local_proxy_variable
        self._sync = sync
        self._staleness = staleness
        self.loads: Dict[str, float] = {}

    def build(self, model_item: ModelItem, resource_spec: ResourceSpec) -> Strategy:
        expr = self._new_strategy(resource_spec)
        self.loads = {ps: 0.0 for ps in reduction_devices(resource_spec)}
        expr.node_config = [self._gen_ps_node_config(v)
                            for v in model_item.trainable_variables]
        return expr

    def _gen_ps_node_config(self, var: VarItem) -> NodeConfig:
        # Greedy: place on the least-loaded destination.
        min_ps = min(self.loads, key=self.loads.get)
        self.loads[min_ps] += byte_size_load_fn(var)
        return NodeConfig(var_name=var.name,
                          synchronizer=PSSynchronizer(
                              reduction_destination=min_ps,
                              local_replication=self._local_proxy_variable,
                              sync=self._sync, staleness=self._staleness))
