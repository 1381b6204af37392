"""PS strategy: every variable on one reduction destination (PyTorch port of
``strategy/ps_strategy.py``)."""
from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import StrategyBuilder, reduction_devices
from autodist_tpu_torch.strategy.ir import NodeConfig, PSSynchronizer, Strategy


class PS(StrategyBuilder):
    """All variables synchronized through the first host-CPU destination."""

    def __init__(self, local_proxy_variable: bool = False, sync: bool = True,
                 staleness: int = 0):
        self._local_proxy_variable = local_proxy_variable
        self._sync = sync
        self._staleness = staleness

    def build(self, model_item: ModelItem, resource_spec: ResourceSpec) -> Strategy:
        expr = self._new_strategy(resource_spec)
        destination = reduction_devices(resource_spec)[0]
        expr.node_config = [
            NodeConfig(var_name=v.name,
                       synchronizer=PSSynchronizer(
                           reduction_destination=destination,
                           local_replication=self._local_proxy_variable,
                           sync=self._sync, staleness=self._staleness))
            for v in model_item.trainable_variables
        ]
        return expr
