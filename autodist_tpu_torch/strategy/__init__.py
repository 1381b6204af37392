"""Strategy layer of the port: serializable plans + the builders ported so
far (PS, PSLoadBalancing, PartitionedPS, UnevenPartitionedPS, AllReduce,
PartitionedAR, RandomAxisPartitionAR, Parallax, Zero1)."""
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import StrategyBuilder, StrategyCompiler
from autodist_tpu_torch.strategy.ir import (
    AllReduceSpec,
    AllReduceSynchronizer,
    GraphConfig,
    NodeConfig,
    PSSynchronizer,
    Strategy,
)
from autodist_tpu_torch.strategy.parallax_strategy import Parallax
from autodist_tpu_torch.strategy.partitioned_all_reduce_strategy import PartitionedAR
from autodist_tpu_torch.strategy.partitioned_ps_strategy import PartitionedPS
from autodist_tpu_torch.strategy.ps_lb_strategy import PSLoadBalancing
from autodist_tpu_torch.strategy.ps_strategy import PS
from autodist_tpu_torch.strategy.random_axis_partition_all_reduce_strategy import (
    RandomAxisPartitionAR)
from autodist_tpu_torch.strategy.uneven_partition_ps_strategy import UnevenPartitionedPS
from autodist_tpu_torch.strategy.zero1_strategy import Zero1

BUILTIN_BUILDERS = {cls.__name__: cls for cls in (
    PS, PSLoadBalancing, PartitionedPS, UnevenPartitionedPS, AllReduce, PartitionedAR,
    RandomAxisPartitionAR, Parallax, Zero1)}


def from_name(name: str, **kwargs) -> StrategyBuilder:
    """Builder by class name. The JAX package's Auto, TensorParallel and
    Plan are in ROADMAP.md."""
    if name not in BUILTIN_BUILDERS:
        raise ValueError(f"unknown or unported strategy {name!r}; ported: "
                         f"{sorted(BUILTIN_BUILDERS)} (the others are in ROADMAP.md)")
    return BUILTIN_BUILDERS[name](**kwargs)


__all__ = [
    "AllReduce", "AllReduceSpec", "AllReduceSynchronizer", "BUILTIN_BUILDERS",
    "GraphConfig", "NodeConfig", "PS", "PSLoadBalancing", "PSSynchronizer", "Parallax",
    "PartitionedAR", "PartitionedPS", "RandomAxisPartitionAR", "Strategy",
    "StrategyBuilder", "StrategyCompiler", "UnevenPartitionedPS", "Zero1", "from_name",
]
