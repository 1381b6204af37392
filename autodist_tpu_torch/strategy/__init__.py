"""Strategy layer of the port: serializable plans, the builders (PS,
PSLoadBalancing, PartitionedPS, UnevenPartitionedPS, AllReduce,
PartitionedAR, RandomAxisPartitionAR, Parallax, Zero1, TensorParallel) and
``Auto``, which picks one by the cost model (``cost_model.py``) on the
resource spec's GPU node model; ``explain.py`` prints its ranking."""
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.auto_strategy import Auto
from autodist_tpu_torch.strategy.base import StrategyBuilder, StrategyCompiler
from autodist_tpu_torch.strategy.cost_model import CostModel, StrategyCost
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
from autodist_tpu_torch.strategy.tensor_parallel_strategy import TensorParallel
from autodist_tpu_torch.strategy.uneven_partition_ps_strategy import UnevenPartitionedPS
from autodist_tpu_torch.strategy.zero1_strategy import Zero1

BUILTIN_BUILDERS = {cls.__name__: cls for cls in (
    PS, PSLoadBalancing, PartitionedPS, UnevenPartitionedPS, AllReduce, PartitionedAR,
    RandomAxisPartitionAR, Parallax, Auto, Zero1, TensorParallel)}


def from_name(name: str, **kwargs) -> StrategyBuilder:
    """Builder by class name. The JAX package's search-based ``Plan`` is
    not ported yet (ROADMAP.md Queue 1 item 11)."""
    if name in ("plan", "Plan"):
        raise NotImplementedError("the Plan builder (plan/) is not ported yet; see "
                                  "ROADMAP.md Queue 1 item 11")
    if name not in BUILTIN_BUILDERS:
        raise ValueError(f"unknown or unported strategy {name!r}; ported: "
                         f"{sorted(BUILTIN_BUILDERS)} (the others are in ROADMAP.md)")
    return BUILTIN_BUILDERS[name](**kwargs)


__all__ = [
    "AllReduce", "AllReduceSpec", "AllReduceSynchronizer", "Auto", "BUILTIN_BUILDERS",
    "CostModel", "StrategyCost",
    "GraphConfig", "NodeConfig", "PS", "PSLoadBalancing", "PSSynchronizer", "Parallax",
    "PartitionedAR", "PartitionedPS", "RandomAxisPartitionAR", "Strategy",
    "StrategyBuilder", "StrategyCompiler", "TensorParallel", "UnevenPartitionedPS", "Zero1",
    "from_name",
]
