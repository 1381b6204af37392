"""Strategy layer of the port: serializable plans + the builders ported so
far (AllReduce, PS, PSLoadBalancing)."""
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
from autodist_tpu_torch.strategy.ps_lb_strategy import PSLoadBalancing
from autodist_tpu_torch.strategy.ps_strategy import PS

BUILTIN_BUILDERS = {cls.__name__: cls for cls in (PS, PSLoadBalancing, AllReduce)}


def from_name(name: str, **kwargs) -> StrategyBuilder:
    """Builder by class name. The JAX package's other builders are in
    ROADMAP.md."""
    if name not in BUILTIN_BUILDERS:
        raise ValueError(f"unknown or unported strategy {name!r}; ported: "
                         f"{sorted(BUILTIN_BUILDERS)} (the others are in ROADMAP.md)")
    return BUILTIN_BUILDERS[name](**kwargs)


__all__ = [
    "AllReduce", "AllReduceSpec", "AllReduceSynchronizer", "BUILTIN_BUILDERS",
    "GraphConfig", "NodeConfig", "PS", "PSLoadBalancing", "PSSynchronizer", "Strategy",
    "StrategyBuilder", "StrategyCompiler", "from_name",
]
