"""Lowering layer of the port: mesh, sharding plan and the train step."""
from autodist_tpu_torch.kernel.lowering import (
    DistributedTrainStep,
    GraphTransformer,
    ShardingPlan,
    SyncKind,
    TrainState,
    VarPlan,
)
from autodist_tpu_torch.kernel.mesh import Mesh, build_mesh

__all__ = ["DistributedTrainStep", "GraphTransformer", "Mesh", "ShardingPlan",
           "SyncKind", "TrainState", "VarPlan", "build_mesh"]
