"""TensorParallel: Megatron-style role-aware axis selection (PyTorch port
of ``strategy/tensor_parallel_strategy.py``).

Column-parallel into a block (QKV, FC1: shard the output feature dim) and
row-parallel out of it (attention output, FC2: shard the input feature
dim), so activations stay sharded through the block interior (Megatron-LM,
arXiv 1909.08053). The lowering puts the partitioned axis on the mesh's
``model`` axis, and the train step renders it with ``DTensor``
(``kernel/lowering.py``).

Role detection, in priority order, as in the JAX package:

1. **Dataflow** (``VarItem.tp_role``, set when the ModelItem traced a
   loss): a contraction consuming a column-sharded interior is row-parallel.
2. **Name markers** (``_COLUMN``/``_ROW``), for ModelItems built without a
   traced loss.
3. **Default column** (last axis), reported loudly per build.

Embeddings shard the vocab axis; 1-D vars (biases, norms) stay replicated
via AllReduce.
"""
from __future__ import annotations

from autodist_tpu_torch.model_item import ModelItem, VarItem
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import StrategyBuilder
from autodist_tpu_torch.strategy.ir import (
    AllReduceSynchronizer, NodeConfig, PSSynchronizer, Strategy)
from autodist_tpu_torch.utils import logging

# Row-parallel (shard input dim, axis -2): projections out of a sharded
# interior. Matched against the last path components.
_ROW = ("wo", "fc2", "out_proj", "o_proj", "down_proj", "proj_out", "dense_4h_to_h")
# Column-parallel (shard output dim, axis -1): projections into the block.
_COLUMN = ("wq", "wk", "wv", "fc1", "in_proj", "q_proj", "k_proj", "v_proj",
           "up_proj", "gate_proj", "dense_h_to_4h")


def _role_axis(var: VarItem) -> tuple:
    """(partition axis or None, provenance): "skip" (rank < 2), "sparse",
    "jaxpr" (the dataflow role; JAX's name for it), "marker" or "default"
    (the builder is guessing)."""
    rank = len(var.shape)
    if rank < 2:
        return None, "skip"
    parts = var.name.lower().split("/")
    # The component holding the layer name ("attn/wq/kernel" -> "wq").
    hay = parts[-2] if parts[-1] in ("kernel", "embedding", "w") and len(parts) >= 2 \
        else parts[-1]
    if var.sparse_update:
        return 0, "sparse"            # vocab/row axis
    if var.tp_role == "row":
        return rank - 2, "jaxpr"
    if var.tp_role == "column":
        return rank - 1, "jaxpr"
    # After the dataflow role: a dense projection merely named "*embed*"
    # keeps the axis its dataflow chose.
    if "embed" in hay:
        return 0, "sparse"
    # Exact-token match ("network" contains "wo").
    if hay in _ROW:
        return rank - 2, "marker"     # input features
    if hay in _COLUMN:
        return rank - 1, "marker"     # output features
    return rank - 1, "default"        # column guess


class TensorParallel(StrategyBuilder):
    """Shard every eligible variable with Megatron axis pairing."""

    def __init__(self, num_shards: int = 0, compressor: str = "NoneCompressor"):
        # 0 = derive from the mesh's model axis at build time.
        self._num_shards = num_shards
        self._compressor = compressor

    def build(self, model_item: ModelItem, resource_spec: ResourceSpec) -> Strategy:
        expr = self._new_strategy(resource_spec)
        mesh = resource_spec.mesh_shape(("data", "model"))
        n = mesh.get("model", 1)
        if n <= 1:
            # No model axis: every device is data-parallel; degrade to
            # sharding over data (the lowering's shard axis fallback).
            n = mesh.get("data", 1)
        if self._num_shards and self._num_shards != n:
            raise ValueError(
                f"TensorParallel(num_shards={self._num_shards}) does not match the mesh "
                f"shard axis size {n}; drop num_shards or fix the resource spec's mesh "
                "block")
        nodes, guessed = [], []
        for v in model_item.trainable_variables:
            axis, how = _role_axis(v)
            if how == "default":
                guessed.append(v.name)
            sync = AllReduceSynchronizer(compressor=self._compressor)
            if axis is None or v.shape[axis] % max(n, 1) != 0:
                nodes.append(NodeConfig(var_name=v.name, synchronizer=sync))
                continue
            part = ["1"] * len(v.shape)
            part[axis] = str(n)
            if v.sparse_update:
                sync = PSSynchronizer()
            nodes.append(NodeConfig(var_name=v.name, synchronizer=sync,
                                    partitioner=",".join(part)))
        if guessed:
            logging.warning(
                "TensorParallel guessed default-column for %d var(s) with no dataflow "
                "role and no name marker: %s. Build the ModelItem with loss_fn + "
                "example_batch for dataflow-based roles.", len(guessed),
                ", ".join(guessed[:8]) + ("…" if len(guessed) > 8 else ""))
        expr.node_config = nodes
        return expr
