"""Auto strategy: pick a builder from the model and the cluster (PyTorch
port of ``strategy/auto_strategy.py``).

1. **Structural dispatch**: a model with sparse-update variables (embedding
   workloads: LM1B, NCF) gets **Parallax** (dense variables all-reduced,
   sparse tables on a load-balanced PS), as the original AutoDist's own
   dispatch is by gradient type.
2. **Cost ranking** of the dense slate (``cost_model.candidate_slate``):
   each candidate is built and priced by
   :class:`~autodist_tpu_torch.strategy.cost_model.CostModel` on the
   resource spec's node model, and the fastest that fits the GPU's HBM
   wins; when none fits, the smallest footprint wins, with a warning.

``Auto(cost_model=False)`` keeps the heuristic that came before the cost
model: PartitionedAR when one tensor holds at least half the bytes, else
AllReduce.
"""
from __future__ import annotations

from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
from autodist_tpu_torch.strategy.base import StrategyBuilder
from autodist_tpu_torch.strategy.cost_model import CostModel, candidate_slate
from autodist_tpu_torch.strategy.ir import Strategy
from autodist_tpu_torch.strategy.parallax_strategy import Parallax
from autodist_tpu_torch.strategy.partitioned_all_reduce_strategy import PartitionedAR
from autodist_tpu_torch.utils import logging


class Auto(StrategyBuilder):
    """Analyze (model x resources) and emit the best-fit strategy."""

    def __init__(self, chunk_size: int = 128, cost_model: bool = True):
        self._chunk_size = chunk_size
        self._use_cost_model = cost_model

    def build(self, model_item: ModelItem, resource_spec: ResourceSpec) -> Strategy:
        if model_item.sparse_variables:
            strategy = Parallax(chunk_size=self._chunk_size).build(model_item, resource_spec)
            if self._use_cost_model:
                cost = CostModel(model_item, resource_spec).strategy_cost(strategy)
                logging.info("Auto -> Parallax (sparse dispatch): %s", cost.describe())
            else:
                logging.info("Auto -> Parallax (sparse dispatch)")
            return strategy
        if not self._use_cost_model:
            return self._heuristic(model_item, resource_spec)
        built = [(name, b.build(model_item, resource_spec)) for name, b in
                 candidate_slate(chunk_size=self._chunk_size, include_sparse=False)]
        ranked = CostModel(model_item, resource_spec).rank(built)
        for name, cost in ranked:
            logging.info("Auto candidate %-16s %s", name, cost.describe())
        best_name, best_cost = ranked[0]
        if not best_cost.feasible:
            logging.warning("Auto: no candidate fits a GPU's HBM (%.2f GB usable); "
                            "choosing smallest footprint %s (%.2f GB)",
                            best_cost.hbm_bytes / 1e9, best_name,
                            best_cost.per_chip_bytes / 1e9)
        logging.info("Auto strategy selected %s", best_name)
        return dict(built)[best_name]

    def _heuristic(self, model_item: ModelItem, resource_spec: ResourceSpec) -> Strategy:
        trainable = model_item.trainable_variables
        total = sum(v.byte_size for v in trainable) or 1
        biggest = max((v.byte_size for v in trainable), default=0)
        if biggest / total >= 0.5 and len(trainable) > 1:
            chosen: StrategyBuilder = PartitionedAR(chunk_size=self._chunk_size)
        else:
            chosen = AllReduce(chunk_size=self._chunk_size)
        logging.info("Auto (heuristic) selected %s", type(chosen).__name__)
        return chosen.build(model_item, resource_spec)
