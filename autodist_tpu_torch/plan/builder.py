"""``Plan``: the search-based planner as an ordinary StrategyBuilder (PyTorch
port of the JAX package's ``plan/builder.py``).

It sits above the fixed builders as ``Auto`` does, but instead of ranking a
fixed slate it (1) consults the persistent plan cache: the same (model,
resources, version) question returns the cached winner byte for byte with
no search; (2) otherwise runs the beam search over the per-variable
strategy space (``plan/search.py``), priced through the per-topology
calibration when one was recorded (``plan/calibrate.py``); (3) stores the
winner and its provenance in the cache::

    ad = AutoDist(strategy_builder="plan")          # default PlanConfig
    ad = AutoDist(strategy_builder=Plan(PlanConfig(
        cache_dir="/fast/plan-cache", generations=8)))

After ``build``, ``Plan.last_result`` holds the provenance (rendered by
``strategy/explain.py``'s ``explain_provenance``) and ``Plan.cache.stats``
the hit and miss counts.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field, replace
from typing import Dict, Optional

from autodist_tpu_torch.model_item import ModelItem
from autodist_tpu_torch.plan.cache import PlanCache, default_cache_dir
from autodist_tpu_torch.plan.calibrate import TopologyCalibration
from autodist_tpu_torch.plan.search import PlanSearch, SearchConfig
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import StrategyBuilder
from autodist_tpu_torch.strategy.ir import Strategy
from autodist_tpu_torch.utils import logging


@dataclass
class PlanConfig:
    """The planner's knobs (search, cache, calibration)."""

    # None disables the cache (always search).
    cache_dir: Optional[str] = field(default_factory=default_cache_dir)
    # Dry-run lower a cached plan before trusting it (plan/cache.py).
    validate_cache: bool = True
    # Search shape (SearchConfig).
    beam_width: int = 4
    generations: int = 4
    mutations_per_survivor: int = 8
    seed: int = 0
    search_mesh: bool = False
    # "auto" loads the calibration recorded for this topology (none when no
    # tune() recorded one), None disables, or a TopologyCalibration.
    calibration: object = "auto"

    def search_config(self) -> SearchConfig:
        return SearchConfig(beam_width=self.beam_width, generations=self.generations,
                            mutations_per_survivor=self.mutations_per_survivor,
                            seed=self.seed, search_mesh=self.search_mesh)


class Plan(StrategyBuilder):
    """Search-based planner with a persistent plan cache."""

    def __init__(self, config: Optional[PlanConfig] = None, **overrides):
        cfg = config or PlanConfig()
        if overrides:
            cfg = replace(cfg, **overrides)
        self.config = cfg
        self.cache: Optional[PlanCache] = None
        if cfg.cache_dir is not None:
            self.cache = PlanCache(cache_dir=cfg.cache_dir, validate=cfg.validate_cache)
        # After build(): {"cache_hit", "key", "n_visited", "provenance",
        # "path", and on a hit "validated" (the dry run lowered the entry)}.
        self.last_result: Optional[Dict] = None

    def _calibration(self, resource_spec: ResourceSpec):
        cal = self.config.calibration
        if cal is None or isinstance(cal, TopologyCalibration):
            return cal
        if cal == "auto":
            import torch

            # The device naming tune() records under.
            kind = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
            return TopologyCalibration.load_for(resource_spec, kind)
        raise ValueError(f"PlanConfig.calibration must be None, 'auto', or a "
                         f"TopologyCalibration; got {cal!r}")

    def build(self, model_item: ModelItem, resource_spec: ResourceSpec) -> Strategy:
        if self.cache is not None:
            entry = self.cache.get(model_item, resource_spec)
            if entry is not None:
                self.last_result = {"cache_hit": True, "key": entry.key, "n_visited": 0,
                                    "provenance": entry.provenance, "path": entry.path,
                                    "validated": entry.validated}
                return entry.strategy
        result = PlanSearch(model_item, resource_spec, self.config.search_config(),
                            calibration=self._calibration(resource_spec)).run()
        self.last_result = {"cache_hit": False, "key": None, "n_visited": result.n_visited,
                            "provenance": result.provenance}
        if self.cache is not None:
            try:
                path = self.cache.put(model_item, resource_spec, result.strategy,
                                      provenance=result.provenance)
                self.last_result["path"] = path
                self.last_result["key"] = os.path.basename(path)
            except OSError as e:
                # A read-only cache dir must not fail planning.
                logging.warning("plan cache store failed (%s); continuing uncached", e)
        return result.strategy
