"""plan: the search-based offline planner (PyTorch port of the JAX
package's ``plan/``).

It sits above the fixed ``strategy/`` builders: a beam search over the
per-variable strategy space (``search.py``) priced by the cost model
through a per-topology calibration fitted from measured steps
(``calibrate.py``), with a persistent plan cache keyed by (model
fingerprint, resource digest, package version), so a repeated question
skips the search (``cache.py``). ``Plan`` packages the three as a
StrategyBuilder — ``AutoDist(strategy_builder="plan")`` — and ``python -m
autodist_tpu_torch.plan --selftest`` is the proof on the CPU.
"""
from autodist_tpu_torch.plan.builder import Plan, PlanConfig
from autodist_tpu_torch.plan.cache import (
    CacheEntry,
    PlanCache,
    default_cache_dir,
    dryrun_lowers,
    model_fingerprint,
    plan_key,
)
from autodist_tpu_torch.plan.calibrate import (
    CalibrationRecord,
    TopologyCalibration,
    calibrate_from_records,
    prediction_error,
    record_from_attribution,
    record_from_profiler,
    topology_key,
)
from autodist_tpu_torch.plan.search import (
    BUCKET_GENE_CHOICES,
    PlanGenome,
    PlanSearch,
    SearchConfig,
    SearchResult,
    VarGene,
    genome_to_strategy,
    search,
    strategy_to_genome,
)

__all__ = [
    "BUCKET_GENE_CHOICES",
    "CacheEntry",
    "CalibrationRecord",
    "Plan",
    "PlanCache",
    "PlanConfig",
    "PlanGenome",
    "PlanSearch",
    "SearchConfig",
    "SearchResult",
    "TopologyCalibration",
    "VarGene",
    "calibrate_from_records",
    "default_cache_dir",
    "dryrun_lowers",
    "genome_to_strategy",
    "model_fingerprint",
    "plan_key",
    "prediction_error",
    "record_from_attribution",
    "record_from_profiler",
    "search",
    "strategy_to_genome",
    "topology_key",
]
