"""The policy actions: pure knob-proposal functions over a PilotContext
(PyTorch port of the JAX package's ``pilot/actions.py``: the same
decisions on the same inputs, plan artifacts under the same content ids).

Each action takes ``(state, evidence)`` and returns an
:class:`ActionResult` — the knob updates to deploy, the action's
``expected`` claim (so the journal can record expected vs measured), or
a typed rejection (the poisoned-refit gate). Actions PROPOSE only: the
controller owns episodes, cooldowns, the guarded rollout, and the
canary/rollback verdict. That split keeps every action a deterministic
unit-testable function.

``refit_replan`` is the heavyweight: refit ``plan/calibrate.py`` from
the live flight+attrib records (the chaos ``poisoned_calibration`` seam
sits exactly at its intake), gate the candidate fit against the
pre-refit coefficients on the TRUSTED record set (a refit that regresses
there is adversarial or garbage — rejected, journaled, never deployed;
the keep-best guard inside ``calibrate_from_records`` is the second,
independent belt), then re-search the plan under the new calibration
(``PlanSearch`` — shardlint/schedlint screening built in) and persist
the winner as a content-addressed artifact the train rollout deploys by
``plan_id`` (the first 12 hex digits of the SHA-256 of the sorted
Strategy JSON: one strategy has one id in both packages).

``tune_xla_flags`` keeps the JAX package's knob, action and flag-set
names, so state files, journals and ``describe()`` read the same in both
packages and either doctor stitches either journal. It is a pure decision
over the flag-set document the context names (measured and stable: the
best set; otherwise the next candidate round-robin, behind the canary).
The port reads no TPU measurement as the card's: the fallback candidates
are JAX's flag-set names, kept only as names, and what a flag set would
change on the card waits for a benchmark.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from autodist_tpu_torch.chaos import hooks
from autodist_tpu_torch.pilot.state import PilotState
from autodist_tpu_torch.utils import logging

# Bounds a serve-knob nudge may never leave (per model x topology; the
# context can override).
SPEC_K_BOUNDS = (1, 8)
MIN_PREFILL_CHUNK = 4

# Flag-set candidates when the flag-set document carries no measured
# results: the JAX package's flag-set names ("base" first so an unmeasured
# pin can always be A/B'd against no flags), kept as names only.
FALLBACK_FLAG_SETS = ("base", "lhs_on", "async_cf_ag", "overlap_all",
                      "vmem128m")


@dataclass
class ActionResult:
    """A proposed knob change (or a typed rejection)."""

    knobs: Dict[str, Any] = field(default_factory=dict)
    expected: Dict[str, Any] = field(default_factory=dict)
    rejected: str = ""   # non-empty = the action refuses to deploy

    @property
    def is_rejected(self) -> bool:
        return bool(self.rejected)


@dataclass
class PilotContext:
    """Everything the real actions need, injected once at wiring time."""

    model_item: Any = None
    resource_spec: Any = None
    device_kind: str = ""
    calibration_dir: str = ""
    pilot_dir: str = ""
    xla_flags_path: str = ""
    # Live (predicted, measured) records from the flight/attrib stream —
    # a callable so every refit reads the freshest window.
    live_records: Optional[Callable[[], List[Any]]] = None
    # The currently deployed strategy (for pricing the stale plan).
    current_strategy: Optional[Callable[[], Any]] = None
    search_config: Any = None
    # A candidate refit must not regress the trusted-set fit error by
    # more than this fraction (the poisoned-calibration gate).
    refit_regression_bound: float = 0.10
    spec_k_bounds: tuple = SPEC_K_BOUNDS
    max_pages: int = 1 << 16
    min_prefill_chunk: int = MIN_PREFILL_CHUNK


# ------------------------------------------------------------ plan artifacts
def plan_artifact_path(pilot_dir: str, plan_id: str) -> str:
    return os.path.join(pilot_dir, "plans", f"plan-{plan_id}.json")


def save_plan_artifact(pilot_dir: str, strategy) -> str:
    """Persist a strategy as a content-addressed pilot artifact; returns
    its ``plan_id``. Deploy-by-id is what lets ``Controller.recover``
    re-deploy the exact old plan after a crash."""
    raw = json.dumps(strategy.to_json(), indent=2,
                     sort_keys=True).encode("utf-8")
    plan_id = hashlib.sha256(raw).hexdigest()[:12]
    path = plan_artifact_path(pilot_dir, plan_id)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(raw)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return plan_id


def load_plan_artifact(pilot_dir: str, plan_id: str):
    from autodist_tpu_torch.strategy.ir import Strategy

    with open(plan_artifact_path(pilot_dir, plan_id), "r",
              encoding="utf-8") as f:
        return Strategy.from_json(json.load(f))


# ----------------------------------------------------------------- actions
def build_actions(ctx: PilotContext) -> Dict[str, Callable]:
    """The action name -> callable map for a wired context."""
    return {
        "refit_replan": lambda s, e: refit_replan(ctx, s, e),
        "tune_bucket_bytes": lambda s, e: tune_bucket_bytes(ctx, s, e),
        "tune_xla_flags": lambda s, e: tune_xla_flags(ctx, s, e),
        "tune_serve_latency": lambda s, e: tune_serve_latency(ctx, s, e),
        "tune_pool": lambda s, e: tune_pool(ctx, s, e),
        "tune_spec_k": lambda s, e: tune_spec_k(ctx, s, e),
    }


def refit_replan(ctx: PilotContext, state: PilotState,
                 evidence: Dict) -> ActionResult:
    """Refit the topology calibration from live records, gate it, and
    re-search the plan under the accepted fit."""
    from autodist_tpu_torch.plan.calibrate import (
        TopologyCalibration,
        _merge_records,
        calibrate_from_records,
        load_records,
        prediction_error,
        topology_key,
    )
    from autodist_tpu_torch.plan.search import PlanSearch, SearchConfig
    from autodist_tpu_torch.strategy.cost_model import CostModel

    key = topology_key(ctx.resource_spec, ctx.device_kind)
    path = os.path.join(ctx.calibration_dir, f"calibration-{key}.json")
    trusted = load_records(path)
    old_calib = TopologyCalibration.load(path)

    live = list(ctx.live_records()) if ctx.live_records else []
    # The chaos poisoned_calibration seam: a plant may corrupt the live
    # window here — exactly what the gate below must catch.
    live = hooks.apply(hooks.SEAM_PILOT_REFIT, live)
    if not live:
        return ActionResult(rejected="no live calibration records")

    # Poisoned-refit gate: fit the candidate over trusted+live, grade it
    # on the TRUSTED records only. A genuine topology drift changes what
    # live records say about the FUTURE; it cannot make the candidate
    # predict the already-measured past much worse than the coefficients
    # fitted on it — a regression there means the live window is
    # corrupted/adversarial, and the fit must never deploy.
    if trusted and old_calib is not None:
        candidate = TopologyCalibration.fit(
            _merge_records(trusted, live), device=ctx.device_kind,
            topology=key)
        err_old = prediction_error(trusted, old_calib)
        err_new = prediction_error(trusted, candidate)
        if (math.isfinite(err_old) and math.isfinite(err_new)
                and err_new > err_old * (1.0 + ctx.refit_regression_bound)
                + 1e-12):
            logging.warning(
                "pilot refit REJECTED: trusted-set error %.4f -> %.4f "
                "(bound %.0f%%) — live window looks poisoned",
                err_old, err_new, ctx.refit_regression_bound * 100)
            return ActionResult(
                rejected="poisoned_calibration: candidate fit regresses "
                         "trusted-set error",
                expected={"err_trusted_before": err_old,
                          "err_trusted_after": err_new})

    # Accepted: persist through the keep-best refit (plan/calibrate.py
    # guards monotonicity on the merged set as the second belt), then
    # re-search under the new fit.
    calib = calibrate_from_records(
        live, ctx.resource_spec, device_kind=ctx.device_kind,
        directory=ctx.calibration_dir)
    search = PlanSearch(ctx.model_item, ctx.resource_spec,
                        ctx.search_config or SearchConfig(),
                        calibration=calib)
    result = search.run()
    plan_id = save_plan_artifact(ctx.pilot_dir, result.strategy)

    expected: Dict[str, Any] = {
        "calibration_error_after": calib.error_after,
        "plan_id": plan_id,
        "priced_new_ms": calib.predict_s(result.cost) * 1e3,
    }
    if ctx.current_strategy is not None:
        current = ctx.current_strategy()
        if current is not None:
            cm = CostModel(ctx.model_item, ctx.resource_spec)
            expected["priced_stale_ms"] = (
                calib.predict_s(cm.strategy_cost(current)) * 1e3)
    return ActionResult(
        knobs={"plan_id": plan_id,
               "bucket_bytes": result.strategy.graph_config.bucket_bytes},
        expected=expected)


def tune_bucket_bytes(ctx: PilotContext, state: PilotState,
                      evidence: Dict) -> ActionResult:
    """Re-pick the backward-overlap bucket gene by priced cost under the
    live calibration (SNT004 step-time regression)."""
    from autodist_tpu_torch.plan.calibrate import TopologyCalibration, topology_key
    from autodist_tpu_torch.plan.search import (
        BUCKET_GENE_CHOICES,
        PlanGenome,
        genome_to_strategy,
        strategy_to_genome,
    )
    from autodist_tpu_torch.strategy.cost_model import CostModel

    current = ctx.current_strategy() if ctx.current_strategy else None
    if current is None:
        return ActionResult(rejected="no deployed strategy to retune")
    key = topology_key(ctx.resource_spec, ctx.device_kind)
    calib = TopologyCalibration.load(
        os.path.join(ctx.calibration_dir, f"calibration-{key}.json"))
    cm = CostModel(ctx.model_item, ctx.resource_spec)

    def priced(strategy) -> float:
        cost = cm.strategy_cost(strategy)
        return calib.predict_s(cost) if calib is not None else cost.total_s

    base = strategy_to_genome(current, ctx.model_item, ctx.resource_spec)
    best_b, best_s = None, float("inf")
    for b in BUCKET_GENE_CHOICES:
        s = priced(genome_to_strategy(
            PlanGenome(genes=base.genes, bucket_bytes=b),
            ctx.model_item, ctx.resource_spec))
        if s < best_s:
            best_b, best_s = b, s
    if best_b is None:
        return ActionResult(rejected="no bucket candidate priced")
    return ActionResult(
        knobs={"bucket_bytes": int(best_b)},
        expected={"priced_before_ms": priced(current) * 1e3,
                  "priced_after_ms": best_s * 1e3})


def tune_xla_flags(ctx: PilotContext, state: PilotState,
                   evidence: Dict) -> ActionResult:
    """Swap the flag set (SNT005 HBM creep).

    A MEASURED flag-set document (``measured`` and ``session_stable``)
    picks the best set by its recorded ms/step. An UNMEASURED one is a
    source of tuning candidates, never a baseline: the action round-robins
    to the next candidate and lets the canary decide.
    """
    doc: Dict[str, Any] = {}
    try:
        with open(ctx.xla_flags_path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        pass
    measured = bool(doc.get("measured")) and bool(doc.get("session_stable"))
    results = {str(k): float(v)
               for k, v in (doc.get("results_ms_per_step") or {}).items()}
    if measured and results:
        best = min(results, key=results.get)
        if best == state.xla_flag_set:
            return ActionResult(
                rejected="measured-best flag set already deployed")
        return ActionResult(
            knobs={"xla_flag_set": best},
            expected={"measured_ms_per_step": results[best],
                      "stale": False})
    # Unmeasured: candidates only. Never "trust" the pinned chosen set —
    # advance past the current one and canary the next.
    candidates = list(results) or list(FALLBACK_FLAG_SETS)
    chosen = str((doc.get("chosen") or {}).get("name", ""))
    current = state.xla_flag_set or chosen
    try:
        nxt = candidates[(candidates.index(current) + 1) % len(candidates)]
    except ValueError:
        nxt = candidates[0]
    if nxt == current:
        return ActionResult(rejected="no alternative flag set to canary")
    return ActionResult(knobs={"xla_flag_set": nxt},
                        expected={"stale": True, "candidate_of": candidates})


def tune_serve_latency(ctx: PilotContext, state: PilotState,
                       evidence: Dict) -> ActionResult:
    """SNT007 (TTFT): halve the prefill chunk so decode interleaves
    sooner; SNT008 (ITL): shed a unit of speculative k (a mispredicting
    draft stretches inter-token gaps)."""
    code = str(evidence.get("code", ""))
    if code == "SNT007":
        chunk = int(state.prefill_chunk)
        if chunk <= ctx.min_prefill_chunk:
            return ActionResult(rejected="prefill chunk already minimal")
        new = max(ctx.min_prefill_chunk, chunk // 2)
        return ActionResult(knobs={"prefill_chunk": new},
                            expected={"prefill_chunk": new})
    k_lo, _ = ctx.spec_k_bounds
    if state.spec_k <= k_lo:
        return ActionResult(rejected="spec k already at lower bound")
    return ActionResult(knobs={"spec_k": state.spec_k - 1},
                        expected={"spec_k": state.spec_k - 1})


def tune_pool(ctx: PilotContext, state: PilotState,
              evidence: Dict) -> ActionResult:
    """SNT009 / burn: grow the KV page pool 25% within the HBM bound —
    more admitted concurrency drains the queue-wait tail."""
    n = int(state.n_pages)
    if n <= 0:
        return ActionResult(rejected="pool size unknown (n_pages=0)")
    grown = min(int(ctx.max_pages), n + max(1, n // 4))
    if grown == n:
        return ActionResult(rejected="pool already at the HBM bound")
    return ActionResult(knobs={"n_pages": grown},
                        expected={"n_pages": grown})


def tune_spec_k(ctx: PilotContext, state: PilotState,
                evidence: Dict) -> ActionResult:
    """Steer spec k by the per-temperature acceptance buckets: any bucket
    collapsing means wasted draft work (k down); uniformly high
    acceptance leaves tokens on the table (k up)."""
    buckets = {
        str(b): float(r)
        for b, r in (evidence.get("acceptance_by_temperature") or {}).items()
        if isinstance(r, (int, float)) and math.isfinite(float(r))}
    if not buckets:
        return ActionResult(rejected="no acceptance buckets measured")
    k_lo, k_hi = ctx.spec_k_bounds
    k = int(state.spec_k)
    if min(buckets.values()) < 0.25 and k > k_lo:
        return ActionResult(knobs={"spec_k": k - 1},
                            expected={"spec_k": k - 1, "buckets": buckets})
    if min(buckets.values()) > 0.90 and k < k_hi:
        return ActionResult(knobs={"spec_k": k + 1},
                            expected={"spec_k": k + 1, "buckets": buckets})
    return ActionResult(rejected="acceptance in band; no k change")
