"""The Controller: sensor streams in, guarded knob rollouts out (PyTorch
port of the JAX package's ``pilot/controller.py``).

The ONE actuator over plan/serve knobs. It
ingests the stack's sensor surfaces — sentry :class:`Finding`s, SLO
reports (burn rates + per-temperature acceptance buckets), measured-wire
attribution, replayed flight records — normalizes each to a trigger
code, and consults the :class:`~autodist_tpu_torch.pilot.policy.PolicyTable`.
When a rule matches, the decision runs the full guarded pipeline:

1. **episode gate** — one action per trigger class per episode
   (sentry-style: the episode latches on first fire and re-arms via
   :meth:`rearm` when the underlying signal recovers);
2. **cooldown + rate limit** — a re-armed trigger inside the per-trigger
   cooldown, or any trigger past the global actions-per-window budget,
   is suppressed (counted, logged, never acted) — the controller cannot
   flap no matter how the metric oscillates;
3. **write-ahead journal** — the ``pending`` DecisionRecord (trigger
   evidence, chosen action, full before/after states, the action's
   expected delta) is fsync'd BEFORE any knob deploys;
4. **guarded rollout** — baseline canary, ``rollout.apply`` (drain →
   elastic rebuild for train; ``rolling_upgrade()`` for serve), canary
   again; a measured regression beyond the bound rolls the old state
   back bit-exactly and journals ``rolled_back``, otherwise
   ``committed`` with the measured delta;
5. **crash consistency** — a controller that dies mid-rollout (a
   BaseException tears through; a real death runs nothing at all)
   leaves the ``pending`` line as the recovery contract:
   :meth:`recover` on the next boot force-applies the journaled
   ``knobs_before`` through the rollout path, so the fleet lands on the
   complete old state — old or new, never a torn mix.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from autodist_tpu_torch.pilot import journal as journal_mod
from autodist_tpu_torch.pilot.journal import (
    VERDICT_COMMITTED,
    VERDICT_PENDING,
    VERDICT_REJECTED,
    VERDICT_ROLLED_BACK,
    DecisionJournal,
    DecisionRecord,
)
from autodist_tpu_torch.pilot.policy import PolicyTable, default_policy_table
from autodist_tpu_torch.pilot.rollout import Rollout
from autodist_tpu_torch.pilot.state import PilotState, PilotStateStore
from autodist_tpu_torch.utils import logging


@dataclass
class ControllerConfig:
    """The guard rails. Defaults are production-shaped; tests and the
    selftest tighten them."""

    # measured-vs-priced wire divergence that opens a wire_drift episode
    drift_bound: float = 0.25
    # SLO error-budget burn rate that opens an slo_burn episode
    burn_bound: float = 1.0
    # a finite per-temperature acceptance below/above this band opens an
    # acceptance_drift episode
    acceptance_band: tuple = (0.25, 0.90)
    # per-trigger cooldown between ACTIONS (rule.cooldown_s overrides)
    cooldown_s: float = 300.0
    # global rate limiter: at most this many actions per window
    max_actions_per_window: int = 6
    rate_window_s: float = 3600.0
    # canary: measurement count and the lower-is-better regression bound
    canary_window: int = 4
    canary_regression_frac: float = 0.05


class Controller:
    """See module docstring. ``clock`` is monotonic-like (cooldowns and
    the rate window); the journal stamps wall time separately."""

    def __init__(
        self,
        store: PilotStateStore,
        journal: DecisionJournal,
        actions: Dict[str, Callable],
        rollout: Rollout,
        policy: Optional[PolicyTable] = None,
        config: Optional[ControllerConfig] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.store = store
        self.journal = journal
        self.actions = dict(actions)
        self.rollout = rollout
        self.policy = policy or default_policy_table()
        self.config = config or ControllerConfig()
        self.clock = clock
        self.state: PilotState = store.load() or PilotState()
        self._episodes: Dict[str, bool] = {}       # trigger -> latched
        self._last_action: Dict[str, float] = {}   # trigger -> clock()
        self._action_times: deque = deque()        # global rate window
        self.stats: Dict[str, int] = {
            "ingested": 0, "episode_gated": 0, "cooldown_suppressed": 0,
            "rate_limited": 0, "acted": 0, "committed": 0,
            "rolled_back": 0, "rejected": 0, "recovered": 0,
        }

    # ------------------------------------------------------------ recovery
    def recover(self) -> List[DecisionRecord]:
        """Finish what a dead controller left half-done: every decision
        whose newest journal line is still ``pending`` had its rollout
        interrupted — force the journaled ``knobs_before`` state back
        through the rollout path and journal the rollback. Idempotent;
        call once at boot before ingesting anything."""
        out: List[DecisionRecord] = []
        for rec in journal_mod.latest_decisions(self.journal.path).values():
            if rec.verdict != VERDICT_PENDING:
                continue
            old = PilotState.from_json(rec.knobs_before)
            new = PilotState.from_json(rec.knobs_after)
            logging.warning(
                "pilot recover: decision %s (%s -> %s) was pending at "
                "boot; rolling the fleet back to state v%d",
                rec.decision_id, rec.trigger, rec.action, old.version)
            self.rollout.apply(new, old)
            self.state = old
            done = DecisionRecord(
                decision_id=rec.decision_id, trigger=rec.trigger,
                code=rec.code, action=rec.action,
                verdict=VERDICT_ROLLED_BACK,
                knobs_before=rec.knobs_before, knobs_after=rec.knobs_after,
                note="controller died mid-rollout; recovered to the "
                     "last-good state")
            self.journal.append(done)
            self.stats["recovered"] += 1
            out.append(done)
        return out

    # ------------------------------------------------------------- ingest
    def ingest_finding(self, finding: Any) -> Optional[DecisionRecord]:
        """An obs sentry :class:`Finding` (or any object/dict with
        ``code``/``value``/``message``)."""
        if isinstance(finding, dict):
            code = str(finding.get("code", ""))
            value = float(finding.get("value", 0.0) or 0.0)
            detail = {k: v for k, v in finding.items() if k != "code"}
        else:
            code = str(getattr(finding, "code", ""))
            value = float(getattr(finding, "value", 0.0) or 0.0)
            detail = {"message": getattr(finding, "message", ""),
                      "step": getattr(finding, "step", None)}
        return self._maybe_act(code, value, detail)

    def ingest_measured_wire(self, measured_s: float, priced_s: float,
                             detail: Optional[Dict] = None,
                             ) -> Optional[DecisionRecord]:
        """A measured-vs-priced pair (obs/attrib MeasuredWire totals, or
        a profiler step wall vs the calibrated prediction). Opens a
        wire_drift episode when the relative divergence exceeds the
        bound."""
        self.stats["ingested"] += 1
        if not (priced_s > 0):
            return None
        drift = abs(measured_s - priced_s) / priced_s
        if drift <= self.config.drift_bound:
            self.rearm("wire_drift")
            return None
        ev = {"measured_s": measured_s, "priced_s": priced_s,
              "drift": drift, **(detail or {})}
        return self._maybe_act("wire_drift", drift, ev, counted=False)

    def ingest_slo_report(self, report: Dict) -> List[DecisionRecord]:
        """An ``SLOTracker.report()`` dict: burn rates past the bound and
        per-temperature acceptance out of band become triggers."""
        out: List[DecisionRecord] = []
        burn = dict(report.get("burn_rate") or {})
        rates = [float(v) for k, v in burn.items()
                 if k in ("fast", "slow")]
        if rates and max(rates) > self.config.burn_bound:
            rec = self._maybe_act("burn_rate", max(rates),
                                  {"burn_rate": burn})
            if rec:
                out.append(rec)
        elif rates:
            self.rearm("slo_burn")
        measured = dict(report.get("measured") or {})
        buckets = {
            str(b): float(r) for b, r in
            (measured.get("acceptance_by_temperature") or {}).items()
            if isinstance(r, (int, float)) and r == r}  # finite only
        lo, hi = self.config.acceptance_band
        if buckets and (min(buckets.values()) < lo
                        or min(buckets.values()) > hi):
            rec = self._maybe_act(
                "acceptance_drift", min(buckets.values()),
                {"acceptance_by_temperature": buckets})
            if rec:
                out.append(rec)
        elif buckets:
            self.rearm("acceptance_drift")
        return out

    def ingest_flight_records(self, records: List[Dict],
                              ) -> List[DecisionRecord]:
        """Replay a flight-record window (``obs.recorder.read_records``):
        sentry events become triggers — the offline/catch-up path when
        the controller wasn't subscribed live."""
        out = []
        for r in records:
            if r.get("kind") == "sentry" and r.get("code"):
                rec = self.ingest_finding(r)
                if rec:
                    out.append(rec)
        return out

    def rearm(self, trigger: str) -> None:
        """Recovery signal for a trigger class: the episode closes, so
        the NEXT excursion may act again (after cooldown)."""
        self._episodes.pop(trigger, None)

    # --------------------------------------------------------------- core
    def _maybe_act(self, code: str, value: float, evidence: Dict,
                   counted: bool = True) -> Optional[DecisionRecord]:
        if counted:
            self.stats["ingested"] += 1
        rule = self.policy.rule_for_code(code)
        if rule is None:
            return None
        if self._episodes.get(rule.trigger):
            self.stats["episode_gated"] += 1
            return None
        # Latch the episode NOW: whatever happens below (action, typed
        # rejection, suppression), this excursion is handled exactly once
        # until the signal re-arms.
        self._episodes[rule.trigger] = True
        now = self.clock()
        cooldown = (rule.cooldown_s if rule.cooldown_s is not None
                    else self.config.cooldown_s)
        last = self._last_action.get(rule.trigger)
        if last is not None and now - last < cooldown:
            self.stats["cooldown_suppressed"] += 1
            logging.info("pilot: %s (%s) suppressed by cooldown "
                         "(%.0fs of %.0fs)", rule.trigger, code,
                         now - last, cooldown)
            return None
        while (self._action_times
               and now - self._action_times[0] > self.config.rate_window_s):
            self._action_times.popleft()
        if len(self._action_times) >= self.config.max_actions_per_window:
            self.stats["rate_limited"] += 1
            logging.warning(
                "pilot: %s (%s) suppressed by the rate limiter (%d "
                "actions in the last %.0fs)", rule.trigger, code,
                len(self._action_times), self.config.rate_window_s)
            return None
        self._last_action[rule.trigger] = now
        self._action_times.append(now)
        self.stats["acted"] += 1
        return self._decide(rule, code, value, evidence)

    def _decide(self, rule, code: str, value: float,
                evidence: Dict) -> DecisionRecord:
        fn = self.actions.get(rule.action)
        decision_id = self.journal.next_id()
        ev = {"value": value, **evidence}
        if fn is None:
            self.stats["rejected"] += 1
            return self.journal.append(DecisionRecord(
                decision_id=decision_id, trigger=rule.trigger, code=code,
                action=rule.action, verdict=VERDICT_REJECTED, evidence=ev,
                note=f"no implementation wired for action {rule.action}"))
        try:
            result = fn(self.state, ev)
        except Exception as e:  # noqa: BLE001 - an action must never kill
            self.stats["rejected"] += 1
            logging.warning("pilot action %s raised: %s", rule.action, e)
            return self.journal.append(DecisionRecord(
                decision_id=decision_id, trigger=rule.trigger, code=code,
                action=rule.action, verdict=VERDICT_REJECTED, evidence=ev,
                note=f"action raised: {type(e).__name__}: {e}"))
        if result is None or result.is_rejected:
            self.stats["rejected"] += 1
            note = result.rejected if result is not None else "no proposal"
            logging.warning("pilot: %s -> %s REJECTED: %s",
                            rule.trigger, rule.action, note)
            return self.journal.append(DecisionRecord(
                decision_id=decision_id, trigger=rule.trigger, code=code,
                action=rule.action, verdict=VERDICT_REJECTED, evidence=ev,
                expected=dict(result.expected) if result else {},
                note=note))
        old = self.state
        new = old.with_knobs(**result.knobs)
        pending = DecisionRecord(
            decision_id=decision_id, trigger=rule.trigger, code=code,
            action=rule.action, verdict=VERDICT_PENDING, evidence=ev,
            knobs_before=old.to_json(), knobs_after=new.to_json(),
            expected=dict(result.expected))
        self.journal.append(pending)  # write-ahead: fsync'd before deploy
        return self._roll_out(rule, pending, old, new)

    def _roll_out(self, rule, pending: DecisionRecord, old: PilotState,
                  new: PilotState) -> DecisionRecord:
        baseline: Dict[str, float] = {}
        if rule.canary:
            baseline = dict(self.rollout.canary(self.config.canary_window))
        try:
            self.rollout.apply(old, new)
        except Exception as e:  # noqa: BLE001 - deploy failure = rollback
            logging.warning("pilot rollout of %s failed (%s); rolling "
                            "back", pending.decision_id, e)
            self.rollout.apply(new, old)
            self.state = old
            self.stats["rolled_back"] += 1
            return self.journal.append(DecisionRecord(
                decision_id=pending.decision_id, trigger=pending.trigger,
                code=pending.code, action=pending.action,
                verdict=VERDICT_ROLLED_BACK,
                knobs_before=pending.knobs_before,
                knobs_after=pending.knobs_after,
                note=f"apply failed: {type(e).__name__}: {e}"))
        measured: Dict[str, float] = {}
        if rule.canary:
            measured = dict(self.rollout.canary(self.config.canary_window))
            frac = self.config.canary_regression_frac
            regressed = sorted(
                k for k, b in baseline.items()
                if k in measured and b == b and measured[k] == measured[k]
                and measured[k] > b * (1.0 + frac) + 1e-12)
            if regressed:
                logging.warning(
                    "pilot canary REGRESSED on %s (%s); rolling back to "
                    "state v%d", regressed, pending.decision_id,
                    old.version)
                self.rollout.apply(new, old)
                self.state = old
                self.stats["rolled_back"] += 1
                return self.journal.append(DecisionRecord(
                    decision_id=pending.decision_id,
                    trigger=pending.trigger, code=pending.code,
                    action=pending.action, verdict=VERDICT_ROLLED_BACK,
                    knobs_before=pending.knobs_before,
                    knobs_after=pending.knobs_after,
                    expected=pending.expected,
                    measured={"baseline": baseline, "canary": measured,
                              "regressed_on": regressed}))
        self.state = new
        self.stats["committed"] += 1
        return self.journal.append(DecisionRecord(
            decision_id=pending.decision_id, trigger=pending.trigger,
            code=pending.code, action=pending.action,
            verdict=VERDICT_COMMITTED,
            knobs_before=pending.knobs_before,
            knobs_after=pending.knobs_after,
            expected=pending.expected,
            measured={"baseline": baseline, "canary": measured}))
