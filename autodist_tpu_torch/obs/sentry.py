"""Online anomaly sentry over the flight-record stream (the port's copy of
the JAX package's ``obs/sentry.py``: the same codes, thresholds and
messages).

The flight recorder (:mod:`autodist_tpu_torch.obs.recorder`) answers "what
happened"; the sentry answers "is something going wrong *right now*". It
watches per-step telemetry — loss, grad/update norms, step wall time, HBM
high-water, per-host straggler scores — and the serving stream (TTFT, ITL,
burn rate per replica), and emits a stable, greppable **verdict code** the
moment a stream turns anomalous:

======== ==============================================================
Code     Condition
======== ==============================================================
SNT001   non-finite loss (NaN/Inf)
SNT002   non-finite gradient / update norm
SNT003   loss spike: z-score vs the rolling window exceeds threshold
SNT004   step-time regression: consecutive steps above ratio x rolling
         median
SNT005   HBM high-water creep above the post-warmup baseline
SNT006   straggler host: step-time p50 diverges from the fleet median
SNT007   serve TTFT regression vs the rolling median (per replica)
SNT008   serve decode-throughput/ITL regression vs the rolling median
SNT009   serve shed/error burn rate above the SLO budget
======== ==============================================================

Each finding fires **once per episode** (the episode re-arms when the
stream recovers), is logged with its code, appended to the flight record
as a ``sentry`` event, counted in ``obs_sentry_*`` metrics through the
port's :class:`~autodist_tpu_torch.metrics.MetricsRegistry`, and — when a
:class:`~autodist_tpu_torch.ft.heartbeat.HealthMonitor` is attached —
**escalated**: the offending host is promoted to SUSPECT scrutiny the same
way a silent one is (``HealthMonitor.escalate``).
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.utils import logging

__all__ = ["CODES", "Finding", "Sentry", "SentryConfig"]

#: code -> one-line description (the module docstring's table).
CODES: Dict[str, str] = {
    "SNT001": "non-finite loss (NaN/Inf)",
    "SNT002": "non-finite gradient/update norm",
    "SNT003": "loss spike vs rolling window (z-score)",
    "SNT004": "step-time regression vs rolling median",
    "SNT005": "HBM high-water creep above baseline",
    "SNT006": "straggler host: step-time diverges from fleet median",
    "SNT007": "serve TTFT regression vs rolling median (per replica)",
    "SNT008": "serve decode-throughput/ITL regression vs rolling median",
    "SNT009": "serve shed/error burn rate above the SLO budget",
}


@dataclass
class SentryConfig:
    """Detection thresholds (the JAX package's defaults). They are
    deliberately conservative: zero findings on a healthy stream matters
    as much as a seeded anomaly tripping its code."""

    window: int = 64              # rolling history length (steps)
    min_history: int = 8          # observations before spike checks arm
    loss_z_threshold: float = 8.0     # SNT003: z vs rolling mean/std
    # SNT003 absolute-change floor: a spike must ALSO exceed this fraction
    # of |rolling mean| (min 1e-6) — a flat window's std collapses toward
    # zero and a pure z-score would turn float noise into a verdict.
    loss_spike_min_fraction: float = 0.05
    step_time_ratio: float = 2.0      # SNT004: step > ratio x rolling median
    step_time_consecutive: int = 3    # SNT004: consecutive regressed steps
    hbm_growth_fraction: float = 0.05  # SNT005: growth over baseline
    hbm_min_history: int = 8           # SNT005: baseline sample size
    straggler_threshold: float = 1.5   # SNT006: score bar (aggregate's)
    # Serving codes. TTFT/ITL
    # regressions mirror SNT004's shape — consecutive observations above
    # ratio x the per-replica rolling median — so a single slow request
    # (compile, GC pause) is never a verdict.
    serve_min_history: int = 8         # SNT007/008: per-replica history
    ttft_ratio: float = 2.0            # SNT007: TTFT > ratio x median
    ttft_consecutive: int = 3
    ttft_min_s: float = 0.1            # SNT007: absolute floor (see below)
    itl_ratio: float = 2.0             # SNT008: ITL > ratio x median
    itl_consecutive: int = 3
    # Absolute floors (the SNT003 precedent): a regressed value must ALSO
    # exceed the floor — serving latencies at millisecond scale have
    # ratio-noise (a prefill-heavy tick doubles a 2ms ITL) that is not an
    # incident anyone should be paged for.
    itl_min_s: float = 0.05
    burn_rate_threshold: float = 2.0   # SNT009: fast-window budget burn


@dataclass
class Finding:
    """One tripped verdict."""

    code: str
    message: str
    value: float = 0.0
    step: Optional[int] = None
    process_id: Optional[int] = None
    t: float = field(default_factory=time.time)

    def to_dict(self) -> dict:
        return {
            "code": self.code, "message": self.message, "value": self.value,
            "step": self.step, "process_id": self.process_id, "t": self.t,
        }


def _finite(x: Optional[float]) -> bool:
    return x is not None and math.isfinite(float(x))


class Sentry:
    """Streaming detector: call :meth:`observe_step` with whatever subset
    of signals a step produced; call :meth:`observe_scores` with the
    aggregator's straggler scores; call :meth:`observe_serve` with a
    replica's serving signals. Thread-compat (single producer per
    instance)."""

    def __init__(
        self,
        config: Optional[SentryConfig] = None,
        registry: Optional[M.MetricsRegistry] = None,
        monitor=None,
        recorder=None,
        process_id: Optional[int] = None,
    ):
        self.config = config or SentryConfig()
        self.monitor = monitor
        self.recorder = recorder
        self.process_id = (ENV.AUTODIST_PROCESS_ID.val
                           if process_id is None else int(process_id))
        self.findings: List[Finding] = []
        w = max(4, int(self.config.window))
        self._loss: deque = deque(maxlen=w)
        self._times: deque = deque(maxlen=w)
        self._hbm_baseline: List[float] = []
        self._slow_streak = 0
        self._episodes: set = set()   # active (code[, pid]) incidents
        self._n = 0
        # Serving streams, keyed per replica id (-1 = unattributed):
        # rolling history + regression streaks for SNT007/SNT008.
        self._ttft: Dict[int, deque] = {}
        self._itl: Dict[int, deque] = {}
        self._ttft_streak: Dict[int, int] = {}
        self._itl_streak: Dict[int, int] = {}

        reg = registry or M.registry
        self._reg = reg
        self._c_findings = reg.counter("obs_sentry_findings_total")
        self._g_loss_z = reg.gauge("obs_sentry_loss_z")
        self._g_time_ratio = reg.gauge("obs_sentry_step_time_ratio")
        self._g_hbm_growth = reg.gauge("obs_sentry_hbm_growth")
        self._g_last = reg.gauge("obs_sentry_last_finding_t")

    # ------------------------------------------------------------- emission
    def _emit(self, code: str, message: str, value: float = 0.0,
              step: Optional[int] = None,
              process_id: Optional[int] = None,
              escalate: bool = True) -> Finding:
        pid = self.process_id if process_id is None else int(process_id)
        f = Finding(code=code, message=message, value=float(value),
                    step=step, process_id=pid)
        self.findings.append(f)
        self._c_findings.inc()
        self._reg.counter(f"obs_sentry_{code.lower()}_total").inc()
        self._g_last.set(f.t)
        # The greppable line: `grep SNT0 <log>` finds every verdict.
        logging.warning("%s: %s (value=%.4g, step=%s, host=%d)",
                        code, message, f.value, step, pid)
        if self.recorder is not None:
            try:
                self.recorder.record_event(
                    "sentry", code=code, message=message, value=f.value,
                    step=step, process_id=pid)
            except Exception:  # noqa: BLE001 - telemetry never fatal
                pass
        if self.monitor is not None and escalate:
            try:
                self.monitor.escalate(pid, reason=f"{code}: {message}")
            except Exception:  # noqa: BLE001 - monitor may be stopping
                logging.warning("sentry escalation failed", exc_info=True)
        return f

    def _fire_once(self, key, code: str, message: str, **kw) -> bool:
        """Once-per-episode gate; :meth:`_clear` re-arms on recovery."""
        if key in self._episodes:
            return False
        self._episodes.add(key)
        self._emit(code, message, **kw)
        return True

    def _clear(self, key) -> None:
        self._episodes.discard(key)

    # ------------------------------------------------------------- observing
    def observe_step(
        self,
        step: Optional[int] = None,
        loss: Optional[float] = None,
        step_time_s: Optional[float] = None,
        hbm_bytes: Optional[float] = None,
        grad_norm: Optional[float] = None,
        update_norm: Optional[float] = None,
    ) -> List[Finding]:
        """Feed one step's signals (any subset); returns the findings this
        observation tripped (possibly empty)."""
        cfg = self.config
        before = len(self.findings)
        self._n += 1

        # ---- SNT001 / SNT003: loss stream
        if loss is not None:
            loss = float(loss)
            if not math.isfinite(loss):
                # value keeps the raw non-finite loss (sign included);
                # JSONL round-trips NaN/Infinity through python json.
                self._fire_once("SNT001", "SNT001",
                                f"non-finite loss {loss!r}", value=loss,
                                step=step)
            else:
                self._clear("SNT001")
                if len(self._loss) >= cfg.min_history:
                    hist = np.asarray(self._loss, np.float64)
                    mean, std = float(hist.mean()), float(hist.std())
                    delta = loss - mean
                    floor = max(1e-6,
                                cfg.loss_spike_min_fraction * abs(mean))
                    # Zero-std window (flat/deterministic loss): only a
                    # change past the absolute floor counts as a spike —
                    # never a bare float-noise uptick.
                    z = (delta / std if std > 1e-12
                         else (float("inf") if delta > floor else 0.0))
                    self._g_loss_z.set(min(z, 1e9))
                    if z > cfg.loss_z_threshold and delta > floor:
                        self._fire_once(
                            "SNT003", "SNT003",
                            f"loss spike: {loss:.4g} is z={min(z, 1e9):.1f} "
                            f"above the rolling window (threshold "
                            f"{cfg.loss_z_threshold})",
                            value=min(z, 1e9), step=step)
                    elif z < cfg.loss_z_threshold / 2:
                        self._clear("SNT003")
                self._loss.append(loss)

        # ---- SNT002: gradient / update norms
        norms_seen = [("grad_norm", grad_norm), ("update_norm", update_norm)]
        bad = [(k, v) for k, v in norms_seen
               if v is not None and not math.isfinite(float(v))]
        if bad:
            k, v = bad[0]
            self._fire_once("SNT002", "SNT002",
                            f"non-finite {k} {float(v)!r}", step=step)
        elif any(v is not None for _, v in norms_seen):
            self._clear("SNT002")

        # ---- SNT004: step-time regression
        if step_time_s is not None and step_time_s > 0:
            step_time_s = float(step_time_s)
            if len(self._times) >= cfg.min_history:
                med = float(np.median(np.asarray(self._times, np.float64)))
                ratio = step_time_s / med if med > 0 else 0.0
                self._g_time_ratio.set(ratio)
                if ratio > cfg.step_time_ratio:
                    self._slow_streak += 1
                    if self._slow_streak >= cfg.step_time_consecutive:
                        self._fire_once(
                            "SNT004", "SNT004",
                            f"step time regressed: {step_time_s * 1e3:.1f}ms is "
                            f"{ratio:.2f}x the rolling median "
                            f"({med * 1e3:.1f}ms) for {self._slow_streak} "
                            f"consecutive steps", value=ratio, step=step)
                else:
                    self._slow_streak = 0
                    self._clear("SNT004")
            self._times.append(step_time_s)

        # ---- SNT005: HBM high-water creep
        if hbm_bytes is not None and hbm_bytes > 0:
            hbm_bytes = float(hbm_bytes)
            if len(self._hbm_baseline) < cfg.hbm_min_history:
                self._hbm_baseline.append(hbm_bytes)
            else:
                base = float(np.median(self._hbm_baseline))
                growth = (hbm_bytes - base) / base if base > 0 else 0.0
                self._g_hbm_growth.set(growth)
                if growth > cfg.hbm_growth_fraction:
                    self._fire_once(
                        "SNT005", "SNT005",
                        f"HBM high-water creep: {hbm_bytes / 2**30:.2f} GiB is "
                        f"{growth * 100:.1f}% above the post-warmup baseline "
                        f"({base / 2**30:.2f} GiB)", value=growth, step=step)
                elif growth < cfg.hbm_growth_fraction / 2:
                    self._clear("SNT005")

        return self.findings[before:]

    def observe_scores(self, scores: Dict[int, float],
                       step: Optional[int] = None) -> List[Finding]:
        """Feed the aggregator's per-host straggler scores
        (``HostAggregator.straggler_scores()``); SNT006 fires once per
        host per straggle episode."""
        before = len(self.findings)
        for pid, score in scores.items():
            key = ("SNT006", int(pid))
            if score > self.config.straggler_threshold:
                self._fire_once(
                    key, "SNT006",
                    f"host {pid} is a straggler: step-time p50 is "
                    f"{score:.2f}x the fleet median", value=score, step=step,
                    process_id=pid)
            else:
                self._clear(key)
        return self.findings[before:]

    def observe_serve(
        self,
        step: Optional[int] = None,
        ttft_s: Optional[float] = None,
        itl_s: Optional[float] = None,
        burn_rate: Optional[float] = None,
        replica_id: Optional[int] = None,
    ) -> List[Finding]:
        """Feed one serving observation (any subset): delivered TTFT and
        ITL attributed to ``replica_id`` (SNT007/SNT008 — once per
        episode *per replica*, escalated into the attached monitor so the
        router demotes the replica the way SNT006 demotes hosts), and the
        SLO tracker's fast-window burn rate (SNT009 — escalated only when
        attributed to a replica; a fleet-level burn has no single host to
        demote)."""
        cfg = self.config
        before = len(self.findings)
        rid = -1 if replica_id is None else int(replica_id)
        w = max(4, int(cfg.window))

        def _regress(value, hist: Dict[int, deque],
                     streak: Dict[int, int], code: str, what: str,
                     ratio_bar: float, consecutive: int,
                     min_s: float) -> None:
            series = hist.setdefault(rid, deque(maxlen=w))
            key = (code, rid)
            value = float(value)
            if len(series) >= cfg.serve_min_history:
                med = float(np.median(np.asarray(series, np.float64)))
                ratio = value / med if med > 0 else 0.0
                if ratio > ratio_bar and value > min_s:
                    streak[rid] = streak.get(rid, 0) + 1
                    if streak[rid] >= consecutive:
                        # process_id is ALWAYS rid (-1 when unattributed):
                        # letting it default would stamp the sentry's own
                        # host id (0) on a fleet-level finding, and a
                        # router consumer would demote real replica 0.
                        self._fire_once(
                            key, code,
                            f"replica {rid} {what} regressed: "
                            f"{value * 1e3:.1f}ms is {ratio:.2f}x the rolling "
                            f"median ({med * 1e3:.1f}ms) for {streak[rid]} "
                            f"consecutive requests", value=ratio, step=step,
                            process_id=rid,
                            escalate=replica_id is not None)
                else:
                    streak[rid] = 0
                    self._clear(key)
            series.append(value)

        if ttft_s is not None and ttft_s > 0:
            _regress(ttft_s, self._ttft, self._ttft_streak, "SNT007",
                     "TTFT", cfg.ttft_ratio, cfg.ttft_consecutive,
                     cfg.ttft_min_s)
        if itl_s is not None and itl_s > 0:
            _regress(itl_s, self._itl, self._itl_streak, "SNT008",
                     "inter-token latency", cfg.itl_ratio,
                     cfg.itl_consecutive, cfg.itl_min_s)
        if burn_rate is not None:
            burn_rate = float(burn_rate)
            if replica_id is None:
                # The gauge is the FLEET burn: per-replica calls must not
                # overwrite it (the last replica's 0.0 would mask a
                # fleet-wide 5x burn from every dashboard).
                self._reg.gauge("obs_sentry_burn_rate").set(burn_rate)
            key = ("SNT009", rid)
            if burn_rate > cfg.burn_rate_threshold:
                self._fire_once(
                    key, "SNT009",
                    f"shed/error burn rate {burn_rate:.2f}x the SLO error "
                    f"budget (threshold {cfg.burn_rate_threshold}x"
                    f"{'' if replica_id is None else f', replica {rid}'})",
                    value=burn_rate, step=step, process_id=rid,
                    escalate=replica_id is not None)
            elif burn_rate < cfg.burn_rate_threshold / 2:
                self._clear(key)
        return self.findings[before:]

    def reset_serve_episodes(self, replica_id: int) -> None:
        """Re-arm one replica's serving episodes (SNT007/008/009) and
        streaks. The router calls this when a demotion cooldown expires:
        while demoted the replica served no traffic, so nothing could
        take the recovery path that normally re-arms the episode — and a
        STILL-sick replica would otherwise be re-admitted permanently
        (the episode gate swallowing every later verdict)."""
        rid = int(replica_id)
        for code in ("SNT007", "SNT008", "SNT009"):
            self._clear((code, rid))
        self._ttft_streak.pop(rid, None)
        self._itl_streak.pop(rid, None)

    # --------------------------------------------------------------- queries
    def codes(self) -> List[str]:
        return sorted({f.code for f in self.findings})

    def summary(self) -> dict:
        return {
            "findings": len(self.findings),
            "codes": self.codes(),
            "observed_steps": self._n,
        }
