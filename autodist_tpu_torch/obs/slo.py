"""Serving SLOs: declarative targets, rolling percentiles, burn rates (the
port's copy of the JAX package's ``obs/slo.py``: the same spec, the same
arithmetic, the same ``slo_report``).

A declarative :class:`SLOSpec` (the latency/error targets a deployment
promises) and an :class:`SLOTracker` that keeps rolling-window percentiles
of the request-level signals — time to first token (TTFT), inter-token
latency (ITL), queue wait — plus good/bad event accounting with
**multi-window burn rates** against the error budget, rendered as one JSON
``slo_report``:

- the :class:`~autodist_tpu_torch.serve.batcher.ContinuousBatcher` feeds a
  tracker from its retire path (TTFT, ITL, queue wait, outcome) and its
  admission edge (sheds), so a single-engine server reports its own SLO
  position (``GET /slo``);
- measured percentiles and burn rates publish as ``slo_*`` gauges through
  the port's :class:`~autodist_tpu_torch.metrics.MetricsRegistry`, so
  ``GET /metrics`` carries them;
- :func:`replay_flight_records` rebuilds a tracker from the flight
  recorder's ``serve``/``request`` records and ``shed`` events, so the SLO
  position of a run that is already dead is computable postmortem.

Burn rate is the bad-event fraction over a window divided by the error
budget (1.0 = burning exactly the budget). Two windows — fast and slow —
are both reported; the sentry's SNT009 fires on the fast one.
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from autodist_tpu_torch import metrics as M

__all__ = ["SLOSpec", "SLOTracker", "json_safe", "replay_flight_records"]


@dataclass(frozen=True)
class SLOSpec:
    """Declarative serving SLO: the targets a deployment promises.

    Latency targets are seconds; ``error_budget`` is the allowed bad
    fraction (errors + sheds over all terminal outcomes) the availability
    target implies; windows are seconds of rolling history. Defaults are
    interactive-chat-shaped — deployments pass their own.
    """

    name: str = "serve"
    ttft_p50_s: float = 1.0        # time to first token
    ttft_p99_s: float = 5.0
    itl_p50_s: float = 0.2         # inter-token latency (decode cadence)
    itl_p99_s: float = 1.0
    queue_wait_p99_s: float = 2.0
    availability: float = 0.99     # fraction of requests that must succeed
    window_s: float = 300.0        # rolling percentile window
    burn_fast_window_s: float = 60.0
    burn_slow_window_s: float = 600.0

    @property
    def error_budget(self) -> float:
        return max(1e-9, 1.0 - self.availability)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, doc: dict) -> "SLOSpec":
        known = {k: doc[k] for k in doc
                 if k in cls.__dataclass_fields__}  # type: ignore[attr-defined]
        return cls(**known)


@dataclass
class _Series:
    """One rolling (t, value, weight) series bounded by time window and
    count. Weights attribute a summary sample to the events it stands
    for — a request's mean ITL carries ``n_tokens - 1`` weight so
    percentiles are per *token*, not per request (multi-token
    speculative-decode steps must not let short requests dominate)."""

    window_s: float
    points: deque = field(default_factory=lambda: deque(maxlen=4096))

    def add(self, t: float, v: float, w: float = 1.0) -> None:
        self.points.append((float(t), float(v), float(w)))

    def values(self, now: float) -> List[tuple]:
        """(value, weight) pairs inside the window."""
        cutoff = now - self.window_s
        return [(v, w) for t, v, w in self.points if t >= cutoff]


class SLOTracker:
    """Streaming SLO accountant (thread-safe; producers on scheduler /
    router threads, readers on HTTP / sentry threads).

    Feed request-level signals with :meth:`observe`; read the position
    with :meth:`report` (the ``slo_report`` JSON), :meth:`percentile`, or
    :meth:`burn_rates`. Gauges ``slo_*`` publish on every report through
    the shared registry.
    """

    def __init__(self, spec: Optional[SLOSpec] = None,
                 registry: Optional[M.MetricsRegistry] = None,
                 clock=time.monotonic):
        self.spec = spec or SLOSpec()
        self.clock = clock
        self._lock = threading.Lock()
        w = self.spec.window_s
        self._ttft = _Series(w)
        # Cached/uncached TTFT split (prefix sharing, serve/prefix.py):
        # a hit-rate shift moves the blended percentile, so the report
        # carries both populations — an uncached (real-prefill)
        # regression stays visible even at a 95% hit rate.
        self._ttft_cached = _Series(w)
        self._ttft_uncached = _Series(w)
        self._itl = _Series(w)
        self._wait = _Series(w)
        # Terminal outcomes: (t, ok, shed) — the burn-rate stream.
        self._events: deque = deque(maxlen=16384)
        self._totals = {"requests": 0, "errors": 0, "sheds": 0}
        # Speculative-decode acceptance: rolling (t, accepted, proposed)
        # — acceptance_rate joins the slo_report so a burn/latency
        # verdict on a spec-decode replica always comes with its
        # acceptance context.
        self._spec: deque = deque(maxlen=4096)
        self._spec_totals = {"proposed": 0, "accepted": 0}
        # Acceptance split by temperature bucket (serve/sampling.py's
        # fixed bucket names): stochastic streams legitimately accept
        # fewer draft tokens than greedy ones, so a blended acceptance
        # dip must be attributable to traffic mix before the sentry
        # calls it sickness. Keyed by caller-supplied bucket string —
        # this module never imports the serve layer.
        self._spec_bucket: Dict[str, deque] = {}
        # Terminal-outcome stream mix: sampled (temperature > 0) vs
        # greedy requests, cumulative.
        self._stream_counts = {"sampled": 0, "greedy": 0}

        reg = registry or M.registry
        self._reg = reg
        self._g = {k: reg.gauge(f"slo_{k}") for k in (
            "ttft_p50_s", "ttft_p99_s", "itl_p50_s", "itl_p99_s",
            "queue_wait_p99_s", "availability", "error_rate",
            "acceptance_rate", "prefix_hit_rate",
            "burn_rate_fast", "burn_rate_slow",
            "compliant")}
        self._g_bucket: Dict[str, Any] = {}

    # --------------------------------------------------------------- feeding
    def observe(self, ttft_s: Optional[float] = None,
                itl_s: Optional[float] = None,
                queue_wait_s: Optional[float] = None,
                ok: Optional[bool] = None, shed: bool = False,
                itl_tokens: int = 1,
                spec_proposed: Optional[int] = None,
                spec_accepted: Optional[int] = None,
                spec_bucket: Optional[str] = None,
                cached: Optional[bool] = None,
                temperature: Optional[float] = None,
                t: Optional[float] = None) -> None:
        """Feed any subset of one request's signals. ``ok`` marks a
        terminal outcome (True = served within contract, False = error);
        ``shed`` marks a typed admission rejection (counts against the
        budget — a shed client did not get an answer). ``itl_tokens``
        weights the ITL sample by the inter-token gaps it summarizes
        (the request's token count minus one): ITL percentiles are
        computed per emitted TOKEN, so multi-token speculative-decode
        steps cannot fake latency wins by finishing short requests in
        one burst. ``spec_proposed``/``spec_accepted`` feed the rolling
        draft-acceptance window; with ``spec_bucket`` set the sample
        feeds ONLY that temperature bucket's window (callers feed the
        blended window with a separate un-bucketed call, so one round is
        never double-counted). ``cached`` attributes a TTFT sample to
        the cached-prefix or uncached (full-prefill) population — the
        split percentiles + ``prefix_hit_rate`` in the report; None
        (deployments without a prefix cache) feeds the blended series
        only. ``temperature`` attributes a terminal outcome to the
        sampled (> 0) or greedy stream population. ``t`` overrides the
        clock for replay."""
        now = self.clock() if t is None else float(t)
        with self._lock:
            if ttft_s is not None and math.isfinite(float(ttft_s)):
                self._ttft.add(now, ttft_s)
                if cached is not None:
                    (self._ttft_cached if cached
                     else self._ttft_uncached).add(now, ttft_s)
            if itl_s is not None and math.isfinite(float(itl_s)):
                self._itl.add(now, itl_s, max(int(itl_tokens), 1))
            if queue_wait_s is not None and math.isfinite(float(queue_wait_s)):
                self._wait.add(now, queue_wait_s)
            if spec_proposed is not None and int(spec_proposed) > 0:
                acc = min(max(int(spec_accepted or 0), 0),
                          int(spec_proposed))
                if spec_bucket:
                    self._spec_bucket.setdefault(
                        str(spec_bucket), deque(maxlen=4096)).append(
                            (now, acc, int(spec_proposed)))
                else:
                    self._spec.append((now, acc, int(spec_proposed)))
                    self._spec_totals["proposed"] += int(spec_proposed)
                    self._spec_totals["accepted"] += acc
            if ok is not None or shed:
                good = bool(ok) and not shed
                if temperature is not None:
                    self._stream_counts[
                        "sampled" if float(temperature) > 0.0
                        else "greedy"] += 1
                self._events.append((now, good, bool(shed)))
                self._totals["requests"] += 1
                if shed:
                    self._totals["sheds"] += 1
                elif not good:
                    self._totals["errors"] += 1

    # --------------------------------------------------------------- reading
    @staticmethod
    def _pct(values: List[tuple], p: float) -> float:
        """Weighted percentile over (value, weight) pairs. With all
        weights 1 this is EXACTLY ``np.percentile`` (the pre-weighting
        arithmetic — golden reports unchanged); with real weights each
        sample counts once per event it summarizes (per-token ITL)."""
        if not values:
            return float("nan")
        vs = np.asarray([v for v, _ in values], np.float64)
        ws = np.asarray([w for _, w in values], np.float64)
        if np.all(ws == 1.0):
            return float(np.percentile(vs, p))
        order = np.argsort(vs, kind="stable")
        vs, ws = vs[order], ws[order]
        # Identical to np.percentile('linear') over the weight-expanded
        # array, without materializing it: a sample of weight w is a run
        # of w repeated unit-rank points [left, right]; within a run the
        # value is constant, between adjacent runs interpolation is
        # linear — so each (left, v) and (right, v) pair anchors interp.
        right = np.cumsum(ws) - 1.0
        left = right - (ws - 1.0)
        xs = np.empty(2 * len(vs))
        xs[0::2], xs[1::2] = left, right
        ys = np.repeat(vs, 2)
        rank = (p / 100.0) * (float(np.sum(ws)) - 1.0)
        return float(np.interp(rank, xs, ys))

    def percentile(self, signal: str, p: float,
                   now: Optional[float] = None) -> float:
        """Rolling-window percentile of ``"ttft" | "itl" | "queue_wait"``
        (NaN while the window is empty)."""
        series = {"ttft": self._ttft, "itl": self._itl,
                  "queue_wait": self._wait}[signal]
        with self._lock:
            vals = series.values(self.clock() if now is None else now)
        return self._pct(vals, p)

    def burn_rates(self, now: Optional[float] = None) -> Dict[str, float]:
        """Error-budget burn per window: bad-fraction / budget. 0.0 while
        no terminal outcomes landed in the window."""
        now = self.clock() if now is None else float(now)
        out = {}
        with self._lock:
            events = list(self._events)
        for key, win in (("fast", self.spec.burn_fast_window_s),
                         ("slow", self.spec.burn_slow_window_s)):
            inside = [(good, shed) for t, good, shed in events
                      if t >= now - win]
            if not inside:
                out[key] = 0.0
                continue
            bad = sum(1 for good, _ in inside if not good)
            out[key] = (bad / len(inside)) / self.spec.error_budget
        return out

    def report(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The ``slo_report``: spec, measured position, burn rates,
        per-objective compliance. Publishes the ``slo_*`` gauges as a
        side effect (report IS the render moment)."""
        now = self.clock() if now is None else float(now)
        spec = self.spec
        with self._lock:
            ttft = self._ttft.values(now)
            ttft_cached = self._ttft_cached.values(now)
            ttft_uncached = self._ttft_uncached.values(now)
            itl = self._itl.values(now)
            wait = self._wait.values(now)
            events = list(self._events)
            totals = dict(self._totals)
            spec_win = [(a, p) for t, a, p in self._spec
                        if t >= now - spec.window_s]
            spec_totals = dict(self._spec_totals)
            bucket_win = {b: [(a, p) for t, a, p in dq
                              if t >= now - spec.window_s]
                          for b, dq in self._spec_bucket.items()}
            stream_counts = dict(self._stream_counts)
        win_events = [(g, s) for t, g, s in events
                      if t >= now - spec.window_s]
        good = sum(1 for g, _ in win_events if g)
        availability = good / len(win_events) if win_events else float("nan")
        proposed = sum(p for _, p in spec_win)
        n_split = len(ttft_cached) + len(ttft_uncached)
        measured = {
            "ttft_p50_s": self._pct(ttft, 50.0),
            "ttft_p99_s": self._pct(ttft, 99.0),
            # Prefix-sharing split (NaN without attributed samples — a
            # deployment without a prefix cache says so, not 0).
            "ttft_cached_p50_s": self._pct(ttft_cached, 50.0),
            "ttft_uncached_p50_s": self._pct(ttft_uncached, 50.0),
            "prefix_hit_rate": (len(ttft_cached) / n_split
                                if n_split else float("nan")),
            "itl_p50_s": self._pct(itl, 50.0),
            "itl_p99_s": self._pct(itl, 99.0),
            "queue_wait_p99_s": self._pct(wait, 99.0),
            "availability": availability,
            "error_rate": (1.0 - availability
                           if math.isfinite(availability) else float("nan")),
            # Speculative-decode acceptance over the window (NaN when no
            # drafting happened — a plain replica's report says so rather
            # than claiming 0).
            "acceptance_rate": (
                sum(a for a, _ in spec_win) / proposed
                if proposed else float("nan")),
            # Acceptance split by temperature bucket over the window —
            # only buckets that actually proposed appear (a replica that
            # never saw high-temperature traffic doesn't claim NaN rows).
            "acceptance_by_temperature": {
                b: (sum(a for a, _ in win) / sum(p for _, p in win)
                    if sum(p for _, p in win) else float("nan"))
                for b, win in sorted(bucket_win.items())},
        }
        burn = self.burn_rates(now)

        def _meets(m: float, target: float, higher_is_better=False) -> bool:
            if not math.isfinite(m):
                return True   # no data is not a violation
            return m >= target if higher_is_better else m <= target
        compliant = {
            "ttft_p50": _meets(measured["ttft_p50_s"], spec.ttft_p50_s),
            "ttft_p99": _meets(measured["ttft_p99_s"], spec.ttft_p99_s),
            "itl_p50": _meets(measured["itl_p50_s"], spec.itl_p50_s),
            "itl_p99": _meets(measured["itl_p99_s"], spec.itl_p99_s),
            "queue_wait_p99": _meets(measured["queue_wait_p99_s"],
                                     spec.queue_wait_p99_s),
            "availability": _meets(measured["availability"],
                                   spec.availability, higher_is_better=True),
        }
        compliant["overall"] = all(compliant.values())
        for key, g in self._g.items():
            if key == "compliant":
                g.set(1.0 if compliant["overall"] else 0.0)
            elif key == "burn_rate_fast":
                g.set(burn["fast"])
            elif key == "burn_rate_slow":
                g.set(burn["slow"])
            else:
                v = measured[key]
                g.set(v if math.isfinite(v) else 0.0)
        for b, rate in measured["acceptance_by_temperature"].items():
            gb = self._g_bucket.get(b)
            if gb is None:
                gb = self._reg.gauge(f"slo_acceptance_rate_{b}")
                self._g_bucket[b] = gb
            gb.set(rate if math.isfinite(rate) else 0.0)
        return {
            "slo": spec.to_dict(),
            "measured": measured,
            "burn_rate": {**burn,
                          "windows_s": [spec.burn_fast_window_s,
                                        spec.burn_slow_window_s]},
            "counts": {**totals, "window_requests": len(win_events),
                       "spec_proposed": spec_totals["proposed"],
                       "spec_accepted": spec_totals["accepted"],
                       "sampled_streams": stream_counts["sampled"],
                       "greedy_streams": stream_counts["greedy"]},
            "compliant": compliant,
        }

    def report_json(self, **kw) -> str:
        return json.dumps(json_safe(self.report(**kw)), default=str)


def json_safe(obj):
    """Recursively replace non-finite floats with None: an empty-window
    report carries NaN percentiles, and ``json.dumps`` would emit bare
    ``NaN`` — valid Python, rejected by every RFC-8259 parser. Every
    HTTP/JSON surface renders reports through this."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj


def replay_flight_records(records: Iterable[Dict[str, Any]],
                          spec: Optional[SLOSpec] = None,
                          registry: Optional[M.MetricsRegistry] = None,
                          ) -> SLOTracker:
    """Rebuild an :class:`SLOTracker` from flight records (the batcher's
    ``surface="serve", event="request"`` rows plus ``shed`` events), so
    the SLO position of a dead run is computable postmortem — same spec,
    same arithmetic, fed with the records' own wall clocks."""
    tracker = SLOTracker(spec=spec, registry=registry or M.MetricsRegistry())
    last_t = 0.0
    last_shed: Dict[Any, int] = {}
    for r in records:
        t = float(r.get("t", 0.0))
        if r.get("kind") == "shed":
            # Shed events are rate-limited to one per window (batcher /
            # router `_shed`), with the CUMULATIVE count on the record:
            # replay the per-process deltas, not the event count — else a
            # 100-rejection burst would replay as one bad event. (Sheds
            # after the final window-opening record are lost with the
            # record that was never written; bounded by one window.)
            total = r.get("total_shed")
            # Key deltas by (process, source): an in-process fleet holds
            # the router's AND a batcher's independent cumulative
            # counters under one process id.
            src = (r.get("r", 0), r.get("src"))
            if isinstance(total, (int, float)) and int(total) >= 1:
                n = min(max(1, int(total) - last_shed.get(src, 0)), 100_000)
                last_shed[src] = int(total)
            else:
                n = 1
            for _ in range(n):
                tracker.observe(ok=False, shed=True, t=t)
        elif r.get("kind") == "step" and r.get("event") == "request":
            cached = r.get("cached")
            temp = r.get("temperature")
            tracker.observe(
                ttft_s=r.get("ttft_s"), itl_s=r.get("itl_s"),
                itl_tokens=max(int(r.get("n_tokens") or 2) - 1, 1),
                queue_wait_s=r.get("queue_wait_s"),
                ok=(r.get("state") == "done"),
                cached=None if cached is None else bool(cached),
                temperature=None if temp is None else float(temp), t=t)
        else:
            continue
        last_t = max(last_t, t)
    # The replayed stream's own clock is "now": windows are computed
    # relative to the last record, not this process's monotonic clock.
    tracker.clock = lambda: last_t
    return tracker
