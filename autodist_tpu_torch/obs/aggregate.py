"""Cross-host observability aggregation over the ft coordination transports
(the port's copy of the JAX package's ``obs/aggregate.py``).

GSPMD splits one program across the mesh, so a slow *host* shows up only as
fleet-wide step time — per-op attribution can't name it. The classic
diagnostic is per-host step-time distributions compared across the fleet: a
host whose p50 sits above the fleet median is a straggler (thermal
throttling, a noisy neighbor, a dying HBM) long before it misses a
heartbeat. :class:`HostAggregator` publishes each host's recent step-time
quantiles over the same pluggable transports the ft heartbeat subsystem
already ships (:class:`~autodist_tpu_torch.ft.heartbeat.FileTransport` /
``CoordinatorTransport`` / ``MemoryTransport``), sweeps every host's
summary, and derives **straggler scores** — ``host_p50 / fleet_median_p50``
— that feed :meth:`~autodist_tpu_torch.ft.heartbeat.HealthMonitor.escalate`:
a persistent straggler is promoted to SUSPECT scrutiny *while still
beating its heart*, closing the gap between "alive" and "healthy".

The transport payloads are versioned dicts next to (not inside) the
heartbeat files — an aggregator dir under the ft base, or any directory
the caller picks — so observability traffic never races the liveness
signal.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np

from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.chaos import hooks as chaos_hooks
from autodist_tpu_torch.utils import logging

__all__ = ["HostAggregator"]


class HostAggregator:
    """Per-host step-time quantiles + fleet straggler scores.

    ``observe_step(seconds)`` records local step times (bounded window);
    :meth:`tick` publishes this host's summary and sweeps the fleet's.
    ``monitor``/``straggler_threshold`` arm the HealthMonitor escalation:
    a peer whose score exceeds the threshold for ``escalate_after``
    consecutive ticks is escalated to SUSPECT with a straggler reason.
    Drive :meth:`tick` from your loop, or :meth:`start` a daemon thread.
    """

    def __init__(
        self,
        transport,
        process_id: int = 0,
        registry: Optional[M.MetricsRegistry] = None,
        window: int = 256,
        interval_s: float = 5.0,
        monitor=None,
        straggler_threshold: float = 1.5,
        escalate_after: int = 3,
        clock: Callable[[], float] = time.time,
    ):
        self.transport = transport
        self.process_id = int(process_id)
        self.interval_s = float(interval_s)
        self.monitor = monitor
        self.straggler_threshold = float(straggler_threshold)
        self.escalate_after = max(1, int(escalate_after))
        self.clock = clock
        self._times: deque = deque(maxlen=max(8, int(window)))
        self._lock = threading.Lock()
        self._fleet: Dict[int, dict] = {}
        self._over: Dict[int, int] = {}  # pid -> consecutive over-threshold
        self._escalated: set = set()     # escalated once per straggle episode
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

        reg = registry or M.registry
        self._g_hosts = reg.gauge("obs_fleet_hosts")
        self._g_fleet_p50 = reg.gauge("obs_fleet_step_p50_s")
        self._g_local_p50 = reg.gauge("obs_host_step_p50_s")
        self._g_score = reg.gauge("obs_straggler_score")
        self._g_score_max = reg.gauge("obs_straggler_score_max")
        self._c_escalations = reg.counter("obs_straggler_escalations_total")

    # ------------------------------------------------------------ recording
    def observe_step(self, seconds: float) -> None:
        with self._lock:
            self._times.append(float(seconds))

    def quantiles(self) -> Dict[str, float]:
        """Local step-time summary (empty dict before any observation)."""
        with self._lock:
            xs = np.asarray(self._times, np.float64)
        if not xs.size:
            return {}
        return {
            "n": int(xs.size),
            "p50": float(np.percentile(xs, 50)),
            "p90": float(np.percentile(xs, 90)),
            "p99": float(np.percentile(xs, 99)),
            "mean": float(xs.mean()),
        }

    # ----------------------------------------------------------------- tick
    def tick(self, now: Optional[float] = None) -> Dict[int, dict]:
        """Publish local quantiles, sweep the fleet's, update scores.

        Returns the swept ``{pid: summary}`` view (own host included)."""
        now = self.clock() if now is None else now
        local = self.quantiles()
        if local:
            try:
                self.transport.publish(self.process_id,
                                       {"time": now, **local})
            except Exception as e:  # noqa: BLE001 - observability never fatal
                logging.warning("obs aggregate publish failed (%s)", e)
        try:
            fleet = self.transport.sweep()
        except Exception:  # noqa: BLE001
            fleet = {}
        # Chaos seam (docs/chaos.md): an installed plant may slow a host's
        # swept quantiles (straggler injection feeding SNT006).
        fleet = chaos_hooks.apply(chaos_hooks.SEAM_AGG_SWEEP, fleet)
        with self._lock:
            self._fleet = fleet
        self._update_scores(fleet)
        return fleet

    def _update_scores(self, fleet: Dict[int, dict]) -> None:
        p50s = {pid: s["p50"] for pid, s in fleet.items()
                if isinstance(s, dict) and s.get("p50")}
        self._g_hosts.set(len(p50s))
        if not p50s:
            return
        fleet_median = float(np.median(list(p50s.values())))
        self._g_fleet_p50.set(fleet_median)
        local = p50s.get(self.process_id)
        if local is not None:
            self._g_local_p50.set(local)
            self._g_score.set(local / fleet_median if fleet_median else 0.0)
        scores = self.straggler_scores(fleet=fleet)
        if scores:
            self._g_score_max.set(max(scores.values()))
        for pid, score in scores.items():
            if score > self.straggler_threshold:
                self._over[pid] = self._over.get(pid, 0) + 1
            else:
                self._over.pop(pid, None)
                self._escalated.discard(pid)  # recovered: next episode fires
            # >= (not ==) + the per-episode dedup set: a monitor attached
            # AFTER the counter passed the bar (a router attaches its own
            # observer monitor when it is built) must still escalate a
            # persistent straggler, exactly once per episode.
            if (self.monitor is not None
                    and self._over.get(pid, 0) >= self.escalate_after
                    and pid not in self._escalated
                    and pid != self.process_id):
                self._escalated.add(pid)
                self._c_escalations.inc()
                logging.warning(
                    "host %d is a straggler (p50 %.1fx fleet median); "
                    "escalating to suspect", pid, score)
                try:
                    self.monitor.escalate(
                        pid, reason=f"straggler x{score:.2f}")
                except Exception:  # noqa: BLE001 - monitor may be stopping
                    logging.warning("straggler escalation failed",
                                    exc_info=True)

    def straggler_scores(
        self, fleet: Optional[Dict[int, dict]] = None
    ) -> Dict[int, float]:
        """``{pid: host_p50 / fleet_median_p50}`` over the last sweep."""
        if fleet is None:
            with self._lock:
                fleet = dict(self._fleet)
        p50s = {pid: s["p50"] for pid, s in fleet.items()
                if isinstance(s, dict) and s.get("p50")}
        if not p50s:
            return {}
        med = float(np.median(list(p50s.values())))
        if not med:
            return {}
        return {pid: p / med for pid, p in p50s.items()}

    def stragglers(self, threshold: Optional[float] = None) -> List[int]:
        th = self.straggler_threshold if threshold is None else threshold
        return sorted(pid for pid, s in self.straggler_scores().items()
                      if s > th)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "HostAggregator":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 - daemon must survive
                    logging.warning("obs aggregator tick failed",
                                    exc_info=True)
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(
            target=loop, name="obs-aggregator", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(5.0, self.interval_s))
            self._thread = None
