"""Fault-tolerant multi-replica serving control plane (the port's
counterpart of the JAX package's ``serve/router.py``).

One :class:`~autodist_tpu_torch.serve.engine.InferenceEngine` is one fault
domain: a replica death takes every in-flight request with it and there
is no way to upgrade without an outage. The :class:`Router` is the
dependency-free control plane in front of N
:class:`~autodist_tpu_torch.serve.replica.Replica` instances (in-process for
tests; subprocess replicas publish the same payloads over the ft
``FileTransport``/``CoordinatorTransport``, so the launcher's supervision
seams carry a fleet unchanged):

- **Health-routed admission.** Replicas export typed readiness
  (``STARTING``/``READY``/``DRAINING``/``SUSPECT``/``DEAD``) through the
  existing :class:`~autodist_tpu_torch.ft.heartbeat.HealthMonitor` transports:
  self-reported state rides the heartbeat payload; SUSPECT/DEAD come
  from the router's observer monitor when beats stop (the same
  missed-beat escalation training fleets use). Work goes to the READY
  replica with the least outstanding work, weighted by
  :mod:`autodist_tpu_torch.obs.aggregate` straggler scores — a slow-but-alive
  replica is demoted before it misses a single beat.
- **Journaled exactly-once delivery.** Every admitted request is
  journaled (request-id keyed, the ``ft/drain.py`` format-v2
  persist/replay family) with its delivered-token watermark and prefix.
  The router is the single client-visible delivery point: tokens reach
  the client exactly once because the router harvests only from the
  currently-assigned backend and dedupes resumed streams against the
  watermark — a zombie replica finishing a failed-over request can waste
  compute but can never deliver a duplicate.
- **Exactly-once failover.** On replica death the router resubmits each
  in-flight request to a survivor, resuming *from the last delivered
  token*: the re-prefill runs over ``prompt + delivered[:-1]`` and its
  first emitted token must reproduce ``delivered[-1]`` **bit-identically**
  (greedy decode is deterministic; the router asserts it and fails the
  request typed on a mismatch rather than delivering a forked stream).
  The regenerated overlap token is skipped, so the client-visible stream
  is the uninterrupted stream, no token delivered twice or dropped.
- **Rolling drain upgrades.** :meth:`Router.rolling_upgrade` cycles the
  fleet one replica at a time: quiesce + drain via the
  :class:`~autodist_tpu_torch.ft.drain.DrainController` sequence (leftovers
  persist with ids + watermarks and fail over like a death, minus the
  death), restart through the replica's engine factory (the test
  fleet's factories build over one shared parameter dict), re-admit on
  READY — zero dropped requests.
- **Typed overload.** The router sheds with the same typed
  ``AdmissionDenied``/``REJECTED``/:class:`~autodist_tpu_torch.serve.batcher.
  Backpressure` contract the single-engine path keeps: when
  every replica is saturated the queue bounds admission at the edge;
  nothing ever hangs. All failover/retry timing goes through
  ``utils/retry.py``.

``python -m autodist_tpu_torch.serve --selftest-router --device cpu`` is
the CPU acceptance proof (3 replicas, one killed mid-decode under 64
concurrent requests, every stream bit-identical to an uninterrupted
control run, journal-verified exactly-once); :func:`fleet_trial` is its
measured run, which ``chip_smoke.py`` drives on the card at full width.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.ft import drain as ft_drain
from autodist_tpu_torch.ft.config import FTConfig
from autodist_tpu_torch.ft.heartbeat import HealthMonitor, PeerState
from autodist_tpu_torch.obs import recorder as obs_recorder
from autodist_tpu_torch.obs import spans as obs_spans
from autodist_tpu_torch.obs.sentry import Sentry, SentryConfig
from autodist_tpu_torch.obs.slo import SLOSpec, SLOTracker
from autodist_tpu_torch.serve import prefix as serve_prefix
from autodist_tpu_torch.serve.batcher import (
    Backpressure,
    GenRequest,
    RequestState,
    make_rejected,
)
from autodist_tpu_torch.serve.replica import Replica, ReplicaState
from autodist_tpu_torch.utils import logging, retry

__all__ = ["Router", "RouterConfig", "build_test_fleet", "calibrated_configs",
           "fleet_trial", "selftest_router"]

_router_ids = itertools.count()

# Prefix-affinity bounds: hash at most this many leading blocks per
# prompt (system prompts live in the first pages; hashing a 1M-token
# prompt buys no routing signal) and cap each replica's warm set (LRU).
_AFFINITY_BLOCKS = 32
_WARM_CAP = 4096


@dataclass(frozen=True)
class RouterConfig:
    """Control-plane knobs (serving cadences are subsecond by design —
    failover latency is a product metric, not a liveness afterthought).

    ``heartbeat_interval_s`` must match what the replicas publish at: the
    observer monitor's SUSPECT/DEAD windows are counted in it.
    """

    max_queue: int = 1024
    dispatch_interval_s: float = 0.005   # loop pacing backstop
    health_interval_s: float = 0.05      # monitor tick + straggler sweep
    heartbeat_interval_s: float = 0.5
    suspect_after_misses: int = 2
    dead_after_misses: int = 6
    straggler_threshold: float = 1.5
    journal_interval_s: float = 0.05     # dirty-journal flush cadence
    drain_deadline_s: float = 30.0       # rolling upgrade per-replica drain
    ready_timeout_s: float = 120.0       # rolling upgrade restart wait
    # How long a serve-sentry verdict (SNT007/008/009 attributed to a
    # replica) holds the replica out of routing. The demotion is the
    # router's own overlay — a latency-sick replica keeps beating READY,
    # so the heartbeat path alone would re-admit it immediately.
    sentry_demote_cooldown_s: float = 30.0
    # Grace after a rolling upgrade finishes during which sentry
    # demotions stay suppressed (maintenance-window alert suppression:
    # an upgrade degrades latency by DESIGN — shrunken fleet, cold
    # restarts — and demoting survivors for it would slow the recovery).
    maintenance_grace_s: float = 10.0


@dataclass
class _Flight:
    """Router bookkeeping for one client request across backend attempts."""

    front: GenRequest                      # the client-visible handle
    backend: Optional[GenRequest] = None   # current replica-side request
    replica_id: Optional[int] = None
    harvested: int = 0       # backend tokens consumed (incl. skipped overlap)
    skip: int = 0            # overlap tokens to skip after a prefix resume
    expect: Optional[int] = None  # bit-identity oracle for the overlap token
    reroutes: int = 0
    t_backend_fail: Optional[float] = None  # failover-latency clock start
    t_dispatch: Optional[float] = None  # current backend's submission time


class Router:
    """Supervise N replicas; admit, route, journal, fail over, upgrade.

    ``replicas`` maps replica id → :class:`Replica` (ids are the
    heartbeat process ids). ``transport`` is the heartbeat transport the
    replicas publish on — the router observes it with a non-publishing
    :class:`HealthMonitor`. ``aggregator`` (optional) is a
    :class:`~autodist_tpu_torch.obs.aggregate.HostAggregator` on the replicas'
    step-time transport; its straggler scores weight the routing.
    """

    def __init__(
        self,
        replicas: Dict[int, Replica],
        transport,
        journal_path: Optional[str] = None,
        config: Optional[RouterConfig] = None,
        aggregator=None,
        registry: Optional[M.MetricsRegistry] = None,
        slo_spec: Optional[SLOSpec] = None,
        sentry_config: Optional[SentryConfig] = None,
    ):
        self.replicas: Dict[int, Replica] = {
            int(k): v for k, v in replicas.items()}
        self.config = config or RouterConfig()
        self.journal_path = journal_path
        self.aggregator = aggregator
        cfg = self.config
        self.monitor = HealthMonitor(
            transport,
            publish=False,
            expected=sorted(self.replicas),
            config=FTConfig(
                heartbeat_interval_s=cfg.heartbeat_interval_s,
                suspect_after_misses=cfg.suspect_after_misses,
                dead_after_misses=cfg.dead_after_misses,
                backoff_initial_s=cfg.heartbeat_interval_s,
            ),
            registry=registry,
        )
        if aggregator is not None and getattr(aggregator, "monitor", None) is None:
            # Persistent stragglers escalate into the monitor (SUSPECT
            # while still beating) — the aggregate.py contract.
            aggregator.monitor = self.monitor

        self._instance = next(_router_ids)
        self._rid_counter = itertools.count()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        # Serializes token harvesting across threads: the router loop's
        # periodic _harvest and a DEAD-transition _fail_over (which can
        # run on rolling_upgrade's caller thread via the forced health
        # sweep) must never consume the same flight concurrently — an
        # interleaved harvested++/tokens.append would deliver a token
        # twice, the exact duplication the exactly-once contract bans.
        self._harvest_mutex = threading.Lock()
        self._queue: List[_Flight] = []          # undispatched, FIFO
        self._flights: Dict[str, _Flight] = {}   # dispatched, by request_id
        self._ledger: Dict[str, int] = {}        # request_id -> completions
        self._view: Dict[int, ReplicaState] = {
            rid: ReplicaState.STARTING for rid in self.replicas}
        self._admin_draining: set = set()        # rolling-upgrade holdout
        self._scores: Dict[int, float] = {}
        self._dispatches: Dict[int, int] = {rid: 0 for rid in self.replicas}
        # Prefix-affinity warm sets: per-replica bounded LRU of the
        # token-block hashes (serve/prefix.py chained digests) recently
        # dispatched there — the routing-side mirror of each replica's
        # radix cache. Purely advisory: affinity is a TIEBREAK under the
        # least-outstanding x straggler weight, so a cold replica still
        # gets work and a warm one never absorbs an overload.
        self._warm: Dict[int, "OrderedDict[str, None]"] = {}
        self._affinity_page_len: Optional[int] = 0   # 0 = not probed yet
        self._running = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self._last_health = -1e9
        self._last_journal = -1e9
        self._journal_dirty = False
        self._shed_last = -1e9   # router-edge shed flight-event window
        self._shed_count = 0

        reg = registry or M.registry
        self._reg = reg
        # Serving SLO position (rolling TTFT/ITL/queue-wait percentiles,
        # burn rates) measured at the DELIVERY point — the stream clients
        # actually saw, failovers included — plus the serve-aware sentry
        # whose SNT007/008/009 verdicts demote the offending replica.
        self.slo = SLOTracker(spec=slo_spec or SLOSpec(), registry=reg)
        self.serve_sentry = Sentry(
            config=sentry_config or SentryConfig(), registry=reg,
            monitor=self.monitor, recorder=obs_recorder)
        self._sentry_demoted: Dict[int, float] = {}  # rid -> holdout end
        self._maintenance_until: Optional[float] = None  # inf while upgrading
        # Per-replica terminal outcomes (t, good) for SNT009's
        # per-replica burn rate: a replica failing ITS requests burns the
        # budget attributably and is demoted like a TTFT/ITL regressor.
        self._replica_outcomes: Dict[int, deque] = {
            rid: deque(maxlen=512) for rid in self.replicas}
        self._h_ttft = reg.histogram("serve_router_ttft_s")
        self._h_itl = reg.histogram("serve_router_itl_s")
        self._g_ready = reg.gauge("serve_router_replicas_ready")
        self._g_total = reg.gauge("serve_router_replicas_total")
        self._g_depth = reg.gauge("serve_router_queue_depth")
        self._g_failover_s = reg.gauge("serve_router_failover_latency_s")
        self._c_failovers = reg.counter("serve_router_failovers_total")
        self._c_rerouted = reg.counter("serve_router_requests_rerouted_total")
        self._c_submitted = reg.counter("serve_router_requests_total")
        self._c_completed = reg.counter("serve_router_requests_completed_total")
        self._c_rejected = reg.counter("serve_router_requests_rejected_total")
        self._c_mismatch = reg.counter("serve_router_prefix_mismatch_total")
        self._h_latency = reg.histogram("serve_router_request_latency_s")
        self._g_total.set(len(self.replicas))

    # ---------------------------------------------------------------- clients
    def submit(self, prompt, max_new_tokens: int = 32,
               timeout_s: Optional[float] = None,
               request_id: Optional[str] = None,
               sampling=None) -> GenRequest:
        """Admit one request; returns the client-visible
        :class:`GenRequest` (its ``tokens``/``state`` are the delivered,
        exactly-once stream). Raises :class:`Backpressure` when the
        router queue is at ``max_queue`` or the router is stopped —
        overload is typed at the edge, never a hang. A statically
        unservable request (over every replica's ceiling) comes back
        already terminal ``REJECTED`` via the backend's typed check.
        ``sampling`` (:class:`~autodist_tpu_torch.serve.sampling.SamplingParams`
        or None for greedy) is validated here, journaled with the
        request, and re-submitted verbatim on failover — the stream's
        draws depend only on ``(request_id, seed, position)``, so the
        bit-identity overlap assertion holds for stochastic streams."""
        prompt = np.asarray(prompt, np.int32).ravel()
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if sampling is not None:
            sampling.validate()
        t_admit_wall, t_admit = time.time(), time.perf_counter()
        front = GenRequest(
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            deadline=(time.monotonic() + timeout_s) if timeout_s else None,
            request_id=request_id
            or f"rt{self._instance}-{os.getpid()}-{next(self._rid_counter)}",
            sampling=sampling,
        )
        # Static shape check against any live engine: typed, immediate,
        # and identical prose to the single-engine edge (ONE home:
        # engine.check_admissible).
        denied = None
        for rep in self.replicas.values():
            if rep.engine is not None:
                denied = rep.engine.check_admissible(
                    len(prompt), max_new_tokens)
                break
        if denied is not None:
            self._c_rejected.inc()
            front.unservable = True
            front._finish(RequestState.REJECTED,
                          f"admission rejected: {denied.reason}")
            obs_spans.add_span(
                "serve.router.admit", t_admit_wall,
                time.perf_counter() - t_admit,
                request_id=front.request_id, outcome="unservable")
            return front
        with self._wake:
            if self._stopped:
                reason = "router is stopped"
            elif len(self._queue) + len(self._flights) >= self.config.max_queue:
                reason = (f"router queue full "
                          f"({self.config.max_queue} requests)")
            else:
                reason = None
                flight = _Flight(front=front)
                self._queue.append(flight)
                self._ledger.setdefault(front.request_id, 0)
                self._c_submitted.inc()
                self._g_depth.set(len(self._queue))
                self._journal_dirty = True
                self._wake.notify()
        if reason is not None:
            self._c_rejected.inc()
            # A shed client got no answer: it burns the SLO error budget.
            self.slo.observe(ok=False, shed=True)
            self._record_shed(reason)
            obs_spans.add_span(
                "serve.router.admit", t_admit_wall,
                time.perf_counter() - t_admit,
                request_id=front.request_id, outcome="shed")
            raise Backpressure(reason)
        obs_spans.add_span(
            "serve.router.admit", t_admit_wall,
            time.perf_counter() - t_admit,
            request_id=front.request_id, outcome="queued")
        return front

    def try_submit(self, prompt, max_new_tokens: int = 32,
                   timeout_s: Optional[float] = None,
                   request_id: Optional[str] = None,
                   sampling=None) -> GenRequest:
        """Typed admission: a shed request comes back already terminal
        ``REJECTED`` (the batcher's ``try_submit`` contract, fleet-wide).
        Invalid sampling params land here as a typed REJECTED too."""
        try:
            return self.submit(prompt, max_new_tokens, timeout_s=timeout_s,
                               request_id=request_id, sampling=sampling)
        except (Backpressure, ValueError) as e:
            return make_rejected(prompt, max_new_tokens, str(e),
                                 request_id=request_id, sampling=sampling)

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "Router":
        with self._lock:
            if self._running:
                return self
            self._running = True
            self._stopped = False
        for rep in self.replicas.values():
            if rep.batcher is None and rep.state is not ReplicaState.DEAD:
                rep.start()
        self._thread = threading.Thread(
            target=self._loop, name="serve-router", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop the control plane. ``drain=True`` waits for in-flight work
        first; whatever remains is journaled (ids + watermarks) and
        finished ``PREEMPTED`` — a restarted router :meth:`recover`\\ s it
        exactly once."""
        if drain and self._thread is not None:
            def idle() -> bool:
                with self._lock:
                    return not self._queue and not self._flights

            retry.wait_until(idle, timeout_s, interval_s=0.01)
        with self._wake:
            self._running = False
            self._stopped = True
            self._wake.notify()
        if self._thread is not None:
            self._thread.join(timeout=max(1.0, timeout_s))
            self._thread = None
        with self._lock:
            leftovers = [f.front for f in self._queue] + [
                f.front for f in self._flights.values()]
            self._queue.clear()
            self._flights.clear()
            self._g_depth.set(0)
        if leftovers and self.journal_path:
            ft_drain.persist_requests(self.journal_path, leftovers)
        elif self.journal_path:
            self._remove_journal()
        for front in leftovers:
            front._finish(RequestState.PREEMPTED,
                          "router stopping; request journaled for recovery")
        for rep in self.replicas.values():
            rep.stop()
            # Same ownership rule as rolling_upgrade: the router's journal
            # is authoritative for everything it admitted; a fronted
            # replica's drain journal holds backend-relative entries
            # (composite prompts, resume-relative tokens) that must never
            # replay alongside it.
            self._consume_replica_journal(rep)

    def _consume_replica_journal(self, rep: Replica) -> None:
        try:
            os.remove(rep.persist_path)
        except OSError:
            pass

    def recover(self, extra_journals: Sequence[str] = ()) -> List[GenRequest]:
        """Resubmit journaled work, resuming each stream from its
        journaled prefix. Call before :meth:`start` traffic.

        The router's OWN journal is authoritative: its entries carry the
        client-relative prompt and delivered watermark. ``extra_journals``
        (e.g. drain journals of crashed standalone replicas) contribute
        only request ids the router never journaled — a backend-side
        entry for a request the router knows about is *resume-relative*
        (composite prompt, suffix tokens) and replaying it would drop the
        original prefix, so it never overrides the front entry. Ids that
        appear only in the extras dedupe among themselves with the
        highest watermark winning (:func:`merge_journal_entries`)."""
        own = ([self.journal_path]
               if self.journal_path and os.path.exists(self.journal_path)
               else [])
        extras = [p for p in extra_journals if p and os.path.exists(p)]
        entries = ft_drain.merge_journal_entries(own)
        seen = {e.get("request_id") for e in entries if e.get("request_id")}
        entries += [e for e in ft_drain.merge_journal_entries(extras)
                    if not e.get("request_id")
                    or e["request_id"] not in seen]
        for p in own + extras:
            try:
                os.remove(p)
            except OSError:
                pass
        fronts: List[GenRequest] = []
        from autodist_tpu_torch.serve.sampling import SamplingParams

        for e in entries:
            try:
                front = self.submit(
                    e["prompt"], max_new_tokens=int(e["max_new_tokens"]),
                    timeout_s=e.get("timeout_s"),
                    request_id=e.get("request_id") or None,
                    sampling=SamplingParams.from_dict(e.get("sampling")))
            except (Backpressure, ValueError, KeyError) as err:
                logging.warning("dropping unrecoverable journal entry %r "
                                "(%s)", e, err)
                continue
            if front.done:
                continue  # typed unservable: dropped, loudly, once
            # Resume from the journaled watermark: the dispatch path
            # re-prefills prompt+prefix[:-1] and asserts the overlap
            # token, exactly like a live failover.
            front.tokens.extend(int(t) for t in e.get("tokens", []))
            fronts.append(front)
        return fronts

    # ------------------------------------------------------------------ loop
    def _notify(self, _req=None) -> None:
        with self._wake:
            self._wake.notify()

    def _loop(self) -> None:
        while True:
            with self._wake:
                if not self._running:
                    break
                self._wake.wait(timeout=self.config.dispatch_interval_s)
                if not self._running:
                    break
            try:
                self._sweep_health()
                self._harvest()
                self._expire()
                self._dispatch()
                self._journal_tick()
            except Exception:  # noqa: BLE001 - the control plane must survive
                logging.warning("router tick failed", exc_info=True)

    # ----------------------------------------------------------------- health
    def replica_state(self, rid: int) -> ReplicaState:
        """The router's current view of one replica (observer-combined)."""
        with self._lock:
            return self._view.get(int(rid), ReplicaState.STARTING)

    def _classify(self, rid: int, peers) -> ReplicaState:
        if rid in self._admin_draining:
            return ReplicaState.DRAINING
        peer = peers.get(rid)
        payload_state = (peer.last_payload.get("state")
                         if peer is not None else None)
        if payload_state == ReplicaState.DEAD.value:
            return ReplicaState.DEAD
        if peer is not None and peer.state is PeerState.DEAD:
            return ReplicaState.DEAD
        # Serve-sentry demotion overlay (SNT007/008/009): the replica is
        # held out of routing for the cooldown even though it keeps
        # beating READY — a TTFT-sick replica is sick at the router's
        # measurement point, which fresh heartbeats cannot clear.
        until = self._sentry_demoted.get(rid)
        if until is not None:
            if time.monotonic() < until:
                return ReplicaState.SUSPECT
            del self._sentry_demoted[rid]
            # Re-arm the episode: while demoted the replica served no
            # traffic, so no recovery observation could clear it — and a
            # still-sick replica must be able to fire (and demote) again.
            self.serve_sentry.reset_serve_episodes(rid)
        if peer is not None and peer.state is PeerState.SUSPECT:
            return ReplicaState.SUSPECT
        try:
            return ReplicaState(payload_state)
        except ValueError:
            return ReplicaState.STARTING

    def _sweep_health(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_health < self.config.health_interval_s:
            return
        self._last_health = now
        self.monitor.tick()
        if self.aggregator is not None:
            try:
                fleet = self.aggregator.tick()
                self._scores = self.aggregator.straggler_scores(fleet)
            except Exception:  # noqa: BLE001 - scores are advisory
                logging.warning("router straggler sweep failed",
                                exc_info=True)
        # SLO burn-rate sweep rides the health cadence: the serve sentry's
        # SNT009 watches the fast window — fleet-level (alert only, no
        # single host to demote) AND per replica (a replica failing ITS
        # requests is demoted like a latency regressor).
        try:
            burn = self.slo.burn_rates()
            findings = self.serve_sentry.observe_serve(
                burn_rate=burn["fast"])
            budget = self.slo.spec.error_budget
            cutoff = now - self.slo.spec.burn_fast_window_s
            with self._lock:
                window = {rid: [g for t, g in evs if t >= cutoff]
                          for rid, evs in self._replica_outcomes.items()}
            for rid, outcomes in window.items():
                if len(outcomes) < 8:
                    continue  # too few outcomes to call a burn
                bad = sum(1 for g in outcomes if not g)
                findings += self.serve_sentry.observe_serve(
                    burn_rate=(bad / len(outcomes)) / budget,
                    replica_id=rid)
            self._apply_sentry_findings(findings)
        except Exception:  # noqa: BLE001 - SLO accounting is advisory
            logging.warning("router burn-rate sweep failed", exc_info=True)
        peers = self.monitor.peers()
        newly_dead: List[int] = []
        with self._lock:
            for rid in self.replicas:
                old = self._view.get(rid)
                new = self._classify(rid, peers)
                if new is not old:
                    logging.info("router: replica %d %s -> %s", rid,
                                 old.value if old else "?", new.value)
                    obs_recorder.record_event(
                        "replica_transition", critical=False, replica=rid,
                        old=old.value if old else "", new=new.value)
                    if new is ReplicaState.DEAD:
                        newly_dead.append(rid)
                self._view[rid] = new
            self._g_ready.set(sum(
                1 for s in self._view.values() if s is ReplicaState.READY))
        for rid in newly_dead:
            self._c_failovers.inc()
            self._fail_over(rid)

    def _record_shed(self, reason: str) -> None:
        """Flight-record router-edge sheds, windowed like the batcher's
        (one event opens each 1s window; ``total_shed`` carries the
        cumulative count so ``obs.slo.replay_flight_records`` recovers
        the true shed count from the deltas, not the event count)."""
        now = time.monotonic()
        with self._lock:
            # Fixed windows (advance only when one opens): a sustained
            # storm keeps emitting one record per window, so the replay
            # deltas recover the true count (batcher._shed semantics).
            opens = now - self._shed_last > 1.0
            if opens:
                self._shed_last = now
            self._shed_count += 1
            n = self._shed_count
        if opens:
            # src keys the replay's cumulative-delta arithmetic: router
            # and batcher counters are independent even in one process.
            obs_recorder.record_event(
                "shed", critical=False, src=f"router-{self._instance}",
                reason=reason[:200], total_shed=n)

    def _observe_serve(self, ttft_s: Optional[float] = None,
                       itl_s: Optional[float] = None,
                       replica_id: Optional[int] = None) -> None:
        """Feed one delivered-stream observation into the serve sentry;
        apply any fired verdicts to the routing view."""
        try:
            self._apply_sentry_findings(self.serve_sentry.observe_serve(
                ttft_s=ttft_s, itl_s=itl_s, replica_id=replica_id))
        except Exception:  # noqa: BLE001 - telemetry never fails a request
            logging.warning("serve sentry observation failed", exc_info=True)

    def _apply_sentry_findings(self, findings) -> None:
        """SNT007/008/009 attributed to a replica demote it in the
        router's view for ``sentry_demote_cooldown_s`` — the serving
        analog of SNT006's host demotion, but held by the router itself
        because the sick replica keeps beating READY."""
        for f in findings:
            rid = f.process_id
            if (f.code in ("SNT007", "SNT008", "SNT009")
                    and rid is not None and rid in self.replicas):
                with self._lock:
                    until = self._maintenance_until
                    if until is not None and time.monotonic() >= until:
                        until = self._maintenance_until = None
                    if until is not None:
                        # Maintenance window (rolling upgrade in progress
                        # or just finished): latency is degraded by
                        # design — record the verdict, suppress the
                        # demotion (SRE alert-suppression semantics).
                        logging.info(
                            "router: %s on replica %d suppressed "
                            "(maintenance window)", f.code, rid)
                        continue
                    routable_left = sum(
                        1 for r, s in self._view.items()
                        if s is ReplicaState.READY
                        and r != rid and r not in self._sentry_demoted)
                    if routable_left == 0:
                        # Never demote the LAST routable replica: a
                        # degraded fleet beats an unroutable one. The
                        # finding is still on record for the operator.
                        logging.warning(
                            "router: %s on replica %d NOT demoted — it is "
                            "the last routable replica", f.code, rid)
                        continue
                    self._sentry_demoted[rid] = (
                        time.monotonic()
                        + self.config.sentry_demote_cooldown_s)
                logging.warning(
                    "router: demoting replica %d for %s (cooldown %.0fs)",
                    rid, f.code, self.config.sentry_demote_cooldown_s)
                obs_recorder.record_event(
                    "replica_demoted", replica=rid, code=f.code,
                    value=f.value,
                    cooldown_s=self.config.sentry_demote_cooldown_s)

    def _fail_over(self, rid: int) -> None:
        """A replica died: every in-flight request assigned to it reroutes
        to a survivor (harvest first — tokens its batcher delivered before
        dying are client-visible and anchor the resume watermark)."""
        # Its radix cache died with it: forget the warm set (the failover
        # re-prefills repopulate the SURVIVOR's tree, and _record_warm
        # tracks those dispatches like any other).
        self._warm.pop(rid, None)
        with self._lock:
            victims = [f for f in self._flights.values()
                       if f.replica_id == rid]
        for flight in victims:
            self._harvest_flight(flight)
            if not flight.front.done:
                self._requeue(flight, f"replica {rid} died")

    # ---------------------------------------------------------------- harvest
    def _harvest(self) -> None:
        with self._lock:
            flights = list(self._flights.values())
        for flight in flights:
            self._harvest_flight(flight)

    def _harvest_flight(self, flight: _Flight) -> None:
        with self._harvest_mutex:
            self._harvest_flight_locked(flight)

    def _harvest_flight_locked(self, flight: _Flight) -> None:
        front, backend = flight.front, flight.backend
        if backend is None or front.done:
            return
        tokens = backend.tokens
        while flight.harvested < len(tokens):
            tok = int(tokens[flight.harvested])
            flight.harvested += 1
            if flight.skip > 0:
                flight.skip -= 1
                expect, flight.expect = flight.expect, None
                if expect is not None and tok != expect:
                    # The failover contract's hard assertion: greedy
                    # decode is deterministic, so the resumed prefix MUST
                    # reproduce bit-identically. A mismatch means the
                    # replicas disagree on the math — delivering a forked
                    # stream would be silent corruption; fail typed.
                    self._c_mismatch.inc()
                    self._finish_flight(
                        flight, RequestState.REJECTED,
                        f"failover prefix mismatch: replica "
                        f"{flight.replica_id} regenerated {tok}, delivered "
                        f"prefix ends with {expect} (nondeterministic "
                        f"decode)")
                    return
                continue
            front.tokens.append(tok)
            self._journal_dirty = True
            if front.t_first_token is None:
                # First client-visible token: the TTFT the SLO measures
                # (delivery point — failover re-prefills included).
                front.t_first_token = time.monotonic()
                ttft = front.t_first_token - front.t_submit
                self._h_ttft.observe(ttft)
                self.slo.observe(ttft_s=ttft)
                # The SENTRY's TTFT is the replica's own admit-to-first-
                # token latency (GenRequest.ttft_s, admission-relative) —
                # never submit- or dispatch-relative: those grow with the
                # router's / backend's queue depth under load, which
                # would read as a per-replica regression and demote
                # healthy replicas, and a cached-prefix admission whose
                # prefill collapses to one chunk would otherwise inherit
                # the queue wait.
                backend_ttft = getattr(backend, "ttft_s", None)
                if backend_ttft is None and flight.t_dispatch is not None:
                    # Remote stubs without a ttft_s surface: dispatch-
                    # relative is the closest per-replica measure left.
                    backend_ttft = front.t_first_token - flight.t_dispatch
                if backend_ttft is not None:
                    self._observe_serve(ttft_s=backend_ttft,
                                        replica_id=flight.replica_id)
            if flight.t_backend_fail is not None:
                # First client-visible token after a failover: the
                # failover latency the bench line reports.
                self._g_failover_s.set(
                    time.monotonic() - flight.t_backend_fail)
                flight.t_backend_fail = None
        if not backend.done:
            return
        # Backend terminal: everything harvestable has been harvested.
        if backend.state is RequestState.DONE:
            self._finish_flight(flight, RequestState.DONE, "")
        elif backend.state is RequestState.TIMEOUT:
            self._finish_flight(flight, RequestState.TIMEOUT, backend.error)
        elif backend.state is RequestState.REJECTED and backend.unservable:
            front.unservable = True
            self._finish_flight(flight, RequestState.REJECTED, backend.error)
        else:
            # REJECTED (engine death / scheduler failure / batcher stop)
            # or PREEMPTED (drain cut it off): fail over to a survivor.
            self._requeue(flight, backend.error or backend.state.value)

    def _finish_flight(self, flight: _Flight, state: RequestState,
                       error: str) -> None:
        front = flight.front
        with self._lock:
            self._flights.pop(front.request_id, None)
            if state is RequestState.DONE:
                self._ledger[front.request_id] = (
                    self._ledger.get(front.request_id, 0) + 1)
            # Outcome attribution for the per-replica burn rate. Skipped
            # for unservable rejections (the client's bug, not the
            # replica's) — everything else that terminates on a replica
            # counts for or against it.
            if flight.replica_id in self._replica_outcomes \
                    and not front.unservable:
                self._replica_outcomes[flight.replica_id].append(
                    (time.monotonic(), state is RequestState.DONE))
            self._journal_dirty = True
        (self._c_completed if state is RequestState.DONE
         else self._c_rejected).inc()
        front._finish(state, error)
        dur = time.monotonic() - front.t_submit
        self._h_latency.observe(dur)
        itl = front.itl_s
        if state is RequestState.DONE and itl is not None:
            self._h_itl.observe(itl)
            # Per-TOKEN attribution: the mean-ITL sample carries the
            # number of inter-token gaps it summarizes, so a multi-token
            # speculative-decode burst can't fake a latency win by
            # letting short requests dominate the percentile window.
            self.slo.observe(itl_s=itl,
                             itl_tokens=max(len(front.tokens) - 1, 1))
            if flight.reroutes == 0:
                # Attribute ITL to the replica ONLY for clean flights: a
                # failed-over request's inter-token gap spans the dead
                # replica's silence — charging it to the survivor would
                # demote the replica that saved the request.
                self._observe_serve(itl_s=itl,
                                    replica_id=flight.replica_id)
        self.slo.observe(ok=state is RequestState.DONE)
        # Delivery span: one "serve.request" per client request closes the
        # request-scoped trace (admit -> route -> prefill/decode ->
        # [failover ->] delivery), whatever replicas served it.
        obs_spans.add_span(
            "serve.request", time.time() - dur, dur,
            request_id=front.request_id, state=state.value,
            replica=flight.replica_id, reroutes=flight.reroutes,
            tokens=len(front.tokens))

    def _requeue(self, flight: _Flight, why: str) -> None:
        """Fail a flight over: back to the queue head (it has waited
        longest), resume spec recomputed from the delivered watermark at
        dispatch time."""
        front = flight.front
        with self._lock:
            if front.request_id not in self._flights:
                return  # already finished/requeued (idempotent)
            self._flights.pop(front.request_id)
            from_replica = flight.replica_id
            flight.backend = None
            flight.replica_id = None
            flight.harvested = 0
            flight.skip = 0
            flight.expect = None
            flight.reroutes += 1
            flight.t_backend_fail = time.monotonic()
            self._queue.insert(0, flight)
            self._g_depth.set(len(self._queue))
            self._journal_dirty = True
        self._c_rerouted.inc()
        logging.info("router: rerouting %s after %d delivered token(s) "
                     "(%s)", front.request_id, len(front.tokens), why)
        obs_recorder.record_event(
            "reroute", critical=False, request_id=front.request_id,
            from_replica=from_replica,
            delivered=len(front.tokens), reason=why[:200])
        # The failover marker in the request-scoped trace: `delivered` IS
        # the journal watermark the resume will replay from.
        obs_spans.add_span(
            "serve.failover", time.time(), 0.0,
            request_id=front.request_id, delivered=len(front.tokens),
            from_replica=from_replica, reason=why[:200])

    # ----------------------------------------------------------------- expiry
    def _expire(self) -> None:
        now = time.monotonic()
        with self._lock:
            expired = [f for f in self._queue
                       if f.front.deadline is not None
                       and now > f.front.deadline]
            for f in expired:
                self._queue.remove(f)
            if expired:
                self._g_depth.set(len(self._queue))
                self._journal_dirty = True
        for f in expired:
            f.front._finish(RequestState.TIMEOUT,
                            "deadline expired in router queue")

    # --------------------------------------------------------------- dispatch
    def _routable(self) -> List[int]:
        with self._lock:
            return [rid for rid, s in self._view.items()
                    if s is ReplicaState.READY
                    and self.replicas[rid].batcher is not None]

    def _rank(self, candidates: List[int],
              hashes: tuple = ()) -> List[int]:
        """Least outstanding work, weighted by straggler score (a 2x-slow
        replica counts as twice as loaded); among equally-loaded
        replicas, the one holding the WARMEST prefix (deepest leading
        run of ``hashes`` in its warm set — a cached-prefix admission
        there skips that much prefill) wins; remaining ties break to
        the lowest id for determinism."""
        def weight(rid: int) -> float:
            load = self.replicas[rid].outstanding + 1
            score = max(1.0, float(self._scores.get(rid, 1.0)))
            return load * score

        return sorted(candidates, key=lambda rid: (
            weight(rid), -self._affinity(rid, hashes), rid))

    # ------------------------------------------------------ prefix affinity
    def _block_page_len(self) -> Optional[int]:
        """The fleet's KV page length (block size of the prefix hashes),
        probed once from any in-process replica engine; None when no
        replica exposes one — affinity then degrades to a no-op and
        routing is exactly the pre-affinity ordering."""
        if self._affinity_page_len == 0:
            page_len = None
            for rep in self.replicas.values():
                engine = getattr(getattr(rep, "batcher", None),
                                 "engine", None)
                if engine is not None and getattr(engine, "page_len", 0):
                    page_len = int(engine.page_len)
                    break
            self._affinity_page_len = page_len
        return self._affinity_page_len

    def _affinity_hashes(self, prompt) -> tuple:
        page_len = self._block_page_len()
        if not page_len or len(prompt) < page_len:
            return ()
        return tuple(serve_prefix.block_hashes(
            np.asarray(prompt, np.int32), page_len,
            limit=_AFFINITY_BLOCKS))

    def _affinity(self, rid: int, hashes: tuple) -> int:
        """Warm-prefix depth: leading blocks of ``hashes`` this replica
        has recently prefilled (its radix cache plausibly still holds
        them — eviction over there only costs recompute, never
        correctness, so stale advice is safe)."""
        warm = self._warm.get(rid)
        if not warm or not hashes:
            return 0
        depth = 0
        for h in hashes:
            if h not in warm:
                break
            depth += 1
        return depth

    def _record_warm(self, rid: int, hashes: tuple) -> None:
        if not hashes:
            return
        warm = self._warm.setdefault(rid, OrderedDict())
        for h in hashes:
            warm.pop(h, None)
            warm[h] = None
        while len(warm) > _WARM_CAP:
            warm.popitem(last=False)

    def _dispatch(self) -> None:
        saturated: set = set()
        while True:
            with self._lock:
                if not self._queue:
                    return
                flight = self._queue[0]
            candidates = [r for r in self._routable() if r not in saturated]
            if not candidates:
                return  # nothing routable: stay queued (bounded at submit)
            # Affinity keys off the ORIGINAL prompt (front.prompt): on a
            # failover resume the delivered tokens re-prefill on the
            # survivor anyway, repopulating its tree — the shared system
            # prefix is what affinity can actually reuse.
            hashes = self._affinity_hashes(flight.front.prompt)
            dispatched = False
            for rid in self._rank(candidates, hashes):
                if self._dispatch_one(flight, rid):
                    dispatched = True
                    if not flight.front.done:
                        # Really dispatched (not a queue-expiry/terminal
                        # rejection): these blocks are now warming there.
                        self._record_warm(rid, hashes)
                    break
                saturated.add(rid)
            if not dispatched:
                return

    def _dispatch_one(self, flight: _Flight, rid: int) -> bool:
        front = flight.front
        timeout_s = None
        if front.deadline is not None:
            timeout_s = front.deadline - time.monotonic()
            if timeout_s <= 0:
                with self._lock:
                    if flight in self._queue:
                        self._queue.remove(flight)
                        self._g_depth.set(len(self._queue))
                front._finish(RequestState.TIMEOUT,
                              "deadline expired in router queue")
                return True
        # Prefix resume: k delivered tokens re-prefill as prompt context
        # minus the last one, whose regeneration is the bit-identity
        # assertion (skip=1). The timeline length is unchanged:
        # (prompt + k - 1) + (max_new - k + 1) == prompt + max_new.
        k = len(front.tokens)
        if k:
            prompt = np.concatenate(
                [front.prompt, np.asarray(front.tokens[:-1], np.int32)])
            max_new = front.max_new_tokens - k + 1
            skip, expect = 1, int(front.tokens[-1])
        else:
            prompt, max_new = front.prompt, front.max_new_tokens
            skip, expect = 0, None
        try:
            backend = self.replicas[rid].submit(
                prompt, max_new, timeout_s=timeout_s,
                request_id=front.request_id,
                sampling=front.sampling)
        except (Backpressure, ValueError):
            return False
        if backend.done and backend.state is RequestState.REJECTED:
            # Typed immediate rejection (unservable / engine refused):
            # propagate for unservable, otherwise try the next replica.
            if backend.unservable:
                with self._lock:
                    if flight in self._queue:
                        self._queue.remove(flight)
                        self._g_depth.set(len(self._queue))
                front.unservable = True
                front._finish(RequestState.REJECTED, backend.error)
                self._c_rejected.inc()
                return True
            return False
        with self._lock:
            if flight in self._queue:
                self._queue.remove(flight)
            self._g_depth.set(len(self._queue))
            flight.backend = backend
            flight.replica_id = rid
            flight.harvested = 0
            flight.skip = skip
            flight.expect = expect
            flight.t_dispatch = time.monotonic()
            self._flights[front.request_id] = flight
            self._dispatches[rid] = self._dispatches.get(rid, 0) + 1
            if front.state is RequestState.QUEUED:
                front.state = RequestState.ACTIVE
            states = {r: s.value for r, s in self._view.items()}
        if flight.reroutes == 0:
            wait_s = max(time.monotonic() - front.t_submit, 0.0)
            front.queue_wait_s = wait_s
            self.slo.observe(queue_wait_s=wait_s)
        # Flight-record the routing decision WITH its inputs — loads,
        # straggler scores, readiness states — so a postmortem can answer
        # "why did it route there"; the span ties it into the request's
        # trace (resume_from is the journal watermark on a failover).
        loads = {r: self.replicas[r].outstanding for r in self.replicas}
        scores = {r: round(float(self._scores.get(r, 1.0)), 3)
                  for r in self.replicas}
        obs_recorder.record_step(
            surface="serve", event="route", request_id=front.request_id,
            replica=rid, resume_from=k, reroutes=flight.reroutes,
            loads=loads, straggler_scores=scores, states=states)
        obs_spans.add_span(
            "serve.router.route", time.time(), 0.0,
            request_id=front.request_id, replica=rid, resume_from=k,
            reroutes=flight.reroutes)
        backend.add_done_callback(self._notify)
        return True

    # ---------------------------------------------------------------- journal
    def _journal_tick(self, force: bool = False) -> None:
        if self.journal_path is None:
            return
        now = time.monotonic()
        with self._lock:
            due = self._journal_dirty and (
                force or now - self._last_journal
                >= self.config.journal_interval_s)
            if not due:
                return
            self._journal_dirty = False
            self._last_journal = now
            fronts = [f.front for f in self._queue] + [
                f.front for f in self._flights.values()]
        if fronts:
            ft_drain.persist_requests(self.journal_path, fronts)
        else:
            self._remove_journal()

    def _remove_journal(self) -> None:
        try:
            os.remove(self.journal_path)
        except OSError:
            pass

    # ---------------------------------------------------------------- queries
    @property
    def outstanding(self) -> int:
        with self._lock:
            return len(self._queue) + len(self._flights)

    def ledger(self) -> Dict[str, int]:
        """``{request_id: completion_count}`` — the exactly-once witness
        (every value must be exactly 1 for a completed request; the
        selftest and chaos scenarios assert it)."""
        with self._lock:
            return dict(self._ledger)

    def dispatch_counts(self) -> Dict[int, int]:
        """``{replica_id: backend_dispatches}`` — the routing witness
        (the partition scenario asserts a SUSPECT replica stops receiving
        new work and resumes after rejoin)."""
        with self._lock:
            return dict(self._dispatches)

    def slo_report(self) -> dict:
        """The fleet ``slo_report``: the SLO tracker's position (rolling
        TTFT/ITL/queue-wait percentiles, burn rates, compliance) plus the
        router's own state — the JSON the frontend's ``GET /slo`` serves
        and the selftest's bounded-p99 bar reads."""
        report = self.slo.report()
        with self._lock:
            view = {rid: s.value for rid, s in self._view.items()}
            demoted = sorted(self._sentry_demoted)
            outstanding = len(self._queue) + len(self._flights)
        report["router"] = {
            "replicas": view,
            "replicas_ready": sum(1 for s in view.values() if s == "ready"),
            "sentry_demoted": demoted,
            "outstanding": outstanding,
            "dispatches": self.dispatch_counts(),
            "sentry_codes": self.serve_sentry.codes(),
        }
        return report

    def metrics_snapshot(self) -> Dict[str, object]:
        """The fleet-level metrics snapshot the router frontend renders:
        the shared registry's snapshot plus per-replica samples labeled
        ``{replica="<id>"}`` from the same facts the heartbeat payloads
        and ``/healthz`` carry — rendered through the ONE OpenMetrics
        exporter, so the fleet surface stays byte-parity-testable against
        the golden exposition rules."""
        snap: Dict[str, object] = dict(self._reg.snapshot())
        with self._lock:
            view = dict(self._view)
        for rid in sorted(self.replicas):
            rep = self.replicas[rid]
            label = f'{{replica="{rid}"}}'
            snap[f"serve_replica_up{label}"] = (
                1.0 if view.get(rid) is ReplicaState.READY else 0.0)
            snap[f"serve_replica_outstanding{label}"] = float(
                rep.outstanding)
            snap[f"serve_replica_page_pool_utilization{label}"] = float(
                rep.page_utilization)
            snap[f"serve_replica_restarts{label}"] = float(rep.restarts)
        return snap

    # --------------------------------------------------------------- upgrades
    def rolling_upgrade(self, deadline_s: Optional[float] = None,
                        ready_timeout_s: Optional[float] = None) -> List[dict]:
        """Drain → restart → re-admit each replica in turn, zero dropped
        requests: while one replica drains (quiesce; in-flight finishes
        within ``deadline_s``; leftovers persist with ids + watermarks and
        fail over through the normal reroute path), the survivors carry
        the traffic; the restarted replica re-admits once its READY beat
        lands. Returns one summary dict per replica."""
        deadline_s = (self.config.drain_deadline_s
                      if deadline_s is None else deadline_s)
        ready_timeout_s = (self.config.ready_timeout_s
                           if ready_timeout_s is None else ready_timeout_s)
        # Open the maintenance window: an upgrade degrades latency by
        # design (shrunken fleet, cold restarts) — serve-sentry demotions
        # are suppressed until maintenance_grace_s after it closes, and
        # existing demotions are lifted (the upgrade IS the remediation).
        with self._lock:
            self._maintenance_until = float("inf")
            self._sentry_demoted.clear()
        results = []
        try:
            results = self._rolling_upgrade_cycles(
                deadline_s, ready_timeout_s)
        finally:
            with self._lock:
                self._maintenance_until = (
                    time.monotonic() + self.config.maintenance_grace_s)
        return results

    def _rolling_upgrade_cycles(self, deadline_s: float,
                                    ready_timeout_s: float) -> List[dict]:
        results = []
        for rid in sorted(self.replicas):
            rep = self.replicas[rid]
            t0 = time.monotonic()
            with self._lock:
                self._admin_draining.add(rid)
                self._view[rid] = ReplicaState.DRAINING
            try:
                out = rep.drain()
                # The router owns every request a fronted replica drains:
                # their fronts fail over through the router's OWN journal
                # (the authoritative delivered watermarks). The replica-
                # local drain journal would re-serve them on a naive
                # fleet recover — consume it now.
                self._consume_replica_journal(rep)
                self._warm.pop(rid, None)   # fresh engine = cold radix tree
                rep.restart()
                ready = rep.wait_ready(ready_timeout_s)
            finally:
                with self._lock:
                    self._admin_draining.discard(rid)
            # Force a health sweep so the READY beat re-admits the
            # replica before the next drain shrinks the fleet again.
            self._sweep_health(force=True)
            ok = ready and retry.wait_until(
                lambda: self.replica_state(rid) is ReplicaState.READY,
                ready_timeout_s, interval_s=0.01)
            obs_recorder.record_event(
                "rolling_upgrade", replica=rid, ok=bool(ok),
                drained=out.get("drained", 0),
                persisted=out.get("persisted", 0),
                duration_s=round(time.monotonic() - t0, 3))
            if not ok:
                raise RuntimeError(
                    f"rolling upgrade: replica {rid} did not return to "
                    f"READY within {ready_timeout_s:.0f}s")
            results.append({"replica": rid, **out,
                            "duration_s": time.monotonic() - t0})
        return results


# ------------------------------------------------------------- selftest
def _tiny_router_cfg():
    from autodist_tpu_torch.models import get_model

    # vocab 128 keeps every mock_load_prompt token (1..126) IN vocab:
    # out-of-vocab lookups clamp differently across program shapes, which
    # would fork the greedy bit-identity oracle.
    return get_model("transformer", vocab_size=128, num_layers=1, d_model=32,
                     num_heads=2, d_ff=64, max_seq_len=64, causal=True,
                     dtype="float32")


#: The test fleet's SLO targets: generous CPU-sim values (the JAX package's
#: ``build_test_fleet`` spec). The selftest's bounded-p99 bar proves the SLO
#: *plumbing* (percentiles measured, compliance computed), not speed; a
#: deployment passes its own ``slo_spec``.
TEST_SLO_SPEC = SLOSpec(
    ttft_p50_s=60.0, ttft_p99_s=120.0, itl_p50_s=10.0, itl_p99_s=30.0,
    queue_wait_p99_s=120.0, availability=0.99, window_s=600.0,
    burn_fast_window_s=60.0, burn_slow_window_s=600.0)


def build_test_fleet(n_replicas: int = 3, n_slots: int = 8,
                     page_len: int = 8, n_pages: int = 41,
                     journal_dir: Optional[str] = None,
                     registry: Optional[M.MetricsRegistry] = None,
                     config: Optional[RouterConfig] = None,
                     spec_decode: bool = False, spec_k: int = 4,
                     prefix_cache: bool = False, kv_quant: bool = False,
                     engine_kwargs: Optional[Callable[[], dict]] = None, *,
                     device="cuda", model_cfg=None, params=None,
                     draft_params=None,
                     sentry_config: Optional[SentryConfig] = None):
    """An in-process fleet for tests and the card: N replicas whose
    factories build an engine over ONE shared parameter dict (the port's
    engine is one device with every parameter whole, so the dict is the
    artifact the JAX package's one compiled one-chip plan is), a shared
    Memory heartbeat transport, a straggler aggregator pair, and a control
    engine for bit-identity oracles.

    ``model_cfg`` defaults to the tiny fp32 transformer of the JAX
    package's fleet; ``params`` (and ``draft_params``) default to seeded
    weights on ``device`` (``init_params`` seeds 0 and 9; tests pass the
    JAX fleet's weights through ``params_from_jax``).

    ``spec_decode=True`` gives every replica a
    :class:`~autodist_tpu_torch.serve.spec.SpecDecodeEngine` (a
    different-seed draft — real accept/reject traffic) while the CONTROL
    engine stays plain: the exactly-once failover bars then also prove the
    lossless claim through journal replay, since every delivered stream
    must still match plain greedy bit for bit.

    ``engine_kwargs`` (a zero-arg callable returning a kwargs dict) is
    re-read every time a replica factory BUILDS — at start and at every
    ``rolling_upgrade()`` restart — so a rolling upgrade brings each
    replica up on new knobs while untouched replicas keep the old set.

    ``kv_quant=True`` serves every replica AND the control engine from
    int8 quantized KV pages, so the bit-identity oracle compares quantized
    to quantized.

    ``config`` defaults to the CPU-sim cadences (heartbeat 0.05 s, SUSPECT
    after 2 misses, DEAD after 4); its ``straggler_threshold`` is the
    router aggregator's escalation bar. ``sentry_config`` defaults to
    ``SentryConfig()``; the SLO spec is :data:`TEST_SLO_SPEC`.

    Returns ``(router, control_engine)``; the caller owns ``stop()``.
    """
    import tempfile

    from autodist_tpu_torch.ft.heartbeat import MemoryTransport
    from autodist_tpu_torch.models.transformer import decode_model, init_params
    from autodist_tpu_torch.obs.aggregate import HostAggregator
    from autodist_tpu_torch.serve.engine import InferenceEngine
    from autodist_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    cfg = model_cfg if model_cfg is not None else _tiny_router_cfg()
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    if params is None:
        params = init_params(cfg, seed=0, device=device)
    geometry = dict(n_slots=n_slots, page_len=page_len, n_pages=n_pages,
                    prefill_chunk=page_len, device=device)

    if spec_decode:
        from autodist_tpu_torch.serve.spec import SpecDecodeEngine

        if draft_params is None:
            draft_params = init_params(cfg, seed=9, device=device)

        def make_engine():
            kw = dict(geometry, spec_k=spec_k, prefix_cache=prefix_cache)
            if engine_kwargs is not None:
                kw.update(engine_kwargs())
            return SpecDecodeEngine(params, decode_model(cfg), draft_params,
                                    decode_model(cfg), **kw)
    else:
        def make_engine():
            # prefix_cache=True gives every replica its OWN radix tree
            # (trees are per-engine state, like slot tables): failover
            # re-prefill then repopulates the survivor's tree organically.
            kw = dict(geometry, prefix_cache=prefix_cache)
            if engine_kwargs is not None:
                kw.update(engine_kwargs())
            return InferenceEngine(params, decode_model(cfg), **kw)

    # The control/oracle engine is ALWAYS plain greedy: with a spec fleet
    # it is the independent decode path every delivered stream must match
    # bit for bit.
    control = InferenceEngine(params, decode_model(cfg), **geometry)
    journal_dir = journal_dir or tempfile.mkdtemp(prefix="router-journal-")
    registry = registry or M.MetricsRegistry()
    hb_transport = MemoryTransport()
    agg_transport = MemoryTransport()
    config = config or RouterConfig(
        heartbeat_interval_s=0.05, health_interval_s=0.02,
        suspect_after_misses=2, dead_after_misses=4)
    replicas = {}
    for rid in range(n_replicas):
        agg = HostAggregator(agg_transport, process_id=rid,
                             registry=M.MetricsRegistry())
        replicas[rid] = Replica(
            rid, make_engine, hb_transport,
            persist_path=os.path.join(journal_dir, f"replica-{rid}.json"),
            heartbeat_interval_s=config.heartbeat_interval_s,
            drain_deadline_s=config.drain_deadline_s,
            aggregator=agg, registry=registry)
    router_agg = HostAggregator(agg_transport, process_id=-1,
                                registry=M.MetricsRegistry(),
                                straggler_threshold=config.straggler_threshold)
    router = Router(
        replicas, hb_transport,
        journal_path=os.path.join(journal_dir, "router-journal.json"),
        config=config, aggregator=router_agg, registry=registry,
        slo_spec=TEST_SLO_SPEC, sentry_config=sentry_config)
    return router, control


#: How far above a kill-free run's maximum :func:`calibrated_configs` sets
#: a threshold that run crossed.
CALIBRATION_MARGIN = 2.0


class _Probe:
    """What a running router's health sweep and serve sentry see: the
    largest straggler score of a sweep, and each TTFT/ITL observation's
    ratio to the rolling median the sentry judges it against, with the
    value (only a value above the sentry's floor can trip it)."""

    def __init__(self, router: Router):
        self.max_score = 0.0
        self.ratios: Dict[str, list] = {"ttft": [], "itl": []}
        self._sentry = router.serve_sentry
        observe_serve = self._sentry.observe_serve

        def observe(step=None, ttft_s=None, itl_s=None, burn_rate=None,
                    replica_id=None):
            rid = -1 if replica_id is None else int(replica_id)
            cfg = self._sentry.config
            for key, value, hist in (("ttft", ttft_s, self._sentry._ttft),
                                     ("itl", itl_s, self._sentry._itl)):
                series = hist.get(rid)
                if value and series and len(series) >= cfg.serve_min_history:
                    med = float(np.median(np.asarray(series, np.float64)))
                    if med > 0:
                        self.ratios[key].append((value / med, value))
            return observe_serve(step=step, ttft_s=ttft_s, itl_s=itl_s,
                                 burn_rate=burn_rate, replica_id=replica_id)

        self._sentry.observe_serve = observe
        if router.aggregator is not None:
            scores_of = router.aggregator.straggler_scores

            def straggler_scores(fleet=None):
                out = scores_of(fleet)
                self.max_score = max([self.max_score, *out.values()])
                return out

            router.aggregator.straggler_scores = straggler_scores

    def summary(self) -> dict:
        cfg = self._sentry.config
        out = {"max_straggler_score": self.max_score}
        for key, floor in (("ttft", cfg.ttft_min_s), ("itl", cfg.itl_min_s)):
            seen = self.ratios[key]
            out[f"{key}_observations"] = len(seen)
            out[f"max_{key}_ratio"] = max((r for r, _ in seen), default=0.0)
            out[f"max_{key}_ratio_above_floor"] = max(
                (r for r, v in seen if v > floor), default=0.0)
        return out


def calibrated_configs(observed: dict, config: RouterConfig,
                       sentry_config: SentryConfig,
                       margin: float = CALIBRATION_MARGIN) -> tuple:
    """``config`` and ``sentry_config`` for a fleet whose kill-free
    :func:`fleet_trial` ``observed`` what healthy replicas show on this
    host: a threshold that run crossed (its largest straggler score, or a
    TTFT/ITL ratio of a value above the sentry's floor) is set ``margin``
    above the measured maximum; every other field is kept. In-process
    replicas share one interpreter, so each one's tick time and prefill
    latency carry the others' work. Returns ``(RouterConfig,
    SentryConfig, {field: {"default", "measured_max", "set_to",
    "margin"}})``."""
    raised = {}
    for obj, field, measured in (
            (config, "straggler_threshold", observed["max_straggler_score"]),
            (sentry_config, "ttft_ratio", observed["max_ttft_ratio_above_floor"]),
            (sentry_config, "itl_ratio", observed["max_itl_ratio_above_floor"])):
        default = getattr(obj, field)
        if measured > default:
            raised[field] = dict(default=default, measured_max=measured,
                                 set_to=measured * margin, margin=margin)
    config = dataclasses.replace(config, **{
        k: v["set_to"] for k, v in raised.items() if k == "straggler_threshold"})
    sentry_config = dataclasses.replace(sentry_config, **{
        k: v["set_to"] for k, v in raised.items() if k != "straggler_threshold"})
    return config, sentry_config, raised


def fleet_trial(router: Router, prompts: Sequence, max_new: int,
                expected: Optional[Sequence[List[int]]] = None,
                kill_replica: Optional[int] = 1,
                timeout_s: float = 300.0) -> dict:
    """One measured run of the router acceptance proof on ``router``:
    ``len(prompts)`` concurrent clients through :func:`async_generate`,
    replica ``kill_replica`` killed once it holds in-flight decode work
    (``None``: no kill), then every bar of :func:`selftest_router`
    measured. The caller owns ``stop()``.

    Returns ``{"ok", "line", "results", "killed", "observed"}``: ``line``
    is the selftest's JSON line (with ``expected``, the streams are held to
    it bit for bit; without, ``streams_bit_identical_to_control`` is None
    and the caller judges the streams), ``ok`` every bar, ``results`` the
    delivered :class:`GenRequest` per prompt, ``observed`` the run's
    largest straggler score and TTFT/ITL ratios to the rolling median
    (before any seeded regression; :func:`calibrated_configs` reads it).
    Without a kill the failover bars read "none happened", every replica
    READY, and no sentry regression is seeded."""
    import asyncio

    from autodist_tpu_torch.serve.server import async_generate

    registry = router._reg
    n_requests, n_replicas = len(prompts), len(router.replicas)
    # Earlier runs traced too: clear the ring so the stitched-trace bar
    # reads only this run (and cannot lose its early failover span to
    # capacity eviction).
    obs_spans.get_tracer().clear()
    probe = _Probe(router)
    router.start()
    for rep in router.replicas.values():
        rep.wait_ready(120.0)
    killed = {"at": None}

    def killer():
        # Kill once the victim holds in-flight decode work: a mid-decode
        # death, not an idle restart.
        def armed() -> bool:
            with router._lock:
                return any(
                    f.replica_id == kill_replica and len(f.front.tokens) > 0
                    for f in router._flights.values())

        if retry.wait_until(armed, 60.0, interval_s=0.005):
            killed["at"] = time.monotonic()
            router.replicas[kill_replica].kill(
                "selftest: injected mid-decode death")

    kthread = threading.Thread(target=killer, daemon=True)

    async def run_clients():
        async def client(i):
            await asyncio.sleep(0.001 * (i % 8))
            return await async_generate(router, prompts[i], max_new)

        return await asyncio.gather(*(client(i) for i in range(n_requests)))

    t0 = time.monotonic()
    if kill_replica is not None:
        kthread.start()
    try:
        results = asyncio.run(asyncio.wait_for(run_clients(),
                                               timeout=timeout_s))
    finally:
        if kill_replica is not None:
            kthread.join(timeout=5.0)
    dt = time.monotonic() - t0
    observed = probe.summary()

    states = {s: sum(1 for r in results if r.state is s) for s in RequestState}
    streams_ok = (None if expected is None else
                  all(r.tokens == list(expected[i])
                      for i, r in enumerate(results)))
    ledger = router.ledger()
    exactly_once = (len(ledger) == n_requests
                    and all(v == 1 for v in ledger.values()))
    snap = registry.snapshot()
    failovers = int(snap.get("serve_router_failovers_total", 0))
    rerouted = int(snap.get("serve_router_requests_rerouted_total", 0))
    mismatches = int(snap.get("serve_router_prefix_mismatch_total", 0))
    # The journal flusher runs on its own cadence: give it one window to
    # consume the final completion before reading the empty-journal bar.
    journal_empty = retry.wait_until(
        lambda: not os.path.exists(router.journal_path), 5.0,
        interval_s=0.01)
    ready_after = int(snap.get("serve_router_replicas_ready", 0))
    lat = snap.get("serve_router_request_latency_s", {})

    # ---- SLO report: p99s measured and bounded against the spec.
    report = router.slo_report()
    measured = report["measured"]
    slo_ok = (
        math.isfinite(measured["ttft_p99_s"])
        and math.isfinite(measured["itl_p99_s"])
        and measured["ttft_p99_s"] > 0
        and bool(report["compliant"]["overall"])
    )

    # ---- Stitched failover trace: ONE request's full life across the
    # killed replica and its survivor, under one trace id.
    trace = obs_spans.get_tracer().to_chrome_trace()
    failover_evs = [e for e in trace["traceEvents"]
                    if e.get("name") == "serve.failover"]
    trace_ok = False
    for ev in failover_evs:
        rid_str = ev["args"].get("request_id")
        chain = obs_spans.events_for_request(trace, rid_str)
        names = [e["name"] for e in chain]
        routes = {e["args"].get("replica") for e in chain
                  if e["name"] == "serve.router.route"}
        tids = {e["args"].get("trace_id") for e in chain}
        watermark = ev["args"].get("delivered")
        trace_ok = (
            "serve.router.admit" in names
            and "serve.request" in names
            and names.count("serve.failover") >= 1
            and len(routes) >= 2          # the dead replica AND a survivor
            and len(tids) == 1            # one stitched trace id
            and isinstance(watermark, int) and watermark >= 1
        )
        if trace_ok:
            break

    snt_once = demoted = None
    if kill_replica is not None:
        # ---- Seeded serve-sentry regressions: SNT007 (TTFT) and SNT008
        # (ITL) each trip exactly once per episode and demote the replica
        # in the router's view (sentry overlay -> SUSPECT -> unroutable).
        survivor = next(r for r in sorted(router.replicas)
                        if r != kill_replica)
        # Warm both streams AT their own rolling median (ratio ~= 1): arms
        # the min-history gate, clears any episode real traffic opened,
        # and resets the streaks — so the seeded regression below is the
        # only live one.
        for series in (router.serve_sentry._ttft, router.serve_sentry._itl):
            hist = series.get(survivor)
            base = float(np.median(list(hist))) if hist else 0.05
            for _ in range(10):
                if series is router.serve_sentry._ttft:
                    router.serve_sentry.observe_serve(ttft_s=base,
                                                      replica_id=survivor)
                else:
                    router.serve_sentry.observe_serve(itl_s=base,
                                                      replica_id=survivor)
        n0 = len(router.serve_sentry.findings)
        for _ in range(4):    # way past any rolling median, 4 consecutive
            router._observe_serve(ttft_s=1000.0, replica_id=survivor)
            router._observe_serve(itl_s=1000.0, replica_id=survivor)
        new_codes = [f.code for f in router.serve_sentry.findings[n0:]
                     if f.process_id == survivor]
        snt_once = (new_codes.count("SNT007") == 1
                    and new_codes.count("SNT008") == 1)
        router._sweep_health(force=True)
        demoted = router.replica_state(survivor) is ReplicaState.SUSPECT

    if kill_replica is not None:
        failover_ok = (killed["at"] is not None and failovers >= 1
                       and rerouted >= 1 and trace_ok and snt_once
                       and demoted and ready_after == n_replicas - 1)
    else:
        failover_ok = (failovers == 0 and rerouted == 0
                       and ready_after == n_replicas)
    ok = (
        states.get(RequestState.DONE, 0) == n_requests
        and streams_ok is not False
        and exactly_once
        and mismatches == 0
        and journal_empty
        and slo_ok
        and failover_ok
    )
    engine = next((rep.engine for rep in router.replicas.values()
                   if rep.engine is not None), None)
    line = {
        "selftest": "autodist_tpu_torch.serve.router",
        "ok": bool(ok),
        "n_requests": n_requests,
        "n_replicas": n_replicas,
        "completed": states.get(RequestState.DONE, 0),
        "dropped": n_requests - states.get(RequestState.DONE, 0),
        "streams_bit_identical_to_control": streams_ok,
        "exactly_once": bool(exactly_once),
        "failovers": failovers,
        "requests_rerouted": rerouted,
        "prefix_mismatches": mismatches,
        "failover_latency_s": round(
            float(snap.get("serve_router_failover_latency_s", 0.0)), 4),
        "replicas_ready_after_kill": ready_after,
        "journal_empty": bool(journal_empty),
        "p50_latency_s": round(lat.get("p50", float("nan")), 4),
        "p99_latency_s": round(lat.get("p99", float("nan")), 4),
        "ttft_p50_s": round(measured["ttft_p50_s"], 4),
        "ttft_p99_s": round(measured["ttft_p99_s"], 4),
        "itl_p50_s": round(measured["itl_p50_s"], 4),
        "itl_p99_s": round(measured["itl_p99_s"], 4),
        "slo_compliant": bool(report["compliant"]["overall"]),
        "burn_rate_fast": round(report["burn_rate"]["fast"], 3),
        "failover_trace_stitched": bool(trace_ok),
        "snt007_snt008_once_per_episode": snt_once,
        "sentry_demoted_replica": demoted,
        "wall_s": round(dt, 2),
        "device": engine.device.type if engine is not None else None,
    }
    if not ok:
        logging.warning(
            "router trial failed: states=%s streams_ok=%s "
            "exactly_once=%s failovers=%d rerouted=%d mismatches=%d "
            "journal_empty=%s ready=%d slo_ok=%s trace_ok=%s snt_once=%s "
            "demoted=%s",
            {s.value: n for s, n in states.items() if n}, streams_ok,
            exactly_once, failovers, rerouted, mismatches, journal_empty,
            ready_after, slo_ok, trace_ok, snt_once, demoted)
    return {"ok": bool(ok), "line": line, "results": list(results),
            "killed": killed["at"] is not None, "observed": observed}


def selftest_router(n_requests: int = 64, n_replicas: int = 3,
                    max_new: int = 10, kill_replica: int = 1,
                    seed: int = 0, n_slots: int = 8,
                    device="cuda") -> int:
    """The router acceptance proof; returns a process exit code.

    3 in-process replicas behind the router, 64 concurrent mock clients;
    one replica is killed mid-decode once it holds in-flight work. Bars:

    - every request completes exactly once (ledger-verified: no
      duplicate completion, no drop; the journal is empty at the end);
    - every delivered stream is **bit-identical** to an uninterrupted
      control run of the same prompt on a lone engine (greedy
      determinism across the failover's re-prefill);
    - at least one failover and one reroute actually happened;
    - the fleet view shows ``n_replicas - 1`` READY replicas afterwards;
    - the ``slo_report`` carries finite, bounded TTFT/ITL p99s and an
      overall-compliant verdict against the test spec;
    - ONE stitched chrome trace shows a rerouted request's full life —
      admit → route(replica A) → queue wait/prefill/decode → failover
      (journal watermark attached) → route(replica B) → delivery — all
      under one trace id;
    - seeded TTFT and ITL regressions trip SNT007/SNT008 exactly once
      per episode and demote the replica in the router's view.

    Beyond the JAX package's selftest, the same fleet first runs the
    prompts without the kill, and a straggler or sentry threshold its
    healthy replicas crossed on this host is raised above what they showed
    (:func:`calibrated_configs`): on a loaded host a healthy replica's
    prefill can read several times its rolling median, and a natural
    SNT007 would demote a survivor. Prints one JSON line (``device`` is
    the engines' device type; ``thresholds_raised`` the calibration).
    """
    import shutil
    import tempfile

    from autodist_tpu_torch.serve.server import mock_load_prompt

    rng = np.random.default_rng(seed)
    workdir = tempfile.mkdtemp(prefix="router-selftest-")
    prompts = [np.asarray(mock_load_prompt(rng, i), np.int32)
               for i in range(n_requests)]

    def fleet(tag, **kw):
        return build_test_fleet(
            n_replicas=n_replicas, n_slots=n_slots,
            journal_dir=os.path.join(workdir, tag),
            registry=M.MetricsRegistry(), device=device, **kw)

    router, control = fleet("kill-free")
    # Uninterrupted control streams (greedy, deterministic).
    expected = [control.generate(p, max_new) for p in prompts]
    try:
        calib = fleet_trial(router, prompts, max_new, expected=expected,
                            kill_replica=None)
        config, sentry_config, raised = calibrated_configs(
            calib["observed"], router.config, router.serve_sentry.config)
        router.stop(drain=False)
        router, _ = fleet("killed", config=config, sentry_config=sentry_config)
        out = fleet_trial(router, prompts, max_new, expected=expected,
                          kill_replica=kill_replica)
    finally:
        router.stop(drain=False)
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps(dict(out["line"], thresholds_raised={
        k: v["set_to"] for k, v in raised.items()})))
    return 0 if out["ok"] else 1
