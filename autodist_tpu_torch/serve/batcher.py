"""Continuous batching: bounded admission queue + paged slot scheduler.

Ports the JAX package's ``serve/batcher.py``. Requests enter a bounded FIFO
(``submit`` raises :class:`Backpressure` when full); a single scheduler
thread admits under **page availability** (admission reserves a request's
whole ``prompt + max_new`` timeline in the engine's page pool,
all-or-nothing), advances every mid-prefill request by one fixed-size chunk
per tick, runs ONE decode step per tick across every decoding slot, and
retires sequences the moment they finish (EOS / ``max_new_tokens`` /
deadline), recycling their pages in the same tick.

The scheduler thread is the only thread that calls into the engine, and so
the only one that issues CUDA work; clients (``submit``, the asyncio front
end) only touch the queue.

Admission is typed end to end: a request that can NEVER run comes back from
``submit`` already terminal ``REJECTED``; a request the pool cannot place
YET stays queued. Metrics go through the port's
:mod:`~autodist_tpu_torch.metrics` registry: ``serve_queue_depth`` /
``serve_active_slots`` / ``serve_page_pool_utilization`` /
``serve_page_fragmentation`` gauges,
``serve_requests_{submitted,completed,timeout,rejected}_total`` and
``serve_tokens_generated_total`` counters, ``serve_tokens_per_sec`` and
``serve_decode_tokens_per_sec`` gauges, and ``serve_request_latency_s`` /
``serve_ttft_s`` / ``serve_itl_s`` histograms; int8-page engines add the
``serve_page_pool_{quant_capacity_x,physical_bytes,fp_equiv_bytes}`` gauges.
Engines exposing ``spec_stats()`` (speculative decode, ``serve/spec.py``)
publish ``serve_spec_acceptance_rate`` / ``serve_spec_tokens_per_step``; a
decode round then emits 1..k+1 tokens a slot, truncated at EOS /
``max_new_tokens`` / deadline where plain decode would have stopped.
Engines with a prefix cache publish ``serve_prefix_hit_rate`` /
``serve_prefix_shared_pages`` / ``serve_page_pool_sharing_ratio`` and split
TTFT into ``serve_ttft_cached_s`` / ``serve_ttft_uncached_s``.

The flight hooks are the JAX batcher's: an optional
:class:`~autodist_tpu_torch.obs.slo.SLOTracker` (``slo=``) fed TTFT, ITL,
queue wait and outcome at retire, sheds at the admission edge and the
spec acceptance window; an ``on_tick`` observer of each progressing tick's
seconds; ``shed`` and ``pool_pressure`` flight events, one per fixed
window (``_SHED_WINDOW_S``); a ``request`` step record at retire and a
``tick`` record every 32nd progressing tick; the ``serve.queue_wait`` span
at admission; and :meth:`ContinuousBatcher.die`, which sheds all work typed
on an engine death (the scheduler's own ``EngineDeadError`` path records an
``error`` event and sheds the same way).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional

import numpy as np

from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.obs import recorder as obs_recorder
from autodist_tpu_torch.obs import spans as obs_spans
from autodist_tpu_torch.serve import sampling as serve_sampling
from autodist_tpu_torch.serve.engine import (
    AdmissionDenied,
    EngineDeadError,
    InferenceEngine,
    Slot,
)
from autodist_tpu_torch.utils import logging, retry


class Backpressure(RuntimeError):
    """Admission queue full — the client should retry/shed (HTTP 429)."""


class RequestState(Enum):
    QUEUED = "queued"
    ACTIVE = "active"
    DONE = "done"
    TIMEOUT = "timeout"
    REJECTED = "rejected"
    # Terminal because the server is shutting down, not because the request
    # failed.
    PREEMPTED = "preempted"


_ids = itertools.count()


@dataclass
class GenRequest:
    """One generation request and its lifecycle."""

    prompt: np.ndarray
    max_new_tokens: int
    deadline: Optional[float] = None      # absolute time.monotonic() cutoff
    id: int = field(default_factory=lambda: next(_ids))
    request_id: str = ""                  # stable identity across processes
    t_submit: float = field(default_factory=time.monotonic)
    t_admit: Optional[float] = None        # engine admission (slot granted)
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    queue_wait_s: Optional[float] = None   # submit -> engine admission
    # True when admission mapped a cached prefix onto shared pages: TTFT
    # is attributed to the cached or the uncached histogram by it.
    cached: bool = False
    sampling: Optional[serve_sampling.SamplingParams] = None
    tokens: List[int] = field(default_factory=list)
    state: RequestState = RequestState.QUEUED
    error: str = ""
    # True when the request can NEVER be served by this engine (over the
    # static max_len ceiling): the HTTP edge maps it to 400.
    unservable: bool = False
    _event: threading.Event = field(default_factory=threading.Event, repr=False)
    _cb_lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    _callbacks: List[Callable[["GenRequest"], None]] = field(
        default_factory=list, repr=False)

    def __post_init__(self):
        if not self.request_id:
            self.request_id = f"g{os.getpid()}-{self.id}"

    def wait(self, timeout: Optional[float] = None) -> "GenRequest":
        """Block until terminal; returns self (check ``state``)."""
        self._event.wait(timeout)
        return self

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit

    @property
    def ttft_s(self) -> Optional[float]:
        """Time from engine ADMISSION to first token (queue wait is
        ``queue_wait_s``); falls back to submit when never admitted."""
        if self.t_first_token is None:
            return None
        base = self.t_admit if self.t_admit is not None else self.t_submit
        return self.t_first_token - base

    @property
    def itl_s(self) -> Optional[float]:
        """Mean inter-token latency over the decode phase."""
        if (self.t_done is None or self.t_first_token is None
                or len(self.tokens) < 2):
            return None
        return (self.t_done - self.t_first_token) / (len(self.tokens) - 1)

    def add_done_callback(self, fn: Callable[["GenRequest"], None]) -> None:
        """Run ``fn(request)`` on completion (from the scheduler thread);
        fires immediately if already terminal."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _finish(self, state: RequestState, error: str = "") -> None:
        with self._cb_lock:
            if self._event.is_set():
                return  # first writer wins
            self.state = state
            self.error = error
            self.t_done = time.monotonic()
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            try:
                fn(self)
            except Exception:  # noqa: BLE001 - a bad callback can't kill the loop
                logging.warning("request %d done-callback raised", self.id,
                                exc_info=True)


def make_rejected(prompt, max_new_tokens: int, error: str,
                  request_id: Optional[str] = None,
                  sampling: Optional[serve_sampling.SamplingParams] = None,
                  ) -> GenRequest:
    """Build an already-terminal typed-``REJECTED`` request."""
    try:
        arr = np.asarray(prompt, np.int32).ravel()
    except (TypeError, ValueError):
        arr = np.zeros(0, np.int32)
    req = GenRequest(prompt=arr, max_new_tokens=max_new_tokens,
                     request_id=request_id or "", sampling=sampling)
    req._finish(RequestState.REJECTED, f"admission rejected: {error}")
    return req


class ContinuousBatcher:
    """Request queue + scheduler around one paged :class:`InferenceEngine`.

    ``max_queue`` bounds admission (backpressure); the active batch is
    bounded by the engine itself (decode rows and page-pool capacity).
    ``start()`` spawns the scheduler thread; ``submit`` is thread-safe.
    ``on_tick(seconds)`` observes each progressing scheduler tick; ``slo``
    is an optional :class:`~autodist_tpu_torch.obs.slo.SLOTracker`.
    """

    def __init__(self, engine: InferenceEngine, max_queue: int = 256,
                 registry: Optional[M.MetricsRegistry] = None,
                 on_tick: Optional[Callable[[float], None]] = None,
                 slo=None):
        self.engine = engine
        self.max_queue = max_queue
        self.slo = slo
        self.on_tick = on_tick
        self._queue: deque[GenRequest] = deque()
        self._active: Dict[Slot, GenRequest] = {}
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._running = False
        self._stopped = False
        self._draining = False  # quiesced: no new admissions, finish active
        self._thread: Optional[threading.Thread] = None
        self._tick_tokens: deque = deque(maxlen=64)   # (t, n) for tokens/sec
        self._decode_tokens: deque = deque(maxlen=64)  # decode-only window
        # Shed and pool-pressure flight events: one per fixed window.
        self._shed_lock = threading.Lock()
        self._shed_last = -1e9   # monotonic stamp of the last window opened
        self._shed_count = 0
        self._pressure_last = -1e9
        self._SHED_WINDOW_S = 1.0
        # Per-instance shed-record source: the SLO replay keys its
        # cumulative-delta arithmetic by it.
        self._shed_src = f"batcher-{next(_ids)}"
        self._tick_seq = 0          # progressing ticks (flight sampling)
        # Cumulative spec counters last fed to the SLO tracker (blended and
        # per temperature bucket): it takes per-tick deltas.
        self._spec_last: Dict[str, int] = {}
        self._spec_last_bucket: Dict[str, Dict[str, int]] = {}
        # Gauges registered on first use, so engines without spec decode,
        # a prefix cache or int8 pages add no metric families.
        self._m_quant_capacity = None
        self._m_spec_accept = self._m_spec_tps = None
        self._m_ttft_cached = self._m_ttft_uncached = None
        self._m_prefix_hit = self._m_prefix_shared = self._m_sharing_ratio = None

        reg = registry or M.registry
        self._registry = reg
        self._m_depth = reg.gauge("serve_queue_depth")
        self._m_active = reg.gauge("serve_active_slots")
        self._m_pool_util = reg.gauge("serve_page_pool_utilization")
        self._m_frag = reg.gauge("serve_page_fragmentation")
        self._m_submitted = reg.counter("serve_requests_submitted_total")
        self._m_completed = reg.counter("serve_requests_completed_total")
        self._m_timeout = reg.counter("serve_requests_timeout_total")
        self._m_rejected = reg.counter("serve_requests_rejected_total")
        self._m_tokens = reg.counter("serve_tokens_generated_total")
        self._m_tps = reg.gauge("serve_tokens_per_sec")
        self._m_decode_tps = reg.gauge("serve_decode_tokens_per_sec")
        self._m_latency = reg.histogram("serve_request_latency_s")
        self._m_ttft = reg.histogram("serve_ttft_s")
        self._m_itl = reg.histogram("serve_itl_s")

    # ---------------------------------------------------------------- clients
    def submit(self, prompt, max_new_tokens: int = 32,
               timeout_s: Optional[float] = None,
               request_id: Optional[str] = None,
               sampling: Optional[serve_sampling.SamplingParams] = None,
               ) -> GenRequest:
        """Enqueue a request. Raises :class:`Backpressure` when the queue is
        full (or the batcher is stopped/draining) and the typed
        :class:`~autodist_tpu_torch.serve.sampling.InvalidSamplingParams`
        for malformed sampling params. A request over the engine's ceiling
        comes back already terminal ``REJECTED``."""
        prompt = np.asarray(prompt, np.int32).ravel()
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if sampling is not None:
            sampling.validate()
        req = GenRequest(
            prompt=prompt, max_new_tokens=max_new_tokens,
            deadline=(time.monotonic() + timeout_s) if timeout_s else None,
            request_id=request_id or "", sampling=sampling)
        denied = self.engine.check_admissible(len(prompt), max_new_tokens)
        if denied is not None:
            self._m_rejected.inc()
            self._shed("unservable request")
            req.unservable = True
            req._finish(RequestState.REJECTED,
                        f"admission rejected: {denied.reason}")
            return req
        shed_reason = None
        with self._wake:
            if self._stopped:
                shed_reason = "batcher is stopped"
            elif self._draining:
                shed_reason = "batcher is draining"
            elif len(self._queue) >= self.max_queue:
                shed_reason = f"admission queue full ({self.max_queue} requests)"
            else:
                self._queue.append(req)
                self._m_submitted.inc()
                self._m_depth.set(len(self._queue))
                self._wake.notify()
        if shed_reason is not None:
            self._m_rejected.inc()
            self._shed(shed_reason)
            raise Backpressure(shed_reason)
        return req

    def try_submit(self, prompt, max_new_tokens: int = 32,
                   timeout_s: Optional[float] = None,
                   request_id: Optional[str] = None,
                   sampling: Optional[serve_sampling.SamplingParams] = None,
                   ) -> GenRequest:
        """Admission that degrades *typed* instead of raising: a shed or
        invalid request comes back already terminal ``REJECTED``."""
        try:
            return self.submit(prompt, max_new_tokens, timeout_s=timeout_s,
                               request_id=request_id, sampling=sampling)
        except (Backpressure, ValueError) as e:
            return make_rejected(prompt, max_new_tokens, str(e),
                                 request_id=request_id, sampling=sampling)

    def submit_with_retry(self, prompt, max_new_tokens: int = 32,
                          timeout_s: Optional[float] = None,
                          policy: Optional[retry.RetryPolicy] = None,
                          ) -> GenRequest:
        """Client-side admission under backpressure through the ONE retry
        layer (``utils/retry.py``)."""
        policy = policy or retry.RetryPolicy(
            initial_s=0.02, max_s=1.0, max_attempts=8, deadline_s=10.0)
        try:
            return retry.retry_call(
                lambda: self.submit(prompt, max_new_tokens, timeout_s=timeout_s),
                policy=policy, retry_on=(Backpressure,),
                describe="serve admission")
        except retry.RetryError as e:
            raise Backpressure(str(e)) from e.__cause__

    def _shed(self, reason: str) -> None:
        """Flight-record a load-shedding decision. One event opens each
        fixed window (rejections less than ``_SHED_WINDOW_S`` apart share
        it) and carries the cumulative count, so a sustained storm keeps
        emitting one record a window and the SLO replay recovers every
        shed. Feeds the SLO tracker one shed per call."""
        now = time.monotonic()
        with self._shed_lock:
            opens = now - self._shed_last > self._SHED_WINDOW_S
            if opens:
                self._shed_last = now
            self._shed_count += 1
            n = self._shed_count
        if opens:
            obs_recorder.record_event("shed", critical=False, src=self._shed_src,
                                      reason=reason, total_shed=n,
                                      pool_free_pages=self.engine.pool.free_pages)
        if self.slo is not None:
            self.slo.observe(ok=False, shed=True)

    def _pool_pressure(self, reason: str) -> None:
        """Flight-record page-pool pressure (fixed windows, like
        :meth:`_shed`): admission defers because pages, not the queue
        bound, are the limiter. A signal, not a failure."""
        now = time.monotonic()
        with self._shed_lock:
            opens = now - self._pressure_last > self._SHED_WINDOW_S
            if opens:
                self._pressure_last = now
        if opens:
            obs_recorder.record_event(
                "pool_pressure", critical=False, reason=reason,
                free_pages=self.engine.pool.free_pages,
                used_pages=self.engine.pool.used_pages,
                queue_depth=len(self._queue))

    # -------------------------------------------------------------- accounting
    @property
    def stopped(self) -> bool:
        with self._lock:
            return self._stopped

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def outstanding(self) -> int:
        """Queued + active request count."""
        with self._lock:
            return len(self._queue) + len(self._active)

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "ContinuousBatcher":
        with self._lock:
            if self._running:
                return self
            self._running = True
            self._stopped = False
            self._draining = False
        self._thread = threading.Thread(
            target=self._loop, name="serve-batcher", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Stop the scheduler; ``drain=True`` finishes in-flight + queued work
        first. Whatever is still undone is failed terminally, so no client
        blocks forever."""
        if drain and self._thread is not None:
            def idle() -> bool:
                with self._lock:
                    return not self._queue and not self._active

            retry.wait_until(idle, timeout_s, interval_s=0.01)
        with self._wake:
            self._running = False
            self._stopped = True
            self._wake.notify()
        stuck = self._join_scheduler(timeout_s)
        self._fail_all("batcher stopped before this request completed",
                       release=not stuck)

    def _join_scheduler(self, timeout_s: float) -> bool:
        """Join the scheduler thread; True when it OUTLIVED the timeout (then
        the caller must not touch engine slot state)."""
        thread = self._thread
        if thread is None:
            return False
        thread.join(timeout=timeout_s)
        self._thread = None
        if thread.is_alive():
            logging.warning(
                "serve scheduler still running after %.1fs join; leaving "
                "engine slot state to it", timeout_s)
            return True
        return False

    def die(self, reason: str) -> None:
        """Abrupt death (replica kill, chaos): shed ALL queued and in-flight
        work with typed ``REJECTED`` results carrying an engine-death
        reason, flight-record the error and stop — the contract of the
        scheduler's own ``EngineDeadError`` path, callable from outside the
        scheduler thread. Idempotent; never blocks a client."""
        with self._wake:
            already = self._stopped
            self._running = False
            self._stopped = True
            self._wake.notify()
        if already:
            return
        self._record_death(reason)
        stuck = self._join_scheduler(2.0)
        self._fail_all(f"engine died mid-decode: {reason}",
                       release=not stuck)

    def _record_death(self, reason) -> None:
        """An engine death in the flight record, and one shed."""
        obs_recorder.record_event(
            "error", error=f"EngineDeadError: {reason}"[:500])
        self._shed(f"engine dead: {reason}")

    def quiesce(self) -> None:
        """Stop admitting while active decodes keep stepping."""
        with self._wake:
            self._draining = True
            self._wake.notify()

    def drain(self, deadline_s: float = 30.0):
        """Graceful shutdown: quiesce, let in-flight decodes finish within
        ``deadline_s``, then stop. Returns ``(n_finished, leftovers)``; the
        leftovers are finished ``PREEMPTED`` (the
        :class:`~autodist_tpu_torch.ft.drain.DrainController` persists them
        for replay)."""
        before = self._m_completed.value
        self.quiesce()
        if self._thread is not None:
            def no_active() -> bool:
                with self._lock:
                    return not self._active

            retry.wait_until(no_active, deadline_s, interval_s=0.005)
        with self._wake:
            self._running = False
            self._stopped = True
            self._wake.notify()
        stuck = self._join_scheduler(max(1.0, deadline_s))
        with self._lock:
            active = list(self._active.items())
            self._active.clear()
            leftovers = list(self._queue)
            self._queue.clear()
            self._m_depth.set(0)
            self._m_active.set(0)
        if not stuck:
            for slot, _req in active:
                self.engine.release(slot)
        leftovers = [req for _, req in active] + leftovers
        for req in leftovers:
            req._finish(RequestState.PREEMPTED,
                        "server draining; request persisted for replay")
        return int(self._m_completed.value - before), leftovers

    def __enter__(self) -> "ContinuousBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- scheduler
    def _loop(self) -> None:
        while True:
            with self._wake:
                if not self._running:
                    break
                if not self._queue and not self._active:
                    self._wake.wait(timeout=0.5)
                    continue
            try:
                t_tick = time.monotonic()
                progressed = self._tick()
                if progressed:
                    self._tick_seq += 1
                    if self._tick_seq % 32 == 1:
                        # Sampled tick record: occupancy, prefill/decode
                        # mix, pool utilization, tick wall.
                        obs_recorder.record_step(
                            surface="serve", event="tick",
                            tick_wall_s=round(time.monotonic() - t_tick, 6),
                            active=self.engine.active_slots,
                            prefilling=self.engine.prefilling_slots,
                            decoding=self.engine.decoding_slots,
                            pool_utilization=round(
                                float(self.engine.page_utilization), 4),
                            queue_depth=len(self._queue))
                    if self.on_tick is not None:
                        try:
                            self.on_tick(time.monotonic() - t_tick)
                        except Exception:  # noqa: BLE001 - observer only
                            logging.warning("on_tick observer raised",
                                            exc_info=True)
                else:
                    # Nothing progressed (a page-pressure window): pace the
                    # poll instead of spinning; submit/retire notify.
                    with self._wake:
                        if self._running:
                            self._wake.wait(timeout=0.02)
            except EngineDeadError as e:
                logging.error("engine died mid-decode; shedding all work: %s", e)
                self._record_death(e)
                with self._wake:
                    self._running = False
                    self._stopped = True
                self._fail_all(f"engine died mid-decode: {e}")
                break
            except Exception:  # noqa: BLE001 - scheduler must survive
                logging.warning("batcher tick failed", exc_info=True)
                self._fail_all("scheduler tick failed; see server log")

    def _fail_all(self, msg: str, release: bool = True) -> None:
        """Terminally fail everything (``release=False`` when a live
        scheduler thread may still own the engine)."""
        with self._lock:
            active = list(self._active.items())
            self._active.clear()
            queued = list(self._queue)
            self._queue.clear()
            self._m_depth.set(0)
        for slot, req in active:
            if release:
                self.engine.release(slot)
            req._finish(RequestState.REJECTED, msg)
        for req in queued:
            req._finish(RequestState.REJECTED, msg)
        self._m_rejected.inc(len(active) + len(queued))

    def _tick(self) -> bool:
        """One scheduler iteration: expire → admit → prefill → decode →
        retire. Returns whether anything progressed."""
        progress = False
        now = time.monotonic()

        with self._lock:
            expired = [r for r in self._queue
                       if r.deadline is not None and now > r.deadline]
            for r in expired:
                self._queue.remove(r)
            self._m_depth.set(len(self._queue))
        for r in expired:
            self._m_timeout.inc()
            progress = True
            r._finish(RequestState.TIMEOUT, "deadline expired in queue")

        # Admission: FIFO while the engine can place the head (host
        # bookkeeping only; runs outside the lock — only this thread pops).
        while True:
            dead = None
            with self._lock:
                if self._draining or not self._queue:
                    break
                head = self._queue[0]
                if head.deadline is not None and time.monotonic() > head.deadline:
                    dead = self._queue.popleft()
                    self._m_depth.set(len(self._queue))
            if dead is not None:
                self._m_timeout.inc()
                progress = True
                dead._finish(RequestState.TIMEOUT, "deadline expired in queue")
                continue
            t_admit, t_admit_wall = time.monotonic(), time.time()
            admitted = self.engine.admit(head.prompt, head.max_new_tokens,
                                         request_id=head.request_id,
                                         sampling=head.sampling)
            if isinstance(admitted, AdmissionDenied):
                if admitted.retryable:
                    # Pages/rows free on retirement: keep it queued.
                    self._pool_pressure(admitted.reason)
                    break
                with self._lock:
                    self._queue.popleft()
                    self._m_depth.set(len(self._queue))
                self._m_rejected.inc()
                progress = True
                head.unservable = True
                head._finish(RequestState.REJECTED,
                             f"admission rejected: {admitted.reason}")
                continue
            # The queue-wait span, recorded now the wait is known (submit to
            # admission; the prefill-chunk spans follow on the same timeline).
            wait_s = max(t_admit - head.t_submit, 0.0)
            head.queue_wait_s = wait_s
            head.t_admit = t_admit
            obs_spans.add_span("serve.queue_wait", t_admit_wall - wait_s,
                               wait_s, request_id=head.request_id)
            with self._lock:
                self._queue.popleft()
                self._m_depth.set(len(self._queue))
                head.state = RequestState.ACTIVE
                self._active[admitted] = head
            progress = True

        # Chunked prefill: every mid-prefill slot advances ONE chunk per tick.
        for slot in self.engine.prefill_pending():
            with self._lock:
                req = self._active.get(slot)
            if req is None:
                continue
            if req.deadline is not None and time.monotonic() > req.deadline:
                self._retire(slot, req, RequestState.TIMEOUT,
                             "deadline expired mid-prefill")
                progress = True
                continue
            first = self.engine.prefill_step(slot)
            progress = True
            if first is None:
                continue
            req.t_first_token = time.monotonic()
            req.tokens.append(first)
            req.cached = self.engine.slot_cached(slot)
            self._observe_ttft(req)
            self._count_tokens(1)
            self._maybe_retire(slot, req)

        # One decode round over every decoding slot.
        with self._lock:
            have_active = bool(self._active)
        if have_active:
            emitted = self.engine.step_many()
            progress = progress or bool(emitted)
            n_appended = 0
            eos = self.engine.decode_model.eos_id
            for slot, tokens in emitted.items():
                with self._lock:
                    req = self._active.get(slot)
                if req is None:
                    continue
                for token in tokens:
                    req.tokens.append(token)
                    n_appended += 1
                    if (len(req.tokens) >= req.max_new_tokens
                            or (eos is not None and token == eos)):
                        break
                    if (req.deadline is not None
                            and time.monotonic() > req.deadline):
                        break
                self._maybe_retire(slot, req)
            self._count_tokens(n_appended, decode=True)
        self._update_spec_metrics()
        self._update_prefix_metrics()
        self._update_quant_metrics()
        with self._lock:
            self._m_active.set(len(self._active))
        self._m_pool_util.set(self.engine.page_utilization)
        self._m_frag.set(self.engine.page_fragmentation)
        return progress

    def _observe_ttft(self, req: GenRequest) -> None:
        ttft = req.ttft_s
        self._m_ttft.observe(ttft)
        if self.engine.prefix_cache is None:
            return
        if self._m_ttft_cached is None:
            self._m_ttft_cached = self._registry.histogram("serve_ttft_cached_s")
            self._m_ttft_uncached = self._registry.histogram("serve_ttft_uncached_s")
        (self._m_ttft_cached if req.cached else self._m_ttft_uncached).observe(ttft)

    def _update_spec_metrics(self) -> None:
        """Acceptance rate and tokens a round from the engine's cumulative
        ``spec_stats()`` (speculative engines only), and the SLO tracker's
        acceptance windows fed per-tick deltas: blended, then per
        temperature bucket (a bucketed sample feeds only its bucket)."""
        stats_fn = getattr(self.engine, "spec_stats", None)
        if stats_fn is None:
            return
        stats = stats_fn()
        if self._m_spec_accept is None:
            self._m_spec_accept = self._registry.gauge("serve_spec_acceptance_rate")
            self._m_spec_tps = self._registry.gauge("serve_spec_tokens_per_step")
        self._m_spec_accept.set(float(stats["acceptance_rate"]))
        self._m_spec_tps.set(float(stats["tokens_per_round"]))
        if self.slo is not None:
            d_prop = int(stats["proposed"]) - self._spec_last.get("proposed", 0)
            d_acc = int(stats["accepted"]) - self._spec_last.get("accepted", 0)
            if d_prop > 0:
                self.slo.observe(spec_proposed=d_prop, spec_accepted=d_acc)
            for b, bs in stats["by_temperature"].items():
                last = self._spec_last_bucket.get(b, {"proposed": 0, "accepted": 0})
                bp, ba = int(bs["proposed"]), int(bs["accepted"])
                if bp - last["proposed"] > 0:
                    self.slo.observe(spec_proposed=bp - last["proposed"],
                                     spec_accepted=ba - last["accepted"],
                                     spec_bucket=b)
                self._spec_last_bucket[b] = {"proposed": bp, "accepted": ba}
        self._spec_last = {"proposed": int(stats["proposed"]),
                           "accepted": int(stats["accepted"])}

    def _update_prefix_metrics(self) -> None:
        """Hit rate, shared pages and the logical/physical sharing ratio
        (engines with a prefix cache only). ``serve_page_pool_utilization``
        already counts physical pages: the pool allocates a shared page
        once."""
        if self.engine.prefix_cache is None:
            return
        if self._m_prefix_hit is None:
            self._m_prefix_hit = self._registry.gauge("serve_prefix_hit_rate")
            self._m_prefix_shared = self._registry.gauge("serve_prefix_shared_pages")
            self._m_sharing_ratio = self._registry.gauge("serve_page_pool_sharing_ratio")
        stats = self.engine.prefix_stats()
        self._m_prefix_hit.set(float(stats["hit_rate"]))
        self._m_prefix_shared.set(float(stats["shared_pages"]))
        self._m_sharing_ratio.set(float(self.engine.sharing_ratio))

    def _update_quant_metrics(self) -> None:
        """Publish the physical-vs-fp-equivalent pool byte split (int8-page
        engines only)."""
        if not self.engine.kv_quant:
            return
        if self._m_quant_capacity is None:
            self._m_quant_capacity = self._registry.gauge(
                "serve_page_pool_quant_capacity_x")
            self._registry.gauge("serve_page_pool_physical_bytes").set(
                float(self.engine.page_pool_bytes))
            self._registry.gauge("serve_page_pool_fp_equiv_bytes").set(
                float(self.engine.page_pool_fp_equiv_bytes))
        self._m_quant_capacity.set(float(self.engine.quant_capacity_x))

    def _maybe_retire(self, slot: Slot, req: GenRequest) -> None:
        """Finish + recycle the slot's pages when the sequence is done."""
        now = time.monotonic()
        eos = self.engine.decode_model.eos_id
        state = None
        if req.deadline is not None and now > req.deadline:
            state, why = RequestState.TIMEOUT, "deadline expired mid-decode"
        elif eos is not None and req.tokens and req.tokens[-1] == eos:
            state, why = RequestState.DONE, ""
        elif len(req.tokens) >= req.max_new_tokens:
            state, why = RequestState.DONE, ""
        if state is None:
            return
        self._retire(slot, req, state, why)

    def _retire(self, slot: Slot, req: GenRequest, state: RequestState,
                why: str) -> None:
        with self._lock:
            self._active.pop(slot, None)
        self.engine.release(slot)
        (self._m_timeout if state is RequestState.TIMEOUT
         else self._m_completed).inc()
        req._finish(state, why)
        self._m_latency.observe(time.monotonic() - req.t_submit)
        itl = req.itl_s
        if itl is not None:
            self._m_itl.observe(itl)
        # One request-level flight record: the SLO inputs survive the
        # process (obs/slo.py's replay_flight_records recomputes the SLO
        # position postmortem).
        temp = (float(req.sampling.temperature)
                if req.sampling is not None else 0.0)
        obs_recorder.record_step(
            surface="serve", event="request", request_id=req.request_id,
            state=state.value, n_tokens=len(req.tokens),
            ttft_s=req.ttft_s, itl_s=itl, queue_wait_s=req.queue_wait_s,
            cached=req.cached, temperature=temp)
        if self.slo is not None:
            # itl_tokens weights the sample by the inter-token gaps it
            # summarizes: ITL percentiles are per token, not per request.
            self.slo.observe(ttft_s=req.ttft_s, itl_s=itl,
                             itl_tokens=max(len(req.tokens) - 1, 1),
                             queue_wait_s=req.queue_wait_s,
                             ok=state is RequestState.DONE,
                             cached=req.cached, temperature=temp)
        with self._wake:
            self._wake.notify()  # pages freed: admission may proceed

    def _count_tokens(self, n: int, decode: bool = False) -> None:
        self._m_tokens.inc(n)
        now = time.monotonic()
        for window, gauge, on in ((self._tick_tokens, self._m_tps, True),
                                  (self._decode_tokens, self._m_decode_tps, decode)):
            if not on:
                continue
            window.append((now, n))
            recent = [(t, k) for t, k in window if now - t <= 5.0]
            if len(recent) >= 2 and now - recent[0][0] > 0:
                gauge.set(sum(k for _, k in recent) / (now - recent[0][0]))
