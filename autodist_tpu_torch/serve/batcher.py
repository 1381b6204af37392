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
    """

    def __init__(self, engine: InferenceEngine, max_queue: int = 256,
                 registry: Optional[M.MetricsRegistry] = None):
        self.engine = engine
        self.max_queue = max_queue
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
        self._m_quant_capacity = None

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
        for params that cannot be served (``temperature > 0`` included). A
        request over the engine's ceiling comes back already terminal
        ``REJECTED``."""
        prompt = np.asarray(prompt, np.int32).ravel()
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        serve_sampling.check_supported(sampling)
        req = GenRequest(
            prompt=prompt, max_new_tokens=max_new_tokens,
            deadline=(time.monotonic() + timeout_s) if timeout_s else None,
            request_id=request_id or "", sampling=sampling)
        denied = self.engine.check_admissible(len(prompt), max_new_tokens)
        if denied is not None:
            self._m_rejected.inc()
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

    def quiesce(self) -> None:
        """Stop admitting while active decodes keep stepping."""
        with self._wake:
            self._draining = True
            self._wake.notify()

    def drain(self, deadline_s: float = 30.0):
        """Graceful shutdown: quiesce, let in-flight decodes finish within
        ``deadline_s``, then stop. Returns ``(n_finished, leftovers)``; the
        leftovers are finished ``PREEMPTED``."""
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
            req._finish(RequestState.PREEMPTED, "server draining")
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
                if not self._tick():
                    # Nothing progressed (a page-pressure window): pace the
                    # poll instead of spinning; submit/retire notify.
                    with self._wake:
                        if self._running:
                            self._wake.wait(timeout=0.02)
            except EngineDeadError as e:
                logging.error("engine died mid-decode; shedding all work: %s", e)
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
            t_admit = time.monotonic()
            admitted = self.engine.admit(head.prompt, head.max_new_tokens,
                                         sampling=head.sampling)
            if isinstance(admitted, AdmissionDenied):
                if admitted.retryable:
                    break  # pages/rows free on retirement: keep it queued
                with self._lock:
                    self._queue.popleft()
                    self._m_depth.set(len(self._queue))
                self._m_rejected.inc()
                progress = True
                head.unservable = True
                head._finish(RequestState.REJECTED,
                             f"admission rejected: {admitted.reason}")
                continue
            head.queue_wait_s = max(t_admit - head.t_submit, 0.0)
            head.t_admit = t_admit
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
            self._m_ttft.observe(req.ttft_s)
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
        self._update_quant_metrics()
        with self._lock:
            self._m_active.set(len(self._active))
        self._m_pool_util.set(self.engine.page_utilization)
        self._m_frag.set(self.engine.page_fragmentation)
        return progress

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
