"""One supervised serving replica: engine + batcher + typed readiness (the
port's counterpart of the JAX package's ``serve/replica.py``).

A :class:`Replica` wraps one
:class:`~autodist_tpu_torch.serve.engine.InferenceEngine` (built by a
caller-supplied ``engine_factory``) behind one
:class:`~autodist_tpu_torch.serve.batcher.ContinuousBatcher`, plus the
fault-tolerance wiring a single engine never needed:

- **Typed readiness** (:class:`ReplicaState`): ``STARTING`` while the
  factory builds the engine, ``READY`` when serving, ``DRAINING`` during a
  graceful drain, ``DEAD`` after a kill. ``SUSPECT`` is observer-side only
  (a :class:`~autodist_tpu_torch.ft.heartbeat.HealthMonitor` derives it
  from missed beats); a replica never claims it about itself.
- **State travels in the heartbeat payload** through the ft transports
  (:class:`~autodist_tpu_torch.ft.heartbeat.MemoryTransport` in process,
  ``FileTransport`` across processes), with the load signals a router
  routes on: ``outstanding`` work and page-pool utilization. ``/healthz``
  (``serve/server.py``) serves the same facts.
- **Step-time feed**: an optional ``aggregator`` (anything with
  ``observe_step(seconds)`` and ``tick()``) receives the batcher's
  scheduler tick durations.
- **Drain/restart**: :meth:`drain` runs the
  :class:`~autodist_tpu_torch.ft.drain.DrainController` sequence (quiesce →
  finish in-flight → persist leftovers with request ids and delivered
  watermarks), :meth:`restart` rebuilds the engine through the factory and
  returns to ``READY``. :meth:`kill` is the abrupt-death path: all work is
  shed typed through :meth:`ContinuousBatcher.die` and the beats stop.

Beyond the JAX replica, which leaves the replay of its journal to the
router in front of it: with ``replayed_path`` set, :meth:`start` replays
the journal at ``persist_path`` into the new batcher before ``READY`` and
consumes it, so a standalone replica restarted on the same directory
serves its drained work exactly once, and each replayed request's outcome
(``request_id``, ``state``, ``tokens``) is appended to ``replayed_path`` as
one JSON line when it finishes: the replayed work has no client connection
to answer.
"""
from __future__ import annotations

import json
import os
import threading
import time
from enum import Enum
from typing import Any, Callable, Optional

from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.ft.drain import DrainController
from autodist_tpu_torch.serve.batcher import Backpressure, ContinuousBatcher, GenRequest
from autodist_tpu_torch.utils import logging, retry

__all__ = ["Replica", "ReplicaState"]


class ReplicaState(Enum):
    """Typed readiness — the value the heartbeat payload carries.
    ``SUSPECT`` is assigned by the observer, never self-reported."""

    STARTING = "starting"
    READY = "ready"
    DRAINING = "draining"
    SUSPECT = "suspect"
    DEAD = "dead"


class Replica:
    """One engine + batcher under supervision, publishing typed readiness.

    ``replica_id`` is the process-id analog on the heartbeat transport;
    ``engine_factory()`` builds (or rebuilds, on :meth:`restart`) the
    engine. ``transport`` is any ft heartbeat transport. ``persist_path``
    roots the drain journal (ft/drain.py format v2).
    """

    def __init__(
        self,
        replica_id: int,
        engine_factory: Callable[[], Any],
        transport,
        persist_path: Optional[str] = None,
        max_queue: int = 256,
        drain_deadline_s: float = 30.0,
        heartbeat_interval_s: float = 1.0,
        aggregator=None,
        registry: Optional[M.MetricsRegistry] = None,
        slo=None,
        replayed_path: Optional[str] = None,
    ):
        self.replica_id = int(replica_id)
        self.engine_factory = engine_factory
        self.transport = transport
        self.persist_path = persist_path or os.path.join(
            ".", f"replica-{replica_id}-queue.json")
        self.max_queue = int(max_queue)
        self.drain_deadline_s = float(drain_deadline_s)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.aggregator = aggregator
        self.registry = registry or M.registry
        # Optional obs.slo.SLOTracker threaded into the batcher: GET /slo
        # renders it.
        self.slo = slo
        self.replayed_path = replayed_path

        self.engine = None
        self.batcher: Optional[ContinuousBatcher] = None
        self.drain_controller: Optional[DrainController] = None
        self.restarts = 0
        self._state = ReplicaState.STARTING
        self._state_lock = threading.Lock()
        self._log_lock = threading.Lock()
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------ state
    @property
    def state(self) -> ReplicaState:
        with self._state_lock:
            return self._state

    def _set_state(self, state: ReplicaState) -> None:
        with self._state_lock:
            if self._state is state:
                return
            self._state = state
        logging.info("replica %d -> %s", self.replica_id, state.value)
        self.publish_now()  # state changes beat immediately, not next tick

    @property
    def outstanding(self) -> int:
        """Queued + active work."""
        return self.batcher.outstanding if self.batcher is not None else 0

    @property
    def page_utilization(self) -> float:
        pool = getattr(self.engine, "pool", None)
        return float(pool.utilization) if pool is not None else 0.0

    def healthz(self) -> dict:
        """The readiness facts ``/healthz`` and the heartbeat payload share."""
        return {
            "replica_id": self.replica_id,
            "state": self.state.value,
            "outstanding": self.outstanding,
            "page_pool_utilization": round(self.page_utilization, 4),
            "restarts": self.restarts,
        }

    # -------------------------------------------------------------- heartbeat
    def publish_now(self) -> None:
        """One beat, immediately (through the transport's chaos seam)."""
        payload = {"time": time.time(), "pid": os.getpid(), **self.healthz()}
        try:
            self.transport.publish(self.replica_id, payload)
        except Exception as e:  # noqa: BLE001 - liveness signal, never fatal
            logging.warning("replica %d heartbeat publish failed (%s)",
                            self.replica_id, e)

    def _hb_loop(self) -> None:
        while not self._hb_stop.is_set():
            # A batcher that died under a READY replica (an engine death
            # mid-decode) is a dead replica: say so instead of beating
            # "ready". Orderly paths (drain, kill) change state first.
            if (self.state is ReplicaState.READY
                    and self.batcher is not None and self.batcher.stopped):
                logging.warning("replica %d: batcher died; reporting DEAD",
                                self.replica_id)
                self._set_state(ReplicaState.DEAD)
            self.publish_now()
            if self.aggregator is not None:
                try:
                    self.aggregator.tick()
                except Exception:  # noqa: BLE001 - observability never fatal
                    logging.warning("replica %d aggregator tick failed",
                                    self.replica_id, exc_info=True)
            self._hb_stop.wait(self.heartbeat_interval_s)

    # -------------------------------------------------------------- lifecycle
    def start(self) -> "Replica":
        """STARTING → build the engine → (replay the journal) → READY.
        Idempotent once READY."""
        if self.batcher is not None and self.state is ReplicaState.READY:
            return self
        self._set_state(ReplicaState.STARTING)
        if self._hb_thread is None:
            self._hb_stop.clear()
            self._hb_thread = threading.Thread(
                target=self._hb_loop, name=f"serve-replica-{self.replica_id}",
                daemon=True)
            self._hb_thread.start()
        self.engine = self.engine_factory()
        # Fleet schedules target one replica: the engine's chaos seam
        # context carries this replica's id.
        self.engine.chaos_host = self.replica_id
        on_tick = (self.aggregator.observe_step
                   if self.aggregator is not None else None)
        self.batcher = ContinuousBatcher(
            self.engine, max_queue=self.max_queue, registry=self.registry,
            on_tick=on_tick, slo=self.slo).start()
        self.drain_controller = DrainController(
            self.batcher, self.persist_path,
            drain_deadline_s=self.drain_deadline_s, registry=self.registry)
        if self.replayed_path is not None:
            for req in self.drain_controller.replay():
                req.add_done_callback(self._log_replayed)
        self._set_state(ReplicaState.READY)
        return self

    def _log_replayed(self, req: GenRequest) -> None:
        line = json.dumps({"request_id": req.request_id, "state": req.state.value,
                           "tokens": [int(t) for t in req.tokens]})
        with self._log_lock, open(self.replayed_path, "a", encoding="utf-8") as f:
            f.write(line + "\n")

    def submit(self, prompt, max_new_tokens: int = 32,
               timeout_s: Optional[float] = None,
               request_id: Optional[str] = None,
               sampling=None) -> GenRequest:
        """Admission passthrough (raises
        :class:`~autodist_tpu_torch.serve.batcher.Backpressure` when
        saturated or not started)."""
        if self.batcher is None:
            raise Backpressure(f"replica {self.replica_id} is not started")
        return self.batcher.submit(prompt, max_new_tokens,
                                   timeout_s=timeout_s,
                                   request_id=request_id,
                                   sampling=sampling)

    def quiesce(self) -> None:
        """Stop admitting; active decodes keep stepping."""
        self._set_state(ReplicaState.DRAINING)
        if self.drain_controller is not None:
            self.drain_controller.quiesce()

    def drain(self) -> dict:
        """Graceful drain: quiesce → finish in-flight within the deadline →
        persist leftovers (request ids + delivered watermarks) as
        ``PREEMPTED``. Returns ``{"drained": n, "persisted": n}``. The
        replica stays DRAINING until :meth:`restart`."""
        self._set_state(ReplicaState.DRAINING)
        if self.drain_controller is None:
            return {"drained": 0, "persisted": 0}
        out = self.drain_controller.shutdown()
        self.batcher = None
        self.drain_controller = None
        return out

    def restart(self) -> "Replica":
        """Rebuild through the factory (fresh engine state) and return to
        READY. Counted in ``restarts``."""
        if self.batcher is not None:
            # A restart over a live batcher is a hard bounce: shed typed.
            self.batcher.die(f"replica {self.replica_id} restarting")
            self.batcher = None
            self.drain_controller = None
        self.engine = None
        self.restarts += 1
        return self.start()

    def kill(self, reason: str = "replica killed") -> None:
        """Abrupt death: shed ALL work with typed engine-death rejections,
        go silent on the transport after one final DEAD beat."""
        with self._state_lock:
            self._state = ReplicaState.DEAD
        self._hb_stop.set()
        if self.batcher is not None:
            self.batcher.die(reason)
            self.batcher = None
            self.drain_controller = None
        self.publish_now()
        self._join_hb()

    def stop(self) -> None:
        """Orderly full stop: drain, then stop beating."""
        if self.batcher is not None:
            self.drain()
        self._hb_stop.set()
        self._join_hb()

    def _join_hb(self) -> None:
        thread, self._hb_thread = self._hb_thread, None
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5.0)

    def wait_ready(self, timeout_s: float = 60.0) -> bool:
        """Bounded readiness wait."""
        return retry.wait_until(
            lambda: self.state is ReplicaState.READY, timeout_s,
            interval_s=0.01)
