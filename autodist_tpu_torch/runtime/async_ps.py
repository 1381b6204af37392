"""Host-driven asynchronous parameter server, the ``sync=False`` rendering
(PyTorch port of ``runtime/async_ps.py``).

A train step whose ranks run in lockstep cannot express a worker that does
not wait; the asynchrony lives in the host's schedule instead:

- one store (:class:`ParamServer`) owns the params and optimizer slots
  behind a lock, with a ``version`` that one applied push bumps;
- ``n_workers`` workers each loop pull -> gradient -> push. A push applies
  at once through the port's :class:`~autodist_tpu_torch.model_item.Optimizer`
  on the server's copy: no accumulation and no waiting for the others, so
  a worker's gradient may be stale by the pushes of the others;
- ``staleness=K > 0`` bounds the lag (SSP): a push whose snapshot is more
  than K versions behind is rejected (the gradient is dropped) and the
  worker pulls again; ``staleness=0`` is unbounded.

A push makes new parameter tensors (``p + u``) and never writes into the
old ones, so a pulled snapshot stays as it was while others push. Workers
are threads of this process pinned round-robin over the local CUDA
devices (all on ``cuda:0`` with one card), each with its own CUDA stream;
a worker synchronizes its stream before it pushes, and the server its
stream after an update, before the new version is visible. On the CPU the
workers are plain threads.

Two schedules: ``"threads"`` (real threads, nondeterministic interleaving)
and ``"round_robin"`` (on the calling thread, deterministic: every worker
pulls the same snapshot, then the pushes apply in worker order).
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.model_item import Optimizer
from autodist_tpu_torch.models.convert import flatten_params, map_tree, unflatten_params
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.device import resolve_device


@dataclass
class AsyncServerState:
    """The server's training state: params (a nested dict of tensors on
    the server's device), optimizer state and the count of applied pushes."""

    params: Any
    opt_state: Any
    version: int = 0


@dataclass
class AsyncMetrics:
    """Per-push records, in apply order."""

    losses: List[float] = field(default_factory=list)
    lags: List[int] = field(default_factory=list)       # version - snapshot
    workers: List[int] = field(default_factory=list)    # who pushed
    wall_s: float = 0.0

    @property
    def max_lag(self) -> int:
        return max(self.lags) if self.lags else 0

    def summary(self) -> Dict[str, float]:
        return {
            "pushes": len(self.losses),
            "last_loss": self.losses[-1] if self.losses else float("nan"),
            "max_lag": self.max_lag,
            "pushes_per_sec": (len(self.losses) / self.wall_s)
            if self.wall_s > 0 else float("nan"),
        }


def _floating_names(params) -> List[str]:
    return [n for n, t in flatten_params(params).items() if t.is_floating_point()]


class ParamServer:
    """The shared store. ``pull`` returns the current params and their
    version; ``push`` applies one worker's gradient at once. ``device``
    defaults to ``"cuda"`` (a restored ``state`` stays where it lies)."""

    def __init__(self, params, tx: Optimizer, staleness: int = 0,
                 device: Optional[torch.device] = None,
                 state: Optional[AsyncServerState] = None):
        self._tx = tx
        self._lock = threading.Lock()
        if state is not None:
            # Adopt a restored state as it is: no fresh slots.
            self.state = state
            first = next(iter(flatten_params(state.params).values()))
            self._device = torch.device(device) if device is not None else first.device
        else:
            self._device = resolve_device(device)
            params = map_tree(lambda t: t.detach().to(self._device).clone(), params)
            self.state = AsyncServerState(
                params=params,
                opt_state=tx.init([flatten_params(params)[n]
                                   for n in _floating_names(params)]))
        self.staleness = int(staleness)
        self.metrics = AsyncMetrics()

    @property
    def device(self) -> torch.device:
        return self._device

    def pull(self):
        with self._lock:
            return self.state.params, self.state.version

    def push(self, grads, snapshot_version: int, worker: int,
             loss: Optional[float] = None) -> int:
        """Apply ``grads`` (nested like the params) computed against
        ``snapshot_version``. Returns the new version, or -1 when the
        snapshot is more than ``staleness`` versions behind (SSP: nothing
        is applied; the caller pulls again). With ``staleness=0`` every
        push applies."""
        with self._lock:
            lag = self.state.version - snapshot_version
            if self.staleness > 0 and lag > self.staleness:
                logging.debug("async-ps: worker %d snapshot v%d is %d > K=%d behind; "
                              "re-pull", worker, snapshot_version, lag, self.staleness)
                return -1
            flat = flatten_params(self.state.params)
            names = _floating_names(self.state.params)
            gflat = flatten_params(grads)
            with torch.no_grad():
                leaves = [flat[n] for n in names]
                updates = self._tx.update([gflat[n].to(self._device) for n in names],
                                          self.state.opt_state, leaves)
                flat.update({n: p + u.to(p.dtype) for n, p, u in zip(names, leaves, updates)})
            self.state.params = unflatten_params(flat)
            if self._device.type == "cuda":
                torch.cuda.current_stream(self._device).synchronize()
            self.state.version += 1
            if loss is not None:
                self.metrics.losses.append(float(loss))
            self.metrics.lags.append(lag)
            self.metrics.workers.append(worker)
            return self.state.version


class AsyncPSTrainer:
    """The asynchronous trainer ``AutoDist.build`` returns for a
    ``sync=False`` strategy. ``init(params)`` builds the server state;
    ``run(state, next_batch, n_pushes)`` applies ``n_pushes`` pushes,
    ``next_batch(tick)`` giving each pull's batch (tick counts down from
    ``n_pushes - 1``), and returns ``(state, metrics)``. The server lives
    on ``device`` (default ``"cuda"``, raising without a card); the workers
    on the local CUDA devices round-robin, or on the CPU with it."""

    def __init__(self, loss_fn: Callable, tx: Optimizer, n_workers: int,
                 staleness: int = 0, schedule: str = "threads", has_aux: bool = False,
                 device=None):
        if schedule not in ("threads", "round_robin"):
            raise ValueError(f"unknown schedule {schedule!r}")
        if n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        self.loss_fn = loss_fn
        self.tx = tx
        self.n_workers = n_workers
        self.staleness = int(staleness)
        self.schedule = schedule
        self.has_aux = has_aux
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            self.devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            self.devices = [self.device]
        self._server: Optional[ParamServer] = None
        self._c_pushes = M.registry.counter("async_ps_pushes_total")
        self._g_version = M.registry.gauge("async_ps_version")
        self._g_loss = M.registry.gauge("async_ps_last_loss")
        self._g_pps = M.registry.gauge("async_ps_pushes_per_sec")
        self._h_lag = M.registry.histogram("async_ps_push_lag")
        # Pushes of the current server already published to the registry.
        self._published = 0

    # ------------------------------------------------------------------ api
    def init(self, params) -> AsyncServerState:
        self._server = ParamServer(params, self.tx, staleness=self.staleness,
                                   device=self.device)
        self._published = 0
        return self._server.state

    def value_and_grad(self, params, batch, device: torch.device):
        """``(loss, grads)`` of ``batch`` at ``params`` on ``device``: the
        worker's computation (grads nested like the params, an unused one
        as zeros)."""
        flat = flatten_params(params)
        targets = {n: t.detach().to(device).requires_grad_(True)
                   for n, t in flat.items() if t.is_floating_point()}
        leaves = {n: targets.get(n, t.to(device) if torch.is_tensor(t) else t)
                  for n, t in flat.items()}
        batch = map_tree(lambda t: t.to(device) if torch.is_tensor(t) else t, batch)
        out = self.loss_fn(unflatten_params(leaves), batch)
        loss = out[0] if self.has_aux else out
        names = list(targets)
        grads = torch.autograd.grad(loss, [targets[n] for n in names], allow_unused=True)
        return loss.detach(), unflatten_params(
            {n: torch.zeros_like(targets[n]) if g is None else g
             for n, g in zip(names, grads)})

    def _worker_loop(self, server: ParamServer, worker: int,
                     next_batch: Callable[[int], Any], budget: List[int],
                     budget_lock: threading.Lock):
        dev = self.devices[worker % len(self.devices)]
        stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            while True:
                with budget_lock:
                    if budget[0] <= 0:
                        return
                    budget[0] -= 1
                    tick = budget[0]
                params, version = server.pull()
                loss, grads = self.value_and_grad(params, next_batch(tick), dev)
                if stream is not None:
                    stream.synchronize()
                if server.push(grads, version, worker, loss=float(loss)) < 0:
                    # Over the staleness bound: the tick returns to the budget.
                    with budget_lock:
                        budget[0] += 1

    def run(self, state: AsyncServerState, next_batch: Callable[[int], Any],
            n_pushes: int):
        """``n_pushes`` asynchronous updates; ``(state, metrics)``."""
        server = self._server
        if server is None or server.state is not state:
            # A state from elsewhere (a restored checkpoint) is adopted as it
            # is, slots included.
            server = ParamServer(None, self.tx, staleness=self.staleness,
                                 device=self.device, state=state)
            self._server = server
            self._published = 0
        t0 = time.perf_counter()
        if self.schedule == "round_robin":
            self._run_round_robin(server, next_batch, n_pushes)
        else:
            budget, budget_lock = [n_pushes], threading.Lock()
            errors: List[BaseException] = []

            def target(w):
                try:
                    self._worker_loop(server, w, next_batch, budget, budget_lock)
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errors.append(e)
                    with budget_lock:
                        budget[0] = 0

            threads = [threading.Thread(target=target, args=(w,), daemon=True)
                       for w in range(self.n_workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            if errors:
                raise errors[0]
        server.metrics.wall_s += time.perf_counter() - t0
        m = server.metrics
        self._publish(server)
        return server.state, {
            "loss": np.asarray(m.losses, np.float32),
            "lag": np.asarray(m.lags, np.int32),
            "worker": np.asarray(m.workers, np.int32),
            **m.summary(),
        }

    def _publish(self, server: ParamServer) -> None:
        """The registry from this server's per-push records (counters by
        delta, gauges as they stand)."""
        m = server.metrics
        new_pushes = len(m.losses) - self._published
        if new_pushes > 0:
            self._published = len(m.losses)
            self._c_pushes.inc(new_pushes)
            for lag in m.lags[-new_pushes:]:
                self._h_lag.observe(float(lag))
        self._g_version.set(server.state.version)
        if m.losses:
            self._g_loss.set(m.losses[-1])
        s = m.summary()
        if s["pushes_per_sec"] == s["pushes_per_sec"]:  # not NaN
            self._g_pps.set(s["pushes_per_sec"])

    def _run_round_robin(self, server: ParamServer, next_batch: Callable[[int], Any],
                         n_pushes: int):
        """Rounds of (every worker pulls the same snapshot) then (the pushes
        apply in worker order): worker w's gradient lands on params that
        workers < w already moved."""
        tick = n_pushes
        pending: List = []
        while tick > 0 or pending:
            if not pending:
                k = min(self.n_workers, tick)
                snapshots = [server.pull() for _ in range(k)]
                for w in range(k):
                    tick -= 1
                    params, version = snapshots[w]
                    dev = self.devices[w % len(self.devices)]
                    loss, grads = self.value_and_grad(params, next_batch(tick), dev)
                    pending.append((grads, version, w, float(loss)))
            grads, version, w, loss = pending.pop(0)
            if server.push(grads, version, w, loss=loss) < 0:
                tick += 1  # over the bound: recompute on a fresh snapshot
