"""Fault tolerance of the port: heartbeats, the snapshot ring with its
preemption hook, and elastic resume (the port's counterpart of the JAX
package's ``ft/``).

- :mod:`~autodist_tpu_torch.ft.heartbeat` — :class:`HealthMonitor`:
  positive liveness signals, healthy/suspect/dead classification with
  exponential escalation backoff, metrics gauges, and the fleet verdicts
  the launcher's watchdog consumes.
- :mod:`~autodist_tpu_torch.ft.snapshot` — :class:`SnapshotManager`: async
  ring of integrity-hashed train-state snapshots, and the SIGTERM hook
  that forces a final one at the next step boundary.
- :mod:`~autodist_tpu_torch.ft.elastic` — rebuild the plan over the
  surviving ranks' group and restore the snapshot into it.
- :mod:`~autodist_tpu_torch.ft.procdrain` — signal-then-grace subprocess
  termination.

The JAX package's serve drain (``ft/drain.py``) is not ported yet
(ROADMAP.md). Entry point: ``AutoDist(fault_tolerance=FTConfig(...))`` —
the :class:`FTRuntime` rides on ``autodist.ft``.
"""
from __future__ import annotations

from typing import Optional

from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.ft.config import FTConfig
from autodist_tpu_torch.ft.elastic import (
    ElasticController,
    recompile_on,
    resume_from_snapshot,
    surviving_resource_spec,
)
from autodist_tpu_torch.ft.heartbeat import (
    CoordinatorTransport,
    FileTransport,
    FleetVerdict,
    HealthMonitor,
    MemoryTransport,
    PeerState,
)
from autodist_tpu_torch.ft.snapshot import SnapshotManager, StateInFlux, latest_snapshot_step

__all__ = [
    "CoordinatorTransport",
    "ElasticController",
    "FTConfig",
    "FTRuntime",
    "FileTransport",
    "FleetVerdict",
    "HealthMonitor",
    "MemoryTransport",
    "PeerState",
    "SnapshotManager",
    "latest_snapshot_step",
    "recompile_on",
    "resume_from_snapshot",
    "surviving_resource_spec",
]


class FTRuntime:
    """The per-process bundle ``AutoDist(fault_tolerance=...)`` creates:
    one started :class:`HealthMonitor` (file transport under the resolved
    heartbeat dir, this process's rank as its id), one
    :class:`SnapshotManager` over the process group, and the preemption
    hook when configured."""

    def __init__(self, config: FTConfig,
                 registry: Optional[M.MetricsRegistry] = None,
                 start_monitor: bool = True,
                 install_preempt_hook: Optional[bool] = None,
                 group=None):
        import torch.distributed as dist

        self.config = config.resolved()
        rank = dist.get_rank() if dist.is_initialized() else 0
        self.monitor = HealthMonitor(
            FileTransport(self.config.heartbeat_dir),
            process_id=rank,
            config=self.config,
            registry=registry,
        )
        if start_monitor:
            self.monitor.start()
        self.snapshots = SnapshotManager.from_config(
            self.config, registry=registry, group=group)
        self.elastic = ElasticController(self.monitor, self.snapshots)
        if (self.config.snapshot_on_preempt
                if install_preempt_hook is None else install_preempt_hook):
            try:
                self.snapshots.install_preempt_hook()
            except ValueError:
                # Not the main thread (embedded runtimes): the hook is an
                # optimization, not a correctness requirement.
                pass

    def maybe_snapshot(self, state, step: Optional[int] = None,
                       step_obj=None) -> Optional[str]:
        """Periodic-snapshot hook for training loops, called at each step
        boundary; also refreshes the heartbeat payload's progress counter
        and registers this state for the preemption hook, which refuses it
        once ``step_obj`` has stepped past it (its tensors are updated in
        place)."""
        resolved = SnapshotManager._resolve_step(state, step)
        self.monitor.set_step(resolved)
        taken = getattr(step_obj, "steps_taken", None)

        def provider():
            if step_obj is not None and step_obj.steps_taken != taken:
                raise StateInFlux(f"the state of step {resolved} has been stepped past")
            return ((step_obj.logical_state(state) if step_obj is not None else state),
                    resolved)

        self.snapshots.register_state_provider(provider)
        return self.snapshots.maybe_snapshot(state, step=resolved, step_obj=step_obj)

    def shutdown(self) -> None:
        self.monitor.stop()
        self.snapshots.wait()
