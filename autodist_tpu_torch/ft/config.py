"""Fault-tolerance configuration: one dataclass of knobs for the whole
``autodist_tpu_torch.ft`` subsystem (the port's copy of the JAX package's
``ft/config.py``: the same fields, defaults and ``resolved()``).

``FTConfig`` travels as a plain value object:
:class:`~autodist_tpu_torch.api.AutoDist` accepts
``fault_tolerance=FTConfig(...)``, the launcher's supervisor consumes the
same object, and each ``ft`` component reads only its own fields.

Directory layout (``resolved()``): everything lives under one base dir —
``AUTODIST_FT_DIR`` env, or ``<working-dir>/ft`` — so a restarted process
finds the previous incarnation's heartbeats and snapshots without any
side-channel.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

from autodist_tpu_torch import const
from autodist_tpu_torch.const import ENV


@dataclass
class FTConfig:
    """Knobs for heartbeating, snapshotting, elastic resume and drain.

    Heartbeats (``ft.heartbeat``):

    - ``heartbeat_interval_s``: publish + sweep period of the
      :class:`~autodist_tpu_torch.ft.heartbeat.HealthMonitor` daemon thread.
    - ``suspect_after_misses``: consecutive missed intervals before a peer
      is classified ``SUSPECT`` (transient: the peer recovers to
      ``HEALTHY`` on its next beat).
    - ``dead_after_misses``: escalation bound — total missed intervals
      (counted in backoff windows, see below) before ``DEAD``.
    - ``backoff_initial_s`` / ``backoff_max_s``: after each miss the next
      escalation check waits exponentially longer (doubling, capped), so a
      flapping network cannot ping-pong a peer between states every tick.

    Snapshots (``ft.snapshot``):

    - ``snapshot_every_steps`` / ``snapshot_every_s``: periodic-snapshot
      cadence for :meth:`~autodist_tpu_torch.ft.snapshot.SnapshotManager.maybe_snapshot`
      (0 disables that trigger; both 0 = manual snapshots only).
    - ``keep_snapshots``: ring size — older snapshots are pruned after a
      new one lands, newest-N retained.
    - ``snapshot_on_preempt``: install the SIGTERM hook (a preemption
      notice) that forces a final snapshot before shutdown.

    Serve drain (``ft.drain``):

    - ``drain_deadline_s``: how long in-flight decodes may run after a
      drain begins before undone work is persisted instead (read by the
      JAX package's serve drain; the port's is not ported yet).

    Fleet supervision (``runtime.launcher``):

    - ``hang_after_misses``: launcher-side watchdog — when a rank's
      heartbeat has been silent this many intervals, the fleet is judged
      hung and its ranks are terminated so the restart supervisor can act
      (a wedged fleet otherwise never exits and exit-code supervision
      waits forever; one silent rank holds every collective of the
      others).
    """

    # heartbeat
    heartbeat_interval_s: float = 5.0
    suspect_after_misses: int = 2
    dead_after_misses: int = 6
    backoff_initial_s: float = 0.0   # 0 = one interval
    backoff_max_s: float = 60.0
    # snapshot
    snapshot_every_steps: int = 0
    snapshot_every_s: float = 0.0
    keep_snapshots: int = 3
    snapshot_on_preempt: bool = True
    # serve drain
    drain_deadline_s: float = 30.0
    # launcher watchdog
    hang_after_misses: int = 12
    # paths (None = derive from base_dir in resolved())
    base_dir: Optional[str] = None
    heartbeat_dir: Optional[str] = None
    snapshot_dir: Optional[str] = None
    queue_persist_path: Optional[str] = None

    def resolved(self) -> "FTConfig":
        """A copy with every path filled in from ``base_dir`` (explicit, or
        ``AUTODIST_FT_DIR``, or ``<working-dir>/ft``). Explicit per-path
        overrides always win."""
        base = self.base_dir or ENV.AUTODIST_FT_DIR.val or const.DEFAULT_FT_DIR
        return dataclasses.replace(
            self,
            base_dir=base,
            heartbeat_dir=self.heartbeat_dir or os.path.join(base, "heartbeats"),
            snapshot_dir=self.snapshot_dir or os.path.join(base, "snapshots"),
            queue_persist_path=(
                self.queue_persist_path
                or os.path.join(base, "serve_queue.json")
            ),
        )
