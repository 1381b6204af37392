"""Heartbeat exchange + peer health classification (the port's copy of
the JAX package's ``ft/heartbeat.py``: the same state machine, verdicts
and transports, driven through :meth:`HealthMonitor.tick` by one clock).

Every process *publishes* a periodic heartbeat and *sweeps* everyone
else's, classifying each peer ``HEALTHY → SUSPECT → DEAD`` with
exponential backoff between escalations so one dropped beat never flaps a
peer. State is exported through the port's
:class:`~autodist_tpu_torch.metrics.MetricsRegistry` gauges
(``ft_peers_{healthy,suspect,dead}``, ``ft_heartbeat_max_age_s``), and the
launcher's supervisor consumes the monitor's verdicts
(``runtime/launcher.py``).

Heartbeats travel through a pluggable transport:

- :class:`FileTransport` — one atomically-replaced JSON file per process
  under a shared directory: the default, and what the launcher process
  (not a member of the process group) observes the fleet through.
- :class:`CoordinatorTransport` — rides the process group's c10d store
  (the ``TCPStore`` of rank 0 that ``pg.join``'s rendezvous and the
  Saver's barriers use), for fleets without a shared filesystem.
- :class:`MemoryTransport` — in-process dict, for tests and the
  single-process case.

The classification step is :meth:`HealthMonitor.tick` (a pure function of
transport contents and a clock), so tests drive the state machine with a
synthetic clock; the daemon thread just calls ``tick`` on a cadence.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional

from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.chaos import hooks as chaos_hooks
from autodist_tpu_torch.ft.config import FTConfig
from autodist_tpu_torch.obs import recorder as obs_recorder
from autodist_tpu_torch.utils import logging, retry

#: Transient transport-publish retry (utils/retry.py, the one backoff
#: home): a beat is worth two quick retries, never a blocking stall of
#: the monitor loop.
_PUBLISH_RETRY = retry.RetryPolicy(
    initial_s=0.02, max_s=0.1, multiplier=2.0, jitter=0.5,
    max_attempts=3, deadline_s=1.0)

#: Hard cap on the shutdown join: ``5 * heartbeat_interval_s`` can be
#: minutes with long intervals, and a daemon thread stuck in a slow
#: transport must not block process shutdown that long.
STOP_JOIN_CAP_S = 10.0


class PeerState(Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"


class FleetVerdict(Enum):
    """Aggregate view the supervisor consumes."""

    HEALTHY = "healthy"    # every known peer healthy
    DEGRADED = "degraded"  # some peers suspect/dead, some alive
    DEAD = "dead"          # every known peer dead (fleet-wide hang/loss)
    UNKNOWN = "unknown"    # no heartbeat ever observed


@dataclass
class PeerInfo:
    """Host-side record for one peer."""

    process_id: int
    state: PeerState = PeerState.HEALTHY
    last_seen: float = 0.0         # transport timestamp of the last beat
    last_payload: dict = field(default_factory=dict)
    misses: int = 0                # consecutive escalation windows missed
    next_check: float = 0.0        # monotonic deadline of the next escalation
    backoff_s: float = 0.0


# ------------------------------------------------------------- transports
class MemoryTransport:
    """In-process heartbeat board (tests, single-process)."""

    def __init__(self):
        self._board: Dict[int, dict] = {}
        self._lock = threading.Lock()

    def publish(self, process_id: int, payload: dict) -> None:
        payload = chaos_hooks.apply(chaos_hooks.SEAM_HB_PUBLISH, payload,
                                    process_id=int(process_id),
                                    transport="memory")
        if payload is None:
            return  # injected transport drop: the beat never lands
        with self._lock:
            self._board[int(process_id)] = dict(payload)

    def sweep(self) -> Dict[int, dict]:
        with self._lock:
            board = {pid: dict(p) for pid, p in self._board.items()}
        return chaos_hooks.apply(chaos_hooks.SEAM_HB_SWEEP, board,
                                 transport="memory")


class FileTransport:
    """One ``hb-<pid>.json`` per process under a shared directory.

    Writes are atomic (tmp + rename) so a sweeping reader never sees a
    torn beat; the payload carries its own ``time`` stamp (``time.time()``
    — wall clock, comparable across hosts to heartbeat precision)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def publish(self, process_id: int, payload: dict) -> None:
        payload = chaos_hooks.apply(chaos_hooks.SEAM_HB_PUBLISH, payload,
                                    process_id=int(process_id),
                                    transport="file")
        if payload is None:
            return  # injected transport drop: the beat never lands
        path = os.path.join(self.directory, f"hb-{int(process_id)}.json")
        tmp = f"{path}.tmp-{os.getpid()}"

        def _write():
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f)
            os.replace(tmp, path)

        # A transient filesystem hiccup (remount, NFS blip) costs a beat
        # only if it outlives the retry budget; the monitor loop's own
        # exception guard catches a final failure.
        retry.retry_call(_write, policy=_PUBLISH_RETRY, retry_on=(OSError,),
                         describe="heartbeat publish")

    def sweep(self) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            if not (name.startswith("hb-") and name.endswith(".json")):
                continue
            try:
                pid = int(name[3:-5])
                with open(os.path.join(self.directory, name),
                          encoding="utf-8") as f:
                    out[pid] = json.load(f)
            except (OSError, ValueError):
                continue  # mid-replace / foreign file: catch it next sweep
        return chaos_hooks.apply(chaos_hooks.SEAM_HB_SWEEP, out,
                                 transport="file")


class CoordinatorTransport:
    """Heartbeats through the process group's c10d store.

    Each beat lands under a fresh sequence-suffixed key
    (``ft/hb/<pid>/<seq>``), as in the JAX package's key-value transport.
    A c10d store has no directory listing, so a per-peer pointer
    ``ft/hb/<pid>/latest`` holds the newest sequence beside it (the
    previous beat's key is deleted); ``sweep`` follows each pointer of the
    group's ``world`` ranks. The newest *payload time* wins: a swept beat
    older than one already seen for that peer (a stale incarnation's
    write racing a restarted one's) never moves the view back.
    """

    PREFIX = "ft/hb"

    def __init__(self, store=None, world_size: Optional[int] = None):
        import torch.distributed as dist

        if store is None:
            if not dist.is_initialized():
                raise NotImplementedError(
                    "CoordinatorTransport without a process group (the JAX package's "
                    "jax.distributed key-value store) is not ported; form a group "
                    "first, pass a c10d store, or use FileTransport; see ROADMAP.md")
            from torch.distributed import distributed_c10d

            store = distributed_c10d._get_default_store()
        if world_size is None:
            world_size = dist.get_world_size() if dist.is_initialized() else 1
        self._store = store
        self.world_size = int(world_size)
        # Wall-clock-seeded so a RESTARTED process's keys sort after its
        # previous incarnation's.
        self._seq = int(time.time() * 1000)
        self._seen: Dict[int, dict] = {}

    def _key(self, pid: int, tail) -> str:
        return f"{self.PREFIX}/{int(pid)}/{tail}"

    def publish(self, process_id: int, payload: dict) -> None:
        payload = chaos_hooks.apply(chaos_hooks.SEAM_HB_PUBLISH, payload,
                                    process_id=int(process_id),
                                    transport="coordinator")
        if payload is None:
            return  # injected transport drop: the beat never lands
        self._seq += 1
        seq = f"{self._seq:015d}"

        def _write():
            self._store.set(self._key(process_id, seq), json.dumps(payload))
            self._store.set(self._key(process_id, "latest"), seq)

        try:
            retry.retry_call(_write, policy=_PUBLISH_RETRY, retry_on=(Exception,),
                             describe="heartbeat publish (c10d store)")
            self._store.delete_key(self._key(process_id, f"{self._seq - 1:015d}"))
        except Exception as e:  # noqa: BLE001 - liveness signal, never fatal
            logging.warning("heartbeat publish failed (%s)", e)

    def sweep(self) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        for pid in range(self.world_size):
            latest = self._key(pid, "latest")
            try:
                if not self._store.check([latest]):
                    continue
                seq = self._store.get(latest).decode()
                payload = json.loads(self._store.get(self._key(pid, seq)).decode())
            except Exception:  # noqa: BLE001 - a key replaced mid-sweep: next sweep
                payload = None
            old = self._seen.get(pid)
            if payload is not None and (
                    old is None or payload.get("time", 0) >= old.get("time", 0)):
                self._seen[pid] = payload
            if pid in self._seen:
                out[pid] = dict(self._seen[pid])
        return chaos_hooks.apply(chaos_hooks.SEAM_HB_SWEEP, out,
                                 transport="coordinator")


# ---------------------------------------------------------------- monitor
class HealthMonitor:
    """Per-process health daemon: publish own beat, classify everyone's.

    ``process_id`` identifies this process on the transport;
    ``publish=False`` makes a pure observer (the launcher's fleet watchdog
    — it is not a fleet member and must not appear as a peer).
    ``expected`` optionally names the process ids that SHOULD exist, so a
    peer that never manages a single beat still shows up (as ``DEAD`` once
    the dead window passes from monitor start).

    Thread-safe: ``tick`` may be driven by the daemon thread (``start``)
    or directly by tests with a synthetic clock.
    """

    def __init__(
        self,
        transport,
        process_id: int = 0,
        config: Optional[FTConfig] = None,
        publish: bool = True,
        expected: Optional[List[int]] = None,
        registry: Optional[M.MetricsRegistry] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.transport = transport
        self.process_id = int(process_id)
        self.config = config or FTConfig()
        self.publish = publish
        self.clock = clock
        self._peers: Dict[int, PeerInfo] = {}
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._started_at: Optional[float] = None
        self._transitions: List[Callable[[int, PeerState, PeerState], None]] = []
        self._step = 0  # training progress carried in the beat payload

        reg = registry or M.registry
        self._g_healthy = reg.gauge("ft_peers_healthy")
        self._g_suspect = reg.gauge("ft_peers_suspect")
        self._g_dead = reg.gauge("ft_peers_dead")
        self._g_age = reg.gauge("ft_heartbeat_max_age_s")
        self._c_sent = reg.counter("ft_heartbeats_sent_total")
        self._c_trans = reg.counter("ft_peer_transitions_total")

        if expected:
            now = self.clock()
            cfg = self.config
            for pid in expected:
                if publish and int(pid) == self.process_id:
                    continue
                self._peers[int(pid)] = PeerInfo(
                    process_id=int(pid), state=PeerState.HEALTHY,
                    last_seen=now,
                    next_check=now + cfg.suspect_after_misses * cfg.heartbeat_interval_s,
                )

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "HealthMonitor":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._started_at = self.clock()
        self._thread = threading.Thread(
            target=self._loop, name="ft-heartbeat", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            # Bounded shutdown: ``5 * interval`` can be minutes with long
            # heartbeat intervals; a wedged transport must not hold the
            # process exit hostage. Past the cap, warn and detach — the
            # thread is a daemon and dies with the process.
            cap = min(5 * self.config.heartbeat_interval_s, STOP_JOIN_CAP_S)
            self._thread.join(timeout=cap)
            if self._thread.is_alive():
                logging.warning(
                    "heartbeat thread did not exit within %.1fs (transport "
                    "wedged?); detaching without blocking shutdown", cap)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the monitor must outlive glitches
                logging.warning("health monitor tick failed", exc_info=True)
            self._stop.wait(self.config.heartbeat_interval_s)

    def set_step(self, step: int) -> None:
        """Record training progress; travels in the next beat's payload so
        peers (and the supervisor) can see who is advancing."""
        self._step = int(step)

    def on_transition(
        self, fn: Callable[[int, PeerState, PeerState], None]
    ) -> None:
        """Run ``fn(pid, old_state, new_state)`` on every classification
        change, from the monitor thread (or the tick caller)."""
        self._transitions.append(fn)

    # ---------------------------------------------------------------- tick
    def tick(self, now: Optional[float] = None) -> None:
        """One publish + sweep + classify round (idempotent, reentrant-safe
        under the instance lock)."""
        now = self.clock() if now is None else now
        if self._started_at is None:
            self._started_at = now
        if self.publish:
            self.transport.publish(self.process_id, {
                "time": now, "step": self._step, "pid": os.getpid(),
            })
            self._c_sent.inc()
        beats = self.transport.sweep()
        fired = []
        with self._lock:
            cfg = self.config
            interval = cfg.heartbeat_interval_s
            for pid, payload in beats.items():
                if self.publish and pid == self.process_id:
                    continue
                seen = float(payload.get("time", now))
                peer = self._peers.get(pid)
                if peer is None:
                    peer = self._peers[pid] = PeerInfo(process_id=pid)
                if seen > peer.last_seen:
                    # Fresh beat: whatever the peer was, it is healthy now,
                    # and the escalation backoff resets.
                    if peer.state is not PeerState.HEALTHY:
                        fired.append((pid, peer.state, PeerState.HEALTHY))
                    peer.state = PeerState.HEALTHY
                    peer.last_seen = seen
                    peer.last_payload = payload
                    peer.misses = 0
                    peer.backoff_s = 0.0
                    peer.next_check = now + cfg.suspect_after_misses * interval
            for pid, peer in self._peers.items():
                if peer.state is PeerState.DEAD:
                    continue
                if now < peer.next_check:
                    continue
                # Escalation window expired without a fresh beat.
                peer.misses += 1
                old = peer.state
                if peer.state is PeerState.HEALTHY:
                    peer.state = PeerState.SUSPECT
                if peer.misses >= max(
                        1, cfg.dead_after_misses - cfg.suspect_after_misses):
                    peer.state = PeerState.DEAD
                # Exponential backoff between escalations: a transient miss
                # costs one SUSPECT round; repeated misses wait doubling
                # windows before the next (so flapping can't thrash states).
                peer.backoff_s = min(
                    cfg.backoff_max_s,
                    (peer.backoff_s * 2) if peer.backoff_s
                    else (cfg.backoff_initial_s or interval),
                )
                peer.next_check = now + peer.backoff_s
                if peer.state is not old:
                    fired.append((pid, old, peer.state))
            states = [p.state for p in self._peers.values()]
            self._g_healthy.set(sum(s is PeerState.HEALTHY for s in states))
            self._g_suspect.set(sum(s is PeerState.SUSPECT for s in states))
            self._g_dead.set(sum(s is PeerState.DEAD for s in states))
            ages = [now - p.last_seen for p in self._peers.values()
                    if p.last_seen > 0]
            self._g_age.set(max(ages) if ages else 0.0)
        self._fire(fired)

    def _fire(self, fired, reason: str = "") -> None:
        """Dispatch classification changes: bump the counter, log, run the
        registered callbacks (outside the lock — a callback may query the
        monitor). ONE path for tick() and escalate()."""
        for pid, old, new in fired:
            self._c_trans.inc()
            logging.info("peer %d: %s -> %s%s", pid, old.value, new.value,
                         f" ({reason})" if reason else "")
            # Classification changes are rare and load-bearing for a
            # postmortem ("host 3 went suspect 40s before the wedge") —
            # flight-record each with the immediate-fsync discipline.
            obs_recorder.record_event(
                "peer_transition", peer=pid, old=old.value, new=new.value,
                reason=reason or "")
            for fn in self._transitions:
                try:
                    fn(pid, old, new)
                except Exception:  # noqa: BLE001 - callbacks can't kill the loop
                    logging.warning("peer-transition callback raised",
                                    exc_info=True)

    def _refresh_state_gauges(self) -> None:
        with self._lock:
            states = [p.state for p in self._peers.values()]
        self._g_healthy.set(sum(s is PeerState.HEALTHY for s in states))
        self._g_suspect.set(sum(s is PeerState.SUSPECT for s in states))
        self._g_dead.set(sum(s is PeerState.DEAD for s in states))

    def escalate(self, pid: int, reason: str = "") -> None:
        """External suspicion feed: force peer ``pid`` to SUSPECT scrutiny
        now (obs straggler scores use this — a host can be alive-but-sick
        long before it misses a beat). A DEAD peer stays dead; a healthy
        beat after escalation clears it through the normal tick path. The
        next escalation window opens immediately, so a straggler that also
        stops beating reaches DEAD on the short path."""
        fired = []
        with self._lock:
            peer = self._peers.get(int(pid))
            if peer is None:
                peer = self._peers[int(pid)] = PeerInfo(process_id=int(pid))
            if peer.state is PeerState.HEALTHY:
                fired.append((int(pid), peer.state, PeerState.SUSPECT))
                peer.state = PeerState.SUSPECT
                peer.next_check = self.clock()  # escalate on the next tick
        if fired:
            self._refresh_state_gauges()
        self._fire(fired, reason=reason or "external escalation")

    # ------------------------------------------------------------- queries
    def peers(self) -> Dict[int, PeerInfo]:
        with self._lock:
            return {
                pid: PeerInfo(
                    process_id=p.process_id, state=p.state,
                    last_seen=p.last_seen, last_payload=dict(p.last_payload),
                    misses=p.misses, next_check=p.next_check,
                    backoff_s=p.backoff_s,
                )
                for pid, p in self._peers.items()
            }

    def surviving(self) -> List[int]:
        """Process ids not classified DEAD — the membership an elastic
        restart rebuilds the ResourceSpec from."""
        with self._lock:
            return sorted(pid for pid, p in self._peers.items()
                          if p.state is not PeerState.DEAD)

    def max_observed_step(self) -> int:
        """Highest training step any beat has carried (``set_step``) —
        the supervisor's progress signal."""
        with self._lock:
            peer_max = max(
                (int(p.last_payload.get("step", 0))
                 for p in self._peers.values()), default=0)
        return max(peer_max, self._step)

    def verdict(self, now: Optional[float] = None) -> FleetVerdict:
        """Aggregate classification of everything observed so far."""
        with self._lock:
            states = [p.state for p in self._peers.values()]
        if not states:
            return FleetVerdict.UNKNOWN
        if all(s is PeerState.HEALTHY for s in states):
            return FleetVerdict.HEALTHY
        if all(s is PeerState.DEAD for s in states):
            return FleetVerdict.DEAD
        return FleetVerdict.DEGRADED

    def fleet_hung(self, now: Optional[float] = None) -> bool:
        """Launcher watchdog predicate: at least one beat was ever seen and
        EVERY peer's last beat is older than ``hang_after_misses``
        intervals. Distinct from ``verdict() is DEAD`` only in its longer,
        dedicated window — killing a live-but-slow fleet is worse than
        waiting a few extra intervals."""
        now = self.clock() if now is None else now
        window = self.config.hang_after_misses * self.config.heartbeat_interval_s
        with self._lock:
            seen = [p.last_seen for p in self._peers.values() if p.last_seen > 0]
        if not seen:
            return False
        return all(now - t > window for t in seen)

    def stalled_peers(self, now: Optional[float] = None) -> List[int]:
        """Peers whose last beat is older than ``hang_after_misses``
        intervals (expected peers that never beat count from the monitor's
        start). With one process per GPU a single silent rank holds every
        collective of the others, whose own beats go on: the launcher's
        watchdog acts on this as on :meth:`fleet_hung`."""
        now = self.clock() if now is None else now
        window = self.config.hang_after_misses * self.config.heartbeat_interval_s
        with self._lock:
            return sorted(pid for pid, p in self._peers.items()
                          if p.last_seen > 0 and now - p.last_seen > window)
