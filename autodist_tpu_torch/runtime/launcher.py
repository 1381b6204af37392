"""Fleet launcher: ``python -m autodist_tpu_torch.runtime.launcher`` (the
port's counterpart of the JAX package's ``runtime/launcher.py``).

One command runs the same training script as every rank of the cluster,
with the role environment each needs, then watches the fleet::

    python -m autodist_tpu_torch.runtime.launcher --resource-spec spec.yml \\
        [--max-restarts 3] [--ft-dir /shared/ft] [--trace-out /shared/traces] \\
        -- python train.py --flags ...

The port runs one rank per GPU: the chief node's ranks (one per GPU of the
node, ``--resource-spec``'s ``gpus``, or this host's cards by default) run
here; every other node runs the launcher's per-node mode
(``--node-local-ranks N``, started over SSH or as a local subprocess by
the :class:`~autodist_tpu_torch.runtime.coordinator.Coordinator`), which
starts its ``N`` ranks and exits non-zero as soon as one of them dies.
Each rank gets the ``AUTODIST_*`` contract and the ``torchrun`` variables
(``runtime/cluster.py``), so ``AutoDist`` joins the group from them.
``--num-local-processes N`` runs N ranks here whatever the spec: gloo CPU
ranks for tests, or one node's cards.

- ``--max-restarts``: relaunch a fleet that exits non-zero (jittered
  exponential backoff through ``utils/retry.py``; ``AUTODIST_RESTART`` is
  the attempt). Scripts resume through ``init_or_restore`` or
  ``ft.resume_from_snapshot``.
- ``--ft-dir``: every rank heartbeats and snapshots under one base dir; a
  watchdog (``_FleetWatch``) over the heartbeats terminates a hung fleet
  (a rank silent for ``hang_after_misses`` intervals: with one process
  per GPU, one silent rank holds every collective of the others, which
  would wait out the group's timeout) after writing a doctor bundle in
  the JAX package's schema; the restart budget resets whenever the
  snapshot ring advances.
- ``--trace-out``: every rank flushes its spans there and the launcher
  stitches one chrome trace (``obs/spans.py``) with its own
  ``launcher.fleet`` span.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional, Sequence, TYPE_CHECKING

from autodist_tpu_torch import const
from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime.cluster import (
    LAUNCHER_ENV,
    TORCHRUN_VARS,
    Cluster,
    clean_stale_processes,
    launcher_token,
    write_pidfile,
)
from autodist_tpu_torch.runtime.coordinator import Coordinator
from autodist_tpu_torch.utils import logging

if TYPE_CHECKING:
    from autodist_tpu_torch.ft import FTConfig

#: Seconds a terminated rank has to exit before it is killed: a rank held
#: in a collective by a dead peer never reaches its SIGTERM handler.
KILL_GRACE_S = 30.0


def _scrub_role_vars(env: dict) -> dict:
    """Drop the role/strategy variables and the ``torchrun`` variables from
    an environment: a rank inheriting an earlier launch's (or a ``build()``
    that exported ``AUTODIST_STRATEGY_ID``) would be misrouted onto another
    rank's identity, rendezvous or shipped strategy. Launchers set them
    explicitly; behavior knobs (log level, testing flags) and user
    variables pass through."""
    role_vars = {
        ENV.AUTODIST_WORKER.name,
        ENV.AUTODIST_STRATEGY_ID.name,
        ENV.AUTODIST_COORDINATOR.name,
        ENV.AUTODIST_NUM_PROCESSES.name,
        ENV.AUTODIST_PROCESS_ID.name,
        LAUNCHER_ENV,
        *TORCHRUN_VARS,
    }
    return {k: v for k, v in env.items() if k not in role_vars}


def _signal(proc: subprocess.Popen, sig) -> None:
    # Imported here: the ft package imports the kernel, which imports this
    # package's process group.
    from autodist_tpu_torch.ft import procdrain

    procdrain.signal_group(proc, sig)


def _exit_code(code: int) -> int:
    """A child's return code as a shell reports it (a signal: 128 + sig)."""
    return 128 - code if code < 0 else code


class _RankGroup:
    """The ranks of one node, started together: ``wait`` returns the first
    non-zero exit code (terminating the others, then killing those left
    after ``KILL_GRACE_S``), or 0 when every rank exits 0."""

    def __init__(self, argv: Sequence[str], envs: Sequence[dict]):
        # Each rank in a session of its own: terminate() signals its group.
        self.procs = [subprocess.Popen(list(argv), env=env, start_new_session=True)
                      for env in envs]
        self._terminating: Optional[float] = None
        self._lock = threading.Lock()

    def exited(self, pid) -> bool:
        """Whether ``pid`` is one of these ranks and has exited."""
        return any(p.pid == pid and p.poll() is not None for p in self.procs)

    def terminate(self) -> None:
        """SIGTERM every rank still running (their preemption hooks run)."""
        with self._lock:
            if self._terminating is None:
                self._terminating = time.monotonic()
        for p in self.procs:
            if p.poll() is None:
                _signal(p, signal.SIGTERM)

    def wait(self) -> int:
        code = 0
        while True:
            codes = [p.poll() for p in self.procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad and not code:
                code = _exit_code(bad[0])
                self.terminate()
            if all(c is not None for c in codes):
                return code
            with self._lock:
                since = self._terminating
            if since is not None and time.monotonic() - since > KILL_GRACE_S:
                for p in self.procs:
                    if p.poll() is None:
                        _signal(p, signal.SIGKILL)
                code = code or 1
            time.sleep(0.05)


class _FleetWatch:
    """Launcher-side fleet observer: a non-publishing
    :class:`~autodist_tpu_torch.ft.heartbeat.HealthMonitor` over the
    fleet's heartbeat directory, plus a watchdog thread that terminates the
    fleet's local ranks when it is hung: every rank silent
    (``fleet_hung``, JAX's rule) or one rank silent while alive
    (``stalled_peers``, the port's: its peers wait in a collective and keep
    beating). A hung fleet never exits, so exit-code supervision alone
    would wait on it forever; the watchdog turns it into a non-zero
    ``launch`` return the supervisor acts on.
    """

    def __init__(self, ft_config: "FTConfig"):
        from autodist_tpu_torch.ft import FileTransport, HealthMonitor

        self.config = ft_config.resolved()
        # Sweep beats left by a previous incarnation: their stale stamps
        # would otherwise read as an immediately-hung fleet.
        hb_dir = self.config.heartbeat_dir
        os.makedirs(hb_dir, exist_ok=True)
        for name in os.listdir(hb_dir):
            if name.startswith("hb-"):
                try:
                    os.remove(os.path.join(hb_dir, name))
                except OSError:
                    pass
        self.monitor = HealthMonitor(
            FileTransport(hb_dir), publish=False, config=self.config)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.hang_detected = False

    def env(self) -> dict:
        """What every rank needs to heartbeat into the base dir the watchdog
        sweeps (and the autopilot's dir beside it, ``pilot/journal.py``)."""
        return {
            ENV.AUTODIST_FT_DIR.name: self.config.base_dir,
            ENV.AUTODIST_PILOT_DIR.name: os.path.join(self.config.base_dir, "pilot"),
        }

    def write_bundle(self, reason: str = "fleet_hung") -> Optional[str]:
        """Persist a doctor bundle — last heartbeats (per-peer state and
        payload), the fleet verdict, and this launcher's spans — under
        ``<ft base>/doctor/`` BEFORE the kill, in the JAX package's schema
        (its ``python -m autodist_tpu.obs doctor <ft base>`` reads it).
        Atomic, fsync'd; a failure never blocks the kill."""
        try:
            from autodist_tpu_torch.obs.spans import get_tracer

            peers = {}
            for pid, p in self.monitor.peers().items():
                peers[str(pid)] = {
                    "state": p.state.value,
                    "last_seen": p.last_seen,
                    "misses": p.misses,
                    "last_payload": p.last_payload,
                }
            bundle = {
                "written_at": time.time(),
                "reason": reason,
                "verdict": self.monitor.verdict().value,
                "hang_after_misses": self.config.hang_after_misses,
                "heartbeat_interval_s": self.config.heartbeat_interval_s,
                "heartbeats": peers,
                "launcher_spans": [
                    {"name": s.name, "t_start_s": s.t_start_s,
                     "dur_s": s.dur_s, "attrs": s.attrs}
                    for s in get_tracer().spans()[-64:]
                ],
            }
            bundle_dir = os.path.join(self.config.base_dir, "doctor")
            os.makedirs(bundle_dir, exist_ok=True)
            path = os.path.join(bundle_dir, f"hang-bundle-{int(time.time())}.json")
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(bundle, f, indent=2, default=str)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            logging.info("wrote doctor bundle -> %s", path)
            return path
        except Exception:  # noqa: BLE001 - the kill must proceed regardless
            logging.warning("doctor bundle write failed", exc_info=True)
            return None

    def hung(self, ranks: Optional[_RankGroup] = None) -> Optional[str]:
        """Why the fleet is hung (None when it is not): every rank silent,
        or ranks silent while alive (a local rank that exited is not)."""
        if self.monitor.fleet_hung():
            return "fleet_hung"
        peers = self.monitor.peers()
        stalled = [pid for pid in self.monitor.stalled_peers()
                   if ranks is None or not ranks.exited(peers[pid].last_payload.get("pid"))]
        return f"ranks_silent:{stalled}" if stalled else None

    def start(self, ranks) -> None:
        """Watch until stopped; on a hang write the bundle, then terminate
        ``ranks`` (anything with ``terminate()``)."""
        def watch():
            while not self._stop.is_set():
                try:
                    self.monitor.tick()
                    why = self.hung(ranks if isinstance(ranks, _RankGroup) else None)
                    if why:
                        self.hang_detected = True
                        logging.error(
                            "fleet hung (%s: heartbeats silent for %d intervals, verdict "
                            "%s); terminating its ranks for restart", why,
                            self.config.hang_after_misses, self.monitor.verdict().value)
                        # Attribution before termination: the bundle is the
                        # context SIGTERM would otherwise discard.
                        self.write_bundle(reason=why)
                        ranks.terminate()
                        return
                except Exception:  # noqa: BLE001 - watchdog must not die
                    logging.warning("fleet watchdog tick failed", exc_info=True)
                self._stop.wait(self.config.heartbeat_interval_s)

        self._thread = threading.Thread(target=watch, name="ft-fleet-watch", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def verdict(self) -> str:
        return self.monitor.verdict().value

    def progress_step(self) -> Optional[int]:
        """Newest snapshot step the fleet persisted (the supervisor's
        progress signal)."""
        from autodist_tpu_torch.ft.snapshot import latest_snapshot_step

        return latest_snapshot_step(self.config.snapshot_dir)


def _default_spec() -> ResourceSpec:
    """This host: one node of its visible cards (one CPU rank without)."""
    import torch

    gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return ResourceSpec(resource_dict={"nodes": [
        {"address": "localhost", "gpus": gpus, "chief": True}]})


def launch(
    resource_spec: Optional[ResourceSpec],
    argv: Sequence[str],
    num_local_processes: int = 0,
    coordinator_port: Optional[int] = None,
    extra_env: Optional[dict] = None,
    supervised: bool = False,
    ft_config: "Optional[FTConfig]" = None,
) -> int:
    """Launch ``argv`` as every rank of the cluster; returns the fleet's
    exit code (the first failing rank's, or 0).

    With ``num_local_processes > 1`` the fleet is N ranks on this machine
    (``_launch_local_fleet``), whatever the spec. Otherwise the chief
    node's ranks run here and the :class:`Coordinator` starts every other
    node's agent. ``extra_env`` is merged into every rank's environment.
    ``supervised=True`` redirects the coordinator's node-death fail-fast
    from ``os._exit(1)`` to terminating the chief's ranks, so this
    function *returns* non-zero instead of killing the calling process
    (:func:`launch_supervised`'s restart loop needs that). ``ft_config``
    arms the fleet watchdog: every rank gets ``AUTODIST_FT_DIR`` pointing
    at one shared base, and a launcher-side observer terminates a hung
    fleet.
    """
    clean_stale_processes()
    argv = list(argv)
    extra_env = dict(extra_env or {})
    extra_env[LAUNCHER_ENV] = launcher_token()
    watch = None
    if ft_config is not None:
        watch = _FleetWatch(ft_config)
        extra_env = {**watch.env(), **extra_env}

    # ONE trace id for the whole launch, exported to every rank (local and
    # SSH alike) and pinned into this launcher's own env, so its spans
    # (launcher.fleet) join the fleet's trace.
    from autodist_tpu_torch.obs.spans import current_trace_id

    trace_id = extra_env.get(ENV.AUTODIST_TRACE_ID.name)
    if trace_id:
        os.environ[ENV.AUTODIST_TRACE_ID.name] = trace_id
    else:
        trace_id = extra_env[ENV.AUTODIST_TRACE_ID.name] = current_trace_id()
    trace_out = (extra_env.get(ENV.AUTODIST_TRACE_OUT.name)
                 or ENV.AUTODIST_TRACE_OUT.val)
    if trace_out:
        extra_env.setdefault(ENV.AUTODIST_TRACE_OUT.name, trace_out)
        os.environ[ENV.AUTODIST_TRACE_OUT.name] = trace_out
    t_launch = time.time()

    if num_local_processes > 1:
        base = {**_scrub_role_vars(dict(os.environ)), **extra_env}
        code = _launch_local_fleet(argv, num_local_processes, coordinator_port,
                                   base_env=base, watch=watch)
        _finish_trace(trace_out, trace_id, t_launch, num_local_processes, code)
        return code

    spec = resource_spec if resource_spec is not None else _default_spec()
    cluster = Cluster(spec, coordinator_port=coordinator_port)
    coordinator = Coordinator(cluster, argv=argv, extra_env=extra_env)
    if supervised:
        # Until the chief's ranks exist: a node dying in this window leaves
        # the chief's ranks failing their rendezvous — still non-zero.
        coordinator.set_failure_action(lambda: None)
    coordinator.launch_clients()

    chief_addr = spec.chief_address
    strategy_id = ENV.AUTODIST_STRATEGY_ID.val
    base = _scrub_role_vars(dict(os.environ))
    envs = [{**base, **extra_env, **cluster.env_for_worker(chief_addr, strategy_id, i)}
            for i in range(cluster.local_world_size(chief_addr))]
    chief = _RankGroup(argv, envs)
    if supervised:
        coordinator.set_failure_action(chief.terminate)
    code = _watched_wait(chief, watch)
    if code == 0:
        coordinator.join()
        if coordinator.any_failed:
            # A node died after the chief's ranks exited cleanly: the
            # failure must surface in the return code.
            logging.error("chief exited 0 but a node failed; reporting failure")
            code = 1
    cluster.terminate()
    _finish_trace(trace_out, trace_id, t_launch, cluster.num_processes, code)
    return code


def _watched_wait(ranks: _RankGroup, watch: Optional[_FleetWatch]) -> int:
    """``ranks.wait()`` under the fleet watchdog: a hang is a failed
    attempt even when the terminated ranks exit 0."""
    if watch is not None:
        watch.start(ranks)
    code = ranks.wait()
    if watch is not None:
        watch.stop()
        if watch.hang_detected and code == 0:
            code = 1
        if code != 0:
            logging.error("fleet attempt failed rc=%d; health verdict: %s",
                          code, watch.verdict())
    return code


def _finish_trace(trace_out: str, trace_id: str, t_launch: float,
                  n_processes: int, code: int) -> None:
    """Record the launcher's own fleet span, flush it, and stitch every
    process's part-file into ONE chrome-trace JSON (``trace-<id>.json``
    under the trace-out dir). Tracing never changes a launch's outcome."""
    if not trace_out:
        return
    try:
        from autodist_tpu_torch.obs.spans import SpanTracer, get_tracer, stitch

        tracer = get_tracer()
        if tracer.trace_id != trace_id:
            # This process traced before the launch chose its id.
            tracer = SpanTracer(trace_id=trace_id)
        tracer.add_span("launcher.fleet", t_launch, time.time() - t_launch,
                        processes=n_processes, exit_code=code)
        tracer.flush_part(trace_out)
        merged = stitch(trace_out, trace_id=trace_id)
        if merged:
            logging.info("stitched fleet trace -> %s (load in Perfetto or "
                         "chrome://tracing)", merged)
    except Exception:  # noqa: BLE001 - observability is never fatal here
        logging.warning("trace stitch failed", exc_info=True)


def launch_supervised(
    resource_spec: Optional[ResourceSpec],
    argv: Sequence[str],
    max_restarts: int = 0,
    num_local_processes: int = 0,
    coordinator_port: Optional[int] = None,
    restart_backoff_s: float = 5.0,
    ft_config: "Optional[FTConfig]" = None,
    restart_backoff_max_s: float = 300.0,
    backoff_seed: Optional[int] = None,
    restart_sleep: Optional[Callable[[float], None]] = None,
) -> int:
    """:func:`launch` under a restart supervisor (the resume loop).

    A fleet that exits non-zero is relaunched — same command, fresh role
    env, stale processes swept — up to ``max_restarts`` times. Each attempt
    carries ``AUTODIST_RESTART`` (0 on the first run) in every rank's env.
    Scripts resume by construction when they open their state with
    ``init_or_restore`` or ``ft.resume_from_snapshot``.

    With ``ft_config`` each attempt runs under the fleet watchdog, and the
    restart budget counts restarts *since the fleet last made progress*:
    when the newest snapshot step advanced across an attempt, the counter
    and the backoff reset.

    Restart pacing is jittered exponential backoff through the port's
    ``utils/retry.py``: ``restart_backoff_s`` the first delay's base,
    doubling per consecutive failed attempt up to ``restart_backoff_max_s``,
    each delay jittered down by up to 50%. ``backoff_seed`` pins the
    jitter; ``restart_sleep`` overrides the sleep. The sequence equals the
    JAX package's under the same seed.
    """
    import random as _random

    from autodist_tpu_torch.utils import retry as _retry

    def _progress() -> Optional[int]:
        if ft_config is None:
            return None
        from autodist_tpu_torch.ft.snapshot import latest_snapshot_step

        return latest_snapshot_step(ft_config.resolved().snapshot_dir)

    backoff = _retry.Backoff(
        _retry.RetryPolicy(initial_s=restart_backoff_s, max_s=restart_backoff_max_s,
                           multiplier=2.0, jitter=0.5),
        rng=_random.Random(backoff_seed) if backoff_seed is not None else None,
    )
    attempt = 0
    last_progress = _progress()
    while True:
        code = launch(
            resource_spec, argv,
            num_local_processes=num_local_processes,
            coordinator_port=coordinator_port,
            extra_env={"AUTODIST_RESTART": str(attempt)},
            # max_restarts=0 keeps the unsupervised fail-fast; ft_config
            # passes through regardless (the watchdog still turns a hang
            # into a reportable non-zero exit).
            supervised=max_restarts > 0,
            ft_config=ft_config,
        )
        if code != 0:
            step_now = _progress()
            if step_now is not None and (
                    last_progress is None or step_now > last_progress):
                if attempt:
                    logging.info(
                        "fleet progressed to snapshot step %d since the last "
                        "restart; resetting the restart budget and backoff", step_now)
                attempt = 0
                backoff.reset()
                last_progress = step_now
        if code == 0 or attempt >= max_restarts:
            if code != 0:
                logging.error("fleet failed rc=%d after %d restart(s) without "
                              "progress; giving up", code, attempt)
            return code
        attempt += 1
        delay = backoff.next_delay()
        logging.warning("fleet exited rc=%d; restarting (%d/%d) in %.3fs",
                        code, attempt, max_restarts, delay)
        if delay > 0:
            (restart_sleep or time.sleep)(delay)


def _launch_local_fleet(
    argv: List[str], n: int, coordinator_port: Optional[int],
    base_env: Optional[dict] = None, watch: Optional[_FleetWatch] = None,
) -> int:
    """N ranks on this machine (gloo CPU ranks in tests, or one node's
    cards): rank ``i`` with ``RANK=i``, ``LOCAL_RANK=i``, the rendezvous at
    ``127.0.0.1:<port>`` (``DEFAULT_COORDINATOR_PORT`` unless given).

    ``base_env`` replaces the inherited environment — except the role
    and ``torchrun`` variables, which are scrubbed from either source and
    set here (see :func:`_scrub_role_vars`).
    """
    port = coordinator_port or const.DEFAULT_COORDINATOR_PORT
    coord = f"127.0.0.1:{port}"
    inherited = _scrub_role_vars(dict(os.environ) if base_env is None else dict(base_env))
    envs = []
    for i in range(n):
        env = {
            **inherited,
            ENV.AUTODIST_COORDINATOR.name: coord,
            ENV.AUTODIST_NUM_PROCESSES.name: str(n),
            ENV.AUTODIST_PROCESS_ID.name: str(i),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "RANK": str(i), "WORLD_SIZE": str(n),
            "LOCAL_RANK": str(i), "LOCAL_WORLD_SIZE": str(n),
        }
        if i:
            env[ENV.AUTODIST_WORKER.name] = f"local-process-{i}"
        envs.append(env)
    return _watched_wait(_RankGroup(argv, envs), watch)


def run_node(argv: Sequence[str], n_local: int) -> int:
    """The per-node mode: start this node's ``n_local`` ranks from this
    process's environment (that of the node's first rank, as the
    coordinator sets it) and return the first non-zero exit code, or 0.
    SIGTERM to this agent terminates its ranks."""
    base = dict(os.environ)
    first = int(base.get("RANK", base.get(ENV.AUTODIST_PROCESS_ID.name, "0")))
    address = base.get(ENV.AUTODIST_WORKER.name, "localhost")
    envs = []
    for i in range(int(n_local)):
        rank = first + i
        env = {**base, "RANK": str(rank), "LOCAL_RANK": str(i),
               "LOCAL_WORLD_SIZE": str(n_local),
               ENV.AUTODIST_PROCESS_ID.name: str(rank)}
        if rank:
            env[ENV.AUTODIST_WORKER.name] = address
        envs.append(env)
    ranks = _RankGroup(argv, envs)
    prev = signal.signal(signal.SIGTERM, lambda s, f: ranks.terminate())
    try:
        return ranks.wait()
    finally:
        signal.signal(signal.SIGTERM, prev)


_pidfile_written = False


def initialize_from_env() -> None:
    """Rank-side completion of the env contract, before ``pg.join`` (the
    JAX package's ``initialize_from_env`` joins ``jax.distributed`` here;
    the port's group forms in ``AutoDist`` on the device it trains on).

    When a multi-process launch is detected (``AUTODIST_NUM_PROCESSES`` >
    1 with an ``AUTODIST_COORDINATOR``), the ``torchrun`` variables that
    ``pg.join`` reads are filled from the ``AUTODIST_*`` contract where
    absent, and this process is recorded in a pidfile. Idempotent."""
    global _pidfile_written
    n = ENV.AUTODIST_NUM_PROCESSES.val
    coord = ENV.AUTODIST_COORDINATOR.val
    if n <= 1 or not coord:
        return
    host, port = coord.rsplit(":", 1)
    os.environ.setdefault("MASTER_ADDR", host)
    os.environ.setdefault("MASTER_PORT", port)
    os.environ.setdefault("WORLD_SIZE", str(n))
    os.environ.setdefault("RANK", str(ENV.AUTODIST_PROCESS_ID.val))
    if not _pidfile_written:
        write_pidfile()
        _pidfile_written = True
        logging.info("initialize_from_env: rendezvous=%s rank=%s/%d", coord,
                     os.environ["RANK"], n)


def main(args: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="autodist_tpu_torch.runtime.launcher",
        description="Launch a training script as every rank of an autodist_tpu_torch "
                    "cluster.",
    )
    parser.add_argument("--resource-spec", default="",
                        help="path to resource_spec.yml (default: this host's cards)")
    parser.add_argument("--num-local-processes", type=int, default=0,
                        help="run N ranks on this machine (tests, one node's cards)")
    parser.add_argument("--node-local-ranks", type=int, default=0,
                        help="per-node mode: start N ranks of this node from the "
                             "environment the coordinator set (internal)")
    parser.add_argument("--coordinator-port", type=int, default=0)
    parser.add_argument("--max-restarts", type=int, default=0,
                        help="relaunch a non-zero-exiting fleet up to N times")
    parser.add_argument("--restart-backoff", type=float, default=5.0)
    parser.add_argument("--ft-dir", default="",
                        help="fault-tolerance base dir shared by the fleet: ranks "
                             "heartbeat and snapshot under it, a hung fleet is "
                             "terminated for restart, and the restart budget resets "
                             "whenever the snapshot ring advances")
    parser.add_argument("--trace-out", default="",
                        help="shared dir for cross-process span tracing: every rank "
                             "flushes a chrome-trace part-file here and the launcher "
                             "stitches them into one trace-<id>.json after the run")
    parser.add_argument("command", nargs=argparse.REMAINDER, help="-- python train.py ...")
    ns = parser.parse_args(args)
    command = ns.command[1:] if ns.command[:1] == ["--"] else list(ns.command)
    if not command:
        parser.error("no command given; usage: launcher [--resource-spec s.yml] -- "
                     "python train.py")
    if ns.node_local_ranks:
        return run_node(command, ns.node_local_ranks)
    spec = ResourceSpec(ns.resource_spec) if ns.resource_spec else None
    ft_config = None
    if ns.ft_dir:
        from autodist_tpu_torch.ft import FTConfig

        ft_config = FTConfig(base_dir=ns.ft_dir)
    if ns.trace_out:
        os.environ[ENV.AUTODIST_TRACE_OUT.name] = ns.trace_out
    return launch_supervised(
        spec, command,
        max_restarts=ns.max_restarts,
        num_local_processes=ns.num_local_processes,
        coordinator_port=ns.coordinator_port or None,
        restart_backoff_s=ns.restart_backoff,
        ft_config=ft_config,
    )


if __name__ == "__main__":
    sys.exit(main())
