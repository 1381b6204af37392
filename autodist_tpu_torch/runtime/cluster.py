"""Cluster: the process table and the group's bootstrap (the port's
counterpart of the JAX package's ``runtime/cluster.py``).

JAX runs one controller process per host, which owns all of that host's
chips, so its process table has one row per node. The port runs one rank
per device (``runtime/process_group.py``), so its table has one row per
(node, GPU): chief first, then by address (JAX's order), then by local
index — the numbering of ``ResourceSpec.gpu_devices``, so rank ``r``
trains on the ``r``-th device of the spec. A node without GPUs (a CPU
spec) is one rank.

:meth:`Cluster.env_for_worker` gives each rank both the JAX package's
``AUTODIST_*`` contract and the ``torchrun`` variables that ``pg.join``
forms the group from (``MASTER_ADDR``/``MASTER_PORT`` of the chief,
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``;
``AUTODIST_PROCESS_ID`` equals ``RANK``). The port has its own pidfiles
under its working directory, never the JAX package's.
"""
from __future__ import annotations

import atexit
import json
import os
import signal
import subprocess
from typing import Dict, List, Optional, Tuple

from autodist_tpu_torch import const
from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.utils import logging

#: The ``torchrun`` variables a launch sets (and a fresh launch scrubs).
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                 "LOCAL_WORLD_SIZE", "GROUP_RANK", "ROLE_RANK", "ROLE_WORLD_SIZE",
                 "TORCHELASTIC_RUN_ID")


def _deterministic_port(spec: ResourceSpec) -> int:
    """A rendezvous port in ``DEFAULT_PORT_RANGE`` keyed on the spec's
    fingerprint, so concurrent clusters on one machine do not collide but
    all members of one cluster agree."""
    rng = const.DEFAULT_PORT_RANGE
    return rng.start + int(spec.fingerprint(), 16) % len(rng)


def local_ranks(node) -> int:
    """Ranks a node runs: one per GPU, one for a node without GPUs."""
    return max(int(node.gpus), 1)


class Cluster:
    """The process table and group lifecycle of one ResourceSpec.

    ``start()`` on the chief launches nothing itself (the
    :class:`~autodist_tpu_torch.runtime.coordinator.Coordinator` starts the
    other nodes) but sweeps stale processes and joins the group.
    """

    def __init__(self, resource_spec: ResourceSpec, coordinator_port: Optional[int] = None):
        self.resource_spec = resource_spec
        self.coordinator_port = coordinator_port or _deterministic_port(resource_spec)
        # chief-first, address-sorted — must match ResourceSpec.gpu_devices.
        self._ordered_nodes = sorted(resource_spec.nodes,
                                     key=lambda n: (not n.chief, n.address))
        self._table: List[Tuple[str, int]] = [
            (n.address, i) for n in self._ordered_nodes for i in range(local_ranks(n))]
        self._initialized = False
        self._local_procs: List[subprocess.Popen] = []

    # ------------------------------------------------------------- identities
    @property
    def num_processes(self) -> int:
        """The world size: one rank per (node, GPU)."""
        return len(self._table)

    @property
    def process_table(self) -> List[Tuple[str, int]]:
        """``(address, local rank)`` of every rank, in rank order."""
        return list(self._table)

    def local_world_size(self, address: str) -> int:
        node = next((n for n in self._ordered_nodes if n.address == address), None)
        if node is None:
            raise ValueError(f"address {address!r} not in resource spec")
        return local_ranks(node)

    @property
    def coordinator_address(self) -> str:
        """``chief_address:port`` of the rendezvous every rank dials."""
        override = ENV.AUTODIST_COORDINATOR.val
        if override:
            return override
        return f"{self.resource_spec.chief_address}:{self.coordinator_port}"

    def process_id(self, address: Optional[str] = None, local_rank: int = 0) -> int:
        """The rank of ``(address, local_rank)`` (default: this process,
        from ``RANK`` when a launch set it)."""
        if address is None:
            if os.environ.get("RANK") is not None:
                return int(os.environ["RANK"])
            address = ENV.AUTODIST_WORKER.val or self.resource_spec.chief_address
            local_rank = int(os.environ.get("LOCAL_RANK", local_rank))
        try:
            return self._table.index((address, int(local_rank)))
        except ValueError:
            raise ValueError(f"address {address!r} (local rank {local_rank}) not in "
                             "resource spec") from None

    @property
    def is_chief(self) -> bool:
        return const.is_chief_process()

    def env_for_worker(self, address: str, strategy_id: str = "",
                       local_rank: int = 0) -> Dict[str, str]:
        """The environment of one rank: the JAX package's ``AUTODIST_*``
        contract and the ``torchrun`` variables. Every rank but rank 0
        carries ``AUTODIST_WORKER`` (its node's address)."""
        rank = self.process_id(address, local_rank)
        host, port = self.coordinator_address.rsplit(":", 1)
        env = {
            ENV.AUTODIST_COORDINATOR.name: self.coordinator_address,
            ENV.AUTODIST_NUM_PROCESSES.name: str(self.num_processes),
            ENV.AUTODIST_PROCESS_ID.name: str(rank),
            ENV.AUTODIST_MIN_LOG_LEVEL.name: str(ENV.AUTODIST_MIN_LOG_LEVEL.val),
            "MASTER_ADDR": host,
            "MASTER_PORT": port,
            "RANK": str(rank),
            "WORLD_SIZE": str(self.num_processes),
            "LOCAL_RANK": str(local_rank),
            "LOCAL_WORLD_SIZE": str(self.local_world_size(address)),
        }
        if rank != 0:
            env[ENV.AUTODIST_WORKER.name] = address
        if strategy_id:
            env[ENV.AUTODIST_STRATEGY_ID.name] = strategy_id
        return env

    # -------------------------------------------------------------- lifecycle
    def initialize(self, device=None) -> None:
        """Join the process group (idempotent; nothing at one process):
        ``pg.join`` on ``device`` (default ``"cuda"``) from the launch's
        environment — the counterpart of ``jax.distributed.initialize``."""
        if self._initialized or self.num_processes == 1:
            self._initialized = True
            return
        from autodist_tpu_torch.runtime import process_group as pg
        from autodist_tpu_torch.utils.device import resolve_device

        rank = self.process_id()
        logging.info("joining cluster: rendezvous=%s rank=%d/%d",
                     self.coordinator_address, rank, self.num_processes)
        pg.join(resolve_device(device), init_method=f"tcp://{self.coordinator_address}",
                world_size=self.num_processes, rank=rank)
        self._initialized = True

    def start(self, device=None) -> None:
        """Chief-side bring-up: sweep stale processes, then join."""
        clean_stale_processes()
        self.initialize(device)

    def register_local_process(self, proc: subprocess.Popen) -> None:
        self._local_procs.append(proc)

    def terminate(self) -> None:
        """SIGTERM the process groups this process launched."""
        for proc in self._local_procs:
            if proc.poll() is None:
                try:
                    os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
                except (ProcessLookupError, PermissionError):
                    pass
        self._local_procs.clear()

    def shutdown(self) -> None:
        self.terminate()
        if self._initialized and self.num_processes > 1:
            from autodist_tpu_torch.runtime import process_group as pg

            pg.leave()
        self._initialized = False


# -------------------------------------------------------------- stale cleanup
#: Exported by the launcher to every process it starts: its pid and start
#: time, recorded in their pidfiles.
LAUNCHER_ENV = "AUTODIST_TORCH_LAUNCHER"


def _pidfile_dir() -> str:
    d = os.path.join(const.DEFAULT_WORKING_DIR, "pids")
    os.makedirs(d, exist_ok=True)
    return d


def _start_time(pid: int) -> Optional[str]:
    """The kernel's start time of ``pid`` (``/proc/<pid>/stat`` field 22),
    or None when it is gone (or there is no ``/proc``)."""
    try:
        with open(f"/proc/{pid}/stat", encoding="utf-8") as f:
            return f.read().rsplit(")", 1)[1].split()[19]
    except (OSError, IndexError):
        return None


def _alive(pid: int, start: Optional[str]) -> bool:
    """Whether ``pid`` is the same live process that was recorded (a pid
    reused by another process is not)."""
    if pid <= 0:
        return False
    now = _start_time(pid)
    if now is not None:
        return start is None or now == start
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def launcher_token() -> str:
    """``<pid>:<start time>`` of this process, for :data:`LAUNCHER_ENV`."""
    return f"{os.getpid()}:{_start_time(os.getpid()) or ''}"


def write_pidfile() -> str:
    """Record this process (its pid, start time and launcher) so a later
    launch can sweep it if it leaks after its launcher died."""
    path = os.path.join(_pidfile_dir(), f"{os.getpid()}.pid")
    record = {"pid": os.getpid(), "start": _start_time(os.getpid()),
              "launcher": os.environ.get(LAUNCHER_ENV, "")}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(record, f)
    atexit.register(_unlink_quietly, path)      # a clean exit leaves no entry
    return path


def _unlink_quietly(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _ancestors() -> set:
    """This process and its ancestors' pids."""
    out, pid = {os.getpid()}, os.getppid()
    while pid > 1 and pid not in out:
        out.add(pid)
        try:
            with open(f"/proc/{pid}/stat", encoding="utf-8") as f:
                pid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            break
    return out


def clean_stale_processes() -> int:
    """SIGTERM the port's processes that outlived their launcher: each
    pidfile of the port's working directory whose process is alive (the
    same process: its start time matches) while the launcher recorded in
    it is gone. A process of a running launch (another fleet on this
    machine) or started by no launcher is left alone, and so are this process, its ancestors
    and any pid reused since; the JAX package's pidfiles live elsewhere
    and are never read. Dead entries are removed. Returns the number of
    processes signalled."""
    killed = 0
    keep = _ancestors()
    d = _pidfile_dir()
    for name in os.listdir(d):
        if not name.endswith(".pid"):
            continue
        path = os.path.join(d, name)
        try:
            with open(path, "r", encoding="utf-8") as f:
                rec = json.loads(f.read())
            pid, start = int(rec["pid"]), rec.get("start")
            launcher = str(rec.get("launcher", ""))
        except (ValueError, OSError, KeyError, TypeError):
            _unlink_quietly(path)
            continue
        if pid in keep:
            continue
        if not _alive(pid, start):
            os.unlink(path)
            continue
        lpid, _, lstart = launcher.partition(":")
        if not launcher or _alive(int(lpid or 0), lstart or None):
            continue                    # no launcher, or its launch still runs
        try:
            os.kill(pid, signal.SIGTERM)
            killed += 1
            logging.info("killed stale autodist_tpu_torch process %d", pid)
        except (ProcessLookupError, PermissionError):
            pass
        _unlink_quietly(path)
    return killed
