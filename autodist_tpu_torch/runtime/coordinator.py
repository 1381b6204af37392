"""Coordinator: chief-side launch of the other nodes, and their watch (the
port's counterpart of the JAX package's ``runtime/coordinator.py``).

On the chief it ships a serialized strategy to every remote node (``scp``
into the worker's ``DEFAULT_STRATEGY_DIR``, where ``AutoDist`` waits for
it), starts one command per non-chief node — over the system ``ssh``, or
as a local subprocess for a local address — and runs a monitor thread per
node that terminates the chief's fleet when a node fails.

JAX starts the user's script once per host (one controller owns the
host's chips). The port runs one rank per GPU, so the command a node runs
is the port's launcher in its per-node mode (``--node-local-ranks N``):
it starts the node's ``N`` local ranks from the node's environment (rank 0
of the node's, :meth:`Cluster.env_for_worker`) and exits non-zero as soon
as any of them dies, as ``torchrun``'s agent does. The chief's monitor
watches that one process per node, as JAX's watches one per host.
"""
from __future__ import annotations

import os
import shlex
import subprocess
import sys
import threading
from typing import Dict, List, Optional, Sequence

from autodist_tpu_torch import const
from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.runtime.cluster import Cluster
from autodist_tpu_torch.utils import logging

_LOCAL_ADDRESSES = ("localhost", "127.0.0.1", "0.0.0.0", "::1")


def _is_local(address: str) -> bool:
    if address in _LOCAL_ADDRESSES:
        return True
    try:
        import socket

        return address in (socket.gethostname(), socket.getfqdn())
    except OSError:  # pragma: no cover
        return False


def node_command(argv: Sequence[str], n_local: int) -> List[str]:
    """The per-node agent command: the port's launcher starting ``n_local``
    ranks of ``argv``."""
    return [sys.executable, "-m", "autodist_tpu_torch.runtime.launcher",
            "--node-local-ranks", str(int(n_local)), "--", *argv]


class Coordinator:
    """Launch the user script on every other node and watch it.

    ``launch_clients()`` starts each non-chief node's agent with the role
    env of the node's first rank; monitor threads implement the chief's
    fail-fast.
    """

    def __init__(
        self,
        cluster: Cluster,
        strategy=None,
        argv: Optional[Sequence[str]] = None,
        extra_env: Optional[Dict[str, str]] = None,
    ):
        self.cluster = cluster
        self.strategy = strategy
        self.argv = list(argv) if argv is not None else [sys.executable] + sys.argv
        # Forwarded into every node's env (local subprocess and SSH shell
        # alike) — the supervisor's AUTODIST_RESTART travels here.
        self.extra_env = dict(extra_env or {})
        self.procs: List[subprocess.Popen] = []
        self.threads: List[threading.Thread] = []
        self._failed = threading.Event()
        self._failure_action = None

    # ------------------------------------------------------------------ launch
    def launch_clients(self) -> None:
        strategy_id = self.strategy.id if self.strategy else ENV.AUTODIST_STRATEGY_ID.val
        spec = self.cluster.resource_spec
        workers = [n for n in spec.nodes if n.address != spec.chief_address]
        for node in workers:
            env = {**self.extra_env,
                   **self.cluster.env_for_worker(node.address, strategy_id)}
            n_local = self.cluster.local_world_size(node.address)
            if _is_local(node.address):
                proc = self._launch_local(env, n_local)
            else:
                self._ship_strategy(node.address, strategy_id)
                proc = self._launch_remote(node.address, env, n_local)
            self.procs.append(proc)
            self.cluster.register_local_process(proc)
            t = threading.Thread(target=self._monitor, args=(node.address, proc),
                                 daemon=True)
            t.start()
            self.threads.append(t)
            logging.info("launched node %s: %d rank(s) (pid %d)", node.address, n_local,
                         proc.pid)

    def _launch_local(self, env: Dict[str, str], n_local: int = 1) -> subprocess.Popen:
        full_env = {**os.environ, **env}
        # setsid: own process group, so terminate() can killpg it without
        # taking down the chief.
        return subprocess.Popen(node_command(self.argv, n_local), env=full_env,
                                start_new_session=True, stdout=None, stderr=None)

    def _ssh_parts(self, address: str):
        """(option args, target, config) honoring the spec's ssh config for
        this host (user, port, key file)."""
        cfg = self.cluster.resource_spec.ssh_config_for(address)
        opts = ["-o", "StrictHostKeyChecking=no"]
        target = address
        if cfg is not None:
            if cfg.port and cfg.port != 22:
                opts += ["-p", str(cfg.port)]
            if cfg.key_file:
                opts += ["-i", cfg.key_file]
            if cfg.user:
                target = f"{cfg.user}@{address}"
        return opts, target, cfg

    def _launch_remote(self, address: str, env: Dict[str, str],
                       n_local: int = 1) -> subprocess.Popen:
        opts, target, cfg = self._ssh_parts(address)
        exports = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())
        venv = (f". {shlex.quote(cfg.python_venv)}/bin/activate && "
                if cfg is not None and cfg.python_venv else "")
        cmd = (f"{venv}cd {shlex.quote(os.getcwd())} && {exports} "
               f"{' '.join(shlex.quote(a) for a in node_command(self.argv, n_local))}")
        if ENV.AUTODIST_DEBUG_REMOTE.val:
            # Print instead of executing: the exact replayable command.
            logging.info("[debug-remote] ssh %s %s %s", " ".join(opts), target, cmd)
            return subprocess.Popen(["true"])
        return subprocess.Popen(["ssh", *opts, target, cmd], start_new_session=True)

    def _ship_strategy(self, address: str, strategy_id: str) -> None:
        """``scp`` the serialized strategy file into the worker's
        ``DEFAULT_STRATEGY_DIR`` (what a worker's ``AutoDist`` waits for)."""
        if not strategy_id:
            return
        path = os.path.join(const.DEFAULT_STRATEGY_DIR, strategy_id)
        if not os.path.exists(path) or ENV.AUTODIST_DEBUG_REMOTE.val:
            return
        opts, target, _ = self._ssh_parts(address)
        # scp spells the port flag -P (capital), unlike ssh.
        scp_opts = ["-P" if o == "-p" else o for o in opts]
        subprocess.run(["ssh", *opts, target,
                        f"mkdir -p {shlex.quote(const.DEFAULT_STRATEGY_DIR)}"], check=True)
        subprocess.run(["scp", *scp_opts, path, f"{target}:{path}"], check=True)

    # ----------------------------------------------------------------- monitor
    def set_failure_action(self, action) -> None:
        """Replace the fail-fast ``os._exit(1)`` with ``action()`` (a
        supervised launch terminates the chief's ranks instead, so
        ``launch()`` returns non-zero and the supervisor decides)."""
        self._failure_action = action

    def _monitor(self, address: str, proc: subprocess.Popen) -> None:
        code = proc.wait()
        if code != 0 and not self._failed.is_set():
            self._failed.set()
            logging.error("node %s exited with code %d — terminating the chief "
                          "(fail-fast)", address, code)
            self.cluster.terminate()
            if self._failure_action is not None:
                self._failure_action()
            else:
                os._exit(1)

    def join(self) -> None:
        """Block until every node's agent exits."""
        for proc in self.procs:
            proc.wait()

    @property
    def any_failed(self) -> bool:
        return self._failed.is_set()
