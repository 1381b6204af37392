"""Graceful subprocess termination: signal, grace period, then kill (the
port's copy of the JAX package's ``ft/procdrain.py``).

Standalone: stdlib only. SIGTERM first gives the child its exit path — the
ft preemption hook snapshots at its next step boundary — then, only if the
grace period expires, the process group is SIGKILLed.
"""
from __future__ import annotations

import os
import signal
import subprocess


def signal_group(proc, sig) -> None:
    """Deliver ``sig`` to the child's process group (it was started with
    ``start_new_session=True``), falling back to the child alone."""
    try:
        os.killpg(proc.pid, sig)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.send_signal(sig)
        except (ProcessLookupError, OSError):
            pass


def stop_gracefully(proc, grace_s: float = 60.0, kill_grace_s: float = 10.0):
    """SIGTERM ``proc``'s group, wait up to ``grace_s`` for a clean exit,
    escalate to SIGKILL, and reap.

    Returns ``(stdout, stderr)`` from the final ``communicate()`` (pipes
    captured by the caller's ``Popen``; ``(None, None)`` otherwise). The
    process is guaranteed reaped on return.
    """
    signal_group(proc, signal.SIGTERM)
    try:
        return proc.communicate(timeout=grace_s)
    except subprocess.TimeoutExpired:
        pass
    signal_group(proc, signal.SIGKILL)
    try:
        return proc.communicate(timeout=kill_grace_s)
    except subprocess.TimeoutExpired:
        # Unreapable (e.g. stuck in an uninterruptible syscall): report what
        # we have; the zombie is the kernel's problem now.
        return None, None
