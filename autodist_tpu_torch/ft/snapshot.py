"""Preemption-aware train-state snapshots: async ring + integrity manifest
(the port's counterpart of the JAX package's ``ft/snapshot.py``, on the
port's :class:`~autodist_tpu_torch.checkpoint.saver.Saver`, in JAX's
format: a snapshot of either package verifies and restores in the other).

Checkpointing (``checkpoint/saver.py``) answers "persist this state";
snapshots answer the fault-tolerance question: keep a short ring of recent
states always on disk, written off the critical path, each entry
verifiable, so a preempted or crashed run resumes from seconds-old work —
on the same ranks or on fewer (``ft/elastic.py``).

Per snapshot:

1. **device→host copy on the calling thread**, synchronous, into fresh
   host tensors: the train step updates its state's tensors in place
   (``p.add_``, ``p.copy_``), so the copy must be complete before the next
   step runs and before the write thread starts. A copy into pageable
   memory with ``non_blocking=True`` (the offload path's idiom) would let
   the next step race it.
2. **background write** through the Saver (atomic stage→swap, one file per
   block). One snapshot in flight at a time: a request while the previous
   write runs is *skipped* (``ft_snapshots_skipped_total``), not queued.
   In a process group the ranks agree over the group's c10d store, before
   each snapshot, whether any of them is busy (then all skip) and whether
   any must block; the write's store barriers carry that agreement's
   sequence, so a skipped or overlapped write never meets another's.
3. **manifest**: after the swap, rank 0 writes ``MANIFEST.json`` (the step
   and a sha256 per file). :meth:`SnapshotManager.verify` re-hashes;
   :meth:`latest_valid` walks the ring newest→oldest skipping corrupt
   entries.
4. **ring prune**: the newest ``keep`` snapshots are kept.

``install_preempt_hook`` arms SIGTERM (a preemption notice). JAX's arrays
are immutable, so its handler snapshots the registered state at once and
defers only when that state was donated mid-step. The port's state is
updated in place: a snapshot taken from the handler while a step runs
would be torn (half the parameters after the update, half before). So the
handler records the signal and takes nothing while a train step runs, when
the registered state has been stepped past since it was registered, or in a
process group (the other ranks cannot join a snapshot from a handler); the
next :meth:`SnapshotManager.maybe_snapshot`, at a step boundary, takes the
forced snapshot and re-delivers the signal — JAX's deferred path, the only
path during a step.

Snapshot dirs use the Saver's ``ckpt-<step>`` naming, so every Saver
facility (``latest_checkpoint``, ``restore``) works on them unchanged.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.chaos import hooks as chaos_hooks
from autodist_tpu_torch.checkpoint.saver import Saver, ShardedLeaf
from autodist_tpu_torch.ft.config import FTConfig
from autodist_tpu_torch.obs import recorder as obs_recorder
from autodist_tpu_torch.obs import spans as obs_spans
from autodist_tpu_torch.utils import logging, retry

MANIFEST = "MANIFEST.json"

#: Snapshot-write retry (utils/retry.py): a transient unwritable dir heals
#: on a quick retry; a persistent failure surfaces through ``wait()``.
_WRITE_RETRY = retry.RetryPolicy(
    initial_s=0.05, max_s=0.5, multiplier=2.0, jitter=0.5,
    max_attempts=3, deadline_s=2.0)

#: How long a rank waits at a snapshot agreement for the others.
AGREE_TIMEOUT_S = 600.0

_instances = 0  # managers made in this process: part of their store keys


class StateInFlux(RuntimeError):
    """The registered state is being (or has been) stepped past: a snapshot
    of it now would be torn or mislabelled."""


def _chain_signal(sig, frame, prev) -> None:
    """Hand a caught signal on to whatever was installed before us: call a
    Python handler; re-deliver under ``SIG_DFL`` when the default
    disposition (terminate) was in place; do nothing for ``SIG_IGN``. This
    process's spans are flushed first (a default-disposition death runs no
    ``atexit`` handler)."""
    obs_spans._flush_at_exit()
    if callable(prev):
        prev(sig, frame)
    elif prev == signal.SIG_DFL:
        signal.signal(sig, signal.SIG_DFL)
        os.kill(os.getpid(), sig)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _to_host(leaf):
    """A host copy of one state leaf that the next step cannot change: a
    synchronous device→host copy (a CPU tensor is cloned), a
    :class:`ShardedLeaf`'s blocks likewise, numpy copied, ints as they are."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, ShardedLeaf):
        return ShardedLeaf(leaf.shape, leaf.dtype, leaf.blocks,
                           {j: _to_host(t) for j, t in leaf.local.items()})
    if isinstance(leaf, np.ndarray):
        return np.array(leaf, copy=True)
    return leaf


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_host_tree(v) for v in tree)
    return _to_host(tree)


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, ShardedLeaf):
        return sum(_nbytes(t) for t in tree.local.values())
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    return 0


def latest_snapshot_step(directory: str) -> Optional[int]:
    """Step of the newest *manifest-carrying* snapshot under ``directory``,
    or None. Cheap (no hashing) — the supervisor's progress probe."""
    saver = Saver(directory)
    for name in reversed(saver._list_checkpoints()):
        mpath = os.path.join(directory, name, MANIFEST)
        try:
            with open(mpath, encoding="utf-8") as f:
                return int(json.load(f)["step"])
        except (OSError, ValueError, KeyError):
            continue
    return None


class SnapshotManager:
    """Async ring of verified train-state snapshots.

    ``every_steps`` / ``every_s`` drive :meth:`maybe_snapshot`'s cadence
    (either trigger fires it; both 0 = only explicit :meth:`snapshot`
    calls). ``keep`` bounds the ring. ``group`` is the process group whose
    ranks snapshot together (default: the default group when one is
    formed); every rank calls :meth:`snapshot` and :meth:`maybe_snapshot`
    in the same order, as they call ``Saver.save``.
    """

    def __init__(
        self,
        directory: str,
        keep: int = 3,
        every_steps: int = 0,
        every_s: float = 0.0,
        registry: Optional[M.MetricsRegistry] = None,
        group=None,
    ):
        global _instances
        _instances += 1
        self._instance = _instances
        self.directory = directory
        self.keep = max(1, int(keep))
        self.every_steps = int(every_steps)
        self.every_s = float(every_s)
        self._worker: Optional[threading.Thread] = None
        self._worker_error: Optional[BaseException] = None
        self._last_step: Optional[int] = None
        self._last_time = 0.0
        self._state_provider: Optional[Callable[[], Tuple[Any, int]]] = None
        self._prev_handler = None
        self._hook_lock = threading.Lock()
        self._in_snapshot = False
        self.preempted = False
        # Signal whose termination was deferred to the next step boundary;
        # re-delivered after the deferred snapshot.
        self._pending_signal: Optional[int] = None
        self._xseq = 0
        self._prev_keys: List[str] = []
        self.set_group(group)
        #: The last snapshot's device→host seconds, write seconds (this
        #: rank's thread, manifest included) and bytes copied to the host.
        self.last_timing = {"device_to_host_s": None, "write_s": None, "bytes": None}

        reg = registry or M.registry
        self._c_taken = reg.counter("ft_snapshots_taken_total")
        self._c_skipped = reg.counter("ft_snapshots_skipped_total")
        self._c_corrupt = reg.counter("ft_snapshots_corrupt_total")
        self._c_preempt = reg.counter("ft_preempt_snapshots_total")
        self._c_write_retries = reg.counter("ft_snapshot_write_retries_total")
        self._g_step = reg.gauge("ft_snapshot_last_step")

    def set_group(self, group=None) -> None:
        """Snapshot with the ranks of ``group`` (the elastic rebuild re-points
        the ring at the survivors' group)."""
        if group is None and dist.is_initialized():
            group = dist.group.WORLD
        self.group = group
        self.saver = Saver(self.directory, max_to_keep=0, group=group)
        if group is not None:
            self.rank, self.world = dist.get_rank(group), dist.get_world_size(group)
            ranks = dist.get_process_group_ranks(group)
            self._gid = f"{self._instance}/{'-'.join(map(str, ranks))}"
        else:
            self.rank, self.world, self._gid = 0, 1, f"{self._instance}/0"

    @classmethod
    def from_config(cls, config: FTConfig,
                    registry: Optional[M.MetricsRegistry] = None, group=None
                    ) -> "SnapshotManager":
        cfg = config.resolved()
        return cls(
            cfg.snapshot_dir, keep=cfg.keep_snapshots,
            every_steps=cfg.snapshot_every_steps,
            every_s=cfg.snapshot_every_s, registry=registry, group=group,
        )

    # ------------------------------------------------------------- agreement
    def _agree(self, tag: str, flags: List[bool]) -> List[bool]:
        """Per flag, whether any rank of the group raised it: one exchange
        over the group's c10d store (``add`` and polling, never a
        collective). Every rank calls it at the same point."""
        if self.world == 1:
            return list(flags)
        from torch.distributed import distributed_c10d

        store = distributed_c10d._get_default_store()
        self._xseq += 1
        base = f"autodist_torch/ft/snapshot/{self._gid}/{self._xseq}/{tag}"
        for i, f in enumerate(flags):
            store.add(f"{base}/{i}", int(bool(f)))
        store.add(f"{base}/n", 1)
        deadline = time.monotonic() + AGREE_TIMEOUT_S
        while store.add(f"{base}/n", 0) < self.world:
            if time.monotonic() > deadline:
                raise TimeoutError(f"snapshot agreement {base!r}: not every rank arrived")
            time.sleep(0.001)
        out = [store.add(f"{base}/{i}", 0) > 0 for i in range(len(flags))]
        keys = [f"{base}/{i}" for i in range(len(flags))] + [f"{base}/n"]
        if self.rank == 0:
            # Every rank has arrived here, so all have read the previous
            # exchange's counts: drop them (the store does not grow a step).
            for old in self._prev_keys:
                store.delete_key(old)
        self._prev_keys = keys
        return out

    # ------------------------------------------------------------------ take
    def maybe_snapshot(self, state: Any, step: Optional[int] = None,
                       step_obj: Any = None) -> Optional[str]:
        """Snapshot iff the step/time cadence says one is due (or a
        preemption flag is pending, on any rank of the group). Returns the
        target path when a snapshot was initiated, else None. Blocks on
        file IO only for a forced (preemption) snapshot."""
        step = self._resolve_step(state, step)
        due = self.preempted
        if self.every_steps > 0 and (
                self._last_step is None
                or step - self._last_step >= self.every_steps):
            due = True
        if self.every_s > 0 and (
                time.monotonic() - self._last_time >= self.every_s):
            due = True
        due, forced = self._agree("cadence", [due, self.preempted])
        if not due:
            return None
        path = self.snapshot(state, step=step, step_obj=step_obj, block=forced)
        if self._pending_signal is not None and path is not None:
            # The handler deferred termination (a step was running); THIS
            # state is at a step boundary. The snapshot is on disk —
            # complete the preemption now.
            sig, self._pending_signal = self._pending_signal, None
            self._c_preempt.inc()
            logging.info(
                "deferred preemption snapshot written at step %d; "
                "re-delivering signal %d", step, sig)
            _chain_signal(sig, None, self._prev_handler)
        return path

    def snapshot(self, state: Any, step: Optional[int] = None,
                 step_obj: Any = None, block: bool = False) -> Optional[str]:
        """Take one snapshot now (every rank of the group calls it).

        ``step_obj`` (a :class:`~autodist_tpu_torch.kernel.DistributedTrainStep`)
        gives the checkpoint view of its state (``logical_state``: logical
        shapes, each rank's blocks) — the same contract as ``step.save``.
        ``block=True`` waits for the write (preemption path); otherwise only
        the device→host copy happens here and the file IO runs on the
        background worker.
        """
        busy, block = self._agree("take", [self._busy(), block])
        if busy:
            if not block:
                self._c_skipped.inc()
                logging.warning(
                    "snapshot at step %s skipped: a previous write is still in "
                    "flight", step)
                return None
            # A forced (preemption/final) snapshot must not be skippable.
            self.wait()
        step = self._resolve_step(state, step)
        self._in_snapshot = True
        try:
            tree = step_obj.logical_state(state) if step_obj is not None else state
            t0 = time.perf_counter()
            with obs_spans.span("ft.snapshot.device_to_host", step=step):
                host_tree = _host_tree(tree)
            self.last_timing = {"device_to_host_s": time.perf_counter() - t0,
                                "write_s": None, "bytes": _nbytes(host_tree)}
        finally:
            self._in_snapshot = False
        path = os.path.join(self.directory, f"ckpt-{step}")
        self._last_step, self._last_time = step, time.monotonic()
        self._worker_error = None
        key = f"ft-{self._gid}/{self._xseq}"
        self._worker = threading.Thread(
            target=self._write, args=(host_tree, path, step, key),
            name="ft-snapshot", daemon=False,
        )
        self._worker.start()
        if block:
            self.wait()
        return path

    def _busy(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    def wait(self) -> None:
        """Join any in-flight snapshot write; re-raise its failure."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        err, self._worker_error = self._worker_error, None
        if err is not None:
            raise RuntimeError("snapshot write failed") from err

    @staticmethod
    def _resolve_step(state: Any, step: Optional[int]) -> int:
        if step is not None:
            return int(step)
        s = getattr(state, "step", None)
        try:
            return int(s) if s is not None else 0
        except TypeError:
            return 0

    def _write(self, host_tree: Any, path: str, step: int, key: str) -> None:
        t0 = time.perf_counter()
        attempts = [0]
        try:
            with obs_spans.span("ft.snapshot.write", step=step):
                def attempt():
                    # Chaos seam: an installed plant may refuse the write.
                    chaos_hooks.fire(chaos_hooks.SEAM_SNAPSHOT_WRITE,
                                     path=path, step=step)
                    attempts[0] += 1
                    # Store barriers only (pure RPC): safe on this thread
                    # while the train step's collectives run.
                    self.saver.save(host_tree, path=path, step=step, block=True,
                                    sync_key=f"{key}/{attempts[0]}")
                    if self.rank == 0:
                        self._write_manifest(path, step)

                retry.retry_call(
                    attempt, policy=_WRITE_RETRY, retry_on=(OSError,),
                    describe=f"snapshot write {path}",
                    on_retry=lambda e, d, a: (
                        self._c_write_retries.inc(),
                        logging.warning(
                            "snapshot write attempt %d failed (%s); "
                            "retrying in %.3fs", a, e, d)))
                if self.rank == 0:
                    self._prune()
            # Post-landing chaos seam: corruption faults bit-rot the files
            # AFTER the manifest recorded their true hashes.
            chaos_hooks.fire(chaos_hooks.SEAM_SNAPSHOT_WRITTEN,
                             path=path, step=step)
            self.last_timing["write_s"] = time.perf_counter() - t0
            self._c_taken.inc()
            self._g_step.set(step)
            obs_recorder.record_event("snapshot", critical=False,
                                      step=step, path=path)
        except BaseException as e:  # noqa: BLE001 - surfaced via wait()
            self._worker_error = e
            obs_recorder.record_event(
                "error", error=f"snapshot write failed: "
                               f"{type(e).__name__}: {e}"[:500])
            logging.warning("snapshot write to %s failed", path, exc_info=True)

    def _write_manifest(self, path: str, step: int) -> None:
        files = {}
        for root, _, names in os.walk(path):
            for name in names:
                if name == MANIFEST:
                    continue
                full = os.path.join(root, name)
                files[os.path.relpath(full, path)] = _sha256(full)
        manifest = {"step": step, "time": time.time(), "files": files}
        tmp = os.path.join(path, MANIFEST + ".tmp")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
        os.replace(tmp, os.path.join(path, MANIFEST))

    def _prune(self) -> None:
        names = self.saver._list_checkpoints()
        for stale in names[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, stale),
                          ignore_errors=True)

    # ---------------------------------------------------------------- verify
    def verify(self, path: str) -> bool:
        """True iff the snapshot's manifest exists and every listed file
        hashes to its recorded digest (and none is missing)."""
        try:
            with open(os.path.join(path, MANIFEST), encoding="utf-8") as f:
                manifest = json.load(f)
            for rel, digest in manifest["files"].items():
                if _sha256(os.path.join(path, rel)) != digest:
                    return False
        except (OSError, ValueError, KeyError):
            return False
        return True

    def latest_valid(self) -> Optional[str]:
        """Newest snapshot that passes :meth:`verify`, walking the ring
        newest→oldest; corrupt entries are skipped (counted + logged)."""
        self.wait()
        for name in reversed(self.saver._list_checkpoints()):
            path = os.path.join(self.directory, name)
            if self.verify(path):
                return path
            self._c_corrupt.inc()
            logging.warning(
                "snapshot %s failed integrity verification; falling back to "
                "the previous ring entry", path)
        return None

    def restore_latest_valid(self, target: Any = None, device=None) -> Optional[Any]:
        """Restore the newest verified snapshot (None when the ring holds
        no valid entry). Each rank reads only the regions its target leaves
        need (a :class:`ShardedLeaf` target: its blocks), whatever layout
        the snapshot was written in — the resharded-resume primitive
        ``ft/elastic.py`` builds on."""
        path = self.latest_valid()
        if path is None:
            return None
        logging.info("restoring snapshot %s", path)
        return self.saver.restore(path, target=target, device=device)

    def latest_step(self) -> Optional[int]:
        return latest_snapshot_step(self.directory)

    # --------------------------------------------------------------- preempt
    def register_state_provider(
            self, fn: Callable[[], Tuple[Any, int]]) -> None:
        """``fn() -> (state_tree, step)`` called by the preemption hook to
        get the freshest snapshot-able state; it raises
        :class:`StateInFlux` when that state has been stepped past
        (``FTRuntime.maybe_snapshot`` registers such a provider)."""
        self._state_provider = fn

    def _must_defer(self) -> bool:
        """Whether the handler must leave the snapshot to the next step
        boundary: a train step is running (its in-place update would tear
        the snapshot), a snapshot is being taken, or the ranks of a group
        would have to join it."""
        from autodist_tpu_torch.kernel.lowering import steps_in_flight

        return steps_in_flight() > 0 or self._in_snapshot or self.world > 1

    def install_preempt_hook(self, signum: int = signal.SIGTERM) -> None:
        """Arm ``signum`` (default SIGTERM, a preemption notice) to force a
        final snapshot, then hand the signal back: a previously installed
        Python handler is chained; the default disposition is HONORED by
        re-delivering the signal with ``SIG_DFL`` restored (a preempted
        process must still die once its snapshot is safe). While a step
        runs the snapshot and the re-delivery wait for the next
        :meth:`maybe_snapshot` (see the module docstring). Must be called
        from the main thread (CPython signal rule)."""
        if self._prev_handler is not None:
            return

        def handler(sig, frame):
            self.preempted = True
            saved = True
            # First, before any snapshot IO that may itself fail: the
            # preemption event, fsync'd at once.
            obs_recorder.record_event("preempt", signal=int(sig),
                                      step=self._last_step)
            with self._hook_lock:
                if self._state_provider is not None:
                    try:
                        if self._must_defer():
                            raise StateInFlux("a train step or snapshot is running, "
                                              "or the ranks of a group must join")
                        state, step = self._state_provider()
                        logging.info(
                            "preemption signal %d: forcing final snapshot at "
                            "step %d", sig, step)
                        self.snapshot(state, step=step, block=True)
                        self._c_preempt.inc()
                    except Exception as e:  # noqa: BLE001 - exit path must not throw
                        # Termination is DEFERRED: the loop's next
                        # maybe_snapshot, at a step boundary, takes the
                        # forced snapshot and then re-delivers this signal.
                        saved = False
                        self._pending_signal = sig
                        logging.warning(
                            "preemption snapshot deferred to the next step "
                            "boundary (maybe_snapshot): %s", e,
                            exc_info=not isinstance(e, StateInFlux))
            if saved:
                _chain_signal(sig, frame, self._prev_handler)

        self._prev_handler = signal.signal(signum, handler) or signal.SIG_DFL
