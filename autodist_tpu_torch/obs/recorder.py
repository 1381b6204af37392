"""Flight recorder: an always-on, bounded black box of every run (the
port's copy of the JAX package's ``obs/recorder.py``, in its record format:
segments written by one package read in the other).

One compact JSONL record per train step or window, plus sparse events
(compiles, snapshots, heartbeat transitions, preemptions, errors), appended
to a crash-safe ring of segments on disk, so that after any death — a hang,
an out-of-memory, a NaN, a SIGKILL — the surviving segments are the
evidence of what happened.

- **One writer.** All flight-dir writes go through this module.
- **Crash-safe.** Each record is one JSON line, written and flushed at once
  (page cache: survives a process kill); ``fsync`` lands every
  ``fsync_every`` records or ``fsync_interval_s`` seconds, and at once for
  an event. A ``kill -9`` mid-write tears at most the final line, which
  :func:`read_records` skips.
- **Bounded.** Segments rotate at ``segment_records`` records; the newest
  ``keep_segments`` per process are kept.
- **Cheap.** An append is a ``json.dumps`` and a buffered write; the
  recorder counts its own cost (:meth:`FlightRecorder.stats` ``append_s``).

The **process-default** recorder turns on when ``AUTODIST_FT_DIR`` is
exported (every supervised fleet launch): records land in
``<ft base>/flight/``. ``AUTODIST_FLIGHT_DIR`` enables it alone;
``AUTODIST_NO_FLIGHT=1`` opts out. Feeds: ``DistributedTrainStep`` (the
first call's ``compile`` event and ``error`` events), ``ft.snapshot``
(snapshot and preempt events) and ``ft.heartbeat`` (peer transitions).
"""
from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.utils import logging

__all__ = [
    "FLIGHT_SUBDIR",
    "FlightRecorder",
    "disable",
    "enable",
    "flight_dir",
    "get_recorder",
    "read_records",
    "record_event",
    "record_step",
]

#: Subdirectory of the ft base dir the default recorder writes under.
FLIGHT_SUBDIR = "flight"
# Segment naming: flight-r<rank>-<seq>.jsonl — per-process files so a
# fleet on a shared filesystem never interleaves writers.
_SEGMENT_PREFIX = "flight-"
_SEGMENT_SUFFIX = ".jsonl"


def flight_dir(base_dir: str) -> str:
    """The flight-record dir for an ft base dir (ONE naming rule, shared
    with the JAX package's doctor, which reads a port fleet's records)."""
    return os.path.join(base_dir, FLIGHT_SUBDIR)


class FlightRecorder:
    """Append-only JSONL ring with the fsync discipline described above.

    Never raises out of a record call: a full disk or revoked mount
    degrades to counted drops (``stats()["errors"]``) — the black box must
    not be able to take down the plane.
    """

    def __init__(
        self,
        directory: str,
        process_id: Optional[int] = None,
        segment_records: int = 1024,
        keep_segments: int = 8,
        fsync_every: int = 64,
        fsync_interval_s: float = 5.0,
        clock=time.time,
    ):
        self.directory = directory
        self.process_id = (ENV.AUTODIST_PROCESS_ID.val
                           if process_id is None else int(process_id))
        self.segment_records = max(1, int(segment_records))
        self.keep_segments = max(1, int(keep_segments))
        self.fsync_every = max(1, int(fsync_every))
        self.fsync_interval_s = float(fsync_interval_s)
        self.clock = clock
        self._lock = threading.Lock()
        self._f = None
        self._seq = 0
        self._n_in_segment = 0
        self._since_fsync = 0
        self._last_fsync = time.monotonic()
        self._closed = False
        self._stats: Dict[str, float] = {
            "records": 0, "events": 0, "bytes": 0, "fsyncs": 0,
            "segments": 0, "pruned_segments": 0, "errors": 0,
            "append_s": 0.0,
        }
        try:
            os.makedirs(directory, exist_ok=True)
            self._seq = self._next_seq()
        except OSError as e:
            self._stats["errors"] += 1
            logging.warning("flight recorder dir unavailable (%s): %s",
                            directory, e)

    # ------------------------------------------------------------- recording
    def record_step(self, **fields: Any) -> None:
        """One per-step (or per-window) record: the dense telemetry row.
        Batched fsync — a crash loses at most ``fsync_every`` steps."""
        self._append({"kind": "step", **fields}, critical=False)

    def record_event(self, kind: str, critical: bool = True,
                     **fields: Any) -> None:
        """One sparse event (compile, snapshot, sentry verdict, error,
        preempt, run_end...). Critical events fsync immediately: they are
        exactly the records a postmortem cannot afford to lose."""
        self._append({"kind": str(kind), **fields}, critical=critical)
        with self._lock:
            self._stats["events"] += 1

    def _append(self, rec: Dict[str, Any], critical: bool) -> None:
        t0 = time.perf_counter()
        try:
            line = json.dumps(
                {"t": self.clock(), "r": self.process_id, **rec},
                separators=(",", ":"), default=str) + "\n"
        except (TypeError, ValueError):
            with self._lock:
                self._stats["errors"] += 1
            return
        with self._lock:
            if self._closed:
                return
            try:
                f = self._ensure_segment()
                f.write(line)
                f.flush()
                self._stats["records"] += 1
                self._stats["bytes"] += len(line)
                self._n_in_segment += 1
                self._since_fsync += 1
                now = time.monotonic()
                if (critical or self._since_fsync >= self.fsync_every
                        or now - self._last_fsync >= self.fsync_interval_s):
                    os.fsync(f.fileno())
                    self._stats["fsyncs"] += 1
                    self._since_fsync = 0
                    self._last_fsync = now
                if self._n_in_segment >= self.segment_records:
                    self._rotate()
            except (OSError, ValueError) as e:
                self._stats["errors"] += 1
                if self._stats["errors"] == 1:  # log the first, count the rest
                    logging.warning("flight record append failed: %s", e)
            finally:
                self._stats["append_s"] += time.perf_counter() - t0

    # -------------------------------------------------------------- segments
    def _segment_path(self, seq: int) -> str:
        return os.path.join(
            self.directory,
            f"{_SEGMENT_PREFIX}r{self.process_id}-{seq:06d}{_SEGMENT_SUFFIX}")

    def _own_segments(self) -> List[str]:
        """This process role's segment names, oldest first."""
        mine = f"{_SEGMENT_PREFIX}r{self.process_id}-"
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(n for n in names
                      if n.startswith(mine) and n.endswith(_SEGMENT_SUFFIX))

    def _next_seq(self) -> int:
        segs = self._own_segments()
        if not segs:
            return 0
        tail = segs[-1][len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)]
        try:
            return int(tail.rsplit("-", 1)[-1]) + 1
        except ValueError:
            return 0

    def _ensure_segment(self):
        if self._f is None:
            self._f = open(self._segment_path(self._seq), "a",
                           encoding="utf-8")
            self._stats["segments"] += 1
            self._n_in_segment = 0
        return self._f

    def _rotate(self) -> None:
        """Close the full segment (fsync'd) and prune the ring. Caller
        holds the lock."""
        f, self._f = self._f, None
        if f is not None:
            try:
                os.fsync(f.fileno())
            except OSError:
                pass
            f.close()
        self._seq += 1
        for name in self._own_segments()[:-self.keep_segments]:
            try:
                os.remove(os.path.join(self.directory, name))
                self._stats["pruned_segments"] += 1
            except OSError:
                pass

    # --------------------------------------------------------------- queries
    def stats(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._stats)

    def close(self, ok: bool = True, **fields: Any) -> None:
        """Flush + fsync + mark the run end. Idempotent; the ``run_end``
        event is what lets the doctor call a run *clean* (a crash never
        writes one)."""
        with self._lock:
            if self._closed:
                return
        self.record_event("run_end", ok=bool(ok), **fields)
        with self._lock:
            self._closed = True
            f, self._f = self._f, None
        if f is not None:
            try:
                os.fsync(f.fileno())
                f.close()
            except OSError:
                pass


# ------------------------------------------------------------------ reading
def read_records(directory: str) -> List[Dict[str, Any]]:
    """Parse every surviving flight record under ``directory``, all
    processes merged, sorted by timestamp. Torn lines (a crash mid-write
    tears at most the final line of a segment) and foreign files are
    skipped, never fatal — this is the reader the doctor trusts on a
    freshly killed run."""
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        if not (name.startswith(_SEGMENT_PREFIX)
                and name.endswith(_SEGMENT_SUFFIX)):
            continue
        try:
            with open(os.path.join(directory, name), encoding="utf-8",
                      errors="replace") as f:
                for ln in f:
                    ln = ln.strip()
                    if not ln:
                        continue
                    try:
                        rec = json.loads(ln)
                    except ValueError:
                        continue  # torn write: skip the fragment
                    if isinstance(rec, dict):
                        out.append(rec)
        except OSError:
            continue
    out.sort(key=lambda r: float(r.get("t", 0.0)))
    return out


def iter_steps(records: Iterable[Dict[str, Any]]):
    """The dense step records of a merged stream (doctor/sentry replay)."""
    return [r for r in records if r.get("kind") == "step"]


# ---------------------------------------------------------- default recorder
_default: Optional[FlightRecorder] = None
_default_lock = threading.Lock()
_resolved = False


def _env_default_dir() -> Optional[str]:
    """Where the always-on default records: AUTODIST_FLIGHT_DIR when set,
    else ``<AUTODIST_FT_DIR>/flight`` on fleet launches; None (disabled)
    otherwise or under AUTODIST_NO_FLIGHT=1."""
    if os.environ.get("AUTODIST_NO_FLIGHT") == "1":
        return None
    explicit = ENV.AUTODIST_FLIGHT_DIR.val
    if explicit:
        return explicit
    base = ENV.AUTODIST_FT_DIR.val
    return flight_dir(base) if base else None


def _install_default(rec: FlightRecorder) -> None:
    """Arm the default recorder's exit paths: at-exit close (the clean
    ``run_end`` marker) AND an excepthook chain — Python runs atexit
    handlers after an uncaught exception too, so without the hook a
    crashed run would still close with ``run_end ok=true`` and the doctor
    would call it clean. The error event lands first (critical fsync) and
    the doctor's precedence (crash/oom/nan beat clean) does the rest.
    Caller holds ``_default_lock``."""
    atexit.register(rec.close)
    prev_hook = sys.excepthook

    def hook(tp, val, tb):
        rec.record_event("error",
                         error=f"uncaught {tp.__name__}: {val}"[:500])
        prev_hook(tp, val, tb)

    sys.excepthook = hook


def get_recorder() -> Optional[FlightRecorder]:
    """The process-default recorder, or None when flight recording is off.
    First call resolves the env contract and arms the exit paths (clean
    ``run_end`` at exit; an uncaught exception records an ``error`` event
    first, so a crash can never read as clean)."""
    global _default, _resolved
    with _default_lock:
        if not _resolved:
            _resolved = True
            d = _env_default_dir()
            if d:
                _default = FlightRecorder(d)
                _install_default(_default)
        return _default


def enable(directory: str, **kwargs: Any) -> FlightRecorder:
    """Install (or replace) the process-default recorder at ``directory``
    — the programmatic form of ``AUTODIST_FLIGHT_DIR``."""
    global _default, _resolved
    with _default_lock:
        old, _default = _default, FlightRecorder(directory, **kwargs)
        _resolved = True
        _install_default(_default)
    if old is not None:
        old.close()
    return _default


def disable(ok: bool = True) -> None:
    """Close and remove the process-default recorder (the inverse of
    :func:`enable`). The next :func:`get_recorder` re-resolves the env
    contract, so scenario harnesses can scope a
    default recorder to one run without leaking it into the next."""
    global _default, _resolved
    with _default_lock:
        old, _default = _default, None
        _resolved = False
    if old is not None:
        old.close(ok=ok)


def record_step(**fields: Any) -> None:
    """Module-level convenience: no-op when no default recorder exists, so
    instrumentation points cost one function call on unconfigured runs."""
    rec = get_recorder()
    if rec is not None:
        rec.record_step(**fields)


def record_event(kind: str, critical: bool = True, **fields: Any) -> None:
    rec = get_recorder()
    if rec is not None:
        rec.record_event(kind, critical=critical, **fields)
