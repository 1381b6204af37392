"""Lightweight cross-process span tracing → chrome-trace / Perfetto JSON
(the port's copy of the JAX package's ``obs/spans.py``, in its format:
part-files and stitched traces read in either package).

A process-wide span tracer any layer writes into — snapshot writes, the
lowering, the launcher's fleet span — whose spans from *different
processes of one launch* stitch into a single timeline.

Mechanics:

- :class:`SpanTracer` holds a thread-safe ring buffer of completed spans
  (bounded memory; a long-running server can trace forever). Spans are
  opened with the :meth:`SpanTracer.span` context manager or the
  :func:`traced` decorator, or recorded retroactively with
  :meth:`SpanTracer.add_span` (e.g. queue-wait time measured by the
  batcher after the fact). Timestamps are wall-clock (``time.time`` —
  the only clock comparable across processes on one host fleet to span
  precision); durations come from ``time.perf_counter`` deltas.
- The **trace id** rides the ``AUTODIST_TRACE_ID`` env var: the launcher
  generates one and exports it to every process it starts
  (``runtime/launcher.py``), so launcher → node agent → rank spans all
  carry the same id. :func:`current_trace_id` generates-and-pins one when
  unset, so single-process runs trace too.
- Export is the chrome-trace JSON object format (``traceEvents`` with
  ``ph: "X"`` complete events, microsecond ``ts``/``dur``) that both
  ``chrome://tracing`` and Perfetto load directly. With
  ``AUTODIST_TRACE_OUT=<dir>`` set, every process flushes its part-file
  into the shared dir at exit; :func:`stitch` merges the parts into ONE
  ``trace-<id>.json`` (the launcher calls it after the fleet exits).

The tracer is stdlib-only (no torch import): the launcher, which never
touches a device, traces through the same module.
"""
from __future__ import annotations

import atexit
import contextlib
import functools
import json
import os
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from autodist_tpu_torch.const import ENV

__all__ = [
    "Span",
    "SpanTracer",
    "add_span",
    "current_trace_id",
    "enable_trace_out",
    "events_for_request",
    "export",
    "get_tracer",
    "span",
    "stitch",
    "traced",
]

_PART_PREFIX = "obs-part-"


def current_trace_id() -> str:
    """The trace id every span in this process carries.

    Inherited from ``AUTODIST_TRACE_ID`` when the launcher exported one;
    otherwise generated once and pinned into ``os.environ`` so any child
    processes started from here join the same trace.
    """
    tid = ENV.AUTODIST_TRACE_ID.val
    if not tid:
        tid = uuid.uuid4().hex[:16]
        os.environ[ENV.AUTODIST_TRACE_ID.name] = tid
    return tid


@dataclass
class Span:
    """One completed span: wall-clock start, measured duration, identity."""

    name: str
    t_start_s: float                 # wall clock (time.time) at open
    dur_s: float                     # perf_counter-measured duration
    trace_id: str
    process: int                     # AUTODIST_PROCESS_ID (the rank)
    os_pid: int
    tid: int
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_event(self) -> Dict[str, Any]:
        """Chrome-trace "X" (complete) event, microsecond units.

        The chrome ``pid`` is the OS pid, not the mesh role: the launcher
        and the chief are both role 0 but must render as separate tracks
        (the role rides in ``args`` and the process_name metadata)."""
        return {
            "name": self.name,
            "ph": "X",
            "ts": self.t_start_s * 1e6,
            "dur": max(self.dur_s, 0.0) * 1e6,
            "pid": self.os_pid,
            "tid": self.tid,
            "args": {**self.attrs, "trace_id": self.trace_id,
                     "process": self.process},
        }


class SpanTracer:
    """Thread-safe bounded span buffer with chrome-trace export."""

    def __init__(self, capacity: int = 4096, trace_id: Optional[str] = None,
                 process: Optional[int] = None):
        self._spans: deque = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self._trace_id = trace_id
        self._process = process
        self._dropped = 0

    @property
    def trace_id(self) -> str:
        # Resolved lazily: the launcher may export AUTODIST_TRACE_ID after
        # this module (and the default tracer) was imported.
        if self._trace_id is None:
            self._trace_id = current_trace_id()
        return self._trace_id

    @property
    def process(self) -> int:
        if self._process is None:
            self._process = ENV.AUTODIST_PROCESS_ID.val
        return self._process

    # ------------------------------------------------------------- recording
    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """``with tracer.span("phase", key=val): ...`` — monotonic-clocked,
        recorded on exit (exceptions mark the span ``error: true``)."""
        t_wall = time.time()
        t0 = time.perf_counter()
        try:
            yield self
        except BaseException:
            attrs = {**attrs, "error": True}
            raise
        finally:
            self.add_span(name, t_wall, time.perf_counter() - t0, **attrs)

    def traced(self, name: Optional[str] = None):
        """Decorator form of :meth:`span` (span named after the function)."""

        def deco(fn):
            label = name or getattr(fn, "__qualname__", fn.__name__)

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                with self.span(label):
                    return fn(*args, **kwargs)

            return wrapper

        return deco

    def add_span(self, name: str, t_start_s: float, dur_s: float,
                 **attrs) -> Span:
        """Record a span measured elsewhere (retroactive — e.g. queue wait
        computed at admission time). ``t_start_s`` is wall-clock seconds."""
        sp = Span(
            name=name, t_start_s=float(t_start_s), dur_s=float(dur_s),
            trace_id=self.trace_id, process=self.process,
            os_pid=os.getpid(), tid=threading.get_ident() % 1_000_000,
            attrs=attrs,
        )
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(sp)
        return sp

    # --------------------------------------------------------------- reading
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    @property
    def dropped(self) -> int:
        """Spans evicted by the ring since construction (capacity pressure)."""
        return self._dropped

    def set_capacity(self, capacity: int) -> None:
        """Resize the ring, keeping the newest spans (``ObsConfig
        .span_capacity`` applies through here)."""
        with self._lock:
            self._spans = deque(self._spans, maxlen=max(1, int(capacity)))

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    # ---------------------------------------------------------------- export
    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome-trace JSON object (self-contained, loadable as-is)."""
        events: List[Dict[str, Any]] = [
            {
                "name": "process_name", "ph": "M", "pid": os.getpid(),
                "args": {"name": f"autodist role {self.process} "
                                 f"(os pid {os.getpid()})"},
            }
        ]
        events.extend(sp.to_event() for sp in self.spans())
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"trace_id": self.trace_id},
        }

    def export(self, path: str) -> str:
        """Write the chrome trace to ``path`` (atomic tmp + replace)."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.to_chrome_trace(), f)
        os.replace(tmp, path)
        return path

    def flush_part(self, directory: str) -> str:
        """Write this process's part-file into a shared trace-out dir, named
        so :func:`stitch` can find every part of one trace."""
        name = (f"{_PART_PREFIX}{self.trace_id}"
                f"-r{self.process}-{os.getpid()}.json")
        return self.export(os.path.join(directory, name))


# ----------------------------------------------------------- default tracer
_default_tracer: Optional[SpanTracer] = None
_default_lock = threading.Lock()
_autoflush_installed = False


def get_tracer() -> SpanTracer:
    """The process-default tracer (every built-in instrumentation point
    writes here). First use arms the ``AUTODIST_TRACE_OUT`` at-exit flush
    when that env var names a directory."""
    global _default_tracer, _autoflush_installed
    with _default_lock:
        if _default_tracer is None:
            _default_tracer = SpanTracer()
        if not _autoflush_installed and ENV.AUTODIST_TRACE_OUT.val:
            _autoflush_installed = True
            atexit.register(_flush_at_exit)
    return _default_tracer


def _flush_at_exit() -> None:
    out = ENV.AUTODIST_TRACE_OUT.val
    tracer = _default_tracer
    if not out or tracer is None or not tracer.spans():
        return
    try:
        tracer.flush_part(out)
    except OSError:
        pass  # exit-path best effort: a full disk must not mask the exit code


def enable_trace_out(directory: str) -> None:
    """Programmatic equivalent of ``AUTODIST_TRACE_OUT=<dir>``: this process
    (and children inheriting the env) flush span part-files into ``dir``."""
    os.environ[ENV.AUTODIST_TRACE_OUT.name] = directory
    get_tracer()  # arms the at-exit flush


def span(name: str, **attrs):
    """Module-level convenience over the default tracer."""
    return get_tracer().span(name, **attrs)


def traced(name: Optional[str] = None):
    return get_tracer().traced(name)


def add_span(name: str, t_start_s: float, dur_s: float, **attrs) -> Span:
    return get_tracer().add_span(name, t_start_s, dur_s, **attrs)


def export(path: str) -> str:
    return get_tracer().export(path)


# --------------------------------------------------------- request tracing
def events_for_request(trace: Dict[str, Any], request_id: str,
                       ) -> List[Dict[str, Any]]:
    """Filter a chrome-trace document (``to_chrome_trace()`` output or a
    stitched file's JSON) down to one request's span chain, time-ordered.

    The serving layers tag every request-scoped span with the stable
    string ``request_id`` (router admit/route/failover/delivery, batcher
    queue wait, engine prefill chunks) or, for batched device steps that
    serve many requests at once (the decode step), a ``request_ids``
    list — both match here, so the returned chain is the request's full
    life including a mid-decode failover across replicas."""
    out = []
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        args = ev.get("args", {}) or {}
        if args.get("request_id") == request_id or (
                isinstance(args.get("request_ids"), (list, tuple))
                and request_id in args["request_ids"]):
            out.append(ev)
    out.sort(key=lambda e: float(e.get("ts", 0.0)))
    return out


# ------------------------------------------------------------------- stitch
def stitch(directory: str, trace_id: Optional[str] = None,
           out: Optional[str] = None) -> Optional[str]:
    """Merge every process's part-file for one trace into a single
    chrome-trace JSON; returns the merged path (None when no parts exist).

    ``trace_id=None`` merges the id the most parts carry (a trace-out dir
    normally holds exactly one launch). Part files are left in place —
    they remain individually loadable and a re-stitch stays possible.
    """
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return None
    parts: Dict[str, List[dict]] = {}
    for name in names:
        if not (name.startswith(_PART_PREFIX) and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name), encoding="utf-8") as f:
                doc = json.load(f)
            tid = doc.get("otherData", {}).get("trace_id", "")
            parts.setdefault(tid, []).append(doc)
        except (OSError, ValueError):
            continue  # torn/foreign file: skip, never fail the stitch
    if trace_id is None and parts:
        trace_id = max(parts, key=lambda t: len(parts[t]))
    docs = parts.get(trace_id or "", [])
    if not docs:
        return None
    events: List[dict] = []
    for doc in docs:
        events.extend(doc.get("traceEvents", []))
    merged = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"trace_id": trace_id, "n_parts": len(docs)},
    }
    out = out or os.path.join(directory, f"trace-{trace_id}.json")
    tmp = f"{out}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(merged, f)
    os.replace(tmp, out)
    return out
