"""Postmortem doctor: stitch a dead run's artifacts into one timeline and
classify the death (PyTorch port of ``obs/doctor.py``).

``python -m autodist_tpu_torch.obs doctor <ft-base-dir>`` reads everything
a run leaves behind, in the JAX package's formats, which the port's writers
keep: flight-record segments (``flight/``, ``obs/recorder.py``), heartbeat
files (``heartbeats/``, ``ft/heartbeat.py``), snapshot MANIFESTs
(``snapshots/``, ``ft/snapshot.py``), the launcher's doctor bundles
(``doctor/``, written by the hang watchdog before it kills a silent fleet,
``runtime/launcher.py``), span part-files (``<base>/traces`` or the
``--trace-out`` dir, ``obs/spans.py``) and an autopilot decision journal
(``pilot/decisions.jsonl``) where one is present. It merges them into a
time-ordered timeline and returns a **verdict** with the evidence lines
that support it, the JAX doctor's verdict for verdict:

======== =============== =================================================
Code     Verdict         Typical cause
======== =============== =================================================
DOC000   clean           ``run_end ok`` recorded; nothing anomalous after
DOC001   nan             sentry SNT001/SNT002, or non-finite loss in tail
DOC002   oom             error event matching RESOURCE_EXHAUSTED / OOM
DOC003   wedge           hang bundle, or heartbeats+records stop
                         mid-stream with no terminal event
DOC004   preemption      SIGTERM preempt event (ft snapshot hook)
DOC005   straggler       hang/abnormal end with SNT006 straggler findings
DOC006   crash           error event that matches no narrower class
DOC007   pool_exhaustion serve died amid KV page-pool pressure
DOC008   failover_storm  repeated replica DEAD transitions on an abnormal end
DOC999   unknown         not enough evidence to classify
======== =============== =================================================

Classification is precedence-ordered (strongest causal evidence first):
oom > nan > pool-exhaustion (typed pool-exhausted error) > failover-storm
> hang-bundle (straggler when SNT006 rode along, wedge otherwise) >
preemption > crash > straggler > clean > abrupt-end wedge (pool-exhaustion
when the stream dies inside a pressure window) > unknown. The module never
raises on malformed artifacts (a postmortem reads exactly the files a crash
tore) and needs no device. The CUDA allocator's "CUDA out of memory"
matches the OOM signature.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from autodist_tpu_torch.obs.recorder import flight_dir, read_records
from autodist_tpu_torch.utils import logging

__all__ = ["Diagnosis", "Evidence", "VERDICT_CODES", "diagnose",
           "render_text", "run_cli"]

#: verdict -> stable greppable code (the docs/observability.md table).
VERDICT_CODES: Dict[str, str] = {
    "clean": "DOC000",
    "nan": "DOC001",
    "oom": "DOC002",
    "wedge": "DOC003",
    "preemption": "DOC004",
    "straggler": "DOC005",
    "crash": "DOC006",
    "pool_exhaustion": "DOC007",
    "failover_storm": "DOC008",
    "unknown": "DOC999",
}

_OOM_RE = re.compile(
    r"RESOURCE[_ ]EXHAUSTED|out of memory|\bOOM\b|allocat\w* failed",
    re.IGNORECASE)
# DOC007: the page-pool-exhausted signature the serve admission path and
# the batcher's pressure/shed events carry (serve/engine.py prose).
# Deliberately narrow — an error merely MENTIONING the pool (accounting
# bug, double free) is a crash, not an exhaustion collapse.
_POOL_RE = re.compile(r"page.pool exhausted|pool exhaust", re.IGNORECASE)
# DOC008 threshold: a storm needs REPEATED death/flap, RECENTLY. Reroute
# count is deliberately NOT a trigger — ONE supervised kill reroutes
# every in-flight request (the chaos replica_death class must stay
# DOC006) — and deaths outside the storm window are history, not the
# cause of THIS death: two recovered single failovers days apart must
# not reclassify a later preemption or crash as a storm.
_STORM_DEAD_TRANSITIONS = 2
_STORM_WINDOW_S = 600.0

# ft directory layout (FTConfig.resolved's literals, mirrored here so the
# doctor reads a base dir without importing ft/).
_HEARTBEAT_SUBDIR = "heartbeats"
_SNAPSHOT_SUBDIR = "snapshots"
_BUNDLE_SUBDIR = "doctor"
_TRACE_SUBDIR = "traces"


@dataclass
class Evidence:
    """One artifact line supporting the verdict."""

    source: str        # flight | heartbeat | snapshot | bundle | span
    t: float
    detail: str

    def to_dict(self) -> dict:
        return {"source": self.source, "t": self.t, "detail": self.detail}


@dataclass
class Diagnosis:
    verdict: str
    code: str
    evidence: List[Evidence] = field(default_factory=list)
    timeline: List[Dict[str, Any]] = field(default_factory=list)
    stats: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self, timeline_tail: int = 40) -> dict:
        return {
            "verdict": self.verdict,
            "code": self.code,
            "evidence": [e.to_dict() for e in self.evidence[:16]],
            "stats": self.stats,
            "timeline_tail": self.timeline[-timeline_tail:],
        }


# ----------------------------------------------------------------- readers
def _read_json(path: str) -> Optional[dict]:
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


def _read_heartbeats(hb_dir: str) -> List[Dict[str, Any]]:
    out = []
    try:
        names = sorted(os.listdir(hb_dir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("hb-") and name.endswith(".json")):
            continue
        doc = _read_json(os.path.join(hb_dir, name))
        if doc is None:
            continue
        try:
            pid = int(name[3:-5])
        except ValueError:
            continue
        out.append({"t": float(doc.get("time", 0.0)), "source": "heartbeat",
                    "kind": "heartbeat", "process_id": pid,
                    "step": doc.get("step")})
    return out


def _read_snapshots(snap_dir: str) -> List[Dict[str, Any]]:
    out = []
    try:
        names = sorted(os.listdir(snap_dir))
    except OSError:
        return out
    for name in names:
        mpath = os.path.join(snap_dir, name, "MANIFEST.json")
        doc = _read_json(mpath)
        if doc is None:
            continue
        try:
            t = os.path.getmtime(mpath)
        except OSError:
            t = 0.0
        out.append({"t": t, "source": "snapshot", "kind": "snapshot_manifest",
                    "step": doc.get("step"), "dir": name})
    return out


def _read_bundles(bundle_dir: str) -> List[Dict[str, Any]]:
    out = []
    try:
        names = sorted(os.listdir(bundle_dir))
    except OSError:
        return out
    for name in names:
        if not name.endswith(".json"):
            continue
        doc = _read_json(os.path.join(bundle_dir, name))
        if doc is None:
            continue
        out.append({"t": float(doc.get("written_at", 0.0)), "source": "bundle",
                    "kind": doc.get("reason", "bundle"), "file": name,
                    "bundle": doc})
    return out


def _read_spans(trace_dir: str, limit: int = 200) -> List[Dict[str, Any]]:
    """Newest span events from chrome-trace part files (obs/spans.py) —
    context for the timeline, rarely verdict-deciding on their own."""
    out: List[Dict[str, Any]] = []
    try:
        names = sorted(os.listdir(trace_dir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("obs-part-") and name.endswith(".json")):
            continue
        doc = _read_json(os.path.join(trace_dir, name))
        if doc is None:
            continue
        for ev in doc.get("traceEvents", []):
            if ev.get("ph") != "X":
                continue
            out.append({
                "t": float(ev.get("ts", 0.0)) / 1e6, "source": "span",
                "kind": "span", "name": ev.get("name"),
                "dur_s": float(ev.get("dur", 0.0)) / 1e6,
                "process_id": ev.get("args", {}).get("process"),
            })
    out.sort(key=lambda e: e["t"])
    return out[-limit:]


def _read_pilot_decisions(base_dir: str) -> List[Dict[str, Any]]:
    """Autopilot decision journal (``<base>/pilot/decisions.jsonl``, which
    either package's ``pilot/journal.py`` writes) — every retune the
    controller attempted, with its trigger and canary verdict, so a
    postmortem reads knob changes next to the sentry findings that caused
    them. Read-only: the pilot package is the ONE writer; a torn line is
    skipped (``read_decisions``)."""
    from autodist_tpu_torch.pilot.journal import decisions_path, read_decisions

    out: List[Dict[str, Any]] = []
    for rec in read_decisions(decisions_path(base_dir)):
        entry: Dict[str, Any] = {
            "t": rec.t, "source": "pilot", "kind": "decision",
            "decision_id": rec.decision_id, "trigger": rec.trigger,
            "action": rec.action, "verdict": rec.verdict,
        }
        if rec.code:
            entry["code"] = rec.code
        if rec.note:
            entry["note"] = rec.note
        out.append(entry)
    return out


# ------------------------------------------------------------ classification
def diagnose(base_dir: str, trace_out: str = "",
             tail_steps: int = 16) -> Diagnosis:
    """Classify whatever died under ``base_dir`` (an ft base: the dir
    ``AUTODIST_FT_DIR`` pointed at). Missing subdirs are just absent
    evidence, never errors."""
    records = read_records(flight_dir(base_dir))
    flight = [{"source": "flight", **r} for r in records]
    heartbeats = _read_heartbeats(os.path.join(base_dir, _HEARTBEAT_SUBDIR))
    snapshots = _read_snapshots(os.path.join(base_dir, _SNAPSHOT_SUBDIR))
    bundles = _read_bundles(os.path.join(base_dir, _BUNDLE_SUBDIR))
    spans = _read_spans(trace_out or os.path.join(base_dir, _TRACE_SUBDIR))
    pilot = _read_pilot_decisions(base_dir)

    timeline = sorted(
        flight + heartbeats + snapshots + bundles + spans + pilot,
        key=lambda e: float(e.get("t", 0.0)))
    stats: Dict[str, Any] = {
        "flight_records": len(flight),
        "heartbeats": len(heartbeats),
        "snapshots": len(snapshots),
        "bundles": len(bundles),
        "spans": len(spans),
        "pilot_decisions": len(pilot),
    }
    steps = [r for r in records if r.get("kind") == "step"]
    if steps:
        stats["first_step_t"] = steps[0].get("t")
        stats["last_step_t"] = steps[-1].get("t")
    snap_steps = [s.get("step") for s in snapshots
                  if isinstance(s.get("step"), int)]
    if snap_steps:
        stats["last_snapshot_step"] = max(snap_steps)

    ev: List[Evidence] = []

    def _ev(source: str, t: Any, detail: str) -> Evidence:
        e = Evidence(source=source, t=float(t or 0.0), detail=detail)
        ev.append(e)
        return e

    def _done(verdict: str) -> Diagnosis:
        stats["verdict"] = verdict
        return Diagnosis(verdict=verdict, code=VERDICT_CODES[verdict],
                         evidence=ev, timeline=_compact(timeline),
                         stats=stats)

    # Gather the classifier's raw signals in one pass over the records.
    run_end = [r for r in records if r.get("kind") == "run_end"]
    errors = [r for r in records if r.get("kind") == "error"]
    preempts = [r for r in records if r.get("kind") == "preempt"]
    sentry = [r for r in records if r.get("kind") == "sentry"]
    nan_sentry = [r for r in sentry if r.get("code") in ("SNT001", "SNT002")]
    straggler_sentry = [r for r in sentry if r.get("code") == "SNT006"]
    hang_bundles = [b for b in bundles
                    if b.get("kind") in ("fleet_hung", "hang")]

    def _nonfinite(x) -> bool:
        if isinstance(x, str):
            return x.lower() in ("nan", "inf", "-inf", "infinity", "-infinity")
        try:
            import math
            return x is not None and not math.isfinite(float(x))
        except (TypeError, ValueError):
            return False

    nan_tail = [r for r in steps[-max(1, tail_steps):]
                if _nonfinite(r.get("loss")) or _nonfinite(r.get("grad_norm"))]

    # ---- precedence ladder (module docstring documents the order) -------
    oom_errors = [r for r in errors if _OOM_RE.search(str(r.get("error", "")))]
    if oom_errors:
        r = oom_errors[-1]
        _ev("flight", r.get("t"),
            f"error event matches OOM signature: {str(r.get('error'))[:200]}")
        return _done("oom")

    if nan_sentry or nan_tail:
        for r in nan_sentry[-3:]:
            _ev("flight", r.get("t"),
                f"sentry {r.get('code')}: {str(r.get('message'))[:160]}")
        for r in nan_tail[-3:]:
            _ev("flight", r.get("t"),
                f"step record carries non-finite loss={r.get('loss')!r}")
        return _done("nan")

    # Serving signals. Raw streams:
    pool_pressure = [r for r in records if r.get("kind") == "pool_pressure"]
    reroutes = [r for r in records if r.get("kind") == "reroute"]
    dead_transitions = [
        r for r in records if r.get("kind") == "replica_transition"
        and str(r.get("new", "")).lower() == "dead"]
    stats["reroutes"] = len(reroutes)
    stats["replica_dead_transitions"] = len(dead_transitions)
    stats["pool_pressure_windows"] = len(pool_pressure)
    clean_end = any(e.get("ok", True) for e in run_end)

    # DOC007 (typed form): the death itself carries the pool-exhausted
    # signature — the pool, not the code path that tripped over it, is
    # the limiter a postmortem should name.
    pool_errors = [r for r in errors
                   if _POOL_RE.search(str(r.get("error", "")))]
    if pool_errors:
        r = pool_errors[-1]
        _ev("flight", r.get("t"),
            f"error event carries the page-pool-exhausted signature: "
            f"{str(r.get('error'))[:200]}")
        for p in pool_pressure[-3:]:
            _ev("flight", p.get("t"),
                f"pool_pressure window: {str(p.get('reason'))[:120]} "
                f"(free_pages={p.get('free_pages')})")
        return _done("pool_exhaustion")

    # DOC008: repeated replica flap on an abnormal end, inside the storm
    # window ending at the last record. One supervised kill with its
    # orderly failover stays crash (DOC006) — however many in-flight
    # requests it rerouted — and old recovered deaths are history.
    last_record_t = float(records[-1].get("t", 0.0)) if records else 0.0
    recent_dead = [r for r in dead_transitions
                   if last_record_t - float(r.get("t", 0.0))
                   <= _STORM_WINDOW_S]
    if not clean_end and len(recent_dead) >= _STORM_DEAD_TRANSITIONS:
        for r in recent_dead[-3:]:
            _ev("flight", r.get("t"),
                f"replica {r.get('replica')} transitioned "
                f"{r.get('old')} -> dead")
        for r in reroutes[-3:]:
            _ev("flight", r.get("t"),
                f"reroute of {r.get('request_id')} after "
                f"{r.get('delivered')} delivered token(s): "
                f"{str(r.get('reason'))[:120]}")
        _ev("flight", recent_dead[-1].get("t"),
            f"failover storm: {len(recent_dead)} DEAD transition(s) inside "
            f"the {_STORM_WINDOW_S:.0f}s window, {len(reroutes)} "
            f"reroute(s), no clean run_end")
        return _done("failover_storm")

    if hang_bundles:
        b = hang_bundles[-1]
        _ev("bundle", b.get("t"),
            f"launcher hang watchdog bundle {b.get('file')}: fleet "
            f"heartbeats went silent (verdict "
            f"{b['bundle'].get('verdict', '?')})")
        for pid, peer in (b["bundle"].get("heartbeats") or {}).items():
            _ev("bundle", peer.get("last_seen", 0.0),
                f"host {pid}: state={peer.get('state')} last beat at "
                f"t={peer.get('last_seen')}")
        if straggler_sentry:
            for r in straggler_sentry[-3:]:
                _ev("flight", r.get("t"),
                    f"sentry SNT006: {str(r.get('message'))[:160]}")
            return _done("straggler")
        return _done("wedge")

    if preempts:
        r = preempts[-1]
        _ev("flight", r.get("t"),
            f"preemption event (SIGTERM snapshot hook), step "
            f"{r.get('step', '?')}")
        return _done("preemption")

    if errors:
        r = errors[-1]
        _ev("flight", r.get("t"),
            f"error event: {str(r.get('error'))[:200]}")
        return _done("crash")

    if straggler_sentry and not clean_end:
        for r in straggler_sentry[-3:]:
            _ev("flight", r.get("t"),
                f"sentry SNT006: {str(r.get('message'))[:160]}")
        return _done("straggler")

    if clean_end:
        r = run_end[-1]
        _ev("flight", r.get("t"), "run_end event recorded (ok=true)")
        return _done("clean")

    if steps or heartbeats:
        # Records exist but simply stop: nothing wrote a terminal event —
        # the signature of a wedge (or an unattributed SIGKILL, which is
        # operationally the same thing: a silent death). A stream that
        # dies INSIDE a page-pool pressure window is the silent form of a
        # pool-exhaustion collapse: name the pool, not "wedge".
        if pool_pressure and records:
            last_t = float(records[-1].get("t", 0.0))
            tail_pressure = [p for p in pool_pressure
                             if last_t - float(p.get("t", 0.0)) <= 30.0]
            if tail_pressure:
                p = tail_pressure[-1]
                _ev("flight", p.get("t"),
                    f"records end abruptly inside a pool_pressure window: "
                    f"{str(p.get('reason'))[:120]} "
                    f"(free_pages={p.get('free_pages')}, "
                    f"queue_depth={p.get('queue_depth')})")
                return _done("pool_exhaustion")
        if steps:
            r = steps[-1]
            _ev("flight", r.get("t"),
                f"flight records end abruptly at t={r.get('t')} with no "
                f"terminal event (last loss={r.get('loss')})")
        for hb in heartbeats[-3:]:
            _ev("heartbeat", hb.get("t"),
                f"host {hb.get('process_id')} last beat at t={hb.get('t')} "
                f"(step {hb.get('step')})")
        return _done("wedge")

    _ev("flight", 0.0, f"no artifacts found under {base_dir}")
    return _done("unknown")


def _compact(timeline: List[Dict[str, Any]],
             max_entries: int = 400) -> List[Dict[str, Any]]:
    """Bound the timeline: keep the head and tail, drop dense middles
    (step records dominate; the interesting part of a postmortem is the
    beginning and the end)."""
    if len(timeline) <= max_entries:
        return timeline
    head = timeline[: max_entries // 4]
    tail = timeline[-(max_entries - len(head)):]
    return head + [{"kind": "elided",
                    "n": len(timeline) - len(head) - len(tail)}] + tail


# --------------------------------------------------------------------- CLI
def render_text(diag: Diagnosis) -> str:
    lines = [f"verdict: {diag.verdict} [{diag.code}]"]
    for k in sorted(diag.stats):
        lines.append(f"  {k}: {diag.stats[k]}")
    lines.append("evidence:")
    if not diag.evidence:
        lines.append("  (none)")
    for e in diag.evidence:
        lines.append(f"  [{e.source} t={e.t:.3f}] {e.detail}")
    return "\n".join(lines)


def run_cli(base_dir: str, as_json: bool = False,
            trace_out: str = "") -> int:
    """The ``python -m autodist_tpu_torch.obs doctor`` body. Exit code 0 for
    clean, 3 for unknown (no evidence), 1 for every classified failure."""
    try:
        diag = diagnose(base_dir, trace_out=trace_out)
    except Exception as e:  # noqa: BLE001 - a postmortem must not crash
        logging.warning("doctor failed over %s", base_dir, exc_info=True)
        if as_json:
            print(json.dumps({"verdict": "unknown",
                              "code": VERDICT_CODES["unknown"],
                              "error": f"{type(e).__name__}: {e}"}))
        else:
            print(f"doctor failed: {type(e).__name__}: {e}")
        return 3
    if as_json:
        print(json.dumps(diag.to_dict(), default=str))
    else:
        print(render_text(diag))
    if diag.verdict == "clean":
        return 0
    return 3 if diag.verdict == "unknown" else 1
