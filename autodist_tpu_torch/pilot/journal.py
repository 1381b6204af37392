"""Append-only fsync'd decision journal: every autopilot decision, forever
(PyTorch port of the JAX package's ``pilot/journal.py``: the same lines,
so either package reads the other's journal).

One JSONL file under ``<base>/pilot/decisions.jsonl`` (deliberately NOT
the flight-record dir or the ``flight-`` naming — ``obs/recorder.py`` is
the ONE flight writer; the pilot journal is its own crash-safe artifact
with the same discipline: append, flush, fsync, torn-tail tolerance on
read).

A decision's life is a sequence of journal lines sharing one
``decision_id``: the ``pending`` line lands BEFORE any knob is deployed
(the write-ahead intent that makes a controller death mid-rollout
recoverable), then exactly one terminal line — ``committed``,
``rolled_back`` or ``rejected`` — with the measured canary delta.
:func:`read_decisions` returns the raw lines; :func:`latest_decisions`
folds them to the newest record per id, so "is anything still pending?"
is one dict scan.

``python -m autodist_tpu_torch.obs doctor <base>`` (and the JAX
package's doctor) stitches these records into
its timeline (source ``pilot``) so a postmortem reads retunes next to the
sentry findings that triggered them.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

# Terminal verdicts (PENDING is the write-ahead intent, never terminal).
VERDICT_PENDING = "pending"
VERDICT_COMMITTED = "committed"
VERDICT_ROLLED_BACK = "rolled_back"
VERDICT_REJECTED = "rejected"

PILOT_SUBDIR = "pilot"
DECISIONS_FILE = "decisions.jsonl"


def pilot_dir(base_dir: Optional[str] = None) -> str:
    """The pilot's artifact dir: ``AUTODIST_PILOT_DIR`` if exported (the
    launcher sets it next to ``AUTODIST_FT_DIR``), else ``<base>/pilot``."""
    from autodist_tpu_torch.const import DEFAULT_WORKING_DIR, ENV

    if base_dir:
        return os.path.join(base_dir, PILOT_SUBDIR)
    env = str(ENV.AUTODIST_PILOT_DIR.val or "")
    if env:
        return env
    ft = str(ENV.AUTODIST_FT_DIR.val or "") or DEFAULT_WORKING_DIR
    return os.path.join(ft, PILOT_SUBDIR)


def decisions_path(base_dir: Optional[str] = None) -> str:
    return os.path.join(pilot_dir(base_dir), DECISIONS_FILE)


@dataclass
class DecisionRecord:
    """One journal line: trigger evidence -> chosen action -> verdict."""

    decision_id: str
    trigger: str                 # policy trigger class (e.g. "wire_drift")
    code: str = ""               # the concrete code that fired (SNT004, ...)
    action: str = ""             # policy action name (e.g. "refit_replan")
    verdict: str = VERDICT_PENDING
    t: float = 0.0               # wall time (time.time) of THIS line
    evidence: Dict[str, Any] = field(default_factory=dict)
    knobs_before: Dict[str, Any] = field(default_factory=dict)  # full state
    knobs_after: Dict[str, Any] = field(default_factory=dict)   # full state
    expected: Dict[str, Any] = field(default_factory=dict)   # action's claim
    measured: Dict[str, Any] = field(default_factory=dict)   # canary's answer
    note: str = ""

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "decision_id": self.decision_id, "trigger": self.trigger,
            "verdict": self.verdict, "t": self.t,
        }
        for k in ("code", "action", "note"):
            if getattr(self, k):
                d[k] = getattr(self, k)
        for k in ("evidence", "knobs_before", "knobs_after", "expected",
                  "measured"):
            if getattr(self, k):
                d[k] = dict(getattr(self, k))
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "DecisionRecord":
        return cls(
            decision_id=str(d["decision_id"]),
            trigger=str(d.get("trigger", "")),
            code=str(d.get("code", "")),
            action=str(d.get("action", "")),
            verdict=str(d.get("verdict", VERDICT_PENDING)),
            t=float(d.get("t", 0.0)),
            evidence=dict(d.get("evidence") or {}),
            knobs_before=dict(d.get("knobs_before") or {}),
            knobs_after=dict(d.get("knobs_after") or {}),
            expected=dict(d.get("expected") or {}),
            measured=dict(d.get("measured") or {}),
            note=str(d.get("note", "")),
        )


class DecisionJournal:
    """Append-only writer. Every append lands with flush + fsync before
    the call returns — a decision the controller acted on is on disk even
    if the controller dies on the next instruction."""

    def __init__(self, path: str, now=time.time):
        self.path = path
        self._now = now
        self._seq = 0

    def next_id(self) -> str:
        self._seq += 1
        return f"d{os.getpid()}-{self._seq}"

    def append(self, record: DecisionRecord) -> DecisionRecord:
        if not record.t:
            record.t = float(self._now())
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        line = json.dumps(record.to_json(), sort_keys=True, default=float)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
        return record

    def read(self) -> List[DecisionRecord]:
        return read_decisions(self.path)


def read_decisions(path: str) -> List[DecisionRecord]:
    """Every journal line in append order; a torn tail (crash mid-append)
    is skipped, never fatal."""
    out: List[DecisionRecord] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for raw in f:
                raw = raw.strip()
                if not raw:
                    continue
                try:
                    out.append(DecisionRecord.from_json(json.loads(raw)))
                except (ValueError, KeyError, TypeError):
                    continue  # torn/garbled line: tolerate, keep reading
    except OSError:
        return []
    return out


def latest_decisions(path: str) -> Dict[str, DecisionRecord]:
    """Newest record per decision_id, in first-seen order — the view that
    answers "which decisions are still pending?" after a crash."""
    latest: Dict[str, DecisionRecord] = {}
    for rec in read_decisions(path):
        latest[rec.decision_id] = rec
    return latest
