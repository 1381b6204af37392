"""Declarative, seeded, replayable chaos schedules (PyTorch port of the
JAX package's ``chaos/schedule.py``).

A :class:`ChaosSchedule` is pure data — a seed plus a list of
:class:`ChaosEvent` rows ("at step N, inject fault F on host H, for K
steps") — serializable to canonical JSON so a chaos run is an artifact
you can attach to a bug report and replay. A :class:`ChaosPlant`
instantiates the schedule against the live stack: it installs the fault
catalog's hook closures (:func:`autodist_tpu_torch.chaos.faults.make_handlers`)
into the seam registry (:mod:`autodist_tpu_torch.chaos.hooks`), owns the seeded
RNG every injector draws from, and appends each injection to a **trace**
whose bytes are a pure function of (schedule, driven steps) — no wall
clock, no process ids, no ``Date.now``-style nondeterminism. Replaying
the same schedule over the same scenario yields byte-identical traces
(pinned by ``tests/test_torch_chaos_schedule.py``, byte for byte
against the JAX package's plant).

Step semantics are scenario-local: for training faults the plant's step
counter advances with each train window (the metrics seam); for
heartbeat/aggregator/serve scenarios the harness drives
:meth:`ChaosPlant.advance` at its own tick boundaries.
"""
from __future__ import annotations

import json
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from autodist_tpu_torch.chaos import hooks

__all__ = ["ChaosEvent", "ChaosSchedule", "ChaosPlant"]


@dataclass(frozen=True)
class ChaosEvent:
    """One scheduled injection window (``until_step`` exclusive; None =
    a single step)."""

    fault: str
    at_step: int = 0
    until_step: Optional[int] = None
    host: int = 0
    params: Tuple[Tuple[str, Any], ...] = ()

    @property
    def end_step(self) -> int:
        return self.at_step + 1 if self.until_step is None else self.until_step

    def active(self, step: int) -> bool:
        return self.at_step <= step < self.end_step

    def param(self, key: str, default: Any = None) -> Any:
        for k, v in self.params:
            if k == key:
                return v
        return default

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {"fault": self.fault, "at_step": self.at_step,
                             "host": self.host}
        if self.until_step is not None:
            d["until_step"] = self.until_step
        if self.params:
            d["params"] = {k: v for k, v in self.params}
        return d

    @staticmethod
    def from_dict(d: dict) -> "ChaosEvent":
        return ChaosEvent(
            fault=str(d["fault"]),
            at_step=int(d.get("at_step", 0)),
            until_step=(None if d.get("until_step") is None
                        else int(d["until_step"])),
            host=int(d.get("host", 0)),
            params=tuple(sorted((str(k), v) for k, v in
                                (d.get("params") or {}).items())),
        )


@dataclass(frozen=True)
class ChaosSchedule:
    """Seed + events. Unknown fault kinds are rejected at construction
    time (a typo'd schedule must not silently inject nothing)."""

    seed: int = 0
    events: Tuple[ChaosEvent, ...] = ()

    def __post_init__(self):
        from autodist_tpu_torch.chaos.faults import CATALOG

        unknown = sorted({e.fault for e in self.events} - set(CATALOG))
        if unknown:
            raise ValueError(
                f"unknown fault kind(s) {unknown}; catalog: "
                f"{sorted(CATALOG)}")

    def to_json(self) -> str:
        doc = {"seed": self.seed,
               "events": [e.to_dict() for e in self.events]}
        return json.dumps(doc, sort_keys=True, indent=2)

    @staticmethod
    def from_json(text: str) -> "ChaosSchedule":
        doc = json.loads(text)
        return ChaosSchedule(
            seed=int(doc.get("seed", 0)),
            events=tuple(ChaosEvent.from_dict(e)
                         for e in doc.get("events", [])))

    @staticmethod
    def from_file(path: str) -> "ChaosSchedule":
        with open(path, encoding="utf-8") as f:
            return ChaosSchedule.from_json(f.read())


class ChaosPlant:
    """A schedule armed against the live stack (context manager).

    ``install()`` registers the catalog's hook closures for every seam
    the schedule touches; ``remove()`` (or context exit) clears them. The
    injection trace accumulates one dict per injection —
    :meth:`trace_bytes` renders it as canonical JSONL, the replay-
    determinism artifact.
    """

    def __init__(self, schedule: ChaosSchedule):
        self.schedule = schedule
        self.rng = random.Random(schedule.seed)
        self.step = 0
        self.trace: List[Dict[str, Any]] = []
        self.state: Dict[Any, Any] = {}
        self._once: set = set()
        self._installed = False

    # ------------------------------------------------------------ lifecycle
    def install(self) -> "ChaosPlant":
        from autodist_tpu_torch.chaos.faults import make_handlers

        if self._installed:
            return self
        for seam, fn in make_handlers(self).items():
            hooks.install(seam, fn, owner=self)
        self._installed = True
        return self

    def remove(self) -> None:
        if self._installed:
            hooks.clear(owner=self)
            self._installed = False

    def __enter__(self) -> "ChaosPlant":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.remove()

    # ------------------------------------------------------------- stepping
    def advance(self, n: int = 1) -> int:
        self.step += int(n)
        return self.step

    # -------------------------------------------------------------- tracing
    def record(self, fault: str, **detail: Any) -> Dict[str, Any]:
        entry = {"i": len(self.trace), "step": self.step, "fault": fault,
                 **detail}
        self.trace.append(entry)
        return entry

    def record_once(self, key: Any, fault: str, **detail: Any) -> bool:
        """Record at most once per ``key`` (events whose hook fires from a
        scheduler thread record per-activation, keeping the trace
        independent of thread timing)."""
        if key in self._once:
            return False
        self._once.add(key)
        self.record(fault, **detail)
        return True

    def injected(self, fault: Optional[str] = None) -> int:
        return sum(1 for e in self.trace
                   if fault is None or e["fault"] == fault)

    def trace_lines(self) -> List[str]:
        return [json.dumps(e, sort_keys=True) for e in self.trace]

    def trace_bytes(self) -> bytes:
        return ("\n".join(self.trace_lines()) + "\n").encode("utf-8") \
            if self.trace else b""
