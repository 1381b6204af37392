"""PilotState: the ONE versioned knob set the autopilot deploys (PyTorch
port of the JAX package's ``pilot/state.py``; the same knobs and JSON, so
a state file reads the same in both packages).

Every knob the controller can turn lives here — the deployed plan id and
its latency-hiding genes on the train side (``plan_id``, ``bucket_bytes``,
``xla_flag_set``: the JAX package's compiler flag-set name, kept as a
name; what a flag set means on the card waits for a benchmark), the
serving knobs on the serve side (``spec_k``,
``prefill_chunk``, ``n_pages``). A knob change is a NEW state (monotone
``version``); rollback re-deploys a prior state object bit-exactly, so
"restore the last-good knobs" is value equality, never a best-effort
diff.

:class:`PilotStateStore` persists the deployed state to one fsync'd file
with an atomic tmp+rename write: a rollout reader (an engine factory
inside the router's ``rolling_upgrade()``, the elastic rebuild closure)
always observes either the complete old state or the complete new state —
never a torn mix. That atomicity is what makes a controller death
mid-rollout recoverable to a consistent fleet (``Controller.recover``).

Nothing in ``autodist_tpu_torch/`` outside ``pilot/`` constructs a
:class:`PilotState` or writes the decision journal: the autopilot is the
ONE actuator that writes plan/serve knobs.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, replace
from typing import Any, Dict, Optional

# The knob names with_knobs() accepts — everything else on the dataclass
# (version) is controller-owned bookkeeping.
KNOBS = ("plan_id", "bucket_bytes", "xla_flag_set", "spec_k",
         "prefill_chunk", "n_pages")


@dataclass(frozen=True)
class PilotState:
    """One deployed knob set. Frozen: a change is a new version."""

    version: int = 0
    # -- train/plan knobs
    plan_id: str = ""        # content id of the deployed strategy artifact
    bucket_bytes: int = 0    # backward-overlap bucket gene (0 = unbucketed)
    xla_flag_set: str = ""   # flag-set name ("" = none pinned)
    # -- serve knobs
    spec_k: int = 4          # speculative-decode draft length
    prefill_chunk: int = 0   # chunked-prefill size (0 = engine default)
    n_pages: int = 0         # KV page-pool size (0 = engine default)

    def knobs(self) -> Dict[str, Any]:
        d = asdict(self)
        d.pop("version")
        return d

    def with_knobs(self, **updates: Any) -> "PilotState":
        """A new state at ``version + 1`` with the named knobs changed.
        Unknown knob names are refused loudly — a typo'd action must not
        silently deploy a no-op."""
        unknown = sorted(set(updates) - set(KNOBS))
        if unknown:
            raise ValueError(f"unknown pilot knob(s): {unknown}")
        return replace(self, version=self.version + 1, **updates)

    def to_json(self) -> Dict[str, Any]:
        return dict(asdict(self))

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "PilotState":
        return cls(
            version=int(d.get("version", 0)),
            plan_id=str(d.get("plan_id", "")),
            bucket_bytes=int(d.get("bucket_bytes", 0)),
            xla_flag_set=str(d.get("xla_flag_set", "")),
            spec_k=int(d.get("spec_k", 4)),
            prefill_chunk=int(d.get("prefill_chunk", 0)),
            n_pages=int(d.get("n_pages", 0)),
        )


class PilotStateStore:
    """The deployed-state file rollout paths read.

    One JSON document, written atomically (tmp + fsync + rename + dir
    fsync). Readers inside a rolling upgrade see old-or-new, never a torn
    mix — the store is the consistency point the "never mixed" contract
    hangs off.
    """

    def __init__(self, path: str):
        self.path = path

    def save(self, state: PilotState) -> str:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = f"{self.path}.tmp-{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(state.to_json(), f, indent=2, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        try:
            dfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # non-POSIX dir fsync: the rename is still atomic
        return self.path

    def load(self) -> Optional[PilotState]:
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                return PilotState.from_json(json.load(f))
        except (OSError, ValueError, KeyError, TypeError):
            return None
