"""Chaos injection seams: the ONE hook registry production code consults
(the port's copy of the JAX package's ``chaos/hooks.py``).

Every fault the chaos subsystem can inject enters the stack through a
**named seam** — a single ``hooks.fire(...)`` / ``hooks.apply(...)`` call
placed in the production module that owns the behavior (snapshot writes,
heartbeat transports, the train-step window, the serve engine, the obs
aggregator sweep). With no hook installed the seams are a dict lookup —
zero-cost and inert in production; with a plant installed (a
:class:`~autodist_tpu_torch.chaos.schedule.ChaosPlant`) they become
deterministic fault injectors.

Contract per seam style:

- ``apply(seam, value, **ctx) -> value`` — *filter* seams: the hook may
  transform or replace the value (poison a batch, drop a heartbeat
  payload by returning None, scale a straggler's quantiles). No hook ⇒
  the value passes through untouched.
- ``fire(seam, **ctx) -> result`` — *event* seams: the hook may RAISE the
  injected fault (an OSError for an unwritable snapshot dir, an engine
  death mid-decode) or
  return a directive the seam interprets (``"defer"`` for admission).
  No hook ⇒ returns None and nothing happens.

This module is deliberately stdlib-only (no jax, no package imports) so
every subsystem can import it without cycles or cost. Only ONE plant may
hold the registry at a time (:func:`install` enforces it) — overlapping
chaos schedules would make injection traces ambiguous.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "SEAM_AGG_SWEEP",
    "SEAM_HB_PUBLISH",
    "SEAM_HB_SWEEP",
    "SEAM_PILOT_REFIT",
    "SEAM_SERVE_ADMIT",
    "SEAM_SERVE_DRAFT",
    "SEAM_SERVE_PAGES",
    "SEAM_SERVE_STEP",
    "SEAM_SNAPSHOT_WRITE",
    "SEAM_SNAPSHOT_WRITTEN",
    "SEAM_TRAIN_BATCH",
    "SEAM_TRAIN_METRICS",
    "active",
    "apply",
    "clear",
    "fire",
    "install",
    "installed",
    "uninstall",
]

# Seam names are part of the chaos schedule format (the JAX package's
# docs/chaos.md), shared by both packages — keep them stable.
SEAM_TRAIN_BATCH = "kernel.train_step.batch"       # apply(batch)
SEAM_TRAIN_METRICS = "kernel.train_step.metrics"   # apply(metrics)
SEAM_SNAPSHOT_WRITE = "ft.snapshot.write"          # fire (may raise OSError)
SEAM_SNAPSHOT_WRITTEN = "ft.snapshot.written"      # fire (corrupts files)
SEAM_HB_PUBLISH = "ft.heartbeat.publish"           # apply(payload) -> None=drop
SEAM_HB_SWEEP = "ft.heartbeat.sweep"               # apply(board)
SEAM_AGG_SWEEP = "obs.aggregate.sweep"             # apply(fleet summaries)
SEAM_SERVE_ADMIT = "serve.engine.admit"            # fire -> "defer" | raise
SEAM_SERVE_STEP = "serve.engine.step"              # fire (may raise)
SEAM_SERVE_PAGES = "serve.pages.alloc"             # fire -> "exhaust"
SEAM_SERVE_DRAFT = "serve.spec.draft"              # fire -> "garbage"
SEAM_PILOT_REFIT = "pilot.calibrate.refit"         # apply(live records)

_lock = threading.Lock()
_hooks: Dict[str, Callable] = {}
_owner: Optional[object] = None


def active() -> bool:
    """Fast inertness check for hot paths (the train-step window)."""
    return bool(_hooks)


def installed() -> List[str]:
    with _lock:
        return sorted(_hooks)


def install(seam: str, fn: Callable, owner: Optional[object] = None) -> None:
    """Register ``fn`` on ``seam``. A second owner trying to install while
    another plant holds any seam is a harness bug — refused loudly."""
    global _owner
    with _lock:
        if _hooks and owner is not None and _owner is not None \
                and owner is not _owner:
            raise RuntimeError(
                "chaos hooks are already installed by another plant; "
                "remove it first (one schedule at a time)")
        if owner is not None:
            _owner = owner
        _hooks[seam] = fn


def uninstall(seam: str) -> None:
    with _lock:
        _hooks.pop(seam, None)


def clear(owner: Optional[object] = None) -> None:
    """Drop every hook (and the owner claim)."""
    global _owner
    with _lock:
        if owner is None or owner is _owner or not _hooks:
            _hooks.clear()
            _owner = None


def apply(seam: str, value: Any, **ctx: Any) -> Any:
    """Filter seam: run the hook over ``value`` (or pass it through)."""
    fn = _hooks.get(seam)
    if fn is None:
        return value
    return fn(value, **ctx)


def fire(seam: str, **ctx: Any) -> Any:
    """Event seam: invoke the hook (which may raise the injected fault);
    returns its directive, or None when no hook is installed."""
    fn = _hooks.get(seam)
    if fn is None:
        return None
    return fn(**ctx)
