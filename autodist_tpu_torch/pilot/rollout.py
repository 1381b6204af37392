"""Guarded rollout paths: the ONLY ways a knob change reaches a fleet
(PyTorch port of the JAX package's ``pilot/rollout.py``).

Both paths share one shape the controller drives (``apply`` /
``canary``): persist the new :class:`~autodist_tpu_torch.pilot.state.PilotState`
to the store FIRST (atomic old-or-new file), then rebuild through the
subsystem's own zero-drop machinery —

- **train**: drain the step loop, then an ``ft/elastic.py``
  ``recompile_on`` rebuild whose strategy/knobs come from the store
  (the same drain -> rebuild path an elastic resize takes);
- **serve**: the router's ``rolling_upgrade()`` — each replica drains,
  fails its leftovers over through the journal, and restarts via its
  engine factory, which reads the store at build time. Zero dropped
  requests is the router's own contract; the pilot only changes WHAT the
  factory builds.

``canary(n)`` returns a dict of **lower-is-better** measured metrics
(seconds-like costs). The controller compares post-apply canary metrics
against the pre-apply baseline and rolls back (a second ``apply`` of the
old state) when any shared metric regresses beyond the configured
fraction — rollback is the same guarded path, not a special case.

The concrete drain/rebuild/measure closures are injected: the selftest
and ``chip_smoke.py``'s ``pilot`` phase wire real
``ft.elastic.recompile_on`` and a real router fleet; unit tests wire
fakes. The rollout classes own only the ordering and the
store write — the part the consistency story depends on.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

from autodist_tpu_torch.pilot.state import PilotState, PilotStateStore


class Rollout:
    """Base contract. ``apply`` deploys a state; ``canary`` measures."""

    def apply(self, old: PilotState, new: PilotState) -> None:
        raise NotImplementedError

    def canary(self, n: int) -> Dict[str, float]:
        raise NotImplementedError


class FunctionRollout(Rollout):
    """Rollout from plain callables — the unit-test / custom-path shim."""

    def __init__(self, apply_fn: Callable[[PilotState, PilotState], None],
                 canary_fn: Callable[[int], Dict[str, float]]):
        self._apply = apply_fn
        self._canary = canary_fn

    def apply(self, old: PilotState, new: PilotState) -> None:
        self._apply(old, new)

    def canary(self, n: int) -> Dict[str, float]:
        return dict(self._canary(n))


class TrainRollout(Rollout):
    """drain -> store write -> elastic rebuild.

    ``drain_fn()`` quiesces the step loop (the trainer finishes its
    in-flight step and parks); ``rebuild_fn(state)`` performs the
    ``ft/elastic.py`` recompile against the knobs/strategy the state
    names and swaps the compiled step in; ``canary_fn(n)`` measures n
    canary steps of whatever is deployed.
    """

    def __init__(self, store: PilotStateStore,
                 drain_fn: Callable[[], None],
                 rebuild_fn: Callable[[PilotState], None],
                 canary_fn: Callable[[int], Dict[str, float]]):
        self.store = store
        self._drain = drain_fn
        self._rebuild = rebuild_fn
        self._canary = canary_fn

    def apply(self, old: PilotState, new: PilotState) -> None:
        self._drain()
        # Store before rebuild: a death between the two leaves a pending
        # journal entry + a store the recovery path simply re-applies.
        self.store.save(new)
        self._rebuild(new)

    def canary(self, n: int) -> Dict[str, float]:
        return dict(self._canary(n))


class ServeRollout(Rollout):
    """store write -> router ``rolling_upgrade()``.

    The router drains each replica in turn (leftovers fail over through
    the journal — zero drops is ITS contract), restarts it via the
    engine factory, and waits READY. The factory reads the store, so the
    restarted replica comes up on the new knobs; replicas not yet cycled
    still run the complete old state — old or new per replica, never a
    torn mix, and ``Controller.recover`` finishes or rolls back a cycle
    a dead controller left half-done.
    """

    def __init__(self, store: PilotStateStore, router,
                 canary_fn: Callable[[int], Dict[str, float]],
                 deadline_s: Optional[float] = None,
                 ready_timeout_s: Optional[float] = None):
        self.store = store
        self.router = router
        self._canary = canary_fn
        self._deadline_s = deadline_s
        self._ready_timeout_s = ready_timeout_s
        # The newest rolling_upgrade()'s per-replica summaries (drain and
        # restart seconds included).
        self.last_upgrade: Optional[list] = None

    def apply(self, old: PilotState, new: PilotState) -> None:
        self.store.save(new)
        self.last_upgrade = self.router.rolling_upgrade(
            deadline_s=self._deadline_s, ready_timeout_s=self._ready_timeout_s)

    def canary(self, n: int) -> Dict[str, float]:
        return dict(self._canary(n))
