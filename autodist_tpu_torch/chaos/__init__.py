"""Deterministic fault injection (the port's counterpart of the JAX
package's ``chaos/``).

The seam registry (:mod:`~autodist_tpu_torch.chaos.hooks`) is consulted by
the snapshot writer, the heartbeat transports, the aggregator, serving,
the train step and the pilot's refit, inert without a hook. The seeded
schedules (:mod:`~autodist_tpu_torch.chaos.schedule`: ``ChaosEvent``,
``ChaosSchedule``, ``ChaosPlant``) and the fault catalog
(:mod:`~autodist_tpu_torch.chaos.faults`: ``CATALOG``, ``FaultSpec``) plant
faults through those seams. The soak harness and its CLI (``harness``,
``__main__``) are not ported yet: asking for either raises
``NotImplementedError`` (ROADMAP.md, Queue 1 item 6d).

This ``__init__`` stays import-light on purpose: production seams import
``chaos.hooks`` from hot paths, so nothing heavier may load here.
"""
from __future__ import annotations

from autodist_tpu_torch.chaos import hooks

__all__ = ["CATALOG", "ChaosEvent", "ChaosPlant", "ChaosSchedule",
           "FaultSpec", "hooks"]


def __getattr__(name):
    if name in ("ChaosEvent", "ChaosPlant", "ChaosSchedule"):
        from autodist_tpu_torch.chaos import schedule

        return getattr(schedule, name)
    if name in ("CATALOG", "FaultSpec"):
        from autodist_tpu_torch.chaos import faults

        return getattr(faults, name)
    if name in ("harness", "__main__"):
        raise NotImplementedError(
            f"autodist_tpu_torch.chaos.{name}: the chaos soak harness and its CLI are not "
            "ported yet (ROADMAP.md, Queue 1 item 6d)")
    raise AttributeError(name)
