"""Fault injection (the port's counterpart of the JAX package's ``chaos/``).

Only the seam registry is ported (:mod:`~autodist_tpu_torch.chaos.hooks`):
the snapshot writer, the heartbeat transports, the aggregator, serving and
the train step (``SEAM_TRAIN_BATCH``, ``SEAM_TRAIN_METRICS``) consult it,
inert without a hook. The harness, the fault catalog and the schedules (``ChaosPlant``,
``ChaosSchedule``, ``ChaosEvent``, ``CATALOG``, ``FaultSpec``) are not
ported yet: asking for one raises ``NotImplementedError`` (ROADMAP.md).
"""
from __future__ import annotations

from autodist_tpu_torch.chaos import hooks

__all__ = ["hooks"]

_NOT_PORTED = ("CATALOG", "ChaosEvent", "ChaosPlant", "ChaosSchedule", "FaultSpec",
               "harness", "faults", "schedule")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"autodist_tpu_torch.chaos.{name}: the chaos harness, faults and schedules "
            "are not ported yet (only the seam registry, chaos.hooks); see ROADMAP.md")
    raise AttributeError(name)
