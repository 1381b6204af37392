"""pilot: the feedback-directed control plane (PyTorch port of the JAX
package's ``pilot/``).

Closes planned -> priced -> measured -> replan in production: the
:class:`Controller` subscribes to the obs sensor surfaces (sentry
findings, SLO burn rates + acceptance buckets, measured-wire drift,
flight-record replay), maps them through a declarative
:class:`PolicyTable`, and deploys knob changes ONLY through guarded
rollout paths (train: drain -> ``ft/elastic.recompile_on`` rebuild;
serve: the router's ``rolling_upgrade()``) with a canary window,
automatic rollback to the last-good :class:`PilotState`, an append-only
fsync'd decision journal the doctor stitches into its timeline, and
episode/cooldown/rate guards so the controller can never flap.

This package is the ONE actuator over plan/serve knobs. ``python -m
autodist_tpu_torch.pilot --selftest [--device cuda|cpu]`` is the
closed-loop proof. Decisions, states, plan ids and journals equal the
JAX package's on the same inputs.
"""
from autodist_tpu_torch.pilot.actions import (
    ActionResult,
    PilotContext,
    build_actions,
    load_plan_artifact,
    save_plan_artifact,
)
from autodist_tpu_torch.pilot.controller import Controller, ControllerConfig
from autodist_tpu_torch.pilot.journal import (
    DecisionJournal,
    DecisionRecord,
    decisions_path,
    latest_decisions,
    pilot_dir,
    read_decisions,
)
from autodist_tpu_torch.pilot.policy import (
    PolicyRule,
    PolicyTable,
    Trigger,
    default_policy_table,
)
from autodist_tpu_torch.pilot.rollout import (
    FunctionRollout,
    Rollout,
    ServeRollout,
    TrainRollout,
)
from autodist_tpu_torch.pilot.state import KNOBS, PilotState, PilotStateStore

__all__ = [
    "ActionResult",
    "Controller",
    "ControllerConfig",
    "DecisionJournal",
    "DecisionRecord",
    "FunctionRollout",
    "KNOBS",
    "PilotContext",
    "PilotState",
    "PilotStateStore",
    "PolicyRule",
    "PolicyTable",
    "Rollout",
    "ServeRollout",
    "TrainRollout",
    "Trigger",
    "build_actions",
    "decisions_path",
    "default_policy_table",
    "latest_decisions",
    "load_plan_artifact",
    "pilot_dir",
    "read_decisions",
    "save_plan_artifact",
]
