"""The declarative trigger -> action policy table (PyTorch port of the JAX
package's ``pilot/policy.py``: the same rules, codes, actions and
descriptions, so ``PolicyTable.describe()`` reads the same in both).

A :class:`PolicyRule` binds a **trigger class** (named after what went
wrong) to the **codes** that evidence it (sentry ``SNT###``, shardlint
``SLT###``, or a pilot-synthesized code like ``wire_drift``) and the ONE
**action** the controller runs per episode. The table is data, not code:
the doctor can explain any journal line from it, and tests enumerate it
to prove each trigger class fires exactly its action.

The default table:

====================  ==========================  ====================
trigger class         evidence codes              action
====================  ==========================  ====================
wire_drift            SLT001-003, wire_drift      refit_replan
step_time_regression  SNT004                      tune_bucket_bytes
hbm_regression        SNT005                      tune_xla_flags
serve_latency         SNT007, SNT008              tune_serve_latency
slo_burn              SNT009, burn_rate           tune_pool
acceptance_drift      acceptance_drift            tune_spec_k
====================  ==========================  ====================

Together ``step_time_regression`` + ``hbm_regression`` cover the
latency-hiding pair (bucket size and the flag set): a step-time regression
retunes the overlap bucket under the live calibration; an HBM regression
swaps the flag set, where an UNMEASURED flag-set document is only ever a
source of tuning candidates behind a canary — never a trusted baseline.
The flag sets keep the JAX package's names (the rule's description
included); the port reads no TPU measurement as the card's, and what a
flag set would change on the card waits for a benchmark.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

ACTIONS = ("refit_replan", "tune_bucket_bytes", "tune_xla_flags",
           "tune_serve_latency", "tune_pool", "tune_spec_k")


@dataclass(frozen=True)
class PolicyRule:
    """One trigger class: the codes that evidence it, the one action."""

    trigger: str
    codes: Tuple[str, ...]
    action: str
    description: str = ""
    # None = the controller's default cooldown; a per-rule override lets
    # slow loops (a full re-search) cool longer than a knob nudge.
    cooldown_s: Optional[float] = None
    canary: bool = True  # guarded rollout with canary/rollback


class PolicyTable:
    """Code -> rule lookup over an ordered rule list."""

    def __init__(self, rules: List[PolicyRule]):
        self.rules = list(rules)
        self._by_code: Dict[str, PolicyRule] = {}
        self._by_trigger: Dict[str, PolicyRule] = {}
        for r in self.rules:
            if r.trigger in self._by_trigger:
                raise ValueError(f"duplicate trigger class: {r.trigger}")
            self._by_trigger[r.trigger] = r
            for c in r.codes:
                if c in self._by_code:
                    raise ValueError(
                        f"code {c} claimed by two triggers "
                        f"({self._by_code[c].trigger} and {r.trigger})")
                self._by_code[c] = r

    def rule_for_code(self, code: str) -> Optional[PolicyRule]:
        return self._by_code.get(code)

    def rule_for_trigger(self, trigger: str) -> Optional[PolicyRule]:
        return self._by_trigger.get(trigger)

    def describe(self) -> List[Dict]:
        return [{
            "trigger": r.trigger, "codes": list(r.codes),
            "action": r.action, "canary": r.canary,
            "cooldown_s": r.cooldown_s, "description": r.description,
        } for r in self.rules]


def default_policy_table() -> PolicyTable:
    """The production matrix (module docstring table)."""
    return PolicyTable([
        PolicyRule(
            "wire_drift", ("SLT001", "SLT002", "SLT003", "wire_drift"),
            "refit_replan",
            "measured wire diverged from priced beyond the drift bound: "
            "refit plan/calibrate.py from live flight+attrib records and "
            "re-search the plan under the new calibration (shardlint/"
            "schedlint screening rides inside PlanSearch)"),
        PolicyRule(
            "step_time_regression", ("SNT004",), "tune_bucket_bytes",
            "sustained step-time regression: re-pick the backward-overlap "
            "bucket_bytes gene by priced cost under the live calibration"),
        PolicyRule(
            "hbm_regression", ("SNT005",), "tune_xla_flags",
            "HBM high-water creep: A/B the xla_flag_ab.py flag set "
            "(scoped VMEM / fusion pressure); unmeasured sets are canary "
            "candidates, never baselines"),
        PolicyRule(
            "serve_latency", ("SNT007", "SNT008"), "tune_serve_latency",
            "TTFT (SNT007) / ITL (SNT008) degradation: shrink the prefill "
            "chunk or the speculative k"),
        PolicyRule(
            "slo_burn", ("SNT009", "burn_rate"), "tune_pool",
            "queue-wait blowup or error-budget burn: grow the KV page "
            "pool within the HBM bound"),
        PolicyRule(
            "acceptance_drift", ("acceptance_drift",), "tune_spec_k",
            "slo_acceptance_rate per-temperature buckets out of band: "
            "step spec k toward the measured acceptance"),
    ])


@dataclass
class Trigger:
    """A normalized piece of evidence the controller ingests: where it
    came from (sentry finding, burn rate, measured-wire report, flight
    replay) is flattened to (code, value, detail)."""

    code: str
    value: float = 0.0
    detail: Dict = field(default_factory=dict)
