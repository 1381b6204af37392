"""Findings and reports: the analyzer's structured output (PyTorch port).

A copy of the JAX package's ``analysis/report.py``, which the port may not
import. Every defect a pass detects is a :class:`Finding` with a STABLE,
greppable code (the ``SL*`` table below — tests and operators key on these,
so codes are append-only) plus a human message; an :class:`AnalysisReport`
bundles the findings with the informational tables (planned-vs-actual wire,
memory summary) the CLI surfaces render. ``report.ok`` is the gate: no
error-severity findings. The port runs only the plan-level memory pass
(``passes.py::hbm_budget``) so far; the codes of the other passes stay in
the table so the two packages' reports read alike.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

#: Stable finding codes (append-only). Severity shown is the default the
#: passes emit.
FINDING_CODES: Dict[str, str] = {
    # wire conformance (inventory vs promised wire)
    "SLW001": "unplanned collective: payload exceeds every planned wire",
    "SLW002": "missing collective: a planned op kind is absent",
    "SLW003": "unattributed large collective (informational)",
    # static memory budget
    "SLM001": "per-chip state overcommits HBM headroom",
    "SLM002": "state + compiled temp/peak overcommits HBM headroom",
    "SLM003": "scheduled peak live bytes overcommit HBM though totals fit",
    # deadlock / ordering / consistency hazards
    "SLH001": "replica-group ordering mismatch across rendezvousing programs",
    "SLH002": "donated/aliased buffer size mismatch",
    "SLH003": "degradation drift: plan flags disagree with the shared predicate",
    "SLH004": "cross-program channel/permute ordering cycle (potential deadlock)",
    # strategy screening (pre-lowering)
    "SLS001": "strategy node cannot lower (screen reject)",
    # measured wire (trace attribution vs the promise — obs/attrib.py;
    # warnings only: traces are optional and the join is heuristic)
    "SLT001": "measured collective with no planned counterpart",
    "SLT002": "promised collective never observed in the trace",
    "SLT003": "per-bucket measured overlap below the priced exposure",
    # schedule passes (analysis/sched.py over the compiled-HLO DAG)
    "SLO001": "gradsync bucket structurally unable to overlap (serialized)",
    "SLO002": "scheduled overlap below the priced hidden fraction",
}

ERROR, WARNING, INFO = "error", "warning", "info"


@dataclass(frozen=True)
class Finding:
    """One defect (or note) from one pass."""

    code: str
    severity: str                 # error | warning | info
    message: str
    var: str = ""
    pass_name: str = ""           # wire | memory | hazard | screen
    details: Dict = field(default_factory=dict)

    def __post_init__(self):
        if self.code not in FINDING_CODES:
            raise ValueError(f"unknown finding code {self.code!r}")
        if self.severity not in (ERROR, WARNING, INFO):
            raise ValueError(f"unknown severity {self.severity!r}")

    def render(self) -> str:
        where = f" var={self.var}" if self.var else ""
        return f"{self.code} [{self.severity}]{where}: {self.message}"


@dataclass
class AnalysisReport:
    """All findings from one analyzer run, plus the informational tables."""

    findings: List[Finding] = field(default_factory=list)
    tables: Dict = field(default_factory=dict)
    program: str = ""

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == ERROR]

    @property
    def warnings(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == WARNING]

    @property
    def ok(self) -> bool:
        """No error-severity findings — the bar cache validation and the
        selftest hold a program to."""
        return not self.errors

    def codes(self) -> Tuple[str, ...]:
        return tuple(f.code for f in self.findings)

    def extend(self, findings: List[Finding]) -> "AnalysisReport":
        self.findings.extend(findings)
        return self

    def summary(self) -> str:
        n_e, n_w = len(self.errors), len(self.warnings)
        label = f" {self.program}" if self.program else ""
        if not self.findings:
            return f"shardlint{label}: clean (0 findings)"
        return (f"shardlint{label}: {n_e} error(s), {n_w} warning(s), "
                f"{len(self.findings) - n_e - n_w} note(s): "
                + "; ".join(f.code for f in self.findings))

    def render(self) -> str:
        lines = [self.summary()]
        for f in self.findings:
            lines.append("  " + f.render())
        return "\n".join(lines)

    def to_json(self) -> Dict:
        return {
            "program": self.program,
            "ok": self.ok,
            "findings": [
                {
                    "code": f.code,
                    "severity": f.severity,
                    "var": f.var,
                    "pass": f.pass_name,
                    "message": f.message,
                    "details": f.details,
                }
                for f in self.findings
            ],
            "tables": self.tables,
        }


class AnalysisError(Exception):
    """Raised where an error-severity report must stop the caller (plan
    cache validation): carries the report so the eviction log can attach
    the findings."""

    def __init__(self, report: AnalysisReport):
        self.report = report
        super().__init__(report.render())


def report_to_text(report: AnalysisReport) -> str:
    """Render a report (findings + tables) for terminal output."""
    out = [report.render()]
    wire = report.tables.get("wire")
    if wire:
        out.append("")
        out.append(f"{'variable':32s} {'rendering':12s} {'planned ops':28s} "
                   f"{'planned':>10s} {'actual':>10s}")
        out.append("-" * 96)
        for row in wire:
            out.append(
                f"{row['var'][:32]:32s} {row['rendering']:12s} "
                f"{','.join(row['planned_ops'])[:28]:28s} "
                f"{row['planned_bytes'] / 1e6:8.3f}MB "
                + (f"{row['actual_bytes'] / 1e6:8.3f}MB"
                   if row.get("actual_bytes") is not None else f"{'—':>10s}")
            )
    sched = report.tables.get("sched_overlap")
    if sched:
        out.append("")
        out.append(f"{'bucket':>6s} {'collectives':>11s} {'wire':>10s} "
                   f"{'window':>10s} {'sched ovl':>9s} {'async':>6s}")
        out.append("-" * 58)
        for row in sched:
            out.append(
                f"{row['bucket']:6d} {row['n_collectives']:11d} "
                f"{row['wire_bytes'] / 1e6:8.3f}MB "
                f"{row['window_compute_bytes'] / 1e6:8.3f}MB "
                f"{row['scheduled_overlap'] * 100:8.1f}% "
                f"{'yes' if row['async_pairs'] else 'no':>6s}")
    smem = report.tables.get("sched_memory")
    if smem and smem.get("n_buffers"):
        top = ", ".join(f"{t['name']} ({t['bytes'] / 1e6:.2f}MB)"
                        for t in smem.get("top_buffers", []))
        out.append(
            f"\nscheduled peak: "
            f"{smem['scheduled_peak_bytes'] / 1e9:.3f} GB/chip live at "
            f"position {smem.get('peak_position', 0)} of "
            f"{smem.get('n_instructions', 0)}"
            + (f" (top: {top})" if top else ""))
    mem = report.tables.get("memory")
    if mem:
        out.append("")
        line = (f"memory: {mem['state_gb_per_chip']:.3f} GB/chip state "
                f"(+{mem.get('temp_gb_per_chip', 0.0):.3f} temp)")
        if mem.get("capacity_gb_per_chip"):
            line += (f" vs {mem['usable_gb_per_chip']:.3f} GB usable "
                     f"({mem['headroom']:.0%} of "
                     f"{mem['capacity_gb_per_chip']:.1f} GB)")
        else:
            line += " — budget unchecked (no ResourceSpec)"
        out.append(line)
    return "\n".join(out)


def dumps(report: AnalysisReport) -> str:
    return json.dumps(report.to_json(), indent=2, sort_keys=True)
