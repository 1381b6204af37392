"""Static analysis of lowered plans (PyTorch port of the JAX package's
``analysis/``): the findings report (``report.py``), the plan-level passes
(``passes.py``: the memory budget :func:`hbm_budget`, SLM001/SLM002; the
degradation drift check :func:`degradation_check`, SLH003; the strategy
screen :func:`screen_strategy`, SLS001) and the schedule screen
(``sched.py``: :func:`screen_schedule`, SLO001/SLM003), joined by
:func:`analyze_plan`, which the plan cache runs before it trusts a cached
winner.

Not ported yet (ROADMAP.md Queue 1 item 7): the passes over a compiled
program — ``analyze_program``, wire conformance, rendezvous and alias
hazards, the measured wire, the schedule passes over the program's DAG and
channel cycles, and the inventory and graph parsers they read."""
from autodist_tpu_torch.analysis.passes import (
    DEFAULT_HEADROOM,
    degradation_check,
    hbm_budget,
    screen_strategy,
)
from autodist_tpu_torch.analysis.report import (
    FINDING_CODES,
    AnalysisError,
    AnalysisReport,
    Finding,
    dumps,
    report_to_text,
)
from autodist_tpu_torch.analysis.sched import screen_schedule


def analyze_plan(
    plan,
    strategy=None,
    resource_spec=None,
    optimizer: str = "",
    headroom: float = DEFAULT_HEADROOM,
    temp_bytes: float = 0.0,
    serve_pool_bytes: float = 0.0,
    serve_shared_fraction: float = 0.0,
    serve_quant_capacity_x: float = 1.0,
    program: str = "",
    model_item=None,
) -> AnalysisReport:
    """Static passes over a lowered ``ShardingPlan`` (no program needed):
    degradation drift against the shared predicate and, with a
    ``resource_spec``, the per-GPU memory budget (``serve_pool_bytes``
    counts a serving engine's KV page pool as a named tenant; the shared
    fraction and quantized capacity ride the memory summary). With
    ``model_item`` and ``strategy``, the schedule screen (degenerate
    bucketing SLO001, the bucket transient SLM003) joins in."""
    report = AnalysisReport(program=program)
    report.extend(degradation_check(plan, strategy))
    mem_findings, mem_summary = hbm_budget(
        plan, resource_spec=resource_spec, optimizer=optimizer, headroom=headroom,
        temp_bytes=temp_bytes, serve_pool_bytes=serve_pool_bytes,
        serve_shared_fraction=serve_shared_fraction,
        serve_quant_capacity_x=serve_quant_capacity_x)
    report.extend(mem_findings)
    report.tables["memory"] = mem_summary
    if strategy is not None and model_item is not None:
        report.extend(screen_schedule(strategy, model_item, resource_spec=resource_spec,
                                      headroom=headroom))
    return report


__all__ = [
    "DEFAULT_HEADROOM",
    "FINDING_CODES",
    "AnalysisError",
    "AnalysisReport",
    "Finding",
    "analyze_plan",
    "degradation_check",
    "dumps",
    "hbm_budget",
    "report_to_text",
    "screen_schedule",
    "screen_strategy",
]
