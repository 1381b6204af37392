"""Static analysis of lowered plans (PyTorch port of the JAX package's
``analysis/``): the findings report (``report.py``) and the plan-level
memory pass :func:`~autodist_tpu_torch.analysis.passes.hbm_budget`, which
prices a plan's state and a serving engine's page pool against the GPU's
memory (SLM001/SLM002). The passes over compiled programs (wire
conformance, hazards, schedule) are not ported."""
from autodist_tpu_torch.analysis.passes import DEFAULT_HEADROOM, hbm_budget
from autodist_tpu_torch.analysis.report import (
    FINDING_CODES,
    AnalysisError,
    AnalysisReport,
    Finding,
    dumps,
    report_to_text,
)

__all__ = [
    "DEFAULT_HEADROOM",
    "FINDING_CODES",
    "AnalysisError",
    "AnalysisReport",
    "Finding",
    "dumps",
    "hbm_budget",
    "report_to_text",
]
