"""Observability of the port, each in the JAX package's format:

- ``spans``: the cross-process span tracer (chrome traces stitched by one
  trace id);
- ``profiler``: :class:`StepProfiler` (the dispatch gap, device time and
  wall of each window, the live MFU from the step's own FLOP count,
  roofline position, compile counts, memory high-water mark) and
  :class:`StepTimer`;
- ``config``: ``ObsConfig`` and the per-process ``ObsRuntime`` that
  ``AutoDist(observability=...)`` starts;
- ``exporter``: the OpenMetrics renderer, reader and file writer;
- ``aggregate``: per-process step-time quantiles and straggler scores;
- ``recorder``: the flight recorder; ``sentry``: the anomaly sentry over
  it; ``slo``: serving SLOs;
- ``doctor``: the postmortem of a dead run's artifacts (``DOC###``).

Entry points: ``AutoDist(observability=ObsConfig(...))`` ->
``autodist.obs``, ``python -m autodist_tpu_torch.obs doctor <ft-dir>`` and
``python -m autodist_tpu_torch.obs --selftest [--device cpu]``. The JAX
package's measured-wire attribution (``obs/attrib.py``: ``attribute``,
``MeasuredWire``) waits for ROADMAP.md Queue 1 item 7.
"""
from autodist_tpu_torch.obs.aggregate import HostAggregator
from autodist_tpu_torch.obs.config import ObsConfig, ObsRuntime
from autodist_tpu_torch.obs.doctor import Diagnosis, diagnose
from autodist_tpu_torch.obs.exporter import FileExporter, parse_openmetrics, render_openmetrics
from autodist_tpu_torch.obs.profiler import StepProfiler, StepTimer, detect_peak_flops
from autodist_tpu_torch.obs.recorder import FlightRecorder, read_records
from autodist_tpu_torch.obs.sentry import CODES, Finding, Sentry, SentryConfig
from autodist_tpu_torch.obs.slo import SLOSpec, SLOTracker, json_safe, replay_flight_records
from autodist_tpu_torch.obs.spans import (
    Span,
    SpanTracer,
    add_span,
    current_trace_id,
    enable_trace_out,
    events_for_request,
    get_tracer,
    span,
    stitch,
    traced,
)

__all__ = [
    "CODES",
    "Diagnosis",
    "FileExporter",
    "Finding",
    "FlightRecorder",
    "HostAggregator",
    "ObsConfig",
    "ObsRuntime",
    "SLOSpec",
    "SLOTracker",
    "Sentry",
    "SentryConfig",
    "Span",
    "SpanTracer",
    "StepProfiler",
    "StepTimer",
    "add_span",
    "current_trace_id",
    "detect_peak_flops",
    "diagnose",
    "enable_trace_out",
    "events_for_request",
    "get_tracer",
    "json_safe",
    "parse_openmetrics",
    "read_records",
    "render_openmetrics",
    "replay_flight_records",
    "span",
    "stitch",
    "traced",
]
