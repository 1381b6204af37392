"""Observability of the port, each in the JAX package's format: the
OpenMetrics renderer, reader and file writer (``exporter``), the
cross-process span tracer (``spans``), the flight recorder (``recorder``),
serving SLOs (``slo``), the anomaly sentry (``sentry``) and the per-host
step-time aggregator with its straggler scores (``aggregate``). The JAX
package's ``ObsRuntime``, profiler and doctor are not ported yet
(ROADMAP.md)."""
from autodist_tpu_torch.obs.aggregate import HostAggregator
from autodist_tpu_torch.obs.exporter import FileExporter, parse_openmetrics, render_openmetrics
from autodist_tpu_torch.obs.sentry import CODES, Finding, Sentry, SentryConfig
from autodist_tpu_torch.obs.slo import SLOSpec, SLOTracker, json_safe, replay_flight_records

__all__ = [
    "CODES",
    "FileExporter",
    "Finding",
    "HostAggregator",
    "SLOSpec",
    "SLOTracker",
    "Sentry",
    "SentryConfig",
    "json_safe",
    "parse_openmetrics",
    "render_openmetrics",
    "replay_flight_records",
]
