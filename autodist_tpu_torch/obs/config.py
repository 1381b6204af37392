"""Observability configuration and the per-process runtime bundle (PyTorch
port of ``obs/config.py``).

``AutoDist(observability=ObsConfig(...))`` starts an :class:`ObsRuntime`
on ``autodist.obs``, as ``fault_tolerance=FTConfig(...)`` starts
``autodist.ft``. Everything is off by default and each piece stands alone:
spans alone, a metrics file alone, or the whole bundle (spans, the file
exporter, the flight recorder and sentry, cross-process aggregation).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

from autodist_tpu_torch import const
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.obs import recorder as _flight
from autodist_tpu_torch.obs import spans as _spans
from autodist_tpu_torch.obs.aggregate import HostAggregator
from autodist_tpu_torch.obs.exporter import FileExporter
from autodist_tpu_torch.obs.profiler import StepProfiler
from autodist_tpu_torch.obs.sentry import Sentry, SentryConfig

__all__ = ["ObsConfig", "ObsRuntime"]


@dataclass
class ObsConfig:
    """Knobs for spans, metrics export, the flight recorder and sentry, and
    cross-process aggregation (the JAX package's fields and defaults).

    - ``trace_out``: shared directory of chrome-trace span part-files
      (every process flushes at exit; ``obs.spans.stitch`` merges). Falls
      back to ``AUTODIST_TRACE_OUT`` when empty.
    - ``span_capacity``: the default tracer's ring size (spans).
    - ``metrics_path`` / ``metrics_interval_s``: a periodic OpenMetrics
      file exporter ("" disables).
    - ``aggregate``: publish this process's step-time quantiles and sweep
      the fleet's over a file transport at ``aggregate_dir`` (default
      ``<ft base>/obs``); a process whose p50 exceeds
      ``straggler_threshold`` x the fleet median for ``escalate_after``
      ticks is escalated to the HealthMonitor's SUSPECT state.
    - ``flight`` / ``flight_dir``: the flight recorder (default
      ``<ft base>/flight``), installed as the process default so every
      instrumentation point (the train step's compiles and errors,
      snapshots, heartbeat transitions, serving) writes into it.
      ``AUTODIST_NO_FLIGHT=1`` turns it off, whatever the config says.
    - ``sentry`` / ``sentry_config``: the anomaly sentry over that stream
      (``obs/sentry.py``), escalated into the HealthMonitor when one is
      attached.
    """

    trace_out: str = ""
    span_capacity: int = 4096
    metrics_path: str = ""
    metrics_interval_s: float = 10.0
    aggregate: bool = False
    aggregate_dir: str = ""
    aggregate_interval_s: float = 5.0
    straggler_threshold: float = 1.5
    escalate_after: int = 3
    flight: bool = True
    flight_dir: str = ""
    sentry: bool = True
    sentry_config: Optional[SentryConfig] = None

    def resolved(self) -> "ObsConfig":
        """A copy with the environment's and the derived defaults filled
        in (as ``FTConfig.resolved``)."""
        out = ObsConfig(**self.__dict__)
        if not out.trace_out:
            out.trace_out = ENV.AUTODIST_TRACE_OUT.val
        base = ENV.AUTODIST_FT_DIR.val or const.DEFAULT_FT_DIR
        if out.aggregate and not out.aggregate_dir:
            out.aggregate_dir = os.path.join(base, "obs")
        if os.environ.get("AUTODIST_NO_FLIGHT") == "1":
            # The operator's opt-out beats the default and an explicit config.
            out.flight = False
        if out.flight and not out.flight_dir:
            out.flight_dir = ENV.AUTODIST_FLIGHT_DIR.val or _flight.flight_dir(base)
        return out


class ObsRuntime:
    """The started observability components of one process.

    ``tracer`` is always the process-default span tracer, so library
    instrumentation and user spans share one timeline; ``exporter``,
    ``recorder``, ``sentry`` and ``aggregator`` exist only when configured.
    :meth:`profiler` wraps a built step, :meth:`observe_step` feeds the
    aggregator, :meth:`close` flushes and stops.
    """

    def __init__(self, config: Optional[ObsConfig] = None,
                 registry: Optional[M.MetricsRegistry] = None, monitor=None):
        self.config = (config or ObsConfig()).resolved()
        self.registry = registry or M.registry
        if self.config.trace_out:
            _spans.enable_trace_out(self.config.trace_out)
        self.tracer = _spans.get_tracer()
        if self.config.span_capacity != self.tracer._spans.maxlen:
            self.tracer.set_capacity(self.config.span_capacity)
        self.exporter: Optional[FileExporter] = None
        if self.config.metrics_path:
            self.exporter = FileExporter(self.config.metrics_path, registry=self.registry,
                                         interval_s=self.config.metrics_interval_s).start()
        self.recorder = None
        if self.config.flight and self.config.flight_dir:
            self.recorder = _flight.enable(self.config.flight_dir)
        self.sentry: Optional[Sentry] = None
        if self.config.sentry:
            self.sentry = Sentry(config=self.config.sentry_config, registry=self.registry,
                                 monitor=monitor, recorder=self.recorder)
        self.aggregator: Optional[HostAggregator] = None
        if self.config.aggregate:
            from autodist_tpu_torch.ft.heartbeat import FileTransport

            self.aggregator = HostAggregator(
                FileTransport(self.config.aggregate_dir),
                process_id=ENV.AUTODIST_PROCESS_ID.val, registry=self.registry,
                interval_s=self.config.aggregate_interval_s, monitor=monitor,
                straggler_threshold=self.config.straggler_threshold,
                escalate_after=self.config.escalate_after).start()

    def profiler(self, step, **kwargs) -> StepProfiler:
        """A :class:`StepProfiler` over ``step`` wired into this runtime's
        registry, tracer, flight recorder and sentry."""
        kwargs.setdefault("registry", self.registry)
        kwargs.setdefault("tracer", self.tracer)
        kwargs.setdefault("recorder", self.recorder)
        kwargs.setdefault("sentry", self.sentry)
        return StepProfiler(step, **kwargs)

    def observe_step(self, seconds: float) -> None:
        if self.aggregator is not None:
            self.aggregator.observe_step(seconds)

    def attach_monitor(self, monitor) -> None:
        """Bind a HealthMonitor late (``AutoDist`` starts ft first, then
        obs, and attaches ft's monitor here)."""
        if self.aggregator is not None:
            self.aggregator.monitor = monitor
        if self.sentry is not None:
            self.sentry.monitor = monitor

    def close(self) -> None:
        if self.aggregator is not None:
            self.aggregator.stop()
        if self.exporter is not None:
            self.exporter.stop()
        if self.recorder is not None:
            self.recorder.close()            # the clean run_end marker
        if self.config.trace_out and self.tracer.spans():
            try:
                self.tracer.flush_part(self.config.trace_out)
            except OSError:
                pass
