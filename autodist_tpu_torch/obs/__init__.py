"""Observability of the port: the OpenMetrics renderer (``exporter``), the
cross-process span tracer (``spans``) and the flight recorder
(``recorder``), each in the JAX package's format. The JAX package's
``ObsRuntime``, profiler, aggregation, SLOs, sentry and doctor are not
ported yet (ROADMAP.md)."""
