"""Observability of the port: for now only the OpenMetrics renderer."""
