"""The ONE OpenMetrics renderer of the port.

A copy of ``render_openmetrics`` from the JAX package's ``obs/exporter.py``:
every export surface (``GET /metrics``, ``MetricsRegistry.render_text``)
emits this format.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from autodist_tpu_torch import metrics as M

__all__ = ["render_openmetrics"]

_QUANTILES = (("p50", "0.5"), ("p90", "0.9"), ("p99", "0.99"))


def _fmt(v: float) -> str:
    return f"{float(v):.6g}"


def render_openmetrics(registry: Optional[M.MetricsRegistry] = None,
                       snapshot: Optional[Dict[str, Any]] = None) -> str:
    """The canonical exposition of a registry (or a frozen ``snapshot``
    from :meth:`~autodist_tpu_torch.metrics.MetricsRegistry.snapshot` — pass one
    when several surfaces must render the exact same instant)."""
    if snapshot is None:
        snapshot = (registry or M.registry).snapshot()
    lines = []
    last_family = None

    def sort_key(name: str):
        # Group by FAMILY first (labeled siblings adjacent, counters next
        # to nothing that could reopen their family), then by full name.
        # Plain name-sort almost gives this, but a family that is a
        # string-prefix of another (`foo` vs `foo_bar` vs `foo{a="1"}`)
        # would interleave — a reopened # TYPE family, which strict
        # OpenMetrics scrapers reject.
        base = name.partition("{")[0]
        fam = (base[:-len("_total")]
               if not isinstance(snapshot[name], dict)
               and base.endswith("_total") else base)
        return (fam, name)

    for name in sorted(snapshot, key=sort_key):
        val = snapshot[name]
        # A snapshot key may carry an inline label set: base name decides
        # the family/type, the labels ride on every sample line.
        base, _, labels = name.partition("{")
        labels = f"{{{labels}" if labels else ""
        if isinstance(val, dict):  # histogram summary
            if (base, "summary") != last_family:
                lines.append(f"# TYPE {base} summary")
                last_family = (base, "summary")
            if val.get("count"):
                for key, label in _QUANTILES:
                    qlabels = (f'{labels[:-1]},quantile="{label}"}}' if labels
                               else f'{{quantile="{label}"}}')
                    lines.append(f"{base}{qlabels} {_fmt(val[key])}")
            lines.append(f"{base}_count{labels} {_fmt(val.get('count', 0))}")
            lines.append(f"{base}_sum{labels} {_fmt(val.get('sum', 0.0))}")
        elif base.endswith("_total"):
            family = base[:-len("_total")]
            if (family, "counter") != last_family:
                lines.append(f"# TYPE {family} counter")
                last_family = (family, "counter")
            lines.append(f"{base}{labels} {_fmt(val)}")
        else:
            if (base, "gauge") != last_family:
                lines.append(f"# TYPE {base} gauge")
                last_family = (base, "gauge")
            lines.append(f"{base}{labels} {_fmt(val)}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"
