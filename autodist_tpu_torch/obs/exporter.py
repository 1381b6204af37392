"""The ONE OpenMetrics renderer of the port, its reader and its file
writer.

A copy of the JAX package's ``obs/exporter.py``: every export surface
(``GET /metrics``, ``MetricsRegistry.render_text``, :class:`FileExporter`)
emits :func:`render_openmetrics`'s format, byte-identical on the same
snapshot, and :func:`parse_openmetrics` reads it back the way a scraper
would.
"""
from __future__ import annotations

import math
import os
import threading
from typing import Any, Dict, Optional, Tuple

from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.utils import logging

__all__ = ["FileExporter", "parse_openmetrics", "render_openmetrics"]

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


def parse_openmetrics(text: str) -> Dict[Tuple[str, str], float]:
    """Parse an exposition back into ``{(name, labels): value}``.

    Validates structure the way a scraper would: every sample line is
    ``name[{labels}] value`` with a finite-or-inf float value, and the
    document ends with ``# EOF``. Raises ``ValueError`` on malformed input.
    """
    lines = text.splitlines()
    if not lines or lines[-1].strip() != "# EOF":
        raise ValueError("exposition missing trailing # EOF")
    out: Dict[Tuple[str, str], float] = {}
    for ln in lines[:-1]:
        ln = ln.strip()
        if not ln or ln.startswith("#"):
            if ln.startswith("#") and not ln.startswith(("# TYPE", "# HELP",
                                                         "# UNIT", "# EOF")):
                raise ValueError(f"unknown comment line: {ln!r}")
            continue
        name, _, rest = ln.partition(" ")
        if not rest:
            raise ValueError(f"sample line without value: {ln!r}")
        labels = ""
        if "{" in name:
            if not name.endswith("}"):
                raise ValueError(f"unterminated label set: {ln!r}")
            name, _, labels = name.partition("{")
            labels = labels[:-1]
        v = float(rest.split()[0])  # raises on non-numeric
        if math.isnan(v):
            raise ValueError(f"NaN sample value: {ln!r}")
        out[(name, labels)] = v
    return out


class FileExporter:
    """Periodic OpenMetrics file writer for processes without an HTTP front
    end: writes :func:`render_openmetrics` to ``path`` atomically (tmp +
    replace — a scraper never reads a torn file) every ``interval_s`` from a
    daemon thread, plus on :meth:`stop`. ``write_once`` is the synchronous
    form."""

    def __init__(self, path: str, registry: Optional[M.MetricsRegistry] = None,
                 interval_s: float = 10.0):
        self.path = path
        self.registry = registry or M.registry
        self.interval_s = float(interval_s)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def write_once(self, snapshot: Optional[Dict[str, Any]] = None) -> str:
        text = render_openmetrics(self.registry, snapshot=snapshot)
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)
        tmp = f"{self.path}.tmp-{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(text)
        os.replace(tmp, self.path)
        return text

    def start(self) -> "FileExporter":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.write_once()
                except OSError as e:
                    logging.warning("metrics file export failed: %s", e)
                self._stop.wait(self.interval_s)

        self._thread = threading.Thread(
            target=loop, name="obs-file-exporter", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(5.0, self.interval_s))
            self._thread = None
        try:
            self.write_once()  # final flush: the file reflects run end
        except OSError:
            pass

    def __enter__(self) -> "FileExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
