"""Operational metrics registry: counters, gauges and histograms.

The port's copy of the registry half of the JAX package's ``metrics.py``
(``Counter``/``Gauge``/``Histogram``/``MetricsRegistry``). The task-metric
functions of that module compute on device arrays in JAX and are not part
of this slice. Serving publishes through this registry from hot host
threads; ``render_text`` delegates to the one OpenMetrics renderer in
``obs/exporter.py``.
"""
from __future__ import annotations

import threading
from typing import Any, Dict

import numpy as np


class Counter:
    """Monotonic counter (requests served, tokens generated)."""

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value (queue depth, active slots, tokens/sec)."""

    def __init__(self):
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def add(self, n: float = 1.0) -> None:
        self._value += n

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Latency-style distribution with exact count/sum and sampled quantiles.

    Keeps up to ``max_samples`` observations; past that, reservoir sampling
    (Vitter's algorithm R) keeps the retained set a uniform sample of the
    stream, so percentiles stay unbiased at serving volumes while memory
    stays bounded.

    The retained reservoir is maintained **sorted** (``bisect.insort`` on
    observe — an O(max_samples) memmove of doubles, microseconds at the
    4096 default) so :meth:`percentile` is an O(1) index + interpolation
    instead of a full ``np.percentile`` pass over every retained
    observation per quantile per render: ``GET /metrics`` under serve load
    renders every histogram in O(quantiles), not O(samples·log·quantiles).
    The interpolation replicates numpy's ``linear`` method bit-for-bit
    (including its t≥0.5 lerp branch), so the rendered exposition is
    byte-identical to the previous implementation — pinned by the
    existing byte-parity golden tests.
    """

    def __init__(self, max_samples: int = 4096):
        self._samples: list = []   # SORTED retained reservoir
        self._max = max_samples
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(0)

    def observe(self, v: float) -> None:
        import bisect

        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            if len(self._samples) < self._max:
                bisect.insort(self._samples, v)
            else:
                j = int(self._rng.integers(0, self._count))
                if j < self._max:
                    # Evicting the j-th order statistic for uniform random
                    # j evicts a uniform-random retained sample — same
                    # algorithm-R distribution as the unsorted variant.
                    del self._samples[j]
                    bisect.insort(self._samples, v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, p: float) -> float:
        """p in [0, 100]; nan when nothing was observed. O(1): index math
        over the sorted reservoir, numpy-'linear'-exact interpolation."""
        with self._lock:
            xs = self._samples
            if not xs:
                return float("nan")
            rank = (len(xs) - 1) * (float(p) / 100.0)
            lo = int(rank)
            hi = min(lo + 1, len(xs) - 1)
            t = rank - lo
            a, b = xs[lo], xs[hi]
            # numpy's _lerp computes b - (b-a)(1-t) for t >= 0.5 (monotone
            # guard); mirror it exactly for byte parity through %.6g.
            if t >= 0.5:
                return float(b - (b - a) * (1.0 - t))
            return float(a + (b - a) * t)

    def summary(self) -> Dict[str, float]:
        return {
            "count": float(self._count),
            "sum": self._sum,
            "mean": (self._sum / self._count) if self._count else float("nan"),
            "p50": self.percentile(50.0),
            "p90": self.percentile(90.0),
            "p99": self.percentile(99.0),
        }


class MetricsRegistry:
    """Named metric table: get-or-create by name, snapshot/render for export.

    One process-wide default lives at ``metrics.registry``; components take a
    registry argument so tests can isolate (the serve selftest passes its
    own to keep its numbers clean of earlier runs).
    """

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls()
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def snapshot(self) -> Dict[str, Any]:
        """{name: value | histogram summary dict} for JSON export."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, Any] = {}
        for name, m in items:
            out[name] = m.summary() if isinstance(m, Histogram) else m.value
        return out

    def render_text(self) -> str:
        """Text exposition of this registry — delegates to THE renderer
        (``autodist_tpu_torch.obs.exporter.render_openmetrics``) so every export
        surface emits one format; kept as a convenience method (lazy
        import: obs imports metrics at module load)."""
        from autodist_tpu_torch.obs.exporter import render_openmetrics

        return render_openmetrics(self)


#: Process-default registry (the serve subsystem's export surface).
registry = MetricsRegistry()
