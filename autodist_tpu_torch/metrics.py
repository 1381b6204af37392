"""Evaluation metrics over the port's models, and the operational registry.

The port of the JAX package's ``metrics.py``. Its first half is the task
metrics: pure functions of logits (``accuracy``, ``top_k_accuracy``,
``perplexity``), factories of ``(params, batch) -> {name: value}`` functions
(``classification_metrics``, ``lm_metrics``, ``ranking_metrics``) that run
on the step's logical parameters (``DistributedTrainStep.compile_metrics``),
and ``evaluate_dataset``, a weighted average over an iterable of batches::

    from autodist_tpu_torch import metrics

    mfn = metrics.classification_metrics(spec.apply, top_k=(1, 5))
    results = metrics.evaluate_dataset(step, state, loader, metrics_fn=mfn)
    # {"loss": 1.93, "top1": 0.71, "top5": 0.90, "examples": 50000}

Its second half is the registry (``Counter``/``Gauge``/``Histogram``/
``MetricsRegistry``): serving publishes through it from hot host threads;
``render_text`` delegates to the one OpenMetrics renderer in
``obs/exporter.py``.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from autodist_tpu_torch.models.convert import tree_leaves

__all__ = [
    "accuracy",
    "top_k_accuracy",
    "perplexity",
    "classification_metrics",
    "lm_metrics",
    "ranking_metrics",
    "evaluate_dataset",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry",
]


# ------------------------------------------------------------- pure metrics
def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Fraction of rows whose argmax matches the integer label (the first
    maximum on a tie, as ``jnp.argmax``)."""
    return (logits.argmax(dim=-1) == labels).to(torch.float32).mean()


def top_k_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """Fraction of rows whose label lands in the k highest logits.

    ``jax.lax.top_k`` breaks a tie by the lower index, which ``torch.topk``
    does not promise; so the label is counted a hit by its rank: the logits
    strictly greater than its own, plus the equal ones at a lower index,
    fewer than ``k``."""
    labels = labels.to(torch.int64)
    own = logits.gather(-1, labels[..., None])
    index = torch.arange(logits.shape[-1], device=logits.device)
    ahead = (logits > own) | ((logits == own) & (index < labels[..., None]))
    hit = ahead.sum(dim=-1) < k
    return hit.to(torch.float32).mean()


def perplexity(mean_loss) -> float:
    """exp(cross-entropy): the LM convention's view of a token loss."""
    if isinstance(mean_loss, torch.Tensor):
        mean_loss = mean_loss.detach().cpu().numpy()
    return float(np.exp(np.asarray(mean_loss)))


# -------------------------------------------------------- metric factories
def classification_metrics(
    apply_fn: Callable[[Any, Any], Any],
    input_key: str = "images",
    label_key: str = "labels",
    top_k: Sequence[int] = (1,),
) -> Callable[[Any, Any], Dict[str, torch.Tensor]]:
    """(params, batch) -> {top1, top5, ...} for dict image/label batches
    through the model's ``apply`` (every CNN of the zoo has one)."""

    def metrics_fn(params, batch):
        logits = apply_fn(params, batch[input_key])
        labels = batch[label_key]
        out = {}
        for k in top_k:
            out[f"top{k}"] = (accuracy(logits, labels) if k == 1
                              else top_k_accuracy(logits, labels, k))
        return out

    return metrics_fn


def lm_metrics(
    apply_fn: Callable[[Any, Any], Any],
    token_key: str = "tokens",
    shift: bool = True,
    pad_id: Optional[int] = None,
) -> Callable[[Any, Any], Dict[str, torch.Tensor]]:
    """(params, batch) -> {token_accuracy} for next-token LMs: the model's
    logits at position t predict token t+1 (``shift=True``); ``pad_id``
    positions are masked out of the average."""

    def metrics_fn(params, batch):
        tokens = batch[token_key]
        logits = apply_fn(params, tokens)
        if shift:
            logits, targets = logits[:, :-1], tokens[:, 1:]
        else:
            targets = tokens
        correct = (logits.argmax(dim=-1) == targets).to(torch.float32)
        if pad_id is not None:
            # The masked mean and its weight: batches aggregate weighted by
            # their valid tokens, not their rows (the __weight convention
            # of evaluate_dataset).
            mask = (targets != pad_id).to(torch.float32)
            n_valid = mask.sum()
            return {
                "token_accuracy": (correct * mask).sum() / torch.clamp(n_valid, min=1.0),
                "token_accuracy__weight": n_valid,
            }
        return {"token_accuracy": correct.mean()}

    return metrics_fn


def ranking_metrics(
    score_fn: Callable[[Any, Any, Any], Any],
    user_key: str = "users",
    item_key: str = "candidates",
    k: int = 10,
) -> Callable[[Any, Any], Dict[str, torch.Tensor]]:
    """HR@k / NDCG@k for implicit-feedback recommenders: each row is one
    user with candidate items ``[C]`` whose positive sits in column 0, the
    rest sampled negatives. ``score_fn(params, users, items)`` scores
    equal-length user/item vectors (the zoo NeuMF: ``lambda p, u, i:
    spec.apply(p, {"users": u, "items": i})``).

    Where the JAX package maps ``score_fn`` over the rows (``vmap``), the
    port scores the flattened ``[B*C]`` user and item vectors in one call
    and reshapes the scores to ``[B, C]``; each score is the same function
    of its own user and item. The positive's rank is the number of
    negatives scored strictly higher (a tie goes to the positive); HR@k is
    rank < k, NDCG@k is 1/log2(rank+2) on a hit.
    """

    def metrics_fn(params, batch):
        users = batch[user_key]                    # [B]
        cands = batch[item_key]                    # [B, C]
        # Users repeated in their own dtype: a cast to the candidates'
        # could wrap when the user vocabulary outgrows the item dtype.
        flat_users = users[:, None].expand(cands.shape).reshape(-1)
        scores = score_fn(params, flat_users, cands.reshape(-1)).reshape(cands.shape)
        pos = scores[:, :1]
        rank = (scores[:, 1:] > pos).to(torch.int32).sum(dim=1)
        hit = rank < k
        ndcg = torch.where(hit, 1.0 / torch.log2(rank.to(torch.float32) + 2.0),
                           torch.zeros((), device=scores.device))
        return {f"hr@{k}": hit.to(torch.float32).mean(), f"ndcg@{k}": ndcg.mean()}

    return metrics_fn


# ----------------------------------------------------------- aggregation
def _batch_size(batch) -> int:
    for leaf in tree_leaves(batch):
        if getattr(leaf, "ndim", 0) >= 1:
            return int(leaf.shape[0])
    return 0


def _logical_params(step, state):
    """The user-shaped parameter view: the step's own
    (``DistributedTrainStep.logical_params`` gathers and unpads storage)
    when it has one, else the raw params."""
    if hasattr(step, "logical_params"):
        return step.logical_params(state)
    return getattr(state, "params", state)


def _compile(step, state, metrics_fn):
    """The step's metric runner (streams offloaded leaves in, gathers and
    unpads storage: ``DistributedTrainStep.compile_metrics``), or
    ``metrics_fn`` itself under ``torch.no_grad()`` for a foreign step
    object; and whether it is the step's."""
    if hasattr(step, "compile_metrics"):
        return step.compile_metrics(metrics_fn, state), True

    def plain(params, batch):
        with torch.no_grad():
            return metrics_fn(params, batch)

    return plain, False


def evaluate_dataset(
    step,
    state,
    batches: Iterable[Any],
    metrics_fn: Optional[Callable[[Any, Any], Dict[str, Any]]] = None,
    max_batches: Optional[int] = None,
) -> Dict[str, float]:
    """Weighted-average ``step.evaluate`` loss (and optional task metrics)
    over an iterable of batches (a DataLoader or any batch iterator).

    Each metric's contribution is weighted by the batch's leading dimension,
    so ragged tails average correctly; a ``metrics_fn`` may override the
    weight of metric ``k`` by also returning ``"<k>__weight"`` (masked
    metrics: ``lm_metrics(pad_id=...)`` counts valid tokens this way).
    ``metrics_fn`` runs on the logical parameter view. Returns ``{"loss":
    ..., <metrics...>, "examples": N}``, or ``{"examples": 0}`` when no
    batch had rows.

    Across ranks the aggregation is per rank: feed every rank the same eval
    batches (replicated evaluation, the same result everywhere), or give
    each a disjoint shard and combine the per-metric sums
    ``result[k] * result["examples"]`` across ranks.
    """
    compiled_metrics = step_runs_it = None
    if metrics_fn is not None:
        compiled_metrics, step_runs_it = _compile(step, state, metrics_fn)
    sums: Dict[str, float] = {}
    weights: Dict[str, float] = {}
    n_total = 0
    logical = None
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        n = _batch_size(batch)
        if n == 0:
            continue
        out = step.evaluate(state, batch)
        vals = {"loss": float(out["loss"])}
        batch_weights = {}
        if compiled_metrics is not None:
            if step_runs_it:
                # The step's runner streams and unpads: raw params in.
                metric_params = getattr(state, "params", state)
            else:
                if logical is None:
                    logical = _logical_params(step, state)
                metric_params = logical
            m = {k: float(v) for k, v in compiled_metrics(metric_params, batch).items()}
            batch_weights = {k[: -len("__weight")]: m.pop(k)
                             for k in list(m) if k.endswith("__weight")}
            vals.update(m)
        for k, v in vals.items():
            w = batch_weights.get(k, float(n))
            sums[k] = sums.get(k, 0.0) + v * w
            weights[k] = weights.get(k, 0.0) + w
        n_total += n
    if n_total == 0:
        return {"examples": 0}
    result = {k: (sums[k] / weights[k]) if weights[k] else 0.0 for k in sums}
    result["examples"] = n_total
    return result


# ------------------------------------------------------- operational registry
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
