"""Model IR: the description strategies are built against (PyTorch port).

The port's copy of the JAX package's ``model_item.py``. A model is a nested
dict of parameter tensors plus a loss function; ``ModelItem`` records one
``VarItem`` per leaf (name = ``"/"``-joined keys, in ``jax.tree_util``'s
sorted leaf order, shape, dtype, trainable and sparse-update flags) and the
optimizer as an explicit :class:`OptimizerSpec`.

Sparse-update detection and the tensor-parallel roles come from one
forward of the loss on ``meta`` tensors (shapes only, nothing is computed
or allocated) under a ``TorchDispatchMode``, the dispatch-level
counterpart of the JAX package's jaxpr scan (``_trace_analysis``):

- a parameter read by a row gather (``aten.index``, ``index_select``,
  ``embedding``, ``gather``), directly or through a view or a dtype cast,
  is sparse (JAX's ``gather``/``take``/``dynamic_slice``);
- contractions (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``convolution``:
  JAX's ``dot_general`` and ``conv_general_dilated``) taint their output
  with their parameter; every other op unions its operands' taints; a
  parameter's first contraction on an activation tainted by a
  column-parallel parameter makes it ``row``, else ``column``
  (``VarItem.tp_role``, rank >= 2 only). A parameter reaches a contraction
  through views (``t``, ``transpose``, ``permute``, reshapes, slices),
  ``_unsafe_view`` and dtype casts. Einsum and ``@`` on 3-D operands reach
  dispatch as views and ``mm``/``bmm``, as ``dot_general`` in JAX; the tied
  output projection ``x @ embed.T`` contracts the table in both.

:meth:`OptimizerSpec.make` writes optax 0.2.6's update rules out as tensor
code (:class:`Optimizer`), defaults included: every optimizer of the JAX
package's registry (``sgd``, the default, ``momentum``, ``adam``,
``adamw``, ``adagrad``, ``rmsprop``, ``lamb``, ``lion``, ``adafactor``),
global-norm clipping (``clip_norm``) and every learning-rate schedule of
its ``make_schedule``. ``expert_names`` marks the parameters whose leading
dim indexes MoE experts. :meth:`ModelItem.to_json` / ``from_json`` carry
the variables (roles included) and the optimizer spec, as in JAX.
"""
from __future__ import annotations

import math
import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves

from autodist_tpu_torch.models.convert import flatten_params, map_tree, tree_leaves
from autodist_tpu_torch.utils import logging

_aten = torch.ops.aten
# Row-gather reads of their first operand (the JAX scan's gather/take).
_SPARSE_READS = (_aten.index, _aten.index_select, _aten.embedding, _aten.gather)
# Ops whose output stands for their input (dtype casts and copies; views are
# recognised by their schema).
_ALIASING = (_aten._to_copy, _aten.clone, _aten.detach, _aten.alias, _aten._unsafe_view)
# Contractions and the positions of their two operands (the JAX scan's
# dot_general / conv_general_dilated); addmm/baddbmm's first operand is
# added pointwise.
_CONTRACTIONS = {_aten.mm: (0, 1), _aten.bmm: (0, 1), _aten.addmm: (1, 2),
                 _aten.baddbmm: (1, 2), _aten.convolution: (0, 1)}


def _marker_match(name: str, markers: Sequence[str]) -> bool:
    """A ``sparse_names`` / ``expert_names`` marker matches at a path-component boundary: "embed" matches
    "embed/embedding" but not "pos_embed/embedding"."""
    return any(re.search(rf"(^|/){re.escape(m)}", name) for m in markers)


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


@dataclass(frozen=True)
class VarItem:
    """One trainable (or frozen) parameter leaf."""

    name: str
    shape: Tuple[int, ...]
    dtype: str
    trainable: bool = True
    sparse_update: bool = False
    # The leading dim indexes experts (MoE), as in the JAX package.
    expert: bool = False
    # Tensor-parallel role from the dataflow scan: "column", "row" or "".
    tp_role: str = ""

    @property
    def size(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    @property
    def byte_size(self) -> int:
        """Payload bytes: the load metric of PS load balancing."""
        return self.size * getattr(torch, self.dtype).itemsize


# ------------------------------------------------------------------ schedules
def _polynomial(init: float, end: float, power: float, steps: int, begin: int = 0):
    """optax.polynomial_schedule: ``init`` to ``end`` over ``steps`` counts
    from ``begin``; a constant ``init`` when ``steps <= 0``."""
    if steps <= 0:
        return lambda count: init
    begin = max(begin, 0)

    def schedule(count):
        frac = 1.0 - min(max(count - begin, 0), steps) / steps
        return (init - end) * frac ** power + end
    return schedule


def _cosine(init: float, decay_steps: int, alpha: float = 0.0):
    """optax.cosine_decay_schedule (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        cos = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init * ((1.0 - alpha) * cos + alpha)
    return schedule


def _join(first, second, boundary: int):
    """optax.join_schedules of two: ``second`` counts from ``boundary``."""
    return lambda count: first(count) if count < boundary else second(count - boundary)


def _exponential(init: float, transition_steps: int, decay_rate: float,
                 staircase: bool = False, transition_begin: int = 0,
                 end_value: Optional[float] = None):
    """optax.exponential_decay, with its ``transition_begin`` and
    ``end_value`` defaults (the JAX package passes neither)."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init
    begin = max(transition_begin, 0)

    def schedule(count):
        p = (count - begin) / transition_steps
        if staircase:
            p = math.floor(p)
        value = init if count - begin <= 0 else init * decay_rate ** p
        if end_value is not None:
            value = max(value, end_value) if decay_rate < 1.0 else min(value, end_value)
        return value
    return schedule


def _piecewise(init: float, boundaries_and_scales: Dict[Any, float]):
    """optax.piecewise_constant_schedule: from each boundary on (JSON keys
    arrive as strings), the value is multiplied by its scale."""
    scales = sorted((int(k), float(v)) for k, v in boundaries_and_scales.items())
    if any(v < 0.0 for _, v in scales):
        raise ValueError("piecewise schedule scales must be non-negative")

    def schedule(count):
        value = init
        for boundary, scale in scales:
            if count >= boundary:
                value *= scale
        return value
    return schedule


def make_schedule(spec: Dict[str, Any]) -> Callable[[int], float]:
    """A schedule spec ``{"schedule": <name>, ...}`` -> ``count -> value``,
    the JAX package's ``make_schedule`` with optax's formulas: ``constant``,
    ``cosine``, ``exponential`` (``staircase``), ``warmup_cosine``,
    ``warmup_polynomial`` (linear warmup from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then polynomial decay to
    ``end_value`` until ``decay_steps``, the total), ``piecewise``
    (``boundaries_and_scales``) and ``linear``."""
    d = dict(spec)
    name = d.pop("schedule")
    if name == "constant":
        value = float(d["value"])
        return lambda count: value
    if name == "cosine":
        return _cosine(float(d["init_value"]), d["decay_steps"], float(d.get("alpha", 0.0)))
    if name == "exponential":
        return _exponential(float(d["init_value"]), d["transition_steps"],
                            float(d["decay_rate"]), bool(d.get("staircase", False)))
    if name == "warmup_cosine":
        init, peak = float(d.get("init_value", 0.0)), float(d["peak_value"])
        warmup, end = int(d["warmup_steps"]), float(d.get("end_value", 0.0))
        alpha = 0.0 if peak == 0.0 else end / peak
        return _join(_polynomial(init, peak, 1.0, warmup),
                     _cosine(peak, int(d["decay_steps"]) - warmup, alpha), warmup)
    if name == "warmup_polynomial":
        warmup, total = int(d["warmup_steps"]), int(d["decay_steps"])
        if total <= warmup:
            raise ValueError(f"warmup_polynomial: decay_steps ({total}) is the total "
                             f"schedule length and must exceed warmup_steps ({warmup})")
        peak = float(d["peak_value"])
        return _join(_polynomial(float(d.get("init_value", 0.0)), peak, 1.0, warmup),
                     _polynomial(peak, float(d.get("end_value", 0.0)),
                                 float(d.get("power", 1.0)), total - warmup), warmup)
    if name == "piecewise":
        return _piecewise(float(d["init_value"]), d["boundaries_and_scales"])
    if name == "linear":
        return _polynomial(float(d["init_value"]), float(d["end_value"]), 1.0,
                           int(d["transition_steps"]))
    raise ValueError(f"unknown schedule {name!r}; known: constant, cosine, exponential, "
                     "warmup_cosine, warmup_polynomial, piecewise, linear")


# ----------------------------------------------------------------- optimizer
#: Each optimizer's hyperparameters and optax 0.2.6's defaults for them.
_DEFAULTS: Dict[str, Dict[str, Any]] = {
    "sgd": dict(momentum=None, nesterov=False),
    "momentum": dict(momentum=0.9, nesterov=False),
    "adam": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0),
    "adamw": dict(b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4),
    "adagrad": dict(initial_accumulator_value=0.1, eps=1e-7),
    "rmsprop": dict(decay=0.9, eps=1e-8, initial_scale=0.0, eps_in_sqrt=True,
                    centered=False, momentum=None, nesterov=False, bias_correction=False),
    "lamb": dict(b1=0.9, b2=0.999, eps=1e-6, eps_root=0.0, weight_decay=0.0),
    "lion": dict(b1=0.9, b2=0.99, weight_decay=1e-3),
    "adafactor": dict(min_dim_size_to_factor=128, decay_rate=0.8, decay_offset=0,
                      multiply_by_parameter_scale=True, clipping_threshold=1.0,
                      momentum=None, weight_decay_rate=None, eps=1e-30, factored=True),
}


def _factored_dims(shape, min_dim: int) -> Optional[Tuple[int, int]]:
    """optax.factorized._factored_dims: ``(d1, d0)``, the second largest and
    the largest dim (a stable sort, as numpy's on short shapes), or ``None``
    below rank 2 or when the second largest is under ``min_dim``."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < min_dim:
        return None
    return order[-2], order[-1]


def _rms(t: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(t * t))


class Optimizer:
    """optax's update rules as tensor code over a list of leaves (in
    :func:`flatten_params` order), defaults included (:data:`_DEFAULTS`).
    ``update`` returns the updates to add to the params and advances
    ``state`` in place; call it under ``torch.no_grad()``. Slots are fp32
    like the params.

    - ``sgd`` (``momentum``, ``nesterov``) and ``momentum`` (0.9):
      ``optax.trace``, then the learning rate;
    - ``adam`` / ``adamw`` (weight decay added after the moments) and
      ``lamb`` (adam, the decay, then the trust ratio ``|p| / |u|``, 1
      where either norm is 0);
    - ``adagrad``: ``g / sqrt(Σg² + eps)`` from an accumulator of 0.1;
    - ``rmsprop``: ``g / sqrt(ν + eps)``; ``centered`` subtracts the square
      of the gradient's EMA ``μ`` from ``ν`` (``scale_by_stddev``),
      ``bias_correction`` divides both EMAs by ``1 − decay^t``; then the
      learning rate and, when ``momentum`` is given, a trace of the scaled
      updates;
    - ``lion``: ``sign(b1 m + (1 − b1) g)`` plus the decay, ``m`` an EMA at
      ``b2``;
    - ``adafactor``: second moments factored into row and column means for
      leaves whose two largest dims are at least ``min_dim_size_to_factor``,
      decay ``1 − t^−0.8``, updates clipped at block RMS 1, scaled by the
      learning rate (optional) and by the parameter's RMS (at least 1e-3).

    ``clip_norm`` clips the global gradient norm first; ``learning_rate`` is
    a number or a schedule spec (:func:`make_schedule`)."""

    def __init__(self, kind: str, learning_rate=None, clip_norm: Optional[float] = None,
                 **hparams):
        if kind not in _DEFAULTS:
            raise ValueError(f"unknown optimizer kind {kind!r}")
        unknown = set(hparams) - set(_DEFAULTS[kind])
        if unknown:
            raise TypeError(f"{kind}: unexpected arguments {sorted(unknown)}")
        if learning_rate is None and kind != "adafactor":
            raise TypeError(f"{kind}: learning_rate is required")
        self.kind = kind
        self.hp = {**_DEFAULTS[kind], **hparams}
        # optax's chain holds a count where a schedule sets the rate
        # (checkpoint/names.py).
        self.schedule = isinstance(learning_rate, dict)
        if learning_rate is None:
            self.lr = None
        elif isinstance(learning_rate, dict):
            self.lr = make_schedule(learning_rate)
        else:
            self.lr = lambda count, v=float(learning_rate): v
        self.clip_norm = clip_norm

    def init(self, leaves: Sequence[torch.Tensor],
             layout: Optional[Sequence[Optional[Tuple[int, Tuple[int, ...], str]]]] = None
             ) -> Dict[str, Any]:
        """Slots for ``leaves``; a leaf that is a block of a larger tensor
        (``layout[i] = (dim, full shape, group)``, see :meth:`update`) gets
        block-shaped slots."""
        hp, kind = self.hp, self.kind
        layout = list(layout) if layout is not None else [None] * len(leaves)
        zeros = lambda: [torch.zeros_like(p) for p in leaves]     # noqa: E731
        state: Dict[str, Any] = {"count": 0}
        if kind in ("sgd", "momentum", "rmsprop", "adafactor") and \
                hp["momentum"] is not None:
            state["trace"] = zeros()
        if kind in ("adam", "adamw", "lamb"):
            state["mu"], state["nu"] = zeros(), zeros()
        elif kind == "lion":
            state["mu"] = zeros()
        elif kind == "adagrad":
            state["nu"] = [torch.full_like(p, hp["initial_accumulator_value"])
                           for p in leaves]
        elif kind == "rmsprop":
            state["nu"] = [torch.full_like(p, hp["initial_scale"]) for p in leaves]
            if hp["centered"]:
                state["mu"] = zeros()
        elif kind == "adafactor":
            state["v"] = [self._factored_init(p, _full_shape(p, lay))
                          for p, lay in zip(leaves, layout)]
        return state

    def _factored_init(self, p: torch.Tensor, full_shape) -> Dict[str, torch.Tensor]:
        dims = _factored_dims(full_shape, self.hp["min_dim_size_to_factor"]) \
            if self.hp["factored"] else None
        if dims is None:
            return {"v": torch.zeros_like(p)}
        d1, d0 = dims
        return {"row": torch.zeros_like(p.sum(d0)), "col": torch.zeros_like(p.sum(d1))}

    def _clip(self, grads, layout, psum):
        # optax.clip_by_global_norm: unchanged below the norm, else g / |g| * max.
        # A replicated leaf counts once; the blocks' partial sums add over
        # the ranks of each block's group.
        squares = [torch.sum(g.to(torch.float32) ** 2) for g in grads]
        total = sum(s for s, lay in zip(squares, layout) if lay is None)
        for cut in _by_group(layout).values():
            total = total + psum(sum(squares[i] for i in cut), layout[cut[0]])
        norm = torch.sqrt(total)
        keep = norm < self.clip_norm
        return [torch.where(keep, g, (g / norm.to(g.dtype)) * self.clip_norm)
                for g in grads]

    def _trace(self, state, updates):
        """optax.trace: ``t = u + momentum t``; nesterov adds ``momentum t``
        once more."""
        m = self.hp["momentum"]
        out = []
        for t, u in zip(state["trace"], updates):
            t.mul_(m).add_(u)
            out.append(u + m * t if self.hp["nesterov"] else t.clone())
        return out

    def _rmsprop(self, state, grads, n):
        """optax.scale_by_rms, or scale_by_stddev when ``centered``: the EMA
        of g² (and of g), each divided by ``1 − decay^n`` under
        ``bias_correction``, then ``g / sqrt(ν̂ − μ̂² + eps)``."""
        decay, eps = self.hp["decay"], self.hp["eps"]
        c = None
        if self.hp["bias_correction"]:
            # In fp32, as optax: at n = 1 the centered ν̂ − μ̂² is g²'s
            # rounding, and a correction taken in fp64 can turn it negative.
            c = _bias_correction(decay, n)
        out = []
        for i, (nu, g) in enumerate(zip(state["nu"], grads)):
            # optax's (1 − decay)·g² + decay·ν, product by product: the
            # centered variance at small counts is rounding, which a fused
            # multiply-add would round differently.
            nu.copy_((1.0 - decay) * (g * g) + decay * nu)
            v = nu if c is None else nu / c
            if self.hp["centered"]:
                mu = state["mu"][i]
                mu.copy_((1.0 - decay) * g + decay * mu)
                m = mu if c is None else mu / c
                v = v - m * m
            out.append(g * torch.rsqrt(v + eps) if self.hp["eps_in_sqrt"]
                       else g / (torch.sqrt(v) + eps))
        return out

    def _adam(self, state, grads, n):
        b1, b2, eps, eps_root = (self.hp[k] for k in ("b1", "b2", "eps", "eps_root"))
        c1, c2 = _bias_correction(b1, n), _bias_correction(b2, n)
        out = []
        for mu, nu, g in zip(state["mu"], state["nu"], grads):
            mu.mul_(b1).add_(g, alpha=1.0 - b1)
            nu.mul_(b2).add_(g * g, alpha=1.0 - b2)
            out.append((mu / c1) / (torch.sqrt(nu / c2 + eps_root) + eps))
        return out

    def _factored_rms(self, state, grads, count, layout, psum):
        """optax.factorized.scale_by_factored_rms, leaf by leaf. The factored
        dims are the full tensor's; a mean over the dim a block was cut on
        adds its partial sums over ranks."""
        eps = self.hp["eps"]
        t = float(count - self.hp["decay_offset"] + 1)
        decay = 1.0 - t ** (-self.hp["decay_rate"])
        out = []
        for v, g, lay in zip(state["v"], grads, layout):
            g2 = g * g + eps
            if "v" in v:
                v["v"].mul_(decay).add_(g2, alpha=1.0 - decay)
                out.append(g * v["v"] ** -0.5)
                continue
            full = _full_shape(g, lay)
            cut = lay[0] if lay is not None else None
            d1, d0 = _factored_dims(full, self.hp["min_dim_size_to_factor"])

            def mean(x, dim, orig, keepdim=False):
                if orig != cut:
                    return x.mean(dim, keepdim=keepdim)
                return psum(x.sum(dim, keepdim=keepdim), lay) / full[orig]

            v["row"].mul_(decay).add_(mean(g2, d0, d0), alpha=1.0 - decay)
            v["col"].mul_(decay).add_(mean(g2, d1, d1), alpha=1.0 - decay)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v["row"] / mean(v["row"], reduced_d1, d1, keepdim=True)) ** -0.5
            out.append(g * row_factor.unsqueeze(d0) * (v["col"] ** -0.5).unsqueeze(d1))
        return out

    @staticmethod
    def _rms(xs, layout, psum):
        """Per-leaf root mean square over the full tensors: the blocks'
        partial sums add over the ranks of their group, one reduction a
        group."""
        out = [_rms(x) if lay is None else None for x, lay in zip(xs, layout)]
        for cut in _by_group(layout).values():
            total = psum(torch.stack([torch.sum(xs[i] * xs[i]) for i in cut]), layout[cut[0]])
            for j, i in enumerate(cut):
                out[i] = torch.sqrt(total[j] / math.prod(layout[i][1]))
        return out

    def _adafactor(self, state, grads, params, count, layout, psum):
        hp = self.hp
        updates = self._factored_rms(state, grads, count, layout, psum)
        if hp["clipping_threshold"] is not None:
            rms = self._rms(updates, layout, psum)
            updates = [u / torch.clamp(r / hp["clipping_threshold"], min=1.0)
                       for u, r in zip(updates, rms)]
        if self.lr is not None:
            updates = [self.lr(count) * u for u in updates]
        if hp["multiply_by_parameter_scale"]:
            rms = self._rms(params, layout, psum)
            updates = [u * torch.clamp(r, min=1e-3) for u, r in zip(updates, rms)]
        if hp["momentum"] is not None:
            m = hp["momentum"]
            for t, u in zip(state["trace"], updates):
                t.mul_(m).add_(u, alpha=1.0 - m)
            updates = [t.clone() for t in state["trace"]]
        if hp["weight_decay_rate"] is not None:
            updates = [u + hp["weight_decay_rate"] * p for u, p in zip(updates, params)]
        return [-u for u in updates]

    def update(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
               params: Sequence[torch.Tensor],
               layout: Optional[Sequence[Optional[Tuple[int, Tuple[int, ...], str]]]] = None,
               psum: Optional[Callable[[torch.Tensor, Any], torch.Tensor]] = None
               ) -> List[torch.Tensor]:
        """The updates of ``params`` by ``grads``. Under a sharded update a
        leaf may be one block of a larger tensor: ``layout[i] = (dim, full
        shape, group)`` says which, and ``psum(t, layout[i])`` adds a
        partial sum over the ranks holding the other blocks of that leaf,
        the ``group`` (an all-reduce over the data group, or over the model
        group for a variable split on the model axis; the leaves of one
        group reduce together). The rules that reduce over a whole
        tensor use them: the global norm of ``clip_norm``, lamb's trust
        ratio, adafactor's factored statistics, update clipping and
        parameter scale."""
        grads = list(grads)
        layout = list(layout) if layout is not None else [None] * len(grads)
        if psum is None:
            if any(lay is not None for lay in layout):
                raise ValueError("a sharded update needs psum")
            psum = lambda t, lay: t                             # noqa: E731
        if self.clip_norm is not None:
            grads = self._clip(grads, layout, psum)
        kind, hp = self.kind, self.hp
        count = state["count"]
        state["count"] = count + 1
        if kind == "adafactor":
            return self._adafactor(state, grads, params, count, layout, psum)
        if kind in ("sgd", "momentum") and "trace" in state:
            grads = self._trace(state, grads)
        elif kind in ("adam", "adamw", "lamb"):
            grads = self._adam(state, grads, count + 1)
        elif kind == "adagrad":
            for nu, g in zip(state["nu"], grads):
                nu.add_(g * g)
            grads = [torch.where(nu > 0, torch.rsqrt(nu + hp["eps"]), 0.0) * g
                     for nu, g in zip(state["nu"], grads)]
        elif kind == "rmsprop":
            grads = self._rmsprop(state, grads, count + 1)
        elif kind == "lion":
            b1, b2 = hp["b1"], hp["b2"]
            out = []
            for mu, g in zip(state["mu"], grads):
                out.append(torch.sign((1.0 - b1) * g + b1 * mu))
                mu.mul_(b2).add_(g, alpha=1.0 - b2)
            grads = out
        if kind in ("adamw", "lamb", "lion"):
            grads = [u + hp["weight_decay"] * p for u, p in zip(grads, params)]
        if kind == "lamb":
            grads = _trust_ratios(params, grads, layout, psum)
        updates = [-self.lr(count) * u for u in grads]
        if kind == "rmsprop" and "trace" in state:
            updates = self._trace(state, updates)
        return updates


def _bias_correction(decay: float, n: int) -> float:
    """optax's ``1 - decay ** count`` in fp32: a correctly rounded fp32
    power (XLA's, which ``torch.pow`` is not at every count), then the fp32
    difference. In float64, 1 - 0.999 is 1.3e-5 (relative) off it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(n))


def _full_shape(t: torch.Tensor, lay) -> Tuple[int, ...]:
    """The shape of the tensor ``t`` is a block of (its own without one)."""
    return tuple(lay[1]) if lay is not None else tuple(t.shape)


def _by_group(layout) -> Dict[Any, List[int]]:
    """The positions of the block leaves by the group of ranks holding
    their other blocks (``layout[i][2]``), in order."""
    out: Dict[str, List[int]] = {}
    for i, lay in enumerate(layout):
        if lay is not None:
            out.setdefault(lay[2], []).append(i)
    return out


def _trust_ratios(params, updates, layout, psum):
    """Each update times lamb's trust ratio ``|p| / |u|``; the squared norms
    of the blocks add over the ranks of their group, one reduction a
    group."""
    norms = [None if lay is not None else
             (torch.linalg.vector_norm(p), torch.linalg.vector_norm(u))
             for p, u, lay in zip(params, updates, layout)]
    for cut in _by_group(layout).values():
        total = psum(torch.stack([torch.stack([torch.sum(params[i] * params[i]),
                                               torch.sum(updates[i] * updates[i])])
                                  for i in cut]), layout[cut[0]])
        for j, i in enumerate(cut):
            norms[i] = torch.sqrt(total[j][0]), torch.sqrt(total[j][1])
    return [u * _trust_ratio_from(*nrm) for u, nrm in zip(updates, norms)]


def _trust_ratio_from(pn: torch.Tensor, un: torch.Tensor) -> torch.Tensor:
    """optax.scale_by_trust_ratio's factor from the two norms: ``|p| / |u|``,
    1 where either is 0."""
    zero = (pn == 0.0) | (un == 0.0)
    return torch.where(zero, torch.ones_like(pn), pn / torch.where(zero, 1.0, un))


@dataclass
class OptimizerSpec:
    """Explicit optimizer capture: ``name`` (one of :data:`_DEFAULTS`: sgd,
    momentum, adam, adamw, adagrad, rmsprop, lamb, lion, adafactor) and its
    optax keyword arguments; a ``learning_rate`` given as ``{"schedule":
    ...}`` goes through :func:`make_schedule`. ``clip_norm`` clips the
    global gradient norm before the update."""

    name: str = "sgd"
    kwargs: Dict[str, Any] = field(default_factory=dict)
    clip_norm: Optional[float] = None

    def make(self) -> Optimizer:
        if self.name not in _DEFAULTS:
            raise ValueError(f"unknown optimizer {self.name!r}; known: {sorted(_DEFAULTS)}")
        return Optimizer(self.name, clip_norm=self.clip_norm, **self.kwargs)


# ------------------------------------------------------------ dataflow trace
class _DataflowScan(TorchDispatchMode):
    """Sparse reads and tensor-parallel roles of the leaves (by index):
    ``alias`` maps a tensor standing for a leaf (through views and casts)
    to it, ``reach`` a tensor to the leaves whose contraction output it is
    a pointwise function of (see the module docstring)."""

    def __init__(self, leaf_index: Dict[int, int]):
        super().__init__()
        self.alias = dict(leaf_index)     # id(tensor) -> leaf index
        self.reach: Dict[int, frozenset] = {}
        self.keep: List[torch.Tensor] = []  # holds traced tensors so ids stay unique
        self.sparse: set = set()
        self.roles: Dict[int, str] = {}

    def _taint(self, outs, taint: frozenset) -> None:
        for t in outs:
            self.reach[id(t)] = taint
            self.keep.append(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        src = args[0] if args and isinstance(args[0], torch.Tensor) else None
        idx = self.alias.get(id(src)) if src is not None else None
        if idx is not None and packet in _SPARSE_READS:
            self.sparse.add(idx)
        if packet in _CONTRACTIONS:
            operands = [args[i] for i in _CONTRACTIONS[packet]]
            params = [self.alias[id(t)] for t in operands if id(t) in self.alias]
            rest = [t for t in _pytree_leaves((args, kwargs or {}))
                    if isinstance(t, torch.Tensor) and id(t) not in self.alias]
            act = frozenset().union(*(self.reach.get(id(t), frozenset()) for t in rest))
            if len(params) == 1:
                p = params[0]
                if p not in self.roles:
                    col = any(self.roles.get(q) == "column" for q in act)
                    self.roles[p] = "row" if col else "column"
                # A contraction is a taint boundary: its output is this
                # parameter's linear map (plus addmm's pointwise operand).
                bias = args[0] if packet in (_aten.addmm, _aten.baddbmm) else None
                extra = self.reach.get(id(bias), frozenset()) if bias is not None else frozenset()
                self._taint(outs, frozenset((p,)) | extra)
            else:
                self._taint(outs, act | frozenset(params))
            return out
        if idx is not None and (packet in _ALIASING or func.is_view) and outs:
            self.alias[id(outs[0])] = idx
            self.keep.append(outs[0])
        taint = frozenset().union(*(self.reach.get(id(t), frozenset())
                                    for t in _pytree_leaves((args, kwargs or {}))
                                    if isinstance(t, torch.Tensor)))
        if taint:
            self._taint(outs, taint)
        return out


def _to_meta(tree):
    return map_tree(lambda t: torch.empty_like(t, device="meta"), tree)


class ModelItem:
    """Abstract model description: variables + optimizer."""

    def __init__(self, variables: Sequence[VarItem],
                 optimizer_spec: Optional[OptimizerSpec] = None,
                 batch_size: Optional[int] = None):
        self._variables = list(variables)
        self.optimizer_spec = optimizer_spec or OptimizerSpec()
        self.batch_size = batch_size

    @classmethod
    def from_params(cls, params, optimizer_spec: Optional[OptimizerSpec] = None,
                    loss_fn: Optional[Callable] = None, example_batch=None,
                    sparse_names: Sequence[str] = (),
                    expert_names: Sequence[str] = (),
                    trainable_filter: Optional[Callable[[str], bool]] = None
                    ) -> "ModelItem":
        """One VarItem per leaf of the nested ``params`` dict, in JAX order.
        With ``loss_fn`` + ``example_batch`` the sparse-update parameters
        and the tensor-parallel roles are found by a meta-tensor trace;
        ``sparse_names`` force-marks more; ``expert_names`` marks the expert
        parameters."""
        flat = flatten_params(params)
        detected, roles = set(), {}
        if loss_fn is not None and example_batch is not None:
            detected, roles = cls._trace_analysis(loss_fn, params, example_batch)
        variables = [
            VarItem(name=name, shape=tuple(t.shape), dtype=_dtype_name(t),
                    trainable=trainable_filter(name) if trainable_filter else True,
                    sparse_update=i in detected or _marker_match(name, sparse_names),
                    expert=_marker_match(name, expert_names),
                    tp_role=roles.get(i, "") if t.dim() >= 2 else "")
            for i, (name, t) in enumerate(flat.items())
        ]
        batch_size = None
        if example_batch is not None:
            # The batch dim is the leading dim shared by most batch leaves
            # (smallest on ties), as in the JAX package.
            leaves = tree_leaves(example_batch)
            dims = Counter(int(t.shape[0]) for t in leaves if getattr(t, "shape", ()))
            if dims:
                top = max(dims.values())
                batch_size = min(d for d, c in dims.items() if c == top)
        return cls(variables, optimizer_spec=optimizer_spec, batch_size=batch_size)

    @staticmethod
    def _trace_analysis(loss_fn: Callable, params, example_batch):
        """``(sparse leaf indices, {leaf index: "column" | "row"})`` of one
        meta-tensor forward (JAX's ``ModelItem._trace_analysis``)."""
        meta_params = _to_meta(params)
        meta_batch = _to_meta(example_batch)
        leaf_index = {id(t): i for i, t in enumerate(flatten_params(meta_params).values())}
        scan = _DataflowScan(leaf_index)
        try:
            with torch.no_grad(), scan:
                loss_fn(meta_params, meta_batch)
        except (RuntimeError, NotImplementedError, TypeError, ValueError) as e:
            # Detection is best-effort, as in the JAX package.
            logging.warning("dataflow trace failed (%s); marking none", e)
            return set(), {}
        return scan.sparse, scan.roles

    # -------------------------------------------------------------- accessors
    @property
    def variables(self) -> List[VarItem]:
        return list(self._variables)

    @property
    def trainable_variables(self) -> List[VarItem]:
        return [v for v in self._variables if v.trainable]

    @property
    def sparse_variables(self) -> List[VarItem]:
        return [v for v in self._variables if v.sparse_update]

    def var(self, name: str) -> VarItem:
        for v in self._variables:
            if v.name == name:
                return v
        raise KeyError(name)

    # ---------------------------------------------------------- serialization
    def to_json(self) -> dict:
        """The JAX package's layout: variables (``tp_role`` only where
        set), optimizer, batch size."""
        return {
            "variables": [
                {"name": v.name, "shape": list(v.shape), "dtype": v.dtype,
                 "trainable": v.trainable, "sparse_update": v.sparse_update,
                 "expert": v.expert, **({"tp_role": v.tp_role} if v.tp_role else {})}
                for v in self._variables],
            "optimizer": {
                "name": self.optimizer_spec.name, "kwargs": self.optimizer_spec.kwargs,
                **({"clip_norm": self.optimizer_spec.clip_norm}
                   if self.optimizer_spec.clip_norm is not None else {})},
            **({"batch_size": self.batch_size} if self.batch_size is not None else {}),
        }

    @classmethod
    def from_json(cls, d: dict) -> "ModelItem":
        return cls([VarItem(name=v["name"], shape=tuple(v["shape"]), dtype=v["dtype"],
                            trainable=v.get("trainable", True),
                            sparse_update=v.get("sparse_update", False),
                            expert=v.get("expert", False), tp_role=v.get("tp_role", ""))
                    for v in d.get("variables", [])],
                   optimizer_spec=OptimizerSpec(**d.get("optimizer", {})),
                   batch_size=d.get("batch_size"))
