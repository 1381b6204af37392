"""Model IR: the description strategies are built against (PyTorch port).

The port's copy of the JAX package's ``model_item.py``. A model is a nested
dict of parameter tensors plus a loss function; ``ModelItem`` records one
``VarItem`` per leaf (name = ``"/"``-joined keys, in ``jax.tree_util``'s
sorted leaf order, shape, dtype, trainable and sparse-update flags) and the
optimizer as an explicit :class:`OptimizerSpec`.

Sparse-update detection traces one forward of the loss on ``meta`` tensors
(shapes only, nothing is computed or allocated) under a
``TorchDispatchMode``: a parameter read by a row gather (``aten.index``,
``index_select``, ``embedding``, ``gather``), directly or through a view or
a dtype cast, is sparse — the JAX package's jaxpr ``gather`` scan, which
marks the same parameters.

:meth:`OptimizerSpec.make` writes optax's update rules out as tensor code
(:class:`Optimizer`), defaults included: ``sgd`` (the default),
``momentum``, ``adam``, ``adamw`` (weight decay 1e-4), global-norm clipping
(``clip_norm``) and the ``constant`` / ``warmup_polynomial`` learning-rate
schedules (the BERT recipe). The other optimizers and schedules, and the
tensor-parallel role inference, are in ROADMAP.md.
"""
from __future__ import annotations

import math
import re
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from autodist_tpu_torch.models.convert import flatten_params, map_params
from autodist_tpu_torch.utils import logging

_aten = torch.ops.aten
# Row-gather reads of their first operand (the JAX scan's gather/take).
_SPARSE_READS = (_aten.index, _aten.index_select, _aten.embedding, _aten.gather)
# Ops whose output stands for their input (dtype casts and copies; views are
# recognised by their schema).
_ALIASING = (_aten._to_copy, _aten.clone, _aten.detach, _aten.alias)


def _marker_match(name: str, markers: Sequence[str]) -> bool:
    """A ``sparse_names`` marker matches at a path-component boundary: "embed" matches
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

    @property
    def size(self) -> int:
        return math.prod(self.shape) if self.shape else 1

    @property
    def byte_size(self) -> int:
        """Payload bytes: the load metric of PS load balancing."""
        return self.size * getattr(torch, self.dtype).itemsize


# ------------------------------------------------------------------ schedules
def make_schedule(spec: Dict[str, Any]) -> Callable[[int], float]:
    """A schedule spec ``{"schedule": <name>, ...}`` -> ``count -> value``,
    optax's formulas: ``constant`` and ``warmup_polynomial`` (linear warmup
    from ``init_value`` to ``peak_value`` over ``warmup_steps``, then
    polynomial decay to ``end_value`` until ``decay_steps``, the total)."""
    d = dict(spec)
    name = d.pop("schedule")
    if name == "constant":
        value = float(d["value"])
        return lambda count: value
    if name == "warmup_polynomial":
        warmup, total = int(d["warmup_steps"]), int(d["decay_steps"])
        if total <= warmup:
            raise ValueError(f"warmup_polynomial: decay_steps ({total}) is the total "
                             f"schedule length and must exceed warmup_steps ({warmup})")
        init, peak = float(d.get("init_value", 0.0)), float(d["peak_value"])
        end, power = float(d.get("end_value", 0.0)), float(d.get("power", 1.0))

        def poly(count, v0, v1, steps, p):
            frac = 1.0 - min(max(count, 0), steps) / steps
            return (v0 - v1) * frac ** p + v1

        def schedule(count):
            if count < warmup:
                return poly(count, init, peak, warmup, 1.0)
            return poly(count - warmup, peak, end, total - warmup, power)
        return schedule
    raise ValueError(f"unknown schedule {name!r}; ported: constant, warmup_polynomial "
                     "(the others are in ROADMAP.md)")


# ----------------------------------------------------------------- optimizer
class Optimizer:
    """optax's update rules as tensor code over a list of leaves (in
    :func:`flatten_params` order). ``update`` returns the updates to add to
    the params and advances ``state`` in place; call it under
    ``torch.no_grad()``. Slots are fp32 like the params."""

    _KINDS = ("sgd", "momentum", "adam", "adamw")

    def __init__(self, kind: str, learning_rate, momentum: Optional[float] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4, clip_norm: Optional[float] = None):
        if kind not in self._KINDS:
            raise ValueError(f"unknown optimizer kind {kind!r}")
        self.kind = kind
        self.lr = (make_schedule(learning_rate) if isinstance(learning_rate, dict)
                   else (lambda count, v=float(learning_rate): v))
        self.momentum = momentum
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, leaves: Sequence[torch.Tensor]) -> Dict[str, Any]:
        state: Dict[str, Any] = {"count": 0}
        if self.kind == "momentum" or (self.kind == "sgd" and self.momentum is not None):
            state["trace"] = [torch.zeros_like(p) for p in leaves]
        if self.kind in ("adam", "adamw"):
            state["mu"] = [torch.zeros_like(p) for p in leaves]
            state["nu"] = [torch.zeros_like(p) for p in leaves]
        return state

    def _clip(self, grads):
        # optax.clip_by_global_norm: unchanged below the norm, else g / |g| * max.
        norm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads))
        keep = norm < self.clip_norm
        return [torch.where(keep, g, (g / norm.to(g.dtype)) * self.clip_norm)
                for g in grads]

    def update(self, grads: Sequence[torch.Tensor], state: Dict[str, Any],
               params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        grads = list(grads)
        if self.clip_norm is not None:
            grads = self._clip(grads)
        count = state["count"]
        if "trace" in state:
            # optax.trace: t = g + momentum * t.
            for t, g in zip(state["trace"], grads):
                t.mul_(self.momentum).add_(g)
            grads = list(state["trace"])
        if self.kind in ("adam", "adamw"):
            n = count + 1
            c1 = 1.0 - self.b1 ** n
            c2 = 1.0 - self.b2 ** n
            out = []
            for mu, nu, g in zip(state["mu"], state["nu"], grads):
                mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                nu.mul_(self.b2).add_(g * g, alpha=1.0 - self.b2)
                out.append((mu / c1) / (torch.sqrt(nu / c2) + self.eps))
            grads = out
            if self.kind == "adamw":
                grads = [u + self.weight_decay * p for u, p in zip(grads, params)]
        step_size = -self.lr(count)
        state["count"] = count + 1
        return [step_size * u for u in grads]


@dataclass
class OptimizerSpec:
    """Explicit optimizer capture: ``name`` (sgd | momentum | adam | adamw)
    and its optax keyword arguments; a ``learning_rate`` given as
    ``{"schedule": ...}`` goes through :func:`make_schedule`.
    ``clip_norm`` clips the global gradient norm before the update."""

    name: str = "sgd"
    kwargs: Dict[str, Any] = field(default_factory=dict)
    clip_norm: Optional[float] = None

    def make(self) -> Optimizer:
        kw = dict(self.kwargs)
        if self.name not in Optimizer._KINDS:
            raise ValueError(f"unknown optimizer {self.name!r}; ported: "
                             f"{sorted(Optimizer._KINDS)} (the others are in ROADMAP.md)")
        if self.name == "momentum":
            kw.setdefault("momentum", 0.9)
        return Optimizer(self.name, clip_norm=self.clip_norm, **kw)


# ------------------------------------------------------------ sparse tracing
class _SparseReadScan(TorchDispatchMode):
    """Marks leaves (by index) read by a row gather, through views/casts."""

    def __init__(self, leaf_index: Dict[int, int]):
        super().__init__()
        self.alias = dict(leaf_index)     # id(tensor) -> leaf index
        self.keep: List[torch.Tensor] = []  # holds aliased tensors so ids stay unique
        self.sparse: set = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        src = args[0] if args and isinstance(args[0], torch.Tensor) else None
        idx = self.alias.get(id(src)) if src is not None else None
        if idx is not None:
            if func.overloadpacket in _SPARSE_READS:
                self.sparse.add(idx)
            elif (func.overloadpacket in _ALIASING or func.is_view) and \
                    isinstance(out, torch.Tensor):
                self.alias[id(out)] = idx
                self.keep.append(out)
        return out


def _to_meta(tree):
    if isinstance(tree, dict):
        return map_params(lambda t: torch.empty_like(t, device="meta"), tree)
    return torch.empty_like(tree, device="meta")


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
                    trainable_filter: Optional[Callable[[str], bool]] = None
                    ) -> "ModelItem":
        """One VarItem per leaf of the nested ``params`` dict, in JAX order.
        With ``loss_fn`` + ``example_batch`` the sparse-update parameters
        are detected from a meta-tensor trace; ``sparse_names`` force-marks
        more."""
        flat = flatten_params(params)
        detected = set()
        if loss_fn is not None and example_batch is not None:
            detected = cls._trace_sparse(loss_fn, params, example_batch)
        variables = [
            VarItem(name=name, shape=tuple(t.shape), dtype=_dtype_name(t),
                    trainable=trainable_filter(name) if trainable_filter else True,
                    sparse_update=i in detected or _marker_match(name, sparse_names))
            for i, (name, t) in enumerate(flat.items())
        ]
        batch_size = None
        if example_batch is not None:
            # The batch dim is the leading dim shared by most batch leaves
            # (smallest on ties), as in the JAX package.
            leaves = flatten_params(example_batch).values() \
                if isinstance(example_batch, dict) else [example_batch]
            dims = Counter(int(t.shape[0]) for t in leaves if getattr(t, "shape", ()))
            if dims:
                top = max(dims.values())
                batch_size = min(d for d, c in dims.items() if c == top)
        return cls(variables, optimizer_spec=optimizer_spec, batch_size=batch_size)

    @staticmethod
    def _trace_sparse(loss_fn: Callable, params, example_batch) -> set:
        """Leaf indices read by a row gather in one meta-tensor forward."""
        meta_params = _to_meta(params)
        meta_batch = _to_meta(example_batch)
        leaf_index = {id(t): i for i, t in enumerate(flatten_params(meta_params).values())}
        scan = _SparseReadScan(leaf_index)
        try:
            with torch.no_grad(), scan:
                loss_fn(meta_params, meta_batch)
        except (RuntimeError, NotImplementedError, TypeError, ValueError) as e:
            # Detection is best-effort, as in the JAX package.
            logging.warning("sparse-update trace failed (%s); marking none", e)
            return set()
        return scan.sparse

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
