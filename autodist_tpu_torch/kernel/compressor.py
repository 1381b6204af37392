"""Gradient compressors: fewer bits on the wire of the gradient sync
(PyTorch port of ``kernel/compressor.py``).

Each compressor owns one variable's compress -> collective -> decompress
sequence. ``step(grad, local, shared, coll)`` takes this rank's local-mean
gradient and returns the synced global-mean gradient (the same on every
rank) with the new per-rank and shared state; the collectives go through
``coll`` (``runtime.process_group.Collectives``), counted under the purpose
``grad``. Without a group ``coll`` is the identity, so one process computes
the compressor at world size 1.

- ``NoneCompressor``: a mean all-reduce in full precision.
- ``HorovodCompressor``: the all-reduce runs on a bf16 copy of the
  gradient (half the bytes), summed in bf16 and divided in fp32.
- ``HorovodCompressorEF``: the same wire plus error feedback: this rank's
  rounding error ``inp - fp32(bf16(inp))`` is kept and added to the next
  step's gradient.
- ``PowerSGDCompressor``: rank-r power iteration with a warm-started ``q``
  (shared) and error feedback; two all-reduces of the factors.
- ``TopKCompressor``: the ``ratio`` largest-magnitude entries of each rank
  (after error feedback), all-gathered as (value, int32 index) pairs and
  scatter-added in rank order.

Per-rank state (the EF residuals) is this rank's own tensor; the JAX
package keeps the ranks' residuals under a leading data-axis dimension.
``wire_factor`` is the JAX function's arithmetic, unchanged.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from autodist_tpu_torch.utils import prng

State = Dict[str, torch.Tensor]


def _zeros(var) -> torch.Tensor:
    return torch.zeros(tuple(var.shape), dtype=getattr(torch, var.dtype))


class Compressor:
    """One gradient leaf's compress -> collective -> decompress policy."""

    name = "Compressor"

    def init_local(self, var) -> State:
        """Per-rank persistent state (CPU tensors; the step places them)."""
        return {}

    def init_shared(self, var) -> State:
        """State that is the same on every rank (CPU tensors)."""
        return {}

    def step(self, grad: torch.Tensor, local: State, shared: State,
             coll) -> Tuple[torch.Tensor, State, State]:
        raise NotImplementedError

    def collectives(self, shape: Tuple[int, ...]) -> Dict[str, int]:
        """The collectives ``step`` issues for a gradient of ``shape``, by
        kind (``ShardingPlan.collectives_per_step`` adds them up)."""
        return {"all_reduce": 1}

    def wire_factor(self, shape: Tuple[int, ...], nshards: int = 1) -> float:
        """Collective payload bytes under this compressor over the dense
        fp32 all-reduce's, for a gradient of ``shape`` over ``nshards``
        ranks (the JAX package's formula)."""
        return 1.0


def _mean_all_reduce(grad: torch.Tensor, coll) -> torch.Tensor:
    out = grad.contiguous().clone()
    coll.all_reduce(out, "grad", mean=True)
    return out


class NoneCompressor(Compressor):
    """The identity: a full-precision mean all-reduce."""

    name = "NoneCompressor"

    def step(self, grad, local, shared, coll):
        return _mean_all_reduce(grad, coll), local, shared


class HorovodCompressor(Compressor):
    """Cast for transport: the all-reduce runs on bf16 payloads."""

    name = "HorovodCompressor"
    wire_dtype = torch.bfloat16

    def _sync(self, compressed: torch.Tensor, coll, dtype) -> torch.Tensor:
        """The bf16 payload summed over ranks in place, widened to
        ``dtype`` and divided."""
        coll.all_reduce(compressed, "grad")
        return compressed.to(dtype) / coll.size

    def step(self, grad, local, shared, coll):
        compressed = grad.to(self.wire_dtype).contiguous()
        return self._sync(compressed, coll, grad.dtype), local, shared

    def wire_factor(self, shape, nshards=1):
        itemsize = torch.empty((), dtype=self.wire_dtype).element_size()
        return itemsize / torch.empty((), dtype=torch.float32).element_size()


class HorovodCompressorEF(HorovodCompressor):
    """Cast transport plus error feedback: ``residual = inp -
    fp32(bf16(inp))``, added to the next step's gradient."""

    name = "HorovodCompressorEF"

    def init_local(self, var):
        return {"residual": _zeros(var)}

    def step(self, grad, local, shared, coll):
        inp = grad + local["residual"].to(grad.dtype)
        compressed = inp.to(self.wire_dtype).contiguous()
        residual = inp - compressed.to(grad.dtype)
        return self._sync(compressed, coll, grad.dtype), {"residual": residual}, shared


class PowerSGDCompressor(Compressor):
    """Rank-r PowerSGD with error feedback. For a gradient reshaped to M
    (m x k): P = M Q (summed, then orthonormalised by QR), Qn = M^T P
    (summed, averaged), M^ = P Qn^T. Q persists across steps; the residual
    carries the approximation error. Rank-0/1 tensors take the plain mean
    all-reduce. The initial Q is JAX's draw, ``jax.random.normal(
    PRNGKey(seed), (k, r))`` (``utils/prng.py``: the bits exactly, the
    floats within a few ulps), orthonormalised by QR and broadcast from
    rank 0 by the step."""

    name = "PowerSGDCompressor"

    def __init__(self, rank: int = 2, seed: int = 0):
        self.rank = rank
        self.seed = seed

    @staticmethod
    def _matrix_shape(shape) -> Tuple[int, int]:
        return shape[0], math.prod(shape[1:])

    def init_local(self, var):
        return {"residual": _zeros(var)} if len(var.shape) >= 2 else {}

    def init_shared(self, var):
        if len(var.shape) < 2:
            return {}
        _, k = self._matrix_shape(var.shape)
        r = min(self.rank, k, var.shape[0])
        q = prng.normal(prng.prng_key(self.seed), (k, r)).to(getattr(torch, var.dtype))
        return {"q": torch.linalg.qr(q).Q}

    def step(self, grad, local, shared, coll):
        if grad.dim() < 2:
            return _mean_all_reduce(grad, coll), local, shared
        m_rows, k = self._matrix_shape(grad.shape)
        inp = grad + local["residual"]
        mat = inp.reshape(m_rows, k)
        p = (mat @ shared["q"]).contiguous()
        coll.all_reduce(p, "grad")
        p = torch.linalg.qr(p).Q
        qn = (mat.T @ p).contiguous()
        coll.all_reduce(qn, "grad")
        qn = qn / coll.size
        approx = (p @ qn.T).reshape(grad.shape)
        return approx, {"residual": inp - approx}, {"q": qn}

    def collectives(self, shape):
        return {"all_reduce": 2 if len(shape) >= 2 else 1}

    def wire_factor(self, shape, nshards=1):
        """(m + k) r / (m k), not clamped at 1; rank-0/1 gradients 1."""
        if len(shape) < 2:
            return 1.0
        m_rows, k = self._matrix_shape(shape)
        r = min(self.rank, k, m_rows)
        return (m_rows + k) * r / (m_rows * k)


class TopKCompressor(Compressor):
    """Magnitude top-k with error feedback. Each rank adds its residual,
    keeps its ``ratio`` largest-magnitude entries and all-gathers them as
    (value, int32 index) pairs; every rank scatter-adds the gathered pairs
    in rank order into zeros and divides by the ranks. What a rank did not
    send stays in its residual. Below ``min_size`` elements the plain mean
    all-reduce runs."""

    name = "TopKCompressor"

    def __init__(self, ratio: float = 0.01, min_size: int = 4096):
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"ratio must be in (0, 1], got {ratio}")
        self.ratio = ratio
        self.min_size = min_size

    def _k(self, shape) -> int:
        return max(1, int(math.prod(shape) * self.ratio))

    def init_local(self, var):
        return {"residual": _zeros(var)} if math.prod(var.shape) >= self.min_size else {}

    def step(self, grad, local, shared, coll):
        if grad.numel() < self.min_size:
            return _mean_all_reduce(grad, coll), local, shared
        k = self._k(grad.shape)
        flat = (grad + local["residual"]).reshape(-1)
        idx = torch.topk(flat.abs(), k, sorted=True).indices
        vals = flat[idx].contiguous()
        residual = flat.index_fill(0, idx, 0.0).reshape(grad.shape)
        all_vals = coll.all_gather(vals, 0, "grad")
        all_idx = coll.all_gather(idx.to(torch.int32).contiguous(), 0, "grad")
        dense = torch.zeros_like(flat).index_add_(0, all_idx, all_vals) / coll.size
        return dense.reshape(grad.shape), {"residual": residual}, shared

    def collectives(self, shape):
        if math.prod(shape) < self.min_size:
            return {"all_reduce": 1}
        return {"all_gather": 2}

    def wire_factor(self, shape, nshards=1):
        """k n / N (values f32 + indices i32 gathered from n ranks against
        the dense fp32 all-reduce), not clamped at 1; 1 below
        ``min_size``."""
        if math.prod(shape) < self.min_size:
            return 1.0
        return self._k(shape) * max(nshards, 1) / math.prod(shape)


_REGISTRY = {
    "NoneCompressor": NoneCompressor,
    "HorovodCompressor": HorovodCompressor,
    "HorovodCompressorEF": HorovodCompressorEF,
    "PowerSGDCompressor": PowerSGDCompressor,
    "TopKCompressor": TopKCompressor,
}

#: Strategy-IR aliases (``AllReduce(compressor="bf16")``).
_ALIASES = {
    "none": "NoneCompressor",
    "bf16": "HorovodCompressor",
    "ef": "HorovodCompressorEF",
    "powersgd": "PowerSGDCompressor",
    "topk": "TopKCompressor",
}


def canonical_compressor_name(name: str) -> str:
    """An IR name with its alias resolved to the registry name."""
    return _ALIASES.get(name, name)


def is_active_compressor(name: Optional[str]) -> bool:
    """True unless ``name`` is empty or (an alias of) the identity."""
    return canonical_compressor_name(name or "") not in ("", "NoneCompressor")


def get_compressor(name: str) -> Compressor:
    """A compressor by IR name or alias; ``ValueError`` for others."""
    name = canonical_compressor_name(name)
    if name not in _REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; known: {sorted(_REGISTRY)} "
                         f"(aliases: {sorted(_ALIASES)})")
    return _REGISTRY[name]()
