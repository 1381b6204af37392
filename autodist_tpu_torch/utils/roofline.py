"""Roofline bounds from the program itself: HBM traffic and FLOPs of one
call, counted from its aten ops (PyTorch port of ``utils/roofline.py``).

The JAX package walks a function's jaxpr. The port walks the aten ops that
one call of the function dispatches, under a ``TorchDispatchMode``, on meta
tensors: the example arguments are replaced by meta tensors of the same
shapes and dtypes (``requires_grad`` kept), so nothing executes and nothing
in the walk depends on the device the real call would run on. Every op of
the call is seen, the backward's too when the function runs autograd.

The port's training kernels (``ops/flash_attention.py``,
``ops/fused_conv_stats.py``) run their plain PyTorch versions on meta
tensors inside :func:`kernel_call`: a kernel's FLOPs are its plain
version's (the flash backward's recomputation of the scores is in the
count), its bytes are the kernel's own, each input read once and each
output written once, and its outputs materialise; what the plain version
makes on the way (the scores a kernel keeps on chip) is not counted as
traffic.

- ``flops``: 2 x the multiply-adds of every ``mm``, ``addmm``, ``bmm``,
  ``baddbmm``, ``convolution`` and ``convolution_backward``, by
  ``torch.utils.flop_counter``'s formulas. Elementwise work is not counted
  (the JAX walk counts dots and convolutions only, as here).
- ``upper_bytes`` (zero fusion): every op's tensor inputs plus outputs. A
  view (an op whose outputs alias its inputs: ``view``, ``t``,
  ``expand``, ``detach``) moves no bytes and is skipped.
- ``lower_bytes`` (perfect fusion): the arguments read once, the outputs
  written once, and twice each intermediate that a materialising op
  writes (written by it, read by its consumer). The materialising ops are
  the JAX walk's ``_MATERIALIZE_PRIMS`` in aten: the products
  (``mm``/``addmm``/``bmm``/``baddbmm``/``convolution`` and its backward),
  the port's kernels (their calls and ``autodist_tpu_torch::*`` ops), gathers
  (``embedding``, ``index_select``, ``gather``), scatters (``scatter``,
  ``scatter_add``, ``scatter_reduce``, ``index_add``, ``index_put``,
  ``embedding_dense_backward``), ``sort``/``topk``, the cumulative ops and
  the c10d collectives.
- ``arg_bytes`` / ``out_bytes``: the example arguments' and the result's
  tensors.

:func:`roofline_times` turns the envelopes into times. It keeps the JAX
package's keys so a reader of the JAX schema reads the port's numbers:
``t_mxu_s`` is the time of the FLOPs at the peak of the tensor cores (the
TPU's matrix unit in the JAX package), ``t_hbm_lower_s`` /
``t_hbm_upper_s`` the two byte envelopes at the memory's rate, and
``t_roofline_s`` the larger of ``t_mxu_s`` and ``t_hbm_lower_s``.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

__all__ = ["traffic_bounds", "roofline_times", "OpWalk", "kernel_call", "to_meta"]

_aten = torch.ops.aten
#: Ops whose 2·MACs are the walk's FLOPs (``torch.utils.flop_counter``).
_FLOP_OPS = frozenset((_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm,
                       _aten.convolution, _aten._convolution,
                       _aten.convolution_backward))
#: Ops whose outputs materialise under any fusion (see the module docstring).
_MATERIALIZE_OPS = _FLOP_OPS | frozenset((
    _aten.embedding, _aten.index_select, _aten.gather,
    _aten.scatter, _aten.scatter_add, _aten.scatter_reduce, _aten.index_add,
    _aten.index_put, _aten.embedding_dense_backward,
    _aten.sort, _aten.topk,
    _aten.cumsum, _aten.cumprod, _aten.logcumsumexp, _aten.cummax, _aten.cummin))
#: Op namespaces that materialise: the port's kernels and the collectives.
_MATERIALIZE_NAMESPACES = frozenset(("autodist_tpu_torch", "_c10d_functional",
                                     "_c10d_functional_autograd", "c10d"))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _is_view(func) -> bool:
    """True when every output of ``func`` aliases an input without writing
    it (a view: no bytes move)."""
    returns = func._schema.returns
    return bool(returns) and all(r.alias_info is not None and not r.alias_info.is_write
                                 for r in returns)


def _fresh_outputs(func, out) -> List[torch.Tensor]:
    """The outputs of ``func`` that are new tensors (not an alias of an
    input, as an in-place op's or a view's are)."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    returns = func._schema.returns
    fresh = []
    for i, t in enumerate(outs):
        if not isinstance(t, torch.Tensor):
            continue
        alias = returns[i].alias_info if i < len(returns) else None
        if alias is None:
            fresh.append(t)
    return fresh


def _flops(func, args, kwargs, out) -> int:
    formula = flop_registry.get(func.overloadpacket)
    if formula is None:
        return 0
    return int(formula(*args, **kwargs, out_val=out))


class OpWalk(TorchDispatchMode):
    """The dispatch mode of the walk: adds up ``flops`` and
    ``unfused_bytes`` over the ops it sees and keeps a weak reference to
    each output of a materialising op (``materialized``). Inside a
    :func:`kernel_call` only FLOPs are added. While :meth:`saving` is
    entered, the bytes autograd saves for the backward are summed in
    ``saved_bytes`` (each storage once, those in ``exclude`` not at all)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.unfused_bytes = 0
        self.materialized: List[Tuple[Any, int]] = []
        self.saved_bytes = 0
        self._saved: set = set()
        self._in_kernel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet in _FLOP_OPS:
            self.flops += _flops(func, args, kwargs, out)
        if self._in_kernel:
            return out
        if not _is_view(func):
            self.unfused_bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.unfused_bytes += sum(_nbytes(t) for t in _tensors(out))
        if packet in _MATERIALIZE_OPS or func.namespace in _MATERIALIZE_NAMESPACES:
            self._materialize(_fresh_outputs(func, out))
        return out

    def _materialize(self, outs) -> None:
        self.materialized += [(weakref.ref(t), _nbytes(t)) for t in outs]

    def saving(self, exclude=()):
        """A ``saved_tensors_hooks`` context that sums the bytes of the
        tensors autograd saves (storages in ``exclude`` not counted)."""
        self._saved = {_storage_key(t) for t in exclude if isinstance(t, torch.Tensor)}

        def pack(t):
            key = _storage_key(t)
            if key not in self._saved:
                self._saved.add(key)
                self.saved_bytes += t.untyped_storage().nbytes()
            return t

        return torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t)

    def intermediate_bytes(self, outputs) -> int:
        """Twice the bytes of each materialised output that is not one of
        ``outputs`` (an intermediate is written, then read)."""
        outs = {id(t) for t in outputs}
        total = 0
        for ref, nbytes in self.materialized:
            t = ref()
            if t is None or id(t) not in outs:
                total += 2 * nbytes
        return total


def _active_walk() -> Optional[OpWalk]:
    """The innermost walk on this thread's dispatch-mode stack. Torch keeps
    that stack per thread (and hands it to the threads that run a
    backward), so a kernel called on another thread is not counted here."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpWalk):
            return mode
    return None


def kernel_call(plain: Callable, *args: Any) -> Any:
    """``plain(*args)``, a kernel's plain version standing in for it on
    meta tensors: inside a walk its FLOPs count, and its bytes are the
    kernel's (each tensor argument read once, each output written once,
    the outputs materialised); outside a walk of this thread it is just the
    call."""
    walk = _active_walk()
    if walk is None:
        return plain(*args)
    walk._in_kernel += 1
    try:
        out = plain(*args)
    finally:
        walk._in_kernel -= 1
    if not walk._in_kernel:
        outs = _tensors(out)
        walk.unfused_bytes += sum(_nbytes(t) for t in _tensors(args) + outs)
        walk._materialize(outs)
    return out


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def to_meta(tree):
    """``tree`` with every tensor (and numpy array) replaced by a meta
    tensor of its shape and dtype; ``requires_grad`` is kept."""
    def leaf(x):
        if isinstance(x, np.ndarray):
            x = torch.as_tensor(x)
        if isinstance(x, torch.Tensor):
            m = torch.empty(x.shape, dtype=x.dtype, device="meta")
            return m.requires_grad_(True) if x.requires_grad else m
        return x

    return tree_map(leaf, tree)


def traffic_bounds(fn: Callable, *example_args: Any) -> Dict[str, float]:
    """HBM traffic and FLOP envelopes of one call of ``fn`` on
    ``example_args`` (tensors, numpy arrays or pytrees of them), walked on
    meta tensors (module docstring). ``fn`` must not read a tensor's
    values (``.item()``, data-dependent branches): nothing executes."""
    args = to_meta(example_args)
    walk = OpWalk()
    with walk:
        out = fn(*args)
    arg_bytes = sum(_nbytes(t) for t in _tensors(args))
    outs = _tensors(out)
    out_bytes = sum(_nbytes(t) for t in outs)
    return {
        "flops": float(walk.flops),
        "lower_bytes": float(arg_bytes + out_bytes + walk.intermediate_bytes(outs)),
        "upper_bytes": float(walk.unfused_bytes),
        "arg_bytes": float(arg_bytes),
        "out_bytes": float(out_bytes),
    }


def roofline_times(bounds: Dict[str, float], peak_flops: Optional[float],
                   bw_bytes_per_s: float) -> Dict[str, float]:
    """The envelopes as times of one call: ``t_mxu_s`` (FLOPs at the
    tensor cores' peak), ``t_hbm_lower_s`` / ``t_hbm_upper_s`` (bytes at
    ``bw_bytes_per_s``) and ``t_roofline_s``, the larger of ``t_mxu_s``
    and ``t_hbm_lower_s``."""
    t_mxu = bounds["flops"] / peak_flops if peak_flops else float("nan")
    t_hbm_lower = bounds["lower_bytes"] / bw_bytes_per_s
    t_hbm_upper = bounds["upper_bytes"] / bw_bytes_per_s
    return {
        "t_mxu_s": t_mxu,
        "t_hbm_lower_s": t_hbm_lower,
        "t_hbm_upper_s": t_hbm_upper,
        "t_roofline_s": max(t_mxu, t_hbm_lower),
    }
