"""Carry parameters between the JAX package and the port.

The JAX package's params are a pytree of arrays; handed over as plain nested
dicts of ``np.ndarray`` (``jax.tree.map(np.asarray, params)``), they become
the port's nested dict of tensors with the same keys and layouts
(:func:`params_from_jax`), and back (:func:`params_to_numpy`). The train
state's compressor and staleness state carry over the same way, cut to one
rank's part (:func:`comp_state_from_jax`, :func:`stale_state_from_jax`). Flat names
follow the JAX package's ``model_item._path_to_name`` (``"/"``-joined keys,
e.g. ``"layers_0/attn/wq/kernel"``) and its leaf order: ``jax.tree_util``
flattens a dict in sorted key order (``layers_10`` before ``layers_2``), and
so does :func:`flatten_params`, so variable lists and the groups strategies
cut from them agree between the packages. No jax is imported here.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from autodist_tpu_torch.utils.device import resolve_device


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    ``device`` (default ``"cuda"``), dtypes kept."""
    dev = resolve_device(device)
    return map_params(lambda x: torch.as_tensor(np.array(x, copy=True), device=dev),
                      tree)


def comp_state_from_jax(comp_state: Dict[str, Any], rank: int = 0,
                        device=None) -> Dict[str, Any]:
    """The JAX step's ``TrainState.comp_state`` as numpy (``{var: {"local":
    {k: [n, ...]}, "shared": {k: ...}}}``) -> rank ``rank``'s compressor
    state in the port: each local leaf's row ``rank`` (that rank's EF
    residual), the shared leaves (PowerSGD's ``q``) whole."""
    dev = resolve_device(device)

    def tensor(x):
        return torch.as_tensor(np.array(x, copy=True), device=dev)

    return {name: {"local": {k: tensor(np.asarray(v)[rank]) for k, v in st["local"].items()},
                   "shared": {k: tensor(v) for k, v in st["shared"].items()}}
            for name, st in comp_state.items()}


def stale_state_from_jax(stale_state: Dict[str, Any],
                         renderings: Dict[str, Tuple[str, Optional[int]]],
                         n: int = 1, rank: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """The JAX step's ``TrainState.stale_state`` as numpy (``{var: [K,
    *storage shape]}``) -> rank ``rank``'s delay buffers in the port:
    shaped like the gradient its optimizer sees, the block ``rank`` of
    ``n`` along the sharded dim for a ``"zero1"`` or ``"sharded"``
    rendering (``renderings[var] = (kind, dim)``, as
    ``ShardingPlan.rendering`` gives), the whole buffer otherwise."""
    dev = resolve_device(device)
    out = {}
    for name, buf in stale_state.items():
        buf = np.asarray(buf)
        kind, dim = renderings.get(name, ("replicated", None))
        if kind != "replicated":
            step = buf.shape[dim + 1] // n
            buf = np.take(buf, np.arange(rank * step, (rank + 1) * step), axis=dim + 1)
        out[name] = torch.as_tensor(np.array(buf, copy=True), device=dev)
    return out


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dict of tensors -> the same nesting of numpy arrays on the host
    (bf16 widened to fp32: numpy has no bf16)."""
    def conv(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return map_params(conv, params)


def map_params(fn: Callable[..., Any], params: Any, *rest: Any) -> Any:
    """``fn`` applied to every leaf, nesting and key order kept; with
    ``rest`` (trees of the same nesting), ``fn`` takes the matching leaves
    of each too. A root that is not a dict is one leaf."""
    if not isinstance(params, dict):
        return fn(params, *rest)
    return {k: map_params(fn, v, *(r[k] for r in rest)) for k, v in params.items()}


def map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of a batch-like tree: nested dicts, lists and
    tuples (anything else is a leaf)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def to_tensor(x: Any) -> torch.Tensor:
    """A batch leaf as a tensor: a tensor as it is, a numpy array (or
    array-like) as a CPU tensor sharing its memory where numpy allows (a
    read-only or non-contiguous array is copied)."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    if not x.flags.writeable or not x.flags.c_contiguous:
        x = np.array(x, copy=True, order="C")
    return torch.from_numpy(x)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of :func:`map_tree`'s trees, in its order."""
    out: List[Any] = []
    map_tree(out.append, tree)
    return out


def flatten_params(params: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested params -> ``{"a/b/c": leaf}`` in ``jax.tree_util``'s leaf order
    (keys sorted at every level), named as ``model_item._path_to_name``."""
    out: Dict[str, Any] = {}
    for k in sorted(params):
        v = params[k]
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_params(v, name))
        else:
            out[name] = v
    return out


def unflatten_params(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_params`: ``{"a/b/c": leaf}`` -> nested dicts."""
    out: Dict[str, Any] = {}
    for name, leaf in flat.items():
        node = out
        *head, last = name.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out
