"""Carry JAX-package parameters into the port.

The JAX package's params are a pytree of arrays; handed over as plain nested
dicts of ``np.ndarray`` (``jax.tree.map(np.asarray, params)``), they become
the port's nested dict of tensors with the same keys and layouts. Flat names
follow the JAX package's ``model_item._path_to_name`` (``"/"``-joined keys,
e.g. ``"layers_0/attn/wq/kernel"``), so checkpoints can interchange.
No jax is imported here.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from autodist_tpu_torch.utils.device import resolve_device


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    ``device`` (default ``"cuda"``), dtypes kept."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.as_tensor(np.array(node, copy=True), device=dev)

    return conv(tree)


def flatten_params(params: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested params -> ``{"a/b/c": leaf}`` (``model_item._path_to_name``)."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_params(v, name))
        else:
            out[name] = v
    return out
