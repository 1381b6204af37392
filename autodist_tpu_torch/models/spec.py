"""ModelSpec: the workload contract ``AutoDist.build`` consumes (PyTorch port).

A model is ``init(seed, device) -> params`` + ``loss_fn(params, batch) ->
scalar`` + ``example_batch(batch_size, device) -> batch``, as in the JAX
package's ``models/spec.py``; seeds take the place of ``jax.random`` keys.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

_MODEL_REGISTRY: Dict[str, Callable[..., "ModelSpec"]] = {}


@dataclass
class ModelSpec:
    """One workload, ready to hand to ``AutoDist.build``."""

    name: str
    init: Callable[..., Any]                    # (seed, device) -> params
    loss_fn: Callable[[Any, Any], Any]          # (params, batch) -> scalar loss
    example_batch: Callable[..., Any]           # (batch_size, device) -> batch
    apply: Optional[Callable[..., Any]] = None  # (params, inputs) -> outputs
    config: Any = None
    # FLOPs of one forward+backward pass per example, for MFU accounting.
    flops_per_example: Optional[float] = None


def register_model(name: str):
    def deco(factory: Callable[..., ModelSpec]):
        _MODEL_REGISTRY[name] = factory
        return factory
    return deco


def get_model_spec(name: str, **overrides) -> ModelSpec:
    """The :class:`ModelSpec` of zoo model ``name`` with config overrides."""
    if name not in _MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; ported: {sorted(_MODEL_REGISTRY)}")
    return _MODEL_REGISTRY[name](**overrides)
