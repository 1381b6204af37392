"""ModelSpec: the workload contract ``AutoDist.build`` consumes (PyTorch port).

A model is ``init(seed, device) -> params`` + ``loss_fn(params, batch) ->
scalar`` + ``example_batch(batch_size, device) -> batch``, as in the JAX
package's ``models/spec.py``; seeds take the place of ``jax.random`` keys.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from autodist_tpu_torch.utils.device import resolve_device

_MODEL_REGISTRY: Dict[str, Callable[..., "ModelSpec"]] = {}


@dataclass
class ModelSpec:
    """One workload, ready to hand to ``AutoDist.build``."""

    name: str
    init: Callable[..., Any]                    # (seed, device) -> params
    loss_fn: Callable[[Any, Any], Any]          # (params, batch) -> scalar loss
    example_batch: Callable[..., Any]           # (batch_size, device) -> batch
    # (params, inputs) -> outputs; multi-input models (NCF) take the batch.
    apply: Optional[Callable[..., Any]] = None
    sparse_names: tuple = ()                    # force-marked sparse params
    expert_names: tuple = ()                    # params with a leading expert dim
    config: Any = None
    # FLOPs of one forward+backward pass per example, for MFU accounting.
    flops_per_example: Optional[float] = None


def image_example_batch(image_size: int, num_classes: int):
    """Deterministic synthetic NHWC image batch factory of the CNN zoo: the
    JAX package's numbers (numpy ``default_rng(0)``: fp32 images, then
    int32 labels), as tensors on ``device`` (default ``"cuda"``)."""
    def example_batch(batch_size: int, device=None):
        dev = resolve_device(device)
        rng = np.random.default_rng(0)
        images = rng.standard_normal(
            (batch_size, image_size, image_size, 3)).astype(np.float32)
        labels = rng.integers(0, num_classes, (batch_size,)).astype(np.int32)
        return {"images": torch.from_numpy(images).to(dev),
                "labels": torch.from_numpy(labels).to(dev)}
    return example_batch


def seeded_generator(seed: int, device=None):
    """``(torch.Generator seeded with seed, device)`` on ``device`` (default
    ``"cuda"``): what every zoo model's ``init`` draws from."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return gen, dev


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
