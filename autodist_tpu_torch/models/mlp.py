"""Small MLP and linear-regression workloads of the PyTorch port.

Mirrors the JAX package's ``models/mlp.py``: ``mlp`` (dense layers with ReLU
between them, softmax cross-entropy) and ``linear_regression`` (``y = x @ w
+ b``, mean squared error; the numeric-assertion workload). fp32
throughout; params are the JAX tree's nested dict.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models.spec import ModelSpec, register_model, seeded_generator
from autodist_tpu_torch.utils.device import resolve_device


def _linspace(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` as fp32, within one fp32 step of
    JAX's values (JAX computes in fp32, numpy in fp64 and rounds once)."""
    return np.linspace(start, stop, num, dtype=np.float32)


@register_model("mlp")
def mlp_model(in_dim: int = 32, hidden: Sequence[int] = (64, 64),
              num_classes: int = 10) -> ModelSpec:
    dims = [in_dim, *hidden, num_classes]

    def init(seed=0, device=None):
        gen, dev = seeded_generator(seed, device)
        return {f"dense_{i}": L.dense_init(gen, dims[i], dims[i + 1], device=dev)
                for i in range(len(dims) - 1)}

    def apply(params, x):
        for i in range(len(dims) - 1):
            x = L.dense(params[f"dense_{i}"], x)
            if i < len(dims) - 2:
                x = torch.relu(x)
        return x

    def loss_fn(params, batch):
        return L.softmax_xent(apply(params, batch["x"]), batch["y"])

    def example_batch(batch_size: int, device=None):
        dev = resolve_device(device)
        x = _linspace(-1.0, 1.0, batch_size * in_dim).reshape(batch_size, in_dim)
        y = (np.arange(batch_size) % num_classes).astype(np.int32)
        return {"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev)}

    return ModelSpec("mlp", init, loss_fn, example_batch, apply=apply)


@register_model("linear_regression")
def linear_regression(in_dim: int = 8) -> ModelSpec:
    """``y = x @ w + b`` with MSE loss, zero-initialised."""

    def init(seed=0, device=None):
        dev = resolve_device(device)
        return {"w": torch.zeros((in_dim, 1), device=dev),
                "b": torch.zeros((1,), device=dev)}

    def apply(params, x):
        return x @ params["w"] + params["b"]

    def loss_fn(params, batch):
        pred = apply(params, batch["x"])[..., 0]
        return torch.mean((pred - batch["y"]) ** 2)

    def example_batch(batch_size: int, device=None):
        dev = resolve_device(device)
        x = torch.from_numpy(_linspace(0.0, 1.0, batch_size * in_dim)
                             .reshape(batch_size, in_dim)).to(dev)
        return {"x": x, "y": x.sum(-1)}

    return ModelSpec("linear_regression", init, loss_fn, example_batch, apply=apply)
