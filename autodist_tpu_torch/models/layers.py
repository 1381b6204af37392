"""Functional NN layers shared by the model zoo (PyTorch port).

Pure functions over explicit param dicts, with the JAX package's layouts
kept at the surface so parameters carry over unchanged: a dense kernel is
``[in, out]`` (``y = x @ kernel``), an embedding table ``[vocab, dim]``.
Initialisers draw from an explicit ``torch.Generator`` on an explicit
device. They do not reproduce ``jax.random``'s numbers (tests carry JAX
parameters over with :mod:`autodist_tpu_torch.models.convert`).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch


# ------------------------------------------------------------------ initializers
def _fans(shape) -> Tuple[int, int]:
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def glorot(gen: torch.Generator, shape, device=None, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=gen, device=device, dtype=dtype)
    return u * (2.0 * limit) - limit


def normal(gen: torch.Generator, shape, stddev=0.02, device=None,
           dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=device, dtype=dtype) * stddev


# ------------------------------------------------------------------------ dense
def dense_init(gen, in_dim: int, out_dim: int, use_bias: bool = True,
               device=None):
    p = {"kernel": glorot(gen, (in_dim, out_dim), device=device)}
    if use_bias:
        p["bias"] = torch.zeros((out_dim,), device=device)
    return p


def dense(p, x, *, compute_dtype=None):
    """``x @ kernel (+ bias)``: both operands cast to ``compute_dtype``, the
    bias cast to the product's dtype (the JAX package's order)."""
    k = p["kernel"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        k = k.to(compute_dtype)
    y = x @ k
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


# -------------------------------------------------------------------- layernorm
def layernorm_init(dim: int, device=None):
    return {"scale": torch.ones((dim,), device=device),
            "bias": torch.zeros((dim,), device=device)}


def layernorm(p, x, eps: float = 1e-6):
    # Normalize in fp32 regardless of compute dtype, then cast back.
    x32 = x.to(torch.float32)
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


# -------------------------------------------------------------------- embedding
def embedding_init(gen, vocab: int, dim: int, stddev: float = 0.02,
                   device=None):
    return {"embedding": normal(gen, (vocab, dim), stddev, device=device)}


def embedding_lookup(p, ids):
    """Row gather — the sparse-update read that ``ModelItem``'s trace marks
    (an ``aten.index`` of the table). Unlike ``jnp.take`` (which fills
    out-of-range rows with NaN), an out-of-range id raises here: callers
    clamp positions first."""
    return p["embedding"][ids.long()]


# ----------------------------------------------------------------------- losses
def per_token_xent(logits, labels):
    """Per-position cross-entropy (fp32 logsumexp), no reduction."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    label_logit = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return logz - label_logit


def softmax_xent(logits, labels):
    """Mean cross-entropy over every position."""
    return per_token_xent(logits, labels).mean()
