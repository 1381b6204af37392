"""NCF / NeuMF recommender of the PyTorch port.

Mirrors the JAX package's ``models/ncf.py``: GMF (the elementwise product of
user and item embeddings) beside an MLP tower over the concatenated
embeddings, a dense head over both, sigmoid cross-entropy on implicit
feedback. Its four embedding tables are read by row gathers: all four are
sparse-update parameters (and ``sparse_names`` marks them too). fp32.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models.spec import ModelSpec, register_model, seeded_generator
from autodist_tpu_torch.utils.device import resolve_device


def init_params(seed: int, num_users: int, num_items: int, mf_dim: int,
                mlp_dims: Sequence[int], device=None) -> Dict[str, Any]:
    if mlp_dims[0] % 2 != 0:
        raise ValueError(f"mlp_dims[0] must be even (user+item embeddings each get "
                         f"half), got {mlp_dims[0]}")
    gen, dev = seeded_generator(seed, device)
    half = mlp_dims[0] // 2
    params: Dict[str, Any] = {
        "mf_user": L.embedding_init(gen, num_users, mf_dim, stddev=0.01, device=dev),
        "mf_item": L.embedding_init(gen, num_items, mf_dim, stddev=0.01, device=dev),
        "mlp_user": L.embedding_init(gen, num_users, half, stddev=0.01, device=dev),
        "mlp_item": L.embedding_init(gen, num_items, half, stddev=0.01, device=dev),
    }
    for i in range(len(mlp_dims) - 1):
        params[f"mlp_{i}"] = L.dense_init(gen, mlp_dims[i], mlp_dims[i + 1], device=dev)
    params["head"] = L.dense_init(gen, mf_dim + mlp_dims[-1], 1, device=dev)
    return params


def forward(params, users, items, num_mlp_layers: int):
    """users, items [B] int -> logits [B]."""
    gmf = (L.embedding_lookup(params["mf_user"], users)
           * L.embedding_lookup(params["mf_item"], items))
    x = torch.cat([L.embedding_lookup(params["mlp_user"], users),
                   L.embedding_lookup(params["mlp_item"], items)], dim=-1)
    for i in range(num_mlp_layers):
        x = torch.relu(L.dense(params[f"mlp_{i}"], x))
    return L.dense(params["head"], torch.cat([gmf, x], dim=-1))[..., 0]


@register_model("ncf")
def neumf(num_users: int = 6040, num_items: int = 3706, mf_dim: int = 64,
          mlp_dims: Sequence[int] = (256, 256, 128, 64)) -> ModelSpec:
    n_mlp = len(mlp_dims) - 1

    def loss_fn(params, batch):
        logits = forward(params, batch["users"], batch["items"], n_mlp)
        return L.sigmoid_xent(logits, batch["labels"])

    def example_batch(batch_size: int, device=None):
        """The JAX package's batch: users ``7i``, items ``13i`` (modulo the
        table sizes), labels alternating 0, 1."""
        dev = resolve_device(device)
        i = torch.arange(batch_size, dtype=torch.int32, device=dev)
        return {"users": (i * 7) % num_users, "items": (i * 13) % num_items,
                "labels": (i % 2).to(torch.float32)}

    return ModelSpec(
        name="ncf",
        init=lambda seed=0, device=None: init_params(seed, num_users, num_items, mf_dim,
                                                     mlp_dims, device=device),
        loss_fn=loss_fn,
        example_batch=example_batch,
        apply=lambda p, b: forward(p, b["users"], b["items"], n_mlp),
        sparse_names=("mf_user", "mf_item", "mlp_user", "mlp_item"),
    )
