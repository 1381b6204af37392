"""LM1B-style LSTM language model of the PyTorch port.

Mirrors the JAX package's ``models/lstm_lm.py``: an embedding read by row
gathers (a sparse-update parameter, also marked by ``sparse_names``),
``num_layers`` LSTM layers and a dense softmax head, next-token
cross-entropy. Each cell keeps the JAX cell exactly: one fused gate kernel
``[in + hidden, 4 hidden]`` over ``concat(x, h)`` in the compute dtype,
gates in the order i, f, g, o with ``sigmoid(f + 1)``, the carry ``(h, c)``
in fp32, and a ``proj [hidden, hidden]`` product on the output. JAX's
``lax.scan`` over time is a Python loop over the sequence here.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models.spec import ModelSpec, register_model, seeded_generator
from autodist_tpu_torch.utils.device import resolve_device


def _lstm_cell_init(gen, in_dim: int, hidden: int, dev):
    return {"kernel": L.glorot(gen, (in_dim + hidden, 4 * hidden), device=dev),
            "bias": torch.zeros((4 * hidden,), device=dev),
            "proj": L.glorot(gen, (hidden, hidden), device=dev)}


def init_params(seed: int, vocab: int, embed_dim: int, hidden: int, num_layers: int,
                device=None) -> Dict[str, Any]:
    gen, dev = seeded_generator(seed, device)
    params: Dict[str, Any] = {
        "embed": L.embedding_init(gen, vocab, embed_dim, device=dev),
        "softmax": {"kernel": L.glorot(gen, (hidden, vocab), device=dev),
                    "bias": torch.zeros((vocab,), device=dev)},
    }
    for i in range(num_layers):
        params[f"lstm_{i}"] = _lstm_cell_init(gen, embed_dim if i == 0 else hidden,
                                              hidden, dev)
    return params


def _lstm_layer(p, xs, hidden: int, dtype):
    """One LSTM layer over ``xs [S, B, in]``: outputs ``[S, B, hidden]`` fp32."""
    b = xs.shape[1]
    kernel, proj = p["kernel"].to(dtype), p["proj"].to(dtype)
    h = torch.zeros((b, hidden), dtype=torch.float32, device=xs.device)
    c = torch.zeros_like(h)
    out = []
    for x in xs:
        z = (torch.cat([x, h], dim=-1).to(dtype) @ kernel).to(torch.float32) + p["bias"]
        i, f, g, o = torch.split(z, hidden, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        h = (h.to(dtype) @ proj).to(torch.float32)
        out.append(h)
    return torch.stack(out)


def forward(params, tokens, num_layers: int, hidden: int, dtype=torch.bfloat16):
    """tokens [B, S] -> fp32 logits [B, S, V]."""
    x = L.embedding_lookup(params["embed"], tokens).transpose(0, 1)   # [S, B, E]
    for i in range(num_layers):
        x = _lstm_layer(params[f"lstm_{i}"], x, hidden, dtype)
    x = x.transpose(0, 1)                                             # [B, S, H]
    logits = x.to(dtype) @ params["softmax"]["kernel"].to(dtype)
    return logits.to(torch.float32) + params["softmax"]["bias"]


@register_model("lstm_lm")
def lstm_lm(vocab_size: int = 8192, embed_dim: int = 512, hidden: int = 1024,
            num_layers: int = 2, seq_len: int = 32) -> ModelSpec:
    def loss_fn(params, batch):
        tokens = batch["tokens"]
        logits = forward(params, tokens[:, :-1], num_layers, hidden)
        return L.softmax_xent(logits, tokens[:, 1:])

    def example_batch(batch_size: int, device=None):
        """The JAX package's batch: ``arange % vocab`` over ``seq_len + 1``."""
        dev = resolve_device(device)
        tokens = (torch.arange(batch_size * (seq_len + 1), dtype=torch.int32, device=dev)
                  .reshape(batch_size, seq_len + 1) % vocab_size)
        return {"tokens": tokens}

    return ModelSpec(
        name="lstm_lm",
        init=lambda seed=0, device=None: init_params(seed, vocab_size, embed_dim, hidden,
                                                     num_layers, device=device),
        loss_fn=loss_fn,
        example_batch=example_batch,
        apply=lambda p, t: forward(p, t, num_layers, hidden),
        sparse_names=("embed",),
    )
