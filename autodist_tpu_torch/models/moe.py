"""Mixture-of-Experts transformer of the PyTorch port.

Mirrors the JAX package's ``models/moe.py``: the transformer's attention
blocks with a Switch-style top-1 routed FFN in place of the MLP, in the
einsum formulation (dispatch and combine over a static capacity dim), expert
kernels with a leading ``[E, ...]`` dim (``expert_names=("expert_",)``),
and the Switch load-balance loss added to the LM loss. Per token t, expert e
and capacity slot c:

- ``gates = softmax(x @ router)`` in fp32; each token keeps its top expert
  and its gate value;
- its slot is its place in that expert's queue (a cumulative sum over the
  tokens in order); tokens past ``capacity = max(1, int(1.25 T / E))`` are
  dropped and pass through the residual;
- ``dispatch[t, e, c]`` and ``combine = dispatch · gate`` are one-hot;
  ``expert_in = dispatchᵀ x``, a ReLU FFN per expert, ``y = combine ·
  expert_out`` (per expert, then summed over experts);
- ``aux = E Σ_e fraction_e · prob_e``, averaged over the layers.

Attention is the transformer's ``_attention``: at the default 127 tokens
``"auto"`` resolves to the dot path, as in the JAX package.
``MoEConfig.remat`` checkpoints each block.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict

import numpy as np
import torch

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models.spec import ModelSpec, register_model, seeded_generator
from autodist_tpu_torch.models.transformer import TransformerConfig, _attention, remat_block
from autodist_tpu_torch.utils.device import resolve_device


@dataclass
class MoEConfig(TransformerConfig):
    num_experts: int = 8
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


def init_params(cfg: MoEConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    gen, dev = seeded_generator(seed, device)
    d, e, f = cfg.d_model, cfg.num_experts, cfg.d_ff
    params: Dict[str, Any] = {
        "embed": L.embedding_init(gen, cfg.vocab_size, d, device=dev),
        "pos_embed": L.embedding_init(gen, cfg.max_seq_len, d, device=dev),
        "ln_f": L.layernorm_init(d, device=dev),
    }
    for i in range(cfg.num_layers):
        params[f"layers_{i}"] = {
            "ln1": L.layernorm_init(d, device=dev),
            "attn": {name: L.dense_init(gen, d, d, device=dev)
                     for name in ("wq", "wk", "wv", "wo")},
            "ln2": L.layernorm_init(d, device=dev),
            "moe": {"router": {"kernel": L.normal(gen, (d, e), device=dev)},
                    "expert_wi": L.normal(gen, (e, d, f), device=dev),
                    "expert_wo": L.normal(gen, (e, f, d), device=dev)},
        }
    return params


def _one_hot(index, n: int):
    """fp32 one-hot of ``index`` over ``n``; all zeros where ``index`` is out
    of ``[0, n)`` (``jax.nn.one_hot``'s rule, which the capacity mask uses)."""
    return (index[..., None] == torch.arange(n, device=index.device)).to(torch.float32)


def moe_ffn(p, x, cfg: MoEConfig):
    """Switch FFN on ``x [T, d]``: ``(y [T, d], aux loss)``."""
    tokens = x.shape[0]
    e = cfg.num_experts
    capacity = max(1, int(cfg.capacity_factor * tokens / e))
    gates = torch.softmax(x.to(torch.float32) @ p["router"]["kernel"].to(torch.float32),
                          dim=-1)                                   # [T, E]
    expert_idx = torch.argmax(gates, dim=-1)                        # first maximum
    gate = torch.amax(gates, dim=-1)
    onehot = _one_hot(expert_idx, e)                                # [T, E]
    position = torch.cumsum(onehot, dim=0) * onehot - 1.0          # queue place
    in_capacity = (position >= 0) & (position < capacity)
    dispatch = onehot * in_capacity
    dispatch_tec = dispatch[..., None] * _one_hot(position.to(torch.int32), capacity)
    combine_tec = dispatch_tec * gate[:, None, None]

    dt = cfg.dtype
    xin = torch.einsum("tec,td->ecd", dispatch_tec.to(dt), x)       # [E, C, d]
    h = torch.relu(torch.einsum("ecd,edf->ecf", xin, p["expert_wi"].to(dt)))
    out = torch.einsum("ecf,efd->ecd", h, p["expert_wo"].to(dt))
    # Combine per expert, then over experts: one nonzero term a token, so
    # the same values as one contraction over (e, c), and the expert dim is
    # never flattened with another (a DTensor split over experts cannot be).
    y = torch.einsum("tec,ecd->ted", combine_tec.to(dt), out).sum(1)

    aux = e * torch.sum(onehot.mean(dim=0) * gates.mean(dim=0))
    return y, aux


def _block(bp, x, cfg: MoEConfig):
    b, s, d = x.shape
    h = L.layernorm(bp["ln1"], x)
    q, k, v = (L.dense(bp["attn"][w], h, compute_dtype=cfg.dtype)
               .reshape(b, s, cfg.num_heads, cfg.head_dim) for w in ("wq", "wk", "wv"))
    o = _attention(q, k, v, cfg).reshape(b, s, d)
    x = x + L.dense(bp["attn"]["wo"], o, compute_dtype=cfg.dtype).to(x.dtype)
    h = L.layernorm(bp["ln2"], x)
    y, aux = moe_ffn(bp["moe"], h.reshape(b * s, d), cfg)
    return x + y.reshape(b, s, d).to(x.dtype), aux


def forward(params, tokens, cfg: MoEConfig):
    """tokens [B, S] -> (fp32 logits [B, S, V], the mean aux loss)."""
    s = tokens.shape[1]
    pos = torch.arange(s, device=tokens.device)
    x = (L.embedding_lookup(params["embed"], tokens)
         + L.embedding_lookup(params["pos_embed"], pos)[None]).to(cfg.dtype)
    aux_total = 0.0
    for i in range(cfg.num_layers):
        x, aux = remat_block(_block, cfg.remat)(params[f"layers_{i}"], x, cfg)
        aux_total = aux_total + aux
    x = L.layernorm(params["ln_f"], x)
    logits = torch.einsum("bsd,vd->bsv", x, params["embed"]["embedding"].to(cfg.dtype))
    return logits.to(torch.float32), aux_total / cfg.num_layers


@register_model("moe_transformer")
def moe_transformer(**overrides) -> ModelSpec:
    cfg = MoEConfig(vocab_size=8192, num_layers=4, d_model=512, num_heads=8, d_ff=1024,
                    max_seq_len=128, num_experts=8)
    cfg = replace(cfg, **overrides)

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        logits, aux = forward(params, tokens[:, :-1], cfg)
        return L.softmax_xent(logits, tokens[:, 1:]) + cfg.aux_loss_weight * aux

    def example_batch(batch_size: int, device=None):
        """The JAX package's batch: numpy ``default_rng(0)`` token ids."""
        dev = resolve_device(device)
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg.vocab_size, (batch_size, cfg.max_seq_len))
        return {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(dev)}

    return ModelSpec(
        name=f"moe_transformer_{cfg.num_layers}x{cfg.num_experts}e",
        init=lambda seed=0, device=None: init_params(cfg, seed=seed, device=device),
        loss_fn=loss_fn,
        example_batch=example_batch,
        apply=lambda p, tokens: forward(p, tokens, cfg)[0],
        sparse_names=("embed/embedding",),
        expert_names=("expert_",),
        config=cfg,
    )
