"""Transformer language model — the serving slice of the PyTorch port.

Mirrors the JAX package's ``models/transformer.py``: a pre-norm causal
transformer with tied input/output embeddings, fp32 params and bf16 compute.
This slice ports the config, the params, the uncached one-shot
:func:`forward` (``dot`` attention) as the oracle, and the paged KV-cache
serving forwards (:func:`forward_paged_prefill_chunk`,
:func:`forward_paged_decode_step`) with their cache helpers. Params are a
plain nested dict of tensors with the JAX tree's keys, so
``models/convert.py`` carries JAX parameters over unchanged.

Unlike the JAX forwards, which return a new cache, the paged forwards
update the cache's tensors in place (the JAX engine donates the cache to
the same effect) and return the same dict.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.ops import paged_attention as pa_ops
from autodist_tpu_torch.utils.device import resolve_device


@dataclass
class TransformerConfig:
    vocab_size: int = 32000
    num_layers: int = 12
    d_model: int = 768
    num_heads: int = 12
    d_ff: int = 3072
    max_seq_len: int = 512
    causal: bool = True                 # False => BERT-style MLM
    dtype: Any = torch.bfloat16         # compute dtype (params stay fp32)
    # dot | auto (dot below the flash crossover; the flash kernels come with
    # the training slice) for the uncached forward.
    attention_impl: str = "auto"
    # Serving-path attention over the paged KV pool: gather (the plain
    # PyTorch version) | kernel (csrc/paged_attention.cu on CUDA) | auto
    # (kernel on CUDA, gather on the CPU).
    paged_attention_impl: str = "auto"
    # int8 KV pages with per-position/per-head fp32 scales.
    kv_quant: bool = False

    def __post_init__(self):
        if isinstance(self.dtype, str):
            self.dtype = getattr(torch, self.dtype)

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.num_heads == 0
        return self.d_model // self.num_heads

    def param_count(self) -> int:
        d, f, v, l_ = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        per_layer = 4 * d * d + 2 * d * f + 4 * d + (f + d) + 4 * d
        return v * d + self.max_seq_len * d + l_ * per_layer + 2 * d


# ---------------------------------------------------------------------- params
def init_params(cfg: TransformerConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Random fp32 params on ``device`` (default ``"cuda"``) from a
    ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    params: Dict[str, Any] = {
        "embed": L.embedding_init(gen, cfg.vocab_size, cfg.d_model, device=dev),
        "pos_embed": L.embedding_init(gen, cfg.max_seq_len, cfg.d_model, device=dev),
        "ln_f": L.layernorm_init(cfg.d_model, device=dev),
    }
    for i in range(cfg.num_layers):
        params[f"layers_{i}"] = {
            "ln1": L.layernorm_init(cfg.d_model, device=dev),
            "attn": {name: L.dense_init(gen, cfg.d_model, cfg.d_model, device=dev)
                     for name in ("wq", "wk", "wv", "wo")},
            "ln2": L.layernorm_init(cfg.d_model, device=dev),
            "mlp": {
                "fc1": L.dense_init(gen, cfg.d_model, cfg.d_ff, device=dev),
                "fc2": L.dense_init(gen, cfg.d_ff, cfg.d_model, device=dev),
            },
        }
    return params


# --------------------------------------------------------------------- forward
def _dot_attention(q, k, v, causal: bool):
    """Plain attention: softmax(QK^T/sqrt(d))V, fp32 softmax."""
    head_dim = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    logits = logits / torch.sqrt(torch.tensor(float(head_dim), device=q.device))
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.tril(torch.ones((sq, sk), dtype=torch.bool, device=q.device))
        logits = pa_ops.apply_mask(logits, mask)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _attention(q, k, v, cfg: TransformerConfig):
    impl = cfg.attention_impl
    if impl == "auto" and q.shape[1] < 1024:
        # The JAX package's measured crossover picks dot below 1024 tokens.
        impl = "dot"
    if impl == "dot":
        return _dot_attention(q, k, v, cfg.causal)
    raise NotImplementedError(
        f"attention_impl {cfg.attention_impl!r} at seq {q.shape[1]} needs the "
        "flash kernels, which are not ported yet (training slice)")


def _mlp(block_params, x, cfg):
    h = L.layernorm(block_params["ln2"], x)
    h = L.dense(block_params["mlp"]["fc1"], h, compute_dtype=cfg.dtype)
    h = F.gelu(h, approximate="tanh")          # jax.nn.gelu's default
    h = L.dense(block_params["mlp"]["fc2"], h, compute_dtype=cfg.dtype)
    return x + h


def _qkv(attn_p, h, cfg, shape):
    return tuple(L.dense(attn_p[w], h, compute_dtype=cfg.dtype).reshape(shape)
                 for w in ("wq", "wk", "wv"))


def _logits(params, x, cfg):
    x = L.layernorm(params["ln_f"], x)
    return x.to(cfg.dtype) @ params["embed"]["embedding"].T.to(cfg.dtype)


def _argmax(logits):
    return torch.argmax(logits.to(torch.float32), dim=-1).to(torch.int32)


def forward(params, tokens, cfg: TransformerConfig):
    """tokens [B, S] int -> logits [B, S, V] (fp32). The uncached oracle."""
    b, s = tokens.shape
    x = L.embedding_lookup(params["embed"], tokens).to(cfg.dtype)
    pos = torch.arange(s, device=tokens.device)
    x = x + L.embedding_lookup(params["pos_embed"], pos).to(cfg.dtype)
    for i in range(cfg.num_layers):
        bp = params[f"layers_{i}"]
        h = L.layernorm(bp["ln1"], x)
        q, k, v = _qkv(bp["attn"], h, cfg, (b, s, cfg.num_heads, cfg.head_dim))
        o = _attention(q, k, v, cfg).reshape(b, s, cfg.d_model)
        x = x + L.dense(bp["attn"]["wo"], o, compute_dtype=cfg.dtype)
        x = _mlp(bp, x, cfg)
    return _logits(params, x, cfg).to(torch.float32)


# --------------------------------------------------------- paged KV decode
def init_paged_kv_cache(cfg: TransformerConfig, n_pages: int, page_len: int,
                        dtype: Any = None, quantized: Optional[bool] = None,
                        device=None) -> Dict[str, Any]:
    """ONE pool of fixed-size KV pages shared by every request —
    ``[num_layers, n_pages, page_len, heads, head_dim]`` per projection; with
    ``cfg.kv_quant`` (or ``quantized=True``) int8 pages plus fp32 scale
    planes ``[num_layers, n_pages, page_len, heads]``. ``device="meta"``
    prices a page without allocating it."""
    dev = device if str(device) == "meta" else resolve_device(device)
    if quantized is None:
        quantized = bool(getattr(cfg, "kv_quant", False))
    shape = (cfg.num_layers, n_pages, page_len, cfg.num_heads, cfg.head_dim)
    if quantized:
        sshape = shape[:-1]
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(sshape, dtype=torch.float32, device=dev),
                "v_scale": torch.zeros(sshape, dtype=torch.float32, device=dev)}
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _paged_scatter(cache, layer, page_of, off, k, v):
    """Write one program's k/v rows through the page-table indices, in
    place — quantize-on-scatter when the cache carries int8 pages. Pad and
    idle rows all land on scratch page 0 with duplicate indices: whichever
    write wins is garbage that no position mask admits."""
    if "k_scale" in cache:
        kq, ks = pa_ops.quantize_kv(k)
        vq, vs = pa_ops.quantize_kv(v)
        cache["k"][layer, page_of, off] = kq
        cache["v"][layer, page_of, off] = vq
        cache["k_scale"][layer, page_of, off] = ks
        cache["v_scale"][layer, page_of, off] = vs
    else:
        cache["k"][layer, page_of, off] = k.to(cache["k"].dtype)
        cache["v"][layer, page_of, off] = v.to(cache["v"].dtype)
    return cache


def _layer_scales(cache, layer):
    if "k_scale" in cache:
        return cache["k_scale"][layer], cache["v_scale"][layer]
    return None, None


def _paged_impl(cfg, device) -> str:
    return pa_ops.resolve_impl(cfg.paged_attention_impl, device)


def forward_paged_prefill_chunk(params, tokens, start: int, length: int, cache,
                                page_table, cfg: TransformerConfig):
    """One chunk of a paged prefill: ``tokens [1, C]`` are prompt positions
    ``[start, start + C)`` (padded past ``length``); each layer writes the
    chunk's k/v through ``page_table [P]`` and its queries attend causally
    over the row's timeline, earlier chunks included. Returns
    ``(next_token [1] int32, cache)``; the token is the argmax at position
    ``length - 1``, meaningful on the chunk that holds it."""
    b, c = tokens.shape
    dev = tokens.device
    page_len = cache["k"].shape[2]
    page_table = page_table.long()
    pos = start + torch.arange(c, device=dev)                       # [C] absolute
    page_of = page_table[pos // page_len]                           # [C]
    off = pos % page_len
    impl = _paged_impl(cfg, dev)
    # Clamp the positional-embedding lookup only: pad positions may sit past
    # the table (their k/v land in scratch) but must still embed in range.
    emb_pos = torch.clamp(pos, max=cfg.max_seq_len - 1)
    x = L.embedding_lookup(params["embed"], tokens).to(cfg.dtype)
    x = x + L.embedding_lookup(params["pos_embed"], emb_pos).to(cfg.dtype)
    for i in range(cfg.num_layers):
        bp = params[f"layers_{i}"]
        h = L.layernorm(bp["ln1"], x)
        q, k, v = _qkv(bp["attn"], h, cfg, (c, cfg.num_heads, cfg.head_dim))
        cache = _paged_scatter(cache, i, page_of, off, k, v)
        ks, vs = _layer_scales(cache, i)
        o = pa_ops.paged_prefill_attention(
            q, cache["k"][i], cache["v"][i], page_table, pos,
            k_scale=ks, v_scale=vs, impl=impl,
            compute_dtype=cfg.dtype).reshape(b, c, cfg.d_model)
        x = x + L.dense(bp["attn"]["wo"], o, compute_dtype=cfg.dtype)
        x = _mlp(bp, x, cfg)
    frontier = min(max(int(length) - 1 - int(start), 0), c - 1)
    logits = _logits(params, x[:, frontier], cfg)                    # [1, V]
    return _argmax(logits), cache


def forward_paged_decode_step(params, tokens, positions, cache, page_tables,
                              cfg: TransformerConfig,
                              return_logits: bool = False):
    """One incremental decode step over every decode row: ``tokens [B]`` at
    absolute ``positions [B]``, ``page_tables [B, P]`` (idle rows carry
    all-scratch tables and compute finite garbage the engine ignores).
    Each layer scatters the token's k/v through the row's table and attends
    under ``j <= positions[b]``. Returns ``(next_token [B] int32, cache)``,
    or ``(next_token, fp32 logits [B, V], cache)`` with ``return_logits``
    (the drift probe)."""
    b = tokens.shape[0]
    dev = tokens.device
    page_len = cache["k"].shape[2]
    positions = positions.long()
    page_tables = page_tables.long()
    rows = torch.arange(b, device=dev)
    page_of = page_tables[rows, positions // page_len]              # [B]
    off = positions % page_len
    impl = _paged_impl(cfg, dev)
    emb_pos = torch.clamp(positions, max=cfg.max_seq_len - 1)
    x = L.embedding_lookup(params["embed"], tokens).to(cfg.dtype)
    x = x + L.embedding_lookup(params["pos_embed"], emb_pos).to(cfg.dtype)
    for i in range(cfg.num_layers):
        bp = params[f"layers_{i}"]
        h = L.layernorm(bp["ln1"], x)
        q, k, v = _qkv(bp["attn"], h, cfg, (b, cfg.num_heads, cfg.head_dim))
        cache = _paged_scatter(cache, i, page_of, off, k, v)
        ks, vs = _layer_scales(cache, i)
        o = pa_ops.paged_decode_attention(
            q, cache["k"][i], cache["v"][i], page_tables, positions,
            k_scale=ks, v_scale=vs, impl=impl,
            compute_dtype=cfg.dtype).reshape(b, cfg.d_model)
        x = x + L.dense(bp["attn"]["wo"], o, compute_dtype=cfg.dtype)
        x = _mlp(bp, x, cfg)
    logits = _logits(params, x, cfg)
    if return_logits:
        return _argmax(logits), logits.to(torch.float32), cache
    return _argmax(logits), cache


def decode_model(cfg: TransformerConfig, eos_id: Optional[int] = None):
    """The transformer's serving adapter: the paged cache functions bound to
    one config, in the shape :class:`~autodist_tpu_torch.serve.engine.
    InferenceEngine` consumes."""
    from autodist_tpu_torch.serve.engine import DecodeModel

    return DecodeModel(
        init_paged_cache=lambda n_pages, page_len, device=None: init_paged_kv_cache(
            cfg, n_pages, page_len, device=device),
        prefill_chunk=lambda params, tokens, start, length, cache, table:
            forward_paged_prefill_chunk(params, tokens, start, length, cache,
                                        table, cfg),
        decode_paged=lambda params, tokens, positions, cache, tables:
            forward_paged_decode_step(params, tokens, positions, cache, tables,
                                      cfg),
        eos_id=eos_id,
        max_len=cfg.max_seq_len,
        fp_cache_dtype=cfg.dtype,
    )
