"""Transformer language model of the PyTorch port.

Mirrors the JAX package's ``models/transformer.py``: a pre-norm transformer
with tied input/output embeddings, fp32 params and bf16 compute, causal
(next-token) or bidirectional (BERT-style MLM) loss. Ported: the config, the
params, the uncached :func:`forward` with ``dot`` or ``flash`` attention
(``ops/flash_attention.py``, the CUDA flash kernels), :func:`loss_fn` for
both objectives, the ``transformer`` / ``bert_base`` / ``bert_large`` model
specs, and the paged KV-cache serving forwards
(:func:`forward_paged_prefill_chunk`, :func:`forward_paged_decode_step`)
with their cache helpers. Params are a plain nested dict of tensors with
the JAX tree's keys, so ``models/convert.py`` carries JAX parameters over
unchanged. ``TransformerConfig.remat`` checkpoints each block.

Unlike the JAX forwards, which return a new cache, the paged forwards
update the cache's tensors in place (the JAX engine donates the cache to
the same effect) and return the same dict.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models.spec import ModelSpec, register_model, seeded_generator
from autodist_tpu_torch.ops import flash_attention as fa_ops
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
    # dot | flash (ops/flash_attention.py) | auto (resolve_attention_impl:
    # flash from the JAX package's default crossover of 1024 tokens when
    # block-aligned, dot below it) for the uncached forward.
    attention_impl: str = "auto"
    # Serving-path attention over the paged KV pool: gather (the plain
    # PyTorch version) | kernel (csrc/paged_attention.cu on CUDA) | auto
    # (kernel on CUDA, gather on the CPU).
    paged_attention_impl: str = "auto"
    # int8 KV pages with per-position/per-head fp32 scales.
    kv_quant: bool = False
    # Checkpoint each block: its forward runs again in the backward
    # (jax.checkpoint in the JAX package, torch.utils.checkpoint here).
    remat: bool = False
    mlm_mask_token: int = 0             # [MASK] id for the MLM objective

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

    def flops_per_example(self, seq_len: Optional[int] = None) -> float:
        """fwd+bwd FLOPs per sequence: 3x forward; forward = 2*P*s matmul
        FLOPs + attention 4*s^2*d per layer."""
        s = seq_len or self.max_seq_len
        fwd = 2.0 * self.param_count() * s + 4.0 * self.num_layers * s * s * self.d_model
        return 3.0 * fwd


# ---------------------------------------------------------------------- params
def init_params(cfg: TransformerConfig, seed: int = 0,
                device=None) -> Dict[str, Any]:
    """Random fp32 params on ``device`` (default ``"cuda"``) from a
    ``torch.Generator`` seeded with ``seed``."""
    gen, dev = seeded_generator(seed, device)
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


#: The JAX package's packaged default flash crossover (``ops/crossover.py``
#: ``DEFAULT_FLASH_CROSSOVER_SEQ``, measured on a TPU v5e). The H100
#: crossover is not measured yet.
DEFAULT_FLASH_CROSSOVER_SEQ = 1024


def resolve_attention_impl(impl: str, seq_len: int) -> str:
    """The ``attention_impl="auto"`` rule of the JAX package: "flash" at and
    above the crossover when the sequence is block-aligned (the flash
    kernel's own constraint), else "dot". Explicit impls pass through."""
    if impl != "auto":
        return impl
    if seq_len >= DEFAULT_FLASH_CROSSOVER_SEQ and seq_len % fa_ops.BLOCK == 0:
        return "flash"
    return "dot"


def _attention(q, k, v, cfg: TransformerConfig):
    impl = resolve_attention_impl(cfg.attention_impl, q.shape[1])
    if impl == "dot":
        return _dot_attention(q, k, v, cfg.causal)
    if impl == "flash":
        return fa_ops.flash_attention(q, k, v, causal=cfg.causal)
    if impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attention_impl {impl!r} (sequence parallelism) is not ported yet; "
            "see ROADMAP.md")
    raise ValueError(f"unknown attention_impl {cfg.attention_impl!r}")


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


def _block(block_params, x, cfg: TransformerConfig):
    b, s, _ = x.shape
    h = L.layernorm(block_params["ln1"], x)
    q, k, v = _qkv(block_params["attn"], h, cfg, (b, s, cfg.num_heads, cfg.head_dim))
    o = _attention(q, k, v, cfg).reshape(b, s, cfg.d_model)
    x = x + L.dense(block_params["attn"]["wo"], o, compute_dtype=cfg.dtype)
    return _mlp(block_params, x, cfg)


def forward(params, tokens, cfg: TransformerConfig):
    """tokens [B, S] int -> logits [B, S, V] (fp32)."""
    b, s = tokens.shape
    x = L.embedding_lookup(params["embed"], tokens).to(cfg.dtype)
    pos = torch.arange(s, device=tokens.device)
    x = x + L.embedding_lookup(params["pos_embed"], pos).to(cfg.dtype)
    for i in range(cfg.num_layers):
        x = remat_block(_block, cfg.remat)(params[f"layers_{i}"], x, cfg)
    return _logits(params, x, cfg).to(torch.float32)


def remat_block(block, remat: bool):
    """``block`` itself, or under ``torch.utils.checkpoint.checkpoint``
    (``use_reentrant=False``) when ``remat`` is set."""
    if not remat:
        return block
    return lambda *args: checkpoint(block, *args, use_reentrant=False)


def loss_fn(params, batch, cfg: TransformerConfig):
    """Mean next-token cross-entropy (causal), or the MLM loss: masked
    positions take ``cfg.mlm_mask_token`` and are predicted back, averaged
    over the masked count (at least 1)."""
    if cfg.causal:
        # Attend over the full (block-aligned) sequence and shift the
        # logits, not the inputs: trimming to s-1 would break the flash
        # kernel's alignment and take the reference path instead.
        tokens = batch["tokens"]
        logits = forward(params, tokens, cfg)
        return L.softmax_xent(logits[:, :-1], tokens[:, 1:])
    mask = batch["mlm_mask"]
    tokens = batch["tokens"]
    inputs = torch.where(mask.bool(), torch.full_like(tokens, cfg.mlm_mask_token),
                         tokens)
    logits = forward(params, inputs, cfg)
    mask = mask.to(torch.float32)
    per_tok = L.per_token_xent(logits, batch["labels"]) * mask
    return per_tok.sum() / torch.clamp(mask.sum(), min=1.0)


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


# ------------------------------------------------------------------- modelspec
@register_model("transformer")
def transformer_lm(**overrides) -> ModelSpec:
    cfg = TransformerConfig(**overrides)

    def example_batch(batch_size: int, device=None):
        """The JAX package's deterministic batch: tokens ``arange % vocab``;
        MLM adds labels = tokens and a mask on every 7th position."""
        dev = resolve_device(device)
        s = cfg.max_seq_len
        tokens = (torch.arange(batch_size * s, dtype=torch.int32, device=dev)
                  .reshape(batch_size, s) % cfg.vocab_size)
        if cfg.causal:
            return {"tokens": tokens}
        mask = (torch.arange(s, device=dev) % 7 == 0).to(torch.int32)
        return {"tokens": tokens, "labels": tokens.clone(),
                "mlm_mask": mask.expand(batch_size, s).contiguous()}

    return ModelSpec(
        name="transformer",
        init=lambda seed=0, device=None: init_params(cfg, seed=seed, device=device),
        loss_fn=lambda p, b: loss_fn(p, b, cfg),
        example_batch=example_batch,
        apply=lambda p, tokens: forward(p, tokens, cfg),
        config=cfg,
        flops_per_example=cfg.flops_per_example(),
    )


@register_model("bert_base")
def bert_base(**overrides) -> ModelSpec:
    """BERT-base MLM pretraining config (the JAX package's ``bert_base``)."""
    kw = dict(vocab_size=30522, num_layers=12, d_model=768, num_heads=12,
              d_ff=3072, max_seq_len=128, causal=False)
    kw.update(overrides)
    spec = transformer_lm(**kw)
    spec.name = "bert_base"
    return spec


@register_model("bert_large")
def bert_large(**overrides) -> ModelSpec:
    """BERT-large uncased (L=24, H=1024, A=16; the JAX package's
    ``bert_large``)."""
    kw = dict(vocab_size=30522, num_layers=24, d_model=1024, num_heads=16,
              d_ff=4096, max_seq_len=128, causal=False)
    kw.update(overrides)
    spec = transformer_lm(**kw)
    spec.name = "bert_large"
    return spec
