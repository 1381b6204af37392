"""Transformer language model of the PyTorch port.

Mirrors the JAX package's ``models/transformer.py``: a pre-norm transformer
with tied input/output embeddings, fp32 params and bf16 compute, causal
(next-token) or bidirectional (BERT-style MLM) loss. Ported: the config, the
params, the uncached :func:`forward` with ``dot`` or ``flash`` attention
(``ops/flash_attention.py``, the CUDA flash kernels) or, over a mesh
``seq`` axis, ``ring`` and ``ulysses`` (``parallel/ring_attention.py``),
:func:`loss_fn` for both objectives, the ``transformer`` / ``bert_base`` /
``bert_large`` model specs, the paged KV-cache serving forwards
(:func:`forward_paged_prefill_chunk`, :func:`forward_paged_decode_step`,
the speculative :func:`forward_paged_verify`; each greedy or sampled) and
the bucketed engine's stacked-cache decode (:func:`forward_prefill`,
:func:`forward_decode_step`, greedy) with their cache helpers. Params are
a plain nested dict of tensors with the JAX tree's keys, so
``models/convert.py`` carries JAX parameters over unchanged.
``TransformerConfig.remat`` checkpoints each block.

Unlike the JAX forwards, which return a new cache, the cached forwards
update the cache's tensors in place (the JAX engine donates the cache to
the same effect) and return the same dict.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models.spec import ModelSpec, register_model, seeded_generator
from autodist_tpu_torch.ops import crossover
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
    # dot | flash (ops/flash_attention.py) | ring | ulysses (sequence
    # parallelism over the mesh's seq axis, parallel/ring_attention.py;
    # flash on a trivial one) | auto (ops/crossover.py: flash
    # from the measured H100 crossover on CUDA in the table's dtype, 1024
    # tokens otherwise, when block-aligned; dot below it) for the uncached
    # forward.
    attention_impl: str = "auto"
    # Serving-path attention over the paged KV pool: gather (the plain
    # PyTorch version) | kernel (csrc/paged_attention.cu on CUDA) | auto
    # (ops/crossover.py: the kernel from the measured timeline crossover on
    # CUDA, gather on the CPU).
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
    """Plain attention: softmax(QK^T/sqrt(d))V, fp32 softmax. ``DTensor``
    inputs on a mesh of two dims run on each rank's heads
    (``utils/placement.py::on_head_groups``): torch 2.11's einsum cannot
    flatten a head dim split over one of two mesh dims."""
    if getattr(q, "placements", None) is not None and q.device_mesh.ndim > 1:
        from autodist_tpu_torch.utils.placement import on_head_groups

        return on_head_groups(_dot_attention, q)(q, k, v, causal)
    head_dim = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    logits = logits / torch.sqrt(torch.tensor(float(head_dim), device=q.device))
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.tril(torch.ones((sq, sk), dtype=torch.bool, device=q.device))
        logits = pa_ops.apply_mask(logits, mask)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def resolve_attention_impl(impl: str, seq_len: int, device=None, dtype=None) -> str:
    """The ``attention_impl="auto"`` rule (``ops/crossover.py``): "flash"
    from the measured H100 crossover for CUDA attention in the table's
    dtype (the packaged 1024 otherwise) when block-aligned, else "dot".
    Explicit impls pass through."""
    return crossover.resolve_attention_impl(impl, seq_len, device, dtype)


def _attention(q, k, v, cfg: TransformerConfig):
    impl = resolve_attention_impl(cfg.attention_impl, q.shape[1], q.device, q.dtype)
    if impl == "dot":
        return _dot_attention(q, k, v, cfg.causal)
    if impl == "flash":
        return fa_ops.flash_attention(q, k, v, causal=cfg.causal)
    if impl == "ring":
        from autodist_tpu_torch.parallel.ring_attention import ring_attention

        return ring_attention(q, k, v, causal=cfg.causal)
    if impl == "ulysses":
        from autodist_tpu_torch.parallel.ring_attention import ulysses_attention

        return ulysses_attention(q, k, v, causal=cfg.causal)
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


# ------------------------------------------------------------ KV-cache decode
def init_kv_cache(cfg: TransformerConfig, n_slots: int, max_len: int,
                  dtype: Any = None, device=None) -> Dict[str, Any]:
    """The stacked decode cache of ``n_slots`` concurrent sequences: one
    ``[num_layers, slots, max_len, heads, head_dim]`` tensor per projection,
    ``max_len`` being a slot's whole timeline (one length bucket of the
    bucketed engine); dtype defaults to the compute dtype. ``device="meta"``
    prices it without allocating."""
    dev = device if str(device) == "meta" else resolve_device(device)
    shape = (cfg.num_layers, n_slots, max_len, cfg.num_heads, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def forward_prefill(params, tokens, length: int, cache, slot: int,
                    cfg: TransformerConfig):
    """Prompt pass into the stacked cache: the uncached causal forward (dot
    attention) of ``tokens [1, S]`` (padded to the bucket's length), each
    layer's k/v written into cache row ``slot`` at ``[0, S)``. Positions
    ``>= length`` hold pad garbage that the decode mask never admits before
    decode overwrites them. Returns ``(next_token [1] int32, cache)``: the
    argmax at ``length - 1``, the first generated token."""
    b, s = tokens.shape
    x = L.embedding_lookup(params["embed"], tokens).to(cfg.dtype)
    pos = torch.arange(s, device=tokens.device)
    x = x + L.embedding_lookup(params["pos_embed"], pos).to(cfg.dtype)
    for i in range(cfg.num_layers):
        bp = params[f"layers_{i}"]
        h = L.layernorm(bp["ln1"], x)
        q, k, v = _qkv(bp["attn"], h, cfg, (b, s, cfg.num_heads, cfg.head_dim))
        cache["k"][i, slot, :s] = k[0].to(cache["k"].dtype)
        cache["v"][i, slot, :s] = v[0].to(cache["v"].dtype)
        o = _dot_attention(q, k, v, causal=True).reshape(b, s, cfg.d_model)
        x = x + L.dense(bp["attn"]["wo"], o, compute_dtype=cfg.dtype)
        x = _mlp(bp, x, cfg)
    return _argmax(_logits(params, x[:, int(length) - 1], cfg)), cache


def forward_decode_step(params, tokens, positions, cache, cfg: TransformerConfig):
    """One incremental decode step over every cache slot: ``tokens [B]`` at
    absolute ``positions [B]`` (B == slots). Each layer writes the token's
    k/v at ``cache[:, b, positions[b]]`` and attends over the slot's
    timeline under ``j <= positions[b]``; idle slots compute garbage the
    engine ignores. Returns ``(next_token [B] int32, cache)``."""
    b = tokens.shape[0]
    max_len = cache["k"].shape[2]
    positions = positions.long()
    rows = torch.arange(b, device=tokens.device)
    x = L.embedding_lookup(params["embed"], tokens).to(cfg.dtype)
    x = x + L.embedding_lookup(params["pos_embed"], positions).to(cfg.dtype)
    mask = pa_ops.position_mask(max_len, positions)                 # [B, L]
    scale = math.sqrt(cfg.head_dim)     # a scalar: a CUDA graph captures the step
    for i in range(cfg.num_layers):
        bp = params[f"layers_{i}"]
        h = L.layernorm(bp["ln1"], x)
        q, k, v = _qkv(bp["attn"], h, cfg, (b, cfg.num_heads, cfg.head_dim))
        cache["k"][i, rows, positions] = k.to(cache["k"].dtype)
        cache["v"][i, rows, positions] = v.to(cache["v"].dtype)
        ck = cache["k"][i].to(cfg.dtype)                            # [B, L, H, D]
        cv = cache["v"][i].to(cfg.dtype)
        logits = torch.einsum("bhd,blhd->bhl", q, ck).to(torch.float32) / scale
        logits = pa_ops.apply_mask(logits, mask[:, None, :])
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        o = torch.einsum("bhl,blhd->bhd", probs, cv).reshape(b, cfg.d_model)
        x = x + L.dense(bp["attn"]["wo"], o, compute_dtype=cfg.dtype)
        x = _mlp(bp, x, cfg)
    return _argmax(_logits(params, x, cfg)), cache


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


def _paged_impl(cfg, device, batch: int, table_pages: int, page_len: int) -> str:
    """The kernel-or-gather choice of one paged forward: the measured
    crossover for its (batch, table width, heads) on CUDA (JAX's
    ``_resolve_paged_impl``)."""
    return pa_ops.resolve_impl(cfg.paged_attention_impl, device, batch=batch,
                               table_pages=table_pages, page_len=page_len,
                               heads=cfg.num_heads)


def _pages_of(page_tables, rows_pos, page_len: int):
    """Pool page of each timeline position through its row's table
    (``page_tables [..., P]``, ``rows_pos [..., Q]``). A position at or past
    the table's width goes to the scratch page 0 — a chunk that starts
    mid-page (a prefix-cache hit) or a verify window hanging off the
    timeline ceiling writes its pad there, never into a live page."""
    n_tables = page_tables.shape[-1]
    pidx = rows_pos // page_len
    pages = torch.gather(page_tables, -1, torch.clamp(pidx, max=n_tables - 1))
    return torch.where(pidx < n_tables, pages, torch.zeros_like(pages))


def _emit(logits, counters, samp):
    """The emitted token: the fp32 argmax, or with ``samp`` (the per-slot
    sampling tensors of ``serve/sampling.py``) the counter-keyed sample at
    absolute positions ``counters``."""
    if samp is None:
        return _argmax(logits)
    from autodist_tpu_torch.serve.sampling import sample_tokens

    return sample_tokens(logits, counters, samp)


def forward_paged_prefill_chunk(params, tokens, start: int, length: int, cache,
                                page_table, cfg: TransformerConfig, samp=None):
    """One chunk of a paged prefill: ``tokens [1, C]`` are prompt positions
    ``[start, start + C)`` (padded past ``length``; ``start`` may lie
    mid-page after a prefix-cache hit); each layer writes the chunk's k/v
    through ``page_table [P]`` and its queries attend causally over the
    row's timeline, earlier chunks included. Returns ``(next_token [1]
    int32, cache)``; the token is the argmax at position ``length - 1`` (or
    with ``samp`` the sample at counter ``length``), meaningful on the
    chunk that holds it."""
    b, c = tokens.shape
    dev = tokens.device
    page_len = cache["k"].shape[2]
    page_table = page_table.long()
    pos = start + torch.arange(c, device=dev)                       # [C] absolute
    page_of = _pages_of(page_table, pos, page_len)                  # [C]
    off = pos % page_len
    impl = _paged_impl(cfg, dev, 1, page_table.shape[0], page_len)
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
    counters = torch.full((b,), int(length), dtype=torch.int64, device=dev)
    return _emit(logits, counters, samp), cache


def forward_paged_decode_step(params, tokens, positions, cache, page_tables,
                              cfg: TransformerConfig, samp=None,
                              return_logits: bool = False):
    """One incremental decode step over every decode row: ``tokens [B]`` at
    absolute ``positions [B]``, ``page_tables [B, P]`` (idle rows carry
    all-scratch tables and compute finite garbage the engine ignores).
    Each layer scatters the token's k/v through the row's table and attends
    under ``j <= positions[b]``. Returns ``(next_token [B] int32, cache)``
    (with ``samp``, the sample at counter ``positions + 1``), or
    ``(next_token, fp32 logits [B, V], cache)`` with ``return_logits`` (the
    drift probe, greedy)."""
    b = tokens.shape[0]
    dev = tokens.device
    page_len = cache["k"].shape[2]
    positions = positions.long()
    page_tables = page_tables.long()
    # A speculative round's last draft feeds may pass the table: scratch.
    page_of = _pages_of(page_tables, positions[:, None], page_len)[:, 0]  # [B]
    off = positions % page_len
    impl = _paged_impl(cfg, dev, b, page_tables.shape[1], page_len)
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
    return _emit(logits, positions + 1, samp), cache


def forward_paged_verify(params, tokens, positions, cache, page_tables,
                         cfg: TransformerConfig, samp=None):
    """Speculative-decode verification, one target forward per spec round:
    ``tokens [B, K1]`` is each row's pending token followed by its ``K1 -
    1`` draft proposals, ``positions [B]`` the pending token's write slot,
    ``page_tables [B, P]`` as in :func:`forward_paged_decode_step`. Each
    layer scatters all K1 tokens' k/v at ``positions[b] + j`` (positions
    past the table's width to the scratch page 0) and the query at offset
    ``j`` attends over ``t <= positions[b] + j`` — the context plain decode
    sees token by token — through ``ops/paged_attention.py::
    paged_verify_attention`` (the CUDA kernel on the card).

    Returns ``(accept [B] int32, out_tokens [B, K1] int32, cache)``:
    ``out_tokens[b, j]`` is the target's token after the prefix through
    ``tokens[b, j]`` (argmax, or with ``samp`` the sample at counter
    ``positions[b] + j + 1``, plain decode's counter for that position),
    and ``accept[b]`` counts the leading proposals equal to it (a cumprod
    of the matches, on the device). The engine emits ``out_tokens[b,
    :accept[b] + 1]``."""
    b, k1 = tokens.shape
    dev = tokens.device
    page_len = cache["k"].shape[2]
    page_tables = page_tables.long()
    rows_pos = positions.long()[:, None] + torch.arange(k1, device=dev)[None, :]
    page_of = _pages_of(page_tables, rows_pos, page_len)            # [B, K1]
    off = rows_pos % page_len
    impl = _paged_impl(cfg, dev, b, page_tables.shape[1], page_len)
    emb_pos = torch.clamp(rows_pos, max=cfg.max_seq_len - 1)
    # The draft is another model: a proposal outside the target's vocab is
    # legal input. Clamp the EMBEDDING read only; acceptance below compares
    # the raw proposals, so a clamped id never falsely matches.
    emb_ids = torch.clamp(tokens, 0, cfg.vocab_size - 1)
    x = L.embedding_lookup(params["embed"], emb_ids).to(cfg.dtype)
    x = x + L.embedding_lookup(params["pos_embed"], emb_pos).to(cfg.dtype)
    for i in range(cfg.num_layers):
        bp = params[f"layers_{i}"]
        h = L.layernorm(bp["ln1"], x)
        q, k, v = _qkv(bp["attn"], h, cfg, (b, k1, cfg.num_heads, cfg.head_dim))
        cache = _paged_scatter(cache, i, page_of, off, k, v)
        ks, vs = _layer_scales(cache, i)
        o = pa_ops.paged_verify_attention(
            q, cache["k"][i], cache["v"][i], page_tables, rows_pos,
            k_scale=ks, v_scale=vs, impl=impl,
            compute_dtype=cfg.dtype).reshape(b, k1, cfg.d_model)
        x = x + L.dense(bp["attn"]["wo"], o, compute_dtype=cfg.dtype)
        x = _mlp(bp, x, cfg)
    logits = _logits(params, x, cfg)                                 # [B, K1, V]
    out = _emit(logits, rows_pos + 1, samp)
    match = (tokens[:, 1:] == out[:, :-1]).to(torch.int32)          # [B, K]
    accept = torch.cumprod(match, dim=1).sum(dim=1).to(torch.int32)
    return accept, out, cache


def decode_model(cfg: TransformerConfig, eos_id: Optional[int] = None):
    """The transformer's serving adapter: the cache functions bound to one
    config, in the shape the engines of ``serve/engine.py`` consume. It
    carries both cache renderings: the paged functions of
    :class:`~autodist_tpu_torch.serve.engine.InferenceEngine` and the
    stacked ones of the bucketed baseline engine."""
    from autodist_tpu_torch.serve.engine import DecodeModel

    return DecodeModel(
        init_cache=lambda n_slots, max_len, device=None: init_kv_cache(
            cfg, n_slots, max_len, device=device),
        prefill=lambda params, tokens, length, cache, slot: forward_prefill(
            params, tokens, length, cache, slot, cfg),
        decode_step=lambda params, tokens, positions, cache: forward_decode_step(
            params, tokens, positions, cache, cfg),
        init_paged_cache=lambda n_pages, page_len, device=None: init_paged_kv_cache(
            cfg, n_pages, page_len, device=device),
        prefill_chunk=lambda params, tokens, start, length, cache, table, samp=None:
            forward_paged_prefill_chunk(params, tokens, start, length, cache,
                                        table, cfg, samp=samp),
        decode_paged=lambda params, tokens, positions, cache, tables, samp=None:
            forward_paged_decode_step(params, tokens, positions, cache, tables,
                                      cfg, samp=samp),
        verify_paged=lambda params, tokens, positions, cache, tables, samp=None:
            forward_paged_verify(params, tokens, positions, cache, tables, cfg,
                                 samp=samp),
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
