"""Paged attention — the ONE home for softmax-over-pages math (PyTorch port).

Mirrors the JAX package's ``ops/paged_attention.py``. Three entry points match
the engine's programs: decode step (one query per row), spec verify (K+1
queries per row) and prefill chunk (one row, C queries). Each has two
implementations:

- ``impl="gather"``: the plain PyTorch version — materialise each row's
  ``[P * page_len, H, D]`` timeline by page index, attend with an fp32
  masked softmax. A literal port of the JAX gather path, einsum spellings
  included.
- ``impl="kernel"``: :func:`paged_attention`, the wrapper of the hand-written
  CUDA kernel ``csrc/paged_attention.cu`` (which replaces the Pallas TPU
  kernel ``_paged_kernel``). On a CUDA tensor it launches the kernel or
  raises; on a CPU tensor it runs the plain version
  (:func:`paged_attention_plain`), because there is no kernel to run there.
  The kernel splits each row's timeline into runs of pages
  (:func:`split_plan`) and merges the splits by log-sum-exp.

``"auto"`` resolves by device (:func:`resolve_impl`): the kernel on CUDA,
the gather path on the CPU.

Underneath either sits optional int8 KV quantisation with per-position
per-head fp32 scales (:func:`quantize_kv` / :func:`dequantize_kv`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

# The masking constant every forward path shares: -1e30 for fp32 logits; a
# finite value well inside the range for halves (-1e30 overflows fp16).
NEG_INF = -1e30

#: Head dims and page lengths the CUDA kernel is built for.
KERNEL_HEAD_DIMS = (16, 64)
KERNEL_MAX_PAGE_LEN = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: The kernel's layout: a block of WARPS warps per (q-tile, split, head,
#: row), each warp taking RUN_SLOTS timeline slots at a time; a q-tile is
#: one query when Q == 1, else Q_TILE.
WARPS, RUN_SLOTS, Q_TILE = 4, 16, 4
#: The split count aims for about SPLIT_BLOCKS_PER_SM blocks on each SM;
#: each split past the first costs the merge's launch (PERF.md: at 32
#: pages, 1 split is as fast as any at decode and verify, 8 the fastest at
#: prefill).
SPLIT_BLOCKS_PER_SM = 3
#: Most pages a split stages in shared memory (the kernel's limit).
MAX_PAGES_PER_SPLIT = 8192


def mask_value(dtype=torch.float32) -> float:
    """The additive-mask fill value for logits of ``dtype``."""
    if dtype in (torch.float32, torch.float64):
        return NEG_INF
    # Half of the finite minimum: representable, and far enough below any
    # real logit that softmax still zeroes the masked entries.
    return float(torch.finfo(dtype).min) / 2.0


def position_mask(timeline: int, positions):
    """``True`` where timeline slot ``t <= positions[...]``; the mask gains
    a trailing timeline axis: ``positions.shape + (timeline,)``."""
    return torch.arange(timeline, device=positions.device) <= positions[..., None]


def apply_mask(logits, mask):
    """Fill ``~mask`` with the dtype-safe mask value (mask pre-broadcast)."""
    return torch.where(mask, logits,
                       torch.tensor(mask_value(logits.dtype), dtype=logits.dtype,
                                    device=logits.device))


# ------------------------------------------------------------ quantization
def quantize_kv(x):
    """Symmetric int8 quantisation over the head_dim axis.

    ``x [..., H, D]`` -> ``(int8 [..., H, D], fp32 scale [..., H])`` with
    ``scale = amax(|x|) / 127`` per (position, head) row; all-zero rows keep
    scale 0. Same order as the JAX package (divide by the safe scale, round
    half to even, clip to ±127, cast), so the int8 bits agree.
    """
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1)
    scale = amax / 127.0
    safe = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(x32 / safe[..., None]), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_kv`: ``int8 * scale`` cast to ``dtype``."""
    return (q.to(torch.float32) * scale[..., None]).to(dtype)


# ------------------------------------------------------- gather reference
def _paged_gather(cache_layer, page_tables):
    """Gather one layer's KV timeline(s) by page index: ``cache_layer
    [n_pages, page_len, ...]`` through ``page_tables [P]`` or ``[B, P]`` ->
    ``[..., P * page_len, ...]``."""
    page_len = cache_layer.shape[1]
    tail = tuple(cache_layer.shape[2:])
    gathered = cache_layer[page_tables.long()]
    return gathered.reshape(
        tuple(page_tables.shape[:-1]) + (page_tables.shape[-1] * page_len,) + tail)


def _gather_timeline(pages, scale, page_tables, compute_dtype):
    if scale is None:
        return _paged_gather(pages, page_tables).to(compute_dtype)
    g = _paged_gather(pages, page_tables)
    s = _paged_gather(scale, page_tables)
    return dequantize_kv(g, s, compute_dtype)


def _sqrt_head_dim(head_dim: int, device) -> torch.Tensor:
    return torch.sqrt(torch.tensor(float(head_dim), dtype=torch.float32,
                                   device=device))


def paged_attention_plain(q4, k_pages, v_pages, page_tables, q_positions,
                          k_scale=None, v_scale=None, compute_dtype=None):
    """The plain PyTorch version of :func:`paged_attention` (the JAX verify
    gather path): ``q4 [B, Q, H, D]``, ``page_tables [B, P]``,
    ``q_positions [B, Q]`` -> ``[B, Q, H, D]`` in the query dtype."""
    compute_dtype = compute_dtype or q4.dtype
    head_dim = q4.shape[-1]
    timeline = page_tables.shape[1] * k_pages.shape[1]
    ck = _gather_timeline(k_pages, k_scale, page_tables, compute_dtype)
    cv = _gather_timeline(v_pages, v_scale, page_tables, compute_dtype)
    mask = position_mask(timeline, q_positions)                   # [B, Q, T]
    logits = torch.einsum("bqhd,bthd->bhqt", q4, ck).to(torch.float32)
    logits = logits / _sqrt_head_dim(head_dim, q4.device)
    logits = apply_mask(logits, mask[:, None, :, :])
    probs = torch.softmax(logits, dim=-1).to(q4.dtype)
    return torch.einsum("bhqt,bthd->bqhd", probs, cv)


# ------------------------------------------------------------- CUDA kernel
def _check_kernel_args(q4, k_pages, v_pages, page_tables, q_positions,
                       k_scale, v_scale):
    """Raise ``ValueError`` on anything the CUDA kernel does not take."""
    dev = q4.device
    tensors = {"q4": q4, "k_pages": k_pages, "v_pages": v_pages,
               "page_tables": page_tables, "q_positions": q_positions}
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("k_scale and v_scale must both be given or both be None")
    if quantized:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q4 on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q4.dim() != 4:
        raise ValueError(f"q4 must be [B, Q, H, D], got {tuple(q4.shape)}")
    b, n_q, h, d = q4.shape
    if q4.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q4 dtype {q4.dtype} not supported (float32, bfloat16)")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not built (built: {KERNEL_HEAD_DIMS})")
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError("k_pages/v_pages must be equal [n_pages, page_len, H, D]")
    n_pages, page_len = k_pages.shape[:2]
    if tuple(k_pages.shape[2:]) != (h, d):
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q4 heads/dim")
    if not 1 <= page_len <= KERNEL_MAX_PAGE_LEN:
        raise ValueError(f"page_len {page_len} outside 1..{KERNEL_MAX_PAGE_LEN}")
    if k_pages.dtype != v_pages.dtype:
        raise ValueError("k_pages and v_pages differ in dtype")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("k_pages/v_pages must start on a 16-byte boundary "
                         "(the kernel reads them as 16-byte vectors)")
    if quantized:
        if k_pages.dtype != torch.int8:
            raise ValueError("scales given but pages are not int8")
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or tuple(s.shape) != (n_pages, page_len, h):
                raise ValueError("scales must be float32 [n_pages, page_len, H]")
    elif k_pages.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"page dtype {k_pages.dtype} needs scales (int8) or is "
                         "not supported")
    if page_tables.dim() != 2 or page_tables.shape[0] != b:
        raise ValueError(f"page_tables must be [B, P], got {tuple(page_tables.shape)}")
    if tuple(q_positions.shape) != (b, n_q):
        raise ValueError(f"q_positions must be [B, Q], got {tuple(q_positions.shape)}")
    for name, t in (("page_tables", page_tables), ("q_positions", q_positions)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if page_tables.shape[1] < 1 or b < 1 or n_q < 1:
        raise ValueError("empty batch, query or page-table dimension")


def split_plan(n_q: int, batch: int, n_heads: int, n_tables: int, page_len: int,
               n_sm: int, n_split=None):
    """``(n_split, pages_per_split)`` of the kernel's page walk, from what
    the host knows without reading the device: each (row, head, q-tile)'s
    timeline of ``n_tables`` pages is cut into ``n_split`` runs of
    ``pages_per_split`` whole pages (the last may be shorter, none is
    empty). By default as many splits as fit SPLIT_BLOCKS_PER_SM blocks on
    each of ``n_sm`` SMs, but no more than one run of RUN_SLOTS slots for
    each of a block's WARPS warps; ``n_split`` asks for a count instead
    (clipped to 1 .. ``n_tables``)."""
    tiles = 1 if n_q == 1 else -(-n_q // Q_TILE)
    if n_split is None:
        runs = -(-n_tables * page_len // RUN_SLOTS)
        most = max(1, min(n_tables, runs // WARPS))
        n_split = min(SPLIT_BLOCKS_PER_SM * n_sm // (batch * n_heads * tiles), most)
    n_split = max(1, min(int(n_split), n_tables),
                  -(-n_tables // MAX_PAGES_PER_SPLIT))
    per_split = -(-n_tables // n_split)
    return -(-n_tables // per_split), per_split


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel_fn():
    from autodist_tpu_torch.ops import _build

    lib = _build.load("paged_attention")
    fn = lib.paged_attention_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def build_kernel() -> None:
    """Compile (or load) the CUDA library now instead of at first launch."""
    _kernel_fn()


def paged_attention(q4, k_pages, v_pages, page_tables, q_positions,
                    k_scale=None, v_scale=None):
    """Attention of ``q4 [B, Q, H, D]`` over each row's KV pages through
    ``page_tables [B, P]`` under ``slot <= q_positions [B, Q]`` — the
    contract of the JAX package's ``_kernel_attention`` for positions >= 0.
    Returns ``[B, Q, H, D]`` in q's dtype.

    CUDA tensors launch ``csrc/paged_attention.cu`` on the current stream
    at :func:`split_plan`'s split count (one count in
    ``paged_attention.launches`` a call, the merge of the splits included)
    or raise; nothing is read back from the device, so the call can be
    captured in a CUDA graph. CPU tensors run :func:`paged_attention_plain`.
    """
    if q4.device.type == "cpu":
        return paged_attention_plain(q4, k_pages, v_pages, page_tables,
                                     q_positions, k_scale, v_scale)
    return _launch(q4, k_pages, v_pages, page_tables, q_positions, k_scale, v_scale)


def _launch(q4, k_pages, v_pages, page_tables, q_positions, k_scale=None,
            v_scale=None, n_split=None):
    """The CUDA branch of :func:`paged_attention`. ``n_split`` forces a
    split count in place of the plan's: a hook for the checks that hold
    every split count against the plain version; no caller of the model
    sets it."""
    if q4.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q4.device}")
    _check_kernel_args(q4, k_pages, v_pages, page_tables, q_positions,
                       k_scale, v_scale)
    fn = _kernel_fn()
    b, n_q, h, d = q4.shape
    page_len, n_tables = k_pages.shape[1], page_tables.shape[1]
    splits, per_split = split_plan(n_q, b, h, n_tables, page_len,
                                   _sm_count(q4.device.index or 0), n_split)
    out = torch.empty_like(q4)
    # The splits' (m, l) then acc, in one fp32 workspace, merged by a
    # second kernel.
    part = (torch.empty(splits * b * n_q * h * (d + 2), dtype=torch.float32,
                        device=q4.device) if splits > 1 else None)
    quantized = k_scale is not None
    stream = torch.cuda.current_stream(q4.device).cuda_stream
    with torch.cuda.device(q4.device):
        rc = fn(q4.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                k_scale.data_ptr() if quantized else None,
                v_scale.data_ptr() if quantized else None,
                page_tables.data_ptr(), q_positions.data_ptr(), out.data_ptr(),
                part.data_ptr() if part is not None else None,
                b, n_q, h, d, page_len, n_tables, per_split,
                _DTYPE_CODE[q4.dtype], _DTYPE_CODE[k_pages.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {rc}")
    paged_attention.launches += 1
    return out


#: Launches of the CUDA kernel (CPU calls and plain runs are not counted).
paged_attention.launches = 0


# ------------------------------------------------------------- entry points
def resolve_impl(impl: str, device) -> str:
    """``"auto"`` -> ``"kernel"`` on CUDA, ``"gather"`` elsewhere; explicit
    ``"gather"``/``"kernel"`` pass through."""
    if impl == "auto":
        return "kernel" if torch.device(device).type == "cuda" else "gather"
    if impl not in ("gather", "kernel"):
        raise ValueError(f"unknown paged attention impl {impl!r} (auto|gather|kernel)")
    return impl


def _index32(t):
    return t.to(torch.int32).contiguous()


def paged_decode_attention(q, k_pages, v_pages, page_tables, positions, *,
                           k_scale=None, v_scale=None, impl: str = "gather",
                           compute_dtype=None):
    """Decode-step attention: ``q [B, H, D]``, ``page_tables [B, P]``,
    ``positions [B]``. Returns ``[B, H, D]``."""
    impl = resolve_impl(impl, q.device)
    compute_dtype = compute_dtype or q.dtype
    if impl == "kernel":
        out = paged_attention(q[:, None].contiguous(), k_pages, v_pages,
                              _index32(page_tables), _index32(positions[:, None]),
                              k_scale, v_scale)
        return out[:, 0]
    head_dim = q.shape[-1]
    timeline = page_tables.shape[1] * k_pages.shape[1]
    ck = _gather_timeline(k_pages, k_scale, page_tables, compute_dtype)
    cv = _gather_timeline(v_pages, v_scale, page_tables, compute_dtype)
    mask = position_mask(timeline, positions)                     # [B, T]
    logits = torch.einsum("bhd,bthd->bht", q, ck).to(torch.float32)
    logits = logits / _sqrt_head_dim(head_dim, q.device)
    logits = apply_mask(logits, mask[:, None, :])
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bht,bthd->bhd", probs, cv)


def paged_prefill_attention(q, k_pages, v_pages, page_table, positions, *,
                            k_scale=None, v_scale=None, impl: str = "gather",
                            compute_dtype=None):
    """Prefill-chunk attention: ``q [C, H, D]`` (one row's chunk),
    ``page_table [P]``, ``positions [C]`` absolute. Returns ``[C, H, D]``."""
    impl = resolve_impl(impl, q.device)
    compute_dtype = compute_dtype or q.dtype
    if impl == "kernel":
        out = paged_attention(q[None].contiguous(), k_pages, v_pages,
                              _index32(page_table[None]), _index32(positions[None]),
                              k_scale, v_scale)
        return out[0]
    head_dim = q.shape[-1]
    timeline = page_table.shape[0] * k_pages.shape[1]
    ck = _gather_timeline(k_pages, k_scale, page_table, compute_dtype)
    cv = _gather_timeline(v_pages, v_scale, page_table, compute_dtype)
    mask = position_mask(timeline, positions)                     # [C, T]
    logits = torch.einsum("chd,thd->hct", q, ck).to(torch.float32)
    logits = logits / _sqrt_head_dim(head_dim, q.device)
    logits = apply_mask(logits, mask[None, :, :])
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("hct,thd->chd", probs, cv)


def paged_verify_attention(q, k_pages, v_pages, page_tables, rows_pos, *,
                           k_scale=None, v_scale=None, impl: str = "gather",
                           compute_dtype=None):
    """Spec-verify attention: ``q [B, K1, H, D]``, ``page_tables [B, P]``,
    ``rows_pos [B, K1]`` absolute query positions. Returns ``[B, K1, H, D]``."""
    impl = resolve_impl(impl, q.device)
    if impl == "kernel":
        return paged_attention(q.contiguous(), k_pages, v_pages,
                               _index32(page_tables), _index32(rows_pos),
                               k_scale, v_scale)
    return paged_attention_plain(q, k_pages, v_pages, page_tables, rows_pos,
                                 k_scale, v_scale, compute_dtype=compute_dtype)


def kernel_bytes(q4, k_pages, page_tables, q_positions, quantized: bool) -> int:
    """Bytes :func:`paged_attention` must move for these inputs: each row's
    live pages (K, V and scales, pages ``0 .. max(qpos) // page_len``) read
    once, q, tables and positions read once, the output written once."""
    page_len, h, d = k_pages.shape[1:]
    live = torch.clamp(q_positions.max(dim=1).values // page_len + 1,
                       max=page_tables.shape[1])
    per_page = 2 * page_len * h * d * k_pages.element_size()
    if quantized:
        per_page += 2 * page_len * h * 4
    io = (2 * q4.numel() * q4.element_size() + page_tables.numel() * 4
          + q_positions.numel() * 4)
    return int(live.sum().item()) * per_page + io


def kernel_flops(q4, k_pages, page_tables, q_positions) -> int:
    """Multiply-adds x 2 of the scores and the weighted sum over the live
    pages this run's positions need."""
    b, n_q, h, d = q4.shape
    page_len = k_pages.shape[1]
    live = torch.clamp(q_positions.max(dim=1).values // page_len + 1,
                       max=page_tables.shape[1])
    return int(4 * n_q * h * d * page_len * int(live.sum().item()))


__all__ = [
    "NEG_INF", "mask_value", "position_mask", "apply_mask", "quantize_kv",
    "dequantize_kv", "paged_attention", "paged_attention_plain", "build_kernel",
    "resolve_impl", "paged_decode_attention", "paged_prefill_attention",
    "paged_verify_attention", "kernel_bytes", "kernel_flops", "split_plan",
]
