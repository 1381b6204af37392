"""Flash attention with a hand-written backward (PyTorch port).

Mirrors the JAX package's ``ops/flash_attention.py``: online-softmax
attention (Dao et al., arXiv 2205.14135) over ``[B, S, H, D]`` tensors, scale
``1/sqrt(D)``, differentiable through a two-kernel backward (dK/dV over key
tiles, dQ over query tiles) that recomputes P from the forward's logsumexp.

Three kernels, each with its plain PyTorch version in this module:

- :func:`flash_fwd` (plain: :func:`flash_fwd_plain`) returns O and lse;
- :func:`flash_dkdv` (plain: :func:`flash_dkdv_plain`) returns dK, dV;
- :func:`flash_dq` (plain: :func:`flash_dq_plain`) returns dQ.

On CUDA tensors each wrapper launches its kernel from
``csrc/flash_attention.cu`` (which replaces the Pallas TPU kernels
``_fwd_kernel``, ``_dkdv_kernel`` and ``_dq_kernel``) and counts the launch,
or raises; on CPU tensors it runs its plain version, because there is no
kernel to run there (meta tensors, used only to trace shapes, take the plain
version too). :class:`FlashAttentionFn` ties the three together as the
``jax.custom_vjp`` of the JAX package does.

The fallback rule is the JAX package's ``_use_reference``, kept visible:
a sequence that is not a multiple of 128, or ``S_q != S_k``, goes through
:func:`mha_reference` (and autograd through it) in both packages.

Under tensor parallelism ``q``, ``k`` and ``v`` are ``DTensor``s sharded on
the heads dim; :func:`flash_attention` then runs through ``local_map``
(``Shard(2)`` in and out), so the kernels see each rank's ``H / model``
heads as plain tensors and count their launches as usual.
"""
from __future__ import annotations

import ctypes

import torch

from autodist_tpu_torch.ops.paged_attention import NEG_INF

#: The JAX kernel's block size: sequences must be multiples of it (and
#: ``S_q == S_k``) to take the kernel path; the CUDA tiles (64) divide it.
BLOCK = 128
#: Head dims the CUDA kernels are built for.
KERNEL_HEAD_DIMS = (64,)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def mha_reference(q, k, v, causal: bool = False):
    """Plain attention ([B,S,H,D] layout), fp32 softmax: the JAX package's
    ``mha_reference``."""
    head_dim = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    logits = logits / torch.sqrt(torch.tensor(float(head_dim), device=q.device))
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.tril(torch.ones((sq, sk), dtype=torch.bool, device=q.device))
        logits = torch.where(mask, logits, torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def use_reference(q, k) -> bool:
    """The JAX package's ``_use_reference``: True when the sequence lengths
    are not multiples of the 128 block or differ between q and k."""
    seq_q, seq_k = q.shape[1], k.shape[1]
    return seq_q % BLOCK != 0 or seq_k % BLOCK != 0 or seq_q != seq_k


def _scale(head_dim: int) -> float:
    return 1.0 / (head_dim ** 0.5)


def _causal_mask(s: int, device):
    """``rows >= cols`` over ``[S, S]``."""
    idx = torch.arange(s, device=device)
    return idx[:, None] >= idx[None, :]


def _scores(q32, k32, causal: bool):
    """fp32 scores ``[B, H, Sq, Sk]`` of already-widened q/k, masked."""
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k32)
    if causal:
        s = torch.where(_causal_mask(s.shape[-1], s.device), s,
                        torch.tensor(NEG_INF, device=s.device))
    return s


# ------------------------------------------------------------ plain versions
def flash_fwd_plain(q, k, v, causal: bool = False):
    """The forward kernel's math in one pass: ``(O [B,S,H,D] in q's dtype,
    lse [B,H,S] fp32)``. Scores ``(q . k) * scale`` in fp32, mask -1e30, p
    rounded to V's dtype before P.V (fp32 sums), ``l == 0`` read as 1,
    ``lse = m + log l``. Equal to the kernel's online softmax in exact
    arithmetic; in bf16 the kernel rounds p against its running max."""
    scale = _scale(q.shape[-1])
    s = _scores(q.to(torch.float32), k.to(torch.float32), causal) * scale
    m = s.amax(dim=-1)                                       # [B, H, S]
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    pv = p.to(v.dtype).to(torch.float32)
    acc = torch.einsum("bhqk,bkhd->bqhd", pv, v.to(torch.float32))
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l_safe.permute(0, 2, 1)[..., None]).to(q.dtype)
    return out, m + torch.log(l_safe)


def _p_and_ds(q, k, v, dout, lse, delta, causal: bool):
    """Backward recomputation shared by the two plain backward versions:
    ``(q * scale, P, dS)`` in fp32."""
    q32 = q.to(torch.float32) * _scale(q.shape[-1])
    s = _scores(q32, k.to(torch.float32), causal)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.to(torch.float32), v.to(torch.float32))
    return q32, p, p * (dp - delta[..., None])


def flash_dkdv_plain(q, k, v, dout, lse, delta, causal: bool = False):
    """The dK/dV kernel's math: ``P = exp(S - lse)``, ``dV = P^T dO``,
    ``dS = P (dO V^T - delta)``, ``dK = dS^T (q * scale)``, all fp32, cast
    to the inputs' dtypes. ``lse``/``delta`` are ``[B, H, S]`` fp32."""
    q32, p, ds = _p_and_ds(q, k, v, dout, lse, delta, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dout.to(torch.float32))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_dq_plain(q, k, v, dout, lse, delta, causal: bool = False):
    """The dQ kernel's math: ``dQ = scale * dS K`` in fp32, cast to q's dtype."""
    _, _, ds = _p_and_ds(q, k, v, dout, lse, delta, causal)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(torch.float32))
    return (dq * _scale(q.shape[-1])).to(q.dtype)


# ------------------------------------------------------------- CUDA kernels
def _check_kernel_args(**tensors):
    """Raise ``ValueError`` on anything the CUDA kernels do not take."""
    q = tensors["q"]
    if q.dim() != 4:
        raise ValueError(f"q must be [B, S, H, D], got {tuple(q.shape)}")
    b, s, h, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not built (built: {KERNEL_HEAD_DIMS})")
    if s % 64 or s < 64:
        raise ValueError(f"seq {s} must be a positive multiple of 64")
    if b * h > 65535:
        raise ValueError(f"batch x heads {b * h} exceeds the grid's 65535")
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (cp.async tiles)")
        if name in ("lse", "delta"):
            if t.dtype != torch.float32 or tuple(t.shape) != (b, h, s):
                raise ValueError(f"{name} must be float32 [B, H, S]")
        elif tuple(t.shape) != (b, s, h, d) or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} {tuple(q.shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def _kernel(name: str, n_ptrs: int):
    from autodist_tpu_torch.ops import _build

    fn = getattr(_build.load("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def build_kernel() -> None:
    """Compile (or load) the CUDA library now instead of at first launch."""
    _kernel("flash_attention_fwd", 5)


def _launch(fn, ptrs, q, causal: bool) -> None:
    b, s, h, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = fn(*[t.data_ptr() for t in ptrs], b, s, h, d, _DTYPE_CODE[q.dtype],
                int(bool(causal)), _scale(d), stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: cudaError {rc}")


def _device_kind(q) -> str:
    if q.device.type in ("cpu", "meta"):
        return "plain"
    if q.device.type != "cuda":
        raise ValueError(f"flash attention: unsupported device {q.device}")
    return "cuda"


def flash_fwd(q, k, v, causal: bool = False):
    """Forward: ``(O [B,S,H,D], lse [B,H,S] fp32)``. CUDA tensors launch
    ``flash_attention_fwd`` (counted in ``flash_fwd.launches``) or raise;
    CPU tensors run :func:`flash_fwd_plain`."""
    if _device_kind(q) == "plain":
        return flash_fwd_plain(q, k, v, causal)
    _check_kernel_args(q=q, k=k, v=v)
    b, s, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch(_kernel("flash_attention_fwd", 5), (q, k, v, out, lse), q, causal)
    flash_fwd.launches += 1
    return out, lse


def flash_dkdv(q, k, v, dout, lse, delta, causal: bool = False):
    """dK, dV. CUDA tensors launch ``flash_attention_dkdv`` (counted in
    ``flash_dkdv.launches``) or raise; CPU tensors run :func:`flash_dkdv_plain`."""
    if _device_kind(q) == "plain":
        return flash_dkdv_plain(q, k, v, dout, lse, delta, causal)
    _check_kernel_args(q=q, k=k, v=v, dout=dout, lse=lse, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(_kernel("flash_attention_dkdv", 8), (q, k, v, dout, lse, delta, dk, dv),
            q, causal)
    flash_dkdv.launches += 1
    return dk, dv


def flash_dq(q, k, v, dout, lse, delta, causal: bool = False):
    """dQ. CUDA tensors launch ``flash_attention_dq`` (counted in
    ``flash_dq.launches``) or raise; CPU tensors run :func:`flash_dq_plain`."""
    if _device_kind(q) == "plain":
        return flash_dq_plain(q, k, v, dout, lse, delta, causal)
    _check_kernel_args(q=q, k=k, v=v, dout=dout, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    _launch(_kernel("flash_attention_dq", 7), (q, k, v, dout, lse, delta, dq), q, causal)
    flash_dq.launches += 1
    return dq


#: Launches of each CUDA kernel (CPU calls and plain runs are not counted).
flash_fwd.launches = 0
flash_dkdv.launches = 0
flash_dq.launches = 0


def reset_launches() -> None:
    """Set every flash kernel's launch count to 0."""
    flash_fwd.launches = flash_dkdv.launches = flash_dq.launches = 0


# ------------------------------------------------------------------ autograd
class FlashAttentionFn(torch.autograd.Function):
    """The JAX package's ``flash_attention`` custom VJP as an autograd
    function: forward saves q, k, v, O and lse; backward forms
    ``delta = rowsum(dO * O)`` in fp32 as a plain tensor op, then runs the
    dK/dV and dQ kernels. Gradients come back in the inputs' dtypes."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_fwd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = (out.to(torch.float32) * dout.to(torch.float32)).sum(-1)
        delta = delta.permute(0, 2, 1).contiguous()              # [B, H, S]
        dk, dv = flash_dkdv(q, k, v, dout, lse, delta, ctx.causal)
        dq = flash_dq(q, k, v, dout, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False):
    """Flash attention, ``[B, S, H, D]`` in and out, differentiable. Aligned
    shapes run :class:`FlashAttentionFn` (under ``torch.export``, the
    forward kernel's operator of ``ops/library.py``); the rest
    :func:`mha_reference` (see :func:`use_reference`). ``DTensor`` inputs
    run on each rank's heads (``utils/placement.py::on_head_groups``:
    ``H / model`` heads under a model split, all H where q is replicated)."""
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        from autodist_tpu_torch.utils.placement import on_head_groups

        return on_head_groups(flash_attention, q)(q, k, v, causal)
    if use_reference(q, k):
        return mha_reference(q, k, v, causal)
    if torch.compiler.is_exporting():           # ops/library.py: the kernel as an op
        return torch.ops.autodist_tpu_torch.flash_fwd(
            q.contiguous(), k.contiguous(), v.contiguous(), bool(causal))[0]
    return FlashAttentionFn.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                  bool(causal))


def kernel_bytes(q, kind: str) -> int:
    """Bytes a kernel must move for ``q``'s shape: each input read once, each
    output written once (fwd: q, k, v in, O and lse out; dkdv: q, k, v, dO,
    lse, delta in, dK, dV out; dq: q, k, v, dO, lse, delta in, dQ out)."""
    b, s, h, _ = q.shape
    t = q.numel() * q.element_size()
    row = b * h * s * 4
    return {"fwd": 4 * t + row, "dkdv": 6 * t + 2 * row,
            "dq": 5 * t + 2 * row}[kind]


def kernel_flops(q, kind: str, causal: bool) -> int:
    """Multiply-add x 2 of the kernel's products over the scores this run
    needs (causal: the lower triangle, diagonal included): 2 products in the
    forward (QK^T, PV), 4 in dK/dV (QK^T, dO V^T, P^T dO, dS^T Q), 3 in dQ
    (QK^T, dO V^T, dS K)."""
    b, s, h, d = q.shape
    pairs = s * (s + 1) // 2 if causal else s * s
    return 2 * d * b * h * pairs * {"fwd": 2, "dkdv": 4, "dq": 3}[kind]


__all__ = [
    "BLOCK", "mha_reference", "use_reference", "flash_fwd_plain", "flash_dkdv_plain",
    "flash_dq_plain", "flash_fwd", "flash_dkdv", "flash_dq", "reset_launches",
    "FlashAttentionFn", "flash_attention", "build_kernel", "kernel_bytes",
    "kernel_flops",
]
