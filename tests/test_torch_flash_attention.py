"""Port parity: ``autodist_tpu_torch.ops.flash_attention`` vs the JAX package.

The same seeded numpy inputs go through the JAX Pallas kernels (interpret
mode on the CPU, as the JAX package's own tests run them) and through the
port's CPU path, which is the three kernels' plain versions. B=2, S=256
(two 128-blocks, so the causal block skip is exercised), H=2, D=64.

Tolerances: fp32 1e-5 (the packages sum in different orders; nothing else
differs). bf16 outputs and gradients 2e-2 absolute and relative: the results
are rounded to bf16 (one step is 2^-8 relative) and the JAX kernel rounds p
to bf16 against its running per-block max where the plain version rounds
against the row max. The fp32 logsumexp of bf16 inputs agrees to 1e-4. The
CUDA kernels are held against their plain versions by the ``cuda``-marked
test, which runs only where a card is present.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.ops.crossover import resolve_attention_impl as jax_resolve
from autodist_tpu_torch.models.transformer import resolve_attention_impl
from autodist_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module("autodist_tpu.ops.flash_attention")

B, S, H, D = 2, 256, 2, 64
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-4}
CASES = [(c, d) for c in (False, True) for d in ("float32", "bfloat16")]
IDS = [f"{'causal' if c else 'full'}-{d}" for c, d in CASES]


def _inputs(seed, dtype, s=S):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, s, H, D)).astype(np.float32) for _ in range(4)]
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("causal,dtype", CASES, ids=IDS)
def test_forward_and_lse_match_jax_kernel(causal, dtype):
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(0, dtype)
    jout, res = jfa._flash_fwd(jq, jk, jv, causal, 128, 128, True)
    jlse = np.asarray(res[4]).reshape(B, H, S)
    out, lse = tfa.flash_fwd(tq, tk, tv, causal)             # CPU: the plain version
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    assert tuple(lse.shape) == (B, H, S)
    _close(out, jout, TOL[dtype], "O")
    _close(lse, jlse, LSE_TOL[dtype], "lse")


@pytest.mark.parametrize("causal,dtype", CASES, ids=IDS)
def test_backward_plain_versions_match_jax_kernels(causal, dtype):
    """dK/dV and dQ plain versions against the Pallas backward kernels on the
    JAX forward's own residuals (lse) and the same dO."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(1, dtype)
    jout, res = jfa._flash_fwd(jq, jk, jv, causal, 128, 128, True)
    jdq, jdk, jdv = jfa._flash_bwd(causal, 128, 128, True, res, jg)
    lse = torch.from_numpy(np.array(res[4]).reshape(B, H, S))
    out = torch.from_numpy(np.array(_np(jout))).to(tq.dtype)
    delta = (out.float() * tg.float()).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv = tfa.flash_dkdv(tq, tk, tv, tg, lse, delta, causal)
    dq = tfa.flash_dq(tq, tk, tv, tg, lse, delta, causal)
    for got, want, name in ((dq, jdq, "dq"), (dk, jdk, "dk"), (dv, jdv, "dv")):
        assert got.dtype == tq.dtype
        _close(got, want, TOL[dtype], name)


@pytest.mark.parametrize("causal,dtype", CASES, ids=IDS)
def test_autograd_gradients_match_jax_vjp(causal, dtype):
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(2, dtype)
    jout, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, causal), jq, jk, jv)
    jdq, jdk, jdv = vjp(jg)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = tfa.flash_attention(*leaves, causal=causal)
    out.backward(tg)
    _close(out.detach(), jout, TOL[dtype], "O")
    for t, want, name in zip(leaves, (jdq, jdk, jdv), ("dq", "dk", "dv")):
        assert t.grad.dtype == t.dtype
        _close(t.grad, want, TOL[dtype], name)


@pytest.mark.parametrize("causal", [False, True])
def test_nonaligned_sequence_takes_the_reference_in_both_packages(causal):
    s = 96                                      # not a multiple of the 128 block
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(3, "float32", s=s)
    assert tfa.use_reference(tq, tk)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = tfa.flash_attention(*leaves, causal=causal)
    assert torch.equal(out, tfa.mha_reference(tq, tk, tv, causal))
    assert out.grad_fn.name() != "FlashAttentionFnBackward"
    out.backward(tg)
    jout, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, causal), jq, jk, jv)
    _close(out.detach(), jout, 1e-5, "O")
    for t, want in zip(leaves, vjp(jg)):
        _close(t.grad, want, 1e-5, "grad")


@pytest.mark.parametrize("sq,sk", [(128, 128), (256, 256), (96, 96), (128, 256),
                                   (64, 64), (384, 384)])
def test_use_reference_rule_matches_jax(sq, sk):
    q, k = torch.zeros((1, sq, 1, 64)), torch.zeros((1, sk, 1, 64))
    want = jfa._use_reference(jnp.zeros((1, sq, 1, 64)), jnp.zeros((1, sk, 1, 64)),
                              min(128, sq), min(128, sk))
    assert tfa.use_reference(q, k) == want


@pytest.mark.parametrize("seq", [128, 512, 1000, 1024, 1088, 1152, 2048, 4096])
def test_auto_attention_rule_matches_jax(seq):
    assert resolve_attention_impl("auto", seq) == jax_resolve("auto", seq)
    assert resolve_attention_impl("dot", seq) == "dot"


def test_cpu_wrappers_run_plain_versions_and_count_no_launch():
    _, (tq, tk, tv, tg) = _inputs(4, "float32")
    tfa.reset_launches()
    out, lse = tfa.flash_fwd(tq, tk, tv, True)
    want_out, want_lse = tfa.flash_fwd_plain(tq, tk, tv, True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    delta = (out * tg).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv = tfa.flash_dkdv(tq, tk, tv, tg, lse, delta, True)
    pk, pv = tfa.flash_dkdv_plain(tq, tk, tv, tg, lse, delta, True)
    assert torch.equal(dk, pk) and torch.equal(dv, pv)
    assert torch.equal(tfa.flash_dq(tq, tk, tv, tg, lse, delta, True),
                       tfa.flash_dq_plain(tq, tk, tv, tg, lse, delta, True))
    assert (tfa.flash_fwd.launches, tfa.flash_dkdv.launches, tfa.flash_dq.launches) == \
        (0, 0, 0)


def test_kernel_byte_and_flop_counts():
    q = torch.zeros((2, 256, 3, 64), dtype=torch.bfloat16)
    t = q.numel() * 2
    row = 2 * 3 * 256 * 4
    assert tfa.kernel_bytes(q, "fwd") == 4 * t + row
    assert tfa.kernel_bytes(q, "dkdv") == 6 * t + 2 * row
    assert tfa.kernel_bytes(q, "dq") == 5 * t + 2 * row
    full, tri = 256 * 256, 256 * 257 // 2
    assert tfa.kernel_flops(q, "fwd", False) == 2 * 64 * 6 * full * 2
    assert tfa.kernel_flops(q, "dkdv", True) == 2 * 64 * 6 * tri * 4
    assert tfa.kernel_flops(q, "dq", True) == 2 * 64 * 6 * tri * 3


def test_kernel_argument_checks():
    q = torch.zeros((1, 128, 1, 32))
    with pytest.raises(ValueError, match="head_dim"):
        tfa._check_kernel_args(q=q, k=q, v=q)
    q = torch.zeros((1, 96, 1, 64))
    with pytest.raises(ValueError, match="multiple of 64"):
        tfa._check_kernel_args(q=q, k=q, v=q)
    q = torch.zeros((1, 128, 2, 64))
    with pytest.raises(ValueError, match="must be"):
        tfa._check_kernel_args(q=q, k=q.to(torch.bfloat16), v=q)
    with pytest.raises(ValueError, match="contiguous"):
        tfa._check_kernel_args(q=q, k=q.transpose(1, 2).contiguous().transpose(1, 2), v=q)


def test_kernel_arguments_must_be_16_byte_aligned():
    """The bf16 kernels stage tiles with 16-byte cp.async: a contiguous view
    that starts off a 16-byte boundary is refused before any launch."""
    n = 1 * 128 * 2 * 64
    q = torch.zeros(n)[None].reshape(1, 128, 2, 64)
    off = torch.zeros(n + 1)[1:].reshape(1, 128, 2, 64)     # 4 bytes in
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    tfa._check_kernel_args(q=q, k=q, v=q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._check_kernel_args(q=q, k=off, v=q)


# ----------------------------------------------- the tensor-core kernels' numerics
# The bf16 forward and dK/dV kernels multiply bf16 operands with fp32 sums on
# the tensor cores. The helpers below repeat their operand rounding in plain
# torch, over the kernels' 64-wide tiles, so that the CPU can hold the design
# to the reference's arithmetic.
TILE = 64
#: Relative L2 distance of dK, dV before the output rounding.
MMA_REL_L2 = 1e-4
#: Relative L2 distance of dQ before the output rounding (2.4e-6 to 2.6e-6
#: measured here), and after it against the JAX kernel's bf16 dQ: where the
#: two fp32 values straddle a rounding boundary they round one bf16 step
#: apart. Over seeds 8-12, causal and not, the rounded outputs read 0.76e-4
#: to 1.34e-4 apart; with dS rounded to bf16 once they read 2.59e-3 to
#: 2.69e-3. The bound sits between the two (DQ_SEEDS checks it).
DQ_REL_L2, DQ_BF16_REL_L2 = 1e-5, 2e-4
DQ_SEEDS = (9, 10, 11, 12)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _emulate_mma_fwd(q, k, v, causal):
    """(O fp32 before its rounding, lse) as the forward kernel computes
    them: fp32 scores of bf16 operands, online softmax over 64-key tiles with
    p rounded to bf16 against the running max, fp32 P.V sums."""
    b, s, h, d = q.shape
    q32, k32, v32 = (t.float() for t in (q, k, v))
    m = torch.full((b, h, s), tfa.NEG_INF)
    l = torch.zeros((b, h, s))
    acc = torch.zeros((b, h, s, d))
    for k0 in range(0, s, TILE):
        sc = torch.einsum("bqhd,bkhd->bhqk", q32, k32[:, k0:k0 + TILE]) * (d ** -0.5)
        if causal:
            keep = torch.arange(s)[:, None] >= torch.arange(k0, k0 + TILE)[None, :]
            sc = torch.where(keep, sc, torch.tensor(tfa.NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", _bf16(p),
                                                    v32[:, k0:k0 + TILE])
        m = m_new
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).permute(0, 2, 1, 3), m + torch.log(l_safe)


def _emulate_mma_dkdv(q, k, v, dout, lse, delta, causal, split=True):
    """dK, dV in fp32 before their rounding, as the dK/dV kernel computes
    them: S = (q scale) k^T and dP = dO v^T from bf16 operands with fp32
    sums; P and dS carried into dV += P^T dO and dK += dS^T (q scale) as
    hi + lo bf16 (``split=False``: rounded to bf16 once); the sums over
    64-query tiles accumulated in fp32."""
    d = q.shape[-1]
    q32, k32, v32, g32 = (t.float() for t in (q, k, v, dout))
    q32 = q32 * (d ** -0.5)
    p = torch.exp(tfa._scores(q32, k32, causal) - lse[..., None])
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", g32, v32) - delta[..., None])

    def operand(x):
        hi = _bf16(x)
        return hi + _bf16(x - hi) if split else hi

    pe, dse = operand(p), operand(ds)
    dk, dv = torch.zeros_like(k32), torch.zeros_like(v32)
    for q0 in range(0, q.shape[1], TILE):
        rows = slice(q0, q0 + TILE)
        dv += torch.einsum("bhqk,bqhd->bkhd", pe[:, :, rows], g32[:, rows])
        dk += torch.einsum("bhqk,bqhd->bkhd", dse[:, :, rows], q32[:, rows])
    return dk, dv


def _emulate_mma_dq(q, k, v, dout, lse, delta, causal, split=True):
    """dQ in fp32 before its rounding, as the dQ kernel computes it: S = q k^T
    (times scale afterwards) and dP = dO v^T from bf16 operands with fp32
    sums; dS carried into dQ += dS k as hi + lo bf16 (``split=False``:
    rounded to bf16 once); the sums over 64-key tiles accumulated in fp32;
    the scale applied once at the end."""
    d = q.shape[-1]
    q32, k32, v32, g32 = (t.float() for t in (q, k, v, dout))
    p = torch.exp(tfa._scores(q32, k32, causal) * (d ** -0.5) - lse[..., None])
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", g32, v32) - delta[..., None])
    hi = _bf16(ds)
    dse = hi + _bf16(ds - hi) if split else hi
    dq = torch.zeros_like(q32)
    for k0 in range(0, k.shape[1], TILE):
        cols = slice(k0, k0 + TILE)
        dq += torch.einsum("bhqk,bkhd->bqhd", dse[..., cols], k32[:, cols])
    return dq * (d ** -0.5)


def _rel_l2(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_tensor_core_forward_rounding_matches_plain_and_jax(causal):
    (jq, jk, jv, _), (tq, tk, tv, _) = _inputs(6, "bfloat16")
    o32, lse = _emulate_mma_fwd(tq, tk, tv, causal)
    jout, res = jfa._flash_fwd(jq, jk, jv, causal, 128, 128, True)
    want_out, want_lse = tfa.flash_fwd_plain(tq, tk, tv, causal)
    for ref, name in ((want_out, "plain"), (jout, "jax")):
        _close(o32.to(torch.bfloat16), ref, TOL["bfloat16"], f"O vs {name}")
    _close(lse, want_lse, LSE_TOL["bfloat16"], "lse vs plain")
    _close(lse, np.asarray(res[4]).reshape(B, H, S), LSE_TOL["bfloat16"], "lse vs jax")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_tensor_core_dkdv_split_keeps_fp32_semantics(causal):
    """The hi/lo split of P and dS keeps dK, dV within 1e-4 relative L2 of
    the reference's fp32 arithmetic (the plain version and the JAX Pallas
    kernel, both in fp32 on the same bf16 values), before the output
    rounding; one bf16 rounding of P and dS does not."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(7, "bfloat16")
    jout, res = jfa._flash_fwd(jq, jk, jv, causal, 128, 128, True)
    lse = torch.from_numpy(np.array(res[4]).reshape(B, H, S))
    out = torch.from_numpy(np.array(_np(jout))).to(torch.bfloat16)
    delta = (out.float() * tg.float()).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv = _emulate_mma_dkdv(tq, tk, tv, tg, lse, delta, causal)
    pk, pv = tfa.flash_dkdv_plain(*(t.float() for t in (tq, tk, tv, tg)), lse, delta, causal)
    f32 = [jnp.asarray(_np(t)) for t in (tq, tk, tv)]
    jres = (*f32, jnp.asarray(_np(out)), res[4])
    _, jdk, jdv = jfa._flash_bwd(causal, 128, 128, True, jres, jnp.asarray(_np(tg)))
    for got, plain, jax_ref, name in ((dk, pk, jdk, "dk"), (dv, pv, jdv, "dv")):
        assert _rel_l2(got, plain) <= MMA_REL_L2, name
        assert _rel_l2(got, jax_ref) <= MMA_REL_L2, name
        assert _rel_l2(plain, jax_ref) <= MMA_REL_L2, name
        _close(got.to(torch.bfloat16), jax_ref, TOL["bfloat16"], name)
    rk, rv = _emulate_mma_dkdv(tq, tk, tv, tg, lse, delta, causal, split=False)
    assert _rel_l2(rk, pk) > MMA_REL_L2 and _rel_l2(rv, pv) > MMA_REL_L2


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_tensor_core_dq_split_keeps_fp32_semantics(causal):
    """The hi/lo split of dS keeps dQ within DQ_REL_L2 of the reference's
    fp32 arithmetic (the plain version and the JAX Pallas ``_dq_kernel``, in
    interpret mode, both in fp32 on the same bf16 values) before the output
    rounding, and within DQ_BF16_REL_L2 of the JAX kernel's bf16 dQ after it;
    one bf16 rounding of dS does not."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(8, "bfloat16")
    jout, res = jfa._flash_fwd(jq, jk, jv, causal, 128, 128, True)
    lse = torch.from_numpy(np.array(res[4]).reshape(B, H, S))
    out = torch.from_numpy(np.array(_np(jout))).to(torch.bfloat16)
    delta = (out.float() * tg.float()).sum(-1).permute(0, 2, 1).contiguous()
    dq = _emulate_mma_dq(tq, tk, tv, tg, lse, delta, causal)
    pq = tfa.flash_dq_plain(*(t.float() for t in (tq, tk, tv, tg)), lse, delta, causal)
    f32 = [jnp.asarray(_np(t)) for t in (tq, tk, tv)]
    jres = (*f32, jnp.asarray(_np(out)), res[4])
    jdq32 = jfa._flash_bwd(causal, 128, 128, True, jres, jnp.asarray(_np(tg)))[0]
    jdq16 = jfa._flash_bwd(causal, 128, 128, True, res, jg)[0]
    assert _rel_l2(dq, pq) <= DQ_REL_L2
    assert _rel_l2(dq, jdq32) <= DQ_REL_L2
    assert _rel_l2(pq, jdq32) <= DQ_REL_L2
    assert _rel_l2(dq.to(torch.bfloat16), jdq16) <= DQ_BF16_REL_L2
    _close(dq.to(torch.bfloat16), jdq16, TOL["bfloat16"], "dq")
    rough = _emulate_mma_dq(tq, tk, tv, tg, lse, delta, causal, split=False)
    assert _rel_l2(rough, pq) > 10 * DQ_REL_L2
    assert _rel_l2(rough.to(torch.bfloat16), jdq16) > 10 * DQ_BF16_REL_L2


@pytest.mark.parametrize("seed", DQ_SEEDS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_dq_bf16_bound_separates_split_from_one_rounding(causal, seed):
    """On other inputs too, the bf16 dQ of the hi/lo split stays within
    DQ_BF16_REL_L2 of the JAX kernel's, and one bf16 rounding of dS lands
    more than ten times the bound away."""
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _inputs(seed, "bfloat16")
    jout, res = jfa._flash_fwd(jq, jk, jv, causal, 128, 128, True)
    lse = torch.from_numpy(np.array(res[4]).reshape(B, H, S))
    out = torch.from_numpy(np.array(_np(jout))).to(torch.bfloat16)
    delta = (out.float() * tg.float()).sum(-1).permute(0, 2, 1).contiguous()
    jdq16 = jfa._flash_bwd(causal, 128, 128, True, res, jg)[0]
    dq = _emulate_mma_dq(tq, tk, tv, tg, lse, delta, causal)
    rough = _emulate_mma_dq(tq, tk, tv, tg, lse, delta, causal, split=False)
    assert _rel_l2(dq.to(torch.bfloat16), jdq16) <= DQ_BF16_REL_L2
    assert _rel_l2(rough.to(torch.bfloat16), jdq16) > 10 * DQ_BF16_REL_L2


@pytest.mark.cuda
@pytest.mark.parametrize("causal,dtype", CASES, ids=IDS)
def test_cuda_kernels_match_plain_versions(causal, dtype):
    """Each CUDA kernel against its plain version on the card, on the same
    inputs (bf16 at 2e-2 for the reasons above, fp32 at 1e-4: the kernels'
    fp32 sums run in another order over 256 terms)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    _, tx = _inputs(5, dtype)
    q, k, v, g = (t.to(dev) for t in tx)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    out, lse = tfa.flash_fwd(q, k, v, causal)
    want_out, want_lse = tfa.flash_fwd_plain(q, k, v, causal)
    delta = (want_out.float() * g.float()).sum(-1).permute(0, 2, 1).contiguous()
    dk, dv = tfa.flash_dkdv(q, k, v, g, want_lse, delta, causal)
    dq = tfa.flash_dq(q, k, v, g, want_lse, delta, causal)
    torch.cuda.synchronize()
    pk, pv = tfa.flash_dkdv_plain(q, k, v, g, want_lse, delta, causal)
    pq = tfa.flash_dq_plain(q, k, v, g, want_lse, delta, causal)
    for got, want in ((out, want_out), (lse, want_lse), (dk, pk), (dv, pv), (dq, pq)):
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
