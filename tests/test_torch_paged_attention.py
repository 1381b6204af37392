"""Port parity: ``autodist_tpu_torch.ops.paged_attention`` vs the JAX package.

The port's plain path (``device="cpu"``; the kernel wrapper runs its plain
version on CPU tensors) is held against the JAX gather path and the JAX
Pallas kernel in interpret mode, on the same seeded numpy inputs, at the
shapes of ``tests/test_paged_kernel.py``. fp32 throughout, tolerance 1e-5
(the two frameworks sum in different orders; nothing else differs).
The CUDA kernel itself is checked against the plain version by the
``cuda``-marked test, which runs only where a card is present.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.ops import paged_attention as jpa
from autodist_tpu_torch.ops import paged_attention as tpa

B, P, PAGE_LEN, H, D = 3, 4, 8, 2, 16
N_PAGES = 12
TOL = 1e-5


def _inputs(seed, entry, quantized):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((N_PAGES, PAGE_LEN, H, D)).astype(np.float32)
    v = rng.standard_normal((N_PAGES, PAGE_LEN, H, D)).astype(np.float32)
    # Distinct physical pages per row, deliberately out of order.
    tables = rng.permutation(N_PAGES)[:B * P].reshape(B, P).astype(np.int32)
    if entry == "decode":
        q = rng.standard_normal((B, H, D)).astype(np.float32)
        pos = np.array([0, 7, P * PAGE_LEN - 1], np.int32)
    elif entry == "verify":
        q = rng.standard_normal((B, 5, H, D)).astype(np.float32)
        base = np.array([0, 9, P * PAGE_LEN - 2], np.int32)
        pos = np.minimum(base[:, None] + np.arange(5)[None, :],
                         P * PAGE_LEN - 1).astype(np.int32)
    else:
        q = rng.standard_normal((PAGE_LEN, H, D)).astype(np.float32)
        tables = tables[0]
        pos = np.arange(PAGE_LEN, 2 * PAGE_LEN, dtype=np.int32)
    return q, k, v, tables, pos


_JAX = {"decode": jpa.paged_decode_attention, "verify": jpa.paged_verify_attention,
        "prefill": jpa.paged_prefill_attention}
_TORCH = {"decode": tpa.paged_decode_attention, "verify": tpa.paged_verify_attention,
          "prefill": tpa.paged_prefill_attention}


def _run_jax(entry, impl, q, k, v, tables, pos, quantized):
    kj, vj, ks, vs = jnp.asarray(k), jnp.asarray(v), None, None
    if quantized:
        kj, ks = jpa.quantize_kv(kj)
        vj, vs = jpa.quantize_kv(vj)
    kw = {"interpret": True} if impl == "kernel" else {}
    return np.asarray(_JAX[entry](jnp.asarray(q), kj, vj, jnp.asarray(tables),
                                  jnp.asarray(pos), k_scale=ks, v_scale=vs,
                                  impl=impl, **kw))


def _run_torch(entry, impl, q, k, v, tables, pos, quantized):
    kt, vt, ks, vs = torch.from_numpy(k), torch.from_numpy(v), None, None
    if quantized:
        kt, ks = tpa.quantize_kv(kt)
        vt, vs = tpa.quantize_kv(vt)
    return _TORCH[entry](torch.from_numpy(q), kt, vt, torch.from_numpy(tables),
                         torch.from_numpy(pos), k_scale=ks, v_scale=vs,
                         impl=impl).numpy()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("entry", ["decode", "verify", "prefill"])
@pytest.mark.parametrize("port_impl", ["gather", "kernel"])
def test_entry_points_match_jax_gather_and_pallas_kernel(entry, quantized,
                                                         port_impl):
    inputs = _inputs({"decode": 0, "verify": 1, "prefill": 2}[entry], entry,
                     quantized)
    got = _run_torch(entry, port_impl, *inputs, quantized)
    for jax_impl in ("gather", "kernel"):
        want = _run_jax(entry, jax_impl, *inputs, quantized)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                   err_msg=f"vs JAX {jax_impl}")


def test_cpu_wrapper_runs_plain_version_and_counts_no_launch():
    q, k, v, tables, pos = _inputs(3, "verify", False)
    before = tpa.paged_attention.launches
    out = tpa.paged_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(tables),
                              torch.from_numpy(pos))
    plain = tpa.paged_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), torch.from_numpy(tables),
                                      torch.from_numpy(pos))
    assert torch.equal(out, plain)
    assert tpa.paged_attention.launches == before


def test_quantize_kv_bits_equal_jax():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((5, PAGE_LEN, H, D)) * 3.0).astype(np.float32)
    x[0, 0, 0] = 0.0                              # an all-zero row keeps scale 0
    jq, js = jpa.quantize_kv(jnp.asarray(x))
    tq, ts = tpa.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-7)
    np.testing.assert_allclose(
        tpa.dequantize_kv(tq, ts).numpy(),
        np.asarray(jpa.dequantize_kv(jq, js, jnp.float32)), rtol=0, atol=1e-7)


@pytest.mark.parametrize("dtype", [("float32", -1e30), ("float64", -1e30),
                                   ("bfloat16", None), ("float16", None)])
def test_mask_value_matches_jax(dtype):
    name, fixed = dtype
    got = tpa.mask_value(getattr(torch, name))
    assert got == jpa.mask_value(getattr(jnp, name))
    if fixed is not None:
        assert got == fixed
    else:
        assert np.isfinite(float(torch.tensor(got, dtype=getattr(torch, name))))


def test_position_mask_and_apply():
    mask = tpa.position_mask(4, torch.tensor([0, 2]))
    assert mask.tolist() == [[True, False, False, False], [True, True, True, False]]
    out = tpa.apply_mask(torch.zeros((2, 4)), mask)
    assert out[0, 1] == -1e30 and out[1, 3] == -1e30 and out[1, 2] == 0


def test_resolve_impl_by_device():
    assert tpa.resolve_impl("auto", "cpu") == "gather"
    assert tpa.resolve_impl("auto", "cuda") == "kernel"
    assert tpa.resolve_impl("gather", "cuda") == "gather"
    with pytest.raises(ValueError):
        tpa.resolve_impl("flash", "cpu")


def test_kernel_byte_and_flop_counts():
    q, k, v, tables, pos = _inputs(5, "verify", False)
    q4, kt = torch.from_numpy(q), torch.from_numpy(k)
    t, p = torch.from_numpy(tables), torch.from_numpy(pos)
    live = [min(int(r.max()) // PAGE_LEN + 1, P) for r in pos]
    per_page = 2 * PAGE_LEN * H * D * 4
    io = 2 * q.nbytes + tables.nbytes + pos.nbytes
    assert tpa.kernel_bytes(q4, kt, t, p, quantized=False) == sum(live) * per_page + io
    assert tpa.kernel_flops(q4, kt, t, p) == 4 * 5 * H * D * PAGE_LEN * sum(live)


@pytest.mark.cuda
@pytest.mark.parametrize("page_dtype", ["float32", "bfloat16", "int8"])
def test_cuda_kernel_matches_plain(page_dtype):
    """The CUDA kernel against its plain version on the card (fp32 compute
    reference; bf16 inputs compared at 1e-2, fp32 at 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v, tables, pos = _inputs(6, "verify", False)
    dev = torch.device("cuda")
    qdt = torch.float32 if page_dtype == "float32" else torch.bfloat16
    q4 = torch.from_numpy(q).to(dev, qdt)
    kt, vt = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
    ks = vs = None
    if page_dtype == "int8":
        kt, ks = tpa.quantize_kv(kt)
        vt, vs = tpa.quantize_kv(vt)
    else:
        kt, vt = kt.to(qdt), vt.to(qdt)
    tab, qp = torch.from_numpy(tables).to(dev), torch.from_numpy(pos).to(dev)
    out = tpa.paged_attention(q4, kt, vt, tab, qp, ks, vs)
    torch.cuda.synchronize()
    ref = tpa.paged_attention_plain(
        q4.float(), kt if page_dtype == "int8" else kt.float(),
        vt if page_dtype == "int8" else vt.float(), tab, qp, ks, vs)
    tol = 1e-5 if qdt == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
