"""Port parity: ``autodist_tpu_torch.ops.paged_attention`` vs the JAX package.

The port's plain path (``device="cpu"``; the kernel wrapper runs its plain
version on CPU tensors) is held against the JAX gather path and the JAX
Pallas kernel in interpret mode, on the same seeded numpy inputs, at the
shapes of ``tests/test_paged_kernel.py``. fp32 throughout, tolerance 1e-5
(the two frameworks sum in different orders; nothing else differs).
The CUDA kernel's algorithm (the timeline cut into splits of whole pages,
each split walked by 4 warps in runs of 16 slots with masked slots at p = 0,
then log-sum-exp merges of the warps and of the splits) is emulated in
plain PyTorch here and held to the same JAX references with fp32, bf16 and
int8 pages. The CUDA kernel itself is checked against the plain version by
the ``cuda``-marked test, which runs only where a card is present.
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
    shape = dict(batch=32, table_pages=32, page_len=16, heads=12)
    assert tpa.resolve_impl("auto", "cpu", **shape) == "gather"
    assert tpa.resolve_impl("auto", "cuda", **shape) == "kernel"
    assert tpa.resolve_impl("gather", "cuda", **shape) == "gather"
    with pytest.raises(ValueError):
        tpa.resolve_impl("flash", "cpu", **shape)


def test_kernel_byte_and_flop_counts():
    q, k, v, tables, pos = _inputs(5, "verify", False)
    q4, kt = torch.from_numpy(q), torch.from_numpy(k)
    t, p = torch.from_numpy(tables), torch.from_numpy(pos)
    live = [min(int(r.max()) // PAGE_LEN + 1, P) for r in pos]
    per_page = 2 * PAGE_LEN * H * D * 4
    io = 2 * q.nbytes + tables.nbytes + pos.nbytes
    assert tpa.kernel_bytes(q4, kt, t, p, quantized=False) == sum(live) * per_page + io
    assert tpa.kernel_flops(q4, kt, t, p) == 4 * 5 * H * D * PAGE_LEN * sum(live)


# ------------------------------------------- the CUDA kernel's split and merge
PAGE_KINDS = ("float32", "bfloat16", "int8")


def _pages(k, v, kind):
    """q dtype, K and V pages and scales of one page kind, from fp32 arrays."""
    qdt = torch.float32 if kind == "float32" else torch.bfloat16
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    if kind == "int8":
        kt, ks = tpa.quantize_kv(kt)
        vt, vs = tpa.quantize_kv(vt)
        return qdt, kt, vt, ks, vs
    return qdt, kt.to(qdt), vt.to(qdt), None, None


def _lse_merge(parts):
    """Log-sum-exp merge of ``(m [H], l [H], acc [H, D])`` states, in order."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    w = [torch.exp(p[0] - m) for p in parts]
    l = sum(p[1] * wi for p, wi in zip(parts, w))
    acc = sum(p[2] * wi[:, None] for p, wi in zip(parts, w))
    return m, l, acc


def _emulate_split_kernel(q4, k, v, tables, qpos, ks=None, vs=None, n_split=None,
                          merge="reached"):
    """``csrc/paged_attention.cu``'s algorithm in fp32, before the output
    rounding: ``(out [B, Q, H, D], pieces)``. Per (row, q-tile, split) that
    runs (its first slot at or before the tile's last position), 4 warps take
    runs of 16 slots in turn with an online softmax in which a masked slot
    gets p = 0 and leaves m alone; the warps merge by log-sum-exp, then the
    splits do: those the query's position reaches (``merge="reached"``, the
    kernel's rule) or every split that ran (``"all"``). ``pieces`` lists
    ``(b, split, query, warp or None, m, l, acc)`` for each warp state and
    each split state that entered a merge."""
    b_, n_q, h, d = q4.shape
    page_len, n_tables = k.shape[1], tables.shape[1]
    n_split, per_split = tpa.split_plan(n_q, b_, h, n_tables, page_len, 132, n_split)
    span, timeline = per_split * page_len, n_tables * page_len
    tile = 1 if n_q == 1 else tpa.Q_TILE
    kt = tpa._gather_timeline(k, ks, tables, torch.float32)        # [B, T, H, D]
    vt = tpa._gather_timeline(v, vs, tables, torch.float32)
    scores = torch.einsum("bqhd,bthd->bqht", q4.float(), kt) * d ** -0.5
    out = torch.zeros((b_, n_q, h, d))
    pieces = []
    for b in range(b_):
        for q0 in range(0, n_q, tile):
            queries = range(q0, min(q0 + tile, n_q))
            last = max(0, max(int(qpos[b, i]) for i in queries))
            states = {}
            for sp in range(n_split):
                begin = sp * span
                end = min(begin + span, timeline, last + 1)
                if begin >= end:
                    continue                     # the split exits at once
                for i in queries:
                    warps = []
                    for w in range(tpa.WARPS):
                        m = torch.full((h,), tpa.NEG_INF)
                        l, acc = torch.zeros(h), torch.zeros((h, d))
                        for r0 in range(begin + w * tpa.RUN_SLOTS, end,
                                        tpa.WARPS * tpa.RUN_SLOTS):
                            t = torch.arange(r0, min(r0 + tpa.RUN_SLOTS, end))
                            admit = t <= int(qpos[b, i])
                            sc = scores[b, i][:, t]                    # [H, run]
                            mx = torch.where(admit, sc, torch.tensor(tpa.NEG_INF)).amax(-1)
                            m_new = torch.maximum(m, mx)
                            alpha = torch.exp(m - m_new)
                            p = torch.where(admit, torch.exp(sc - m_new[:, None]),
                                            torch.zeros(()))
                            l = l * alpha + p.sum(-1)
                            acc = acc * alpha[:, None] + torch.einsum(
                                "ht,thd->hd", p, vt[b, t])
                            m = m_new
                        warps.append((m, l, acc))
                        pieces.append((b, sp, i, w, m, l, acc))
                    states[sp, i] = _lse_merge(warps)
                    pieces.append((b, sp, i, None, *states[sp, i]))
            for i in queries:
                reach = min(n_split, max(int(qpos[b, i]), 0) // span + 1)
                ran = [sp for sp in range(n_split) if (sp, i) in states]
                use = ran if merge == "all" else [sp for sp in ran if sp < reach]
                _, l, acc = _lse_merge([states[sp, i] for sp in use])
                l = torch.where(l == 0, torch.ones_like(l), l)
                out[b, i] = acc / l[:, None]
    return out, pieces


def _as4(entry, q, tables, pos):
    """An entry point's arguments in the kernel's [B, Q, H, D] form."""
    if entry == "decode":
        return q[:, None], tables, pos[:, None]
    if entry == "prefill":
        return q[None], tables[None], pos[None]
    return q, tables, pos


@pytest.mark.parametrize("n_split", [1, 2, 4])
@pytest.mark.parametrize("kind", PAGE_KINDS)
@pytest.mark.parametrize("entry", ["decode", "verify", "prefill"])
def test_split_and_merge_match_jax_kernel_and_gather(entry, kind, n_split):
    """The kernel's split walk and merges against the JAX Pallas kernel
    (interpret mode) on the same q and pages, and against the JAX gather
    path in fp32 on the same (bf16 or int8) values: fp32 at 1e-5; bf16 q
    and output within one bf16 step (1e-2) of the Pallas kernel's, and at
    1e-5 of the fp32 gather before the output rounding."""
    q, k, v, tables, pos = _inputs({"decode": 0, "verify": 1, "prefill": 2}[entry],
                                   entry, False)
    qdt, kt, vt, ks, vs = _pages(k, v, kind)
    qt = torch.from_numpy(q).to(qdt)
    q4, t4, p4 = _as4(entry, qt, torch.from_numpy(tables), torch.from_numpy(pos))
    got, _ = _emulate_split_kernel(q4, kt, vt, t4, p4, ks, vs, n_split)
    jk, jv = jnp.asarray(kt.float().numpy()), jnp.asarray(vt.float().numpy())
    if kind == "int8":
        jk, jv = jnp.asarray(kt.numpy()), jnp.asarray(vt.numpy())
    jks = None if ks is None else jnp.asarray(ks.numpy())
    jvs = None if vs is None else jnp.asarray(vs.numpy())
    args = (jnp.asarray(tables), jnp.asarray(pos))
    if kind != "float32":
        jk32, jv32 = jk, jv
        if kind == "bfloat16":
            jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        jq = jnp.asarray(qt.float().numpy()).astype(jnp.bfloat16)
    else:
        jk32, jv32, jq = jk, jv, jnp.asarray(q)
    kernel = np.asarray(_JAX[entry](jq, jk, jv, *args, k_scale=jks, v_scale=jvs,
                                    impl="kernel", interpret=True).astype(jnp.float32))
    gather = np.asarray(_JAX[entry](jnp.asarray(qt.float().numpy()), jk32, jv32, *args,
                                    k_scale=jks, v_scale=jvs, impl="gather",
                                    compute_dtype=jnp.float32))
    got = got.reshape(kernel.shape)
    np.testing.assert_allclose(got.numpy(), gather, atol=TOL, rtol=TOL,
                               err_msg="vs JAX gather")
    if kind == "float32":
        np.testing.assert_allclose(got.numpy(), kernel, atol=TOL, rtol=TOL,
                                   err_msg="vs JAX kernel")
    else:
        np.testing.assert_allclose(got.to(torch.bfloat16).float().numpy(), kernel,
                                   atol=1e-2, rtol=1e-2, err_msg="vs JAX kernel")


def _edge_inputs(seed):
    """B=2 rows of 5 queries (a tile of 4 and a tile of 1) over 4 pages of 8
    slots. Row 0's first tile mixes positions 3 (mid page 0) and 20 (mid
    page 2): the splits and warps past slot 3 run for the tile but admit no
    slot of the query at 3. Row 1 stays in page 0, so with more splits than
    its live pages its later splits exit."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((N_PAGES, PAGE_LEN, H, D)).astype(np.float32)
    v = rng.standard_normal((N_PAGES, PAGE_LEN, H, D)).astype(np.float32)
    tables = rng.permutation(N_PAGES)[:2 * P].reshape(2, P).astype(np.int32)
    q = rng.standard_normal((2, 5, H, D)).astype(np.float32)
    pos = np.array([[3, 4, 11, 20, 27], [0, 1, 2, 3, 5]], np.int32)
    return q, k, v, tables, pos


@pytest.mark.parametrize("kind", PAGE_KINDS)
@pytest.mark.parametrize("n_split", [2, 4])
def test_masked_split_carries_weight_zero(kind, n_split):
    """A split (and a warp) in which every slot of a query is masked keeps
    m = -1e30 with l = 0 and acc = 0, so it carries weight 0 into a merge:
    merging every split that ran gives the kernel's answer, which matches
    the JAX Pallas kernel. Under the TPU kernel's own rule (masked slots
    weighted exp(-1e30 - m), m seeded by slot 0) such a split would count
    each masked slot once."""
    q, k, v, tables, pos = _edge_inputs(9)
    qdt, kt, vt, ks, vs = _pages(k, v, kind)
    q4, t4, p4 = torch.from_numpy(q).to(qdt), torch.from_numpy(tables), torch.from_numpy(pos)
    got, pieces = _emulate_split_kernel(q4, kt, vt, t4, p4, ks, vs, n_split)
    every, _ = _emulate_split_kernel(q4, kt, vt, t4, p4, ks, vs, n_split, merge="all")
    masked = [(b, sp, i, w) for b, sp, i, w, m, l, acc in pieces
              if bool((m == tpa.NEG_INF).all())]
    assert any(w is None for *_, w in masked), "no fully masked split reached"
    assert any(w is not None for *_, w in masked), "no fully masked warp reached"
    for b, sp, i, w, m, l, acc in pieces:
        if (b, sp, i, w) in masked:
            assert not l.any() and not acc.any()
    # Row 1 lives in page 0: every split past it exits (more splits than
    # live pages).
    assert all(sp == 0 for b, sp, *_ in pieces if b == 1)
    torch.testing.assert_close(every, got, atol=0, rtol=0)
    jk = jnp.asarray(kt.numpy()) if kind == "int8" else jnp.asarray(kt.float().numpy())
    jv = jnp.asarray(vt.numpy()) if kind == "int8" else jnp.asarray(vt.float().numpy())
    jdt = jnp.float32 if kind == "float32" else jnp.bfloat16
    if kind == "bfloat16":
        jk, jv = jk.astype(jdt), jv.astype(jdt)
    want = np.asarray(jpa.paged_verify_attention(
        jnp.asarray(q4.float().numpy()).astype(jdt), jk, jv, jnp.asarray(tables),
        jnp.asarray(pos), k_scale=None if ks is None else jnp.asarray(ks.numpy()),
        v_scale=None if vs is None else jnp.asarray(vs.numpy()), impl="kernel",
        interpret=True).astype(jnp.float32))
    tol = TOL if kind == "float32" else 1e-2
    np.testing.assert_allclose(got.to(qdt).float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("shape,asked,want", [
    ((1, 32, 12, 32, 16), None, (1, 32)),     # decode, 32 rows: 384 blocks
    ((1, 32, 12, 128, 16), None, (1, 128)),   # decode, 128 pages: the card is full
    ((16, 1, 12, 32, 16), None, (8, 4)),      # prefill: 48 blocks
    ((5, 32, 12, 32, 16), None, (1, 32)),     # verify: 2 q-tiles a row
    ((16, 1, 2, 32, 16), None, (8, 4)),       # one run a warp at most
    ((1, 1, 1, 1, 16), None, (1, 1)),
    ((1, 3, 2, 4, 8), None, (1, 4)),          # 4 pages of 8 slots: 2 runs in all
    ((1, 32, 12, 32, 16), 3, (3, 11)),        # a count asked for ...
    ((1, 32, 12, 32, 16), 5, (5, 7)),
    ((1, 32, 12, 10, 16), 6, (5, 2)),         # ... 10 pages in 6: 5 splits of 2
    ((1, 32, 12, 7, 16), 100, (7, 1)),
    ((1, 32, 12, 4, 16), 1, (1, 4)),
    ((1, 32, 12, 20000, 16), 1, (3, 6667)),   # the kernel's most pages a split
])
def test_split_plan(shape, asked, want):
    """The split plan from host-known sizes on 132 SMs: whole pages that
    cover the table, no split empty, at most the kernel's pages a split."""
    n, per = tpa.split_plan(*shape, 132, n_split=asked)
    assert (n, per) == want
    assert (n - 1) * per < shape[3] <= n * per and per <= tpa.MAX_PAGES_PER_SPLIT


@pytest.mark.cuda
@pytest.mark.parametrize("n_split", [None, 1, 2, 4])
@pytest.mark.parametrize("page_dtype", ["float32", "bfloat16", "int8"])
def test_cuda_kernel_matches_plain(page_dtype, n_split):
    """The CUDA kernel against its plain version on the card (fp32 compute
    reference; bf16 inputs compared at 1e-2, fp32 at 1e-5) at several split
    counts; a repeated launch is bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v, tables, pos = _inputs(6, "verify", False)
    dev = torch.device("cuda")
    qdt, kt, vt, ks, vs = _pages(k, v, page_dtype)
    q4, kt, vt = torch.from_numpy(q).to(dev, qdt), kt.to(dev), vt.to(dev)
    ks, vs = (None, None) if ks is None else (ks.to(dev), vs.to(dev))
    tab, qp = torch.from_numpy(tables).to(dev), torch.from_numpy(pos).to(dev)

    def run():
        if n_split is None:                          # the plan's own count
            return tpa.paged_attention(q4, kt, vt, tab, qp, ks, vs)
        return tpa._launch(q4, kt, vt, tab, qp, ks, vs, n_split=n_split)

    out, again = run(), run()
    torch.cuda.synchronize()
    ref = tpa.paged_attention_plain(
        q4.float(), kt if page_dtype == "int8" else kt.float(),
        vt if page_dtype == "int8" else vt.float(), tab, qp, ks, vs)
    tol = 1e-5 if qdt == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref, atol=tol, rtol=tol)
    assert torch.equal(out, again)
