"""Port parity: the stacked-cache decode and the bucketed engine.

The JAX package's test model (``tests/test_serve_paged.py``: fp32, vocab 97,
2 layers, d_model 32, 32 positions) with its weights carried over by
``params_from_jax``, on the CPU:

- ``forward_prefill`` and ``forward_decode_step`` against JAX's, on the
  same numpy-seeded tokens: every emitted token equal, and the stacked
  cache within 1e-5 absolute and relative (fp32, where the two differ only
  in summation order);
- the port's ``BucketedInferenceEngine`` against JAX's on the same prompts
  and admissions: greedy streams equal, slots (bucket, row) equal;
  ``bucket_for``, spilling to a larger bucket, ``token_budget``, the
  ``ValueError`` past the largest bucket and the capacities equal. JAX's
  engine rounds its rows up to the test mesh's 8 devices, so the port's is
  built with that row count;
- ``tests/test_serve_paged.py``'s cases rendered in the port (paged engine
  with the gather path against the bucketed engine): equal streams on
  short, page-crossing and multi-chunk prompts, a request joining
  mid-batch, a chunked prefill interleaved with decode, recycled pages
  serving a new request, and exactly two serving programs
  (``compiled_programs``) for any length mix;
- the speculative engine's ``compiled_programs`` on
  ``tests/test_serve_spec.py``'s mixed run: the four programs JAX's engine
  compiles (its pin of 5 counts its draft decode twice: the first feed is
  a host array, the others device outputs), streams equal JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.api import AutoDist as JAutoDist
from autodist_tpu.models import transformer as JT
from autodist_tpu.serve import BucketedInferenceEngine as JBucketed
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu_torch.models import get_model
from autodist_tpu_torch.models import transformer as TT
from autodist_tpu_torch.models.convert import params_from_jax
from autodist_tpu_torch.serve import BucketedInferenceEngine, BucketSlot
from autodist_tpu_torch.serve.engine import InferenceEngine
from autodist_tpu_torch.serve.server import _admission_capacity
from helpers.torch_spec import port, prompts, rig  # noqa: F401
from helpers.torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
SHAPE = dict(vocab_size=97, num_layers=2, d_model=32, num_heads=2, d_ff=64,
             max_seq_len=32, causal=True)
JCFG = JT.TransformerConfig(**SHAPE, dtype=jnp.float32)
CFG = get_model("transformer", **SHAPE, dtype="float32")
BUCKETS = (16, 32)


@pytest.fixture(scope="module")
def jparams():
    return JT.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def jpaged(jparams):
    JAutoDist.reset_default()
    try:
        yield JAutoDist(strategy_builder=JAllReduce()).build_inference(
            jparams, decode_model=JT.decode_model(JCFG),
            n_slots=8, page_len=8, n_pages=33, prefill_chunk=8)
    finally:
        JAutoDist.reset_default()


@pytest.fixture(scope="module")
def jbucketed(jparams, jpaged):
    return JBucketed(jparams, jpaged.plan, decode_model=JT.decode_model(JCFG),
                     n_slots=4, bucket_lens=BUCKETS)


@pytest.fixture(scope="module")
def bucketed(params, jbucketed):
    return BucketedInferenceEngine(params, TT.decode_model(CFG), n_slots=jbucketed.n_slots,
                                   bucket_lens=BUCKETS, device="cpu")


@pytest.fixture(scope="module")
def paged(params):
    return InferenceEngine(params, TT.decode_model(CFG), n_slots=8, page_len=8,
                           n_pages=33, prefill_chunk=8, device="cpu")


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def prefill_all(engine, slot):
    first = None
    while first is None:
        first = engine.prefill_step(slot)
    return first


# ------------------------------------------------------- stacked-cache decode
def test_prefill_and_decode_match_jax(jparams, params):
    """Prefill two slots of a 4-slot, 32-position cache, then 6 decode steps
    over all four rows: tokens equal, cache within TOL."""
    rng = np.random.default_rng(11)
    n_slots, max_len = 4, 32
    jcache = JT.init_kv_cache(JCFG, n_slots, max_len)
    cache = TT.init_kv_cache(CFG, n_slots, max_len, device="cpu")
    positions = np.zeros(n_slots, np.int32)
    tokens = np.zeros(n_slots, np.int32)
    for slot, length in ((1, 5), (3, 13)):
        padded = np.zeros((1, max_len), np.int32)
        padded[0, :length] = rng.integers(1, 96, size=length)
        jt, jcache = JT.forward_prefill(jparams, jnp.asarray(padded), jnp.int32(length),
                                        jcache, jnp.int32(slot), JCFG)
        with torch.no_grad():
            tt, cache = TT.forward_prefill(params, torch.from_numpy(padded), length,
                                           cache, slot, CFG)
        assert _np(tt).tolist() == np.asarray(jt).tolist()
        positions[slot], tokens[slot] = length, int(np.asarray(jt)[0])
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), np.asarray(jcache[name]),
                                   atol=TOL, rtol=TOL, err_msg=name)
    for _ in range(6):
        jt, jcache = JT.forward_decode_step(jparams, jnp.asarray(tokens),
                                            jnp.asarray(positions), jcache, JCFG)
        with torch.no_grad():
            tt, cache = TT.forward_decode_step(params, torch.from_numpy(tokens),
                                               torch.from_numpy(positions), cache, CFG)
        assert _np(tt).tolist() == np.asarray(jt).tolist()
        tokens, positions = np.asarray(jt).astype(np.int32), positions + 1
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), np.asarray(jcache[name]),
                                   atol=TOL, rtol=TOL, err_msg=name)


def test_decode_model_carries_both_renderings():
    dm = TT.decode_model(CFG)
    for fn in ("init_cache", "prefill", "decode_step", "init_paged_cache",
               "prefill_chunk", "decode_paged", "verify_paged"):
        assert getattr(dm, fn) is not None, fn
    cache = dm.init_cache(3, 16, device="meta")
    assert tuple(cache["k"].shape) == (2, 3, 16, 2, 16) and cache["k"].dtype == torch.float32


# ------------------------------------------------------------ bucketed engine
def test_bucketed_streams_match_jax(bucketed, jbucketed):
    rng = np.random.default_rng(7)
    prompts = [np.array([5, 17, 3, 88, 2], np.int32),
               rng.integers(1, 96, size=12).astype(np.int32),
               rng.integers(1, 96, size=20).astype(np.int32)]
    for p in prompts:
        assert bucketed.generate(p, 10) == jbucketed.generate(p, 10), p


def test_bucketed_batched_steps_match_jax(bucketed, jbucketed):
    """Three requests in two buckets stepping together, one joining late."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 96, size=n).astype(np.int32) for n in (4, 9, 14)]
    news = (8, 6, 12)
    got = {}
    for engine, key in ((bucketed, "port"), (jbucketed, "jax")):
        streams, slots = [], []
        for p, n in zip(prompts[:2], news[:2]):
            slot, first = engine.admit(p, n)
            slots.append(slot)
            streams.append([first])
        out = engine.step()
        for s, stream in zip(slots, streams):
            stream.append(out[s])
        slot, first = engine.admit(prompts[2], news[2])
        slots.append(slot)
        streams.append([first])
        for _ in range(5):
            out = engine.step()
            for s, stream in zip(slots, streams):
                stream.append(out[s])
        for s in slots:
            engine.release(s)
        got[key] = ([(s.bucket, s.index) for s in slots], streams)
    assert got["port"] == got["jax"]
    assert got["port"][0][2][0] == 32          # 14 + 12 tokens: the 32 bucket


def test_bucket_for_spill_budget_and_ceiling(bucketed, jbucketed):
    for total in (1, 16, 17, 32, 33, 100):
        assert bucketed.bucket_for(total) == jbucketed.bucket_for(total), total
    assert bucketed.max_len == jbucketed.max_len == 32
    assert bucketed.kv_pool_tokens == jbucketed.kv_pool_tokens
    prompt = np.array([1, 2, 3], np.int32)
    port, jax_ = [], []
    for _ in range(bucketed.n_slots + 1):          # one past the 16 bucket
        port.append(bucketed.admit(prompt, 4))
        jax_.append(jbucketed.admit(prompt, 4))
    assert [(s.bucket, s.index, t) for s, t in port] == \
        [(s.bucket, s.index, t) for s, t in jax_]
    assert port[-1][0] == BucketSlot(32, 0)        # spilled
    assert bucketed.active_tokens == jbucketed.active_tokens
    assert bucketed.free_slots == jbucketed.free_slots
    # A token budget of 16 forbids the spill.
    assert bucketed.admit(prompt, 4, token_budget=16) is None
    assert jbucketed.admit(prompt, 4, token_budget=16) is None
    for s, _ in port:
        bucketed.release(s)
    for s, _ in jax_:
        jbucketed.release(s)
    assert bucketed.active_slots == jbucketed.active_slots == 0
    for engine in (bucketed, jbucketed):
        with pytest.raises(ValueError, match="largest bucket is 32"):
            engine.admit(np.arange(1, 30, dtype=np.int32), 4)


def test_capacities_match_jax(bucketed, jbucketed):
    assert _admission_capacity(bucketed, 6, 6) == _admission_capacity(jbucketed, 6, 6)
    assert _admission_capacity(bucketed, 6, 20) == _admission_capacity(jbucketed, 6, 20)


def test_bucketed_needs_its_surface(params):
    dm = TT.decode_model(CFG)
    dm.prefill = None
    with pytest.raises(ValueError, match="bucketed surface"):
        BucketedInferenceEngine(params, dm, device="cpu")


# ------------------------------------- tests/test_serve_paged.py in the port
def test_paged_matches_bucketed_greedy_streams(paged, bucketed, jpaged):
    rng = np.random.default_rng(7)
    prompts = [np.array([5, 17, 3, 88, 2], np.int32),
               rng.integers(1, 96, size=12).astype(np.int32),   # crosses a page
               rng.integers(1, 96, size=20).astype(np.int32)]   # 3 prefill chunks
    for p in prompts:
        want = bucketed.generate(p, 10)
        assert paged.generate(p, 10) == want == jpaged.generate(p, 10), p


def test_mid_batch_join_matches_bucketed(paged, bucketed):
    p1 = np.array([3, 9, 27], np.int32)
    p2 = np.array([44, 8, 15, 16, 23], np.int32)
    n = 8
    b1, bf1 = bucketed.admit(p1, n)
    ref1 = [bf1] + [bucketed.step()[b1] for _ in range(3)]
    b2, bf2 = bucketed.admit(p2, n)
    ref2 = [bf2]
    while len(ref1) < n or len(ref2) < n:
        out = bucketed.step()
        if len(ref1) < n:
            ref1.append(out[b1])
        if len(ref2) < n:
            ref2.append(out[b2])
    bucketed.release(b1)
    bucketed.release(b2)

    s1 = paged.admit(p1, n)
    got1 = [prefill_all(paged, s1)] + [paged.step()[s1] for _ in range(3)]
    s2 = paged.admit(p2, n)
    got2 = [prefill_all(paged, s2)]
    while len(got1) < n or len(got2) < n:
        out = paged.step()
        if len(got1) < n:
            got1.append(out[s1])
        if len(got2) < n:
            got2.append(out[s2])
    paged.release(s1)
    paged.release(s2)
    assert got1 == ref1
    assert got2 == ref2


def test_chunked_prefill_interleaves_with_decode(paged, bucketed):
    p_short = np.array([5, 17, 3, 88, 2], np.int32)
    p_long = np.arange(1, 21, dtype=np.int32)           # 3 chunks of 8
    n = 8
    ref_short = bucketed.generate(p_short, n)
    ref_long = bucketed.generate(p_long, n)

    s1 = paged.admit(p_short, n)
    got1 = [prefill_all(paged, s1)]
    s2 = paged.admit(p_long, n)
    got2, chunks = [], 0
    while not got2:
        first = paged.prefill_step(s2)        # ONE chunk...
        chunks += 1
        if first is not None:
            got2.append(first)
        out = paged.step()                    # ...then a decode tick
        if s1 in out and len(got1) < n:
            got1.append(out[s1])
        if got2 and s2 in out and len(got2) < n:
            got2.append(out[s2])
    assert chunks == 3
    assert len(got1) >= 3                     # decode advanced every tick
    while len(got1) < n or len(got2) < n:
        out = paged.step()
        if len(got1) < n:
            got1.append(out[s1])
        if len(got2) < n:
            got2.append(out[s2])
    paged.release(s1)
    paged.release(s2)
    assert got1 == ref_short
    assert got2 == ref_long


def test_page_recycling_after_retirement(paged, bucketed):
    free0 = paged.pool.free_pages
    p = np.array([11, 22, 33, 44], np.int32)
    s = paged.admit(p, 12)                    # 16 tokens -> 2 pages
    held = list(paged._tables[s.index].pages)
    assert paged.pool.free_pages == free0 - 2
    prefill_all(paged, s)
    paged.step()
    paged.release(s)
    assert paged.pool.free_pages == free0

    q = np.array([7, 7, 7], np.int32)
    s2 = paged.admit(q, 12)
    assert set(paged._tables[s2.index].pages) & set(held)   # LIFO reuse
    got = [prefill_all(paged, s2)]
    while len(got) < 12:
        got.append(paged.step()[s2])
    paged.release(s2)
    assert got == bucketed.generate(q, 12)    # stale rows never read


def test_exactly_two_programs_for_any_length_mix(paged, jpaged):
    rng = np.random.default_rng(3)
    for size in (3, 9, 14, 19):
        prompt = rng.integers(1, 96, size=size).astype(np.int32)
        assert paged.generate(prompt, 6) == jpaged.generate(prompt, 6)
    assert paged.compiled_programs == 2 == jpaged.compiled_programs


def test_spec_engine_programs_against_jax(rig, port, prompts):
    _, spec_factory = port
    spec = spec_factory(4, same_draft=True)
    jspec = rig.spec_engine(4, same_draft=True)
    for p in prompts:
        assert spec.generate(p, 6) == jspec.generate(p, 6)
    sizes = {name: getattr(jspec, name)._cache_size() if getattr(jspec, name) else 0
             for name in ("_prefill_fn", "_decode_fn", "_verify_fn", "_draft_prefill_fn",
                          "_draft_decode_fn")}
    assert jspec.compiled_programs == 5 == sum(sizes.values())
    assert sizes["_draft_decode_fn"] == 2 and sizes["_decode_fn"] == 0
    assert spec.compiled_programs == sum(1 for n in sizes.values() if n) == 4
    assert {kind for kind, *_ in spec._programs} == {
        "prefill_chunk", "draft_prefill_chunk", "draft_decode_paged", "verify_paged"}
