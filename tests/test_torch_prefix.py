"""Port parity: copy-on-write prefix sharing (``serve/prefix.py`` and the
engine's prefix path) against the JAX package's.

- The same seeded sequence of match / acquire / insert / evict / release /
  cancel / purge on the port's and JAX's ``PrefixCache`` (each over its own
  package's page pool) gives the same pages, refcounts and stats at every
  step.
- Engine streams with the prefix cache equal the JAX engine's (its
  ``_tiny_engine(prefix_cache=True)``, weights carried over) and the port's
  own cold streams, kv_quant off and on: cold inserts, warm matches, a
  mid-page copy-on-write divergence, stochastic hit vs cold, and concurrent
  joins through the batcher; ``prefix_stats`` (COW copies included) equal
  to JAX's after each pass; refcounts back to zero and every pool page
  back after ``purge``.
- Eviction under pool pressure never reclaims a page under a live lease.
"""
import jax
import numpy as np
import pytest
from helpers.torch_threads import one_torch_thread  # noqa: F401

from autodist_tpu.serve import pages as JP
from autodist_tpu.serve import prefix as JX
from autodist_tpu.serve.sampling import SamplingParams as JaxSamplingParams
from autodist_tpu.serve.server import _N_PAGES, _PAGE_LEN, _tiny_engine
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.models import get_model
from autodist_tpu_torch.models.convert import params_from_jax
from autodist_tpu_torch.models.transformer import decode_model
from autodist_tpu_torch.serve import pages as TP
from autodist_tpu_torch.serve import prefix as TX
from autodist_tpu_torch.serve.batcher import ContinuousBatcher, RequestState
from autodist_tpu_torch.serve.engine import AdmissionDenied, InferenceEngine
from autodist_tpu_torch.serve.sampling import SamplingParams
from autodist_tpu_torch.serve.spec import pools_balanced

MAX_NEW = 8


def _drive(prefix_mod, pages_mod, seed, n_ops=300, page_len=4, n_pages=24):
    """A seeded admission/retirement workload straight on the tree and its
    pool, as the engine drives them; returns the log of every outcome."""
    pool = pages_mod.build_pool(n_pages, page_len)
    cache = prefix_mod.build_prefix_cache(pool, page_len)
    rng = np.random.default_rng(seed)
    stems = [rng.integers(1, 6, size=14).astype(np.int32) for _ in range(3)]
    live, log = [], []

    def snapshot(tag, *extra):
        nodes = sorted((p, nd.refcount) for p, nd in cache._owned.items())
        log.append((tag, *extra, pool.free_pages, pool.used_pages, nodes,
                    sorted(cache.stats().items())))

    for _ in range(n_ops):
        op = int(rng.integers(0, 5))
        if op <= 1 or not live:
            stem = stems[int(rng.integers(0, 3))][: int(rng.integers(0, 15))]
            prompt = np.concatenate([stem, rng.integers(1, 6, size=int(rng.integers(1, 6)))
                                     ]).astype(np.int32)
            m = cache.match(prompt)
            lease = cache.acquire(m)
            need = len(prompt) + 2 - m.n_full * page_len
            table = pool.alloc(need)
            while table is None and cache.evict(
                    pages_mod.pages_for_tokens(need, page_len)):
                table = pool.alloc(need)
            tail = (m.tail_node.page if m.tail_node is not None else None, m.tail_len)
            if table is None:
                cache.cancel(lease)
                snapshot("denied", [nd.page for nd in m.nodes], tail)
                continue
            if not m.tail_len or rng.random() < 0.5:
                cache.unpin_tail(lease)
            table.pages[:0] = lease.pages
            live.append([prompt, table, lease, False])
            snapshot("admit", list(table.pages), tail)
        elif op == 2:
            entry = live[int(rng.integers(0, len(live)))]
            if not entry[3]:
                entry[3] = True
                snapshot("insert", cache.insert(entry[0], entry[1].pages, entry[2]))
        elif op == 3:
            prompt, table, lease, _ = live.pop(int(rng.integers(0, len(live))))
            shared = set(lease.pages)
            exclusive = [p for p in table.pages if p not in shared]
            cache.release(lease)
            if exclusive:
                pool.reclaim(exclusive)
            snapshot("release", sorted(exclusive))
        else:
            snapshot("evict", cache.evict(int(rng.integers(1, 4))))
    for prompt, table, lease, _ in live:
        shared = set(lease.pages)
        cache.release(lease)
        pool.reclaim([p for p in table.pages if p not in shared])
    snapshot("drained", cache.live_refcount)
    snapshot("purge", cache.purge())
    assert pool.used_pages == 0 and pool.free_pages == pool.usable_pages
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_radix_sequences_equal_jax(seed):
    want = _drive(JX, JP, seed)
    got = _drive(TX, TP, seed)
    assert got == want
    tags = {entry[0] for entry in got}
    assert {"admit", "insert", "release", "evict"} <= tags


def test_block_hashes_equal_jax():
    toks = np.random.default_rng(5).integers(0, 1000, size=37)
    assert TX.block_hashes(toks, 8) == JX.block_hashes(toks, 8)
    assert TX.block_hashes(toks, 4, limit=3) == JX.block_hashes(toks, 4, limit=3)


def _port_engine(jparams, kv_quant, **kw):
    cfg = get_model("transformer", vocab_size=128, num_layers=2, d_model=32,
                    num_heads=2, d_ff=64, max_seq_len=64, dtype="float32",
                    kv_quant=kv_quant)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return InferenceEngine(params, decode_model(cfg), **dict(dict(
        n_slots=32, page_len=_PAGE_LEN, n_pages=_N_PAGES, prefill_chunk=_PAGE_LEN,
        device="cpu"), **kw))


@pytest.fixture(scope="module", params=[False, True], ids=["fp", "kv_quant"])
def engines(request):
    jeng, jparams, _ = _tiny_engine(prefix_cache=True, kv_quant=request.param)
    return (jeng, _port_engine(jparams, request.param, prefix_cache=True),
            _port_engine(jparams, request.param))


def _workload():
    rng = np.random.default_rng(7)
    system = rng.integers(1, 127, size=26).astype(np.int32)   # 3 blocks + 2
    suffix = [rng.integers(1, 127, size=int(n)).astype(np.int32)
              for n in rng.integers(1, 14, size=8)]
    prompts = [np.concatenate([system, s]) for s in suffix]
    # Mid-page divergence: the first 29 tokens of a cached prompt, then new.
    cow = np.concatenate([prompts[0][:29], rng.integers(1, 127, size=3)]).astype(np.int32)
    return prompts, cow


def test_streams_equal_jax_and_cold(engines):
    jeng, teng, cold = engines
    prompts, cow = _workload()
    for label, batch in (("cold", prompts), ("warm", prompts), ("cow", [cow])):
        for p in batch:
            got = teng.generate(p, MAX_NEW)
            assert got == jeng.generate(p, MAX_NEW), label
            assert got == cold.generate(p, MAX_NEW), label
        assert teng.prefix_stats() == jeng.prefix_stats(), label
    stats = teng.prefix_stats()
    assert stats["hits"] > 0 and stats["cow_copies"] > 0
    # Stochastic: a cache hit draws the cold start's stream, and JAX's.
    sp = SamplingParams(temperature=1.0, top_p=0.9, seed=4)
    jsp = JaxSamplingParams(**sp.to_dict())
    for i, p in enumerate(prompts[:3]):
        got = teng.generate(p, MAX_NEW, request_id=f"s{i}", sampling=sp)
        assert got == cold.generate(p, MAX_NEW, request_id=f"s{i}", sampling=sp)
        assert got == jeng.generate(p, MAX_NEW, request_id=f"s{i}", sampling=jsp)
    assert teng.prefix_stats() == jeng.prefix_stats()
    assert teng.prefix_cache.live_refcount == 0
    assert teng.pool.used_pages == teng.prefix_cache.cached_pages


def test_batcher_joins_and_pools_balance(engines):
    jeng, teng, cold = engines
    prompts, cow = _workload()
    want = [cold.generate(p, MAX_NEW) for p in prompts + [cow]]
    registry = M.MetricsRegistry()
    with ContinuousBatcher(teng, registry=registry) as batcher:
        reqs = [batcher.submit(p, MAX_NEW) for p in (prompts + [cow]) * 3]
        for r in reqs:
            r.wait(timeout=120)
    assert all(r.state is RequestState.DONE for r in reqs)
    assert [r.tokens for r in reqs] == want * 3
    assert any(r.cached for r in reqs)
    snap = registry.snapshot()
    assert snap["serve_ttft_cached_s"]["count"] + snap["serve_ttft_uncached_s"]["count"] \
        == len(reqs)
    assert 0.0 < snap["serve_prefix_hit_rate"] <= 1.0
    cache = teng.prefix_cache
    assert cache.live_refcount == 0 and teng.pool.used_pages == cache.cached_pages
    assert teng.sharing_ratio == 1.0 and teng.shared_fraction == 0.0   # idle
    cache.purge()
    assert pools_balanced(teng) and pools_balanced(cold)


def test_eviction_never_touches_a_live_lease():
    _, jparams, _ = _tiny_engine()
    eng = _port_engine(jparams, False, n_slots=4, n_pages=20, prefix_cache=True)
    cold = _port_engine(jparams, False, n_slots=4)
    rng = np.random.default_rng(9)
    long_prompt = rng.integers(1, 127, size=40).astype(np.int32)
    eng.generate(long_prompt, MAX_NEW)                       # cached: 5 blocks
    # A live lease on those blocks, held mid-prefill (decode rounds of the
    # generate calls below would otherwise advance it).
    slot = eng.admit(long_prompt, MAX_NEW)
    assert not isinstance(slot, AdmissionDenied) and eng.slot_cached(slot)
    live_pages = list(eng._leases[slot.index].pages)
    evictions = eng.prefix_cache.evictions
    for i in range(12):                                      # pressure: new prefixes
        p = rng.integers(1, 127, size=30).astype(np.int32)
        assert eng.generate(p, MAX_NEW) == cold.generate(p, MAX_NEW)
    assert eng.prefix_cache.evictions > evictions
    owned = eng.prefix_cache._owned
    assert all(p in owned and owned[p].refcount >= 1 for p in live_pages)
    first = None
    while first is None:
        first = eng.prefill_step(slot)
    tokens = [first]
    while len(tokens) < MAX_NEW:
        tokens += eng.step_many()[slot]
    eng.release(slot)
    assert tokens[:MAX_NEW] == cold.generate(long_prompt, MAX_NEW)
    eng.prefix_cache.purge()
    assert pools_balanced(eng)


def test_selftest_prefix_cli(capsys):
    from autodist_tpu_torch.serve.__main__ import main

    assert main(["--selftest-prefix"]) == 0
    assert '"ok": true' in capsys.readouterr().out


def test_prefix_hit_chunk_past_the_table_matches_cold():
    """prefill_chunk 16 over 8-token pages: a prefix hit that resumes at
    position 53 prefills [53, 69), past the 64-token table. The port sends
    positions 64..68 to the scratch page, so the hit's stream equals the
    cold one (the JAX engine's cold stream here; its own prefix hit clamps
    them onto the table's last page over prompt KV: ROADMAP Queue 3)."""
    from autodist_tpu.api import AutoDist
    from autodist_tpu.models.transformer import decode_model as jax_decode_model

    _, jparams, jcfg = _tiny_engine()
    build = dict(n_slots=4, page_len=8, n_pages=56, prefill_chunk=16)
    AutoDist.reset_default()
    jcold = AutoDist().build_inference(jparams, decode_model=jax_decode_model(jcfg),
                                       **build)
    AutoDist.reset_default()
    rng = np.random.default_rng(0)
    first = rng.integers(1, 127, size=60).astype(np.int32)
    second = np.concatenate([first[:53], rng.integers(1, 127, size=7)]).astype(np.int32)
    eng = _port_engine(jparams, False, prefix_cache=True, **build)
    eng.generate(first, 4)
    assert eng.generate(second, 4) == jcold.generate(second, 4)
    stats = eng.prefix_stats()
    assert stats["cow_copies"] == 1 and stats["hits"] == 6
    eng.prefix_cache.purge()
    assert pools_balanced(eng)
