"""Port parity: speculative decode's verify forward and rounds against the
JAX package's (the engines' greedy streams: ``tests/test_torch_spec.py``).

- ``models/transformer.py::forward_paged_verify`` on the same params,
  cache, tables and tokens as JAX's (rows whose window passes the table's
  width, an out-of-vocab draft id, fully accepting and rejecting rows;
  greedy and sampled; fp32 and int8 pages): ``accept`` and ``out`` equal,
  the scattered cache within 1e-5 (int8 pages bitwise).
- Stochastic spec streams equal plain stochastic streams (and JAX's).
- Draft-pool accounting balances after hundreds of accept/reject cycles
  through the batcher, with a starved draft pool too, and with a prefix
  cache shared by both pools.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_threads import one_torch_thread  # noqa: F401
from helpers.torch_spec import (MAX_NEW, expected, np_tree, port, prompts,  # noqa: F401
                                rig, tcfg)

from autodist_tpu.models import transformer as jt
from autodist_tpu.serve.sampling import SamplingParams as JaxSamplingParams
from autodist_tpu.serve.server import _tiny_cfg
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.models import transformer as tt
from autodist_tpu_torch.models.convert import params_from_jax
from autodist_tpu_torch.serve import sampling as S
from autodist_tpu_torch.serve.batcher import ContinuousBatcher, RequestState
from autodist_tpu_torch.serve.spec import pools_balanced

CACHE_TOL = 1e-5


# ------------------------------------------------------------ verify forward
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["fp", "kv_quant"])
def test_verify_forward_matches_jax(kv_quant, sampled):
    jcfg = _tiny_cfg(kv_quant=kv_quant)
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_jax(np_tree(jparams), device="cpu")
    port_cfg = tcfg(kv_quant=kv_quant)
    rng = np.random.default_rng(1)
    b, k1, page_len, n_pages, n_tables = 4, 5, 8, 20, 4
    jcache = jt.init_paged_kv_cache(jcfg, n_pages, page_len)
    # Seeded cache contents, the same on both sides.
    filled = {}
    for name, leaf in jcache.items():
        if leaf.dtype == jnp.int8:
            filled[name] = rng.integers(-127, 128, size=leaf.shape).astype(np.int8)
        else:
            filled[name] = rng.uniform(0.0 if "scale" in name else -1.0, 0.05 if "scale"
                                       in name else 1.0, size=leaf.shape).astype(np.float32)
    tables = np.array([[3, 7, 1, 9], [2, 5, 0, 0], [4, 6, 8, 10], [11, 12, 13, 14]],
                      np.int32)
    positions = np.array([5, 13, 29, 30], np.int32)        # rows 2-3 pass the table
    samp = (S.samp_tuple(S.SamplingParams(temperature=0.9, top_k=30, top_p=0.9, seed=2),
                         "verify", b) if sampled else None)

    def run_jax(tokens):
        cache = {k: jnp.asarray(v) for k, v in filled.items()}
        js = None if samp is None else tuple(jnp.asarray(a) for a in samp)
        acc, out, cache = jt.forward_paged_verify(
            jparams, jnp.asarray(tokens), jnp.asarray(positions), cache,
            jnp.asarray(tables), jcfg, samp=js)
        return np.asarray(acc), np.asarray(out), np_tree(cache)

    def run_port(tokens):
        cache = {k: torch.from_numpy(v.copy()) for k, v in filled.items()}
        acc, out, cache = tt.forward_paged_verify(
            tparams, torch.from_numpy(tokens), torch.from_numpy(positions), cache,
            torch.from_numpy(tables), port_cfg, samp=samp)
        return acc.numpy(), out.numpy(), {k: v.numpy() for k, v in cache.items()}

    tokens = rng.integers(1, 127, size=(b, k1)).astype(np.int32)
    # Rows 0 and 2 propose the target's own tokens (full acceptance: each
    # pass fixes one more proposal); row 3 carries an out-of-vocab draft id.
    for _ in range(k1 - 1):
        out = run_jax(tokens)[1]
        tokens[[0, 2], 1:] = out[[0, 2], :-1]
    tokens[3, 2] = 200
    want, got = run_jax(tokens), run_port(tokens)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0][0] == k1 - 1 and got[0][2] == k1 - 1 and got[0][3] <= 1
    for name in want[2]:
        if want[2][name].dtype == np.int8:
            np.testing.assert_array_equal(got[2][name], want[2][name], err_msg=name)
        else:
            np.testing.assert_allclose(got[2][name], want[2][name], atol=CACHE_TOL,
                                       rtol=CACHE_TOL, err_msg=name)


@pytest.mark.parametrize("same_draft", [True, False], ids=["same", "divergent"])
@pytest.mark.parametrize("k", [2, 4])
def test_stochastic_spec_equals_plain_stochastic(rig, port, prompts, k, same_draft):
    plain, spec_engine = port
    spec = spec_engine(k, same_draft)
    for i, p in enumerate(prompts):
        sp = S.SamplingParams(temperature=(0.8, 1.0, 1.5)[i % 3], top_p=0.9,
                              top_k=(0, 40)[i % 2], seed=5)
        rid = f"stoch-{k}-{same_draft}-{i}"
        want = plain.generate(p, MAX_NEW, request_id=rid, sampling=sp)
        assert spec.generate(p, MAX_NEW, request_id=rid, sampling=sp) == want
        if i < 2:
            assert want == rig.plain.generate(p, MAX_NEW, request_id=rid,
                                              sampling=JaxSamplingParams(**sp.to_dict()))
    stats = spec.spec_stats()
    assert stats["by_temperature"].keys() <= {"mid", "high"}
    if same_draft:
        assert spec.acceptance_rate == 1.0
    assert pools_balanced(spec)


@pytest.mark.parametrize("draft_n_pages", [49, 3], ids=["pool", "starved"])
def test_draft_pool_balances_after_accept_reject_cycles(port, prompts, expected,
                                                        draft_n_pages):
    _, spec_engine = port
    spec = spec_engine(4, same_draft=False, draft_n_pages=draft_n_pages)
    registry = M.MetricsRegistry()
    with ContinuousBatcher(spec, max_queue=256, registry=registry) as batcher:
        while spec.proposed_total // spec.spec_k < 300:
            wave = [batcher.submit(prompts[i % len(prompts)], MAX_NEW) for i in range(24)]
            for r in wave:
                r.wait(timeout=120)
            assert all(r.state is RequestState.DONE for r in wave)
            assert [r.tokens for r in wave] == [expected[i % len(prompts)]
                                                for i in range(24)]
    assert pools_balanced(spec)
    stats = spec.spec_stats()
    assert stats["draft_pool_used_pages"] == 0
    assert (stats["draft_starved"] > 0) == (draft_n_pages == 3)
    snap = registry.snapshot()
    assert snap["serve_spec_acceptance_rate"] == pytest.approx(stats["acceptance_rate"])
    assert snap["serve_spec_tokens_per_step"] == pytest.approx(stats["tokens_per_round"])


def test_prefix_cache_spans_both_pools(port, prompts, expected):
    _, spec_engine = port
    spec = spec_engine(4, same_draft=True, prefix_cache=True)
    shared = np.concatenate([prompts[3], prompts[2]])             # 37 tokens
    cow = np.concatenate([shared[:20], [9, 9, 9]]).astype(np.int32)
    plain = port[0]
    for p in (shared, shared, cow, prompts[3]):
        assert spec.generate(p, MAX_NEW) == plain.generate(p, MAX_NEW)
    stats = spec.prefix_stats()
    assert stats["hits"] > 0 and stats["cow_copies"] > 0
    assert spec.prefix_cache.live_refcount == 0
    spec.prefix_cache.purge()
    assert pools_balanced(spec)


def test_selftest_spec_cli(capsys):
    from autodist_tpu_torch.serve.__main__ import main

    assert main(["--selftest-spec"]) == 0
    assert '"ok": true' in capsys.readouterr().out


def test_server_flags_build_the_spec_engine_with_a_prefix_cache():
    import argparse

    from autodist_tpu_torch.serve.__main__ import build_frontend

    args = argparse.Namespace(
        model="transformer", model_arg=["num_layers=2", "d_model=32", "num_heads=2",
                                        "d_ff=64", "vocab_size=128", "max_seq_len=64"],
        kv_quant=False, seed=0, device="cpu", slots=4, page_len=8, pages=None,
        prefill_chunk=None, prefix_cache=True, draft_model="transformer",
        draft_arg=["num_layers=1", "d_model=32", "num_heads=2", "d_ff=64",
                   "vocab_size=128", "max_seq_len=64"], spec_k=3,
        checkpoint=None, draft_checkpoint=None,
        host="127.0.0.1", port=0)
    engine = build_frontend(args).batcher.engine
    assert engine.spec_k == 3 and engine.prefix_cache is not None
    assert engine.prefix_cache.draft_pool is engine.draft_pool
    sp = S.SamplingParams(temperature=0.9, seed=1)
    prompt = [5, 17, 3, 88, 2, 9, 4, 1, 7]
    assert engine.generate(prompt, 6, request_id="x", sampling=sp) == \
        engine.generate(prompt, 6, request_id="x", sampling=sp)
