"""Port parity: the port's paged transformer forwards vs the JAX package.

Weights come from the JAX ``init_params`` and are carried over with
``params_from_jax``; inputs are seeded numpy arrays fed to both packages.
Tiny fp32 config (``serve/server.py::_tiny_cfg``: 2 layers, d=32). Bars:
logits to 1e-4, tokens equal, caches to 1e-5 (int8 pages bit-equal), and
the paged stream agrees with the uncached one-shot ``forward``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.model_item import _path_to_name
from autodist_tpu.models import transformer as jt
from autodist_tpu.serve.server import _tiny_cfg
from autodist_tpu_torch.models import get_model
from autodist_tpu_torch.models import transformer as tt
from autodist_tpu_torch.models.convert import flatten_params, params_from_jax

PAGE_LEN, N_PAGES = 8, 12
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5


def _setup(kv_quant):
    jcfg = _tiny_cfg(kv_quant=kv_quant)
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = get_model("transformer", vocab_size=128, num_layers=2, d_model=32,
                     num_heads=2, d_ff=64, max_seq_len=64, dtype="float32",
                     kv_quant=kv_quant)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _assert_caches_close(jcache, tcache):
    assert set(jcache) == set(tcache)
    for name in jcache:
        want, got = np.asarray(jcache[name]), tcache[name].numpy()
        if want.dtype == np.int8:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, atol=CACHE_TOL, rtol=CACHE_TOL,
                                       err_msg=name)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_prefill_chunks_and_decode_steps_match_jax(kv_quant):
    jcfg, jparams, tcfg, tparams = _setup(kv_quant)
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, 127, size=13).astype(np.int32)   # two chunks
    table = np.array([5, 2, 9, 1, 0, 0, 0, 0], np.int32)        # shuffled + scratch
    jcache = jt.init_paged_kv_cache(jcfg, N_PAGES, PAGE_LEN)
    tcache = tt.init_paged_kv_cache(tcfg, N_PAGES, PAGE_LEN, device="cpu")
    for start in (0, PAGE_LEN):
        chunk = np.zeros((1, PAGE_LEN), np.int32)
        part = prompt[start:start + PAGE_LEN]
        chunk[0, :len(part)] = part
        jtok, jcache = jt.forward_paged_prefill_chunk(
            jparams, jnp.asarray(chunk), start, len(prompt), jcache,
            jnp.asarray(table), jcfg)
        ttok, tcache = tt.forward_paged_prefill_chunk(
            tparams, torch.from_numpy(chunk), start, len(prompt), tcache,
            torch.from_numpy(table), tcfg)
        assert ttok.tolist() == np.asarray(jtok).tolist()
    _assert_caches_close(jcache, tcache)

    # Two decode rows: the prompt's row and an idle all-scratch row.
    tables = np.stack([table, np.zeros_like(table)])
    tokens = np.array([int(np.asarray(jtok)[0]), 0], np.int32)
    positions = np.array([len(prompt), 0], np.int32)
    for _ in range(4):
        jtok, jlog, jcache = jt.forward_paged_decode_step(
            jparams, jnp.asarray(tokens), jnp.asarray(positions), jcache,
            jnp.asarray(tables), jcfg, return_logits=True)
        ttok, tlog, tcache = tt.forward_paged_decode_step(
            tparams, torch.from_numpy(tokens), torch.from_numpy(positions), tcache,
            torch.from_numpy(tables), tcfg, return_logits=True)
        np.testing.assert_allclose(tlog.numpy()[0], np.asarray(jlog)[0],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        assert ttok.numpy()[0] == np.asarray(jtok)[0]
        tokens = np.array([int(np.asarray(jtok)[0]), 0], np.int32)
        positions = positions + np.array([1, 0], np.int32)
    # Row 1 only ever wrote scratch page 0; the live pages must agree.
    live = [p for p in range(N_PAGES) if p != 0]
    _assert_caches_close({k: np.asarray(v)[:, live] for k, v in jcache.items()},
                         {k: v[:, live] for k, v in tcache.items()})


def test_uncached_forward_matches_jax_and_paged_stream():
    jcfg, jparams, tcfg, tparams = _setup(False)
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, 127, size=(2, 20)).astype(np.int32)
    want = np.asarray(jt.forward(jparams, jnp.asarray(tokens), jcfg))
    got = tt.forward(tparams, torch.from_numpy(tokens), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=LOGIT_TOL)

    # Greedy paged decode of row 0 reproduces the uncached logits per step.
    prompt = tokens[0, :9]
    table = torch.tensor([3, 7, 1, 4, 0, 0, 0, 0], dtype=torch.int32)
    cache = tt.init_paged_kv_cache(tcfg, N_PAGES, PAGE_LEN, device="cpu")
    seq = list(prompt)
    for start in (0, PAGE_LEN):
        chunk = torch.zeros((1, PAGE_LEN), dtype=torch.int32)
        part = torch.from_numpy(prompt[start:start + PAGE_LEN])
        chunk[0, :len(part)] = part
        tok, cache = tt.forward_paged_prefill_chunk(
            tparams, chunk, start, len(prompt), cache, table, tcfg)
    seq.append(int(tok[0]))
    for _ in range(6):
        pos = len(seq) - 1
        tok, logits, cache = tt.forward_paged_decode_step(
            tparams, torch.tensor([seq[-1]], dtype=torch.int32),
            torch.tensor([pos], dtype=torch.int32), cache, table[None], tcfg,
            return_logits=True)
        full = tt.forward(tparams, torch.tensor([seq], dtype=torch.int32), tcfg)
        torch.testing.assert_close(logits[0], full[0, pos], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
        assert int(tok[0]) == int(torch.argmax(full[0, pos]))
        seq.append(int(tok[0]))


def test_param_names_follow_jax_path_names():
    _, jparams, _, tparams = _setup(False)
    leaves, _ = jax.tree_util.tree_flatten_with_path(jparams)
    jax_names = {_path_to_name(path) for path, _ in leaves}
    flat = flatten_params(tparams)
    assert set(flat) == jax_names
    cfg = tt.TransformerConfig(vocab_size=128, num_layers=2, d_model=32,
                               num_heads=2, d_ff=64, max_seq_len=64)
    fresh = tt.init_params(cfg, seed=3, device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten_params(fresh).items()} == \
        {_path_to_name(p): tuple(x.shape) for p, x in leaves}
    assert sum(v.numel() for v in flat.values()) == cfg.param_count()


def test_init_params_is_seeded():
    cfg = tt.TransformerConfig(vocab_size=64, num_layers=1, d_model=16,
                               num_heads=1, d_ff=32, max_seq_len=16)
    a = flatten_params(tt.init_params(cfg, seed=7, device="cpu"))
    b = flatten_params(tt.init_params(cfg, seed=7, device="cpu"))
    c = flatten_params(tt.init_params(cfg, seed=8, device="cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed/embedding"], c["embed/embedding"])
