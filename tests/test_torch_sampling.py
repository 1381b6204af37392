"""Port parity: the counter-based stochastic sampling of
``autodist_tpu_torch/serve/sampling.py`` against the JAX package's.

- ``request_key`` (blake2b) equal to JAX's;
- the torch threefry2x32 bits bitwise equal to ``jax.random.bits(
  jax.random.fold_in(key, c), (V,))`` over 256 keys x counters (0 and
  2^31 - 1 among them);
- the Gumbel noise within ``GUMBEL_ULPS`` ulps of ``jax.random.gumbel``,
  ulps taken at ``max(|g|, 1)``: both compute ``-log(-log(u))`` from the
  same bit-exact ``u``, and each ``log`` may round differently in its last
  place, an absolute error of about one ulp of 1 where ``|g| < 1``;
- ``sample_tokens`` equal to JAX's on a seeded grid of 2,160 rows over
  temperature x top_k x top_p, greedy rows bitwise; a row that differs
  must be a near-tie (the two tokens' logit-plus-noise scores within the
  noise's ulp bound), and such rows are held to 0.5%;
- the draw calibrated within the port (``chi_square_fits`` against the
  float64 filtered distribution), ``chi_square_fits`` and the param helpers
  equal to JAX's;
- engine streams: stochastic generate on the port's engine equal to the
  JAX engine's for the same id, seed, prompt and weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_threads import one_torch_thread  # noqa: F401

from autodist_tpu.serve import sampling as JS
from autodist_tpu.serve.server import _N_PAGES, _PAGE_LEN, _tiny_engine
from autodist_tpu_torch.models import get_model
from autodist_tpu_torch.models.convert import params_from_jax
from autodist_tpu_torch.models.transformer import decode_model
from autodist_tpu_torch.serve import sampling as S
from autodist_tpu_torch.serve.engine import InferenceEngine

GUMBEL_ULPS = 4
NEAR_TIE_SHARE = 0.005


def _keys(n, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint64).astype(np.uint32)
    counters = rng.integers(0, 2 ** 31 - 1, size=n).astype(np.int32)
    counters[:3] = (0, 2 ** 31 - 1, 1)
    return keys, counters


@jax.jit
def _jax_bits_and_gumbel(keys, counters):
    def one(key, c):
        k = jax.random.fold_in(key, c)
        return jax.random.bits(k, (512,)), jax.random.gumbel(k, (512,), jnp.float32)

    return jax.vmap(one)(keys, counters)


def _port_noise(keys, counters, fn):
    hi, lo = S.fold_in(torch.from_numpy(keys[:, 0].astype(np.int64)),
                       torch.from_numpy(keys[:, 1].astype(np.int64)),
                       torch.from_numpy(counters.astype(np.int64)))
    return fn(hi, lo, 512).numpy()


def test_request_key_matches_jax():
    for rid in ("", "r1", "g123-45", "ünïcode-id", "x" * 300):
        for seed in (0, 1, 7, 2 ** 40, -3):
            assert S.request_key(rid, seed) == JS.request_key(rid, seed)


def test_threefry_bits_bitwise_equal_jax():
    keys, counters = _keys(256)
    want, _ = _jax_bits_and_gumbel(jnp.asarray(keys), jnp.asarray(counters))
    got = _port_noise(keys, counters, S.random_bits).astype(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(want))


def _ulps(got, want):
    return np.abs(got.astype(np.float64) - want) / np.spacing(
        np.maximum(np.abs(want), 1.0).astype(np.float32)).astype(np.float64)


def test_gumbel_within_ulps_of_jax():
    keys, counters = _keys(256, seed=1)
    _, want = _jax_bits_and_gumbel(jnp.asarray(keys), jnp.asarray(counters))
    got = _port_noise(keys, counters, S.gumbel)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    assert _ulps(got, np.asarray(want, np.float64)).max() <= GUMBEL_ULPS


def _grid(vocab=96, reps=12, seed=2):
    """Rows over temperature x top_k x top_p (greedy included), each row its
    own request key and counter; logits seeded, a few rows with exact ties."""
    rng = np.random.default_rng(seed)
    temps, top_ks, top_ps = (0.0, 0.3, 0.8, 1.0, 1.7), (0, 1, 5, 40), (1.0, 0.9, 0.5)
    combos = [(t, k, p) for t in temps for k in top_ks for p in top_ps] * reps
    rows = len(combos) * 3
    logits = (rng.standard_normal((rows, vocab)) * rng.uniform(0.5, 4.0, (rows, 1))
              ).astype(np.float32)
    logits[::17, 3] = logits[::17, 11] = logits[::17].max(axis=1) + 1.0
    params = np.array(combos * 3, np.float64)
    keys, counters = _keys(rows, seed=seed)
    samp = (params[:, 0].astype(np.float32), params[:, 1].astype(np.int32),
            params[:, 2].astype(np.float32), keys[:, 0], keys[:, 1])
    return logits, counters, samp


def test_sample_tokens_grid_matches_jax():
    logits, counters, samp = _grid()
    n = len(logits)
    assert n >= 2000
    want = np.asarray(jax.jit(JS.sample_tokens)(
        jnp.asarray(logits), jnp.asarray(counters), tuple(jnp.asarray(a) for a in samp)))
    got = S.sample_tokens(torch.from_numpy(logits), torch.from_numpy(counters),
                          samp).numpy()
    greedy = samp[0] <= 0
    np.testing.assert_array_equal(got[greedy], logits[greedy].argmax(-1))
    np.testing.assert_array_equal(got[greedy], want[greedy])
    differ = np.flatnonzero(got != want)
    if len(differ):
        keys = samp[3].astype(np.int64), samp[4].astype(np.int64)
        hi, lo = S.fold_in(torch.from_numpy(keys[0][differ]),
                           torch.from_numpy(keys[1][differ]),
                           torch.from_numpy(counters[differ].astype(np.int64)))
        noise = S.gumbel(hi, lo, logits.shape[1]).numpy().astype(np.float64)
        scaled = logits[differ] / np.maximum(samp[0][differ], 1e-6)[:, None]
        rows = np.arange(len(differ))
        a, b = got[differ], want[differ]
        margin = np.abs((scaled[rows, a] + noise[rows, a]) - (scaled[rows, b] + noise[rows, b]))
        bound = 2 * GUMBEL_ULPS * np.spacing(np.maximum(
            np.maximum(np.abs(noise[rows, a]), np.abs(noise[rows, b])), 1.0).astype(np.float32))
        assert (margin <= bound).all(), (differ, margin, bound)
    assert len(differ) <= NEAR_TIE_SHARE * n


@pytest.mark.parametrize("sp", [
    S.SamplingParams(temperature=1.0),
    S.SamplingParams(temperature=0.7, top_k=5),
    S.SamplingParams(temperature=1.3, top_p=0.8),
    S.SamplingParams(temperature=0.9, top_k=8, top_p=0.9, seed=3),
], ids=["plain", "top_k", "top_p", "both"])
def test_draws_calibrated_chi_square(sp):
    rng = np.random.default_rng(11)
    vocab, n = 16, 4096
    row = rng.normal(0.0, 1.5, vocab).astype(np.float32)
    toks = S.sample_tokens(torch.from_numpy(np.tile(row, (n, 1))), torch.arange(n),
                           S.samp_tuple(sp, "calib", n)).numpy()
    ref = S.filtered_probs(row, sp)
    assert (ref[toks] > 0).all()                      # no masked token drawn
    counts = np.bincount(toks, minlength=vocab)
    fits, stat, crit = S.chi_square_fits(counts, np.maximum(ref, 1e-300))
    assert fits, (stat, crit)
    assert (fits, stat, crit) == JS.chi_square_fits(counts, np.maximum(ref, 1e-300))
    np.testing.assert_allclose(ref, JS._filtered_probs(row, JS.SamplingParams(**sp.to_dict())))
    # A wrong distribution fails by far.
    assert not S.chi_square_fits(counts, np.full(vocab, 1.0 / vocab))[0]


def test_params_helpers_match_jax():
    for t in (0.0, 0.2, 0.5, 0.51, 1.0, 1.5):
        assert S.temperature_bucket(t) == JS.temperature_bucket(t)
    assert S.TEMPERATURE_BUCKETS == JS.TEMPERATURE_BUCKETS
    d = {"temperature": 0.8, "top_k": 4, "top_p": 0.9, "seed": 2}
    assert S.SamplingParams.from_dict(d).to_dict() == JS.SamplingParams.from_dict(d).to_dict()
    assert S.SamplingParams.from_dict(None) is None and S.SamplingParams.from_dict({}) is None
    for bad in ({"top_p": 2.0}, {"temperature": float("nan")}, {"top_k": "x"}):
        with pytest.raises(S.InvalidSamplingParams):
            S.SamplingParams.from_dict(bad)
        with pytest.raises(ValueError):   # JAX's is untyped for a non-number
            JS.SamplingParams.from_dict(bad)


@pytest.fixture(scope="module")
def engines():
    jeng, jparams, _ = _tiny_engine(n_slots=8)
    cfg = get_model("transformer", vocab_size=128, num_layers=2, d_model=32,
                    num_heads=2, d_ff=64, max_seq_len=64, dtype="float32")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    teng = InferenceEngine(params, decode_model(cfg), n_slots=8, page_len=_PAGE_LEN,
                           n_pages=_N_PAGES, prefill_chunk=_PAGE_LEN, device="cpu")
    return jeng, teng


def test_engine_stochastic_streams_equal_jax(engines):
    jeng, teng = engines
    rng = np.random.default_rng(4)
    grid = [S.SamplingParams(temperature=0.8, seed=1),
            S.SamplingParams(temperature=1.0, top_p=0.9, seed=2),
            S.SamplingParams(temperature=1.4, top_k=40, seed=3),
            S.SamplingParams(temperature=0.6, top_k=8, top_p=0.8, seed=4)]
    for i in range(8):
        prompt = rng.integers(1, 127, size=int(rng.integers(3, 20))).astype(np.int32)
        sp = grid[i % len(grid)]
        got = teng.generate(prompt, 10, request_id=f"req-{i}", sampling=sp)
        want = jeng.generate(prompt, 10, request_id=f"req-{i}",
                             sampling=JS.SamplingParams(**sp.to_dict()))
        assert got == want
        assert got == teng.generate(prompt, 10, request_id=f"req-{i}", sampling=sp)
    other = teng.generate(prompt, 10, request_id="req-7",
                          sampling=S.SamplingParams(temperature=0.6, top_k=8, top_p=0.8,
                                                    seed=5))
    assert other != got                                  # another seed, another stream
    assert teng.pool.used_pages == 0


def test_selftest_sampling_cli(capsys):
    from autodist_tpu_torch.serve.__main__ import main

    assert main(["--selftest-sampling"]) == 0
    assert '"ok": true' in capsys.readouterr().out
