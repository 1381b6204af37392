"""Port parity: greedy serving through the port's engine, batcher and HTTP
front end vs the JAX package's tiny serving engine.

The JAX side is ``serve/server.py::_tiny_engine`` (tiny fp32 transformer,
page_len 8, 56 pages); the port gets the same weights via
``params_from_jax`` and runs on ``device="cpu"`` (the plain path). Greedy
token streams must be identical, kv_quant off and on.
"""
import asyncio
import json

import jax
import numpy as np
import pytest
import torch

from autodist_tpu.serve.server import _N_PAGES, _PAGE_LEN, _tiny_engine
from autodist_tpu.serve.sampling import SamplingParams as JaxSamplingParams
from autodist_tpu.serve.server import mock_load_prompt as jax_mock_load_prompt
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.models import get_model
from autodist_tpu_torch.models.convert import params_from_jax
from autodist_tpu_torch.models.transformer import decode_model, init_params
from autodist_tpu_torch.serve import sampling as S
from autodist_tpu_torch.serve.batcher import ContinuousBatcher, RequestState
from autodist_tpu_torch.serve.engine import AdmissionDenied, InferenceEngine
from autodist_tpu_torch.serve.server import ServeFrontend, mock_load_prompt

MAX_NEW = 12


def _port_engine(jparams, kv_quant, n_slots=32, device="cpu"):
    cfg = get_model("transformer", vocab_size=128, num_layers=2, d_model=32,
                    num_heads=2, d_ff=64, max_seq_len=64, dtype="float32",
                    kv_quant=kv_quant)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return InferenceEngine(params, decode_model(cfg), n_slots=n_slots,
                           page_len=_PAGE_LEN, n_pages=_N_PAGES,
                           prefill_chunk=_PAGE_LEN, device=device)


@pytest.fixture(scope="module", params=[False, True], ids=["fp", "kv_quant"])
def engines(request):
    jeng, jparams, _ = _tiny_engine(kv_quant=request.param)
    return jeng, _port_engine(jparams, request.param)


def test_greedy_streams_equal_jax(engines):
    jeng, teng = engines
    assert teng.kv_quant == jeng.kv_quant
    assert teng.pool.n_pages == jeng.pool.n_pages and teng.max_len == jeng.max_len
    assert teng.quant_capacity_x == pytest.approx(jeng.quant_capacity_x)
    rng = np.random.default_rng(0)
    for i in range(10):
        prompt = mock_load_prompt(rng, i)
        assert teng.generate(prompt, MAX_NEW) == jeng.generate(prompt, MAX_NEW)
    assert teng.pool.used_pages == 0


def test_mock_load_prompt_matches_jax():
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for i in range(16):
        np.testing.assert_array_equal(mock_load_prompt(a, i),
                                      jax_mock_load_prompt(b, i))


def test_batcher_concurrent_requests_complete_without_leaks(engines):
    jeng, teng = engines
    rng = np.random.default_rng(1)
    prompts = [mock_load_prompt(rng, i) for i in range(16)]
    registry = M.MetricsRegistry()
    with ContinuousBatcher(teng, registry=registry) as batcher:
        reqs = [batcher.submit(p, MAX_NEW) for p in prompts]
        for r in reqs:
            r.wait(timeout=120)
    assert [r.state for r in reqs] == [RequestState.DONE] * 16
    for p, r in zip(prompts[:4], reqs[:4]):
        assert r.tokens == jeng.generate(p, MAX_NEW)
    assert teng.pool.used_pages == 0 and teng.active_slots == 0
    snap = registry.snapshot()
    assert snap["serve_requests_completed_total"] == 16
    assert snap["serve_tokens_generated_total"] == 16 * MAX_NEW
    assert snap["serve_ttft_s"]["count"] == 16


def _http(port, method, path, body=None):
    async def go():
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        data = json.dumps(body).encode() if body is not None else b""
        writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                     f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
        await writer.drain()
        raw = await reader.read()
        writer.close()
        head, _, payload = raw.partition(b"\r\n\r\n")
        return int(head.split()[1]), payload.decode()

    return go()


def test_frontend_generate_round_trip():
    _, jparams, _ = _tiny_engine()
    teng = _port_engine(jparams, False, n_slots=4)
    prompt = [5, 17, 3, 88, 2]
    want = teng.generate(prompt, 6)

    async def scenario():
        fe = await ServeFrontend(ContinuousBatcher(teng, registry=M.MetricsRegistry()),
                                 port=0).start()
        try:
            gen = await _http(fe.port, "POST", "/generate",
                              {"tokens": prompt, "max_new_tokens": 6})
            hot = await _http(fe.port, "POST", "/generate",
                              {"tokens": prompt, "max_new_tokens": 6,
                               "temperature": 0.8})
            health = await _http(fe.port, "GET", "/healthz")
            metrics = await _http(fe.port, "GET", "/metrics")
        finally:
            await fe.close()
        return gen, hot, health, metrics

    gen, hot, health, metrics = asyncio.run(scenario())
    assert gen[0] == 200 and json.loads(gen[1])["tokens"] == want
    # temperature > 0 is served (the stochastic draw; its stream is held to
    # JAX's in tests/test_torch_sampling.py).
    assert hot[0] == 200 and json.loads(hot[1])["state"] == "done"
    assert len(json.loads(hot[1])["tokens"]) == 6
    assert health[0] == 200 and json.loads(health[1])["ok"] is True
    assert metrics[0] == 200 and "serve_requests_completed_total 2" in metrics[1]


def test_stochastic_sampling_refused_typed():
    """``temperature > 0`` is served (it was refused before the stochastic
    draw was ported) and its stream is a pure function of ``(request_id,
    seed)``; malformed params still get the typed rejection, and a POST
    with them the typed 400."""
    jeng, jparams, _ = _tiny_engine()
    teng = _port_engine(jparams, False, n_slots=4)
    hot = S.SamplingParams(temperature=0.7, top_k=20, top_p=0.9, seed=3)
    prompt = [5, 17, 3, 88, 2]
    a = teng.generate(prompt, 8, request_id="r1", sampling=hot)
    assert a == teng.generate(prompt, 8, request_id="r1", sampling=hot)
    assert a == jeng.generate(np.asarray(prompt, np.int32), 8, request_id="r1",
                              sampling=JaxSamplingParams(**hot.to_dict()))
    registry = M.MetricsRegistry()
    with ContinuousBatcher(teng, registry=registry) as batcher:
        req = batcher.submit(prompt, 8, request_id="r1", sampling=hot).wait(120)
    assert req.state is RequestState.DONE and req.tokens == a
    batcher = ContinuousBatcher(teng, registry=M.MetricsRegistry())
    for bad in (S.SamplingParams(top_p=0.0), S.SamplingParams(temperature=-1.0),
                S.SamplingParams(top_k=-2)):
        with pytest.raises(S.InvalidSamplingParams):
            batcher.submit([1, 2, 3], 4, sampling=bad)
        with pytest.raises(S.InvalidSamplingParams):
            teng.admit([1, 2, 3], 4, sampling=bad)
        req = batcher.try_submit([1, 2, 3], 4, sampling=bad)
        assert req.state is RequestState.REJECTED
    with pytest.raises(S.InvalidSamplingParams):
        S.SamplingParams.from_dict({"temperature": "hot"})

    async def scenario():
        fe = await ServeFrontend(ContinuousBatcher(teng, registry=M.MetricsRegistry()),
                                 port=0).start()
        try:
            return await _http(fe.port, "POST", "/generate",
                               {"tokens": prompt, "max_new_tokens": 4, "top_p": 0.0})
        finally:
            await fe.close()

    code, body = asyncio.run(scenario())
    assert code == 400 and json.loads(body)["type"] == "invalid_sampling_params"
    # Greedy params are served as greedy.
    assert teng.generate([1, 2, 3], 3, sampling=S.SamplingParams()) == \
        teng.generate([1, 2, 3], 3)
    denied = teng.admit([1] * 60, 10)
    assert isinstance(denied, AdmissionDenied) and not denied.retryable


def test_greedy_sample_tokens_matches_jax():
    from autodist_tpu.serve.sampling import sample_tokens as jax_sample_tokens
    from autodist_tpu.serve.sampling import slot_arrays as jax_slot_arrays

    rng = np.random.default_rng(2)
    logits = rng.standard_normal((6, 40)).astype(np.float32)
    logits[0, [3, 9]] = 10.0                          # tie: first max wins
    samp = jax_slot_arrays(6)
    tup = tuple(samp[k] for k in ("temperature", "top_k", "top_p", "key_hi", "key_lo"))
    counters = np.arange(6, dtype=np.int32)
    want = np.asarray(jax_sample_tokens(logits, counters, tup))
    got = S.sample_tokens(torch.from_numpy(logits), torch.from_numpy(counters), tup)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 3
    # Stochastic rows are served too (the full grid: test_torch_sampling.py).
    hot = (np.full(6, 0.5, np.float32),) + tup[1:]
    np.testing.assert_array_equal(
        S.sample_tokens(torch.from_numpy(logits), torch.from_numpy(counters), hot).numpy(),
        np.asarray(jax_sample_tokens(logits, counters, hot)))
    port = S.slot_arrays(6)
    assert {k: (v.dtype, v.tolist()) for k, v in port.items()} == \
        {k: (v.dtype, v.tolist()) for k, v in samp.items()}


def test_cuda_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_model("transformer", vocab_size=64, num_layers=1, d_model=16,
                    num_heads=1, d_ff=32, max_seq_len=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(params, decode_model(cfg), n_slots=2)
    from autodist_tpu_torch.serve.__main__ import main
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--model-arg", "num_layers=1", "--port", "0"])
