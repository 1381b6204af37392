"""Port parity: serving from a checkpoint.

The JAX package's tiny serving model (``serve/server.py::_tiny_engine``:
fp32 transformer, 2 layers, d_model 32, page_len 8) is saved by the JAX
``Saver``; the port's ``AutoDist.build_inference(checkpoint=...)`` restores
it from a template of meta tensors and serves the JAX package's
``build_inference(checkpoint=...)`` greedy streams token for token. A
training checkpoint (the port's ``step.save``: the whole logical state)
serves through the ``params/`` probe in both packages, equal to serving the
trained params from memory. ``InferenceEngine.build`` and
``SpecDecodeEngine.build(checkpoint=, draft_checkpoint=)`` give the same
streams, the CLI's ``--checkpoint`` / ``--draft-checkpoint`` reach the
engine, and ``apply_fn`` beside ``decode_model`` gives one engine that
serves both the one-shot forward and paged decode.
"""
import argparse

import jax
import numpy as np
import pytest
import torch

from autodist_tpu import api as japi
from autodist_tpu.checkpoint import Saver as JSaver
from autodist_tpu.models.transformer import decode_model as jax_decode_model
from autodist_tpu.serve.server import _N_PAGES, _PAGE_LEN, _tiny_engine
from autodist_tpu_torch import api as tapi
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.models import get_model, get_model_spec
from autodist_tpu_torch.models.convert import flatten_params, map_params, params_from_jax
from autodist_tpu_torch.models.transformer import decode_model
from autodist_tpu_torch.serve.engine import InferenceEngine
from autodist_tpu_torch.serve.server import mock_load_prompt
from autodist_tpu_torch.serve.spec import SpecDecodeEngine
from autodist_tpu_torch.strategy import AllReduce

MAX_NEW, N_PROMPTS = 8, 6
TINY = dict(vocab_size=128, num_layers=2, d_model=32, num_heads=2, d_ff=64, max_seq_len=64)
SIZES = dict(n_slots=8, page_len=_PAGE_LEN, n_pages=_N_PAGES, prefill_chunk=_PAGE_LEN)


@pytest.fixture(autouse=True)
def _fresh_autodist():
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()
    yield
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()


def _cfg():
    return get_model("transformer", dtype="float32", **TINY)


def _meta(params):
    return map_params(lambda t: torch.empty_like(t, device="meta"), params)


def _prompts():
    rng = np.random.default_rng(5)
    return [mock_load_prompt(rng, i) for i in range(N_PROMPTS)]


def _streams(engine):
    return [engine.generate(p, MAX_NEW) for p in _prompts()]


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """The tiny model's params saved by the JAX Saver, and JAX's streams
    served from that checkpoint."""
    d = str(tmp_path_factory.mktemp("jax_params"))
    _, jparams, jcfg = _tiny_engine()
    JSaver(d).save(jparams, step=3)
    japi.AutoDist.reset_default()
    try:
        jeng = japi.AutoDist().build_inference(
            jax.eval_shape(lambda: jparams), decode_model=jax_decode_model(jcfg),
            checkpoint=d, **SIZES)
    finally:
        japi.AutoDist.reset_default()
    return d, jparams, _streams(jeng)


def test_build_inference_checkpoint_streams_equal_jax(jax_ckpt):
    d, jparams, want = jax_ckpt
    template = _meta(params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    engine = tapi.AutoDist(strategy_builder=AllReduce(), device="cpu").build_inference(
        template, decode_model=decode_model(_cfg()), checkpoint=d, **SIZES)
    restored = flatten_params(engine.params)
    for name, t in flatten_params(params_from_jax(jax.tree.map(np.asarray, jparams),
                                                  device="cpu")).items():
        assert torch.equal(restored[name], t), name
    assert _streams(engine) == want
    # A ckpt-N path serves the same as its Saver directory.
    tapi.AutoDist.reset_default()
    built = InferenceEngine.build(template, decode_model(_cfg()),
                                  checkpoint=f"{d}/ckpt-3", device="cpu", **SIZES)
    assert _streams(built) == want


def test_spec_engine_build_from_checkpoints(jax_ckpt):
    """Greedy speculative decode is lossless: the same-weights draft,
    restored from the same checkpoint, serves the plain streams."""
    d, jparams, want = jax_ckpt
    template = _meta(params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"))
    engine = SpecDecodeEngine.build(template, template, decode_model(_cfg()),
                                    decode_model(_cfg()), checkpoint=d, draft_checkpoint=d,
                                    spec_k=3, device="cpu", **SIZES)
    assert engine.spec_k == 3
    assert _streams(engine) == want


def test_training_checkpoint_serves_through_the_params_probe(tmp_path):
    """The port's step.save (step, params/, opt_state/) serves in both
    packages as the trained params do from memory."""
    spec = get_model_spec("transformer", dtype="float32", **TINY)
    params = spec.init(0, device="cpu")
    batch = spec.example_batch(8, device="cpu")
    step = tapi.AutoDist(strategy_builder=AllReduce(), device="cpu").build(
        spec.loss_fn, params, batch)
    state, _ = step.run(step.init(params), batch, 2)
    step.save(Saver(str(tmp_path)), state)
    trained = {k: v.detach().clone() for k, v in flatten_params(
        step.logical_params(state)).items()}
    tapi.AutoDist.reset_default()
    from autodist_tpu_torch.models.convert import unflatten_params

    want = _streams(InferenceEngine(unflatten_params(trained), decode_model(_cfg()),
                                    device="cpu", **SIZES))
    engine = tapi.AutoDist(device="cpu").build_inference(
        _meta(params), decode_model=decode_model(_cfg()), checkpoint=str(tmp_path), **SIZES)
    assert _streams(engine) == want

    from autodist_tpu.serve.server import _tiny_cfg

    _, jparams, _ = _tiny_engine()
    japi.AutoDist.reset_default()
    jeng = japi.AutoDist().build_inference(
        jax.eval_shape(lambda: jparams), decode_model=jax_decode_model(_tiny_cfg()),
        checkpoint=str(tmp_path), **SIZES)
    assert _streams(jeng) == want


def test_cli_flags_reach_the_engine(jax_ckpt, monkeypatch):
    from autodist_tpu_torch.serve import __main__ as cli

    d, _, want = jax_ckpt
    seen = {}

    def capture(args):
        seen.update(vars(args))
        raise SystemExit(0)

    monkeypatch.setattr(cli, "build_frontend", capture)
    with pytest.raises(SystemExit):
        cli.main(["--checkpoint", d, "--draft-model", "transformer",
                  "--draft-checkpoint", d, "--device", "cpu"])
    assert seen["checkpoint"] == d and seen["draft_checkpoint"] == d
    monkeypatch.undo()

    args = argparse.Namespace(
        model="transformer", model_arg=[f"{k}={v}" for k, v in TINY.items()]
        + ["dtype=float32"], kv_quant=False, seed=7, device="cpu", slots=8,
        page_len=_PAGE_LEN, pages=_N_PAGES, prefill_chunk=_PAGE_LEN, prefix_cache=False,
        draft_model=None, draft_arg=None, spec_k=4, checkpoint=d, draft_checkpoint=None,
        host="127.0.0.1", port=0)
    engine = cli.build_frontend(args).batcher.engine
    assert _streams(engine) == want


def test_apply_fn_is_not_ported():
    """Once raising (one-shot inference was not ported), ``apply_fn`` now
    rides beside ``decode_model``: one engine serves the uncached forward
    (``infer``, exactly ``spec.apply``) and paged decode."""
    cfg = _cfg()
    spec = get_model_spec("transformer", dtype="float32", **TINY)
    params = spec.init(0, device="cpu")
    tapi.AutoDist.reset_default()
    try:
        engine = tapi.AutoDist(device="cpu").build_inference(
            params, apply_fn=spec.apply, decode_model=decode_model(cfg),
            page_len=_PAGE_LEN, n_pages=_N_PAGES)
    finally:
        tapi.AutoDist.reset_default()
    tokens = torch.arange(1, 17, dtype=torch.int32).reshape(2, 8)
    assert torch.equal(engine.infer(tokens), spec.apply(params, tokens))
    assert len(engine.generate(np.array([5, 17, 3], np.int32), 4)) == 4
