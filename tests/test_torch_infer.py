"""Port parity: one-shot inference (``InferenceEngine.infer``).

The same numpy-seeded inputs through JAX's ``InferenceEngine.infer`` (on the
test mesh) and the port's on the CPU, the weights carried over with
``params_from_jax``, all fp32:

- the zoo ``mlp`` (the case of ``tests/test_serve.py``'s one-shot test):
  1e-5 relative, 1e-6 absolute, and exactly the port's own ``apply``;
- a 2-layer causal ``transformer`` (vocab 128, d 32, 16 tokens): logits
  within 1e-5 absolute and relative;
- a narrow ResNet-50 (width 8, 32 px, 10 classes, batch 8; BatchNorm from
  batch statistics, the fused 1x1 conv + statistics op 36 times, counted
  by a spy): logits within 1e-3 relative L2, the bound
  ``tests/test_torch_resnet.py`` holds the two fp32 ResNet-50 forwards to
  (at initialisation the 50-layer net amplifies the summation-order
  differences of fp32: about 2e-4 here, up to 9e-4 absolute on logits of
  magnitude 4);
- ``AutoDist.build_inference(apply_fn=)`` returns such a one-shot engine,
  ``InferenceEngine.build(params, apply_fn=)`` too, and an engine with
  neither ``apply_fn`` nor ``decode_model`` raises, as JAX's does.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.models import transformer as JT
from autodist_tpu.serve import InferenceEngine as JEngine
from autodist_tpu_torch import api as tapi
from autodist_tpu_torch.models import get_model, get_model_spec
from autodist_tpu_torch.models import resnet as R
from autodist_tpu_torch.models import transformer as TT
from autodist_tpu_torch.models.convert import params_from_jax
from autodist_tpu_torch.ops import fused_conv_stats as fcs
from autodist_tpu_torch.serve.engine import InferenceEngine
from helpers.torch_threads import one_torch_thread  # noqa: F401

JR = importlib.import_module("autodist_tpu.models.resnet")
MLP = dict(in_dim=12, hidden=(16,), num_classes=4)
LM = dict(vocab_size=128, num_layers=2, d_model=32, num_heads=2, d_ff=64,
          max_seq_len=16, causal=True)
RESNET = dict(depth=50, width=8, num_classes=10, image=32, batch=8)


@pytest.fixture(autouse=True)
def _fresh_autodist():
    tapi.AutoDist.reset_default()
    yield
    tapi.AutoDist.reset_default()


def _port(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _close(got, want, atol, rtol):
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=rtol)


def test_mlp_infer_matches_jax():
    jspec = jax_get_model("mlp", **MLP)
    jparams = jspec.init(jax.random.PRNGKey(1))
    x = np.random.default_rng(0).normal(size=(16, 12)).astype(np.float32)
    want = JEngine.build(jparams, apply_fn=jspec.apply).infer(x)
    spec = get_model_spec("mlp", **MLP)
    params = _port(jparams)
    engine = InferenceEngine.build(params, apply_fn=spec.apply, device="cpu")
    got = engine.infer(x)
    _close(got, want, atol=1e-6, rtol=1e-5)
    assert torch.equal(got, spec.apply(params, torch.from_numpy(x)))
    assert not got.requires_grad


def test_transformer_infer_matches_jax():
    jcfg = JT.TransformerConfig(**LM, dtype=jnp.float32)
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(1).integers(1, 128, size=(8, 16)).astype(np.int32)
    want = JEngine.build(jparams, apply_fn=lambda p, t: JT.forward(p, t, jcfg)).infer(tokens)
    cfg = get_model("transformer", **LM, dtype="float32")
    engine = tapi.AutoDist(device="cpu").build_inference(
        _port(jparams), apply_fn=lambda p, t: TT.forward(p, t, cfg))
    got = engine.infer(tokens)
    assert tuple(got.shape) == (8, 16, 128)
    _close(got, want, atol=1e-5, rtol=1e-5)


def _resnet_params():
    """JAX's ResNet tree (``eval_shape`` of its ``init_params``, which
    compiles nothing) filled from numpy: He-normal kernels, unit BatchNorm
    scales, zero biases."""
    shapes = jax.eval_shape(lambda k: JR.init_params(k, RESNET["depth"], RESNET["num_classes"],
                                                     width=RESNET["width"]),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return np.ones(leaf.shape, np.float32)
        if "bias" in name:
            return np.zeros(leaf.shape, np.float32)
        std = np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_resnet_infer_matches_jax(monkeypatch):
    depth = RESNET["depth"]
    jparams = _resnet_params()
    images = np.random.default_rng(4).standard_normal(
        (RESNET["batch"], RESNET["image"], RESNET["image"], 3)).astype(np.float32)
    want = JEngine.build(
        jparams, apply_fn=lambda p, x: JR.forward(p, x, depth, dtype=jnp.float32)).infer(images)
    calls = []
    fused = fcs.fused_matmul_stats
    monkeypatch.setattr(fcs, "fused_matmul_stats",
                        lambda x, w: calls.append(tuple(x.shape)) or fused(x, w))
    engine = InferenceEngine.build(
        _port(jparams), apply_fn=lambda p, x: R.forward(p, x, depth, dtype=torch.float32),
        device="cpu")
    got = engine.infer(images)
    assert tuple(got.shape) == (RESNET["batch"], RESNET["num_classes"])
    want = np.asarray(want)
    assert np.linalg.norm(got.numpy() - want) <= 1e-3 * np.linalg.norm(want)
    assert len(calls) == R.fused_launches_per_forward(depth) == 36


def test_one_shot_engine_has_no_decode_state():
    spec = get_model_spec("mlp", **MLP)
    params = spec.init(0, device="cpu")
    engine = tapi.AutoDist(device="cpu").build_inference(params, apply_fn=spec.apply)
    assert isinstance(engine, InferenceEngine) and engine.decode_model is None
    x = torch.ones((2, 12))
    assert torch.equal(engine.infer(x), spec.apply(params, x))


def test_engine_needs_apply_fn_or_decode_model():
    jparams = jax_get_model("mlp", **MLP).init(jax.random.PRNGKey(1))
    with pytest.raises(ValueError, match="needs apply_fn"):
        JEngine.build(jparams)
    params = get_model_spec("mlp", **MLP).init(0, device="cpu")
    with pytest.raises(ValueError, match="needs apply_fn"):
        InferenceEngine(params, device="cpu")
    with pytest.raises(ValueError, match="needs apply_fn"):
        tapi.AutoDist(device="cpu").build_inference(params)


def test_decode_only_engine_refuses_infer():
    cfg = get_model("transformer", **LM, dtype="float32")
    engine = InferenceEngine(TT.init_params(cfg, device="cpu"), TT.decode_model(cfg),
                             page_len=8, n_pages=17, device="cpu")
    with pytest.raises(ValueError, match="without apply_fn"):
        engine.infer(torch.ones((1, 4), dtype=torch.int32))
