"""Port parity: the serving export (``checkpoint/saved_model.py``).

- A dense ``x @ w + b`` exported by both packages from the same numpy
  params: the loaded programs' outputs within 1e-6 of each other, the same
  manifest fields (``n_params``, ``leaf_index_width``, ``n_example_args``,
  ``in_avals``, ``out_avals``), and the port's ``params/`` checkpoint read
  by the JAX ``Saver`` as JAX's own.
- A custom pytree (a ``NamedTuple`` of params), as the JAX package's test
  holds it: the loader never needs the class.
- A small bert-style transformer forward (fp32, seq 128, flash attention):
  the loaded program equals the eager forward bitwise on the CPU's plain
  path, calls the flash forward's operator (``ops/library.py``) once a
  layer, and is within 1e-5 of the JAX package's forward (dot attention).
- The fused conv-stats and paged-attention operators are what a traced
  1x1 conv + BatchNorm and a paged attention call export to, with the
  eager results.
"""
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import torch

from autodist_tpu.checkpoint import SavedModelBuilder as JBuilder
from autodist_tpu.checkpoint import Saver as JSaver
from autodist_tpu.checkpoint import load_saved_model as jload
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu_torch.checkpoint import SavedModelBuilder, load_saved_model
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models import transformer as tt
from autodist_tpu_torch.models.convert import params_from_jax
from autodist_tpu_torch.ops import paged_attention as pa
from test_torch_zoo import fill_params

BERT = dict(vocab_size=101, num_layers=2, d_model=64, num_heads=2, d_ff=128, max_seq_len=128)


def _ops(serve):
    return [str(n.target) for n in serve.exported.graph.nodes
            if str(n.target).startswith("autodist_tpu_torch.")]


def test_dense_round_trip_equals_jax(tmp_path):
    rng = np.random.default_rng(9)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    x = rng.standard_normal((5, 8)).astype(np.float32)

    JBuilder(lambda p, x: x @ p["w"] + p["b"]).save(
        str(tmp_path / "jax"), {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    SavedModelBuilder(lambda p, x: x @ p["w"] + p["b"]).save(
        str(tmp_path / "port"), {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
        torch.from_numpy(x))
    want = np.asarray(jload(str(tmp_path / "jax"))(x))
    got = load_saved_model(str(tmp_path / "port"))(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, x @ w + b, rtol=1e-6, atol=1e-6)

    import json

    def manifest(d):
        with open(f"{d}/saved_model.json", encoding="utf-8") as f:
            return json.load(f)

    jm, tm = manifest(tmp_path / "jax"), manifest(tmp_path / "port")
    for key in ("n_params", "leaf_index_width", "n_example_args", "in_avals", "out_avals"):
        assert tm[key] == jm[key], key
    leaves = JSaver().restore(str(tmp_path / "port" / "params"))
    np.testing.assert_array_equal(leaves["0000"], b)       # sorted keys: b, then w
    np.testing.assert_array_equal(leaves["0001"], w)


def test_custom_pytree(tmp_path):
    class P(NamedTuple):
        w: torch.Tensor
        b: torch.Tensor

    params = P(w=torch.full((8, 4), 0.5), b=torch.ones((4,)))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 8)).astype(np.float32))
    d = str(tmp_path / "export_nt")
    SavedModelBuilder(lambda p, x: x @ p.w + p.b).save(d, params, x)
    serve = load_saved_model(d)
    torch.testing.assert_close(serve(x), x @ params.w + params.b, rtol=1e-6, atol=1e-6)
    assert len(serve.params) == 2


def test_transformer_forward_exports_the_flash_operator(tmp_path):
    jspec = jax_get_model("bert_base", dtype=jnp.float32, attention_impl="dot", **BERT)
    jparams = fill_params(jspec)
    spec = get_model_spec("bert_base", dtype="float32", attention_impl="flash", **BERT)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    cfg = spec.config
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, BERT["vocab_size"], (2, 128)).astype(np.int64))

    def forward(p, t):
        return tt.forward(p, t, cfg)

    SavedModelBuilder(forward).save(str(tmp_path), params, tokens)
    serve = load_saved_model(str(tmp_path))
    assert _ops(serve).count("autodist_tpu_torch.flash_fwd.default") == cfg.num_layers
    with torch.no_grad():
        eager = forward(params, tokens)
    got = serve(tokens)
    assert torch.equal(got, eager)
    from autodist_tpu.models import transformer as jtt

    want = np.asarray(jtt.forward(jparams, jnp.asarray(tokens.numpy()), jspec.config))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_conv_stats_and_paged_operators_export(tmp_path):
    gen = torch.Generator().manual_seed(0)
    conv_p = L.conv_init(gen, 1, 1, 16, 32, device="cpu")
    bn_p = L.batchnorm_init(32, device="cpu")
    x = torch.randn((2, 4, 4, 16), generator=gen)
    d = str(tmp_path / "conv")
    SavedModelBuilder(lambda p, x: L.conv_batchnorm(p[0], p[1], x)).save(d, (conv_p, bn_p), x)
    serve = load_saved_model(d)
    assert "autodist_tpu_torch.fused_matmul_stats.default" in _ops(serve)
    with torch.no_grad():
        assert torch.equal(serve(x), L.conv_batchnorm(conv_p, bn_p, x))

    b, q, h, dim, page_len, pages = 2, 3, 2, 16, 4, 4
    k_pages = torch.randn((1 + b * pages, page_len, h, dim), generator=gen)
    v_pages = torch.randn((1 + b * pages, page_len, h, dim), generator=gen)
    tables = torch.arange(1, 1 + b * pages, dtype=torch.int32).reshape(b, pages)
    qpos = torch.tensor([[5, 6, 7], [12, 13, 14]], dtype=torch.int32)
    q4 = torch.randn((b, q, h, dim), generator=gen)
    d = str(tmp_path / "paged")
    SavedModelBuilder(lambda p, q4: pa.paged_attention(q4, p["k"], p["v"], tables, qpos)
                      ).save(d, {"k": k_pages, "v": v_pages}, q4)
    serve = load_saved_model(d)
    assert "autodist_tpu_torch.paged_attention.default" in _ops(serve)
    assert torch.equal(serve(q4), pa.paged_attention(q4, k_pages, v_pages, tables, qpos))
