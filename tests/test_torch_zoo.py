"""Port parity: the zoo models without BatchNorm (``mlp``,
``linear_regression``, ``ncf``, ``lstm_lm``, ``moe_transformer``; ``vgg``'s
cases, on the helpers here, are in ``tests/test_torch_zoo_cnn.py``).

The JAX package and the port run side by side on the CPU at small sizes, on
the same parameters (the JAX tree's ``eval_shape`` filled from a seeded
numpy generator and carried over with ``params_from_jax``) and the same
example batches:

- the spec: name, ``flops_per_example``, ``sparse_names``, ``expert_names``,
  the port's own ``init`` shapes and the example batch (the MLP's
  ``linspace`` within one fp32 step, the rest equal);
- the ``VarItem`` list with the loss traced (names, order, shapes, dtypes,
  sparse and expert flags) and ``Strategy.to_json()`` under AllReduce, PS
  and PSLoadBalancing;
- fp32 loss within 1e-5 and gradients within 1e-5 absolute + 1e-4 relative
  (``lstm_lm`` and ``vgg`` through their ``forward(dtype=float32)``, the MoE
  with ``dtype="float32"``);
- bf16 (the specs' default): the port's logits within twice the JAX model's
  own bf16-vs-fp32 drift (relative L2) of the fp32 logits;
- 3 steps of ``AutoDist(AllReduce).build(...).run`` against the JAX
  package's, each model with an optimizer of its recipe: losses within 1e-5
  and final params within 1e-5 absolute + 1e-4 relative. The JAX side runs on
  ``tests/conftest.py``'s 8-device CPU mesh, so the batch (8) divides it.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu import api as japi
from autodist_tpu import model_item as jmi
from autodist_tpu import strategy as jstrat
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.models import layers as JL
from autodist_tpu.resource_spec import ResourceSpec as JaxResourceSpec
from autodist_tpu_torch import api as tapi
from autodist_tpu_torch import model_item as tmi
from autodist_tpu_torch import strategy as tstrat
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models import lstm_lm as TLSTM
from autodist_tpu_torch.models import vgg as TVGG
from autodist_tpu_torch.models.convert import (flatten_params, params_from_jax,
                                               params_to_numpy, unflatten_params)
from autodist_tpu_torch.resource_spec import ResourceSpec

JLSTM = importlib.import_module("autodist_tpu.models.lstm_lm")
JVGG = importlib.import_module("autodist_tpu.models.vgg")

LOSS_TOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
BATCH = 8
SPEC_YML = """
nodes:
  - address: 10.0.0.1
    chips: 2
    chief: true
  - address: 10.0.0.2
    chips: 2
"""
LSTM = dict(vocab_size=50, embed_dim=16, hidden=32, num_layers=2, seq_len=8)
MOE = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=2, d_ff=64, max_seq_len=16,
           num_experts=4)
VGG = dict(depth=11, image_size=32, num_classes=10)
# model -> (overrides, the optimizer of its 3-step run). The sign-like first
# steps of adafactor, rmsprop, lamb and lion (u ~ g / |g| elementwise) turn
# rounding-level gradient differences into lr-sized ones, so those are held
# to optax in tests/test_torch_optim.py on shared gradients instead.
MODELS = {
    "mlp": ({}, ("momentum", {"learning_rate": 0.1, "nesterov": True})),
    "linear_regression": ({}, ("sgd", {"learning_rate": 0.05})),
    "ncf": (dict(num_users=50, num_items=40, mf_dim=8, mlp_dims=(16, 16, 8)),
            ("adagrad", {"learning_rate": 0.05})),
    "lstm_lm": (LSTM, ("sgd", {"learning_rate": {
        "schedule": "warmup_cosine", "peak_value": 0.5, "warmup_steps": 1,
        "decay_steps": 4}})),
    "moe_transformer": (MOE, ("sgd", {"learning_rate": {
        "schedule": "exponential", "init_value": 0.1, "transition_steps": 1,
        "decay_rate": 0.5}})),
    "vgg": (VGG, ("momentum", {"learning_rate": {
        "schedule": "piecewise", "init_value": 0.01,
        "boundaries_and_scales": {"1": 0.5}}})),
}
# The models of this file (vgg runs in tests/test_torch_zoo_cnn.py).
LOCAL = sorted(m for m in MODELS if m != "vgg")


@pytest.fixture(autouse=True)
def _fresh_autodist():
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()
    yield
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()


def fill_params(jspec, seed=0):
    """The JAX tree of ``jspec.init`` (``eval_shape``: nothing compiled),
    filled from numpy: unit scales, zero biases, He-scaled normals."""
    shapes = jax.eval_shape(jspec.init, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return np.ones(leaf.shape, np.float32)
        if "bias" in name:
            return np.zeros(leaf.shape, np.float32)
        std = np.sqrt(2.0 / np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 0.1
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def specs(model, fp32=False):
    overrides = dict(MODELS[model][0])
    jover, tover = dict(overrides), dict(overrides)
    if fp32 and model == "moe_transformer":
        jover["dtype"], tover["dtype"] = jnp.float32, "float32"
    return jax_get_model(model, **jover), get_model_spec(model, **tover)


def losses32(model, jspec, tspec):
    """(JAX, port) fp32 loss functions of ``model``."""
    if model == "lstm_lm":
        n, h = LSTM["num_layers"], LSTM["hidden"]
        return (lambda p, b: JL.softmax_xent(JLSTM.forward(p, b["tokens"][:, :-1], n, h,
                                                           dtype=jnp.float32),
                                             b["tokens"][:, 1:]),
                lambda p, b: L.softmax_xent(TLSTM.forward(p, b["tokens"][:, :-1], n, h,
                                                          dtype=torch.float32),
                                            b["tokens"][:, 1:]))
    if model == "vgg":
        return (lambda p, b: JL.softmax_xent(JVGG.forward(p, b["images"], 11,
                                                          dtype=jnp.float32), b["labels"]),
                lambda p, b: L.softmax_xent(TVGG.forward(p, b["images"], 11,
                                                         dtype=torch.float32), b["labels"]))
    return jspec.loss_fn, tspec.loss_fn


def batches(jspec, tspec):
    """The JAX batch as numpy and the port's own, checked equal (the MLP's
    linspace within one fp32 step), then the JAX numbers on both sides."""
    jbatch = {k: np.asarray(v) for k, v in jspec.example_batch(BATCH).items()}
    tbatch = tspec.example_batch(BATCH, device="cpu")
    assert set(jbatch) == set(tbatch)
    for k, v in jbatch.items():
        assert tbatch[k].numpy().dtype == v.dtype, k
        np.testing.assert_allclose(tbatch[k].numpy(), v, rtol=1.2e-7, atol=6e-8, err_msg=k)
    return jbatch, {k: torch.from_numpy(v.copy()) for k, v in jbatch.items()}


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten_params(tree).items()}


def _rows(item):
    return [(v.name, tuple(v.shape), v.dtype, v.trainable, v.sparse_update, v.expert)
            for v in item.variables]


def check_spec(jspec, tspec, jparams):
    assert tspec.name == jspec.name
    assert tspec.flops_per_example == jspec.flops_per_example
    assert tuple(tspec.sparse_names) == tuple(jspec.sparse_names)
    assert tuple(tspec.expert_names) == tuple(jspec.expert_names)
    own = tspec.init(3, device="cpu")
    assert {k: tuple(v.shape) for k, v in flatten_params(own).items()} == \
        {k: v.shape for k, v in _flat_np(jparams).items()}
    assert all(v.dtype == torch.float32 for v in flatten_params(own).values())
    if not torch.cuda.is_available():          # entry points default to "cuda"
        for entry in (lambda: tspec.init(3), lambda: tspec.example_batch(BATCH)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                entry()


def check_var_items(jspec, tspec, jparams, tparams, jbatch, tbatch):
    kw = dict(sparse_names=jspec.sparse_names, expert_names=jspec.expert_names)
    jitem = jmi.ModelItem.from_params(jparams, loss_fn=jspec.loss_fn, example_batch=jbatch,
                                      **kw)
    titem = tmi.ModelItem.from_params(tparams, loss_fn=tspec.loss_fn, example_batch=tbatch,
                                      **kw)
    assert _rows(titem) == _rows(jitem)
    assert titem.batch_size == jitem.batch_size
    return jitem, titem


def strategy_json(strategy, tpu_to_gpu=False):
    import json

    d = strategy.to_json()
    d["id"] = d["path"] = ""
    return json.loads(json.dumps(d).replace(":TPU:", ":GPU:")) if tpu_to_gpu else d


def check_strategy_json(builder, jitem, titem, tmp_path):
    spec_file = tmp_path / "spec.yml"
    spec_file.write_text(SPEC_YML)
    kwargs = {"chunk_size": 5} if builder == "AllReduce" else {}
    jstrategy = getattr(jstrat, builder)(**kwargs).build(jitem, JaxResourceSpec(str(spec_file)))
    tstrategy = tstrat.from_name(builder, **kwargs).build(titem, ResourceSpec(str(spec_file)))
    assert strategy_json(tstrategy) == strategy_json(jstrategy, tpu_to_gpu=True)


def loss_and_grads(tloss_fn, tparams, tbatch):
    flat = {k: v.clone().requires_grad_(True) for k, v in flatten_params(tparams).items()}
    loss = tloss_fn(unflatten_params(flat), tbatch)
    grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
    return loss.item(), {k: (torch.zeros_like(v) if g is None else g).numpy()
                         for (k, v), g in zip(flat.items(), grads)}


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ------------------------------------------------------------ cases by model
def spec_and_batch_case(model):
    jspec, tspec = specs(model)
    jparams = fill_params(jspec)
    check_spec(jspec, tspec, jparams)
    batches(jspec, tspec)


def var_items_case(model):
    jspec, tspec = specs(model)
    jparams = fill_params(jspec)
    tparams = params_from_jax(jparams, device="cpu")
    jbatch, tbatch = batches(jspec, tspec)
    _, titem = check_var_items(jspec, tspec, jparams, tparams, jbatch, tbatch)
    sparse = {v.name for v in titem.sparse_variables}
    expert = {v.name for v in titem.variables if v.expert}
    want_sparse = {"ncf": {"mf_user/embedding", "mf_item/embedding", "mlp_user/embedding",
                           "mlp_item/embedding"},
                   "lstm_lm": {"embed/embedding"},
                   "moe_transformer": {"embed/embedding", "pos_embed/embedding"}}
    assert sparse == want_sparse.get(model, set())
    assert bool(expert) == (model == "moe_transformer")
    assert all("expert_" in n for n in expert)


def strategy_json_case(model, builder, tmp_path):
    jspec, tspec = specs(model)
    jparams = fill_params(jspec)
    jbatch, tbatch = batches(jspec, tspec)
    jitem, titem = check_var_items(jspec, tspec, jparams, params_from_jax(jparams, "cpu"),
                                   jbatch, tbatch)
    check_strategy_json(builder, jitem, titem, tmp_path)


def fp32_grads_case(model):
    jspec, tspec = specs(model, fp32=True)
    jparams = fill_params(jspec)
    jbatch, tbatch = batches(jspec, tspec)
    jloss_fn, tloss_fn = losses32(model, jspec, tspec)
    jloss, jgrads = jax.jit(jax.value_and_grad(jloss_fn))(jparams, jbatch)
    loss, grads = loss_and_grads(tloss_fn, params_from_jax(jparams, "cpu"), tbatch)
    np.testing.assert_allclose(loss, float(jloss), atol=LOSS_TOL, rtol=LOSS_TOL)
    want = _flat_np(jgrads)
    assert list(grads) == list(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g, want[name], atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=name)


def _logits(model, jparams, tparams, jbatch, tbatch, jdt, tdt):
    if model == "lstm_lm":
        n, h = LSTM["num_layers"], LSTM["hidden"]
        j = JLSTM.forward(jparams, jbatch["tokens"], n, h, dtype=jdt)
        with torch.no_grad():
            t = TLSTM.forward(tparams, tbatch["tokens"], n, h, dtype=tdt)
    elif model == "vgg":
        j = JVGG.forward(jparams, jbatch["images"], 11, dtype=jdt)
        with torch.no_grad():
            t = TVGG.forward(tparams, tbatch["images"], 11, dtype=tdt)
    else:
        jspec = jax_get_model(model, **MODELS[model][0], dtype=jdt)
        tspec = get_model_spec(model, **MODELS[model][0], dtype=tdt)
        j = jspec.apply(jparams, jbatch["tokens"])
        with torch.no_grad():
            t = tspec.apply(tparams, tbatch["tokens"])
    return np.asarray(j, np.float32), t.float().numpy()


def bf16_drift_case(model):
    jspec, tspec = specs(model)
    jparams = fill_params(jspec)
    tparams = params_from_jax(jparams, device="cpu")
    jbatch, tbatch = batches(jspec, tspec)
    j16, t16 = _logits(model, jparams, tparams, jbatch, tbatch, jnp.bfloat16, torch.bfloat16)
    j32, t32 = _logits(model, jparams, tparams, jbatch, tbatch, jnp.float32, torch.float32)
    jax_drift = rel_l2(j16, j32)
    assert 0 < jax_drift < 0.1                   # bf16 rounding, not another model
    assert rel_l2(t16, t32) <= 2 * jax_drift
    assert rel_l2(t32, j32) <= 1e-5


def _optimizers(model):
    name, kwargs = MODELS[model][1]
    return jmi.OptimizerSpec(name, kwargs), tmi.OptimizerSpec(name, kwargs)


def autodist_steps_case(model):
    jspec, tspec = specs(model, fp32=True)
    jloss_fn, tloss_fn = losses32(model, jspec, tspec)
    jparams = fill_params(jspec)
    tparams = params_from_jax(jparams, device="cpu")
    jbatch, tbatch = batches(jspec, tspec)
    jopt, topt = _optimizers(model)
    kw = dict(sparse_names=jspec.sparse_names, expert_names=jspec.expert_names)

    jstep = japi.AutoDist(strategy_builder=jstrat.AllReduce()).build(
        jloss_fn, jparams, jbatch, optimizer=jopt, **kw)
    jstate, jm = jstep.run(jstep.init(jparams), jbatch, 3)
    tstep = tapi.AutoDist(strategy_builder=tstrat.AllReduce(), device="cpu").build(
        tloss_fn, tparams, tbatch, optimizer=topt, **kw)
    tstate, tm = tstep.run(tstep.init(tparams), tbatch, 3)

    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    got = _flat_np(params_to_numpy(tstep.logical_params(tstate)))
    want = _flat_np(jax.tree.map(np.asarray, jstep.logical_params(jstate)))
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=name)


# ------------------------------------------------------- the tests of this file
@pytest.mark.parametrize("model", LOCAL)
def test_spec_init_and_batch_match_jax(model):
    spec_and_batch_case(model)


@pytest.mark.parametrize("model", LOCAL)
def test_var_items_match_jax(model):
    var_items_case(model)


@pytest.mark.parametrize("builder", ["AllReduce", "PS", "PSLoadBalancing"])
@pytest.mark.parametrize("model", LOCAL)
def test_strategy_json_matches_jax(model, builder, tmp_path):
    strategy_json_case(model, builder, tmp_path)


@pytest.mark.parametrize("model", LOCAL)
def test_fp32_loss_and_grads_match_jax(model):
    fp32_grads_case(model)


@pytest.mark.parametrize("model", ("lstm_lm", "moe_transformer"))
def test_bf16_drift_from_fp32_is_the_jax_models(model):
    bf16_drift_case(model)


@pytest.mark.parametrize("model", LOCAL)
def test_three_autodist_steps_match_jax(model):
    autodist_steps_case(model)
