"""Port parity: the zoo's CNNs with BatchNorm, ``densenet`` here and
``inception`` on the same cases in ``tests/test_torch_zoo_inception.py``
(``vgg`` is in ``tests/test_torch_zoo_vgg.py``).

DenseNet (``blocks=(2, 2)``, growth 8) and Inception-V3 (``width=1/16``) at
32 px, batch 8, 10 classes (32 px leaves Inception's mixed_a a 4x4 map and
every later block at least 1x1), on the JAX tree filled from numpy:

- spec, VarItems and ``Strategy.to_json()`` under AllReduce, PS and
  PSLoadBalancing: equal;
- fp32 loss, the head's gradient and the whole gradient. At initialisation
  BatchNorm + ReLU make these models sensitive to fp32 rounding: moving the
  batch by one row (the same sums in another order) flips a ReLU near 0 in
  JAX's own DenseNet and moves its whole gradient by 0.5% (relative L2),
  and Inception's logits move by 1e-4 from JAX's own reordering. So each
  is held, relative L2, to twice JAX's own spread under three such
  reorderings (reversed, rolled by 1 and by 3), measured in the test, or to
  1e-5 (loss) and 1e-4 (gradients) where that is larger, as
  ``tests/test_torch_resnet.py`` does for ResNet-50;
- bf16: the port's logits within twice the JAX model's own bf16-vs-fp32
  drift, and the port's fp32 logits within twice JAX's own change under
  the reversal;
- 3 steps of ``AutoDist(AllReduce, device="cpu")``, each against JAX's
  step (``jax.value_and_grad`` and the optax update on unsharded arrays;
  BatchNorm normalises over the whole batch on both sides) from the same
  parameters and the same optimizer history (JAX's optimizer state is
  carried along the port's gradients): the loss within 1e-5 and the
  params' whole update within 1e-4, or twice JAX's own spread over the
  reordered batches at that point, itself under 0.1. A whole trajectory
  cannot be compared: the gradients of these narrow BatchNorm nets at
  init are so large that JAX's own 3-step runs part under a reordering of
  the batch. No update, and (momentum) the update of a freshly started
  optimizer, must fall outside the bound;
- the fused 1x1-conv op: once per dense layer and 40 times an Inception
  forward (a spy), and at full width (DenseNet-121 at 224 px, Inception-V3
  at 299 px, on meta tensors) only at shapes the CUDA kernel takes.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autodist_tpu import api as japi
from autodist_tpu import model_item as jmi
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.models import layers as JL
from autodist_tpu_torch import api as tapi
from autodist_tpu_torch import model_item as tmi
from autodist_tpu_torch import strategy as tstrat
from autodist_tpu_torch.models import densenet as TD
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.models import inception as TI
from autodist_tpu_torch.models import layers as L
from autodist_tpu_torch.models.convert import (flatten_params, map_params,
                                               params_from_jax, params_to_numpy,
                                               unflatten_params)
from autodist_tpu_torch.ops import fused_conv_stats as fcs
from test_torch_zoo import (batches, check_spec, check_strategy_json, check_var_items,
                            fill_params, loss_and_grads, rel_l2)

JD = importlib.import_module("autodist_tpu.models.densenet")
JI = importlib.import_module("autodist_tpu.models.inception")

LOSS_RTOL, GRAD_RTOL, SPREAD_FACTOR, MAX_SPREAD = 1e-5, 1e-4, 2.0, 0.1
IMAGE, CLASSES = 32, 10          # batch 8: test_torch_zoo.batches
BLOCKS, GROWTH, WIDTH = (2, 2), 8, 1 / 16
BN_MODELS = {
    "densenet": (dict(blocks=BLOCKS, growth=GROWTH, image_size=IMAGE, num_classes=CLASSES),
                 ("sgd", {"learning_rate": 0.05})),
    "inception": (dict(width=WIDTH, image_size=IMAGE, num_classes=CLASSES),
                  ("momentum", {"learning_rate": {
                      "schedule": "warmup_cosine", "init_value": 1e-4, "peak_value": 5e-4,
                      "warmup_steps": 1, "decay_steps": 4}})),
}


@pytest.fixture(autouse=True)
def _fresh_autodist():
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()
    yield
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()


# --------------------------------------------------------- densenet, inception
def _specs(model):
    overrides = BN_MODELS[model][0]
    return jax_get_model(model, **overrides), get_model_spec(model, **overrides)


def _forwards(model, jdt, tdt):
    """(JAX, port) ``(params, images) -> logits`` in the given dtypes."""
    if model == "densenet":
        return (lambda p, x: JD.forward(p, x, 121, dtype=jdt, blocks=BLOCKS),
                lambda p, x: TD.forward(p, x, 121, dtype=tdt, blocks=BLOCKS))
    return (lambda p, x: JI.forward(p, x, dtype=jdt), lambda p, x: TI.forward(p, x, dtype=tdt))


def _losses32(model):
    jf, tf = _forwards(model, jnp.float32, torch.float32)
    return (lambda p, b: JL.softmax_xent(jf(p, b["images"]), b["labels"]),
            lambda p, b: L.softmax_xent(tf(p, b["images"]), b["labels"]))


@functools.lru_cache(maxsize=None)
def _value_and_grad(model):
    return jax.jit(jax.value_and_grad(_losses32(model)[0]))


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_params(jax.tree.map(np.asarray, tree)).items()}


def _whole_rel(got, want):
    num = sum(((np.asarray(got[k]) - np.asarray(want[k])) ** 2).sum() for k in want)
    return float(np.sqrt(num / sum((np.asarray(v) ** 2).sum() for v in want.values())))


def _reorders(jbatch):
    """The batch reversed and rolled by 1 and 3 rows: the same sums in other
    orders."""
    for order in (lambda v: v[::-1], lambda v: np.roll(v, 1, 0), lambda v: np.roll(v, 3, 0)):
        yield {k: order(v).copy() for k, v in jbatch.items()}


def _within_spread(got, want, variants, floor, what):
    """``got`` within ``max(floor, SPREAD_FACTOR x JAX's own spread)`` of
    ``want`` (relative L2 over the flat dicts), the spread being JAX's
    largest change over ``variants`` (its runs on reordered batches), itself
    under MAX_SPREAD. Returns the bound."""
    spread = max(_whole_rel(v, want) for v in variants)
    err, bound = _whole_rel(got, want), max(floor, SPREAD_FACTOR * spread)
    assert spread < MAX_SPREAD, f"{what}: JAX's own spread {spread}"
    assert err <= bound, f"{what}: {err} vs spread {spread}"
    return bound


def _head(flat):
    return {k: v for k, v in flat.items() if k.startswith("head/")}


def spec_json_case(model, tmp_path):
    jspec, tspec = _specs(model)
    jparams = fill_params(jspec)
    check_spec(jspec, tspec, jparams)
    jbatch, tbatch = batches(jspec, tspec)
    jitem, titem = check_var_items(jspec, tspec, jparams, params_from_jax(jparams, "cpu"),
                                   jbatch, tbatch)
    assert not titem.sparse_variables
    for builder in ("AllReduce", "PS", "PSLoadBalancing"):
        check_strategy_json(builder, jitem, titem, tmp_path)


def fp32_spread_case(model):
    jspec, tspec = _specs(model)
    jparams = fill_params(jspec)
    jbatch, tbatch = batches(jspec, tspec)
    tloss_fn = _losses32(model)[1]
    vg = _value_and_grad(model)
    runs = [(float(loss), _flat(grads)) for loss, grads in
            (vg(jparams, b) for b in (jbatch, *_reorders(jbatch)))]
    (jloss, want), others = runs[0], runs[1:]
    loss, got = loss_and_grads(tloss_fn, params_from_jax(jparams, "cpu"), tbatch)
    assert list(got) == list(want)
    _within_spread({"loss": loss}, {"loss": jloss}, [{"loss": v} for v, _ in others],
                   LOSS_RTOL, "loss")
    _within_spread(_head(got), _head(want), [_head(g) for _, g in others], GRAD_RTOL, "head")
    _within_spread(got, want, [g for _, g in others], GRAD_RTOL, "whole gradient")


def bf16_spread_case(model):
    jspec, tspec = _specs(model)
    jparams = fill_params(jspec)
    tparams = params_from_jax(jparams, device="cpu")
    jbatch, tbatch = batches(jspec, tspec)
    logits = {}
    for name, jdt, tdt in (("16", jnp.bfloat16, torch.bfloat16),
                           ("32", jnp.float32, torch.float32)):
        jf, tf = _forwards(model, jdt, tdt)
        logits["j" + name] = np.asarray(jax.jit(jf)(jparams, jbatch["images"]), np.float32)
        with torch.no_grad():
            logits["t" + name] = tf(tparams, tbatch["images"]).float().numpy()
    jax_drift = rel_l2(logits["j16"], logits["j32"])
    assert 0 < jax_drift
    assert rel_l2(logits["t16"], logits["t32"]) <= 2 * jax_drift
    jf32 = jax.jit(_forwards(model, jnp.float32, torch.float32)[0])
    _within_spread({"logits": logits["t32"]}, {"logits": logits["j32"]},
                   [{"logits": np.asarray(jf32(jparams, jbatch["images"][::-1].copy()))[::-1]}],
                   LOSS_RTOL, "fp32 logits")


def autodist_steps_case(model):
    """3 steps of ``step.run`` one at a time, each held to JAX's step from the
    same parameters and the same optimizer history: JAX's state is carried
    along the port's own gradients, so the two updates differ only by the
    step's own gradient."""
    jspec, tspec = _specs(model)
    jparams = fill_params(jspec)
    tparams = params_from_jax(jparams, device="cpu")
    jbatch, tbatch = batches(jspec, tspec)
    name, kwargs = BN_MODELS[model][1]
    tx = jmi.OptimizerSpec(name, kwargs).make()
    vg, update = _value_and_grad(model), jax.jit(tx.update)
    step = tapi.AutoDist(strategy_builder=tstrat.AllReduce(), device="cpu").build(
        _losses32(model)[1], tparams, tbatch, optimizer=tmi.OptimizerSpec(name, kwargs))
    state, jstate = step.init(tparams), tx.init(jparams)
    for t in range(3):
        before = params_to_numpy(step.logical_params(state))
        p = jax.tree.map(np.copy, before)
        _, _, tgrads = step.loss_and_grads(state, tbatch)
        tgrads = unflatten_params({k: g.numpy() for k, g in zip(_flat(p), tgrads)})
        state, metrics = step.run(state, tbatch, 1)
        after = flatten_params(params_to_numpy(step.logical_params(state)))
        got = {k: v - want for (k, v), want in zip(after.items(), _flat(p).values())}
        jloss, jgrads = vg(p, jbatch)
        want = _flat(update(jgrads, jstate, p)[0])
        assert list(got) == list(want)
        others = [(float(loss), _flat(update(grads, jstate, p)[0]))
                  for loss, grads in (vg(p, b) for b in _reorders(jbatch))]
        _within_spread({"loss": metrics["loss"].numpy()}, {"loss": np.array([float(jloss)])},
                       [{"loss": np.array([loss])} for loss, _ in others], LOSS_RTOL,
                       f"step {t} loss")
        bound = _within_spread(got, want, [u for _, u in others], GRAD_RTOL, f"step {t} update")
        # Controls the bound must reject: no update at all, and (momentum
        # after the first step) the update of a freshly started optimizer.
        assert _whole_rel({k: 0 * v for k, v in want.items()}, want) > bound
        if t and name == "momentum":
            fresh = _flat(update(jgrads, tx.init(p), p)[0])
            assert _whole_rel(fresh, want) > bound, f"step {t}: fresh state within {bound}"
        jstate = update(tgrads, jstate, p)[1]


# ------------------------------------------------------------ densenet tests
def test_densenet_spec_var_items_and_strategy_json_match_jax(tmp_path):
    spec_json_case("densenet", tmp_path)


def test_densenet_fp32_loss_and_grads_match_jax():
    fp32_spread_case("densenet")


def test_densenet_bf16_drift_from_fp32_is_the_jax_models():
    bf16_spread_case("densenet")


def test_densenet_three_autodist_steps_match_one_device_jax():
    autodist_steps_case("densenet")


# ------------------------------------------------------------ fused conv ops
def _spy(monkeypatch):
    calls = []
    plain = fcs.fused_matmul_stats

    def spy(x, w):
        calls.append((x.shape[0], x.shape[1], w.shape[1]))
        if x.device.type == "meta":
            fcs.check_kernel_args(x, w)
        return plain(x, w)

    monkeypatch.setattr(fcs, "fused_matmul_stats", spy)
    return calls


def test_fused_conv_launches_per_forward(monkeypatch):
    calls = _spy(monkeypatch)
    jspec, _ = _specs("densenet")
    TD.forward(params_from_jax(fill_params(jspec), "cpu"),
               torch.zeros((2, IMAGE, IMAGE, 3)), 121, blocks=BLOCKS)
    assert len(calls) == sum(BLOCKS)                # one a dense layer
    calls.clear()
    jspec, _ = _specs("inception")
    tparams = params_from_jax(fill_params(jspec), "cpu")
    TI.forward(tparams, torch.zeros((2, IMAGE, IMAGE, 3)))
    assert len(calls) == 40


@pytest.mark.parametrize("model", ["densenet", "inception"])
def test_full_width_fused_convs_are_shapes_the_kernel_takes(model, monkeypatch):
    calls = _spy(monkeypatch)
    spec = get_model_spec(model)
    params = map_params(lambda t: t.to("meta"), spec.init(0, device="cpu"))
    size = 224 if model == "densenet" else 299
    images = torch.empty((2, size, size, 3), device="meta")
    if model == "densenet":
        TD.forward(params, images, 121)
    else:
        TI.forward(params, images)
    assert len(calls) == (58 if model == "densenet" else 40)
    # K and N multiples of 8 (check_kernel_args in the spy); densenet's K
    # run 64 + 32 i, many not multiples of 64.
    if model == "densenet":
        assert {n for _, _, n in calls} == {128}
        assert any(k % 64 for _, k, _ in calls)
