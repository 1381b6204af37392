"""Port parity: every optimizer and learning-rate schedule of the JAX
package's registry (``autodist_tpu/model_item.py``) against optax 0.2.6.

The same seeded numpy parameters and gradients go through
``jmi.OptimizerSpec(...).make()`` (optax) and the port's tensor code for 7
updates, leaf by leaf, to atol 1e-6 and rtol 1e-5 (fp32; the schedules are
evaluated in fp64 on the port's side and in fp32 by optax). Adafactor runs
on a leaf whose two dims are at least 128 (factored) beside ones below it
(not factored); without a learning rate its leaves grow to about 25, and
atol scales with the largest. A ``piecewise`` spec goes through a JSON
round trip first. The schedules themselves are held to rtol 1e-5 over 12
counts (optax evaluates them in fp32).
"""
import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autodist_tpu import model_item as jmi
from autodist_tpu_torch import model_item as tmi

ATOL, RTOL, UPDATES = 1e-6, 1e-5, 7

SCHEDULES = {
    "cosine": {"schedule": "cosine", "init_value": 0.05, "decay_steps": 5, "alpha": 0.1},
    "exponential": {"schedule": "exponential", "init_value": 0.05,
                    "transition_steps": 2, "decay_rate": 0.5},
    "exponential_staircase": {"schedule": "exponential", "init_value": 0.05,
                              "transition_steps": 2, "decay_rate": 0.5,
                              "staircase": True},
    "warmup_cosine": {"schedule": "warmup_cosine", "init_value": 0.001,
                      "peak_value": 0.05, "warmup_steps": 2, "decay_steps": 6,
                      "end_value": 0.005},
    "piecewise": {"schedule": "piecewise", "init_value": 0.05,
                  "boundaries_and_scales": {2: 0.5, 4: 0.1}},
    "linear": {"schedule": "linear", "init_value": 0.05, "end_value": 0.01,
               "transition_steps": 4},
}

CASES = [
    ("momentum", {"learning_rate": 0.05, "nesterov": True}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.8, "nesterov": True}),
    ("adagrad", {"learning_rate": 0.05}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "momentum": 0.9, "nesterov": True,
                 "eps_in_sqrt": False}),
    ("lamb", {"learning_rate": 0.01}),
    ("lamb", {"learning_rate": 0.01, "weight_decay": 0.1}),
    ("lion", {"learning_rate": 0.001}),
    ("adafactor", {"learning_rate": 0.01}),
    ("adafactor", {}),
    ("adafactor", {"learning_rate": 0.01, "momentum": 0.9, "weight_decay_rate": 0.01,
                   "min_dim_size_to_factor": 4}),
    ("adam", {"learning_rate": 0.01, "eps_root": 1e-8}),
] + [("sgd", {"learning_rate": dict(s)}) for s in SCHEDULES.values()]

# A [128, 160] leaf (factored by adafactor's default), a [130, 64] one (its
# second dim is under 128: not factored), a [4, 3, 5] one and a bias.
SHAPES = ((128, 160), (130, 64), (4, 3, 5), (7,))


def _run(name, kwargs, shapes=SHAPES, clip_norm=None, seed=7):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = jmi.OptimizerSpec(name, kwargs, clip_norm=clip_norm).make()
    opt = tmi.OptimizerSpec(name, kwargs, clip_norm=clip_norm).make()
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = tx.init(jp), opt.init(tp)
    for _ in range(UPDATES):
        grads = [rng.standard_normal(p.shape).astype(np.float32) for p in params]
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        with torch.no_grad():
            for p, u in zip(tp, opt.update([torch.from_numpy(g) for g in grads],
                                           tstate, tp)):
                p.add_(u)
    return tp, jp


@pytest.mark.parametrize("name,kwargs", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_updates_match_optax(name, kwargs):
    tp, jp = _run(name, kwargs)
    for got, want in zip(tp, jp):
        want = np.asarray(want)
        # Adafactor without a learning rate steps by the parameter's RMS, so
        # the leaves grow to |p| ~ 25 in 7 updates: fp32 rounding there is
        # absolute, a few ulps of the leaf's largest value.
        atol = ATOL * max(1.0, np.abs(want).max()) if "learning_rate" not in kwargs else ATOL
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=RTOL)


def test_clip_norm_chains_in_front_of_new_optimizers():
    for name in ("lamb", "adafactor"):
        tp, jp = _run(name, {"learning_rate": 0.01}, clip_norm=0.5)
        for got, want in zip(tp, jp):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_optax_over_counts(name):
    spec = json.loads(json.dumps(SCHEDULES[name]))      # piecewise keys become strings
    want = jmi.make_schedule(spec)
    got = tmi.make_schedule(spec)
    for count in range(12):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=RTOL, atol=1e-9,
                                   err_msg=f"{name} at {count}")


def test_piecewise_json_round_trip_trains_like_optax():
    spec = json.loads(json.dumps({"learning_rate": SCHEDULES["piecewise"]}))
    assert set(spec["learning_rate"]["boundaries_and_scales"]) == {"2", "4"}
    tp, jp = _run("momentum", spec)
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_adafactor_factors_the_leaves_optax_factors():
    opt = tmi.OptimizerSpec("adafactor", {"learning_rate": 0.01}).make()
    state = opt.init([torch.zeros(s) for s in SHAPES])
    assert [sorted(v) for v in state["v"]] == [["col", "row"], ["v"], ["v"], ["v"]]
    assert state["v"][0]["row"].shape == (128,) and state["v"][0]["col"].shape == (160,)
    jstate = jmi.OptimizerSpec("adafactor", {"learning_rate": 0.01}).make().init(
        [jnp.zeros(s) for s in SHAPES])[0]
    assert [tuple(r.shape) for r in jstate.v_row] == [(128,), (1,), (1,), (1,)]


def test_unknown_names_and_arguments_raise():
    with pytest.raises(ValueError, match="unknown optimizer"):
        tmi.OptimizerSpec("sgdx", {"learning_rate": 0.1}).make()
    with pytest.raises(TypeError, match="unexpected"):
        tmi.OptimizerSpec("lion", {"learning_rate": 0.1, "decay": 0.5}).make()
    with pytest.raises(TypeError, match="learning_rate is required"):
        tmi.OptimizerSpec("lamb", {}).make()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmi.OptimizerSpec("rmsprop", {"learning_rate": 0.1, "centered": True}).make()
    with pytest.raises(ValueError, match="unknown schedule"):
        tmi.make_schedule({"schedule": "step"})
    with pytest.raises(ValueError, match="positive decay_steps"):
        tmi.make_schedule({"schedule": "cosine", "init_value": 1.0, "decay_steps": 0})
