"""Port parity: checkpoints cross between the JAX package and the port.

The port's ``checkpoint/saver.py`` writes and reads the JAX package's
format (``metadata.json`` format 2, one ``.npy`` a leaf or block, JAX's
pytree names). Held:

- a JAX ``Saver`` checkpoint of the seeded zoo ``mlp`` (32-64-64-10, fp32;
  adafactor factors its 64-wide kernels) after 2 steps of adamw with ``clip_norm`` 1.0, or of
  adafactor, restores into the port's step (``init_or_restore``): the
  same loss on the batch (forward) and the same next step as JAX's third,
  within 1e-5 (loss) and 1e-5 + 1e-4 relative (params): summation order;
- the reverse: the port's checkpoint after 2 steps restores into JAX's
  step, whose third step equals the port's within the same;
- the optimizer's checkpoint names (``checkpoint/names.py``) equal optax's
  tree paths for every optimizer kind and schedule of the port's registry,
  with and without ``clip_norm``;
- a bfloat16 leaf round-trips through both packages bit for bit (JAX's
  ``'<V2'`` files, read through a 16-bit view); ``step`` and every
  ``count`` are int32 scalars on disk;
- the Saver's own contract, as the JAX package's tests hold it: a torn
  write is invisible, ``max_to_keep`` drops old checkpoints, an
  asynchronous write's failure surfaces in ``wait()`` and does not stick,
  values are captured at ``save(block=False)``, a wrong shape or a missing
  entry raises with JAX's messages, ``restore_subtree`` reads one prefix,
  a restore casts to the target's dtype.
"""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax  # noqa: F401 - the JAX package's optimizers
import pytest
import torch

from autodist_tpu import api as japi
from autodist_tpu import model_item as jmi
from autodist_tpu import strategy as jstrat
from autodist_tpu.checkpoint import Saver as JSaver
from autodist_tpu.model_item import _path_to_name
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu_torch import api as tapi
from autodist_tpu_torch import model_item as tmi
from autodist_tpu_torch import strategy as tstrat
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.checkpoint import saver as saver_mod
from autodist_tpu_torch.checkpoint.names import opt_state_names
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.models.convert import flatten_params, params_from_jax, params_to_numpy
from test_torch_zoo import fill_params

BATCH = 16
LOSS_TOL, PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-5, 1e-4
#: Adam and adafactor scale each update by the gradient's own size, so a
#: parameter whose gradient is rounding noise (a transformer's key bias)
#: moves by noise of the learning rate's size in either package: the mlp
#: has none.
OPTIMIZERS = {
    "adamw_clip": ("adamw", {"learning_rate": 1e-3, "weight_decay": 0.01}, 1.0),
    "adafactor": ("adafactor", {"learning_rate": 1e-2, "min_dim_size_to_factor": 32}, None),
}


@pytest.fixture(autouse=True)
def _fresh_autodist():
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()
    yield
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()


def _steps(opt_key):
    """(JAX step, JAX params, JAX batch, port step, port params, port batch)
    of the small transformer under one optimizer."""
    name, kwargs, clip = OPTIMIZERS[opt_key]
    jspec = jax_get_model("mlp")
    tspec = get_model_spec("mlp")
    jparams = fill_params(jspec)
    tparams = params_from_jax(jparams, device="cpu")
    jbatch = jspec.example_batch(BATCH)
    tbatch = tspec.example_batch(BATCH, device="cpu")
    jstep = japi.AutoDist(strategy_builder=jstrat.AllReduce()).build(
        jspec.loss_fn, jparams, jbatch,
        optimizer=jmi.OptimizerSpec(name, dict(kwargs), clip_norm=clip))
    japi.AutoDist.reset_default()
    tstep = tapi.AutoDist(strategy_builder=tstrat.AllReduce(), device="cpu").build(
        tspec.loss_fn, tparams, tbatch,
        optimizer=tmi.OptimizerSpec(name, dict(kwargs), clip_norm=clip))
    return jstep, jparams, jbatch, tstep, tparams, tbatch


def _assert_params(tparams, jparams):
    got = {k: np.asarray(v) for k, v in flatten_params(params_to_numpy(tparams)).items()}
    want = {k: np.asarray(v) for k, v in
            flatten_params(jax.tree.map(np.asarray, jparams)).items()}
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("opt_key", sorted(OPTIMIZERS))
def test_jax_checkpoint_restores_into_port(tmp_path, opt_key):
    jstep, jparams, jbatch, tstep, tparams, tbatch = _steps(opt_key)
    jstate, _ = jstep.run(jstep.init(jparams), jbatch, 2)
    jstep.save(JSaver(str(tmp_path)), jstate)
    jeval = float(jstep.evaluate(jstate, jbatch)["loss"])
    jstate, jm = jstep.run(jstate, jbatch, 1)

    tstate = tstep.init_or_restore(tparams, Saver(str(tmp_path)))
    assert tstate.step == 2 and tstate.opt_state["count"] == 2
    np.testing.assert_allclose(float(tstep.evaluate(tstate, tbatch)["loss"]), jeval,
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    tstate, tm = tstep.run(tstate, tbatch, 1)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    _assert_params(tstep.logical_params(tstate), jstep.logical_params(jstate))


@pytest.mark.parametrize("opt_key", sorted(OPTIMIZERS))
def test_port_checkpoint_restores_into_jax(tmp_path, opt_key):
    jstep, jparams, jbatch, tstep, tparams, tbatch = _steps(opt_key)
    tstate, _ = tstep.run(tstep.init(tparams), tbatch, 2)
    path = tstep.save(Saver(str(tmp_path)), tstate)
    assert os.path.basename(path) == "ckpt-2"
    tstate, tm = tstep.run(tstate, tbatch, 1)

    jstate = jstep.init_or_restore(jparams, JSaver(str(tmp_path)))
    assert int(jstate.step) == 2
    jstate, jm = jstep.run(jstate, jbatch, 1)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    _assert_params(tstep.logical_params(tstate), jstep.logical_params(jstate))


def test_port_metadata_equals_jax_metadata(tmp_path):
    """The same state's checkpoint from both packages: the same entries,
    shapes and dtypes (step and counts int32 scalars)."""
    jstep, jparams, jbatch, tstep, tparams, tbatch = _steps("adamw_clip")
    jpath = jstep.save(JSaver(str(tmp_path / "jax")), jstep.init(jparams))
    tpath = tstep.save(Saver(str(tmp_path / "port")), tstep.init(tparams))
    jmeta, tmeta = JSaver.read_metadata(jpath), Saver.read_metadata(tpath)
    assert tmeta == jmeta
    assert tmeta["entries"]["step"] == {"dtype": "int32", "shape": []}
    assert tmeta["entries"]["opt_state/1/0/count"] == {"dtype": "int32", "shape": []}


# ---------------------------------------------------------------- the names
SCHEDULE = {"schedule": "cosine", "init_value": 0.05, "decay_steps": 5}
NAME_CASES = [
    ("sgd", {"learning_rate": 0.05}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.8, "nesterov": True}),
    ("momentum", {"learning_rate": 0.05}),
    ("adam", {"learning_rate": 0.01}),
    ("adamw", {"learning_rate": 0.01}),
    ("lamb", {"learning_rate": 0.01}),
    ("adagrad", {"learning_rate": 0.05}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "momentum": 0.9}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}),
    ("rmsprop", {"learning_rate": 0.01, "bias_correction": True, "momentum": 0.9}),
    ("lion", {"learning_rate": 0.001}),
    ("adafactor", {"learning_rate": 0.01}),
    ("adafactor", {}),
    ("adafactor", {"learning_rate": 0.01, "momentum": 0.9, "weight_decay_rate": 0.01}),
    ("adafactor", {"learning_rate": 0.01, "clipping_threshold": None,
                   "multiply_by_parameter_scale": False, "momentum": 0.9}),
]
NAME_CASES += [(k, dict(kw, learning_rate=dict(SCHEDULE))) for k, kw in NAME_CASES
               if "learning_rate" in kw]


@pytest.mark.parametrize("clip", (None, 1.0), ids=("noclip", "clip"))
@pytest.mark.parametrize("kind,kwargs", NAME_CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(NAME_CASES)])
def test_optimizer_names_equal_optax_paths(kind, kwargs, clip):
    params = {"dense": {"kernel": jnp.zeros((130, 160)), "bias": jnp.zeros((7,))},
              "embed": jnp.zeros((4, 3))}
    state = jmi.OptimizerSpec(kind, dict(kwargs), clip_norm=clip).make().init(params)
    want = sorted(_path_to_name(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(state)[0])
    opt = tmi.OptimizerSpec(kind, dict(kwargs), clip_norm=clip).make()
    assert opt_state_names(opt, ["dense/bias", "dense/kernel", "embed"]) == want


# ------------------------------------------------------------- bf16, ints
def test_bf16_leaf_round_trips_through_both_packages(tmp_path):
    rng = np.random.default_rng(3)
    values = rng.standard_normal((5, 7)).astype(np.float32)
    t = torch.from_numpy(values).to(torch.bfloat16)
    path = Saver(str(tmp_path / "port")).save({"a": t, "n": 7}, step=1)
    got = JSaver(str(tmp_path / "port")).restore(path)
    assert Saver.read_metadata(path)["entries"]["a"] == {"dtype": "bfloat16", "shape": [5, 7]}
    np.testing.assert_array_equal(got["a"].view(ml_dtypes.bfloat16).astype(np.float32),
                                  t.float().numpy())
    assert got["n"].dtype == np.int32 and int(got["n"]) == 7
    with open(os.path.join(path, "a.npy"), "rb") as f:
        assert b"'descr': '<V2'" in f.read(128)

    jpath = JSaver(str(tmp_path / "jax")).save(
        {"a": jnp.asarray(values, jnp.bfloat16)}, step=1)
    back = Saver(str(tmp_path / "jax")).restore(jpath)
    assert back["a"].dtype == torch.bfloat16
    assert torch.equal(back["a"], t)
    cast = Saver().restore(jpath, target={"a": torch.zeros((5, 7))})
    assert cast["a"].dtype == torch.float32 and torch.equal(cast["a"], t.float())


# ------------------------------------------------------- the Saver's contract
def test_shape_mismatch_and_missing_entry_raise(tmp_path):
    path = Saver(str(tmp_path)).save({"w": torch.zeros((2, 2))})
    with pytest.raises(ValueError, match="model mismatch"):
        Saver(str(tmp_path)).restore(path, target={"w": torch.zeros((3, 2))})
    with pytest.raises(KeyError, match="has no entry 'extra'"):
        Saver(str(tmp_path)).restore(path, target={"w": torch.zeros((2, 2)),
                                                   "extra": torch.zeros(3)})


def test_latest_checkpoint_and_gc(tmp_path):
    saver = Saver(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3):
        saver.save({"w": torch.zeros((2, 2))}, step=s)
    assert saver.latest_checkpoint().endswith("ckpt-3")
    assert sorted(os.listdir(tmp_path)) == ["ckpt-2", "ckpt-3"]


def test_torn_write_invisible_and_orphans_swept(tmp_path):
    saver = Saver(str(tmp_path))
    saver.save({"w": torch.ones(4)}, step=5)
    os.makedirs(tmp_path / "ckpt-6.tmp-12345")
    assert saver.latest_checkpoint().endswith("ckpt-5")
    os.makedirs(tmp_path / "ckpt-5.tmp-99999")
    os.makedirs(tmp_path / "ckpt-5.old-99999")
    saver.save({"w": torch.full((4,), 2.0)}, step=5)
    assert sorted(os.listdir(tmp_path)) == ["ckpt-5", "ckpt-6.tmp-12345"]
    assert float(saver.restore(str(tmp_path / "ckpt-5"))["w"][0]) == 2.0


def test_async_save_failure_surfaces_in_wait(tmp_path, monkeypatch):
    saver = Saver(str(tmp_path))

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(saver_mod.np, "save", boom)
    saver.save({"w": torch.ones(4)}, step=1, block=False)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        saver.wait()
    monkeypatch.undo()
    saver.save({"w": torch.ones(4)}, step=2, block=False)
    assert saver.latest_checkpoint().endswith("ckpt-2")


def test_async_save_captures_values_at_call(tmp_path):
    """block=False copies to the host before it returns: training on does
    not change what is written."""
    spec = get_model_spec("mlp")
    params = spec.init(0, device="cpu")
    batch = spec.example_batch(16, device="cpu")
    step = tapi.AutoDist(strategy_builder=tstrat.AllReduce(), device="cpu").build(
        spec.loss_fn, params, batch)
    state, _ = step(step.init(params), batch)
    snapshot = {k: v.detach().clone() for k, v in flatten_params(state.params).items()}
    saver = Saver(str(tmp_path))
    path = step.save(saver, state, block=False)
    for _ in range(3):
        state, _ = step(state, batch)
    saver.wait()
    restored = flatten_params(saver.restore(path)["params"])
    for name, want in snapshot.items():
        assert torch.equal(restored[name], want), name
        assert not torch.equal(flatten_params(state.params)[name].detach(), want), name


def test_restore_subtree_reads_only_the_prefix(tmp_path):
    saver = Saver(str(tmp_path))
    state = {"step": 7, "params": {"dense": {"kernel": torch.arange(6.0).reshape(2, 3)}},
             "opt_state": {"mu": {"dense": {"kernel": torch.zeros((2, 3))}}}}
    path = saver.save(state, step=7)
    out = saver.restore_subtree(path, "params", {"dense": {"kernel": torch.zeros((2, 3))}})
    assert torch.equal(out["dense"]["kernel"], state["params"]["dense"]["kernel"])
    full = saver.restore_subtree(path, "", target=state)
    assert full["step"] == 7 and isinstance(full["step"], int)
    # The JAX Saver reads the same subtree of the port's file.
    jout = JSaver(str(tmp_path)).restore_subtree(
        path, "params", {"dense": {"kernel": jnp.zeros((2, 3))}})
    np.testing.assert_array_equal(np.asarray(jout["dense"]["kernel"]),
                                  np.arange(6.0).reshape(2, 3))


# --------------------------------------------------------------- DCP bridge
def _mlp_step(optimizer=None):
    spec = get_model_spec("mlp")
    params = spec.init(0, device="cpu")
    batch = spec.example_batch(16, device="cpu")
    step = tapi.AutoDist(strategy_builder=tstrat.AllReduce(), device="cpu").build(
        spec.loss_fn, params, batch, optimizer=optimizer)
    return step, params, batch


def test_dcp_round_trip_is_exact(tmp_path):
    from autodist_tpu_torch.checkpoint import export_dcp, import_dcp

    step, params, batch = _mlp_step(tmi.OptimizerSpec("adamw", {"learning_rate": 1e-3},
                                                      clip_norm=1.0))
    state, _ = step.run(step.init(params), batch, 2)
    export_dcp(step, state, str(tmp_path / "dcp"))
    back = import_dcp(step, params, str(tmp_path / "dcp"))
    assert back.step == 2 and back.opt_state["count"] == 2
    for (name, leaf, _), (_, got, _) in zip(step.checkpoint_leaves(state),
                                            step.checkpoint_leaves(back)):
        if isinstance(leaf, int):
            assert got == leaf, name
        else:
            assert torch.equal(got, leaf), name


def test_dcp_foreign_checkpoint_with_matching_names_loads(tmp_path):
    """A DCP checkpoint written without the bridge (a plain flat dict of the
    same names) imports; one missing a leaf raises before reading."""
    import torch.distributed.checkpoint as dcp

    from autodist_tpu_torch.checkpoint import import_dcp

    step, params, batch = _mlp_step()
    flat = {name: (torch.tensor(leaf, dtype=torch.int32) if isinstance(leaf, int)
                   else torch.full_like(leaf, 0.25))
            for name, leaf, _ in step.checkpoint_leaves(step.init(params))}
    flat["step"] = torch.tensor(9, dtype=torch.int32)
    dcp.save(flat, checkpoint_id=str(tmp_path / "foreign"), no_dist=True)
    state = import_dcp(step, params, str(tmp_path / "foreign"))
    assert state.step == 9 and state.opt_state["count"] == 9    # sgd: count from step
    assert all(bool((t == 0.25).all()) for t in flatten_params(state.params).values())
    flat.pop("params/dense_0/kernel")
    dcp.save(flat, checkpoint_id=str(tmp_path / "partial"), no_dist=True)
    with pytest.raises(KeyError, match="missing 1 leaves"):
        import_dcp(step, params, str(tmp_path / "partial"))
