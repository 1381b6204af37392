"""Port parity of pipeline parallelism (``parallel/pipeline.py``) on 4 gloo
ranks, one process each, against the JAX package's ``pipeline_apply``,
``pipeline_value_and_grad`` and ``AutoDist.build_pipeline`` on meshes of
the first 4 CPU devices, from the same numpy inputs (the port's
counterparts of ``tests/test_moe_pipeline.py``'s ``TestPipeline``,
``Test1F1B``, ``TestPipelineRemat`` and ``TestPipelineTrainStep``):

- GPipe forward at pipe 4 and data 2 x pipe 2 (4 and 8 microbatches), and
  the gradients of ``sum(out ** 2)``: each rank's stage slice and ``x``'s
  whole gradient against JAX's; the other slices zero;
- ``1f1b`` against JAX's ``1f1b`` and the port's own ``gpipe``;
- the interleaved loop (``pipeline_value_and_grad``) at pipe 4 and data 2 x
  pipe 2: loss, stage gradients and ``x``'s cotangent;
- ``remat_stages``: the same values and gradients;
- a mesh without a pipe axis: the stages in sequence; the raises (a stage
  count other than the axis, an unknown schedule);
- the memory shapes of the three schedules, as JAX's test reads them from
  compiled buffer sizes: bytes saved for backward (live, each tensor
  counted once, read with ``saved_tensors_hooks``) grow with ``n_micro``
  under gpipe, are under half of that under 1f1b at 32 microbatches, and
  stay flat (< 1.1x) for the interleaved loop;
- ``build_pipeline`` at data 2 x pipe 2 (SGD 0.1, 4 microbatches): one
  step's loss and gathered parameters, a 3-step ``run`` and ``evaluate``
  against JAX's step.

Tolerances: JAX's own in ``tests/test_moe_pipeline.py`` (forward atol
1e-5; gradients rtol 1e-4, atol 1e-5; the train step rtol 2e-5, atol
2e-6); a schedule against another rtol 1e-5, atol 1e-6. Each data rank
microbatches its own rows where JAX microbatches the global batch: equal
for these row-wise stages and mean losses.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

from autodist_tpu.api import AutoDist as JAutoDist
from autodist_tpu.kernel import build_mesh as jbuild_mesh
from autodist_tpu.parallel import pipeline_apply as jpipeline_apply
from autodist_tpu.parallel import pipeline_value_and_grad as jpipeline_value_and_grad
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from helpers import torch_dist as td

WORKER = td.WORKER.with_name("torch_parallel_worker.py")
FWD_ATOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-4, 1e-5
SCHED_RTOL, SCHED_ATOL = 1e-5, 1e-6
PIPE4, DATA_PIPE = {"data": 1, "pipe": 4}, {"data": 2, "pipe": 2}
JAX_MESHES = {"pipe4": ((1, 4), ("data", "pipe")), "data2pipe2": ((2, 2), ("data", "pipe")),
              "data4": ((4,), ("data",))}
MESHES = {"pipe4": PIPE4, "data2pipe2": DATA_PIPE, "data4": {"data": 4}}


def tanh_stage(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


def two_layer_stage(p, h):
    h = jnp.tanh(h @ p["w1"])
    return jnp.tanh(h @ p["w2"] + p["b"])


STAGES = {"tanh": tanh_stage, "two_layer": two_layer_stage}


def mse_head(o, t):
    return jnp.mean((o - t) ** 2)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def tanh_inputs(stages, d=8, rows=16, seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": _normal(rng, stages, d, d, scale=0.5), "b": _normal(rng, stages, d, scale=0.1)}
    return params, _normal(rng, rows, d), _normal(rng, rows, d)


def two_layer_inputs(stages, d=8, dh=16, rows=16, seed=1):
    rng = np.random.default_rng(seed)
    params = {"w1": _normal(rng, stages, d, dh, scale=0.3),
              "w2": _normal(rng, stages, dh, d, scale=0.3),
              "b": _normal(rng, stages, d, scale=0.1)}
    return params, _normal(rng, rows, d), _normal(rng, rows, d)


def step_inputs():
    rng = np.random.default_rng(3)
    params = {"w": _normal(rng, 2, 8, 8, scale=0.3), "b": np.zeros((2, 8), np.float32)}
    return params, _normal(rng, 16, 8), _normal(rng, 16, 8)


INPUTS = {"tanh4": tanh_inputs(4), "tanh2": tanh_inputs(2), "two4": two_layer_inputs(4),
          "two2": two_layer_inputs(2), "mem4": two_layer_inputs(4, d=16, dh=64),
          "step": step_inputs()}


def _apply(cid, stage, inputs, mname, n_micro, schedule="gpipe", remat=False):
    return dict(id=cid, kind="pipe_apply", stage=stage, inputs=inputs, mesh=MESHES[mname],
                jmesh=mname, n_micro=n_micro, schedule=schedule, remat=remat)


APPLY = [
    _apply("tanh/pipe4/m4", "tanh", "tanh4", "pipe4", 4),
    _apply("tanh/pipe4/m8", "tanh", "tanh4", "pipe4", 8),
    _apply("tanh/data2pipe2/m4", "tanh", "tanh2", "data2pipe2", 4),
    _apply("tanh/data2pipe2/m8", "tanh", "tanh2", "data2pipe2", 8),
    _apply("tanh/data2pipe2/remat", "tanh", "tanh2", "data2pipe2", 4, remat=True),
    _apply("tanh/data4/sequential", "tanh", "tanh4", "data4", 2),
    _apply("two/pipe4/gpipe", "two_layer", "two4", "pipe4", 4),
    _apply("two/pipe4/1f1b", "two_layer", "two4", "pipe4", 4, schedule="1f1b"),
    _apply("two/data2pipe2/1f1b", "two_layer", "two2", "data2pipe2", 4, schedule="1f1b"),
]
VG = [dict(id=f"vg/{m}", kind="pipe_vg", stage="two_layer", inputs=i, mesh=MESHES[m],
           jmesh=m, n_micro=4) for m, i in (("pipe4", "two4"), ("data2pipe2", "two2"),
                                             ("data4", "two4"))]
CASES = APPLY + VG + [
    dict(id="memory", kind="pipe_memory", inputs="mem4", mesh=PIPE4, n_micros=(8, 32)),
    dict(id="error/stages", kind="pipe_error", stage="tanh", inputs="tanh4", mesh=PIPE4,
         stages=2),
    dict(id="error/schedule", kind="pipe_error", stage="tanh", inputs="tanh4", mesh=PIPE4,
         stages=4, schedule="2f2b"),
    dict(id="step", kind="pipe_step", stage="tanh", inputs="step", mesh=DATA_PIPE, lr=0.1,
         run_steps=3),
]


def jax_mesh(name):
    shape, names = JAX_MESHES[name]
    return Mesh(np.array(jax.devices()[:4]).reshape(shape), names)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return td.run_ranks(tmp_path_factory.mktemp("ranks"), INPUTS, CASES, worker=WORKER)


def _jax_apply(c):
    params, x, _ = (jax.tree.map(jnp.asarray, a) for a in INPUTS[c["inputs"]])
    mesh = jax_mesh(c["jmesh"])

    def fwd(p, xx):
        return jpipeline_apply(STAGES[c["stage"]], p, xx, c["n_micro"], mesh=mesh,
                               remat_stages=c["remat"], schedule=c["schedule"])

    out = jax.jit(fwd)(params, x)
    gp, gx = jax.jit(jax.grad(lambda p, xx: jnp.sum(fwd(p, xx) ** 2), argnums=(0, 1)))(
        params, x)
    return np.asarray(out), jax.tree.map(np.asarray, gp), np.asarray(gx)


def _check_grads(got, want_grads, want_gx, rtol=GRAD_RTOL, atol=GRAD_ATOL):
    s = got["stage"]
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g, want_grads[name][s], rtol=rtol, atol=atol,
                                   err_msg=f"stage {s} {name}")
    np.testing.assert_allclose(got["gx"], want_gx, rtol=rtol, atol=atol, err_msg="gx")


@pytest.mark.parametrize("c", APPLY, ids=lambda c: c["id"])
def test_pipeline_apply_matches_jax(c, ranks):
    want_out, want_grads, want_gx = _jax_apply(c)
    for res in ranks:
        got = res[c["id"]]
        np.testing.assert_allclose(got["out"], want_out, rtol=FWD_ATOL, atol=FWD_ATOL)
        _check_grads(got, want_grads, want_gx)
        if c["jmesh"] != "data4":
            assert got["other_grads_zero"]


@pytest.mark.parametrize("pair", [("two/pipe4/1f1b", "two/pipe4/gpipe"),
                                  ("tanh/data2pipe2/remat", "tanh/data2pipe2/m4")])
def test_schedules_change_memory_not_values(pair, ranks):
    for res in ranks:
        a, b = res[pair[0]], res[pair[1]]
        np.testing.assert_allclose(a["out"], b["out"], rtol=SCHED_RTOL, atol=SCHED_ATOL)
        for name in a["grads"]:
            np.testing.assert_allclose(a["grads"][name], b["grads"][name], rtol=SCHED_RTOL,
                                       atol=SCHED_ATOL)
        np.testing.assert_allclose(a["gx"], b["gx"], rtol=SCHED_RTOL, atol=SCHED_ATOL)


@pytest.mark.parametrize("c", VG, ids=lambda c: c["id"])
def test_interleaved_value_and_grad_matches_jax(c, ranks):
    params, x, tgt = (jax.tree.map(jnp.asarray, a) for a in INPUTS[c["inputs"]])
    loss, grads, gx = jax.jit(lambda p, xx, tt: jpipeline_value_and_grad(
        STAGES[c["stage"]], p, xx, mse_head, c["n_micro"], targets=tt,
        mesh=jax_mesh(c["jmesh"])))(params, x, tgt)
    for res in ranks:
        got = res[c["id"]]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        _check_grads(got, jax.tree.map(np.asarray, grads), np.asarray(gx))


def test_raises(ranks):
    for res in ranks:
        assert "must equal mesh axis" in res["error/stages"]["error"]
        assert "schedule" in res["error/schedule"]["error"]


def test_memory_shapes_of_the_three_schedules(ranks):
    def peak(n_micro, schedule):
        return max(res["memory"][n_micro][schedule] for res in ranks)

    assert peak(32, "gpipe") > 2 * peak(8, "gpipe")          # grows with n_micro
    assert peak(32, "1f1b") < peak(32, "gpipe") / 2          # boundary inputs only
    assert peak(32, "interleaved") < 1.1 * peak(8, "interleaved")   # O(S), flat


def _jax_step():
    rs = JResourceSpec(resource_dict={
        "nodes": [{"address": "localhost", "chips": 4, "chief": True}], "mesh": DATA_PIPE})
    JAutoDist.reset_default()
    ad = JAutoDist(resource_spec=rs, mesh_axes=tuple(DATA_PIPE))
    ad._mesh = jbuild_mesh(rs, axes=tuple(DATA_PIPE), devices=jax.devices()[:4])
    return ad.build_pipeline(tanh_stage, mse_head, n_microbatches=4,
                             optimizer=optax.sgd(0.1), donate_state=False)


def test_build_pipeline_matches_jax(ranks):
    params, x, tgt = (jax.tree.map(jnp.asarray, a) for a in INPUTS["step"])
    try:
        step = _jax_step()
        state = step.init(params)
        ev0 = float(step.evaluate(state, (x, tgt))["loss"])
        state1, m = step(state, (x, tgt))
        state3, ms = step.run(state1, (x, tgt), 3)
        ev1 = float(step.evaluate(state3, (x, tgt))["loss"])
    finally:
        JAutoDist.reset_default()
    want = jax.tree.map(np.asarray, state1.params)
    for res in ranks:
        got = res["step"]
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5)
        for name, value in got["params"].items():
            np.testing.assert_allclose(value, want[name], rtol=2e-5, atol=2e-6, err_msg=name)
        np.testing.assert_allclose(got["run_losses"], np.asarray(ms["loss"]), rtol=1e-5)
        np.testing.assert_allclose([got["eval0"], got["eval1"]], [ev0, ev1], rtol=1e-5)
        assert got["run_losses"][-1] < got["run_losses"][0] and got["eval1"] < got["eval0"]
        assert got["steps"] == 4 and got["donated_state_unchanged"]
        assert got["local_shape"] == {"w": (1, 8, 8), "b": (1, 8)}    # this stage's slice
