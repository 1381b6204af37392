"""Port parity of training on three-axis meshes with a pipe axis: 8 gloo
ranks, one process each, on the CPU (``helpers/torch_parallel_worker.py``
at world 8), against the JAX package on an 8-device mesh of the same shape
(``jax.devices()[:8]``), from the same numpy inputs:

- ``AutoDist.build`` (not the pipeline) of the small causal ``transformer``
  (``tests/test_torch_three_axis.py``'s ``SMALL``, fp32, two SGD steps at
  lr 0.05, global batch 8) under ``TensorParallel`` with flash attention at
  data 2 x pipe 2 x model 2, and under ``AllReduce`` with ``ring`` attention
  at data 2 x seq 2 x pipe 2: the pipe ranks repeat the work, as JAX's do.
  Losses within rtol 1e-5, parameters within rtol 2e-5 / atol 2e-6, every
  rank's parameters bitwise equal, the data-axis wire as the plan predicts;
- ``AutoDist.build_pipeline`` (``tests/test_torch_pipeline.py``'s
  ``tanh_stage`` / ``mse_head``, SGD 0.1, 4 microbatches) at data 2 x pipe
  2 x model 2 and at data 2 x seq 2 x pipe 2 against JAX's
  ``build_pipeline``: stage parameters are replicated over every axis but
  ``pipe`` (JAX's ``_stage_spec``), so each rank's ``local_shape`` is its
  stage's slice, whole over the model and seq ranks. One step's loss and
  gathered stack, a 3-step ``run`` and ``evaluate`` at
  ``tests/test_torch_pipeline.py``'s bars (rtol 1e-5 on losses, rtol 2e-5 /
  atol 2e-6 on parameters);
- a stage that calls ``ring_attention`` on a seq axis of 2: JAX's
  ``build_pipeline`` raises ``ValueError`` (its ``shard_map`` over ``seq``
  cannot open inside the one over ``pipe``), and so does the port, on
  every rank before any point-to-point op.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from autodist_tpu.api import AutoDist as JAutoDist
from autodist_tpu.kernel import build_mesh as jbuild_mesh
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.parallel import ring_attention as jring_attention
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu_torch.models.convert import params_from_jax
from helpers import torch_dist as td
from test_torch_pipeline import mse_head, step_inputs, tanh_stage
from test_torch_three_axis import SMALL, WORLD, _case, jax_runs
from test_torch_tp_e2e import filled

WORKER = td.WORKER.with_name("torch_parallel_worker.py")
DPM = {"data": 2, "pipe": 2, "model": 2}
DSP = {"data": 2, "seq": 2, "pipe": 2}
BUILD = [
    dict(_case("transformer/tp/pipe2model2", "transformer", "TensorParallel", DPM,
               dict(SMALL, attention_impl="flash")), kind="train", inputs="transformer"),
    dict(_case("transformer/ring/seq2pipe2", "transformer", "AllReduce", DSP,
               dict(SMALL, attention_impl="ring")), kind="train", inputs="transformer"),
]
PIPELINES = [dict(id=f"pipeline/{name}", kind="pipe_step", stage="tanh", inputs="step",
                  mesh=mesh, lr=0.1, run_steps=3)
             for name, mesh in (("pipe2model2", DPM), ("seq2pipe2", DSP))]
RING_STAGE = dict(id="pipeline/ring-stage", kind="pipe_step_error", stage="ring",
                  inputs="step", mesh=DSP, lr=0.1)


def ring_stage(p, h):
    q = jnp.tanh(h @ p["w"] + p["b"]).reshape(h.shape[0], 4, 1, 2)
    return jring_attention(q, q, q).reshape(h.shape)


def _transformer_inputs():
    spec = jax_get_model("transformer", **dict(BUILD[0]["overrides"], dtype=jnp.float32))
    params = filled(jax.eval_shape(spec.init, jax.random.PRNGKey(0)), 1)
    return params, jax.tree.map(np.asarray, spec.example_batch(8))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params, batch = _transformer_inputs()
    inputs = {"transformer": (params_from_jax(params, device="cpu"), td.to_torch(batch)),
              "step": step_inputs()}
    results = td.run_ranks(tmp_path_factory.mktemp("ranks"), inputs,
                           BUILD + PIPELINES + [RING_STAGE], world=WORLD, worker=WORKER)
    return results, (params, batch)


@pytest.mark.parametrize("c", BUILD, ids=lambda c: c["id"])
def test_build_beside_a_pipe_axis_matches_jax(c, runs):
    results, (params, batch) = runs
    got = results[0][c["id"]]
    for rank, res in enumerate(results[1:], 1):
        for name, value in got["params"].items():
            np.testing.assert_array_equal(res[c["id"]]["params"][name], value,
                                          err_msg=f"rank {rank} {name}")
    [(jlosses, jparams)] = jax_runs(c, params, [batch])
    td.assert_params_close(got["params"], jparams, what="vs JAX 8-device")
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    assert got["losses"][-1] < got["losses"][0]
    for counts in got["collectives"]:
        assert td.wire_counts(counts) == got["predicted"], (counts, got["predicted"])
        if "model" in c["mesh"]:
            assert sum(counts.get("model", {}).values()) > 0, counts


def _jax_pipeline(mesh, stage):
    rs = JResourceSpec(resource_dict={
        "nodes": [{"address": "localhost", "chips": WORLD, "chief": True}], "mesh": mesh})
    ad = JAutoDist(resource_spec=rs, mesh_axes=tuple(mesh))
    ad._mesh = jbuild_mesh(rs, axes=tuple(mesh), devices=jax.devices()[:WORLD])
    return ad.build_pipeline(stage, mse_head, n_microbatches=4, optimizer=optax.sgd(0.1),
                             donate_state=False)


@pytest.mark.parametrize("c", PIPELINES, ids=lambda c: c["id"])
def test_build_pipeline_beside_other_axes_matches_jax(c, runs):
    params, x, tgt = (jax.tree.map(jnp.asarray, a) for a in step_inputs())
    JAutoDist.reset_default()
    try:
        step = _jax_pipeline(c["mesh"], tanh_stage)
        state = step.init(params)
        ev0 = float(step.evaluate(state, (x, tgt))["loss"])
        state1, m = step(state, (x, tgt))
        state3, ms = step.run(state1, (x, tgt), c["run_steps"])
        ev1 = float(step.evaluate(state3, (x, tgt))["loss"])
    finally:
        JAutoDist.reset_default()
    want = jax.tree.map(np.asarray, state1.params)
    for res in runs[0]:
        got = res[c["id"]]
        np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5)
        for name, value in got["params"].items():
            np.testing.assert_allclose(value, want[name], rtol=2e-5, atol=2e-6, err_msg=name)
        np.testing.assert_allclose(got["run_losses"], np.asarray(ms["loss"]), rtol=1e-5)
        np.testing.assert_allclose([got["eval0"], got["eval1"]], [ev0, ev1], rtol=1e-5)
        assert got["run_losses"][-1] < got["run_losses"][0] and got["eval1"] < got["eval0"]
        # This stage's slice, whole over the model and seq ranks.
        assert got["local_shape"] == {"w": (1, 8, 8), "b": (1, 8)}


def test_seq_parallel_attention_inside_a_stage_raises_in_both(runs):
    params, x, tgt = (jax.tree.map(jnp.asarray, a) for a in step_inputs())
    JAutoDist.reset_default()
    try:
        step = _jax_pipeline(DSP, ring_stage)
        with pytest.raises(ValueError):
            step(step.init(params), (x, tgt))
    finally:
        JAutoDist.reset_default()
    for res in runs[0]:
        assert "inside a pipeline stage" in res[RING_STAGE["id"]]["error"]
