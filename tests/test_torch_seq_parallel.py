"""Port parity of training over a ``seq`` axis and of plans on ``seq`` and
``pipe`` meshes.

- The small causal ``transformer`` (2 layers, d 32, 4 heads, d_ff 64, seq
  16, fp32) with ``attention_impl="ring"`` and ``"ulysses"``, trained 2
  SGD steps through ``AutoDist.build`` (AllReduce) on 4 gloo ranks at data
  2 x seq 2 and at seq 4 (``helpers/torch_dist.py``'s harness), against
  JAX's step on a 4-device mesh of the same shape (JAX's attention finds
  its mesh through a default ``AutoDist``): losses within rtol 1e-5 and
  parameters within rtol 2e-5 / atol 2e-6, the bars of
  ``tests/test_torch_tp_e2e.py``; every rank's parameters bitwise equal;
  each step's data-axis wire equal to the plan's prediction (the seq
  group's own collectives are not the plan's).
- Plans on ``Mesh.logical`` data x seq and data x pipe meshes, and on the
  three-axis meshes data x model x expert, data x seq x model, data x pipe
  x model and seq x pipe (no processes), var for var against JAX's
  ``GraphTransformer`` on a mesh of the same shape over the first CPU
  devices, as ``tests/test_torch_dist_plan.py`` compares data meshes.
- The combinations that raised before the three-axis port (seq or pipe
  beside a wide model or expert axis, seq with pipe) now build on gloo
  ranks, each rank with the groups of its coordinates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from autodist_tpu import model_item as jmi
from autodist_tpu import strategy as jstrat
from autodist_tpu.api import AutoDist as JAutoDist
from autodist_tpu.kernel import DistributedTrainStep as JStep
from autodist_tpu.kernel import GraphTransformer as JGraphTransformer
from autodist_tpu.kernel import build_mesh as jbuild_mesh
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu_torch import model_item as tmi
from autodist_tpu_torch import strategy as tstrat
from autodist_tpu_torch.kernel import GraphTransformer, Mesh
from autodist_tpu_torch.kernel.mesh import _check_axes
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.models.convert import params_from_jax
from autodist_tpu_torch.resource_spec import ResourceSpec
from helpers import torch_dist as td

PARALLEL_WORKER = td.WORKER.with_name("torch_parallel_worker.py")
SMALL = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4, d_ff=64, max_seq_len=16)
LR, STEPS, BATCH = 0.05, 2, 8
MESHES = {"data2seq2": {"data": 2, "seq": 2}, "seq4": {"data": 1, "seq": 4}}


def _case(impl, mname):
    mesh = MESHES[mname]
    return dict(id=f"{impl}/{mname}", model="transformer", zoo="transformer",
                builder="AllReduce", builder_kwargs={}, opt="sgd",
                opt_kwargs={"learning_rate": LR}, clip_norm=None, steps=STEPS, mesh=mesh,
                mesh_axes=tuple(mesh), overrides=dict(SMALL, attention_impl=impl,
                                                      dtype="float32"))


CASES = [_case(impl, m) for impl in ("ring", "ulysses") for m in MESHES]


def _jax_spec(c):
    return jax_get_model("transformer", **dict(c["overrides"], dtype=jnp.float32))


def _filled(shapes, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32),
                        shapes)


def _inputs():
    jspec = _jax_spec(CASES[0])
    params = _filled(jax.eval_shape(jspec.init, jax.random.PRNGKey(0)))
    return {"transformer": (params, jax.tree.map(np.asarray, jspec.example_batch(BATCH)))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    np_inputs = _inputs()
    torch_inputs = {k: (params_from_jax(p, device="cpu"), td.to_torch(b))
                    for k, (p, b) in np_inputs.items()}
    return td.run_ranks(tmp_path_factory.mktemp("ranks"), torch_inputs, CASES), np_inputs


def jax_train(c, params, batch):
    """(losses, logical params) of JAX's step on a 4-device mesh of the
    case's shape; its ring/Ulysses attention reads the mesh of the default
    AutoDist, made here over the same devices."""
    rs = JResourceSpec(resource_dict={
        "nodes": [{"address": "localhost", "chips": 4, "chief": True}], "mesh": c["mesh"]})
    mesh = jbuild_mesh(rs, axes=c["mesh_axes"], devices=jax.devices()[:4])
    JAutoDist.reset_default()
    try:
        ad = JAutoDist(resource_spec=rs, mesh_axes=c["mesh_axes"])
        ad._mesh = mesh
        loss_fn = _jax_spec(c).loss_fn
        opt = jmi.OptimizerSpec(c["opt"], dict(c["opt_kwargs"]))
        item = jmi.ModelItem.from_params(params, optimizer_spec=opt, loss_fn=loss_fn,
                                         example_batch=batch)
        strategy = jstrat.StrategyCompiler(item).compile(
            jstrat.from_name(c["builder"]).build(item, rs))
        step = JStep(JGraphTransformer(strategy, item, mesh).transform(), loss_fn,
                     opt.make())
        state, losses = step.init(params), []
        for _ in range(c["steps"]):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        return losses, jax.tree.map(np.asarray, step.logical_params(state))
    finally:
        JAutoDist.reset_default()


@pytest.mark.parametrize("c", CASES, ids=lambda c: c["id"])
def test_seq_step_matches_jax(c, runs):
    results, np_inputs = runs
    got = results[0][c["id"]]
    for rank, res in enumerate(results[1:], 1):
        for name, value in got["params"].items():
            np.testing.assert_array_equal(res[c["id"]]["params"][name], value,
                                          err_msg=f"rank {rank} {name}")
    jlosses, jparams = jax_train(c, *np_inputs["transformer"])
    td.assert_params_close(got["params"], td.flat_np(jparams), what="vs JAX 4-device")
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    assert got["losses"][-1] < got["losses"][0]
    for counts in got["collectives"]:
        assert td.wire_counts(counts) == got["predicted"], (counts, got["predicted"])


# ------------------------------------------------------------------ plans
BERT = dict(vocab_size=101, num_layers=2, d_model=64, num_heads=2, d_ff=128, max_seq_len=32,
            attention_impl="dot")
PLAN_BUILDERS = [("AllReduce", {"chunk_size": 2}), ("PartitionedPS", {}), ("Zero1", {}),
                 ("PSLoadBalancing", {})]
PLAN_MESHES = [{"data": 2, "seq": 2}, {"data": 4, "seq": 2}, {"data": 2, "pipe": 2},
               {"data": 2, "pipe": 4}, {"data": 2, "model": 2, "expert": 2},
               {"data": 2, "seq": 2, "model": 2}, {"data": 2, "pipe": 2, "model": 2},
               {"data": 1, "seq": 2, "pipe": 2}]


def _items(model):
    if model == "bert_base":
        jspec, tspec = jax_get_model("bert_base", **BERT), get_model_spec("bert_base", **BERT)
        jparams = _filled(jax.eval_shape(jspec.init, jax.random.PRNGKey(0)))
        jbatch, tbatch = jspec.example_batch(4), tspec.example_batch(4, device="cpu")
        jloss, tloss = jspec.loss_fn, tspec.loss_fn
    else:
        from helpers import torch_dist_worker as worker

        jparams, jbatch = td.inputs()[model]
        tbatch = td.to_torch(jbatch)
        jloss, tloss = td.JAX_LOSSES[model], worker.LOSSES[model]
    jitem = jmi.ModelItem.from_params(jparams, loss_fn=jloss, example_batch=jbatch)
    titem = tmi.ModelItem.from_params(params_from_jax(jparams, device="cpu"), loss_fn=tloss,
                                      example_batch=tbatch)
    return jitem, titem


def _dim(pspec):
    dims = [i for i, e in enumerate(tuple(pspec)) if e is not None]
    return dims[0] if dims else None


@pytest.mark.parametrize("mesh", PLAN_MESHES, ids=lambda m: "x".join(f"{k}{v}"
                                                                    for k, v in m.items()))
@pytest.mark.parametrize("model", ["dense", "embed", "bert_base"])
def test_plan_matches_jax(model, mesh):
    jitem, titem = _items(model)
    n = int(np.prod(list(mesh.values())))
    rd = {"nodes": [{"address": "localhost", "chips": n, "chief": True}], "mesh": mesh}
    jrs = JResourceSpec(resource_dict=rd)
    trs = ResourceSpec(resource_dict=rd)
    for builder, kwargs in PLAN_BUILDERS:
        jstrategy = jstrat.StrategyCompiler(jitem).compile(
            jstrat.from_name(builder, **kwargs).build(jitem, jrs))
        tstrategy = tstrat.StrategyCompiler(titem).compile(
            tstrat.from_name(builder, **kwargs).build(titem, trs))
        jplan = JGraphTransformer(jstrategy, jitem, jbuild_mesh(
            jrs, devices=jax.devices()[:n])).transform()
        tplan = GraphTransformer(tstrategy, titem, Mesh.logical(mesh)).transform()
        assert list(tplan.var_plans) == list(jplan.var_plans)
        for name, jp in jplan.var_plans.items():
            tp = tplan.var_plans[name]
            want = (jp.kind.value, _dim(jp.pspec), _dim(jp.update_pspec), jp.storage_shape,
                    jp.shard_update, jp.degradations, jp.num_shards)
            got = (tp.kind.value, tp.storage_dim, tp.update_dim, tp.storage_shape,
                   tp.shard_update, tp.degradations, tp.num_shards)
            assert got == want, (builder, name)
        assert tplan.bucket_assignment() == jplan.bucket_assignment()
        assert tplan.describe() == jplan.describe()


UNPORTED_BEFORE = [{"data": 2, "seq": 2, "model": 2}, {"data": 1, "pipe": 2, "expert": 2},
                   {"data": 1, "seq": 2, "pipe": 2}, {"seq": 2, "model": 4}]


@pytest.mark.parametrize("shape", UNPORTED_BEFORE,
                         ids=lambda m: "x".join(f"{k}{v}" for k, v in m.items()))
def test_unported_combinations_raise(shape, tmp_path):
    """The name is kept from when these shapes raised: each now builds on
    gloo ranks (``helpers/torch_parallel_worker.py``), and each rank's
    groups are the ranks that share its coordinate on every other axis
    (row-major coordinates); its shard mesh, those that share every
    coordinate but the model and expert ones."""
    _check_axes(shape, "data")
    world = int(np.prod(list(shape.values())))
    axes = tuple(shape) if "data" in shape else ("data",) + tuple(shape)
    case = dict(id="groups", kind="mesh_groups", inputs="none", mesh=shape, mesh_axes=axes)
    got = {r: res["groups"] for r, res in enumerate(
        td.run_ranks(tmp_path, {"none": ()}, [case], world=world, worker=PARALLEL_WORKER))}
    names = tuple(got[0]["coords"])
    sizes = {ax: shape.get(ax, 1) for ax in names}

    def along(mine, axes):
        return [r for r, other in got.items()
                if all(other["coords"][a] == mine[a] for a in names if a not in axes)]

    for rank, res in got.items():
        mine = res["coords"]
        assert mine == Mesh(axis_names=names, shape=sizes, rank=rank).coords
        assert res["data"] == along(mine, ("data",))
        for ax in ("seq", "pipe"):
            if shape.get(ax, 1) > 1:
                assert res[ax] == along(mine, (ax,)), (ax, res)
        wide = tuple(ax for ax in names if ax in ("model", "expert") and sizes[ax] > 1)
        assert tuple(res["shard_axes"]) == wide
        if wide:
            assert sorted(np.ravel(res["shard_mesh"]).tolist()) == along(mine, wide)


@pytest.mark.parametrize("shape", [{"data": 2, "seq": 2}, {"data": 1, "pipe": 4},
                                   {"data": 4, "pipe": 2}])
def test_seq_and_pipe_beside_data_pass(shape):
    _check_axes(shape, "data")
    mesh = Mesh.logical(shape)
    axis = "seq" if shape.get("seq", 1) > 1 else "pipe"
    assert mesh.shard_axes == ()
    assert mesh.axis_group(axis) is None      # a logical mesh plans only
