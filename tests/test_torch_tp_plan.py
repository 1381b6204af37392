"""Port parity of tensor and expert parallelism's plan (no processes: a plan
needs only the mesh's axis sizes, ``Mesh.logical``).

For the zoo models (``transformer``, ``bert_base``, ``moe_transformer``,
``mlp``, ``lstm_lm``, ``ncf``, ``resnet``, ``vgg``) at small widths, on the
same parameters and example batch:

- the ``VarItem`` list with the loss traced, ``tp_role`` included, equals
  JAX's ``ModelItem._trace_analysis`` var for var, and ``ModelItem.to_json``
  equals JAX's (and round-trips through ``from_json``);
- the ``TensorParallel`` Strategy JSON equals the JAX builder's at meshes
  ``{data 2, model 4}``, ``{data 4, model 2}`` and ``{model 1}``;
- the ``ShardingPlan`` on ``Mesh.logical`` equals JAX's
  ``GraphTransformer`` plan on ``jax.devices()[:8]`` var for var (kind, the
  sharded dim and its mesh axis of ``pspec`` and ``update_pspec``,
  ``storage_shape``, shard counts, degradations) and ``describe()`` line
  for line: TensorParallel at both model meshes, PartitionedPS at
  ``{data 2, model 4}``, and the MoE's expert plan under AllReduce at
  ``{data 2, expert 4}`` (JAX's ``expert_wi`` ``P("expert", None, None)``,
  as ``tests/test_moe_pipeline.py`` holds it).

The port's renderings of those plans (``partitioned`` / ``expert`` over the
model axis) and their data-axis wire are checked here too, and each zoo
model's loss and gradients with its variables placed as TensorParallel
splits them, on a one-rank model mesh, against the plain ones; the step
itself runs in ``tests/test_torch_tp_e2e.py`` and, for the models outside
the transformer family, ``tests/test_torch_tp_models.py``.
"""
import functools
import json

import jax
import numpy as np
import pytest
import torch

from autodist_tpu import model_item as jmi
from autodist_tpu import strategy as jstrat
from autodist_tpu.kernel import GraphTransformer as JGraphTransformer
from autodist_tpu.kernel import build_mesh as jbuild_mesh
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy.tensor_parallel_strategy import _role_axis as jrole_axis
from autodist_tpu_torch import model_item as tmi
from autodist_tpu_torch import strategy as tstrat
from autodist_tpu_torch.kernel import GraphTransformer, Mesh, mesh as tmesh
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.models.convert import (flatten_params, map_params, params_from_jax,
                                               unflatten_params)
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.tensor_parallel_strategy import _role_axis

ZOO = {
    "transformer": dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4, d_ff=64,
                        max_seq_len=16),
    "bert_base": dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4, d_ff=64,
                      max_seq_len=16),
    "moe_transformer": dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4, d_ff=64,
                            max_seq_len=16, num_experts=4),
    "mlp": {},
    "lstm_lm": dict(vocab_size=50, embed_dim=16, hidden=32, num_layers=2, seq_len=8),
    "ncf": dict(num_users=50, num_items=40, mf_dim=8, mlp_dims=(16, 16, 8)),
    "resnet": dict(depth=18, num_classes=10, image_size=32),
    "vgg": dict(depth=11, image_size=32, num_classes=10),
}
TP_MESHES = [{"data": 2, "model": 4}, {"data": 4, "model": 2}]
EXPERT_MESH = {"data": 2, "expert": 4}


@functools.lru_cache(maxsize=None)
def items(model):
    """(JAX ModelItem, port ModelItem) of a zoo model with its loss traced,
    the MoE's expert names given."""
    js, ts = jax_get_model(model, **ZOO[model]), get_model_spec(model, **ZOO[model])
    rng = np.random.default_rng(0)
    jparams = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(s.dtype),
                           jax.eval_shape(js.init, jax.random.PRNGKey(0)))
    jbatch = {k: np.asarray(v) for k, v in js.example_batch(4).items()}
    experts = tuple(getattr(js, "expert_names", ()) or ())
    jitem = jmi.ModelItem.from_params(jparams, loss_fn=js.loss_fn, example_batch=jbatch,
                                      expert_names=experts)
    titem = tmi.ModelItem.from_params(
        params_from_jax(jparams, device="cpu"), loss_fn=ts.loss_fn,
        example_batch={k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()},
        expert_names=tuple(ts.expert_names or ()))
    return jitem, titem


def _var_rows(item):
    return [(v.name, tuple(v.shape), v.dtype, v.sparse_update, v.expert, v.tp_role)
            for v in item.variables]


def _specs(mesh, chips):
    d = {"nodes": [{"address": "localhost", "chips": chips, "chief": True}], "mesh": mesh}
    return JResourceSpec(resource_dict=d), ResourceSpec(resource_dict=d)


def _strategy_json(strategy, tpu_to_gpu=False):
    d = strategy.to_json()
    d["id"] = d["path"] = ""
    text = json.dumps(d)
    return json.loads(text.replace(":TPU:", ":GPU:") if tpu_to_gpu else text)


def _dim_axis(pspec):
    """(dim, mesh axis) of a one-axis ``PartitionSpec``, or (None, None)."""
    dims = [(i, e) for i, e in enumerate(tuple(pspec)) if e is not None]
    assert len(dims) <= 1
    return dims[0] if dims else (None, None)


@pytest.mark.parametrize("model", sorted(ZOO))
def test_roles_and_json_match_jax(model):
    jitem, titem = items(model)
    assert _var_rows(titem) == _var_rows(jitem)
    assert titem.to_json() == jitem.to_json()
    again = tmi.ModelItem.from_json(json.loads(json.dumps(titem.to_json())))
    assert _var_rows(again) == _var_rows(titem)
    # The builder's role axis agrees too, provenance included.
    for jv, tv in zip(jitem.variables, titem.variables):
        assert _role_axis(tv) == jrole_axis(jv), tv.name


def test_roles_alternate_in_the_transformer():
    _, titem = items("transformer")
    roles = {v.name: v.tp_role for v in titem.variables if v.tp_role}
    for w in ("wq", "wk", "wv"):
        assert roles[f"layers_1/attn/{w}/kernel"] == "column"
    assert roles["layers_1/attn/wo/kernel"] == "row"
    assert roles["layers_1/mlp/fc1/kernel"] == "column"
    assert roles["layers_1/mlp/fc2/kernel"] == "row"


@pytest.mark.parametrize("mesh", TP_MESHES + [{"model": 1}], ids=json.dumps)
@pytest.mark.parametrize("model", sorted(ZOO))
def test_tensor_parallel_strategy_json_matches_jax(model, mesh):
    jitem, titem = items(model)
    jrs, trs = _specs(mesh, int(np.prod(list(mesh.values()))))
    jstrategy = jstrat.TensorParallel().build(jitem, jrs)
    tstrategy = tstrat.from_name("TensorParallel").build(titem, trs)
    assert _strategy_json(tstrategy) == _strategy_json(jstrategy, tpu_to_gpu=True)
    compiled = tstrat.StrategyCompiler(titem).compile(tstrategy)
    jcompiled = jstrat.StrategyCompiler(jitem).compile(jstrategy)
    assert _strategy_json(compiled) == _strategy_json(jcompiled, tpu_to_gpu=True)


def test_num_shards_mismatch_raises():
    _, titem = items("transformer")
    _, trs = _specs({"data": 2, "model": 4}, 8)
    with pytest.raises(ValueError, match="does not match the mesh shard axis size 4"):
        tstrat.TensorParallel(num_shards=2).build(titem, trs)
    tstrat.TensorParallel(num_shards=4).build(titem, trs)


def _plans(model, builder, kwargs, mesh, axes):
    jitem, titem = items(model)
    jrs, trs = _specs(mesh, 8)
    jstrategy = jstrat.StrategyCompiler(jitem).compile(
        jstrat.from_name(builder, **kwargs).build(jitem, jrs))
    tstrategy = tstrat.StrategyCompiler(titem).compile(
        tstrat.from_name(builder, **kwargs).build(titem, trs))
    assert _strategy_json(tstrategy) == _strategy_json(jstrategy, tpu_to_gpu=True)
    jplan = JGraphTransformer(jstrategy, jitem, jbuild_mesh(
        jrs, axes=axes, devices=jax.devices()[:8])).transform()
    shape = trs.mesh_shape(axes)
    tplan = GraphTransformer(tstrategy, titem,
                             Mesh(axis_names=tuple(shape), shape=shape)).transform()
    return jplan, tplan


PLAN_CASES = ([(m, "TensorParallel", {}, mesh, ("data", "model"))
               for m in sorted(ZOO) for mesh in TP_MESHES]
              + [(m, "PartitionedPS", {}, TP_MESHES[0], ("data", "model"))
                 for m in ("bert_base", "moe_transformer", "resnet")]
              + [("moe_transformer", "AllReduce", {}, EXPERT_MESH, ("data", "expert")),
                 ("moe_transformer", "AllReduce", {}, EXPERT_MESH, ("data", "model"))])


@pytest.mark.parametrize("model,builder,kwargs,mesh,axes", PLAN_CASES,
                         ids=[f"{c[0]}-{c[1]}-{json.dumps(c[3])}-{'x'.join(c[4])}"
                              for c in PLAN_CASES])
def test_plan_matches_jax(model, builder, kwargs, mesh, axes):
    jplan, tplan = _plans(model, builder, kwargs, mesh, axes)
    assert list(tplan.var_plans) == list(jplan.var_plans)
    for name, jp in jplan.var_plans.items():
        tp = tplan.var_plans[name]
        jdim, jax_axis = _dim_axis(jp.pspec)
        udim, uaxis = _dim_axis(jp.update_pspec)
        want = (jp.kind.value, jdim, jax_axis, udim, jp.storage_shape, jp.shard_update,
                jp.degradations, jp.num_shards, jp.reduction_destination)
        got = (tp.kind.value, tp.storage_dim,
               tp.storage_axis if tp.storage_dim is not None else None, tp.update_dim,
               tp.storage_shape, tp.shard_update, tp.degradations, tp.num_shards,
               tp.reduction_destination)
        assert got == want, name
        # The step's rendering is JAX's promised wire for model/expert vars.
        jwire = jplan.promised_wire()[name].rendering
        if jwire in ("expert", "partitioned"):
            assert tplan.rendering(name) == (jwire, tp.storage_dim), name
    assert tplan.describe() == jplan.describe()


def test_expert_plan_shards_experts_and_wire():
    jplan, tplan = _plans("moe_transformer", "AllReduce", {}, EXPERT_MESH, ("data", "expert"))
    assert str(jplan.var_plans["layers_0/moe/expert_wi"].pspec) == \
        "PartitionSpec('expert', None, None)"
    assert tplan.rendering("layers_0/moe/expert_wi") == ("expert", 0)
    assert tplan.local_shape("layers_0/moe/expert_wi") == (1, 32, 64)
    assert tplan.rendering("layers_0/attn/wq/kernel") == ("replicated", None)
    # The two sparse tables are row-sharded over the data axis (a
    # reduce-scatter and a gather each); every other variable, experts'
    # blocks included, syncs with one data-axis all-reduce.
    assert tplan.rendering("embed/embedding") == ("sharded", 0)
    n_float = sum(1 for v in tplan.var_plans.values() if v.var.dtype.startswith("float"))
    assert tplan.collectives_per_step() == {"all_reduce": n_float - 2, "reduce_scatter": 2,
                                            "all_gather": 2}


def test_tensor_parallel_renderings_and_wire():
    _, tplan = _plans("transformer", "TensorParallel", {}, TP_MESHES[1], ("data", "model"))
    assert tplan.rendering("layers_0/attn/wq/kernel") == ("partitioned", 1)
    assert tplan.rendering("layers_0/attn/wo/kernel") == ("partitioned", 0)
    assert tplan.rendering("embed/embedding") == ("partitioned", 0)
    assert tplan.rendering("layers_0/ln1/scale") == ("replicated", None)
    assert tplan.local_shape("layers_0/mlp/fc1/kernel") == (32, 32)
    n_float = sum(1 for v in tplan.var_plans.values() if v.var.dtype.startswith("float"))
    assert tplan.collectives_per_step()["all_reduce"] == n_float
    assert tplan.compressors() == {}



@pytest.mark.parametrize("compressor", ["PowerSGDCompressor", "TopKCompressor",
                                        "HorovodCompressorEF"])
def test_whole_gradient_compressors_on_split_variables_raise(compressor):
    """The name is kept from when PowerSGD and TopK on a model-split
    variable raised. JAX's manual sync compresses such a variable's whole
    gradient, and so does the port now: the plan prices PowerSGD's and
    TopK's collectives on the logical shape (a rank's block for the
    elementwise Horovod-EF), and the step constructs as far as its missing
    process group (a logical mesh has none; the step trains in
    ``tests/test_torch_tp_models.py``)."""
    from autodist_tpu_torch.kernel.compressor import get_compressor
    from autodist_tpu_torch.kernel.lowering import DistributedTrainStep

    _, titem = items("transformer")
    _, trs = _specs(TP_MESHES[1], 8)
    strategy = tstrat.StrategyCompiler(titem).compile(
        tstrat.from_name("TensorParallel", compressor=compressor).build(titem, trs))
    shape = trs.mesh_shape(("data", "model"))
    plan = GraphTransformer(strategy, titem, Mesh(axis_names=tuple(shape),
                                                  shape=shape)).transform()
    split = [n for n in plan.compressors() if plan.var_plans[n].model_sharded]
    assert split
    whole = compressor != "HorovodCompressorEF"
    comp = get_compressor(compressor)
    want = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0}
    for name in plan.var_plans:
        if not plan.var_plans[name].var.dtype.startswith("float"):
            continue
        if name not in plan.compressors():
            want["all_reduce"] += 1             # its plain all-reduce
            continue
        shape = plan.compressed_shape(name)
        if name in split:
            assert shape == (tuple(plan.var_plans[name].var.shape) if whole
                             else plan.local_shape(name)), name
        for kind, k in comp.collectives(shape).items():
            want[kind] += k
    assert plan.collectives_per_step() == want
    spec = get_model_spec("transformer", **ZOO["transformer"])
    tx = tmi.OptimizerSpec("sgd", {"learning_rate": 0.1}).make()
    with pytest.raises(ValueError, match="process group"):
        DistributedTrainStep(plan, spec.loss_fn, tx)

def test_logical_mesh_axes_and_coords():
    m = Mesh.logical({"data": 2, "expert": 4})
    assert m.axis_names == ("data", "expert", "model") and m.shard_axes == ("expert",)
    assert m.data_size == 2 and m.coords == {"data": 0, "expert": 0, "model": 0}
    m = Mesh(axis_names=("model", "data"), shape={"model": 2, "data": 2}, rank=3)
    assert m.coords == {"model": 1, "data": 1} and m.data_rank == 1
    m = Mesh(axis_names=("model", "data"), shape={"model": 2, "data": 2}, rank=1)
    assert m.coords == {"model": 0, "data": 1} and m.data_rank == 1
    # Any mix of the known axes renders; the shard mesh has a dim for each
    # wide model or expert axis. An unknown wide axis still raises.
    for shape in ({"data": 2, "model": 2, "expert": 2}, {"data": 2, "seq": 2},
                  {"data": 2, "seq": 2, "model": 2}):
        tmesh._check_axes(shape, "data")
    m = Mesh.logical({"data": 2, "model": 2, "expert": 2})
    assert m.shard_axes == ("model", "expert") and m.shard_mesh() is None
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tmesh._check_axes({"data": 2, "stage": 2}, "data")


@pytest.mark.parametrize("model", sorted(ZOO))
def test_only_the_transformer_family_trains_under_a_model_axis(model, tmp_path):
    """Every zoo model now trains under a model axis (the name is kept from
    when only the transformer family did): each variable placed as
    ``TensorParallel``'s plan at ``{data 4, model 2}`` renders it
    (``Shard(dim)`` for a split one, ``Replicate`` else), on a one-rank
    model mesh in this process, gives the plain loss and gradients. No
    conv kernel is split on a spatial dim."""
    from torch.distributed.tensor import Replicate, Shard

    _, titem = items(model)
    _, trs = _specs(TP_MESHES[1], 8)
    strategy = tstrat.StrategyCompiler(titem).compile(
        tstrat.from_name("TensorParallel").build(titem, trs))
    shape = trs.mesh_shape(("data", "model"))
    plan = GraphTransformer(strategy, titem, Mesh(axis_names=tuple(shape),
                                                  shape=shape)).transform()
    split = {n: plan.rendering(n)[1] for n in plan.var_plans
             if plan.rendering(n)[0] == "partitioned"}
    assert split, model
    for name, dim in split.items():
        if len(plan.var_plans[name].shape) == 4:
            assert dim in (2, 3), (name, dim)
    want, gwant, got, ggot = _placed_vs_plain(model, tmp_path, ("model",),
                                              lambda mesh, name: [Shard(split[name])]
                                              if name in split else [Replicate()])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for a, b in zip(ggot, gwant):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _placed_vs_plain(model, tmp_path, dims, placements):
    """``(plain loss, plain gradients, placed loss, placed gradients)`` of a
    zoo model at small widths from seeded numpy parameters: plain tensors,
    then each variable a ``DTensor`` on a one-rank mesh of ``dims`` placed
    as ``placements(mesh, name)`` says (the batch replicated), its
    gradients made whole."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from autodist_tpu_torch.utils.placement import placement_list

    js, ts = jax_get_model(model, **ZOO[model]), get_model_spec(model, **ZOO[model])
    rng = np.random.default_rng(1)
    params = map_params(lambda t: (torch.from_numpy(rng.standard_normal(t.shape)
                                                    .astype(np.float32)) * 0.1
                                   if t.is_floating_point() else t),
                        params_from_jax(jax.tree.map(
                            lambda s: np.zeros(s.shape, s.dtype),
                            jax.eval_shape(js.init, jax.random.PRNGKey(0))), device="cpu"))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in js.example_batch(4).items()}

    def loss_and_grads(p, b):
        p = map_params(lambda t: t.detach().requires_grad_(t.is_floating_point()), p)
        leaves = [t for t in flatten_params(p).values() if t.requires_grad]
        loss = ts.loss_fn(p, b)
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        grads = torch.autograd.grad(loss, leaves)
        return loss, [g.full_tensor() if isinstance(g, DTensor) else g for g in grads]

    want, gwant = loss_and_grads(params, batch)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0,
                            world_size=1)
    try:
        mesh = DeviceMesh("cpu", torch.zeros([1] * len(dims), dtype=torch.int),
                          mesh_dim_names=dims)
        placed = {n: DTensor.from_local(t, mesh, placements(mesh, n), run_check=False)
                  for n, t in flatten_params(params).items()}
        rep = placement_list(mesh, None, Replicate())
        dbatch = {k: DTensor.from_local(v, mesh, rep, run_check=False)
                  for k, v in batch.items()}
        with implicit_replication():
            got, ggot = loss_and_grads(unflatten_params(placed), dbatch)
    finally:
        dist.destroy_process_group()
    return want, gwant, got, ggot


ME_MESH = {"data": 2, "model": 2, "expert": 2}


@pytest.mark.parametrize("model", sorted(ZOO))
def test_zoo_trains_placed_on_a_model_by_expert_mesh(model, tmp_path):
    """Each zoo model with every variable placed as ``TensorParallel``'s
    plan at ``{data 2, model 2, expert 2}`` renders it, on a one-rank
    two-dim (model, expert) mesh in this process: a model-split variable
    ``[Shard(dim), Replicate()]``, an expert-split one ``[Replicate(),
    Shard(0)]``, the rest ``Replicate`` on both (a model without expert
    variables is replicated over the expert ranks). It gives the plain loss
    and gradients, at the one-dim test's tolerances."""
    from torch.distributed.tensor import Replicate, Shard

    from autodist_tpu_torch.utils.placement import placement_list

    _, titem = items(model)
    _, trs = _specs(ME_MESH, 8)
    strategy = tstrat.StrategyCompiler(titem).compile(
        tstrat.from_name("TensorParallel").build(titem, trs))
    shape = trs.mesh_shape(tuple(ME_MESH))
    plan = GraphTransformer(strategy, titem, Mesh(axis_names=tuple(shape),
                                                  shape=shape)).transform()
    assert plan.mesh.shard_axes == ("model", "expert")
    split = {n: (plan.var_plans[n].storage_axis, plan.rendering(n)[1]) for n in plan.var_plans
             if plan.rendering(n)[0] in ("partitioned", "expert")}
    axes = {ax for ax, _ in split.values()}
    assert axes == ({"model", "expert"} if model == "moe_transformer" else {"model"}), axes

    def placements(mesh, name):
        ax, d = split.get(name, (None, None))
        return placement_list(mesh, ax, Shard(d) if ax else Replicate())

    want, gwant, got, ggot = _placed_vs_plain(model, tmp_path, ("model", "expert"),
                                              placements)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for a, b in zip(ggot, gwant):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_dtensor_counts_and_shared_counters(tmp_path):
    """``count_dtensor`` counts ``DTensor``'s functional collectives only,
    and ``Collectives.over`` adds to the same counters (one gloo rank)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.device_mesh import DeviceMesh

    from autodist_tpu_torch.runtime import process_group as pg

    group = pg.join(torch.device("cpu"), init_method=f"file://{tmp_path}/pg", world_size=1,
                    rank=0)
    try:
        coll = pg.Collectives(group)
        mesh = DeviceMesh("cpu", [0], mesh_dim_names=("model",))
        with coll.count_dtensor("model"):
            # The functional collective DTensor issues (a one-rank mesh
            # skips its own redistributions), and a c10d one of this class.
            funcol.wait_tensor(funcol.all_reduce(torch.ones(4), "sum", (mesh, 0)))
            coll.all_reduce(torch.ones(2), "grad")
        assert coll.snapshot() == {"model": {"all_reduce": 1}, "grad": {"all_reduce": 1}}
        other = coll.over(group)
        other.all_reduce(torch.ones(2), "optimizer")
        assert coll.snapshot()["optimizer"] == {"all_reduce": 1}
    finally:
        pg.leave()
