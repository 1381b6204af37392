"""Port parity: the training path (model -> strategy -> lowering -> API).

The JAX package and the port run side by side on the CPU, on the same
weights (JAX ``init`` carried over with ``params_from_jax``) and the same
deterministic example batches:

- the ``VarItem`` list (names, order, shapes, dtypes, sparse flags) of
  ``ModelItem.from_params`` with the loss traced;
- ``Strategy.to_json()`` of every ported builder (AllReduce, PS,
  PSLoadBalancing, PartitionedPS, UnevenPartitionedPS, PartitionedAR,
  RandomAxisPartitionAR, Parallax, Zero1) on one yml spec (``id``/``path``
  blanked, ``TPU`` -> ``GPU`` in device names);
- ``loss_fn`` value and gradients, causal and MLM, flash attention, fp32
  (JAX runs its Pallas kernels in interpret mode): 1e-5 on the loss, 1e-5
  absolute + 1e-4 relative on gradients (summation order only);
- 3 steps of ``AutoDist(AllReduce).build(...).run(...)`` with SGD and with
  adamw + clipping + the BERT warmup schedule: losses and final params to
  1e-5 / 1e-4 relative. The JAX side runs on ``tests/conftest.py``'s
  8-device CPU mesh, so the batch (8) divides it;
- optax's update rules against the port's tensor code, leaf by leaf.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autodist_tpu import api as japi
from autodist_tpu import model_item as jmi
from autodist_tpu import strategy as jstrat
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.resource_spec import ResourceSpec as JaxResourceSpec
from autodist_tpu_torch import api as tapi
from autodist_tpu_torch import model_item as tmi
from autodist_tpu_torch import strategy as tstrat
from autodist_tpu_torch.kernel import GraphTransformer, Mesh, build_mesh
from autodist_tpu_torch.models import get_model, get_model_spec
from autodist_tpu_torch.models.convert import (
    flatten_params, params_from_jax, params_to_numpy, unflatten_params)
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.base import replica_devices
from autodist_tpu_torch.strategy.ir import (
    AllReduceSynchronizer, NodeConfig, PSSynchronizer, Strategy)

SMALL = dict(vocab_size=101, num_layers=2, d_model=64, num_heads=1, d_ff=128,
             max_seq_len=128, attention_impl="flash")
LOSS_TOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-4
SPEC_YML = """
nodes:
  - address: 10.0.0.1
    chips: 2
    chief: true
  - address: 10.0.0.2
    chips: 2
"""


@pytest.fixture(autouse=True)
def _fresh_autodist():
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()
    yield
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()


def _pair(model, **overrides):
    """(JAX spec, JAX params, port spec, port params) on carried-over weights."""
    jspec = jax_get_model(model, dtype=jnp.float32, **overrides)
    tspec = get_model_spec(model, dtype="float32", **overrides)
    jparams = jspec.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jspec, jparams, tspec, tparams


def _batches(jspec, tspec, b):
    jbatch = jspec.example_batch(b)
    tbatch = tspec.example_batch(b, device="cpu")
    assert set(jbatch) == set(tbatch)
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k].numpy(), np.asarray(jbatch[k]))
    return jbatch, tbatch


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in flatten_params(tree).items()}


def _assert_trees_close(got, want, atol, rtol, skip=()):
    got, want = _flat_np(got), _flat_np(want)
    assert list(got) == list(want)
    for name in want:
        if any(name.endswith(s) for s in skip):
            continue
        np.testing.assert_allclose(got[name], want[name], atol=atol, rtol=rtol,
                                   err_msg=name)


# ------------------------------------------------------------------ capture
@pytest.mark.parametrize("model", ["transformer", "bert_base"])
def test_var_items_match_jax_model_item(model):
    # 11 layers: jax.tree_util orders layers_10 before layers_2.
    overrides = dict(SMALL, num_layers=11, d_model=32, d_ff=64, max_seq_len=16,
                     attention_impl="dot")
    jspec, jparams, tspec, tparams = _pair(model, **overrides)
    jbatch, tbatch = _batches(jspec, tspec, 2)
    jitem = jmi.ModelItem.from_params(jparams, loss_fn=jspec.loss_fn,
                                      example_batch=jbatch)
    titem = tmi.ModelItem.from_params(tparams, loss_fn=tspec.loss_fn,
                                      example_batch=tbatch)

    def rows(item):
        return [(v.name, tuple(v.shape), v.dtype, v.trainable, v.sparse_update,
                 v.byte_size) for v in item.variables]

    assert rows(titem) == rows(jitem)
    assert {v.name for v in titem.sparse_variables} == {"embed/embedding",
                                                        "pos_embed/embedding"}
    assert titem.batch_size == jitem.batch_size == 2
    assert list(flatten_params(tparams)) == [v.name for v in jitem.variables]
    assert flatten_params(unflatten_params(flatten_params(tparams))).keys() == \
        flatten_params(tparams).keys()


def test_sparse_trace_follows_views_and_casts_not_dense_reads():
    w = torch.zeros((5, 3))
    params = {"a": {"table": torch.zeros((7, 3))}, "b": {"w": w}, "c": {"t": w.clone()}}

    def loss(p, batch):
        rows = p["a"]["table"].to(torch.float64)[batch]       # cast, then gather
        col = p["c"]["t"].T[0]                                 # a view, then a slice
        ones = torch.ones(3, device=p["b"]["w"].device)
        return rows.sum() + (p["b"]["w"] @ ones).sum() + col.sum()

    item = tmi.ModelItem.from_params(params, loss_fn=loss,
                                     example_batch=torch.tensor([1, 2]))
    assert [v.name for v in item.sparse_variables] == ["a/table"]
    forced = tmi.ModelItem.from_params(params, sparse_names=("b",))
    assert [v.name for v in forced.sparse_variables] == ["b/w"]


# ----------------------------------------------------------------- strategy
def _strategy_json(strategy, tpu_to_gpu=False):
    d = strategy.to_json()
    d["id"] = d["path"] = ""
    if tpu_to_gpu:
        import json

        d = json.loads(json.dumps(d).replace(":TPU:", ":GPU:"))
    return d


BUILDER_KWARGS = {"AllReduce": {"chunk_size": 5}, "PartitionedAR": {"chunk_size": 5},
                  "RandomAxisPartitionAR": {"chunk_size": 5, "seed": 3},
                  "Zero1": {"min_bytes": 1024, "bucket_bytes": 1 << 16}}


@pytest.mark.parametrize("builder", [
    "AllReduce", "PS", "PSLoadBalancing", "PartitionedPS", "UnevenPartitionedPS",
    "PartitionedAR", "RandomAxisPartitionAR", "Parallax", "Zero1"])
def test_strategy_json_matches_jax(builder, tmp_path):
    spec_file = tmp_path / "spec.yml"
    spec_file.write_text(SPEC_YML)
    kwargs = BUILDER_KWARGS.get(builder, {})
    jspec, jparams, tspec, tparams = _pair("bert_base", **dict(SMALL, num_layers=3))
    jitem = jmi.ModelItem.from_params(jparams)
    titem = tmi.ModelItem.from_params(tparams)
    jstrategy = getattr(jstrat, builder)(**kwargs).build(
        jitem, JaxResourceSpec(str(spec_file)))
    tstrategy = tstrat.from_name(builder, **kwargs).build(
        titem, ResourceSpec(str(spec_file)))
    want = _strategy_json(jstrategy, tpu_to_gpu=True)
    assert _strategy_json(tstrategy) == want
    assert want["graph_config"]["replicas"][0] == "10.0.0.1:GPU:0"
    # The JSON round trip, and the port reading the JAX package's file.
    back = Strategy.from_json(jstrategy.to_json())
    assert _strategy_json(back, tpu_to_gpu=True) == want


def test_strategy_serializes_under_the_strategy_dir():
    titem = tmi.ModelItem.from_params({"w": torch.zeros(3)})
    s = tstrat.AllReduce().build(titem, ResourceSpec(resource_dict={}))
    path = s.serialize()
    assert Strategy.deserialize(s.id).to_json() == s.to_json()
    assert path.startswith(tapi.const.DEFAULT_STRATEGY_DIR)


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("model", ["transformer", "bert_base"])
def test_flash_loss_and_grads_match_jax(model):
    jspec, jparams, tspec, tparams = _pair(model, **SMALL)
    jbatch, tbatch = _batches(jspec, tspec, 2)
    jloss, jgrads = jax.jit(jax.value_and_grad(jspec.loss_fn))(jparams, jbatch)
    flat = {k: v.clone().requires_grad_(True) for k, v in flatten_params(tparams).items()}
    loss = tspec.loss_fn(unflatten_params(flat), tbatch)
    grads = torch.autograd.grad(loss, list(flat.values()))
    np.testing.assert_allclose(loss.item(), float(jloss), atol=LOSS_TOL, rtol=LOSS_TOL)
    jflat = _flat_np(jgrads)
    for (name, g) in zip(flat, grads):
        np.testing.assert_allclose(g.numpy(), jflat[name], atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_flops_per_example_and_spec_match_jax():
    jspec, _, tspec, _ = _pair("bert_base", **dict(SMALL, max_seq_len=512))
    assert tspec.flops_per_example == jspec.flops_per_example
    assert tspec.name == "bert_base" and not tspec.config.causal
    assert tspec.config.mlm_mask_token == jspec.config.mlm_mask_token
    big = get_model_spec("bert_large")
    assert (big.config.num_layers, big.config.d_model, big.config.num_heads) == (24, 1024, 16)
    assert get_model("transformer").vocab_size == 32000      # the serving entry points


# ------------------------------------------------------------------ training
OPTIMIZERS = {
    "sgd": (None, None),
    "adamw_clip_warmup": (
        jmi.OptimizerSpec("adamw", {"learning_rate": {
            "schedule": "warmup_polynomial", "peak_value": 1e-3, "warmup_steps": 2,
            "decay_steps": 10}}, clip_norm=0.5),
        tmi.OptimizerSpec("adamw", {"learning_rate": {
            "schedule": "warmup_polynomial", "peak_value": 1e-3, "warmup_steps": 2,
            "decay_steps": 10}}, clip_norm=0.5)),
}


@pytest.mark.parametrize("model,opt", [("transformer", "sgd"),
                                       ("bert_base", "adamw_clip_warmup")])
def test_three_autodist_steps_match_jax(model, opt):
    jopt, topt = OPTIMIZERS[opt]
    jspec, jparams, tspec, tparams = _pair(model, **SMALL)
    jbatch, tbatch = _batches(jspec, tspec, 8)

    jad = japi.AutoDist(strategy_builder=jstrat.AllReduce())
    jstep = jad.build(jspec.loss_fn, jparams, jbatch, optimizer=jopt)
    jstate, jm = jstep.run(jstep.init(jparams), jbatch, 3)

    tad = tapi.AutoDist(strategy_builder=tstrat.AllReduce(), device="cpu")
    tstep = tad.build(tspec.loss_fn, tparams, tbatch, optimizer=topt)
    tstate, tm = tstep.run(tstep.init(tparams), tbatch, 3)

    assert tm["loss"].shape == (3,) and tstate.step == 3
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               atol=LOSS_TOL, rtol=LOSS_TOL)
    # The key biases' true gradient is 0 (softmax ignores a per-query
    # constant): theirs is rounding noise, which adam scales up to lr-sized
    # steps of either sign in both packages, so they are left out under adam.
    skip = ("attn/wk/bias",) if jopt is not None else ()
    _assert_trees_close(params_to_numpy(tstep.logical_params(tstate)),
                        jax.tree.map(np.asarray, jstep.logical_params(jstate)),
                        PARAM_ATOL, PARAM_RTOL, skip=skip)
    # The caller's params are copied, never updated in place.
    _assert_trees_close(params_to_numpy(tparams),
                        jax.tree.map(np.asarray, jparams), 0, 0)
    ev = tstep.evaluate(tstate, tbatch)["loss"]
    np.testing.assert_allclose(ev.item(), float(jstep.evaluate(jstate, jbatch)["loss"]),
                               atol=LOSS_TOL, rtol=LOSS_TOL)


def test_ps_load_balancing_trains_like_all_reduce_and_stacked_run():
    _, _, tspec, tparams = _pair("transformer", **dict(SMALL, attention_impl="dot"))
    batch = tspec.example_batch(2, device="cpu")
    losses = {}
    for name in ("AllReduce", "PSLoadBalancing"):
        tapi.AutoDist.reset_default()
        ad = tapi.AutoDist(strategy_builder=name, device="cpu")
        step = ad.build(tspec.loss_fn, tparams, batch)
        stacked = {k: torch.stack([v] * 2) for k, v in batch.items()}
        state, m = step.run(step.init(tparams), stacked, 2, stacked=True)
        losses[name] = m["loss"]
        kinds = {p.kind.value for p in ad.plan.var_plans.values()}
        assert kinds == ({"all_reduce"} if name == "AllReduce" else {"ps"})
    assert torch.equal(losses["AllReduce"], losses["PSLoadBalancing"])
    assert losses["AllReduce"][1] < losses["AllReduce"][0]


@pytest.mark.parametrize("name,kwargs,tx_kwargs", [
    ("sgd", {"learning_rate": 0.1}, {}),
    ("momentum", {"learning_rate": 0.1}, {}),
    ("adam", {"learning_rate": 0.01, "b1": 0.8}, {}),
    ("adamw", {"learning_rate": 0.01, "weight_decay": 0.1}, {}),
    ("adamw", {"learning_rate": {"schedule": "warmup_polynomial", "peak_value": 0.01,
                                 "warmup_steps": 2, "decay_steps": 5, "power": 2.0,
                                 "end_value": 1e-4}}, {"clip_norm": 0.3}),
    ("sgd", {"learning_rate": {"schedule": "constant", "value": 0.2}}, {"clip_norm": 1e3}),
])
def test_optimizer_updates_match_optax(name, kwargs, tx_kwargs):
    rng = np.random.default_rng(7)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    tx = jmi.OptimizerSpec(name, kwargs, **tx_kwargs).make()
    opt = tmi.OptimizerSpec(name, kwargs, **tx_kwargs).make()
    jp = [jnp.asarray(p) for p in params]
    tp = [torch.from_numpy(p.copy()) for p in params]
    jstate, tstate = tx.init(jp), opt.init(tp)
    for _ in range(7):
        grads = [rng.standard_normal(p.shape).astype(np.float32) for p in params]
        updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, updates)
        with torch.no_grad():
            for p, u in zip(tp, opt.update([torch.from_numpy(g) for g in grads],
                                           tstate, tp)):
                p.add_(u)
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)


def test_unported_options_raise_not_implemented():
    titem = tmi.ModelItem.from_params({"w": torch.zeros((4, 2))})
    one_host = {"nodes": [{"address": "localhost", "gpus": 0}]}
    mesh = build_mesh(ResourceSpec(resource_dict=one_host), device="cpu")

    def lower(sync, bucket=0, on=mesh):
        s = Strategy(node_config=[NodeConfig("w", synchronizer=sync)])
        s.graph_config.bucket_bytes = bucket
        return GraphTransformer(s, titem, on).transform()

    assert lower(AllReduceSynchronizer()).plan_for("w").kind.value == "all_reduce"
    # ZeRO-1 and buckets lower now: on a data axis of 4 the update shards
    # axis 0; on one device ZeRO-1 degrades to replication, as in JAX.
    four = Mesh.logical({"data": 4})
    assert lower(AllReduceSynchronizer(shard_update=True), on=four).plan_for(
        "w").shard_update
    assert lower(AllReduceSynchronizer(shard_update=True)).plan_for(
        "w").degradations == ("non_divisible",)
    assert lower(AllReduceSynchronizer(), bucket=1 << 20).bucket_assignment() == (("w",),)
    # Compressors and staleness lower now; the direct lowering of an
    # asynchronous PS still raises (AutoDist.build routes it to the async
    # trainer), as the JAX package's does.
    assert lower(AllReduceSynchronizer(compressor="HorovodCompressor")).plan_for(
        "w").compressor == "HorovodCompressor"
    assert lower(PSSynchronizer(staleness=2)).plan_for("w").staleness == 2
    with pytest.raises(NotImplementedError, match="AsyncPSTrainer"):
        lower(PSSynchronizer(sync=False))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lower(AllReduceSynchronizer(), on=Mesh.logical({"data": 2, "model": 2}))
    tstrat.PSLoadBalancing(sync=False)
    tstrat.PSLoadBalancing(staleness=1)
    with pytest.raises(ValueError, match="disagree"):
        build_mesh(ResourceSpec(resource_dict={"nodes": [
            {"address": "localhost", "gpus": 2}]}), device="cpu")
    ad = tapi.AutoDist(strategy_builder="AllReduce", device="cpu")
    step = ad.build(lambda p, b: (p["w"] ** 2).sum(), {"w": torch.ones((4, 2))},
                    torch.zeros(1), host_offload=True)
    assert not step.plan.has_offload            # AllReduce variables stay resident


def test_compute_dtype_and_aux_metrics():
    seen = []

    def loss(p, b):
        seen.append(p["w"].dtype)
        value = ((p["w"].float() - b) ** 2).mean()
        return value, {"w_mean": p["w"].float().mean().detach()}

    params = {"w": torch.ones((4, 2))}
    ad = tapi.AutoDist(strategy_builder="AllReduce", device="cpu")
    step = ad.build(loss, params, torch.zeros(1), has_aux=True, compute_dtype="bfloat16")
    state, m = step.run(step.init(params), torch.zeros(1), 2)
    assert seen[-1] == torch.bfloat16                      # the loss saw bf16 params
    assert state.params["w"].dtype == torch.float32        # the state stayed fp32
    assert m["loss"].shape == (2,) and m["aux"]["w_mean"].shape == (2,)
    assert m["aux"]["w_mean"][1] < m["aux"]["w_mean"][0]   # SGD moved w towards 0
    with pytest.raises(ValueError, match="floating"):
        tapi.AutoDist.reset_default()
        tapi.AutoDist(device="cpu").build(loss, params, torch.zeros(1), compute_dtype="int32")


def test_worker_loads_the_chiefs_strategy(monkeypatch):
    monkeypatch.setenv("AUTODIST_STRATEGY_ID", "")       # restored after the test
    params = {"w": torch.ones((4, 2))}

    def loss(p, b):
        return (p["w"] ** 2).sum()

    chief = tapi.AutoDist(strategy_builder="AllReduce", device="cpu")
    chief.build(loss, params, torch.zeros(1))
    assert os.environ["AUTODIST_STRATEGY_ID"] == chief.strategy.id
    tapi.AutoDist.reset_default()
    monkeypatch.setenv("AUTODIST_WORKER", "1")
    worker = tapi.AutoDist(strategy_builder="PSLoadBalancing", device="cpu")
    worker.build(loss, params, torch.zeros(1))
    assert worker.strategy.to_json() == chief.strategy.to_json()
    assert worker.plan.plan_for("w").kind.value == "all_reduce"   # the chief's, not PS


def test_autodist_is_one_per_process_and_needs_cuda_unless_cpu():
    a = tapi.AutoDist(device="cpu")
    assert isinstance(a.strategy_builder, tstrat.PSLoadBalancing)
    assert a.resource_spec.num_gpus == 0 and a.mesh.devices == (torch.device("cpu"),)
    with pytest.raises(RuntimeError, match="Only one AutoDist"):
        tapi.AutoDist(device="cpu")
    tapi.AutoDist.reset_default()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tapi.AutoDist()


def test_resource_spec_devices_and_fingerprint(tmp_path):
    spec_file = tmp_path / "spec.yml"
    spec_file.write_text(SPEC_YML)
    spec = ResourceSpec(str(spec_file))
    assert [d.name_string() for d in spec.gpu_devices] == [
        "10.0.0.1:GPU:0", "10.0.0.1:GPU:1", "10.0.0.2:GPU:0", "10.0.0.2:GPU:1"]
    assert [d.name_string() for d in spec.cpu_devices] == ["10.0.0.1:CPU:0",
                                                           "10.0.0.2:CPU:0"]
    assert spec.mesh_shape(("data", "model")) == {"data": 4, "model": 1}
    assert spec.fingerprint() == ResourceSpec(resource_dict=spec.to_dict()).fingerprint()
    with pytest.raises(ValueError, match="one chief"):
        ResourceSpec(resource_dict={"nodes": [{"address": "a", "chief": True},
                                              {"address": "b", "chief": True}]})
    cpu = ResourceSpec.from_local_devices("cpu")
    assert cpu.num_gpus == 0 and replica_devices(cpu) == ["localhost:CPU:0"]
