"""Port parity of the multi-device plan (no processes: a plan needs only
the mesh's axis sizes, ``Mesh.logical``).

For every ported builder (``helpers/torch_dist.py``'s, plus AllReduce with
4 KiB buckets and Zero1 with ``min_bytes``) x the e2e dense and embedding
models, a small bert_base and a small ResNet-18 x a data axis of 2, 4 and
8: the port's ``Strategy`` JSON equals the JAX builder's (``TPU`` ->
``GPU`` in device names), and its ``ShardingPlan`` equals JAX's
``GraphTransformer`` plan on a mesh of the first ``n`` CPU devices, var for
var: the kind, ``storage_dim`` / ``update_dim`` (the non-``None`` entry of
``pspec`` / ``update_pspec``), ``storage_shape``, ``shard_update``,
``degradations``, shard count and destinations; the bucket assignment; and
``describe()``, line for line.
"""
import functools
import importlib
import json

import jax
import numpy as np
import pytest

from autodist_tpu import model_item as jmi
from autodist_tpu import strategy as jstrat
from autodist_tpu.kernel import GraphTransformer as JGraphTransformer
from autodist_tpu.kernel import build_mesh as jbuild_mesh
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu_torch import model_item as tmi
from autodist_tpu_torch import strategy as tstrat
from autodist_tpu_torch.kernel import GraphTransformer, Mesh
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.models.convert import params_from_jax
from autodist_tpu_torch.resource_spec import ResourceSpec
from helpers import torch_dist as td
from helpers import torch_dist_worker as worker

JR = importlib.import_module("autodist_tpu.models.resnet")
BERT = dict(vocab_size=101, num_layers=2, d_model=64, num_heads=1, d_ff=128,
            max_seq_len=32, attention_impl="dot")
RESNET = dict(depth=18, width=8, num_classes=10, image_size=32)
BUILDERS = td.BUILDERS + [
    ("AllReduce-buckets-4k", "AllReduce", {"bucket_bytes": 4096}),
    ("Zero1-min-bytes", "Zero1", {"min_bytes": 256, "bucket_bytes": 4096}),
]
MODELS = ("dense", "embed", "bert_base", "resnet")


def _filled(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


@functools.lru_cache(maxsize=None)
def items(model):
    """(JAX ModelItem, port ModelItem) with the loss traced on both sides."""
    if model in ("dense", "embed"):
        params, batch = td.inputs()[model]
        jitem = jmi.ModelItem.from_params(params, loss_fn=td.JAX_LOSSES[model],
                                          example_batch=batch)
        titem = tmi.ModelItem.from_params(td.to_torch(params), loss_fn=worker.LOSSES[model],
                                          example_batch=td.to_torch(batch))
        return jitem, titem
    if model == "bert_base":
        jspec = jax_get_model("bert_base", **BERT)
        tspec = get_model_spec("bert_base", **BERT)
        jparams = _filled(jax.eval_shape(jspec.init, jax.random.PRNGKey(0)))
        jbatch = jspec.example_batch(4)
        tbatch = tspec.example_batch(4, device="cpu")
        jloss, tloss = jspec.loss_fn, tspec.loss_fn
    else:
        depth, classes, size = RESNET["depth"], RESNET["num_classes"], RESNET["image_size"]
        jparams = _filled(jax.eval_shape(
            lambda k: JR.init_params(k, depth, classes, width=RESNET["width"]),
            jax.random.PRNGKey(0)))
        jbatch = JR.image_example_batch(size, classes)(4)
        tbatch = get_model_spec("resnet", image_size=size,
                                num_classes=classes).example_batch(4, device="cpu")
        jloss, tloss = td.jax_resnet_loss(depth), worker.resnet_loss(depth)
    tparams = params_from_jax(jparams, device="cpu")
    jitem = jmi.ModelItem.from_params(jparams, loss_fn=jloss, example_batch=jbatch)
    titem = tmi.ModelItem.from_params(tparams, loss_fn=tloss, example_batch=tbatch)
    return jitem, titem


def _dim(pspec):
    dims = [i for i, e in enumerate(tuple(pspec)) if e is not None]
    assert len(dims) <= 1
    return dims[0] if dims else None


def _strategy_json(strategy, tpu_to_gpu=False):
    d = strategy.to_json()
    d["id"] = d["path"] = ""
    text = json.dumps(d)
    return json.loads(text.replace(":TPU:", ":GPU:") if tpu_to_gpu else text)


def test_model_items_agree():
    for model in MODELS:
        jitem, titem = items(model)
        assert [(v.name, tuple(v.shape), v.sparse_update) for v in titem.variables] == \
            [(v.name, tuple(v.shape), v.sparse_update) for v in jitem.variables]
    assert [v.name for v in items("embed")[1].sparse_variables] == ["embedding"]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("bid,builder,kwargs", BUILDERS, ids=[b[0] for b in BUILDERS])
def test_plan_matches_jax(bid, builder, kwargs, model, n):
    jitem, titem = items(model)
    nodes = {"nodes": [{"address": "localhost", "chips": n, "chief": True}]}
    jrs, trs = JResourceSpec(resource_dict=nodes), ResourceSpec(resource_dict=nodes)
    jstrategy = jstrat.StrategyCompiler(jitem).compile(
        jstrat.from_name(builder, **kwargs).build(jitem, jrs))
    tstrategy = tstrat.StrategyCompiler(titem).compile(
        tstrat.from_name(builder, **kwargs).build(titem, trs))
    assert _strategy_json(tstrategy) == _strategy_json(jstrategy, tpu_to_gpu=True)

    jplan = JGraphTransformer(jstrategy, jitem,
                              jbuild_mesh(jrs, devices=jax.devices()[:n])).transform()
    tplan = GraphTransformer(tstrategy, titem, Mesh.logical({"data": n})).transform()
    assert list(tplan.var_plans) == list(jplan.var_plans)
    for name, jp in jplan.var_plans.items():
        tp = tplan.var_plans[name]
        want = (jp.kind.value, _dim(jp.pspec), _dim(jp.update_pspec), jp.storage_shape,
                jp.shard_update, jp.degradations, jp.num_shards, jp.shard_destinations,
                jp.reduction_destination, jp.local_replication)
        got = (tp.kind.value, tp.storage_dim, tp.update_dim, tp.storage_shape,
               tp.shard_update, tp.degradations, tp.num_shards, tp.shard_destinations,
               tp.reduction_destination, tp.local_replication)
        assert got == want, name
    assert tplan.bucket_assignment() == jplan.bucket_assignment()
    assert tplan.describe() == jplan.describe()
