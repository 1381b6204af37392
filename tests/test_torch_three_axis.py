"""Port parity of training on three-axis meshes with a model or expert axis:
8 gloo ranks, one process each, on the CPU (``helpers/torch_dist.py``'s
harness at world 8), against JAX's step on an 8-device mesh of the same
shape (``jax.devices()[:8]``), from the same numpy parameters
(``params_from_jax``), in fp32, two SGD steps at lr 0.05 on a global batch
of 8, every rank's logical parameters bitwise equal:

- the small ``moe_transformer`` (2 layers, d 32, 4 heads, d_ff 64, seq 16,
  4 experts) under ``TensorParallel`` at data 2 x model 2 x expert 2 with
  flash attention (each rank's 2 heads: ``Shard(2)`` on ``model``, whole
  over ``expert``): its Megatron pairs on ``model``, its ``[E, ...]`` kernels
  on ``expert``, each variable on one axis at most as in JAX's plan;
- the small causal ``transformer`` (``tests/test_torch_seq_parallel.py``'s
  ``SMALL``) under ``TensorParallel`` with ``ulysses`` and with ``ring``
  attention at data 2 x seq 2 x model 2 (the seq group runs on each rank's
  2 heads through ``local_map``);
- the small MoE with ``ulysses`` at data 2 x seq 2 x expert 2 (``max_seq_len``
  17, so the shifted sequence is 16), and at data 1 x seq 2 x expert 4: the
  expert axis wider than the heads a seq rank needs (the heads stay whole
  over the expert ranks, as JAX's are, so Ulysses splits all 4 over seq);
- ResNet-18 (width 8, 32 px) under ``TensorParallel`` at data 2 x model 2 x
  expert 2: the convs on split weights and the fused 1x1 conv + BatchNorm's
  plain version through ``local_map`` on the two-dim shard mesh (nothing is
  split over ``expert``: the ranks of that axis hold every variable whole).

The port routes each data rank's tokens through the MoE, JAX's GSPMD step
the global batch's (a rendering that differs on purpose, pinned by
``tests/test_torch_tp_e2e.py::test_unbucketed_moe_routes_per_rank``).
The model x expert case takes gradient buckets (``bucket_bytes`` 4096 in
the strategy's graph config, on both sides): JAX's bucketed step is its
manual one, which routes per data rank as the port does. JAX's manual step
cannot run Ulysses (its ``shard_map`` over ``seq`` does not open inside
the one over ``data``), so the seq x expert case runs JAX's GSPMD step
with a routing that cannot tell the two apart: a capacity factor of 4
(each expert can take every token of a rank: nothing is dropped either
way) and no auxiliary loss (a batch statistic, a mean of products).

Tolerances: the transformer and MoE losses within rtol 1e-5 and parameters
within rtol 2e-5 / atol 2e-6 (``tests/test_torch_seq_parallel.py``'s bars);
ResNet-18 within twice JAX's own spread, as
``tests/test_torch_tp_models.py`` holds it (its fp32 gradients at init move
with summation order). Each step's data-axis wire equals the plan's
prediction, and ``DTensor``'s own collectives are counted under each wide
shard axis's name.
"""
import importlib

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
from autodist_tpu_torch.models.convert import params_from_jax
from helpers import torch_dist as td
from test_torch_dist_resnet import _rel_update
from test_torch_tp_e2e import filled
from test_torch_tp_models import (CLASSES, CNN_LR, DEPTH, IMAGE, LOSS_RTOL, SPREAD_FACTOR,
                                  UPDATE_RTOL, WIDTH, _reordered_in_blocks)

JR = importlib.import_module("autodist_tpu.models.resnet")

WORLD = 8
SMALL = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4, d_ff=64, max_seq_len=16)
MOE = dict(SMALL, num_experts=4)
LR, STEPS, BATCH = 0.05, 2, 8
ME = {"data": 2, "model": 2, "expert": 2}
SM = {"data": 2, "seq": 2, "model": 2}
SE = {"data": 2, "seq": 2, "expert": 2}
SE4 = {"data": 1, "seq": 2, "expert": 4}
BUCKETS = 4096
JAX_MODELS = {"transformer": "transformer", "moe": "moe_transformer",
              "moe17": "moe_transformer"}


def _case(cid, model, builder, mesh, overrides=None, **extra):
    lr = CNN_LR.get(model, LR)
    return dict(id=cid, model=model, zoo=JAX_MODELS.get(model, model), builder=builder,
                builder_kwargs={}, opt="sgd", opt_kwargs={"learning_rate": lr},
                clip_norm=None, steps=STEPS, mesh=mesh, mesh_axes=tuple(mesh),
                overrides=dict(overrides or {}, dtype="float32"), **extra)


EXACT = [
    _case("moe/tp/model2expert2", "moe", "TensorParallel", ME,
          dict(MOE, attention_impl="flash"), expert_names=("expert_",),
          bucket_bytes=BUCKETS),
    _case("transformer/ulysses/seq2model2", "transformer", "TensorParallel", SM,
          dict(SMALL, attention_impl="ulysses")),
    _case("transformer/ring/seq2model2", "transformer", "TensorParallel", SM,
          dict(SMALL, attention_impl="ring")),
    _case("moe/ulysses/seq2expert2", "moe17", "AllReduce", SE,
          dict(MOE, max_seq_len=17, attention_impl="ulysses", capacity_factor=4.0,
               aux_loss_weight=0.0), expert_names=("expert_",)),
    _case("moe/ulysses/seq2expert4", "moe17", "AllReduce", SE4,
          dict(MOE, max_seq_len=17, attention_impl="ulysses", capacity_factor=4.0,
               aux_loss_weight=0.0), expert_names=("expert_",)),
]
RESNET = dict(_case("resnet18/tp/model2expert2", "resnet", "TensorParallel", ME),
              depth=DEPTH)
CASES = EXACT + [RESNET]


# ------------------------------------------------------------------- JAX
def _jax_loss(c):
    if c["model"] == "resnet":
        return td.jax_resnet_loss(DEPTH)
    return jax_get_model(c["zoo"], **dict(c["overrides"], dtype=jnp.float32)).loss_fn


def inputs():
    out = {"resnet": (filled(jax.eval_shape(
        lambda k: JR.init_params(k, DEPTH, CLASSES, width=WIDTH), jax.random.PRNGKey(0)), 2),
        jax.tree.map(np.asarray, JR.image_example_batch(IMAGE, CLASSES)(BATCH)))}
    for c in EXACT:
        if c["model"] not in out:
            spec = jax_get_model(c["zoo"], **dict(c["overrides"], dtype=jnp.float32))
            params = filled(jax.eval_shape(spec.init, jax.random.PRNGKey(0)), 1)
            out[c["model"]] = (params, jax.tree.map(np.asarray, spec.example_batch(BATCH)))
    return out


def jax_runs(c, params, batches):
    """``(losses, flat logical params)`` of JAX's step on an 8-device mesh
    of the case's shape after its steps, from ``params``, on each batch (one
    compiled step). Its ring/Ulysses attention reads the mesh of the default
    AutoDist, made here over the same devices."""
    loss_fn = _jax_loss(c)
    rs = JResourceSpec(resource_dict={
        "nodes": [{"address": "localhost", "chips": WORLD, "chief": True}],
        "mesh": c["mesh"]})
    mesh = jbuild_mesh(rs, axes=c["mesh_axes"], devices=jax.devices()[:WORLD])
    opt = jmi.OptimizerSpec(c["opt"], dict(c["opt_kwargs"]))
    item = jmi.ModelItem.from_params(params, optimizer_spec=opt, loss_fn=loss_fn,
                                     example_batch=batches[0],
                                     expert_names=c.get("expert_names", ()))
    strategy = jstrat.from_name(c["builder"], **c["builder_kwargs"]).build(item, rs)
    if c.get("bucket_bytes"):
        strategy.graph_config.bucket_bytes = c["bucket_bytes"]
    strategy = jstrat.StrategyCompiler(item).compile(strategy)
    JAutoDist.reset_default()
    try:
        ad = JAutoDist(resource_spec=rs, mesh_axes=c["mesh_axes"])
        ad._mesh = mesh
        step = JStep(JGraphTransformer(strategy, item, mesh).transform(), loss_fn, opt.make())
        out = []
        for batch in batches:
            state, losses = step.init(params), []
            for _ in range(c["steps"]):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            out.append((losses, td.flat_np(jax.tree.map(np.asarray,
                                                        step.logical_params(state)))))
        return out
    finally:
        JAutoDist.reset_default()


# ------------------------------------------------------------------ ranks
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    np_inputs = inputs()
    torch_inputs = {k: (params_from_jax(p, device="cpu"), td.to_torch(b))
                    for k, (p, b) in np_inputs.items()}
    results = td.run_ranks(tmp_path_factory.mktemp("ranks"), torch_inputs, CASES, world=WORLD)
    return results, np_inputs


def _ranks_agree(results, cid):
    got = results[0][cid]
    for rank, res in enumerate(results[1:], 1):
        for name, value in got["params"].items():
            np.testing.assert_array_equal(res[cid]["params"][name], value,
                                          err_msg=f"rank {rank} {name}")
    return got


def _check_wire(c, got):
    """The data-axis wire as the plan predicts, and ``DTensor``'s own
    collectives under the name of each wide shard axis that splits a
    variable."""
    axes = {ax for ax in ("model", "expert") if c["mesh"].get(ax, 1) > 1}
    split = {kind for kind, _ in got["renderings"].values()}
    if "expert" not in split:
        axes.discard("expert")
    for counts in got["collectives"]:
        assert td.wire_counts(counts) == got["predicted"], (counts, got["predicted"])
        for ax in axes:
            assert sum(counts.get(ax, {}).values()) > 0, (ax, counts)


@pytest.mark.parametrize("c", EXACT, ids=lambda c: c["id"])
def test_three_axis_step_matches_jax(c, runs):
    results, np_inputs = runs
    got = _ranks_agree(results, c["id"])
    params, batch = np_inputs[c["model"]]
    [(jlosses, jparams)] = jax_runs(c, params, [batch])
    td.assert_params_close(got["params"], jparams, what="vs JAX 8-device")
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    assert got["losses"][-1] < got["losses"][0]
    _check_wire(c, got)
    kinds = {n: kind for n, (kind, _) in got["renderings"].items()}
    if "expert" in c["mesh"]:
        assert kinds["layers_0/moe/expert_wi"] == "expert"
    if "model" in c["mesh"]:
        assert kinds["layers_0/attn/wq/kernel"] == "partitioned"


def test_resnet_on_two_dim_shard_mesh_within_jax_spread(runs):
    """ResNet-18 at data 2 x model 2 x expert 2 against JAX's 8-device step
    within twice its own spread (each data rank's rows reversed, or rolled
    by one) or 1e-4, as ``tests/test_torch_tp_models.py::check_cnn``."""
    results, np_inputs = runs
    c = RESNET
    got = _ranks_agree(results, c["id"])
    params, batch = np_inputs["resnet"]
    (jlosses, jparams), *others = jax_runs(c, params, [batch, *_reordered_in_blocks(batch)])
    start = td.flat_np(params)
    err = _rel_update(got["params"], jparams, start)
    spread = max(_rel_update(p, jparams, start) for _, p in others)
    assert err <= max(UPDATE_RTOL, SPREAD_FACTOR * spread), (err, spread)
    for i, want in enumerate(jlosses):
        moved = max(abs(sl[i] - want) for sl, _ in others)
        assert abs(got["losses"][i] - want) <= max(LOSS_RTOL * abs(want),
                                                   SPREAD_FACTOR * moved), (i, got["losses"])
    assert got["losses"][-1] < got["losses"][0]
    _check_wire(c, got)
    kinds = {kind for kind, _ in got["renderings"].values()}
    assert "partitioned" in kinds and "expert" not in kinds
