"""Port parity of tensor and expert parallelism's step (4 gloo ranks, one
process each, on the CPU; the harness of ``helpers/torch_dist.py``).

Each case trains through ``AutoDist.build`` with a ``mesh:`` block and is
held against JAX's step on a 4-device mesh of the same shape, from the same
numpy parameters (``params_from_jax``), in fp32, three SGD steps: losses
within rtol 1e-5 and parameters within rtol 2e-5 / atol 2e-6 (the bars of
``tests/test_torch_dist_models.py``), every rank's parameters bitwise
equal, and each step's data-axis wire equal to the plan's prediction, with
``DTensor``'s own collectives counted under the ``model`` / ``expert``
purpose:

- the small transformer (2 layers, d 32, 4 heads, d_ff 64, seq 16), data 2
  x model 2 under ``TensorParallel``, with ``dot`` and ``flash`` attention
  (``flash`` through ``local_map`` on each rank's 2 heads; at seq 16 both
  packages take the reference inside it);
- a small ``bert_base`` (MLM), data 2 x model 2 under ``TensorParallel``;
- the transformer with ``clip_norm`` 0.5 (the global norm over the split
  leaves' blocks);
- a small MoE (4 experts), data 2 x expert 2 under ``AllReduce`` with the
  expert names (the experts' ``[E, ...]`` kernels split over ``expert``);
- a compressor (Horovod-EF) on the split variables' blocks: its
  residuals block-shaped, its wire as the plan predicts;
- checkpoints: the TensorParallel transformer's trained state restored
  into an AllReduce step and the AllReduce one's into a TensorParallel
  step, each leaf bitwise (a model-split leaf is each rank's
  ``ShardedLeaf`` block); its metadata equals JAX's TensorParallel
  checkpoint's, which restores into the ranks, and theirs into JAX's
  step, bitwise.

The flash kernels' plain versions run on 128-token heads through the
``local_map`` path in ``test_flash_local_map_on_heads`` (one gloo rank in
this process).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu import model_item as jmi
from autodist_tpu import strategy as jstrat
from autodist_tpu.kernel import DistributedTrainStep as JStep
from autodist_tpu.kernel import GraphTransformer as JGraphTransformer
from autodist_tpu.kernel import build_mesh as jbuild_mesh
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.checkpoint import Saver as JSaver
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.models.convert import params_from_jax
from helpers import torch_dist as td

SMALL = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4, d_ff=64,
             max_seq_len=16)
MOE = dict(SMALL, num_experts=4)
TP_MESH, EXPERT_MESH = {"data": 2, "model": 2}, {"data": 2, "expert": 2}
LR, STEPS, BATCH = 0.05, 3, 8


def _case(cid, model, zoo, builder, mesh, axes, overrides, builder_kwargs=None, **extra):
    return dict(id=cid, model=model, zoo=zoo, builder=builder,
                builder_kwargs=builder_kwargs or {},
                opt="sgd", opt_kwargs={"learning_rate": LR}, clip_norm=None, steps=STEPS,
                mesh=mesh, mesh_axes=axes, overrides=dict(overrides, dtype="float32"),
                **extra)


TP_CASES = [
    _case("transformer/dot", "transformer", "transformer", "TensorParallel", TP_MESH,
          ("data", "model"), dict(SMALL, attention_impl="dot")),
    _case("transformer/flash", "transformer", "transformer", "TensorParallel", TP_MESH,
          ("data", "model"), dict(SMALL, attention_impl="flash")),
    _case("bert/dot", "bert", "bert_base", "TensorParallel", TP_MESH, ("data", "model"),
          dict(SMALL, attention_impl="dot")),
    # The global gradient norm sums each split leaf's blocks over the model axis.
    dict(_case("transformer/clip", "transformer", "transformer", "TensorParallel", TP_MESH,
               ("data", "model"), dict(SMALL, attention_impl="dot")), clip_norm=0.5),
    _case("moe/expert", "moe", "moe_transformer", "AllReduce", EXPERT_MESH,
          ("data", "expert"), dict(MOE, attention_impl="dot"),
          builder_kwargs={"bucket_bytes": 4096}, expert_names=("expert_",)),
]
# The MoE routes each rank's tokens (capacity from the rank's count), as
# JAX's manual (shard_map) step does, which buckets select on both sides
# above; JAX's GSPMD step routes the global batch. Without buckets the port
# keeps its per-rank routing: held to the bucketed run, and apart from
# JAX's GSPMD step by the gap ROADMAP.md records.
GSPMD_MOE = dict(TP_CASES[4], id="moe/expert-unbucketed", builder_kwargs={})
# A compressor on split variables runs on each rank's block over the data
# axis (JAX: "model/seq/expert-sharded vars compress fine").
EF_CASE = dict(TP_CASES[0], id="transformer/ef",
               builder_kwargs={"compressor": "HorovodCompressorEF"})
# Checkpoints across plans: each writes its trained state, then restores
# the other's into a fresh step of its own plan.
CKPT_CASES = [
    _case("ckpt/tp", "transformer", "transformer", "TensorParallel", TP_MESH,
          ("data", "model"), dict(SMALL, attention_impl="dot")),
    _case("ckpt/ar", "transformer", "transformer", "AllReduce", None, None,
          dict(SMALL, attention_impl="dot")),
]
JAX_MODELS = {"transformer": "transformer", "bert": "bert_base", "moe": "moe_transformer"}


def filled(shapes, seed):
    """The JAX tree of ``shapes`` filled from numpy: unit scales, zero
    biases, He-scaled normals."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return np.ones(leaf.shape, np.float32)
        if "bias" in name:
            return np.zeros(leaf.shape, np.float32)
        std = np.sqrt(2.0 / np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 0.1
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_spec(c):
    over = dict(c["overrides"], dtype=jnp.float32)
    return jax_get_model(JAX_MODELS[c["model"]], **over)


def model_inputs():
    out = {}
    for c in TP_CASES:
        if c["model"] in out:
            continue
        jspec = _jax_spec(c)
        params = filled(jax.eval_shape(jspec.init, jax.random.PRNGKey(0)), 1)
        out[c["model"]] = (params, jax.tree.map(np.asarray, jspec.example_batch(BATCH)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    np_inputs = model_inputs()
    torch_inputs = {k: (params_from_jax(p, device="cpu"), td.to_torch(b))
                    for k, (p, b) in np_inputs.items()}
    tmp = tmp_path_factory.mktemp("ranks")
    tp_dir, ar_dir, jax_dir = (str(tmp / d) for d in ("ckpt_tp", "ckpt_ar", "ckpt_jax"))
    c = CKPT_CASES[0]
    _, _, jstep, jstate = jax_train_mesh(c, *np_inputs[c["model"]], _jax_spec(c).loss_fn,
                                         state_too=True)
    jstep.save(JSaver(jax_dir), jstate)
    cases = TP_CASES + [GSPMD_MOE, EF_CASE, dict(CKPT_CASES[0], save=tp_dir),
                        dict(CKPT_CASES[1], save=ar_dir),
                        dict(CKPT_CASES[0], id="ckpt/tp<-ar", steps=0,
                             restore=[ar_dir, jax_dir]),
                        dict(CKPT_CASES[1], id="ckpt/ar<-tp", steps=0, restore=[tp_dir])]
    results = td.run_ranks(tmp, torch_inputs, cases)
    return results, np_inputs, (tp_dir, ar_dir, jax_dir)


def jax_step(c, params, batch, loss_fn):
    """JAX's step on a 4-device mesh of the case's shape."""
    rs = JResourceSpec(resource_dict={
        "nodes": [{"address": "localhost", "chips": 4, "chief": True}], "mesh": c["mesh"]})
    opt = jmi.OptimizerSpec(c["opt"], dict(c["opt_kwargs"]), clip_norm=c["clip_norm"])
    item = jmi.ModelItem.from_params(params, optimizer_spec=opt, loss_fn=loss_fn,
                                     example_batch=batch,
                                     expert_names=c.get("expert_names", ()))
    strategy = jstrat.StrategyCompiler(item).compile(
        jstrat.from_name(c["builder"], **c["builder_kwargs"]).build(item, rs))
    mesh = jbuild_mesh(rs, axes=c["mesh_axes"], devices=jax.devices()[:4])
    return JStep(JGraphTransformer(strategy, item, mesh).transform(), loss_fn, opt.make())


def jax_train_mesh(c, params, batch, loss_fn, state_too=False):
    """(losses, logical params[, step, state]) of JAX's step after the
    case's steps."""
    step = jax_step(c, params, batch, loss_fn)
    state, losses = step.init(params), []
    for _ in range(c["steps"]):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    out = losses, jax.tree.map(np.asarray, step.logical_params(state))
    return out + (step, state) if state_too else out


@pytest.mark.parametrize("c", TP_CASES, ids=lambda c: c["id"])
def test_sharded_step_matches_jax(c, runs):
    results, np_inputs, _ = runs
    got = results[0][c["id"]]
    for rank, res in enumerate(results[1:], 1):
        for name, value in got["params"].items():
            np.testing.assert_array_equal(res[c["id"]]["params"][name], value,
                                          err_msg=f"rank {rank} {name}")
    params, batch = np_inputs[c["model"]]
    jlosses, jparams = jax_train_mesh(c, params, batch, _jax_spec(c).loss_fn)
    td.assert_params_close(got["params"], td.flat_np(jparams), what="vs JAX 4-device")
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    axis = "expert" if "expert" in c["mesh"] else "model"
    split = [n for n, (kind, _) in got["renderings"].items() if kind in
             ("partitioned", "expert")]
    assert split, got["renderings"]
    for counts in got["collectives"]:
        assert td.wire_counts(counts) == got["predicted"], (counts, got["predicted"])
        assert counts["metric"] == {"all_reduce": 1}
        # DTensor's own collectives over the model / expert axis.
        assert sum(counts.get(axis, {}).values()) > 0, counts


def test_unbucketed_moe_routes_per_rank(runs):
    results, np_inputs, _ = runs
    got = results[0][GSPMD_MOE["id"]]
    td.assert_params_close(got["params"], results[0]["moe/expert"]["params"],
                           what="unbucketed vs bucketed")
    np.testing.assert_allclose(got["losses"], results[0]["moe/expert"]["losses"], rtol=1e-5)
    for counts in got["collectives"]:
        assert td.wire_counts(counts) == got["predicted"], (counts, got["predicted"])
    jlosses, _ = jax_train_mesh(GSPMD_MOE, *np_inputs["moe"],
                                _jax_spec(GSPMD_MOE).loss_fn)
    # Capacity int(1.25 T / E) from 60 tokens a rank, not the batch's 120.
    assert abs(got["losses"][0] - jlosses[0]) > 1e-4 * abs(jlosses[0])


def test_compressor_on_split_blocks(runs):
    results = runs[0]
    got, plain = results[0][EF_CASE["id"]], results[0]["transformer/dot"]
    assert got["losses"][0] == plain["losses"][0]
    np.testing.assert_allclose(got["losses"], plain["losses"], rtol=1e-3)
    for counts in got["collectives"]:
        assert td.wire_counts(counts) == got["predicted"], (counts, got["predicted"])
    residual = got["comp_state"]["layers_0/attn/wq/kernel"]["local"]["residual"]
    assert residual.shape == (32, 16)                  # this rank's column block
    assert got["comp_state"]["layers_0/ln1/scale"]["local"]["residual"].shape == (32,)


def test_expert_kernels_split_and_tp_pairs(runs):
    results = runs[0]
    moe = results[0]["moe/expert"]["renderings"]
    assert moe["layers_0/moe/expert_wi"] == ("expert", 0)
    assert moe["layers_0/moe/expert_wo"] == ("expert", 0)
    assert moe["layers_0/attn/wq/kernel"] == ("replicated", None)
    tp = results[0]["transformer/dot"]["renderings"]
    assert tp["layers_0/attn/wq/kernel"] == ("partitioned", 1)
    assert tp["layers_0/attn/wo/kernel"] == ("partitioned", 0)
    assert tp["layers_0/mlp/fc2/kernel"] == ("partitioned", 0)
    assert tp["embed/embedding"] == ("partitioned", 0)
    # dot and flash (through local_map) train the same parameters.
    flash = results[0]["transformer/flash"]
    td.assert_params_close(flash["params"], results[0]["transformer/dot"]["params"],
                           what="flash vs dot")


def test_checkpoints_cross_plans_bitwise(runs):
    results, _, (_, ar_dir, _) = runs
    for writer, reader in (("ckpt/ar", "ckpt/tp<-ar"), ("ckpt/tp", "ckpt/ar<-tp")):
        trained = results[0][writer]["params"]
        for rank, res in enumerate(results):
            restored = res[reader]["checkpoint"]["restored"]
            restored = restored[ar_dir] if reader == "ckpt/tp<-ar" else \
                next(iter(restored.values()))
            assert restored["step"] == STEPS and restored["count"] == STEPS
            for name, value in trained.items():
                np.testing.assert_array_equal(restored["params"][name], value,
                                              err_msg=f"{reader} rank {rank} {name}")
    # Each rank's TensorParallel state holds its own block of a split leaf.
    blocks = [res["ckpt/tp<-ar"]["checkpoint"]["restored"][ar_dir]["blocks"][
        "params/layers_0/attn/wq/kernel"] for res in results]
    assert [b[:2] for b in blocks] == [((0, 0), (32, 16)), ((0, 16), (32, 32))] * 2
    # The two plans' trained states agree within the e2e bars.
    td.assert_params_close(results[0]["ckpt/tp"]["params"], results[0]["ckpt/ar"]["params"],
                           what="TensorParallel vs AllReduce")


def test_checkpoints_cross_packages(runs):
    """The TensorParallel checkpoint's metadata equals JAX's for its 4-device
    TensorParallel plan; JAX's restores into the ranks and the ranks' into
    JAX's step, bitwise."""
    results, np_inputs, (tp_dir, _, jax_dir) = runs
    c = CKPT_CASES[0]
    path = results[0]["ckpt/tp"]["checkpoint"]["path"]
    assert Saver.read_metadata(path) == JSaver.read_metadata(f"{jax_dir}/ckpt-{STEPS}")
    params, batch = np_inputs[c["model"]]
    _, jparams = jax_train_mesh(c, params, batch, _jax_spec(c).loss_fn)
    for rank, res in enumerate(results):
        restored = res["ckpt/tp<-ar"]["checkpoint"]["restored"][jax_dir]
        for name, value in td.flat_np(jparams).items():
            np.testing.assert_array_equal(restored["params"][name], value,
                                          err_msg=f"rank {rank} {name}")
    jstep = jax_step(c, params, batch, _jax_spec(c).loss_fn)
    jstate = jstep.init_or_restore(params, JSaver(tp_dir))
    got = td.flat_np(jax.tree.map(np.asarray, jstep.logical_params(jstate)))
    for name, value in results[0]["ckpt/tp"]["params"].items():
        np.testing.assert_array_equal(got[name], value, err_msg=name)


def test_flash_local_map_on_heads(tmp_path):
    """One gloo rank in this process: ``flash_attention`` on ``DTensor``s
    (``Shard(2)``) runs ``FlashAttentionFn``'s plain versions at 128 tokens,
    and its output and gradients equal the plain call's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard

    from autodist_tpu_torch.ops import flash_attention as fa

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0,
                            world_size=1)
    try:
        mesh = DeviceMesh("cpu", [0], mesh_dim_names=("model",))
        gen = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(2, 128, 4, 8, generator=gen, requires_grad=True)
                   for _ in range(3))
        want = fa.flash_attention(q, k, v, causal=True)
        gwant = torch.autograd.grad(want.square().sum(), (q, k, v))
        dq, dk, dv = (DTensor.from_local(t, mesh, [Shard(2)]) for t in (q, k, v))
        got = fa.flash_attention(dq, dk, dv, causal=True)
        assert isinstance(got, DTensor) and got.placements == (Shard(2),)
        ggot = torch.autograd.grad(got.to_local().square().sum(), (q, k, v))
        torch.testing.assert_close(got.to_local(), want, rtol=0, atol=0)
        for a, b in zip(ggot, gwant):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    finally:
        dist.destroy_process_group()
