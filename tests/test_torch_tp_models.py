"""Port parity of the zoo outside the transformer family under a model or
expert axis, and of the two-axis optimizer rules (4 gloo ranks, one
process each, on the CPU; the harness of ``helpers/torch_dist.py``).

Each case trains through ``AutoDist.build`` with a ``mesh:`` block and is
held against JAX's step on a 4-device mesh of the same shape, from the same
numpy parameters (``params_from_jax``), in fp32, three SGD steps, every
rank's parameters bitwise equal:

- ResNet-18 (width 8, 32 px, batch 8) under ``TensorParallel`` at data 2 x
  model 2: its convs split on ``cout`` (column) and ``cin`` (row), the 1x1
  projections of both kinds through the fused conv-stats op's plain
  version under ``local_map``; the same ResNet under ``PartitionedAR``
  (the BatchNorm scales and biases split too), and under ``AllReduce`` at
  data 2 x expert 2 (nothing to split: replicated over the expert ranks);
- VGG-11 (32 px) under ``TensorParallel`` (DenseNet and Inception-v3, and
  the CNNs under ``PartitionedAR``, are in
  ``tests/test_torch_tp_cnn_zoo.py``);
- lstm_lm and ncf under ``TensorParallel`` (the vocab-split tables through
  ``_rows_held``, lstm's column-split gate kernel and row-split ``proj``);
- the small transformer under ``Zero1`` at data 2 x model 2 (variables
  split on the data axis beside others split on the model axis) with
  ``clip_norm`` 0.5, with lamb and with adafactor;
- Horovod-EF on the model-split variables: the trained state, compressor
  residuals included, saved and restored into another plan and into JAX's
  step, and JAX's into the ranks, bitwise;
- PowerSGD and TopK on the model-split variables of the transformer under
  ``TensorParallel``, two steps from JAX's initial compressor state
  (PowerSGD's ``q``): both compress the logical gradient, as JAX does, so
  their state is the whole variable's; the trained state (residuals, ``q``)
  crosses between the packages' checkpoints bitwise. TopK runs on a
  transformer of width 64, whose attention and MLP kernels (64 x 64) are at
  TopK's ``min_size`` of 4096 elements while a rank's block is below it:
  the rule reads the logical size.

Tolerances. The transformer, lstm_lm and ncf: losses within rtol 1e-5,
parameters within rtol 2e-5 / atol 2e-6 (``tests/test_torch_tp_e2e.py``'s
bars). Under lamb and adafactor the attention's key biases are left out
of that comparison: their gradient is zero but for rounding (a softmax
does not see a constant added to a row of logits), and both optimizers
scale it to a step of the learning rate's size in either package
(``tests/test_torch_checkpoint.py`` keeps them out for that reason); they
are held to 3 x lr x steps. The CNNs' fp32 gradients at initialisation
move with summation order (BatchNorm over 4 images a data rank, ReLUs near
0), so each is held as ``tests/test_torch_zoo_cnn.py::_within_spread``
holds them: the whole update (relative L2 of params after minus before)
within twice JAX's own spread (the largest change of JAX's step run again
with each data rank's rows reversed, or rolled by one) or 1e-4 where that
is larger (the zoo's bar on a gradient), each loss within twice the
reorderings' change or rtol 1e-5. Their SGD rate is 3e-3 (1e-4 for VGG,
which has no BatchNorm): at 1e-2 these narrow nets take steps so large
that JAX's own 3-step runs part under a reordering.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu.checkpoint import Saver as JSaver
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.models import layers as JL
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.models.convert import params_from_jax
from helpers import torch_dist as td
from test_torch_dist_resnet import _rel_update
from test_torch_tp_e2e import SMALL, filled, jax_step, jax_train_mesh

JR = importlib.import_module("autodist_tpu.models.resnet")
JV = importlib.import_module("autodist_tpu.models.vgg")
JD = importlib.import_module("autodist_tpu.models.densenet")
JI = importlib.import_module("autodist_tpu.models.inception")
JLSTM = importlib.import_module("autodist_tpu.models.lstm_lm")

TP_MESH, EXPERT_MESH = {"data": 2, "model": 2}, {"data": 2, "expert": 2}
LR, STEPS, BATCH, DATA = 0.01, 3, 8, 2
#: The CNNs' SGD rates: 3e-3 with BatchNorm; VGG, without it, diverges at
#: init above about 1e-4.
CNN_LR = {"resnet": 3e-3, "densenet": 3e-3, "inception": 3e-3, "vgg": 1e-4}
#: The floors of ``tests/test_torch_zoo_cnn.py::_within_spread``: the loss
#: and the whole update (relative L2; one SGD step's update is the
#: gradient's, held there to 1e-4).
LOSS_RTOL, UPDATE_RTOL, SPREAD_FACTOR = 1e-5, 1e-4, 2.0
DEPTH, WIDTH, CLASSES, IMAGE = 18, 8, 10, 32
VGG = dict(depth=11, image_size=IMAGE, num_classes=CLASSES)
DENSE = dict(blocks=(2, 2), growth=8, image_size=IMAGE, num_classes=CLASSES)
INCEPTION = dict(width=1 / 16, image_size=IMAGE, num_classes=CLASSES)
LSTM = dict(vocab_size=64, embed_dim=16, hidden=32, num_layers=2, seq_len=8)
NCF = dict(num_users=64, num_items=48, mf_dim=8, mlp_dims=(16, 16, 8))


def case(cid, model, builder, mesh=TP_MESH, axes=("data", "model"), opt="sgd",
          opt_kwargs=None, steps=STEPS, **extra):
    lr = CNN_LR.get(model, LR)
    return dict(id=cid, model=model, zoo=model, builder=builder, builder_kwargs={},
                opt=opt, opt_kwargs=opt_kwargs or {"learning_rate": lr}, clip_norm=None,
                steps=steps, mesh=mesh, mesh_axes=axes, **extra)


CNN_CASES = [
    case("resnet/tp", "resnet", "TensorParallel", depth=DEPTH),
    case("resnet/partitioned_ar", "resnet", "PartitionedAR", depth=DEPTH),
    case("resnet/expert", "resnet", "AllReduce", EXPERT_MESH, ("data", "expert"),
          depth=DEPTH),
    case("vgg/tp", "vgg", "TensorParallel", overrides=VGG, fp32=True),
]
EXACT_CASES = [
    case("lstm_lm/tp", "lstm_lm", "TensorParallel", overrides=LSTM, fp32=True),
    case("ncf/tp", "ncf", "TensorParallel", overrides=NCF),
    dict(case("transformer/zero1-clip", "transformer", "Zero1",
               overrides=dict(SMALL, attention_impl="dot", dtype="float32")),
         clip_norm=0.5),
    case("transformer/zero1-lamb", "transformer", "Zero1", opt="lamb",
          opt_kwargs={"learning_rate": 1e-3, "weight_decay": 0.01},
          overrides=dict(SMALL, attention_impl="dot", dtype="float32")),
    case("transformer/zero1-adafactor", "transformer", "Zero1", opt="adafactor",
          opt_kwargs={"learning_rate": 1e-2, "min_dim_size_to_factor": 8},
          overrides=dict(SMALL, attention_impl="dot", dtype="float32")),
]

# Horovod-EF on the split variables, its trained state saved from one plan
# and restored into another with the same data axis (JAX stacks one
# residual a data rank) and from and into JAX's TensorParallel step.
EF = dict(overrides=dict(SMALL, attention_impl="dot", dtype="float32"),
          builder_kwargs={"compressor": "HorovodCompressorEF"})
EF_TP = dict(case("ef/tp", "transformer", "TensorParallel", steps=2), **EF)
# Parallax: the table on a PS as under TensorParallel (so no compressor
# state either), every other variable whole under AllReduce.
EF_AR = dict(case("ef/ar", "transformer", "Parallax", steps=2), **EF)
EF_VAR = "layers_0/attn/wq/kernel"
# PowerSGD and TopK on the split variables: trained (and saved), then a
# fresh step restored from JAX's trained checkpoint.
WHOLE = {"PowerSGDCompressor": ("psgd", "transformer", SMALL),
         "TopKCompressor": ("topk", "transformer64", dict(SMALL, d_model=64))}
WHOLE_CASES = {name: dict(case(f"{tag}/tp", model, "TensorParallel", steps=2),
                          zoo="transformer",
                          overrides=dict(over, attention_impl="dot", dtype="float32"),
                          builder_kwargs={"compressor": name})
               for name, (tag, model, over) in WHOLE.items()}


# ------------------------------------------------------------------- JAX
def _jax_loss(c):
    """JAX's fp32 loss of a case's model."""
    o, f32 = c.get("overrides", {}), jnp.float32
    if c["model"] == "resnet":
        return td.jax_resnet_loss(DEPTH)
    if c["model"] in ("vgg", "densenet", "inception"):
        forward = {"vgg": lambda p, x: JV.forward(p, x, o["depth"], dtype=f32),
                   "densenet": lambda p, x: JD.forward(p, x, 121, dtype=f32,
                                                       blocks=o["blocks"]),
                   "inception": lambda p, x: JI.forward(p, x, dtype=f32)}[c["model"]]
        return lambda p, b: JL.softmax_xent(forward(p, b["images"]), b["labels"])
    if c["model"] == "lstm_lm":
        def loss(p, b):
            t = b["tokens"]
            return JL.softmax_xent(JLSTM.forward(p, t[:, :-1], o["num_layers"], o["hidden"],
                                                 dtype=f32), t[:, 1:])
        return loss
    over = dict(o, dtype=f32) if c["zoo"] == "transformer" else o
    return jax_get_model(c["zoo"], **over).loss_fn


def inputs(cases):
    """``{model: (numpy params, numpy batch)}`` of every case's model."""
    out = {"resnet": (filled(jax.eval_shape(
        lambda k: JR.init_params(k, DEPTH, CLASSES, width=WIDTH), jax.random.PRNGKey(0)), 2),
        jax.tree.map(np.asarray, JR.image_example_batch(IMAGE, CLASSES)(BATCH)))}
    for c in cases:
        if c["model"] in out:
            continue
        over = dict(c["overrides"])
        if c["zoo"] == "transformer":
            over["dtype"] = jnp.float32
        spec = jax_get_model(c["zoo"], **over)
        params = filled(jax.eval_shape(spec.init, jax.random.PRNGKey(0)), 1)
        batch = {k: np.asarray(v) for k, v in spec.example_batch(BATCH).items()}
        if c["model"] == "lstm_lm":
            rng = np.random.default_rng(0)
            batch = {"tokens": rng.integers(0, LSTM["vocab_size"], (BATCH, LSTM["seq_len"] + 1)
                                            ).astype(np.int32)}
        out[c["model"]] = (params, batch)
    return out


def _reordered_in_blocks(batch):
    """Each data rank's rows reversed, and rolled by one: the same
    statistics, summed in other orders."""
    for order in (lambda v: v[:, ::-1], lambda v: np.roll(v, 1, 1)):
        yield {k: order(v.reshape((DATA, -1) + v.shape[1:])).reshape(v.shape)
               for k, v in batch.items()}


def _jax_runs(c, params, batches, loss):
    """``(losses, flat logical params)`` of JAX's 4-device step after the
    case's steps, from ``params``, on each batch (one compiled step)."""
    step, out = jax_step(c, params, batches[0], loss), []
    for batch in batches:
        state, losses = step.init(params), []
        for _ in range(c["steps"]):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        out.append((losses, td.flat_np(jax.tree.map(np.asarray, step.logical_params(state)))))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    np_inputs = inputs(CNN_CASES + EXACT_CASES + list(WHOLE_CASES.values()))
    torch_inputs = {k: (params_from_jax(p, device="cpu"), td.to_torch(b))
                    for k, (p, b) in np_inputs.items()}
    tmp = tmp_path_factory.mktemp("ranks")
    dirs = {d: str(tmp / d) for d in ("tp", "ar", "jax")}
    jstep, jstate = _jax_ef(np_inputs)
    jstep.save(JSaver(dirs["jax"]), jstate)
    ef = [dict(EF_TP, save=dirs["tp"]), dict(EF_AR, save=dirs["ar"]),
          dict(EF_TP, id="ef/tp<-", steps=0, restore=[dirs["tp"], dirs["ar"], dirs["jax"]]),
          dict(EF_AR, id="ef/ar<-", steps=0, restore=[dirs["tp"]])]
    whole = []
    for name, c in WHOLE_CASES.items():
        for d in ("port", "jax"):
            dirs[f"{name}/{d}"] = str(tmp / f"{c['id'].split('/')[0]}_{d}")
        jstep, state0, jstate = _jax_whole(c, np_inputs)
        jstep.save(JSaver(dirs[f"{name}/jax"]), jstate)
        comp0 = jax.tree.map(np.asarray, state0.comp_state)
        whole += [dict(c, comp_state=comp0, save=dirs[f"{name}/port"]),
                  dict(c, id=f"{c['id']}<-jax", steps=0, comp_state=comp0,
                       restore=[dirs[f"{name}/jax"]])]
    results = td.run_ranks(tmp, torch_inputs, CNN_CASES + EXACT_CASES + ef + whole)
    return results, np_inputs, dirs


def _jax_whole(c, np_inputs):
    """JAX's TensorParallel step under a whole-gradient compressor, its
    initial state and its state after the case's steps."""
    params, batch = np_inputs[c["model"]]
    step = jax_step(c, params, batch, _jax_loss(c))
    state0 = step.init(params)
    state, losses = step.init(params), []
    for _ in range(c["steps"]):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    step.losses = losses
    return step, state0, state


def _jax_ef(np_inputs):
    """JAX's TensorParallel step under Horovod-EF and its state after the
    case's steps."""
    params, batch = np_inputs["transformer"]
    step = jax_step(EF_TP, params, batch, _jax_loss(EF_TP))
    state = step.init(params)
    for _ in range(EF_TP["steps"]):
        state, _ = step(state, batch)
    return step, state


def _ranks_agree(results, cid):
    got = results[0][cid]
    for rank, res in enumerate(results[1:], 1):
        for name, value in got["params"].items():
            np.testing.assert_array_equal(res[cid]["params"][name], value,
                                          err_msg=f"rank {rank} {name}")
    return got


def check_cnn(c, results, np_inputs):
    """A CNN case's ranks against each other (bitwise) and against JAX's
    4-device step within twice its own spread (the module docstring)."""
    got = _ranks_agree(results, c["id"])
    params, batch = np_inputs[c["model"]]
    (jlosses, jparams), *others = _jax_runs(c, params, [batch, *_reordered_in_blocks(batch)],
                                            _jax_loss(c))
    start = td.flat_np(params)
    err = _rel_update(got["params"], jparams, start)
    spread = max(_rel_update(p, jparams, start) for _, p in others)
    assert err <= max(UPDATE_RTOL, SPREAD_FACTOR * spread), (err, spread)
    for i, want in enumerate(jlosses):
        moved = max(abs(sl[i] - want) for sl, _ in others)
        assert abs(got["losses"][i] - want) <= max(LOSS_RTOL * abs(want),
                                                   SPREAD_FACTOR * moved), (i, got["losses"])
    assert got["losses"][-1] < got["losses"][0] or c["steps"] == 1
    for counts in got["collectives"]:
        assert td.wire_counts(counts) == got["predicted"], (counts, got["predicted"])


@pytest.mark.parametrize("c", CNN_CASES, ids=lambda c: c["id"])
def test_cnn_matches_jax_within_its_spread(c, runs):
    check_cnn(c, *runs[:2])


@pytest.mark.parametrize("c", EXACT_CASES, ids=lambda c: c["id"])
def test_step_matches_jax(c, runs):
    results, np_inputs, _ = runs
    got = _ranks_agree(results, c["id"])
    params, batch = np_inputs[c["model"]]
    jlosses, jparams = jax_train_mesh(c, params, batch, _jax_loss(c))
    jparams, mine = td.flat_np(jparams), dict(got["params"])
    if c["opt"] in ("lamb", "adafactor"):
        lr = c["opt_kwargs"]["learning_rate"]
        for name in [n for n in jparams if n.endswith("attn/wk/bias")]:
            for side in (jparams.pop(name), mine.pop(name)):
                assert np.max(np.abs(side)) <= 3 * lr * c["steps"], name
    td.assert_params_close(mine, jparams, what="vs JAX 4-device")
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    for counts in got["collectives"]:
        assert td.wire_counts(counts) == got["predicted"], (counts, got["predicted"])


def _coords(rank):
    from autodist_tpu_torch.kernel import Mesh

    return Mesh(axis_names=("data", "model"), shape=TP_MESH, rank=rank).coords


def test_model_split_compressor_state_checkpoints(runs):
    """The residual of a model-split variable is written as JAX's ``[n,
    *var.shape]`` stack, each rank its model block of its data row; it
    restores into a plan that keeps the variable whole (its rows) and
    back, and into JAX's step and from it, bitwise."""
    results, np_inputs, dirs = runs
    name = f"comp_state/{EF_VAR}/local/residual"
    # The TensorParallel ranks' trained blocks, placed by their coords.
    trained = np.zeros((2, 32, 32), np.float32)
    for rank, res in enumerate(results):
        block = res["ef/tp"]["comp_state"][EF_VAR]["local"]["residual"]
        assert block.shape == (32, 16)
        co = _coords(rank)
        trained[co["data"], :, co["model"] * 16:(co["model"] + 1) * 16] = block
    meta = Saver.read_metadata(results[0]["ef/tp"]["checkpoint"]["path"])["entries"][name]
    jmeta = JSaver.read_metadata(f"{dirs['jax']}/ckpt-{EF_TP['steps']}")["entries"][name]
    assert (meta["shape"], meta["dtype"]) == (jmeta["shape"], jmeta["dtype"]) == \
        ([2, 32, 32], "float32")
    assert len(meta["shards"]) == 4
    for rank, res in enumerate(results):
        co = _coords(rank)
        # The whole plan's ranks read their data row.
        start, stop, got = res["ef/ar<-"]["checkpoint"]["restored"][dirs["tp"]]["blocks"][name]
        assert (start, stop) == ((co["data"], 0, 0), (co["data"] + 1, 32, 32))
        np.testing.assert_array_equal(got, trained[co["data"]:co["data"] + 1])
        tp_reads = res["ef/tp<-"]["checkpoint"]["restored"]
        _, _, got = tp_reads[dirs["tp"]]["blocks"][name]
        np.testing.assert_array_equal(got[0], res["ef/tp"]["comp_state"][EF_VAR]["local"][
            "residual"])
        # The whole plan's rows, split again into this rank's block.
        ar_row = results[2 * co["data"]]["ef/ar"]["comp_state"][EF_VAR]["local"]["residual"]
        _, _, got = tp_reads[dirs["ar"]]["blocks"][name]
        np.testing.assert_array_equal(got[0], ar_row[:, co["model"] * 16:
                                                     (co["model"] + 1) * 16])
    # JAX's checkpoint into the ranks and theirs into JAX's step, bitwise.
    jstep, jstate = _jax_ef(np_inputs)
    want = np.asarray(jstate.comp_state[EF_VAR]["local"]["residual"])
    for rank, res in enumerate(results):
        co = _coords(rank)
        _, _, got = res["ef/tp<-"]["checkpoint"]["restored"][dirs["jax"]]["blocks"][name]
        np.testing.assert_array_equal(
            got, want[co["data"]:co["data"] + 1, :, co["model"] * 16:(co["model"] + 1) * 16])
    params = np_inputs["transformer"][0]
    back = jstep.init_or_restore(params, JSaver(dirs["tp"]))
    np.testing.assert_array_equal(np.asarray(back.comp_state[EF_VAR]["local"]["residual"]),
                                  trained)
    for pname, value in results[0]["ef/tp"]["params"].items():
        np.testing.assert_array_equal(
            td.flat_np(jax.tree.map(np.asarray, jstep.logical_params(back)))[pname], value,
            err_msg=pname)
    # The two plans trained the same steps: their residuals agree.
    np.testing.assert_allclose(trained, np.stack(
        [results[2 * d]["ef/ar"]["comp_state"][EF_VAR]["local"]["residual"]
         for d in range(2)]), rtol=1e-4, atol=1e-6)


def test_row_split_statistics_are_the_reduced_products(tmp_path):
    """A 1x1 conv split on ``cin`` (one process): each of 2 ranks launches
    the fused op on what ``conv_batchnorm``'s row route hands it (the
    gathered rows and kernel, its block of output columns), so the sums it
    gives BatchNorm are the column sums of the reduced product, not those
    of a rank's partial product (its ``cin`` block). On a one-rank mesh the
    route runs through ``local_map`` and equals the plain op bitwise."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from autodist_tpu_torch.models import layers as L

    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 4, 4, 16, generator=gen)
    k = torch.randn(1, 1, 16, 24, generator=gen)
    y = x.reshape(-1, 16) @ k.reshape(16, 24)
    blocks = [L.fused_block(2, 24, r, 2) for r in range(2)]
    assert [route for route, _ in blocks] == ["row", "row"]
    got = [L._fused_product(x, k, 1, cols) for _, cols in blocks]
    s1, s2 = (torch.cat([g[i] for g in got]) for i in (1, 2))
    torch.testing.assert_close(s1, y.sum(0), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s2, (y * y).sum(0), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(torch.cat([g[0] for g in got], -1).reshape(-1, 24), y)
    partial = x[..., :8].reshape(-1, 8) @ k.reshape(16, 24)[:8]
    assert (partial.sum(0) - y.sum(0)).abs().max() > 1.0
    assert (partial.square().sum(0) - s2).abs().max() > 1.0

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0,
                            world_size=1)
    try:
        mesh = DeviceMesh("cpu", [0], mesh_dim_names=("model",))
        scale, bias = torch.rand(24, generator=gen) + 0.5, torch.randn(24, generator=gen)
        want = L.conv_batchnorm({"kernel": k}, {"scale": scale, "bias": bias}, x)
        bn = {"scale": DTensor.from_local(scale, mesh, [Replicate()]),
              "bias": DTensor.from_local(bias, mesh, [Replicate()])}
        out = L.conv_batchnorm({"kernel": DTensor.from_local(k, mesh, [Shard(2)])}, bn,
                               DTensor.from_local(x, mesh, [Shard(3)]))
        assert out.placements == (Shard(3),)
        torch.testing.assert_close(out.to_local(), want, rtol=0, atol=0)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", sorted(WHOLE_CASES))
def test_whole_gradient_compressor_on_split_variables_matches_jax(name, runs):
    """PowerSGD and TopK on the model-split variables against JAX's 4-device
    step (from JAX's initial compressor state): losses, parameters and each
    rank's compressor state (its data row of JAX's ``[n, ...]`` stack, the
    whole variable's shape; PowerSGD's ``q`` shared) at the e2e bars."""
    results, np_inputs, _ = runs
    c = WHOLE_CASES[name]
    got = _ranks_agree(results, c["id"])
    jstep, _, jstate = _jax_whole(c, np_inputs)
    td.assert_params_close(got["params"], td.flat_np(jax.tree.map(
        np.asarray, jstep.logical_params(jstate))), what="vs JAX 4-device")
    np.testing.assert_allclose(got["losses"], jstep.losses, rtol=1e-5)
    for counts in got["collectives"]:
        assert td.wire_counts(counts) == got["predicted"], (counts, got["predicted"])
        assert sum(counts.get("model", {}).values()) > 0, counts
    params = np_inputs[c["model"]][0]
    shapes = td.flat_np(params)
    split = [n for n, (kind, _) in got["renderings"].items() if kind == "partitioned"
             and n in got["comp_state"]]
    assert split
    for rank, res in enumerate(results):
        data = _coords(rank)["data"]
        for var, st in res[c["id"]]["comp_state"].items():
            want = jstate.comp_state[var]
            for k, v in st["local"].items():
                assert v.shape == shapes[var].shape, (var, k)
                np.testing.assert_allclose(v, np.asarray(want["local"][k])[data],
                                           rtol=2e-5, atol=2e-6, err_msg=f"{var} {k}")
            for k, v in st["shared"].items():
                np.testing.assert_allclose(v, np.asarray(want["shared"][k]), rtol=2e-5,
                                           atol=2e-6, err_msg=f"{var} {k}")
    if name == "TopKCompressor":
        # 4096 elements, 2048 a rank: compressed whole.
        assert got["comp_state"][EF_VAR]["local"]["residual"].shape == (64, 64)


@pytest.mark.parametrize("name", sorted(WHOLE_CASES))
def test_whole_gradient_compressor_state_crosses_packages(name, runs):
    """The trained compressor state in JAX's layout: ``local`` ``[n,
    *var.shape]`` (each row written once, by the first model rank of its
    data rank), ``shared`` whole. The ranks' checkpoint restores into JAX's
    step and JAX's into the ranks, bitwise."""
    results, np_inputs, dirs = runs
    c = WHOLE_CASES[name]
    path = results[0][c["id"]]["checkpoint"]["path"]
    jpath = f"{dirs[name + '/jax']}/ckpt-{c['steps']}"
    entries = Saver.read_metadata(path)["entries"]
    jentries = JSaver.read_metadata(jpath)["entries"]
    comp = sorted(k for k in jentries if k.startswith("comp_state/"))
    assert comp and sorted(k for k in entries if k.startswith("comp_state/")) == comp
    for k in comp:
        assert (entries[k]["shape"], entries[k]["dtype"]) == \
            (jentries[k]["shape"], jentries[k]["dtype"]), k
    jstep, _, jstate = _jax_whole(c, np_inputs)
    params = np_inputs[c["model"]][0]
    back = jstep.init_or_restore(params, JSaver(dirs[name + "/port"]))
    for var, st in back.comp_state.items():
        for k, v in st["local"].items():
            rows = [results[2 * d][c["id"]]["comp_state"][var]["local"][k] for d in range(2)]
            np.testing.assert_array_equal(np.asarray(v), np.stack(rows), err_msg=var)
        for k, v in st["shared"].items():
            np.testing.assert_array_equal(
                np.asarray(v), results[0][c["id"]]["comp_state"][var]["shared"][k])
    for rank, res in enumerate(results):
        data = _coords(rank)["data"]
        blocks = res[f"{c['id']}<-jax"]["checkpoint"]["restored"][dirs[name + "/jax"]][
            "blocks"]
        for var, st in jstate.comp_state.items():
            for k, v in st["local"].items():
                start, stop, got = blocks[f"comp_state/{var}/local/{k}"]
                assert start[0] == data and stop[0] == data + 1
                np.testing.assert_array_equal(got, np.asarray(v)[data:data + 1])
            for k, v in st["shared"].items():
                _, _, got = blocks[f"comp_state/{var}/shared/{k}"]
                np.testing.assert_array_equal(got, np.asarray(v))
