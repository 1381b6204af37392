"""The sparse touched-rows wire of the port against the JAX package's.

The JAX package row-shards a sparse table over the data axis and GSPMD
moves only the touched rows (``tests/test_sparse_wire.py``: no collective
payload reaches a quarter of the table). The port renders the same wire by
hand (``kernel/sparse.py``) in the GSPMD semantics, and keeps the
whole-table wire in the manual one (buckets, a compressor, ZeRO-1), as
JAX's manual step does.

- ``promised_wire()`` equals JAX's var for var (every ``VarWire`` field)
  for the zoo at small widths under eight builders, at 4 and 8 devices and
  on a {data 2, model 4} mesh; a compressor or buckets turn the step's
  rendering of a sparse table to ``sharded``, as does a split by columns.
- One spawn of 4 gloo ranks (``helpers/torch_dist_worker.py``): JAX's test
  shape (a 4096 x 16 table, batch 64) under AllReduce, PSLoadBalancing and
  Parallax, LM1B (fp32) and NCF at small widths, the MoE (fp32) whose tied
  output projection uses the table whole, and the manual semantics
  (buckets). Each: the ranks bitwise alike; parameters and losses against
  JAX's 4-device step and the port's one-process step (the dist tests'
  rtol 2e-5 / atol 2e-6, losses 1e-5); the bytes of every step's
  collectives by purpose and kind equal to ``step.predicted_bytes``; in the
  GSPMD cases no row-read payload at or above a quarter of the table (the
  embed cases: no payload of any step collective), in the manual one the
  table's gradient reduce-scattered whole. An id outside the table raises
  on every rank, as the plain read does. ``AutoDist.tune`` over the group:
  every rank builds the chief's pick and skips a candidate whose builder
  raised on the chief; one rank failing in a candidate's steps stops the
  sweep on every rank.
- JAX's compiled 4-device MoE step: what its tied table moves (the parity
  note of ROADMAP.md Queue 3).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu import strategy as jstrat
from autodist_tpu.kernel import GraphTransformer as JGraphTransformer
from autodist_tpu.kernel import build_mesh as jbuild_mesh
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.models import layers as JL
from autodist_tpu_torch import strategy as tstrat
from autodist_tpu_torch.kernel import GraphTransformer, Mesh
from autodist_tpu_torch.models.convert import params_from_jax
from helpers import torch_auto as ta
from helpers import torch_dist as td
from helpers import torch_dist_worker as worker

JLSTM = __import__("importlib").import_module("autodist_tpu.models.lstm_lm")

WIRE_BUILDERS = [("AllReduce", {}), ("Parallax", {}), ("PSLoadBalancing", {}), ("PS", {}),
                 ("Zero1", {}), ("PartitionedPS", {}), ("PartitionedAR", {}),
                 ("AllReduce", {"bucket_bytes": 4096})]
WIRE_MESHES = [({"data": 4}, 4), ({"data": 8}, 8), ({"data": 2, "model": 4}, 8)]


def _plans(model, builder, kwargs, mesh, n):
    jitem, titem = ta.items(model)
    d = {"nodes": [{"address": "localhost", "chips": n, "chief": True}]}
    if len(mesh) > 1:
        d["mesh"] = mesh
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
    from autodist_tpu_torch.resource_spec import ResourceSpec

    jrs, trs = JResourceSpec(resource_dict=d), ResourceSpec(resource_dict=d)
    jstrategy = jstrat.StrategyCompiler(jitem).compile(
        jstrat.from_name(builder, **kwargs).build(jitem, jrs))
    tstrategy = tstrat.StrategyCompiler(titem).compile(
        tstrat.from_name(builder, **kwargs).build(titem, trs))
    jplan = JGraphTransformer(jstrategy, jitem, jbuild_mesh(
        jrs, axes=("data", "model"), devices=jax.devices()[:n])).transform()
    shape = trs.mesh_shape(("data", "model"))
    tplan = GraphTransformer(tstrategy, titem, Mesh.logical(shape)).transform()
    return jplan, tplan


@pytest.mark.parametrize("mesh,n", WIRE_MESHES, ids=["data4", "data8", "data2xmodel4"])
@pytest.mark.parametrize("model", ("bert_base", "lstm_lm", "ncf", "moe_transformer", "resnet"))
def test_promised_wire_equals_jax(model, mesh, n):
    for builder, kwargs in WIRE_BUILDERS:
        if builder == "PartitionedPS" and len(mesh) == 1 and model == "resnet":
            continue    # a 4-D kernel split over many PS shards: slow, not wire-relevant
        jplan, tplan = _plans(model, builder, kwargs, mesh, n)
        jwire, twire = jplan.promised_wire(), tplan.promised_wire()
        assert sorted(twire) == sorted(jwire)
        for name in jwire:
            assert dataclasses.asdict(twire[name]) == dataclasses.asdict(jwire[name]), \
                (model, builder, kwargs, mesh, name)
        for name, w in twire.items():
            # The step's rendering of a row-split table: sparse in the GSPMD
            # semantics (pure data axis), whole-table under buckets; a table
            # split by columns (PartitionedPS) moves whole too.
            if w.rendering == "sparse" and len(mesh) == 1:
                dim = tplan.var_plans[name].storage_dim
                want = "sharded" if tplan.manual_semantics() or dim else "sparse"
                assert tplan.rendering(name) == (want, dim), (builder, kwargs, name)


def test_compressor_keeps_the_whole_table():
    _, tplan = _plans("ncf", "AllReduce", {"compressor": "bf16"}, {"data": 4}, 4)
    assert tplan.manual_semantics()
    assert tplan.rendering("mf_user/embedding") == ("sharded", 0)
    _, plain = _plans("ncf", "AllReduce", {}, {"data": 4}, 4)
    assert plain.rendering("mf_user/embedding") == ("sparse", 0)
    counts = plain.collectives_per_step()
    assert counts["reduce_scatter"] == counts["all_gather"] == 0


# ------------------------------------------------------------ 4 gloo ranks
VOCAB, EDIM, BATCH = 4096, 16, 64
LSTM = dict(vocab_size=4096, embed_dim=16, hidden=32, num_layers=2, seq_len=8)
NCF = dict(num_users=4096, num_items=2048, mf_dim=8, mlp_dims=(16, 16, 8))
MOE = dict(vocab_size=512, num_layers=2, d_model=32, num_heads=4, d_ff=64, max_seq_len=16,
           num_experts=4, capacity_factor=8.0, aux_loss_weight=0.0)
TABLES = {"embed_wide": ["embedding"], "lm1b": ["embed/embedding"],
          "ncf": ["mf_user/embedding", "mf_item/embedding", "mlp_user/embedding",
                  "mlp_item/embedding"], "moe": ["embed/embedding"]}


def _zoo(cid, model, builder, kwargs, opt, zoo, overrides, **extra):
    return dict(td.case(cid, model, builder, kwargs, opt), zoo=zoo, overrides=overrides,
                **extra)


CASES = ([td.case(f"embed_wide/{b}", "embed_wide", b, {}, "adam")
          for b in ("AllReduce", "PSLoadBalancing", "Parallax")]
         + [td.case("embed_wide/AllReduce-buckets", "embed_wide", "AllReduce",
                    {"bucket_bytes": 64}, "adam"),
            _zoo("lm1b/Parallax", "lm1b", "Parallax", {}, "adam", "lstm_lm", LSTM, fp32=True),
            _zoo("lm1b/AllReduce", "lm1b", "AllReduce", {}, "sgd", "lstm_lm", LSTM, fp32=True),
            _zoo("ncf/Parallax", "ncf", "Parallax", {}, "adam", "ncf", NCF),
            _zoo("moe/AllReduce", "moe", "AllReduce", {}, "sgd", "moe_transformer",
                 dict(MOE, dtype="float32"))])
TUNE = dict(td.case("tune", "embed_wide", "AllReduce", {}, "sgd"),
            tune=["Refuses", "AllReduce", "Parallax", "PSLoadBalancing"])
# Rank 2 fails in the first candidate's steps while its peers wait in them.
TUNE_FAILS = dict(td.case("tune_fails", "embed_wide", "AllReduce", {}, "sgd"),
                  tune=["AllReduce", "Parallax"], fail_rank=2)
BAD_IDS = [dict(td.case(f"bad_id{i}", "embed_wide", "AllReduce", {}, "sgd"), bad_id=i)
           for i in (VOCAB, -VOCAB - 1)]


def _filled(shapes, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32),
                        shapes)


def _jax_models():
    """{model: (JAX loss, numpy params, numpy batch)} of the cases."""
    rng = np.random.default_rng(0)
    embed = ({"embedding": rng.standard_normal((VOCAB, EDIM)).astype(np.float32),
              "w": rng.standard_normal((EDIM, 1)).astype(np.float32)},
             (rng.integers(0, VOCAB, BATCH).astype(np.int64),
              rng.standard_normal(BATCH).astype(np.float32)))
    jl = jax_get_model("lstm_lm", **LSTM)

    def lstm_loss(params, batch):
        t = batch["tokens"]
        return JL.softmax_xent(JLSTM.forward(params, t[:, :-1], LSTM["num_layers"],
                                             LSTM["hidden"], dtype=jnp.float32), t[:, 1:])

    tokens = rng.integers(0, LSTM["vocab_size"], (8, LSTM["seq_len"] + 1)).astype(np.int32)
    jn = jax_get_model("ncf", **NCF)
    jm = jax_get_model("moe_transformer", dtype=jnp.float32, **MOE)
    moe_tokens = rng.integers(0, MOE["vocab_size"], (8, MOE["max_seq_len"])).astype(np.int32)
    return {
        "embed_wide": (td.jax_embed_loss,) + embed,
        "lm1b": (lstm_loss, _filled(jax.eval_shape(jl.init, jax.random.PRNGKey(0))),
                 {"tokens": tokens}),
        "ncf": (jn.loss_fn, _filled(jax.eval_shape(jn.init, jax.random.PRNGKey(0))),
                {k: np.asarray(v) for k, v in jn.example_batch(BATCH).items()}),
        "moe": (jm.loss_fn, _filled(jax.eval_shape(jm.init, jax.random.PRNGKey(0))),
                {"tokens": moe_tokens}),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    models = _jax_models()
    torch_inputs = {k: (params_from_jax(p, device="cpu"), td.to_torch(b))
                    for k, (_, p, b) in models.items()}
    # The failing sweep ends when the group's timeout frees the waiting ranks.
    results = td.run_ranks(tmp_path_factory.mktemp("ranks"), torch_inputs,
                           CASES + BAD_IDS + [TUNE, TUNE_FAILS],
                           timeout_s=td.JOIN_TIMEOUT_S + 3 * worker.GROUP_TIMEOUT_S)
    return results, models, torch_inputs


def _table_bytes(got, name):
    return math.prod(got["params"][name].shape) * 4


@pytest.mark.parametrize("c", CASES, ids=[c["id"] for c in CASES])
def test_sparse_wire_matches_jax_and_its_prediction(c, runs):
    results, models, torch_inputs = runs
    got = results[0][c["id"]]
    for rank, res in enumerate(results[1:], 1):
        for name, value in got["params"].items():
            np.testing.assert_array_equal(res[c["id"]]["params"][name], value,
                                          err_msg=f"rank {rank} {name}")
    loss_fn, params, batch = models[c["model"]]
    jlosses, jparams = td.jax_train(c, params, batch, loss_fn)
    td.assert_params_close(got["params"], td.flat_np(jparams), what="vs JAX 4-device")
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    losses, one = td.one_process(c, *torch_inputs[c["model"]])
    td.assert_params_close(got["params"], one, what="vs one process")
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)

    manual = got["manual"]
    tables = TABLES[c["model"]]
    for name in tables:
        assert got["renderings"][name] == (("sharded", 0) if manual else ("sparse", 0))
    wire = ("grad", "param", "sparse", "table")
    for counts, moved in zip(got["collectives"], got["bytes"]):
        assert td.wire_counts(counts) == got["predicted"]
        assert {p: moved[p] for p in wire if p in moved} == got["predicted_bytes"]
    table = min(_table_bytes(got, name) for name in tables)
    largest = got["largest"]
    if manual:
        # The manual semantics move the table whole, as JAX's shard_map does.
        assert largest["grad"]["reduce_scatter"] >= table
        assert largest["param"]["all_gather"] >= table
        assert "sparse" not in largest
        return
    assert max(largest["sparse"].values()) < table // 4, largest["sparse"]
    assert "grad" not in largest or all(
        n not in tables for n in got["renderings"] if got["renderings"][n][0] != "sparse")
    if c["model"] == "embed_wide":
        # JAX's bar: no collective of the step moves a table-shaped operand.
        step_purposes = [p for p in largest if p not in ("init", "view")]
        assert max(max(largest[p].values()) for p in step_purposes) < table // 4, largest
    if c["model"] == "moe":
        # The tied output projection gathers the table whole: its own purpose.
        padded = got["predicted_bytes"]["table"]["all_gather"]
        assert padded == MOE["vocab_size"] * MOE["d_model"] * 4
        assert got["bytes"][0]["table"] == {"all_gather": padded, "reduce_scatter": padded}
    else:
        assert "table" not in got["predicted_bytes"]
    if c["model"] == "ncf":
        # Four tables, two ids tensors: each gathered once a forward.
        assert got["collectives"][0]["sparse"] == {"all_gather": 2 + 4, "reduce_scatter": 4}


def test_tune_over_the_group_builds_the_chiefs_pick(runs):
    results = runs[0]
    picks = {r["tune"]["selected"] for r in results}
    assert len(picks) == 1, picks
    chief = results[0]["tune"]["measured"]
    assert picks.pop() == min(chief, key=chief.get)
    assert len({r["tune"]["builder"] for r in results}) == 1
    # The chief's builder refused: every rank skipped that candidate.
    assert all(r["tune"]["measured"]["Refuses"] == math.inf for r in results)


def test_tune_stops_on_every_rank_when_one_rank_fails(runs):
    """No rank goes on to the next candidate's collectives while a peer may
    still wait in the failed one's."""
    for rank, r in enumerate(runs[0]):
        error = r["tune_fails"]["error"]
        assert "candidate AllReduce failed" in error and "the sweep stops" in error, error
        assert "2: 'MemoryError: out of memory" in error, (rank, error)


@pytest.mark.parametrize("bad", [c["bad_id"] for c in BAD_IDS])
def test_out_of_range_id_raises_as_the_plain_read(bad, runs):
    """An id outside the table raises on every rank, as the one-process
    read (``table[ids]``) raises."""
    errors = {r[f"bad_id{bad}"]["error"] for r in runs[0]}
    assert errors == {f"index {bad} is out of bounds for a table of {VOCAB} rows"}, errors
    params, (ids, y) = runs[2]["embed_wide"]
    ids = ids.clone()
    ids[5] = bad
    with pytest.raises(IndexError):
        worker.embed_loss(params, (ids, y))


def test_jax_moe_tied_table_wire():
    """What JAX's compiled 4-device GSPMD MoE step moves: its largest
    collectives carry the whole (row-sharded) table for the tied output
    projection, as the port's ``table`` purpose does."""
    from helpers import collective_sizes, compiled_hlo

    loss_fn, params, batch = _jax_models()["moe"]
    c = td.case("moe", "moe", "AllReduce", {}, "sgd")
    from autodist_tpu import model_item as jmi
    from autodist_tpu.kernel import DistributedTrainStep as JStep
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec

    rs = JResourceSpec(resource_dict={"nodes": [{"address": "localhost", "chips": 4}]})
    opt = jmi.OptimizerSpec(c["opt"], dict(c["opt_kwargs"]))
    item = jmi.ModelItem.from_params(params, optimizer_spec=opt, loss_fn=loss_fn,
                                     example_batch=batch)
    strategy = jstrat.StrategyCompiler(item).compile(jstrat.AllReduce().build(item, rs))
    plan = JGraphTransformer(strategy, item, jbuild_mesh(rs, devices=jax.devices()[:4])
                             ).transform()
    assert plan.promised_wire()["embed/embedding"].rendering == "sparse"
    step = JStep(plan, loss_fn, opt.make())
    sizes = collective_sizes(compiled_hlo(step, step.init(params), batch))
    table = MOE["vocab_size"] * MOE["d_model"]
    assert max(sizes) >= table, sorted(sizes, reverse=True)[:8]
