"""Port parity of sharded checkpoints at 4 gloo ranks (one process each, on
the CPU) against the JAX package's 4-device checkpoints.

A dense regression (``w [12, 8]``, ``b [8]``: every axis splits over 4
without padding) under Zero1, PartitionedPS with ``staleness=2`` and
AllReduce with the Horovod-EF compressor, Adam, and PartitionedPS on the
``tests/helpers/torch_dist.py`` dense model, whose ``b [5]`` pads to 8.
The ranks start once (``tests/helpers/torch_dist_worker.py``); each case
trains, saves through ``step.save`` and restores the JAX package's
checkpoint of the same case (and the one-process port's, where the state
does not depend on the world size: not the EF residuals, which JAX stacks
``[n, ...]``). Held, bitwise (a checkpoint copies values):

- every rank writes only its own blocks: block ``j`` of a split leaf by
  rank ``j`` alone, whole leaves by rank 0, no file twice, and no rank a
  whole file of a split leaf;
- the metadata equals the JAX ``Saver``'s for JAX's 4-device plan of the
  same case (unpadded cases: JAX writes a padded leaf's sliced view whole);
- the 4-rank checkpoint restores into the one-process port step and into
  JAX's 4-device step, each leaf equal to the checkpoint's;
- JAX's checkpoint (and the one-process port's) restore into the 4 ranks:
  each rank's blocks equal the checkpoint's region, ``step`` and the
  optimizer's ``count`` too.
"""
import jax
import numpy as np
import pytest

from autodist_tpu import model_item as jmi
from autodist_tpu import strategy as jstrat
from autodist_tpu.checkpoint import Saver as JSaver
from autodist_tpu.kernel import DistributedTrainStep as JStep
from autodist_tpu.kernel import GraphTransformer as JGraphTransformer
from autodist_tpu.kernel import build_mesh as jbuild_mesh
from autodist_tpu.model_item import _path_to_name
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu_torch import api as tapi
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.checkpoint.saver import flatten_with_names
from helpers import torch_dist as td
from helpers import torch_dist_worker as worker

N = 4
ADAM = {"learning_rate": 1e-2}
CASES = [
    dict(id="Zero1", model="dense8", builder="Zero1", builder_kwargs={}, steps=2),
    dict(id="PartitionedPS-stale2", model="dense8", builder="PartitionedPS",
         builder_kwargs={"staleness": 2}, steps=3),
    dict(id="AllReduce-EF", model="dense8", builder="AllReduce",
         builder_kwargs={"compressor": "HorovodCompressorEF"}, steps=2),
    dict(id="PartitionedPS-padded", model="dense", builder="PartitionedPS",
         builder_kwargs={}, steps=2),
]
for _c in CASES:
    _c.update(opt="adam", opt_kwargs=dict(ADAM), clip_norm=None)


def _inputs():
    rng = np.random.default_rng(11)
    dense8 = {"w": rng.standard_normal((12, 8)).astype(np.float32),
              "b": rng.standard_normal((8,)).astype(np.float32)}
    batch = (rng.standard_normal((16, 12)).astype(np.float32),
             rng.standard_normal((16, 8)).astype(np.float32))
    return {"dense8": (dense8, batch), "dense": td.inputs()["dense"]}


def _jax_step(c, params, batch):
    rs = JResourceSpec(resource_dict={"nodes": [
        {"address": "localhost", "chips": N, "chief": True}]})
    opt = jmi.OptimizerSpec(c["opt"], dict(c["opt_kwargs"]), clip_norm=c["clip_norm"])
    item = jmi.ModelItem.from_params(params, optimizer_spec=opt, loss_fn=td.jax_dense_loss,
                                     example_batch=batch)
    strategy = jstrat.from_name(c["builder"], **c["builder_kwargs"]).build(item, rs)
    strategy = jstrat.StrategyCompiler(item).compile(strategy)
    plan = JGraphTransformer(strategy, item, jbuild_mesh(rs, devices=jax.devices()[:N])
                             ).transform()
    return JStep(plan, td.jax_dense_loss, opt.make())


def _flat_ckpt(path):
    """Every entry of a checkpoint, whole, as numpy."""
    return {n: t.numpy() for n, t in flatten_with_names(Saver().restore(path))}


def _jax_flat(tree):
    return {_path_to_name(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(step, state):
    """The one-process port state's checkpoint leaves as numpy."""
    out = {}
    for name, leaf, _ in step.checkpoint_leaves(state):
        out[name] = np.asarray(leaf) if isinstance(leaf, int) else leaf.detach().numpy()
    return out


def _assert_leaves(got, want, what):
    assert sorted(got) == sorted(want), (what, sorted(set(got) ^ set(want)))
    for name, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[name]).astype(value.dtype), value,
                                      err_msg=f"{what} {name}")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """JAX's and the one-process port's checkpoints of each case, then the
    4 ranks: each case trained, saved and restored from those."""
    tmp = tmp_path_factory.mktemp("ckpt_dist")
    np_inputs = _inputs()
    torch_inputs = {k: td.to_torch(v) for k, v in np_inputs.items()}
    cases = []
    for c in CASES:
        c = dict(c)
        params, batch = np_inputs[c["model"]]
        jstep = _jax_step(c, params, batch)
        jstate = jstep.init(params)
        for _ in range(c["steps"]):
            jstate, _ = jstep(jstate, batch)
        jdir = str(tmp / "jax" / c["id"])
        jstep.save(JSaver(jdir), jstate)
        restore = [jdir]
        if "compressor" not in c["builder_kwargs"]:
            tapi.AutoDist.reset_default()
            _, step, state, _, _, _ = worker.train(c, *torch_inputs[c["model"]])
            tapi.AutoDist.reset_default()
            one_dir = str(tmp / "one" / c["id"])
            step.save(Saver(one_dir), state)
            restore.append(one_dir)
        c.update(save=str(tmp / "port" / c["id"]), restore=restore, jax_dir=jdir)
        cases.append(c)
    results = td.run_ranks(tmp, torch_inputs, cases, world=N)
    return cases, results, np_inputs, torch_inputs


@pytest.mark.parametrize("cid", [c["id"] for c in CASES])
def test_each_rank_writes_only_its_blocks(run, cid):
    cases, results, _, _ = run
    c = next(c for c in cases if c["id"] == cid)
    path = results[0][cid]["checkpoint"]["path"]
    entries = Saver.read_metadata(path)["entries"]
    written = [set(r[cid]["checkpoint"]["files"]) for r in results]
    assert sum(len(w) for w in written) == len(set().union(*written)), "a file twice"
    split = 0
    for name, entry in entries.items():
        if "shards" not in entry:
            assert f"{name}.npy" in written[0], name
            continue
        split += 1
        for j, sh in enumerate(entry["shards"]):
            owners = [r for r, w in enumerate(written) if sh["file"] in w]
            assert owners == [j], (name, j, owners)
            block = np.load(f"{path}/{sh['file']}")
            assert list(block.shape) == [b - a for a, b in zip(sh["start"], sh["stop"])]
        assert not any(f"{name}.npy" in w for w in written), name
    assert split > 0, f"{cid}: no leaf is split over the ranks"


@pytest.mark.parametrize("cid", [c["id"] for c in CASES if "padded" not in c["id"]])
def test_metadata_equals_jax(run, cid):
    cases, results, _, _ = run
    c = next(c for c in cases if c["id"] == cid)
    path = results[0][cid]["checkpoint"]["path"]
    jmeta = JSaver.read_metadata(f"{c['jax_dir']}/ckpt-{c['steps']}")
    assert Saver.read_metadata(path) == jmeta


@pytest.mark.parametrize("cid", [c["id"] for c in CASES])
def test_rank_checkpoint_restores_into_jax_and_one_process(run, cid):
    cases, results, np_inputs, torch_inputs = run
    c = next(c for c in cases if c["id"] == cid)
    path = results[0][cid]["checkpoint"]["path"]
    want = _flat_ckpt(path)
    params, batch = np_inputs[c["model"]]
    jstep = _jax_step(c, params, batch)
    jstate = jstep.init_or_restore(params, JSaver(c["save"]))
    _assert_leaves(_jax_flat(jstep.logical_state(jstate)), want, "JAX 4-device")
    if "compressor" in c["builder_kwargs"]:
        return                      # JAX's [n, ...] residuals need n ranks
    tapi.AutoDist.reset_default()
    try:
        _, step, _, _, _, _ = worker.train(dict(c, steps=0), *torch_inputs[c["model"]])
        state = step.init_or_restore(torch_inputs[c["model"]][0], Saver(c["save"]))
    finally:
        tapi.AutoDist.reset_default()
    _assert_leaves(_port_flat(step, state), want, "one process")


@pytest.mark.parametrize("cid", [c["id"] for c in CASES])
def test_checkpoints_restore_into_the_ranks(run, cid):
    cases, results, _, _ = run
    c = next(c for c in cases if c["id"] == cid)
    for directory in c["restore"]:
        path = f"{directory}/ckpt-{c['steps']}"
        want = _flat_ckpt(path)
        covered = {name: 0 for name in want}
        for rank, res in enumerate(results):
            got = res[cid]["checkpoint"]["restored"][directory]
            assert got["step"] == c["steps"] and got["count"] == c["steps"]
            # A rank past a padded leaf's logical end holds none of it.
            assert set(got["blocks"]) <= set(want), sorted(set(got["blocks"]) - set(want))
            for name, (start, stop, value) in got["blocks"].items():
                region = want[name][tuple(slice(a, b) for a, b in zip(start, stop))]
                np.testing.assert_array_equal(value, region, err_msg=f"rank {rank} {name}")
                covered[name] += value.size
            for name, value in got["params"].items():
                np.testing.assert_array_equal(value, want[f"params/{name}"],
                                              err_msg=f"rank {rank} params {name}")
        for name, n in covered.items():
            assert n >= want[name].size, (directory, name, n)
