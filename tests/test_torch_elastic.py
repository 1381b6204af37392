"""Elastic resume of the port against the JAX package's
(``tests/test_ft.py``'s kill/resume anchor and its elastic cases).

JAX trains on 8 devices, snapshots at step 3 and resumes on 4 with a
recompiled plan. The port runs one process per device, so the same story
is 4 gloo ranks → 2, in one spawn: all 4 train 3 steps, snapshot, and
train 3 more (the uninterrupted run); ranks 2-3 then exit, and ranks 0-1
call ``AutoDist.elastic_rebuild(ranks=[0, 1])``, which forms their group,
rebuilds the plan over it and restores the step-3 snapshot through the
Saver's per-rank blocks; they train 3 more steps. Their losses equal the
uninterrupted 4-rank run's and JAX's 8-device run's on the same params and
batch (rtol 1e-5, atol 1e-6), and so do the final parameters.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from autodist_tpu.ft import SnapshotManager as JSnapshotManager
from autodist_tpu.ft import recompile_on as jrecompile_on
from autodist_tpu.ft import resume_from_snapshot as jresume_from_snapshot
from autodist_tpu.kernel import DistributedTrainStep, GraphTransformer, build_mesh
from autodist_tpu.model_item import ModelItem, OptimizerSpec
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import AllReduce as JAllReduce
from autodist_tpu.strategy import StrategyCompiler
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.ft import (SnapshotManager, recompile_on, resume_from_snapshot,
                                   surviving_resource_spec)
from autodist_tpu_torch.resource_spec import ResourceSpec

REPO = Path(__file__).resolve().parents[1]
BATCH, DIN, DOUT, LR = 16, 8, 4, 0.1
RTOL, ATOL = 1e-5, 1e-6


def make_inputs():
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((DIN, DOUT)).astype(np.float32),
              "b": rng.standard_normal(DOUT).astype(np.float32)}
    batch = (rng.standard_normal((BATCH, DIN)).astype(np.float32),
             rng.standard_normal((BATCH, DOUT)).astype(np.float32))
    return params, batch


def jax_loss(params, batch):
    x, y = batch
    return jnp.mean((x @ params["w"] + params["b"] - y) ** 2)


def torch_loss(params, batch):
    x, y = batch
    return torch.mean((x @ params["w"] + params["b"] - y) ** 2)


def jax_step(n):
    spec = JResourceSpec(resource_dict={"nodes": [
        {"address": "localhost", "chips": n, "chief": True}]})
    params, batch = make_inputs()
    item = ModelItem.from_params(params, optimizer_spec=OptimizerSpec(
        "sgd", {"learning_rate": LR}))
    compiled = StrategyCompiler(item).compile(JAllReduce().build(item, spec))
    plan = GraphTransformer(compiled, item, build_mesh(spec, axes=("data",),
                                                       devices=jax.devices()[:n])).transform()
    return DistributedTrainStep(plan, jax_loss, optax.sgd(LR))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's 8-device run: 6 uninterrupted losses, and the kill/resume
    losses on 4 devices from its step-3 snapshot."""
    params, batch = make_inputs()
    step = jax_step(8)
    state, losses = step.init(params), []
    for i in range(6):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i == 2:
            snap_dir = str(tmp_path_factory.mktemp("jax_snap"))
            JSnapshotManager(snap_dir).snapshot(state, step_obj=step, block=True)
    w = np.asarray(step.logical_params(state)["w"])
    step4 = jrecompile_on(jax.devices()[:4], jax_loss, params, batch,
                          strategy_builder=JAllReduce(), optimizer=optax.sgd(LR))
    state4 = jresume_from_snapshot(step4, params, JSnapshotManager(snap_dir))
    resumed = []
    for _ in range(3):
        state4, m = step4(state4, batch)
        resumed.append(float(m["loss"]))
    return {"losses": losses, "w": w, "resumed": resumed, "snap_dir": snap_dir}


WORKER = """
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from autodist_tpu_torch.api import AutoDist
from autodist_tpu_torch.ft import FTConfig
from autodist_tpu_torch.model_item import OptimizerSpec
from autodist_tpu_torch.strategy import AllReduce

rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
data = np.load(os.path.join(work, "inputs.npz"))
params = {"w": torch.from_numpy(data["w"]), "b": torch.from_numpy(data["b"])}
batch = (torch.from_numpy(data["x"]), torch.from_numpy(data["y"]))
opt = OptimizerSpec("sgd", {"learning_rate": %(lr)r})

def loss_fn(p, b):
    x, y = b
    return torch.mean((x @ p["w"] + p["b"] - y) ** 2)

ad = AutoDist(strategy_builder=AllReduce(), device="cpu", init_method=f"file://{work}/pg",
              world_size=world, rank=rank, timeout_s=60, mesh_axes=("data",),
              fault_tolerance=FTConfig(base_dir=os.path.join(work, "ft"),
                                       heartbeat_interval_s=0.2, snapshot_on_preempt=False))
step = ad.build(loss_fn, params, batch, optimizer=opt)
state, losses = step.init(params), []
for i in range(6):
    state, m = step(state, batch)
    losses.append(float(m["loss"]))
    if i == 2:
        ad.ft.snapshots.snapshot(state, step_obj=step, block=True)
out = {"losses": losses, "w": step.logical_params(state)["w"].tolist()}
if rank >= 2:                         # the lost half of the fleet
    ad.ft.shutdown()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    os._exit(0)
step2, state2 = ad.elastic_rebuild(loss_fn, params, batch, ranks=[0, 1], optimizer=opt)
out["restored_step"] = int(state2.step)
out["survivor_world"] = step2.plan.mesh.shape["data"]
out["spec_gpus"] = ad.resource_spec.num_gpus
resumed = []
for _ in range(3):
    state2, m = step2(state2, batch)
    resumed.append(float(m["loss"]))
out["resumed"] = resumed
out["resumed_w"] = step2.logical_params(state2)["w"].tolist()
ad.ft.shutdown()
with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
"""


def test_four_to_two_rank_elastic_resume_matches_uninterrupted_and_jax(tmp_path, jax_run):
    params, (x, y) = make_inputs()
    np.savez(tmp_path / "inputs.npz", w=params["w"], b=params["b"], x=x, y=y)
    script = tmp_path / "worker.py"
    script.write_text(WORKER % {"lr": LR})
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(4)]
    procs = [subprocess.Popen([sys.executable, str(script), str(r), "4", str(tmp_path)],
                              env=env, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(4)]
    deadline = time.monotonic() + 150
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    tails = {r: (tmp_path / f"rank{r}.log").read_text()[-2000:] for r in range(4)}
    assert all(p.returncode == 0 for p in procs), tails
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(4)]
    ref = ranks[0]["losses"]
    for got in ranks:
        np.testing.assert_allclose(got["losses"], jax_run["losses"], rtol=RTOL, atol=ATOL)
        assert got["losses"] == ref                     # ranks agree bitwise
    for got in ranks[:2]:
        assert (got["restored_step"], got["survivor_world"], got["spec_gpus"]) == (3, 2, 2)
        np.testing.assert_allclose(got["resumed"], ref[3:], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["resumed"], jax_run["losses"][3:], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got["resumed"], jax_run["resumed"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(np.asarray(got["resumed_w"], np.float32), jax_run["w"],
                                   rtol=RTOL, atol=ATOL)
    assert ranks[0]["resumed"] == ranks[1]["resumed"]


def test_one_process_resume_from_jax_snapshot(jax_run):
    """JAX's step-3 snapshot (8-device plan) resumes in a one-process port
    step built by ``recompile_on([0])``: the next 3 losses equal JAX's."""
    params, batch = make_inputs()
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tbatch = tuple(torch.from_numpy(v) for v in batch)
    from autodist_tpu_torch.model_item import OptimizerSpec as TOpt

    step = recompile_on([0], torch_loss, tparams, tbatch, device="cpu",
                        optimizer=TOpt("sgd", {"learning_rate": LR}))
    state = resume_from_snapshot(step, tparams, SnapshotManager(
        jax_run["snap_dir"], registry=M.MetricsRegistry()))
    assert state.step == 3
    losses = []
    for _ in range(3):
        state, m = step(state, tbatch)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jax_run["losses"][3:], rtol=RTOL, atol=ATOL)


def test_resume_without_snapshot_is_fresh_init(tmp_path):
    params, batch = make_inputs()
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    step = recompile_on([0], torch_loss, tparams, tuple(torch.from_numpy(v) for v in batch),
                        device="cpu")
    state = resume_from_snapshot(step, tparams, SnapshotManager(
        str(tmp_path), registry=M.MetricsRegistry()))
    assert state.step == 0


def test_surviving_resource_spec():
    spec = surviving_resource_spec([0, 1, 2, 3])
    assert spec.num_gpus == 4 and spec.chief_address == "localhost"
    template = ResourceSpec(resource_dict={
        "nodes": [{"address": "10.0.0.1", "gpus": 4, "chief": True},
                  {"address": "10.0.0.2", "gpus": 4}],
        "mesh": {"data": 8}, "gpu": {"device": "NVIDIA H100 80GB HBM3"}})
    survived = surviving_resource_spec([1, 2, 5], template)
    assert [(n.address, n.gpus, n.chief) for n in survived.nodes] == [
        ("10.0.0.1", 2, True), ("10.0.0.2", 1, False)]
    assert survived.mesh_shape(("data",)) == {"data": 3}
    assert survived.gpu.device == "NVIDIA H100 80GB HBM3"
    only_second = surviving_resource_spec([6, 7], template)
    assert [(n.address, n.gpus, n.chief) for n in only_second.nodes] == [
        ("10.0.0.2", 2, True)]
    with pytest.raises(ValueError):
        surviving_resource_spec([], template)


def test_elastic_rebuild_needs_fault_tolerance():
    from autodist_tpu_torch.api import AutoDist

    AutoDist.reset_default()
    try:
        ad = AutoDist(device="cpu")
        with pytest.raises(RuntimeError, match="fault tolerance"):
            ad.elastic_rebuild(torch_loss, {}, None)
    finally:
        AutoDist.reset_default()
