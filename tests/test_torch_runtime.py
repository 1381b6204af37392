"""The port's runtime against the JAX package's (``tests/test_runtime.py``'s
cases, on the port's per-GPU process table): the cluster's ordering, ports
and env contract, the stale-process sweep, the coordinator's local launch,
fail-fast and failure action, the launcher's env scrub, restart supervisor
and backoff, and three fleets of gloo ranks on the CPU started by the
port's launcher:

- the supervised crash-resume (``test_supervised_crash_resume``): 2 ranks,
  a crash at step 2 on attempt 0, a resume to step 4; the final parameters
  equal JAX's uninterrupted 4 steps of the same model within 1e-6;
- the hang watchdog: ranks that stop beating while alive (one asleep, its
  peer held in a collective) are terminated within ``hang_after_misses``
  intervals, the doctor bundle written first in JAX's keys, ``launch``
  returns non-zero and the restart budget resets as the snapshot ring
  advances;
- the per-node agent: one rank failing ends the node with its code.
"""
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime import cluster as cluster_mod
from autodist_tpu_torch.runtime import launcher as L
from autodist_tpu_torch.runtime.cluster import (
    LAUNCHER_ENV, Cluster, _deterministic_port, _pidfile_dir, clean_stale_processes)
from autodist_tpu_torch.runtime.coordinator import Coordinator, _is_local

REPO = Path(__file__).resolve().parents[1]

TWO_NODE = {"nodes": [{"address": "10.0.0.2", "gpus": 4},
                      {"address": "10.0.0.1", "gpus": 4, "chief": True}]}


def make_cluster():
    return Cluster(ResourceSpec(resource_dict=TWO_NODE))


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def fleet_env(monkeypatch):
    """Ranks started from this process import the port from the checkout,
    on one torch thread each."""
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv(ENV.AUTODIST_TRACE_OUT.name, raising=False)
    monkeypatch.delenv(ENV.AUTODIST_FT_DIR.name, raising=False)


# ----------------------------------------------------------------- cluster
class TestCluster:
    def test_deterministic_port_in_range(self):
        p1 = _deterministic_port(ResourceSpec(resource_dict=TWO_NODE))
        assert p1 == _deterministic_port(ResourceSpec(resource_dict=TWO_NODE))
        assert 15000 <= p1 < 16000

    def test_process_table_is_per_gpu_chief_first_then_sorted(self):
        c = make_cluster()
        assert c.num_processes == 8
        assert c.process_id("10.0.0.1") == 0              # chief first
        assert c.process_id("10.0.0.1", 3) == 3
        assert c.process_id("10.0.0.2") == 4
        assert c.process_id("10.0.0.2", 3) == 7
        # Rank r is the r-th device of the spec's numbering.
        devices = ResourceSpec(resource_dict=TWO_NODE).gpu_devices
        assert [(d.host_address, d.device_index) for d in devices] == c.process_table

    def test_unknown_address_raises(self):
        with pytest.raises(ValueError, match="not in resource spec"):
            make_cluster().process_id("10.9.9.9")

    def test_coordinator_address_is_chief(self):
        c = make_cluster()
        host, port = c.coordinator_address.rsplit(":", 1)
        assert host == "10.0.0.1" and int(port) == c.coordinator_port

    def test_env_contract(self):
        c = make_cluster()
        env = c.env_for_worker("10.0.0.2", strategy_id="20260729T000000M0", local_rank=2)
        assert env[ENV.AUTODIST_WORKER.name] == "10.0.0.2"
        assert env[ENV.AUTODIST_PROCESS_ID.name] == env["RANK"] == "6"
        assert env[ENV.AUTODIST_NUM_PROCESSES.name] == env["WORLD_SIZE"] == "8"
        assert env[ENV.AUTODIST_STRATEGY_ID.name] == "20260729T000000M0"
        assert env[ENV.AUTODIST_COORDINATOR.name] == c.coordinator_address
        assert (env["MASTER_ADDR"], env["MASTER_PORT"]) == ("10.0.0.1",
                                                            str(c.coordinator_port))
        assert (env["LOCAL_RANK"], env["LOCAL_WORLD_SIZE"]) == ("2", "4")
        chief = c.env_for_worker("10.0.0.1")
        assert ENV.AUTODIST_WORKER.name not in chief and chief["RANK"] == "0"

    def test_cpu_node_is_one_rank_and_single_node_initialize_noop(self):
        c = Cluster(ResourceSpec(resource_dict={"nodes": [
            {"address": "localhost", "gpus": 0, "chief": True}]}))
        c.initialize(device="cpu")
        assert c.num_processes == 1


# ---------------------------------------------------------- stale cleanup
def _pidfile(pid, launcher=""):
    path = os.path.join(_pidfile_dir(), f"{pid}.pid")
    with open(path, "w") as f:
        json.dump({"pid": pid, "start": cluster_mod._start_time(pid),
                   "launcher": launcher}, f)
    return path


class TestStaleCleanup:
    def test_dead_pidfile_removed(self):
        child = subprocess.Popen([sys.executable, "-c", "pass"])
        child.wait()
        path = _pidfile(child.pid, launcher="1:0")
        clean_stale_processes()
        assert not os.path.exists(path)

    def test_orphan_killed_live_launch_and_self_left_alone(self):
        dead = subprocess.Popen([sys.executable, "-c", "pass"])
        dead.wait()
        orphan = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
        running = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
        try:
            p_orphan = _pidfile(orphan.pid, launcher=f"{dead.pid}:x")
            p_running = _pidfile(running.pid, launcher=cluster_mod.launcher_token())
            p_self = _pidfile(os.getpid(), launcher=f"{dead.pid}:x")
            p_parent = _pidfile(os.getppid(), launcher=f"{dead.pid}:x")
            killed = clean_stale_processes()
            assert killed >= 1
            assert orphan.wait(timeout=10) == -signal.SIGTERM
            assert not os.path.exists(p_orphan)
            assert running.poll() is None and os.path.exists(p_running)
            assert os.path.exists(p_self) and os.path.exists(p_parent)
        finally:
            for p in (orphan, running):
                p.kill()
                p.wait()
            for path in (p_running, p_self, p_parent):
                if os.path.exists(path):
                    os.unlink(path)

    def test_pidfiles_live_under_the_port_working_dir(self):
        from autodist_tpu import const as jconst
        from autodist_tpu_torch import const

        assert _pidfile_dir().startswith(const.DEFAULT_WORKING_DIR)
        assert not _pidfile_dir().startswith(jconst.DEFAULT_WORKING_DIR + os.sep)


# ------------------------------------------------------------- coordinator
class TestCoordinator:
    def test_is_local(self):
        assert _is_local("localhost") and _is_local("127.0.0.1")
        assert not _is_local("10.0.0.9")

    def test_debug_remote_short_circuits_ssh(self, monkeypatch):
        monkeypatch.setenv(ENV.AUTODIST_DEBUG_REMOTE.name, "True")
        coord = Coordinator(make_cluster(), argv=["python", "train.py"])
        coord.launch_clients()
        for p in coord.procs:
            assert p.wait(timeout=10) == 0           # "true" stub, no real ssh
        assert not coord.any_failed

    def test_local_node_launch_runs_each_rank_with_its_env(self, tmp_path, fleet_env):
        out = tmp_path / "env"
        out.mkdir()
        script = tmp_path / "w.py"
        script.write_text(textwrap.dedent(f"""
            import os
            with open(os.path.join({str(out)!r}, os.environ["RANK"]), "w") as f:
                f.write(",".join(os.environ.get(k, "") for k in (
                    "AUTODIST_WORKER", "AUTODIST_PROCESS_ID", "LOCAL_RANK",
                    "LOCAL_WORLD_SIZE", "WORLD_SIZE")))
        """))
        spec = ResourceSpec(resource_dict={"nodes": [
            {"address": "localhost", "gpus": 2, "chief": True}]})
        c = Cluster(spec)
        coord = Coordinator(c, argv=[sys.executable, str(script)])
        proc = coord._launch_local(c.env_for_worker("localhost", ""), n_local=2)
        assert proc.wait(timeout=60) == 0
        assert (out / "0").read_text() == ",0,0,2,2"
        assert (out / "1").read_text() == "localhost,1,1,2,2"

    def test_chief_fail_fast_on_node_death(self, tmp_path, fleet_env):
        """A node's agent exits non-zero → the chief process os._exit(1)s."""
        driver = tmp_path / "driver.py"
        driver.write_text(textwrap.dedent("""
            import sys, threading, time
            from autodist_tpu_torch.resource_spec import ResourceSpec
            from autodist_tpu_torch.runtime.cluster import Cluster
            from autodist_tpu_torch.runtime.coordinator import Coordinator

            spec = ResourceSpec(resource_dict={"nodes": [
                {"address": "localhost", "gpus": 1, "chief": True}]})
            c = Cluster(spec)
            coord = Coordinator(c, argv=[sys.executable, "-c", "raise SystemExit(3)"])
            proc = coord._launch_local(c.env_for_worker("localhost"))
            coord.procs.append(proc)
            threading.Thread(target=coord._monitor, args=("localhost", proc),
                             daemon=True).start()
            time.sleep(60)
            print("chief survived", flush=True)
        """))
        res = subprocess.run([sys.executable, str(driver)], capture_output=True,
                             text=True, timeout=90)
        assert res.returncode == 1, res.stdout + res.stderr
        assert "chief survived" not in res.stdout

    def test_supervised_failure_action_replaces_os_exit(self, fleet_env):
        c = Cluster(ResourceSpec(resource_dict={"nodes": [
            {"address": "localhost", "gpus": 1, "chief": True}]}))
        coord = Coordinator(c, argv=[sys.executable, "-c", "raise SystemExit(3)"])
        fired = threading.Event()
        coord.set_failure_action(fired.set)
        proc = coord._launch_local(c.env_for_worker("localhost"))
        coord.procs.append(proc)
        threading.Thread(target=coord._monitor, args=("localhost", proc),
                         daemon=True).start()
        assert fired.wait(timeout=60)
        assert coord.any_failed

    def test_extra_env_reaches_nodes_and_role_env_wins(self):
        c = Cluster(ResourceSpec(resource_dict={"nodes": [
            {"address": "localhost", "gpus": 2, "chief": True}]}))
        coord = Coordinator(c, argv=["true"], extra_env={
            "AUTODIST_RESTART": "2", ENV.AUTODIST_WORKER.name: "must-not-win"})
        env = {**coord.extra_env, **c.env_for_worker("localhost", local_rank=1)}
        assert env["AUTODIST_RESTART"] == "2"
        assert env[ENV.AUTODIST_WORKER.name] == "localhost"


# ---------------------------------------------------------------- launcher
def test_fleet_launcher_scrubs_inherited_role_vars(monkeypatch):
    captured = []

    class FakeProc:
        def __init__(self, argv, env=None, **kw):
            captured.append(env)
            self.pid = -1

        def poll(self):
            return 0

    monkeypatch.setattr(L.subprocess, "Popen", FakeProc)
    base = {"PATH": "/usr/bin", ENV.AUTODIST_STRATEGY_ID.name: "stale",
            ENV.AUTODIST_WORKER.name: "10.0.0.9", "RANK": "7", "MASTER_PORT": "1",
            LAUNCHER_ENV: "1:1", "AUTODIST_MIN_LOG_LEVEL": "DEBUG",
            "AUTODIST_TEST_CKPT_DIR": "/x"}
    assert L._launch_local_fleet(["true"], 2, 15900, base_env=base) == 0
    assert [e["RANK"] for e in captured] == ["0", "1"]
    for env in captured:
        assert env.get(ENV.AUTODIST_STRATEGY_ID.name) != "stale"
        assert env.get(ENV.AUTODIST_WORKER.name) != "10.0.0.9"
        assert LAUNCHER_ENV not in env and env["MASTER_PORT"] == "15900"
        assert env["AUTODIST_MIN_LOG_LEVEL"] == "DEBUG"
        assert env["AUTODIST_TEST_CKPT_DIR"] == "/x"


class TestRestartSupervisor:
    def _sup(self, monkeypatch, codes, max_restarts):
        calls = []

        def fake_launch(spec, argv, num_local_processes=0, coordinator_port=None,
                        extra_env=None, supervised=False, ft_config=None):
            self.last_supervised = supervised
            calls.append((extra_env or {}).get("AUTODIST_RESTART"))
            return codes[len(calls) - 1]

        monkeypatch.setattr(L, "launch", fake_launch)
        monkeypatch.setattr("time.sleep", lambda s: None)
        return L.launch_supervised(None, ["true"], max_restarts=max_restarts,
                                   restart_backoff_s=0), calls

    def test_restarts_until_success(self, monkeypatch):
        rc, calls = self._sup(monkeypatch, [1, 1, 0], max_restarts=3)
        assert rc == 0 and calls == ["0", "1", "2"]

    def test_gives_up_after_budget(self, monkeypatch):
        rc, calls = self._sup(monkeypatch, [7, 7], max_restarts=1)
        assert rc == 7 and len(calls) == 2

    def test_zero_restarts_is_plain_launch(self, monkeypatch):
        rc, calls = self._sup(monkeypatch, [3], max_restarts=0)
        assert rc == 3 and len(calls) == 1 and self.last_supervised is False

    def test_restart_budget_runs_supervised(self, monkeypatch):
        self._sup(monkeypatch, [0], max_restarts=2)
        assert self.last_supervised is True


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_backoff_delays_equal_jax_under_seed(seed, monkeypatch):
    """The delays ``launch_supervised`` sleeps under ``backoff_seed`` equal
    the JAX package's, attempt for attempt."""
    import autodist_tpu.runtime.launcher as JL

    def delays(mod):
        slept = []
        monkeypatch.setattr(mod, "launch", lambda *a, **k: 1)
        rc = mod.launch_supervised(None, ["true"], max_restarts=6, restart_backoff_s=0.5,
                                   restart_backoff_max_s=4.0, backoff_seed=seed,
                                   restart_sleep=slept.append)
        assert rc == 1
        return slept

    got, want = delays(L), delays(JL)
    assert len(got) == 6 and got == want


def test_node_agent_exits_with_the_failing_rank_and_ends_the_others(tmp_path, fleet_env,
                                                                    monkeypatch):
    script = tmp_path / "r.py"
    script.write_text(textwrap.dedent("""
        import os, time
        if os.environ["LOCAL_RANK"] == "1":
            raise SystemExit(5)
        time.sleep(60)
    """))
    monkeypatch.setenv("RANK", "4")
    t0 = time.monotonic()
    assert L.run_node([sys.executable, str(script)], 2) == 5
    assert time.monotonic() - t0 < 30


# ------------------------------------------------------------------ fleets
CRASH_RESUME = """
import json, os, sys
import torch
torch.set_num_threads(1)
from autodist_tpu_torch.api import AutoDist
from autodist_tpu_torch.checkpoint import Saver
from autodist_tpu_torch.model_item import OptimizerSpec
from autodist_tpu_torch.strategy import AllReduce

ad = AutoDist(strategy_builder=AllReduce(), device="cpu", timeout_s=60)

def loss_fn(params, batch):
    return ((batch["x"] @ params["w"]) ** 2).mean()

params = {"w": torch.ones(4, 2)}
batch = {"x": torch.ones(8, 4) / 4.0}
step = ad.build(loss_fn, params, batch,
                optimizer=OptimizerSpec("sgd", {"learning_rate": 0.05}))
saver = Saver(os.environ["AUTODIST_TEST_CKPT_DIR"])
state = step.init_or_restore(params, saver)
start, restart = int(state.step), int(os.environ.get("AUTODIST_RESTART", "0"))
assert (start == 0) == (restart == 0), (start, restart)
while int(state.step) < 4:
    state, _ = step(state, batch)
    step.save(saver, state)
    if restart == 0 and int(state.step) == 2:
        os._exit(1)          # a crash on every rank mid-training
rank = torch.distributed.get_rank()
with open(os.path.join(os.environ["AUTODIST_TEST_OUT"], f"rank{rank}.json"), "w") as f:
    json.dump({"start": start, "restart": restart, "step": int(state.step),
               "w": step.logical_params(state)["w"].tolist()}, f)
"""


def _jax_uninterrupted(steps: int):
    import jax
    import optax

    from autodist_tpu.kernel import DistributedTrainStep, GraphTransformer, build_mesh
    from autodist_tpu.model_item import ModelItem, OptimizerSpec
    from autodist_tpu.resource_spec import ResourceSpec as JSpec
    from autodist_tpu.strategy import AllReduce, StrategyCompiler

    def loss_fn(params, batch):
        return ((batch["x"] @ params["w"]) ** 2).mean()

    spec = JSpec(resource_dict={"nodes": [{"address": "localhost", "chips": 2,
                                           "chief": True}]})
    params = {"w": np.ones((4, 2), np.float32)}
    batch = {"x": np.ones((8, 4), np.float32) / 4.0}
    item = ModelItem.from_params(params, optimizer_spec=OptimizerSpec(
        "sgd", {"learning_rate": 0.05}), loss_fn=loss_fn, example_batch=batch)
    compiled = StrategyCompiler(item).compile(AllReduce().build(item, spec))
    plan = GraphTransformer(compiled, item, build_mesh(spec, devices=jax.devices()[:2])
                            ).transform()
    step = DistributedTrainStep(plan, loss_fn, optax.sgd(0.05))
    state = step.init(params)
    for _ in range(steps):
        state, _ = step(state, batch)
    return np.asarray(step.logical_params(state)["w"])


def test_supervised_crash_resume_matches_jax(tmp_path, fleet_env):
    script = tmp_path / "train.py"
    script.write_text(CRASH_RESUME)
    (tmp_path / "out").mkdir()
    os.environ["AUTODIST_TEST_CKPT_DIR"] = str(tmp_path / "ckpt")
    os.environ["AUTODIST_TEST_OUT"] = str(tmp_path / "out")
    try:
        rc = L.launch_supervised(None, [sys.executable, str(script)], max_restarts=2,
                                 num_local_processes=2, coordinator_port=_free_port(),
                                 restart_backoff_s=0.1)
    finally:
        os.environ.pop("AUTODIST_TEST_CKPT_DIR")
        os.environ.pop("AUTODIST_TEST_OUT")
    assert rc == 0
    ranks = [json.loads((tmp_path / "out" / f"rank{r}.json").read_text()) for r in (0, 1)]
    want = _jax_uninterrupted(4)
    for got in ranks:
        assert (got["start"], got["restart"], got["step"]) == (2, 1, 4)
        np.testing.assert_allclose(np.asarray(got["w"], np.float32), want, rtol=0,
                                   atol=1e-6)
    from autodist_tpu_torch.checkpoint import Saver

    assert int(Saver(str(tmp_path / "ckpt")).restore_latest()["step"]) == 4


HANG = """
import json, os, signal, sys, time
import torch
torch.set_num_threads(1)
from autodist_tpu_torch.api import AutoDist
from autodist_tpu_torch.ft import FTConfig, resume_from_snapshot
from autodist_tpu_torch.strategy import AllReduce

out = os.environ["AUTODIST_TEST_OUT"]
restart = len([n for n in os.listdir(out) if n.startswith("start-")]) // 2
with open(os.path.join(out, f"start-{restart}-{os.environ['RANK']}"), "w"):
    pass
if restart == 2:
    sys.exit(0)                              # the third attempt completes
ad = AutoDist(strategy_builder=AllReduce(), device="cpu", timeout_s=120,
              fault_tolerance=FTConfig(heartbeat_interval_s=0.1, snapshot_every_steps=1,
                                       snapshot_on_preempt=False))
rank = torch.distributed.get_rank()
doctor = os.path.join(os.environ["AUTODIST_FT_DIR"], "doctor")

def on_term(sig, frame):
    # What the launcher had written when it terminated this rank.
    names = sorted(os.listdir(doctor)) if os.path.isdir(doctor) else []
    with open(os.path.join(out, f"term-{restart}-{rank}.json"), "w") as f:
        json.dump({"bundles": names, "t": time.time()}, f)
    os._exit(143)

signal.signal(signal.SIGTERM, on_term)

def loss_fn(params, batch):
    return ((batch["x"] @ params["w"]) ** 2).mean()

params = {"w": torch.ones(4, 2)}
batch = {"x": torch.ones(8, 4) / 4.0}
step = ad.build(loss_fn, params, batch)
state = resume_from_snapshot(step, params, ad.ft.snapshots)
for _ in range(2):
    state, _ = step(state, batch)
    ad.ft.maybe_snapshot(state, step_obj=step)
    ad.ft.snapshots.wait()
torch.distributed.barrier()
if rank == 1:
    ad.ft.monitor.stop()                     # alive, silent
    with open(os.path.join(out, f"silent-{restart}.json"), "w") as f:
        json.dump({"t": time.time()}, f)
    time.sleep(600)
state, _ = step(state, batch)                # held in the collective by rank 1
"""


def test_hang_watchdog_kills_after_bundle_and_budget_resets(tmp_path, fleet_env,
                                                            monkeypatch):
    from autodist_tpu_torch.ft import FTConfig, latest_snapshot_step

    script = tmp_path / "hang.py"
    script.write_text(HANG)
    out = tmp_path / "out"
    out.mkdir()
    monkeypatch.setenv("AUTODIST_TEST_OUT", str(out))
    monkeypatch.setattr(L, "KILL_GRACE_S", 2.0)
    codes, real_launch = [], L.launch

    def recorded(*a, **k):
        codes.append(real_launch(*a, **k))
        return codes[-1]

    monkeypatch.setattr(L, "launch", recorded)
    cfg = FTConfig(base_dir=str(tmp_path / "ft"), heartbeat_interval_s=0.1,
                   hang_after_misses=10)
    rc = L.launch_supervised(None, [sys.executable, str(script)], max_restarts=1,
                             num_local_processes=2, coordinator_port=_free_port(),
                             restart_backoff_s=0.05, ft_config=cfg)
    # Two hung attempts, each advancing the snapshot ring by 2 steps, then
    # a clean one: a budget of 1 restart lasts because progress resets it.
    assert rc == 0
    assert codes[:2] != [0, 0] and all(c != 0 for c in codes[:2]) and codes[2] == 0
    assert latest_snapshot_step(str(tmp_path / "ft" / "snapshots")) == 4
    doctor = tmp_path / "ft" / "doctor"
    bundles = sorted(os.listdir(doctor))
    assert len(bundles) == 2
    window = cfg.hang_after_misses * cfg.heartbeat_interval_s
    for attempt, name in enumerate(bundles):
        term = json.loads((out / f"term-{attempt}-1.json").read_text())
        assert name in term["bundles"], "rank 1 was terminated before the bundle was written"
        silent = json.loads((out / f"silent-{attempt}.json").read_text())["t"]
        written = json.loads((doctor / name).read_text())["written_at"]
        # Killed within hang_after_misses intervals of the last beat (which
        # came up to a stop() before the silence was stamped), plus a tick.
        assert window <= written - silent + 3 * cfg.heartbeat_interval_s
        assert written - silent <= window + 3 * cfg.heartbeat_interval_s + 1.0
        assert term["t"] >= written
    bundle = json.loads((doctor / bundles[-1]).read_text())
    assert set(bundle) == {"written_at", "reason", "verdict", "hang_after_misses",
                           "heartbeat_interval_s", "heartbeats", "launcher_spans"}
    assert "1" in bundle["heartbeats"] and bundle["reason"].startswith("ranks_silent")


def test_fleet_watch_bundle_keys_equal_jax(tmp_path):
    """The port's bundle of a silent fleet and JAX's, on the same stale
    heartbeats, carry the same keys, verdict and per-peer records."""
    from autodist_tpu.ft import FTConfig as JFTConfig
    from autodist_tpu.runtime.launcher import _FleetWatch as JWatch
    from autodist_tpu_torch.ft import FTConfig
    from autodist_tpu_torch.ft.heartbeat import FileTransport

    bundles, stale = [], time.time() - 600.0
    for mk_cfg, Watch, base in ((FTConfig, L._FleetWatch, tmp_path / "port"),
                                (JFTConfig, JWatch, tmp_path / "jax")):
        watch = Watch(mk_cfg(base_dir=str(base), heartbeat_interval_s=1.0,
                             hang_after_misses=5))
        hb = FileTransport(os.path.join(str(base), "heartbeats"))
        for pid in range(2):
            hb.publish(pid, {"time": stale, "step": 42})
        watch.monitor.tick()
        assert watch.monitor.fleet_hung()
        bundles.append(json.loads(open(watch.write_bundle()).read()))
    port, jax_ = bundles
    assert set(port) == set(jax_)
    assert port["verdict"] == jax_["verdict"]
    for pid in ("0", "1"):
        assert {k: v for k, v in port["heartbeats"][pid].items() if k != "last_seen"} \
            == {k: v for k, v in jax_["heartbeats"][pid].items() if k != "last_seen"}
