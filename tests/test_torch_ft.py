"""The port's fault tolerance against the JAX package's (``tests/test_ft.py``
and ``tests/test_obs.py``'s cases that need no serving):

- heartbeats: a JAX and a port :class:`HealthMonitor` driven side by side
  through ``tick`` by one synthetic clock and one scripted beat schedule
  (``MemoryTransport``): every transition, state, verdict and hang answer
  equal at every tick; the file transport read across the packages; the
  port's c10d-store transport (sequence keys, a per-peer latest pointer,
  the newest payload time wins);
- snapshots across packages: a port snapshot verifies under JAX's
  ``SnapshotManager.verify`` and restores through JAX's
  ``restore_latest_valid``, and the reverse, bitwise; a corrupt newest
  entry falls back to the previous ring entry in both;
- the ring (prune, verify, skip when busy, cadence), the preemption hook,
  and SIGTERM during a train step: the hook defers to the step boundary,
  and the snapshot equals the state there, never a torn one;
- ``AutoDist(fault_tolerance=...)``, the supervisor's progress reset, and
  ``procdrain``.
"""
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from autodist_tpu import metrics as JM
from autodist_tpu.ft import FTConfig as JFTConfig
from autodist_tpu.ft import HealthMonitor as JHealthMonitor
from autodist_tpu.ft import MemoryTransport as JMemoryTransport
from autodist_tpu.ft import SnapshotManager as JSnapshotManager
from autodist_tpu.ft import latest_snapshot_step as jlatest_snapshot_step
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.ft import (
    CoordinatorTransport,
    FileTransport,
    FleetVerdict,
    FTConfig,
    HealthMonitor,
    MemoryTransport,
    SnapshotManager,
    latest_snapshot_step,
)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture(scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- heartbeats
#: Scripted schedules: (clock advance before the tick, peers beating at
#: the tick's time, external escalations before the tick).
SCHEDULES = {
    "silence_to_dead_and_back": [(0.0, [1, 2], [])] + [(2.5, [2], [])]
    + [(8.0, [2], [])] * 5 + [(1.0, [1, 2], [])],
    "transient_miss": [(0.0, [1], []), (2.5, [], []), (0.3, [1], []), (1.0, [1], [])],
    "flapping": [(0.0, [1, 2, 3], [])] + [(1.7, [1, 2, 3][: 1 + i % 3], []) for i in range(14)],
    "escalated_straggler": [(0.0, [1, 2], []), (0.5, [1, 2], [2]), (0.5, [1], []),
                            (3.0, [1], []), (8.0, [1], []), (8.0, [1], []),
                            (1.0, [1, 2], [])],
    "whole_fleet_silent": [(0.0, [1, 2], [])] + [(5.0, [], [])] * 6,
}


def _pair(expected=None, **cfg_kw):
    cfg = dict(heartbeat_interval_s=1.0, suspect_after_misses=2, dead_after_misses=4,
               backoff_max_s=8.0, hang_after_misses=6, **cfg_kw)
    clock = {"t": 100.0}
    sides = []
    for Cfg, Mon, Transport, reg in ((FTConfig, HealthMonitor, MemoryTransport,
                                      M.MetricsRegistry()),
                                     (JFTConfig, JHealthMonitor, JMemoryTransport,
                                      JM.MetricsRegistry())):
        transport = Transport()
        mon = Mon(transport, process_id=0, config=Cfg(**cfg), expected=expected,
                  registry=reg, clock=lambda: clock["t"])
        log = []
        mon.on_transition(lambda pid, old, new, log=log: log.append(
            (pid, old.value, new.value)))
        sides.append((mon, transport, log))
    return sides, clock


def _view(mon):
    return ({pid: (p.state.value, p.misses, p.backoff_s, p.last_seen)
             for pid, p in mon.peers().items()},
            mon.verdict().value, mon.fleet_hung(), mon.surviving(),
            mon.max_observed_step())


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("expected", [None, [0, 1, 2, 3]])
def test_monitor_transitions_equal_jax(name, expected):
    sides, clock = _pair(expected)
    for i, (dt, beating, escalate) in enumerate(SCHEDULES[name]):
        clock["t"] += dt
        for mon, transport, _ in sides:
            for pid in escalate:
                mon.escalate(pid, reason="straggler")
            for pid in beating:
                transport.publish(pid, {"time": clock["t"], "step": i})
            mon.tick()
        (port, _, plog), (jax_, _, jlog) = sides
        assert plog == jlog, f"tick {i}"
        assert _view(port) == _view(jax_), f"tick {i}"
    assert sides[0][2], "the schedule made no transition"


def test_monitor_gauges_and_progress():
    reg = M.MetricsRegistry()
    clock = {"t": 50.0}
    transport = MemoryTransport()
    mon = HealthMonitor(transport, process_id=0, config=FTConfig(heartbeat_interval_s=1.0),
                        registry=reg, clock=lambda: clock["t"])
    mon.set_step(17)
    transport.publish(1, {"time": 50.0, "step": 9})
    mon.tick()
    snap = reg.snapshot()
    assert snap["ft_peers_healthy"] == 1 and snap["ft_heartbeats_sent_total"] == 1
    assert mon.max_observed_step() == 17


def test_stalled_peers_names_a_silent_rank_while_others_beat():
    clock = {"t": 0.0}
    transport = MemoryTransport()
    mon = HealthMonitor(transport, publish=False, clock=lambda: clock["t"],
                        config=FTConfig(heartbeat_interval_s=1.0, hang_after_misses=3))
    for t in range(6):
        clock["t"] = 100.0 + t
        transport.publish(0, {"time": clock["t"]})
        if t == 0:
            transport.publish(1, {"time": 100.0})
        mon.tick()
    assert mon.stalled_peers() == [1] and not mon.fleet_hung()


def test_monitor_thread_lifecycle():
    transport = MemoryTransport()
    mon = HealthMonitor(transport, process_id=3, config=FTConfig(heartbeat_interval_s=0.02),
                        registry=M.MetricsRegistry())
    mon.start()
    deadline = time.monotonic() + 5.0
    while 3 not in transport.sweep() and time.monotonic() < deadline:
        time.sleep(0.01)
    mon.stop()
    assert 3 in transport.sweep()


def test_file_transport_reads_across_packages(tmp_path):
    from autodist_tpu.ft import FileTransport as JFileTransport

    FileTransport(str(tmp_path)).publish(0, {"time": 1.0, "step": 4})
    JFileTransport(str(tmp_path)).publish(7, {"time": 2.0})
    for transport in (FileTransport(str(tmp_path)), JFileTransport(str(tmp_path))):
        beats = transport.sweep()
        assert set(beats) == {0, 7} and beats[0]["step"] == 4


def test_coordinator_transport_on_a_c10d_store():
    import socket

    from torch.distributed import TCPStore

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = TCPStore("127.0.0.1", port, 2, True, wait_for_workers=False)
    client = TCPStore("127.0.0.1", port, 2, False)
    a = CoordinatorTransport(store=server, world_size=2)
    b = CoordinatorTransport(store=client, world_size=2)
    a.publish(0, {"time": 10.0, "step": 1})
    b.publish(1, {"time": 11.0, "step": 2})
    b.publish(1, {"time": 12.0, "step": 3})
    assert a.sweep() == {0: {"time": 10.0, "step": 1}, 1: {"time": 12.0, "step": 3}}
    # The previous beat's key is gone; only the pointer and the newest stay.
    seq = client.get("ft/hb/1/latest").decode()
    assert client.check([f"ft/hb/1/{seq}"])
    assert not client.check([f"ft/hb/1/{int(seq) - 1:015d}"])
    # A stale incarnation's older write never moves the view back.
    stale = CoordinatorTransport(store=client, world_size=2)
    stale._seq = 10 ** 14
    stale.publish(1, {"time": 5.0, "step": 0})
    assert a.sweep()[1]["step"] == 3
    # The monitor classifies through it like through any transport.
    clock = {"t": 12.5}
    mon = HealthMonitor(a, publish=False, clock=lambda: clock["t"],
                        config=FTConfig(heartbeat_interval_s=1.0))
    mon.tick()
    assert mon.verdict() is FleetVerdict.HEALTHY


def test_coordinator_transport_without_a_group_names_roadmap():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        CoordinatorTransport()


# -------------------------------------------------- snapshots across packages
def _tree(s):
    base = np.arange(12, dtype=np.float32).reshape(3, 4)
    return {"params": {"w": base + s, "b": np.full(4, s, np.float32)}, "step": s}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: np.asarray(v)})
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_snapshots_read_across_packages(tmp_path, writer):
    def port_tree(s):
        t = _tree(s)
        return {"params": {k: torch.from_numpy(v) for k, v in t["params"].items()},
                "step": s}

    if writer == "port":
        mgr = SnapshotManager(str(tmp_path), keep=2, registry=M.MetricsRegistry())
        for s in (1, 2, 3):
            mgr.snapshot(port_tree(s), step=s, block=True)
    else:
        mgr = JSnapshotManager(str(tmp_path), keep=2, registry=JM.MetricsRegistry())
        for s in (1, 2, 3):
            mgr.snapshot(_tree(s), step=s, block=True)
    assert sorted(os.listdir(tmp_path)) == ["ckpt-2", "ckpt-3"]
    port = SnapshotManager(str(tmp_path), registry=M.MetricsRegistry())
    jax_ = JSnapshotManager(str(tmp_path), registry=JM.MetricsRegistry())
    assert latest_snapshot_step(str(tmp_path)) == jlatest_snapshot_step(str(tmp_path)) == 3
    for mgr in (port, jax_):
        assert mgr.verify(str(tmp_path / "ckpt-3"))
        assert mgr.latest_valid().endswith("ckpt-3")
    want = _flat(_tree(3))
    got_port = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
                for k, v in _flat(port.restore_latest_valid()).items()}
    got_jax = _flat(jax_.restore_latest_valid())
    for got in (got_port, got_jax):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got[k].tobytes() == want[k].astype(got[k].dtype).tobytes()

    # Corrupt the newest: both packages fall back to ckpt-2.
    victim = tmp_path / "ckpt-3" / "params" / "w.npy"
    blob = bytearray(victim.read_bytes())
    blob[-4:] = b"\xff\xff\xff\xff"
    victim.write_bytes(bytes(blob))
    reg, jreg = M.MetricsRegistry(), JM.MetricsRegistry()
    port = SnapshotManager(str(tmp_path), registry=reg)
    jax_ = JSnapshotManager(str(tmp_path), registry=jreg)
    for mgr in (port, jax_):
        assert not mgr.verify(str(tmp_path / "ckpt-3"))
        assert mgr.latest_valid().endswith("ckpt-2")
    np.testing.assert_array_equal(port.restore_latest_valid()["params"]["w"].numpy(),
                                  _tree(2)["params"]["w"])
    np.testing.assert_array_equal(np.asarray(jax_.restore_latest_valid()["params"]["w"]),
                                  _tree(2)["params"]["w"])
    assert reg.snapshot()["ft_snapshots_corrupt_total"] >= 1


def test_missing_manifest_is_invalid(tmp_path):
    mgr = SnapshotManager(str(tmp_path), registry=M.MetricsRegistry())
    mgr.snapshot({"w": torch.zeros(3)}, step=1, block=True)
    os.remove(tmp_path / "ckpt-1" / "MANIFEST.json")
    assert mgr.latest_valid() is None and mgr.restore_latest_valid() is None


def test_async_snapshot_overlaps_and_skips_when_busy(tmp_path):
    reg = M.MetricsRegistry()
    mgr = SnapshotManager(str(tmp_path), keep=4, registry=reg)
    big = {"w": torch.zeros(256, 256)}
    assert mgr.snapshot(big, step=1) is not None        # returns at once
    mgr._worker.join(timeout=0)                          # still busy, or done
    second = mgr.snapshot(big, step=2)
    mgr.wait()
    assert (second is None) == (reg.snapshot().get("ft_snapshots_skipped_total", 0) == 1)
    assert mgr.latest_valid() is not None


def test_snapshot_copies_the_state_before_it_returns(tmp_path):
    """The device→host copy is complete on return: a later in-place update
    (the next step's) does not reach the snapshot."""
    mgr = SnapshotManager(str(tmp_path), registry=M.MetricsRegistry())
    w = torch.ones(64, 64)
    mgr.snapshot({"w": w}, step=1)
    w.add_(1.0)
    mgr.wait()
    assert torch.equal(mgr.restore_latest_valid()["w"], torch.ones(64, 64))
    assert mgr.last_timing["bytes"] == 64 * 64 * 4


def test_maybe_snapshot_cadence(tmp_path):
    mgr = SnapshotManager(str(tmp_path), every_steps=2, registry=M.MetricsRegistry())
    tree = {"w": torch.zeros(3)}
    assert mgr.maybe_snapshot(tree, step=0) is not None
    mgr.wait()
    assert mgr.maybe_snapshot(tree, step=1) is None
    assert mgr.maybe_snapshot(tree, step=2) is not None
    mgr.wait()


@pytest.fixture
def sigterm_guard():
    """A chained Python SIGTERM handler recording deliveries, restored after."""
    chained = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: chained.append(s))
    yield chained
    signal.signal(signal.SIGTERM, prev)


def test_preempt_hook_forces_final_snapshot_between_steps(tmp_path, sigterm_guard):
    mgr = SnapshotManager(str(tmp_path), registry=M.MetricsRegistry())
    state = {"w": torch.full((4,), 7.0)}
    mgr.register_state_provider(lambda: (state, 5))
    mgr.install_preempt_hook()
    os.kill(os.getpid(), signal.SIGTERM)
    assert mgr.preempted and sigterm_guard == [signal.SIGTERM]
    assert latest_snapshot_step(str(tmp_path)) == 5
    np.testing.assert_array_equal(mgr.restore_latest_valid()["w"].numpy(), 7.0)


def _dense_step(device="cpu"):
    from autodist_tpu_torch.api import AutoDist
    from autodist_tpu_torch.model_item import OptimizerSpec
    from autodist_tpu_torch.strategy import AllReduce

    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal(4).astype(np.float32))}
    batch = (torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32)),
             torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32)))
    hits = {"n": 0, "at": None}

    def loss_fn(p, b):
        x, y = b
        hits["n"] += 1
        if hits["n"] == hits["at"]:
            os.kill(os.getpid(), signal.SIGTERM)         # mid-step: forward done soon
        return torch.mean((x @ p["w"] + p["b"] - y) ** 2)

    AutoDist.reset_default()
    try:
        ad = AutoDist(strategy_builder=AllReduce(), device=device)
        step = ad.build(loss_fn, params, batch,
                        optimizer=OptimizerSpec("adam", {"learning_rate": 0.1}))
    finally:
        AutoDist.reset_default()
    return step, params, batch, hits


def test_sigterm_during_a_step_never_writes_a_torn_snapshot(tmp_path, sigterm_guard):
    """SIGTERM lands inside step 3 (in its loss): the hook takes nothing
    then; the next ``maybe_snapshot`` at the step boundary writes step 3's
    state, bitwise the state there, then re-delivers the signal."""
    from autodist_tpu_torch.ft import FTRuntime

    step, params, batch, hits = _dense_step()
    ft = FTRuntime(FTConfig(base_dir=str(tmp_path), snapshot_every_steps=100,
                            heartbeat_interval_s=0.05),
                   registry=M.MetricsRegistry(), start_monitor=False)
    try:
        state = step.init(params)
        hits["n"] = 0
        for i in range(1, 6):
            if i == 3:
                hits["at"] = hits["n"] + 1
            state, _ = step(state, batch)
            if i == 3:
                assert ft.snapshots.preempted and sigterm_guard == []
                assert latest_snapshot_step(ft.config.snapshot_dir) == 1  # nothing new
                boundary = {k: v.clone() for k, v in step.logical_params(state).items()}
                slots = [t.clone() for t in state.opt_state["mu"]]
            ft.maybe_snapshot(state, step_obj=step)
            ft.snapshots.wait()
            if i == 3:
                assert sigterm_guard == [signal.SIGTERM]       # re-delivered
                assert latest_snapshot_step(ft.config.snapshot_dir) == 3
        path = os.path.join(ft.config.snapshot_dir, "ckpt-3")
        from autodist_tpu_torch.checkpoint import Saver

        snap = Saver().restore(path)
        assert int(snap["step"]) == 3
        for name, want in boundary.items():
            assert torch.equal(snap["params"][name], want), name
        mu = snap["opt_state"]["0"]["mu"]
        assert torch.equal(mu["b"], slots[0]) and torch.equal(mu["w"], slots[1])
    finally:
        ft.shutdown()
        ft.snapshots._prev_handler = None


def test_preempt_hook_defers_when_the_registered_state_was_stepped_past(
        tmp_path, sigterm_guard):
    """A signal between steps after the loop stepped past the registered
    state (its tensors updated in place, its step number stale) defers too."""
    from autodist_tpu_torch.ft import FTRuntime

    step, params, batch, _ = _dense_step()
    ft = FTRuntime(FTConfig(base_dir=str(tmp_path), snapshot_every_steps=100),
                   registry=M.MetricsRegistry(), start_monitor=False)
    try:
        state = step.init(params)
        state, _ = step(state, batch)
        ft.maybe_snapshot(state, step_obj=step)           # registers step 1
        ft.snapshots.wait()
        state, _ = step(state, batch)                     # stepped past it
        os.kill(os.getpid(), signal.SIGTERM)
        assert sigterm_guard == [] and latest_snapshot_step(ft.config.snapshot_dir) == 1
        ft.maybe_snapshot(state, step_obj=step)
        assert sigterm_guard == [signal.SIGTERM]
        assert latest_snapshot_step(ft.config.snapshot_dir) == 2
    finally:
        ft.shutdown()
        ft.snapshots._prev_handler = None


# --------------------------------------------------------------- api seam
def test_autodist_fault_tolerance_seam(tmp_path):
    from autodist_tpu_torch.api import AutoDist
    from autodist_tpu_torch.strategy import AllReduce

    step, params, batch, _ = _dense_step()
    AutoDist.reset_default()
    try:
        ad = AutoDist(strategy_builder=AllReduce(), device="cpu", fault_tolerance=FTConfig(
            base_dir=str(tmp_path), heartbeat_interval_s=0.05, snapshot_every_steps=1,
            snapshot_on_preempt=False))
        assert ad.ft is not None
        step = ad.build(step.loss_fn, params, batch)
        state = step.init(params)
        state, _ = step(state, batch)
        assert ad.ft.maybe_snapshot(state, step_obj=step) is not None
        ad.ft.snapshots.wait()
        assert latest_snapshot_step(str(tmp_path / "snapshots")) == 1
        deadline = time.monotonic() + 5.0
        while not list((tmp_path / "heartbeats").glob("hb-*.json")) \
                and time.monotonic() < deadline:
            time.sleep(0.02)
        assert list((tmp_path / "heartbeats").glob("hb-0.json"))
        ad.ft.shutdown()
    finally:
        AutoDist.reset_default()


def test_launcher_progress_resets_restart_budget(tmp_path, monkeypatch):
    from autodist_tpu_torch.runtime import launcher

    cfg = FTConfig(base_dir=str(tmp_path))
    snap_dir = cfg.resolved().snapshot_dir
    calls = {"n": 0}

    def fake_launch(*a, **k):
        calls["n"] += 1
        if calls["n"] < 4:
            SnapshotManager(snap_dir, registry=M.MetricsRegistry()).snapshot(
                {"w": torch.zeros(2)}, step=calls["n"], block=True)
            return 1
        return 0

    monkeypatch.setattr(launcher, "launch", fake_launch)
    assert launcher.launch_supervised(None, ["true"], max_restarts=1,
                                      restart_backoff_s=0.0, ft_config=cfg) == 0
    assert calls["n"] == 4
    calls["n"] = 0
    monkeypatch.setattr(launcher, "launch", lambda *a, **k: (
        calls.__setitem__("n", calls["n"] + 1) or 1))
    assert launcher.launch_supervised(None, ["true"], max_restarts=1,
                                      restart_backoff_s=0.0, ft_config=cfg) == 1
    assert calls["n"] == 2


def test_procdrain_sigterm_then_kill():
    from autodist_tpu_torch.ft import procdrain

    def child(code):
        proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, start_new_session=True)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if proc.stdout.readline().startswith("up"):
                break
        return proc

    proc = child("import signal, sys, time\n"
                 "signal.signal(signal.SIGTERM, lambda s, f: sys.exit(0))\n"
                 "print('up', flush=True)\ntime.sleep(60)\n")
    procdrain.stop_gracefully(proc, grace_s=15.0)
    assert proc.returncode == 0
    proc = child("import signal, time\nsignal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
                 "print('up', flush=True)\ntime.sleep(60)\n")
    procdrain.stop_gracefully(proc, grace_s=0.5)
    assert proc.returncode not in (None, 0)


def test_ft_config_equals_jax():
    import dataclasses

    port, jax_ = FTConfig(base_dir="/b"), JFTConfig(base_dir="/b")
    assert dataclasses.asdict(port.resolved()) == dataclasses.asdict(jax_.resolved())
