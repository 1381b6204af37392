"""Port parity: the per-host step-time aggregator (``obs/aggregate.py``)
against the JAX package's, on the same observations.

Quantiles, straggler scores, gauges and the escalation into a health
monitor (once per straggle episode, and with a monitor attached late) equal
JAX's (``tests/test_obs.py:361-420``); the ``obs.aggregate.sweep`` chaos
seam slows a host's swept quantiles in both packages; the daemon thread
publishes and stops; a straggler escalates both packages' ``HealthMonitor``
to SUSPECT while it keeps beating.
"""
import time

import pytest

from autodist_tpu import metrics as JM
from autodist_tpu.chaos import hooks as jhooks
from autodist_tpu.ft.heartbeat import HealthMonitor as JMonitor
from autodist_tpu.ft.heartbeat import MemoryTransport as JTransport
from autodist_tpu.ft.heartbeat import PeerState as JPeer
from autodist_tpu.obs.aggregate import HostAggregator as JAggregator
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.chaos import hooks
from autodist_tpu_torch.ft import HealthMonitor, MemoryTransport
from autodist_tpu_torch.ft.heartbeat import PeerState
from autodist_tpu_torch.obs import HostAggregator
from autodist_tpu_torch.utils import retry

PKGS = {"port": (HostAggregator, MemoryTransport, M.MetricsRegistry),
        "jax": (JAggregator, JTransport, JM.MetricsRegistry)}
GAUGES = ("obs_fleet_hosts", "obs_fleet_step_p50_s", "obs_host_step_p50_s",
          "obs_straggler_score", "obs_straggler_score_max",
          "obs_straggler_escalations_total")


class _Mon:
    def __init__(self):
        self.escalations = []

    def escalate(self, pid, reason=""):
        self.escalations.append((pid, reason))


def _pair(pkg, fast=0.10, slow=0.45, clock=lambda: 100.0):
    agg_cls, tr_cls, reg_cls = PKGS[pkg]
    transport, reg = tr_cls(), reg_cls()
    a = agg_cls(transport, process_id=0, registry=reg, clock=clock)
    b = agg_cls(transport, process_id=1, registry=reg_cls(), clock=clock)
    for i in range(16):
        a.observe_step(fast + 0.001 * i)
        b.observe_step(slow + 0.002 * i)
    return a, b, reg


def _run(pkg):
    a, b, reg = _pair(pkg)
    b.tick()
    mon = _Mon()
    a.monitor = mon
    for _ in range(a.escalate_after):
        a.tick()
    out = {"quantiles": (a.quantiles(), b.quantiles()), "scores": a.straggler_scores(),
           "stragglers": a.stragglers(), "escalations": list(mon.escalations),
           "snap": {k: reg.snapshot()[k] for k in GAUGES}}
    a.tick()                                   # once per straggle episode
    out["after"] = list(mon.escalations)
    return out


def test_scores_quantiles_escalation_equal_jax():
    port, ref = _run("port"), _run("jax")
    assert port == ref
    scores = port["scores"]
    assert scores[1] > 1.5 > scores[0]
    assert port["stragglers"] == [1]
    assert len(port["escalations"]) == 1 and port["escalations"][0][0] == 1
    assert "straggler" in port["escalations"][0][1]
    assert port["snap"]["obs_fleet_hosts"] == 2
    assert port["snap"]["obs_straggler_score_max"] == pytest.approx(scores[1])
    assert port["snap"]["obs_straggler_escalations_total"] == 1
    assert port["after"] == port["escalations"]


def test_late_attached_monitor_escalates_once_equal_jax():
    seen = {}
    for pkg in PKGS:
        a, b, _ = _pair(pkg, fast=0.1, slow=0.5)
        b.tick()
        for _ in range(a.escalate_after + 2):    # the counter passes the bar
            a.tick()
        mon = _Mon()
        a.monitor = mon                          # late attach
        a.tick()
        a.tick()
        seen[pkg] = [pid for pid, _ in mon.escalations]
    assert seen["port"] == seen["jax"] == [1]


def test_recovery_rearms_the_episode_equal_jax():
    seen = {}
    for pkg in PKGS:
        a, b, _ = _pair(pkg)
        mon = _Mon()
        a.monitor = mon
        b.tick()
        for _ in range(a.escalate_after):
            a.tick()
        for _ in range(256):                     # host 1 recovers
            b.observe_step(0.10)
        b.tick()
        a.tick()
        for _ in range(256):                     # and straggles again
            b.observe_step(0.60)
        b.tick()
        for _ in range(a.escalate_after):
            a.tick()
        seen[pkg] = [pid for pid, _ in mon.escalations]
    assert seen["port"] == seen["jax"] == [1, 1]


def test_empty_and_single_host_equal_jax():
    seen = {}
    for pkg, (agg_cls, tr_cls, reg_cls) in PKGS.items():
        reg = reg_cls()
        a = agg_cls(tr_cls(), process_id=3, registry=reg)
        empty = (a.quantiles(), a.tick(now=5.0), a.straggler_scores(), a.stragglers())
        a.observe_step(0.2)
        one = a.tick(now=6.0)
        seen[pkg] = (empty, one, a.straggler_scores(), reg.snapshot()["obs_fleet_hosts"])
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == ({}, {}, {}, [])
    assert seen["port"][2] == {3: 1.0}


@pytest.mark.parametrize("factor", [3.0, 1.0])
def test_chaos_sweep_seam_slows_a_host_equal_jax(factor):
    seen = {}
    for pkg, registry in (("port", hooks), ("jax", jhooks)):
        owner = object()

        def slow_host(fleet, **_):
            return {pid: (dict(s, p50=s["p50"] * factor) if pid == 2 else s)
                    for pid, s in fleet.items()}

        registry.install(registry.SEAM_AGG_SWEEP, slow_host, owner=owner)
        try:
            agg_cls, tr_cls, reg_cls = PKGS[pkg]
            transport = tr_cls()
            aggs = [agg_cls(transport, process_id=p, registry=reg_cls(),
                            clock=lambda: 7.0) for p in range(3)]
            for agg in aggs:
                for _ in range(8):
                    agg.observe_step(0.1)
                agg.tick()
            aggs[0].tick()                       # sweeps every host's summary
            seen[pkg] = aggs[0].straggler_scores()
        finally:
            registry.clear(owner)
    assert seen["port"] == seen["jax"]
    assert seen["port"][2] == pytest.approx(factor)


def test_daemon_thread_publishes_and_stops():
    transport = MemoryTransport()
    agg = HostAggregator(transport, process_id=4, registry=M.MetricsRegistry(),
                         interval_s=0.01)
    agg.observe_step(0.25)
    agg.start()
    assert agg.start() is agg                    # idempotent
    try:
        assert retry.wait_until(lambda: 4 in transport.sweep(), 5.0, interval_s=0.01)
        assert transport.sweep()[4]["p50"] == 0.25
    finally:
        agg.stop()
    assert agg._thread is None


def test_straggler_escalates_health_monitor_equal_jax():
    """A straggler that keeps beating is escalated to SUSPECT in both
    packages' observer monitors; its next fresh beat clears it."""
    seen = {}
    for pkg, (agg_cls, tr_cls, reg_cls), (mon_cls, peer) in (
            ("port", PKGS["port"], (HealthMonitor, PeerState)),
            ("jax", PKGS["jax"], (JMonitor, JPeer))):
        hb = tr_cls()
        mon = mon_cls(hb, publish=False, expected=[0, 1], registry=reg_cls())
        for pid in (0, 1):
            hb.publish(pid, {"time": time.time()})
        mon.tick()
        a, b, _ = _pair(pkg)
        a.monitor = mon
        b.tick()
        for _ in range(a.escalate_after):
            a.tick()
        states = [mon.peers()[1].state is peer.SUSPECT]
        hb.publish(1, {"time": time.time() + 1.0})
        mon.tick()
        states.append(mon.peers()[1].state is peer.HEALTHY)
        seen[pkg] = states
    assert seen["port"] == seen["jax"] == [True, True]
