"""Port parity: the anomaly sentry (``obs/sentry.py``) against the JAX
package's.

The feeds of ``tests/test_obs_sentry.py:32-115`` and
``tests/test_serve_slo.py:199-300`` go into both packages' ``Sentry``:
findings must match in code, message, value, step and process id, fire once
per episode and re-arm the same way; escalation reaches each package's
``HealthMonitor`` alike and findings land in each package's flight record.
"""
from types import SimpleNamespace

import pytest

from autodist_tpu import metrics as JM
from autodist_tpu.ft import FTConfig as JFTConfig
from autodist_tpu.ft.heartbeat import HealthMonitor as JMonitor
from autodist_tpu.ft.heartbeat import MemoryTransport as JTransport
from autodist_tpu.obs import recorder as jrecorder
from autodist_tpu.obs import sentry as jsentry
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.ft import FTConfig, HealthMonitor, MemoryTransport, PeerState
from autodist_tpu_torch.obs import CODES, Sentry, SentryConfig
from autodist_tpu_torch.obs import recorder

NAN, INF = float("nan"), float("inf")


def _pair(**kw):
    cfg = kw.pop("config", None)
    port = Sentry(config=SentryConfig(**cfg) if cfg else None,
                  registry=M.MetricsRegistry(), **kw)
    ref = jsentry.Sentry(config=jsentry.SentryConfig(**cfg) if cfg else None,
                         registry=JM.MetricsRegistry(), **kw)
    return port, ref


def _key(f):
    value = f.value if f.value == f.value else "nan"
    return (f.code, f.message, value, f.step, f.process_id)


def _same_findings(port, ref):
    assert [_key(f) for f in port.findings] == [_key(f) for f in ref.findings]
    assert port.codes() == ref.codes() and port.summary() == ref.summary()


TRAIN_FEEDS = {
    "clean": lambda s: ([s.observe_step(step=i, loss=2.0 - 0.005 * i, step_time_s=0.1,
                                        hbm_bytes=8e9, grad_norm=1.0, update_norm=0.01)
                         for i in range(128)], s.observe_scores({0: 1.0, 1: 1.1, 2: 0.95})),
    "nan_loss": lambda s: [s.observe_step(step=i, step_time_s=0.1,
                                          loss=NAN if i >= 20 else 2.0) for i in range(24)],
    "inf_grad": lambda s: [s.observe_step(step=i, loss=2.0, step_time_s=0.1,
                                          grad_norm=INF if i == 20 else 1.0)
                           for i in range(24)],
    "loss_spike": lambda s: [s.observe_step(step=i, step_time_s=0.1,
                                            loss=90.0 if i == 20 else 2.0 + 0.01 * (i % 3))
                             for i in range(24)],
    "step_time": lambda s: [s.observe_step(step=i, loss=2.0,
                                           step_time_s=0.5 if i >= 16 else 0.1)
                            for i in range(24)],
    "hbm_creep": lambda s: [s.observe_step(step=i, loss=2.0, step_time_s=0.1,
                                           hbm_bytes=8e9 * (1 + max(0, i - 8) * 0.02))
                            for i in range(24)],
    "lagging_host": lambda s: [s.observe_scores({0: 1.0, 1: 1.02, 2: 2.4}, step=i)
                               for i in range(4)],
    "flat_noise": lambda s: ([s.observe_step(step=i, loss=2.0) for i in range(16)],
                             s.observe_step(step=16, loss=2.0 + 1e-9),
                             s.observe_step(step=17, loss=2.5)),
    "episodes": lambda s: ([s.observe_step(step=i, loss=2.0) for i in range(12)],
                           [s.observe_step(step=i, loss=NAN) for i in range(12, 20)],
                           [s.observe_step(step=i, loss=2.0) for i in range(20, 30)],
                           s.observe_step(step=30, loss=NAN)),
}
WANT_TRAIN = {"clean": [], "nan_loss": ["SNT001"], "inf_grad": ["SNT002"],
              "loss_spike": ["SNT003"], "step_time": ["SNT004"], "hbm_creep": ["SNT005"],
              "lagging_host": ["SNT006"], "flat_noise": ["SNT003"],
              "episodes": ["SNT001", "SNT001"]}


@pytest.mark.parametrize("name", sorted(TRAIN_FEEDS))
def test_training_feeds_equal_jax(name):
    port, ref = _pair(config=dict(min_history=8, hbm_min_history=8), process_id=0)
    TRAIN_FEEDS[name](port)
    TRAIN_FEEDS[name](ref)
    _same_findings(port, ref)
    assert [f.code for f in port.findings] == WANT_TRAIN[name]


def _serve(s, rid, values, kind):
    for v in values:
        s.observe_serve(replica_id=rid, **{kind: v})


SERVE_FEEDS = {
    "clean": lambda s: [s.observe_serve(ttft_s=0.2, itl_s=0.02, burn_rate=0.1, replica_id=1)
                        for _ in range(64)],
    "ttft": lambda s: (_serve(s, 0, [0.2] * 12, "ttft_s"), _serve(s, 0, [5.0] * 4, "ttft_s")),
    "itl": lambda s: (_serve(s, 0, [0.05] * 12, "itl_s"), _serve(s, 0, [2.0] * 4, "itl_s")),
    "burn": lambda s: s.observe_serve(burn_rate=50.0, replica_id=0),
    "episodes": lambda s: (_serve(s, 3, [0.2] * 12, "ttft_s"), _serve(s, 3, [5.0] * 6, "ttft_s"),
                           _serve(s, 3, [0.2] * 12, "ttft_s"), _serve(s, 3, [5.0] * 6, "ttft_s")),
    "per_replica": lambda s: ([_serve(s, r, [0.2] * 12, "ttft_s") for r in (0, 1)],
                              [_serve(s, r, [5.0] * 4, "ttft_s") for r in (0, 1)]),
    "floor": lambda s: (_serve(s, 0, [0.002] * 12, "itl_s"), _serve(s, 0, [0.008] * 6, "itl_s")),
    "fleet_burn": lambda s: (s.observe_serve(burn_rate=5.0), s.observe_serve(burn_rate=0.0,
                                                                              replica_id=2)),
    "unattributed_ttft": lambda s: ([s.observe_serve(ttft_s=0.2) for _ in range(12)],
                                    [s.observe_serve(ttft_s=5.0) for _ in range(4)]),
    "reset": lambda s: (_serve(s, 1, [0.2] * 12, "ttft_s"), _serve(s, 1, [50.0] * 4, "ttft_s"),
                        s.reset_serve_episodes(1), _serve(s, 1, [50.0] * 4, "ttft_s")),
}
WANT_SERVE = {"clean": [], "ttft": ["SNT007"], "itl": ["SNT008"], "burn": ["SNT009"],
              "episodes": ["SNT007", "SNT007"], "per_replica": ["SNT007", "SNT007"],
              "floor": [], "fleet_burn": ["SNT009"], "unattributed_ttft": ["SNT007"],
              "reset": ["SNT007", "SNT007"]}


@pytest.mark.parametrize("name", sorted(SERVE_FEEDS))
def test_serve_feeds_equal_jax(name):
    calls = {"port": [], "jax": []}
    port, _ = _pair()
    ref = jsentry.Sentry(registry=JM.MetricsRegistry(),
                         monitor=SimpleNamespace(escalate=lambda pid, reason="":
                                                 calls["jax"].append((pid, reason))))
    port.monitor = SimpleNamespace(
        escalate=lambda pid, reason="": calls["port"].append((pid, reason)))
    SERVE_FEEDS[name](port)
    SERVE_FEEDS[name](ref)
    _same_findings(port, ref)
    assert [f.code for f in port.findings] == WANT_SERVE[name]
    assert calls["port"] == calls["jax"]
    if name == "unattributed_ttft" or name == "fleet_burn":
        assert calls["port"] == [] and port.findings[0].process_id == -1
    if name == "fleet_burn":
        assert port._reg.gauge("obs_sentry_burn_rate").value == 5.0


def test_sentry_escalates_into_health_monitor():
    mon = HealthMonitor(MemoryTransport(), process_id=0, publish=False,
                        config=FTConfig(), registry=M.MetricsRegistry())
    jmon = JMonitor(JTransport(), process_id=0, publish=False, config=JFTConfig(),
                    registry=JM.MetricsRegistry())
    port = Sentry(registry=M.MetricsRegistry(), monitor=mon, process_id=3)
    ref = jsentry.Sentry(registry=JM.MetricsRegistry(), monitor=jmon, process_id=3)
    for s in (port, ref):
        for i in range(4):
            s.observe_step(step=i, loss=2.0)
        s.observe_step(step=4, loss=NAN)
    assert mon.peers()[3].state is PeerState.SUSPECT
    assert jmon.peers()[3].state.value == mon.peers()[3].state.value
    _same_findings(port, ref)


def test_serve_regression_escalates_the_replica():
    mon = HealthMonitor(MemoryTransport(), process_id=0, publish=False,
                        config=FTConfig(), registry=M.MetricsRegistry())
    s = Sentry(registry=M.MetricsRegistry(), monitor=mon)
    _serve(s, 2, [0.2] * 12, "ttft_s")
    _serve(s, 2, [5.0] * 4, "ttft_s")
    assert mon.peers()[2].state is PeerState.SUSPECT


def test_findings_land_in_flight_record_like_jax(tmp_path):
    rec = recorder.FlightRecorder(str(tmp_path / "port"), process_id=0)
    jrec = jrecorder.FlightRecorder(str(tmp_path / "jax"), process_id=0)
    port = Sentry(registry=M.MetricsRegistry(), recorder=rec, process_id=0)
    ref = jsentry.Sentry(registry=JM.MetricsRegistry(), recorder=jrec, process_id=0)
    for s in (port, ref):
        for i in range(10):
            s.observe_step(step=i, loss=2.0)
        s.observe_step(step=10, loss=INF)
        _serve(s, 1, [0.1] * 10, "itl_s")
        _serve(s, 1, [1.0] * 3, "itl_s")
    rec.close()
    jrec.close()

    def events(d):
        return [{k: v for k, v in r.items() if k != "t"}
                for r in recorder.read_records(d) if r["kind"] == "sentry"]

    got, want = events(str(tmp_path / "port")), events(str(tmp_path / "jax"))
    assert got == want and [e["code"] for e in got] == ["SNT001", "SNT008"]


def test_codes_and_metrics_equal_jax():
    assert CODES == jsentry.CODES
    assert SentryConfig().__dict__ == jsentry.SentryConfig().__dict__
    reg = M.MetricsRegistry()
    s = Sentry(registry=reg)
    s.observe_serve(burn_rate=9.0, replica_id=4)
    snap = reg.snapshot()
    assert snap["obs_sentry_findings_total"] == 1 and snap["obs_sentry_snt009_total"] == 1
    assert s.findings[0].to_dict()["process_id"] == 4


def test_process_id_defaults_to_the_env(monkeypatch):
    monkeypatch.setenv("AUTODIST_PROCESS_ID", "5")
    assert Sentry(registry=M.MetricsRegistry()).process_id == 5
    assert jsentry.Sentry(registry=JM.MetricsRegistry()).process_id == 5
