"""Port parity: the postmortem doctor (``obs/doctor.py``) and ``python -m
autodist_tpu_torch.obs`` against the JAX package's
(``tests/test_obs_sentry.py:271-370``, ``autodist_tpu/obs/__main__.py:
129-196``).

Every death of JAX's verdict table is written into an ft base dir through
the port's own writers (the flight recorder, the sentry, the heartbeat file
transport, the snapshot manager, the launcher's hang bundle, the span
tracer) and read by both doctors: verdict, code, stats, evidence and
timeline must be equal. Then the CLIs: ``doctor DIR [--json]`` exit codes
(0 clean, 1 a classified failure, 3 unknown), ``--selftest --device cpu``
printing one JSON line with ``ok: true``, and ``--selftest`` without a card
exiting non-zero with the reason.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from autodist_tpu.obs import doctor as jdoctor
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.ft.heartbeat import FileTransport
from autodist_tpu_torch.obs import doctor
from autodist_tpu_torch.obs.__main__ import seeded_doctor_bases
from autodist_tpu_torch.obs.recorder import FlightRecorder, flight_dir
from autodist_tpu_torch.obs.sentry import Sentry, SentryConfig
from autodist_tpu_torch.obs.spans import SpanTracer

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _steps(rec, n=12):
    for i in range(n):
        rec.record_step(steps=1, loss=2.0 - 0.01 * i, step_wall_s=0.1)


def _sentry(rec):
    return Sentry(config=SentryConfig(min_history=8, hbm_min_history=8),
                  registry=M.MetricsRegistry(), recorder=rec)


def _both(base):
    """Both doctors over ``base``; equal in every field."""
    port, ref = doctor.diagnose(str(base)), jdoctor.diagnose(str(base))
    assert json.dumps(port.to_dict(), default=str, sort_keys=True) == \
        json.dumps(ref.to_dict(), default=str, sort_keys=True)
    return port


# ------------------------------------------------------------------ table
def test_verdict_table_equals_jax():
    assert doctor.VERDICT_CODES == jdoctor.VERDICT_CODES


@pytest.mark.parametrize("want", ["clean", "nan", "oom", "preemption", "wedge", "straggler"])
def test_selftest_seeded_deaths_read_alike(tmp_path, want):
    base = seeded_doctor_bases(str(tmp_path))[want]
    d = _both(base)
    assert d.verdict == want and d.code == doctor.VERDICT_CODES[want]


# ---------------------------------------------------- test_obs_sentry cases
def _crash(base):
    rec = FlightRecorder(flight_dir(base))
    _steps(rec)
    rec.record_event("error", error="ValueError: boom")


def _oom_beats_clean(base):
    rec = FlightRecorder(flight_dir(base))
    _steps(rec)
    rec.record_event("error", error="torch.OutOfMemoryError: CUDA out of memory. Tried to "
                     "allocate 2.00 GiB")
    rec.close(ok=True)


def _nan_tail(base):
    rec = FlightRecorder(flight_dir(base))
    _steps(rec, n=8)
    rec.record_step(steps=1, loss=float("nan"), step_wall_s=0.1)


def _nan_grad(base):
    rec = FlightRecorder(flight_dir(base))
    _steps(rec, n=8)
    _sentry(rec).observe_step(step=9, loss=2.0, grad_norm=float("inf"))


def _preempt_clean_exit(base):
    rec = FlightRecorder(flight_dir(base))
    _steps(rec)
    rec.record_event("preempt", signal=15, step=11)
    rec.close(ok=True)


def _pool_error(base):
    rec = FlightRecorder(flight_dir(base))
    _steps(rec)
    rec.record_event("pool_pressure", reason="free pages below watermark", free_pages=2)
    rec.record_event("error", error="RuntimeError: page pool exhausted: 0 free pages")


def _pool_silent(base):
    rec = FlightRecorder(flight_dir(base))
    _steps(rec)
    rec.record_event("pool_pressure", reason="free pages below watermark", free_pages=0,
                     queue_depth=17)


def _failover_storm(base):
    rec = FlightRecorder(flight_dir(base))
    _steps(rec)
    for rid in (0, 1, 0):
        rec.record_event("replica_transition", replica=rid, old="ready", new="dead")
    rec.record_event("reroute", request_id="r7", delivered=3, reason="replica 0 dead")


def _single_failover(base):
    rec = FlightRecorder(flight_dir(base))
    _steps(rec)
    rec.record_event("replica_transition", replica=0, old="ready", new="dead")
    rec.record_event("error", error="EngineDeadError: replica 0 died")


def _heartbeats_stop(base):
    hb = FileTransport(os.path.join(base, "heartbeats"))
    for pid in range(3):
        hb.publish(pid, {"time": time.time() - 90.0, "step": 40})


def _empty(base):
    os.makedirs(base, exist_ok=True)


def _spans_and_pilot(base):
    rec = FlightRecorder(flight_dir(base))
    _steps(rec)
    rec.close(ok=True)
    tracer = SpanTracer(trace_id="doc", process=0)
    with tracer.span("train.window", steps=4):
        pass
    tracer.flush_part(os.path.join(base, "traces"))
    os.makedirs(os.path.join(base, "pilot"))
    with open(os.path.join(base, "pilot", "decisions.jsonl"), "w") as f:
        f.write(json.dumps({"decision_id": "d1-1", "trigger": "wire_drift", "code": "SNT004",
                            "action": "refit_replan", "verdict": "committed",
                            "t": time.time()}) + "\n")
        f.write("{torn\n")


def _snapshot_progress(base):
    from autodist_tpu_torch.ft.snapshot import SnapshotManager

    rec = FlightRecorder(flight_dir(base))
    _steps(rec)
    SnapshotManager(os.path.join(base, "snapshots"), registry=M.MetricsRegistry()).snapshot(
        {"w": torch.ones(4, 4)}, step=7, block=True)


def _hang_bundle(base, stragglers=False):
    from autodist_tpu_torch.ft import FTConfig
    from autodist_tpu_torch.runtime.launcher import _FleetWatch

    watch = _FleetWatch(FTConfig(base_dir=base, heartbeat_interval_s=1.0,
                                 hang_after_misses=5))
    if stragglers:
        rec = FlightRecorder(flight_dir(base))
        _steps(rec)
        _sentry(rec).observe_scores({0: 1.0, 1: 2.7})
    hb = FileTransport(os.path.join(base, "heartbeats"))
    for pid in range(1 if stragglers else 2):
        hb.publish(pid, {"time": time.time() - 600.0, "step": 42})
    watch.monitor.tick()
    assert watch.write_bundle() is not None


CASES = {
    "crash": (_crash, "crash"),
    "oom_beats_clean": (_oom_beats_clean, "oom"),
    "nan_tail": (_nan_tail, "nan"),
    "nan_grad_sentry": (_nan_grad, "nan"),
    "preempt_clean_exit": (_preempt_clean_exit, "preemption"),
    "pool_error": (_pool_error, "pool_exhaustion"),
    "pool_silent": (_pool_silent, "pool_exhaustion"),
    "failover_storm": (_failover_storm, "failover_storm"),
    "single_failover": (_single_failover, "crash"),
    "heartbeats_stop": (_heartbeats_stop, "wedge"),
    "empty": (_empty, "unknown"),
    "spans_and_pilot": (_spans_and_pilot, "clean"),
    "snapshot_progress": (_snapshot_progress, "wedge"),
    "hang_bundle": (_hang_bundle, "wedge"),
    "hang_bundle_stragglers": (lambda b: _hang_bundle(b, stragglers=True), "straggler"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_both_doctors_agree(tmp_path, case):
    write, want = CASES[case]
    base = str(tmp_path / case)
    write(base)
    d = _both(base)
    assert d.verdict == want and d.code == doctor.VERDICT_CODES[want]
    if case == "snapshot_progress":
        assert d.stats["last_snapshot_step"] == 7
    if case == "spans_and_pilot":
        assert d.stats["spans"] == 1 and d.stats["pilot_decisions"] == 1
        assert [e for e in d.timeline if e["source"] == "pilot"][0]["code"] == "SNT004"


def test_a_profiled_run_reads_clean_in_both(tmp_path, monkeypatch):
    from autodist_tpu_torch.api import AutoDist
    from autodist_tpu_torch.models import get_model_spec
    from autodist_tpu_torch.obs import ObsConfig
    from autodist_tpu_torch.obs import recorder as flight
    from autodist_tpu_torch.strategy import AllReduce

    spec = get_model_spec("mlp", in_dim=16, hidden=(32,), num_classes=4)
    params, batch = spec.init(0, device="cpu"), spec.example_batch(8, device="cpu")
    # The runtime counts into the process-wide registry: a fresh one, so
    # this run's windows do not reach later tests of this worker process.
    monkeypatch.setattr(M, "registry", M.MetricsRegistry())
    AutoDist.reset_default()
    try:
        ad = AutoDist(strategy_builder=AllReduce(), device="cpu",
                      observability=ObsConfig(flight_dir=flight_dir(str(tmp_path))))
        step = ad.build(spec.loss_fn, params, batch, record_norms=True)
        prof = ad.obs.profiler(step)
        state = step.init(params)
        for _ in range(3):
            state, _ = prof.run(state, batch, 2)
        ad.obs.close()
    finally:
        AutoDist.reset_default()
        flight._default = None
        flight._resolved = False
    d = _both(str(tmp_path))
    assert d.verdict == "clean" and d.stats["flight_records"] >= 4
    steps = [e for e in d.timeline if e.get("kind") == "step"]
    assert len(steps) == 3 and all(np.isfinite(e["grad_norm"]) for e in steps)


# -------------------------------------------------------------------- CLIs
def test_run_cli_exit_codes(tmp_path, capsys):
    nan = tmp_path / "nan"
    _nan_tail(str(nan))
    assert doctor.run_cli(str(nan), as_json=True) == 1
    doc = json.loads(capsys.readouterr().out.strip())
    assert doc["verdict"] == "nan" and doc["code"] == "DOC001" and doc["evidence"]
    clean = tmp_path / "clean"
    rec = FlightRecorder(flight_dir(str(clean)))
    _steps(rec)
    rec.close(ok=True)
    assert doctor.run_cli(str(clean), as_json=False) == 0
    assert "verdict: clean" in capsys.readouterr().out
    assert doctor.run_cli(str(tmp_path / "empty"), as_json=True) == 3


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "autodist_tpu_torch.obs", *args],
                          capture_output=True, text=True, cwd=REPO, timeout=timeout, env=env)


def test_doctor_cli_subprocess(tmp_path):
    rec = FlightRecorder(flight_dir(str(tmp_path)))
    _steps(rec)
    rec.record_event("preempt", signal=15)
    r = _cli("doctor", str(tmp_path), "--json")
    assert r.returncode == 1, r.stderr[-500:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["verdict"] == "preemption"


def test_selftest_cli_on_the_cpu():
    r = _cli("--selftest", "--device", "cpu")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["ok"] is True and line["device"] == "cpu" and line["flops_per_step"] > 0
    assert line["doctor_cases"] == {k: k for k in ("clean", "nan", "oom", "preemption",
                                                   "straggler", "wedge")}


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is present here")
def test_selftest_cli_without_a_card_says_so():
    r = _cli("--selftest")
    assert r.returncode != 0
    assert "needs an NVIDIA GPU" in r.stderr and not r.stdout.strip()


def test_attrib_cli_names_the_roadmap():
    r = _cli("attrib")
    assert r.returncode == 2 and "Queue 1 item 7" in r.stderr
