"""Port parity: serving SLOs (``obs/slo.py``) and the OpenMetrics reader and
file writer (``obs/exporter.py``) against the JAX package's.

Identical seeded streams go into both packages' ``SLOTracker`` under one
clock: reports, burn rates and percentiles must be exactly equal (both are
the same numpy arithmetic in float64). ``replay_flight_records`` over
records written by either package's recorder gives JAX's report, and
``parse_openmetrics`` reads both renderers' text alike.
"""
import json

import numpy as np
import pytest

from autodist_tpu import metrics as JM
from autodist_tpu.obs import exporter as jexporter
from autodist_tpu.obs import recorder as jrecorder
from autodist_tpu.obs import slo as jslo
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.obs import (FileExporter, SLOSpec, SLOTracker, json_safe,
                                    parse_openmetrics, render_openmetrics,
                                    replay_flight_records)
from autodist_tpu_torch.obs import recorder

SPECS = [dict(), dict(availability=0.9, window_s=10.0, burn_fast_window_s=5.0,
                      burn_slow_window_s=50.0, ttft_p99_s=0.3)]


def _feed(seed, n=400):
    """A seeded stream of ``observe`` calls and clock steps: TTFT/ITL/queue
    wait with weights, outcomes, sheds, spec acceptance blended and per
    bucket, cached flags and temperatures."""
    rng = np.random.default_rng(seed)
    calls = []
    for i in range(n):
        kw = {}
        r = rng.random()
        if r < 0.6:
            kw = dict(ttft_s=float(rng.lognormal(-2, 0.7)),
                      itl_s=float(rng.lognormal(-4, 0.5)),
                      itl_tokens=int(rng.integers(1, 40)),
                      queue_wait_s=float(rng.exponential(0.2)),
                      ok=bool(rng.random() > 0.05),
                      cached=None if i % 5 == 0 else bool(rng.random() > 0.5),
                      temperature=None if i % 7 == 0 else float(rng.choice([0.0, 0.8])))
        elif r < 0.7:
            kw = dict(ok=False, shed=True)
        elif r < 0.85:
            prop = int(rng.integers(0, 9))
            kw = dict(spec_proposed=prop, spec_accepted=int(rng.integers(0, prop + 2)))
        else:
            prop = int(rng.integers(1, 9))
            kw = dict(spec_proposed=prop, spec_accepted=int(rng.integers(0, prop + 1)),
                      spec_bucket=str(rng.choice(["greedy", "low", "high"])))
        if i == 37:
            kw = dict(ttft_s=float("nan"), itl_s=float("inf"))
        calls.append((float(rng.exponential(0.05)), kw))
    return calls


def _pair(spec_kw):
    t = {"now": 1000.0}
    port = SLOTracker(spec=SLOSpec(**spec_kw), registry=M.MetricsRegistry(),
                      clock=lambda: t["now"])
    ref = jslo.SLOTracker(spec=jslo.SLOSpec(**spec_kw), registry=JM.MetricsRegistry(),
                          clock=lambda: t["now"])
    return port, ref, t


def _same(a, b):
    assert json.dumps(json_safe(a), sort_keys=True) == \
        json.dumps(jslo.json_safe(b), sort_keys=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("spec_i", range(len(SPECS)))
def test_tracker_reports_equal_jax(seed, spec_i):
    port, ref, t = _pair(SPECS[spec_i])
    for k, (dt, kw) in enumerate(_feed(seed)):
        t["now"] += dt
        port.observe(**kw)
        ref.observe(**kw)
        if k % 50 == 49:
            _same(port.report(), ref.report())
            assert port.burn_rates() == ref.burn_rates()
            for sig in ("ttft", "itl", "queue_wait"):
                for p in (50.0, 90.0, 99.0):
                    a, b = port.percentile(sig, p), ref.percentile(sig, p)
                    assert a == b or (np.isnan(a) and np.isnan(b))
    _same(port.report(), ref.report())
    assert port.report_json() == ref.report_json()


def test_empty_report_is_nan_safe_json():
    port, ref, _ = _pair({})
    doc = json.loads(port.report_json())
    assert doc["measured"]["ttft_p50_s"] is None
    assert doc == json.loads(ref.report_json())
    assert doc["compliant"]["overall"] is True


def test_weighted_percentile_equals_expanded_array():
    vals = [(0.1, 1.0), (0.5, 3.0), (0.2, 2.0), (0.9, 1.0)]
    expanded = [0.1, 0.5, 0.5, 0.5, 0.2, 0.2, 0.9]
    for p in (0.0, 10.0, 50.0, 90.0, 99.0, 100.0):
        assert SLOTracker._pct(vals, p) == pytest.approx(np.percentile(expanded, p), abs=1e-12)
        assert SLOTracker._pct(vals, p) == jslo.SLOTracker._pct(vals, p)


def test_slo_gauges_render_through_both_exporters():
    reg, jreg = M.MetricsRegistry(), JM.MetricsRegistry()
    port = SLOTracker(registry=reg)
    ref = jslo.SLOTracker(registry=jreg)
    for tr in (port, ref):
        tr.observe(ttft_s=0.2, itl_s=0.02, ok=True)
        tr.observe(spec_proposed=4, spec_accepted=3, spec_bucket="low")
        tr.report()
    text, jtext = render_openmetrics(reg), jexporter.render_openmetrics(jreg)
    assert text == jtext
    samples = parse_openmetrics(text)
    assert samples == jexporter.parse_openmetrics(jtext)
    assert samples[("slo_ttft_p50_s", "")] == pytest.approx(0.2)
    assert samples[("slo_compliant", "")] == 1.0
    assert samples[("slo_acceptance_rate_low", "")] == pytest.approx(0.75)


def _write_records(rec, seed):
    rng = np.random.default_rng(seed)
    for i in range(60):
        if i % 9 == 4:
            rec.record_event("shed", critical=False, src=f"batcher-{i % 2}",
                             reason="queue full", total_shed=int(i))
        else:
            rec.record_step(surface="serve", event="request", request_id=f"r{i}",
                            state="done" if rng.random() > 0.1 else "timeout",
                            n_tokens=int(rng.integers(1, 30)),
                            ttft_s=float(rng.lognormal(-2, 0.5)),
                            itl_s=None if i % 11 == 0 else float(rng.lognormal(-4, 0.3)),
                            queue_wait_s=float(rng.exponential(0.1)),
                            cached=bool(i % 3), temperature=float(i % 2) * 0.7)
        if i % 13 == 0:
            rec.record_step(surface="serve", event="tick", active=3)
    rec.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_replay_flight_records_equals_jax(tmp_path, writer):
    clock = iter(np.arange(5000.0, 6000.0, 0.25))
    if writer == "port":
        rec = recorder.FlightRecorder(str(tmp_path), process_id=0, clock=lambda: next(clock))
    else:
        rec = jrecorder.FlightRecorder(str(tmp_path), process_id=0, clock=lambda: next(clock))
    _write_records(rec, seed=4)
    records = recorder.read_records(str(tmp_path))
    assert records == jrecorder.read_records(str(tmp_path))
    spec_kw = dict(window_s=1e9, burn_fast_window_s=5.0, burn_slow_window_s=1e9)
    port = replay_flight_records(records, spec=SLOSpec(**spec_kw))
    ref = jslo.replay_flight_records(records, spec=jslo.SLOSpec(**spec_kw))
    _same(port.report(), ref.report())
    counts = port.report()["counts"]
    # Sheds replay as cumulative deltas per source, not one per event.
    assert counts["sheds"] > sum(1 for r in records if r["kind"] == "shed")


def test_replay_keys_shed_deltas_by_source(tmp_path):
    rec = recorder.FlightRecorder(str(tmp_path), process_id=0)
    for src, total in (("router-0", 1), ("batcher-5", 1), ("router-0", 50),
                       ("batcher-5", 3)):
        rec.record_event("shed", critical=False, src=src, reason="x", total_shed=total)
    rec.close()
    tracker = replay_flight_records(
        recorder.read_records(str(tmp_path)),
        spec=SLOSpec(window_s=1e9, burn_fast_window_s=1e9, burn_slow_window_s=1e9))
    assert tracker.report()["counts"]["sheds"] == 53


@pytest.mark.parametrize("text,ok", [
    ("# TYPE a gauge\na 1\n# EOF\n", True),
    ('# TYPE h summary\nh{quantile="0.5"} 2\nh_count 1\nh_sum 2\n# EOF\n', True),
    ("a 1\n", False),                       # no EOF
    ("a\n# EOF\n", False),                  # no value
    ("a{x=1 2\n# EOF\n", False),            # unterminated labels
    ("# what\na 1\n# EOF\n", False),        # unknown comment
    ("a nan\n# EOF\n", False),              # NaN value
    ("a +Inf\n# EOF\n", True),
])
def test_parse_openmetrics_equals_jax(text, ok):
    if ok:
        assert parse_openmetrics(text) == jexporter.parse_openmetrics(text)
    else:
        with pytest.raises(ValueError):
            parse_openmetrics(text)
        with pytest.raises(ValueError):
            jexporter.parse_openmetrics(text)


def test_file_exporter_writes_what_the_renderer_renders(tmp_path):
    reg, jreg = M.MetricsRegistry(), JM.MetricsRegistry()
    for r in (reg, jreg):
        r.counter("serve_requests_completed_total").inc(3)
        r.gauge("serve_queue_depth").set(2)
        r.histogram("serve_ttft_s").observe(0.25)
    path, jpath = tmp_path / "m.prom", tmp_path / "j.prom"
    with FileExporter(str(path), registry=reg, interval_s=0.05):
        reg.counter("serve_requests_completed_total").inc()
    jreg.counter("serve_requests_completed_total").inc()
    jexporter.FileExporter(str(jpath), registry=jreg).write_once()
    text = path.read_text()
    assert text == render_openmetrics(reg) == jpath.read_text()
    assert parse_openmetrics(text)[("serve_requests_completed_total", "")] == 4.0
    assert not [p for p in tmp_path.iterdir() if ".tmp-" in p.name]
