"""The port's span tracer and flight recorder against the JAX package's
(``tests/test_obs.py``'s trace cases): the chrome-trace golden shape; span
part-files and stitched traces read back through JAX's ``stitch`` and the
reverse; a 2-process run of the port's launcher gives one trace id with the
launcher's ``launcher.fleet`` span; flight records cross both ways; and the
train step's instrumentation (the ``lowering.transform`` span, the first
call's ``compile`` event, the ``error`` event, the snapshot spans).
"""
import json
import os
import sys
import time
from collections import Counter
from pathlib import Path

import pytest
import torch

from autodist_tpu.obs import recorder as jrecorder
from autodist_tpu.obs import spans as jspans
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.obs import recorder, spans

REPO = Path(__file__).resolve().parents[1]


def test_chrome_trace_export_golden_shape(tmp_path):
    tracer = spans.SpanTracer(trace_id="cafe1234", process=3)
    with tracer.span("outer", phase="x"):
        with tracer.span("inner"):
            time.sleep(0.002)

    @tracer.traced("decorated")
    def f():
        return 7

    assert f() == 7
    tracer.add_span("retro", time.time() - 1.0, 0.5, request_id=42)
    with pytest.raises(RuntimeError):
        with tracer.span("failing"):
            raise RuntimeError("boom")
    doc = json.load(open(tracer.export(str(tmp_path / "trace.json"))))
    assert doc["displayTimeUnit"] == "ms" and doc["otherData"]["trace_id"] == "cafe1234"
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"outer", "inner", "decorated", "retro", "failing"}
    for e in xs:
        assert set(e) >= {"name", "ph", "ts", "dur", "pid", "tid", "args"}
        assert e["args"]["trace_id"] == "cafe1234" and e["args"]["process"] == 3
    inner = next(e for e in xs if e["name"] == "inner")
    outer = next(e for e in xs if e["name"] == "outer")
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e3
    assert next(e for e in xs if e["name"] == "failing")["args"]["error"] is True
    # The same spans through JAX's tracer give the same event keys.
    jt = jspans.SpanTracer(trace_id="cafe1234", process=3)
    jt.add_span("retro", 1.0, 0.5, request_id=42)
    jdoc = jt.to_chrome_trace()
    assert set(jdoc) == set(doc)
    assert set(jdoc["traceEvents"][1]) == set(xs[0])


def test_ring_buffer_bounds_memory_and_counts_drops():
    tracer = spans.SpanTracer(capacity=8, trace_id="t", process=0)
    for i in range(20):
        tracer.add_span(f"s{i}", time.time(), 0.0)
    assert len(tracer.spans()) == 8 and tracer.dropped == 12
    assert tracer.spans()[-1].name == "s19"


@pytest.mark.parametrize("stitcher", ["port", "jax"])
def test_parts_from_both_packages_stitch_in_either(tmp_path, stitcher):
    a = spans.SpanTracer(trace_id="deadbeef", process=0)
    a.add_span("port.step", time.time(), 0.1)
    b = jspans.SpanTracer(trace_id="deadbeef", process=1)
    b.add_span("jax.step", time.time(), 0.1)
    other = spans.SpanTracer(trace_id="ffffffff", process=0)
    other.add_span("stale.run", time.time(), 0.1)
    a.flush_part(str(tmp_path))
    b.flush_part(str(tmp_path))
    other.flush_part(str(tmp_path))
    stitch = spans.stitch if stitcher == "port" else jspans.stitch
    merged = stitch(str(tmp_path), trace_id="deadbeef")
    doc = json.load(open(merged))
    assert doc["otherData"] == {"trace_id": "deadbeef", "n_parts": 2}
    assert {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"} == {
        "port.step", "jax.step"}
    assert stitch(str(tmp_path)).endswith("trace-deadbeef.json")
    # The other package's stitch of the same dir writes the same document.
    again = (jspans.stitch if stitcher == "port" else spans.stitch)(
        str(tmp_path), trace_id="deadbeef", out=str(tmp_path / "again.json"))
    assert json.load(open(again)) == doc


def test_two_process_launcher_run_stitches_one_trace(tmp_path, monkeypatch):
    from autodist_tpu_torch.runtime import launcher

    script = tmp_path / "spanner.py"
    script.write_text("import time\n"
                      "from autodist_tpu_torch.obs import spans\n"
                      "with spans.span('fleet.unit'):\n"
                      "    time.sleep(0.01)\n")
    out = tmp_path / "traces"
    out.mkdir()
    monkeypatch.setenv("AUTODIST_TRACE_OUT", str(out))
    monkeypatch.delenv("AUTODIST_TRACE_ID", raising=False)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = launcher.launch(None, [sys.executable, str(script)], num_local_processes=2,
                           coordinator_port=port)
    assert code == 0
    merged = [n for n in os.listdir(out) if n.startswith("trace-")]
    assert len(merged) == 1, os.listdir(out)
    for doc in (json.load(open(out / merged[0])),
                json.load(open(jspans.stitch(str(out), out=str(tmp_path / "j.json"))))):
        xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        assert len({e["args"]["trace_id"] for e in xs}) == 1
        assert {e["args"]["process"] for e in xs if e["name"] == "fleet.unit"} == {0, 1}
        assert any(e["name"] == "launcher.fleet" for e in xs)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_flight_records_read_across_packages(tmp_path, writer):
    Rec = recorder.FlightRecorder if writer == "port" else jrecorder.FlightRecorder
    rec = Rec(str(tmp_path), process_id=2, segment_records=3, keep_segments=2)
    for i in range(7):
        rec.record_step(step=i, loss=1.0 / (i + 1))
    rec.record_event("snapshot", step=6, path="/x")
    rec.close()
    with open(next(tmp_path.glob("flight-r2-*.jsonl")), "a") as f:
        f.write('{"t": 1e12, "kind": "st')                   # a torn final line
    port, jax_ = recorder.read_records(str(tmp_path)), jrecorder.read_records(str(tmp_path))
    assert port == jax_ and port
    kinds = Counter(r["kind"] for r in port)
    assert kinds["snapshot"] == 1 and kinds["run_end"] == 1
    assert all(r["r"] == 2 for r in port)
    assert len(list(tmp_path.glob("flight-r2-*.jsonl"))) <= 2


def test_train_step_flight_events_and_lowering_span(tmp_path):
    from autodist_tpu_torch.api import AutoDist
    from autodist_tpu_torch.strategy import AllReduce

    tracer = spans.get_tracer()
    before = Counter(s.name for s in tracer.spans())
    rec = recorder.enable(str(tmp_path / "flight"), process_id=0)
    fail = {"on": False}

    def loss_fn(p, b):
        if fail["on"]:
            raise FloatingPointError("boom")
        return ((b @ p["w"]) ** 2).mean()

    params, batch = {"w": torch.ones(4, 2)}, torch.ones(8, 4)
    AutoDist.reset_default()
    try:
        step = AutoDist(strategy_builder=AllReduce(), device="cpu").build(loss_fn, params,
                                                                          batch)
        state = step.init(params)
        state, _ = step(state, batch)
        state, _ = step(state, batch)
        state, _ = step.run(state, batch, 2)
        fail["on"] = True
        with pytest.raises(FloatingPointError):
            step(state, batch)
    finally:
        AutoDist.reset_default()
        recorder.disable()
    assert [e["program"] for e in step.compile_log] == ["step", "run[2]"]
    records = recorder.read_records(str(tmp_path / "flight"))
    assert [r["program"] for r in records if r["kind"] == "compile"] == ["step", "run[2]"]
    errors = [r for r in records if r["kind"] == "error"]
    assert len(errors) == 1 and "FloatingPointError: boom" in errors[0]["error"]
    assert rec.stats()["errors"] == 0
    after = Counter(s.name for s in tracer.spans())
    assert after["lowering.transform"] > before["lowering.transform"]


def test_snapshot_write_records_spans(tmp_path):
    from autodist_tpu_torch.ft.snapshot import SnapshotManager

    tracer = spans.get_tracer()
    before = Counter(s.name for s in tracer.spans())
    mgr = SnapshotManager(str(tmp_path), registry=M.MetricsRegistry())
    assert mgr.snapshot({"w": torch.ones(4, 4)}, step=7, block=True) is not None
    after = Counter(s.name for s in tracer.spans())
    assert after["ft.snapshot.device_to_host"] > before["ft.snapshot.device_to_host"]
    assert after["ft.snapshot.write"] > before["ft.snapshot.write"]
