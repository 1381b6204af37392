"""CLI: ``python -m autodist_tpu_torch.obs [--selftest | doctor DIR | attrib]``
(PyTorch port of ``obs/__main__.py``).

- ``--selftest [--device cpu]``: the observability proof on one rank, the
  JAX package's selftest: spans (context manager, decorator,
  retroactive), the :class:`~autodist_tpu_torch.obs.profiler.StepProfiler`
  over a real ``AutoDist.build`` step (its FLOPs equal to the step's
  ``window_cost``), the chrome-trace export, the OpenMetrics renderer
  through both surfaces, the flight recorder and sentry on a clean
  profiled loop (no findings, the recorder's cost under 1% of the loop),
  every seeded anomaly tripping exactly its ``SNT###`` code, and the
  doctor naming each seeded death. It prints one JSON line and exits 1 on
  a failed check. It runs on the card unless ``--device cpu`` is given,
  and exits 2 without one.
- ``doctor DIR [--json] [--trace-out T]``: the postmortem of an ft base
  dir (``obs/doctor.py``). Exit 0 clean, 1 a classified failure, 3
  unknown.
- ``attrib``: measured-wire attribution waits for ROADMAP.md Queue 1
  item 7; it says so and exits 2.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

#: The flight records of a seeded case: steps of a falling loss.
_SEEDED_STEPS = 12


def _seeded_sentry_checks(failures: list) -> dict:
    """Every anomaly class trips exactly its code; a clean synthetic
    stream trips none. Host-side only."""
    from autodist_tpu_torch import metrics as M
    from autodist_tpu_torch.obs.sentry import CODES, Sentry, SentryConfig

    def fresh():
        return Sentry(config=SentryConfig(min_history=8, hbm_min_history=8),
                      registry=M.MetricsRegistry())

    tripped = {}

    def run_case(name, feed, want_code):
        s = fresh()
        feed(s)
        tripped[name] = s.codes()
        if tripped[name] != [want_code]:
            failures.append(f"seeded {name}: expected exactly [{want_code}], "
                            f"got {tripped[name]}")

    s = fresh()
    for i in range(64):
        s.observe_step(step=i, loss=2.0 - 0.01 * i, step_time_s=0.1, hbm_bytes=8e9,
                       grad_norm=1.0, update_norm=0.01)
    if s.findings:
        failures.append(f"clean stream tripped {s.codes()} (expected none)")

    run_case("nan_loss", lambda s: [
        s.observe_step(step=i, loss=(float("nan") if i >= 20 else 2.0), step_time_s=0.1)
        for i in range(24)], "SNT001")
    run_case("nan_grad", lambda s: [
        s.observe_step(step=i, loss=2.0, step_time_s=0.1,
                       grad_norm=(float("inf") if i == 20 else 1.0))
        for i in range(24)], "SNT002")
    run_case("loss_spike", lambda s: [
        s.observe_step(step=i, loss=(50.0 if i == 20 else 2.0 + 0.01 * (i % 3)),
                       step_time_s=0.1) for i in range(24)], "SNT003")
    run_case("step_time_regression", lambda s: [
        s.observe_step(step=i, loss=2.0, step_time_s=(0.5 if i >= 16 else 0.1))
        for i in range(24)], "SNT004")
    run_case("hbm_creep", lambda s: [
        s.observe_step(step=i, loss=2.0, step_time_s=0.1,
                       hbm_bytes=8e9 * (1.0 + max(0, i - 8) * 0.02))
        for i in range(24)], "SNT005")
    run_case("straggler", lambda s: [
        s.observe_scores({0: 1.0, 1: 1.02, 2: 2.4}, step=i) for i in range(4)], "SNT006")

    unknown = {c for cs in tripped.values() for c in cs} - set(CODES)
    if unknown:
        failures.append(f"sentry emitted undocumented codes: {unknown}")
    return tripped


def seeded_doctor_bases(tmpdir: str) -> dict:
    """One ft base dir per death the doctor names, written through the
    port's own writers (the flight recorder, the sentry, the heartbeat
    file transport): ``{expected verdict: base dir}``. The JAX package's
    selftest seeds the same six."""
    from autodist_tpu_torch import metrics as M
    from autodist_tpu_torch.ft.heartbeat import FileTransport
    from autodist_tpu_torch.obs.recorder import FlightRecorder, flight_dir
    from autodist_tpu_torch.obs.sentry import Sentry, SentryConfig

    bases = {}

    def base(name):
        d = os.path.join(tmpdir, f"doctor-{name}")
        os.makedirs(d, exist_ok=True)
        bases[name] = d
        rec = FlightRecorder(flight_dir(d))
        for i in range(_SEEDED_STEPS):
            rec.record_step(steps=1, loss=2.0 - 0.01 * i, step_wall_s=0.1,
                            dispatch_gap_s=0.01)
        return d, rec

    _, rec = base("clean")
    rec.close(ok=True)
    _, rec = base("nan")
    Sentry(config=SentryConfig(), registry=M.MetricsRegistry(),
           recorder=rec).observe_step(step=_SEEDED_STEPS, loss=float("nan"))
    _, rec = base("oom")
    rec.record_event("error", error="torch.OutOfMemoryError: CUDA out of memory. Tried "
                     "to allocate 16.00 GiB")
    _, rec = base("preemption")
    rec.record_event("preempt", step=_SEEDED_STEPS - 1, signal="SIGTERM")
    d, rec = base("wedge")
    hb = FileTransport(os.path.join(d, "heartbeats"))
    for pid in range(2):
        hb.publish(pid, {"time": time.time() - 120.0, "step": _SEEDED_STEPS - 1})
    _, rec = base("straggler")
    Sentry(config=SentryConfig(), registry=M.MetricsRegistry(),
           recorder=rec).observe_scores({0: 1.0, 1: 2.6})
    return bases


def _seeded_doctor_checks(failures: list, tmpdir: str) -> dict:
    from autodist_tpu_torch.obs.doctor import diagnose

    verdicts = {want: diagnose(d).verdict for want, d in seeded_doctor_bases(tmpdir).items()}
    for want, got in verdicts.items():
        if got != want:
            failures.append(f"doctor misclassified seeded {want} bundle as {got!r}")
    return verdicts


def selftest(window: int = 4, n_windows: int = 3, device=None) -> int:
    """The proof (module docstring) on ``device`` (default the card); prints
    ONE JSON line and returns the exit code."""
    import torch

    from autodist_tpu_torch import metrics as M
    from autodist_tpu_torch.api import AutoDist
    from autodist_tpu_torch.models import get_model_spec
    from autodist_tpu_torch.obs.doctor import diagnose
    from autodist_tpu_torch.obs.exporter import (FileExporter, parse_openmetrics,
                                                 render_openmetrics)
    from autodist_tpu_torch.obs.profiler import StepProfiler
    from autodist_tpu_torch.obs.recorder import FlightRecorder, flight_dir
    from autodist_tpu_torch.obs.sentry import Sentry
    from autodist_tpu_torch.obs.spans import SpanTracer
    from autodist_tpu_torch.strategy import AllReduce
    from autodist_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    failures = []
    registry = M.MetricsRegistry()
    tracer = SpanTracer(capacity=512)

    # ------------------------------------------------------------- spans
    with tracer.span("selftest.setup", phase="build"):
        spec = get_model_spec("mlp", in_dim=16, hidden=(32,), num_classes=4)
        params = spec.init(0, device=dev)
        batch = spec.example_batch(8, device=dev)
        AutoDist.reset_default()
        try:
            step = AutoDist(strategy_builder=AllReduce(), device=dev).build(
                spec.loss_fn, params, batch)
        finally:
            AutoDist.reset_default()

    @tracer.traced("selftest.decorated")
    def _decorated():
        return 41 + 1

    if _decorated() != 42:
        failures.append("decorator changed the return value")
    tracer.add_span("selftest.retroactive", time.time(), 0.001)

    # ------------------------------- profiler + flight recorder + sentry
    tmpdir = tempfile.mkdtemp(prefix="obs-selftest-")
    ft_base = os.path.join(tmpdir, "ft")
    recorder = FlightRecorder(flight_dir(ft_base))
    sentry = Sentry(registry=registry, recorder=recorder)
    prof = StepProfiler(step, registry=registry, tracer=tracer, recorder=recorder,
                        sentry=sentry)
    state = step.init(params)
    for _ in range(n_windows):
        state, _ = prof.run(state, batch, window)
    rep = prof.report()
    if rep["windows"] != n_windows:
        failures.append(f"profiler recorded {rep['windows']} != {n_windows}")
    want = step.window_cost(state, batch, 1)["flops"]
    got = rep.get("flops_per_step", 0.0)
    if want > 0 and abs(got - want) > 1e-6 * want:
        failures.append(f"flops mismatch: profiler {got} vs window_cost {want}")
    if want <= 0:
        failures.append("window_cost returned no flops")
    if not rep.get("device_s", 0.0) <= rep.get("wall_s", 0.0):
        failures.append(f"device_s {rep.get('device_s')} > wall_s {rep.get('wall_s')}")
    if sentry.findings:
        failures.append(f"clean profiled run tripped sentry codes {sentry.codes()}")

    # The recorder's own cost (append_s: serialise, write, flush and its
    # share of fsyncs) over long windows, after one warm-up window.
    over_prof = StepProfiler(step, registry=M.MetricsRegistry(),
                             tracer=SpanTracer(capacity=64), recorder=recorder, sentry=None)
    state, _ = over_prof.run(state, batch, 256)
    s0 = recorder.stats()
    t0 = time.perf_counter()
    for _ in range(3):
        state, _ = over_prof.run(state, batch, 256)
    loop_wall = time.perf_counter() - t0
    overhead = (recorder.stats()["append_s"] - s0["append_s"]) / max(loop_wall, 1e-9)
    if not math.isfinite(overhead) or overhead >= 0.01:
        failures.append(f"recorder overhead {overhead * 100:.3f}% >= 1% of the train loop")
    recorder.close(ok=True)
    clean_diag = diagnose(ft_base)
    if clean_diag.verdict != "clean":
        failures.append(f"doctor called the live clean run {clean_diag.verdict!r}")

    # ------------------------------------------- seeded anomalies + doctor
    sentry_cases = _seeded_sentry_checks(failures)
    doctor_cases = _seeded_doctor_checks(failures, tmpdir)

    # -------------------------------------------------------- chrome trace
    trace_path = tracer.export(os.path.join(tmpdir, "trace.json"))
    try:
        with open(trace_path, encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
        xs = [e for e in events if e.get("ph") == "X"]
        if not xs:
            failures.append("chrome trace has no complete (X) events")
        for e in xs:
            missing = [k for k in ("name", "ts", "dur", "pid", "tid") if k not in e]
            if missing:
                failures.append(f"event missing {missing}: {e}")
                break
        ids = {e["args"].get("trace_id") for e in xs}
        if len(ids) != 1:
            failures.append(f"events carry {len(ids)} trace ids: {ids}")
        names = {e["name"] for e in xs}
        if "profiler.window" not in names:
            failures.append(f"no profiler.window span in {sorted(names)}")
    except (OSError, ValueError, KeyError) as e:
        failures.append(f"chrome trace unloadable: {e}")

    # --------------------------------------------------------- openmetrics
    snap = registry.snapshot()
    text_render = render_openmetrics(registry, snapshot=snap)
    exporter = FileExporter(os.path.join(tmpdir, "metrics.prom"), registry=registry)
    text_file = exporter.write_once(snapshot=snap)
    if text_render.encode() != text_file.encode():
        failures.append("render and file exporter disagree byte-for-byte")
    try:
        with open(exporter.path, encoding="utf-8") as f:
            samples = parse_openmetrics(f.read())
        for name in ("obs_profiled_windows_total", "obs_step_wall_s_count",
                     "obs_sentry_findings_total"):
            if (name, "") not in samples:
                failures.append(f"exposition missing {name}")
    except (OSError, ValueError) as e:
        failures.append(f"openmetrics exposition malformed: {e}")

    ok = not failures
    line = {
        "selftest": "autodist_tpu_torch.obs",
        "ok": ok,
        "windows": n_windows,
        "steps_per_window": window,
        "flops_per_step": rep.get("flops_per_step"),
        "dispatch_gap_ms": round(rep.get("dispatch_gap_s", 0.0) * 1e3, 3),
        "step_wall_ms": round(rep.get("step_wall_s", 0.0) * 1e3, 3),
        "step_device_ms": round(rep.get("step_device_s", 0.0) * 1e3, 3),
        "compiles": rep.get("compiles", {}).get("count"),
        "trace_events": len(tracer.spans()),
        "openmetrics_bytes": len(text_file),
        "flight_records": recorder.stats()["records"],
        "recorder_overhead_pct": round(overhead * 100, 4),
        "sentry_cases": dict(sorted(sentry_cases.items())),
        "doctor_cases": dict(sorted(doctor_cases.items())),
        "device": dev.type,
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "n_devices": 1,
    }
    if failures:
        line["failures"] = failures
    print(json.dumps(line), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m autodist_tpu_torch.obs",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--selftest", action="store_true",
                    help="run the observability proof and exit")
    ap.add_argument("--device", default="cuda",
                    help="selftest: the device to train on (default cuda; cpu for the "
                         "plain path)")
    ap.add_argument("--window", type=int, default=4, help="selftest: steps a window")
    ap.add_argument("--windows", type=int, default=3, help="selftest: profiled windows")
    sub = ap.add_subparsers(dest="cmd")
    doc = sub.add_parser("doctor", help="postmortem: classify the death recorded under "
                                        "an ft base dir")
    doc.add_argument("dir", help="ft base dir (what AUTODIST_FT_DIR pointed at)")
    doc.add_argument("--json", action="store_true", help="emit ONE JSON line")
    doc.add_argument("--trace-out", default="",
                     help="span part-file dir (default: <dir>/traces)")
    sub.add_parser("attrib", help="measured-wire attribution (not ported yet)")
    args = ap.parse_args(argv)
    if args.cmd == "doctor":
        from autodist_tpu_torch.obs.doctor import run_cli

        return run_cli(args.dir, as_json=args.json, trace_out=args.trace_out)
    if args.cmd == "attrib":
        print("attrib: measured-wire attribution (obs/attrib.py) waits for ROADMAP.md "
              "Queue 1 item 7 (program-level analysis on torch.profiler traces)",
              file=sys.stderr)
        return 2
    if args.selftest:
        from autodist_tpu_torch.utils.device import resolve_device

        try:
            resolve_device(args.device)
        except RuntimeError as e:
            print(f"obs --selftest needs an NVIDIA GPU (or --device cpu): {e}",
                  file=sys.stderr)
            return 2
        return selftest(window=args.window, n_windows=args.windows, device=args.device)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
