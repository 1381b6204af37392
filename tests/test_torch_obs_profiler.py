"""Port parity: the step profiler, ``window_cost``, ``record_norms``, the
train chaos seams, ``ObsRuntime`` and ``tune``'s audit (``obs/profiler.py``,
``obs/config.py``, ``kernel/lowering.py``, ``api.py``) against the JAX
package's (``tests/test_obs.py:251-359, 448-527``,
``tests/test_obs_sentry.py:441-539``).

The tiny ``mlp`` of those tests (in 16, hidden 32, 4 classes, batch 8) is
built on both sides from the same numpy parameters (``params_from_jax``);
JAX's step runs on one CPU device (``jax.devices()[:1]``), the port's on
the CPU:

- the profiler's ``flops_per_step`` equals ``window_cost(state, batch,
  1)["flops"]`` to 1e-9, as do the ``obs_flops_per_step`` gauge and the
  ``profiler.window`` span; on the CPU ``device_s`` is ``wall_s`` (the
  host is the device; JAX's is ``wall_s - dispatch_gap_s``);
- ``window_cost`` is per step for any ``num_steps``, and at most JAX's
  XLA count of the same step (which adds elementwise work; the ratio is
  printed);
- ``record_norms``: the global gradient and update norms equal JAX's to
  1e-5 relative, on one rank (adam + clip) and on 4 gloo ranks, a
  model-split variable's blocks at data 2 x model 2 under TensorParallel
  and ZeRO-1's data-split blocks (``tests/helpers/torch_dist.py``);
- a plant on ``SEAM_TRAIN_BATCH`` that poisons the batch trips SNT001 in
  a profiled run; the seams see JAX's context; without a plant a call
  costs one ``chaos_hooks.active()`` and no ``apply``;
- ``_record_tune_obs`` passes ``tests/test_obs.py:494-527``'s assertions.
"""
import dataclasses
import threading
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu import model_item as jmi
from autodist_tpu import strategy as jstrat
from autodist_tpu.kernel import DistributedTrainStep as JStep
from autodist_tpu.kernel import GraphTransformer as JGraphTransformer
from autodist_tpu.kernel import build_mesh as jbuild_mesh
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch import obs
from autodist_tpu_torch.api import AutoDist
from autodist_tpu_torch.chaos import hooks as chaos_hooks
from autodist_tpu_torch.model_item import OptimizerSpec
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.models.convert import params_from_jax
from autodist_tpu_torch.obs import recorder as flight
from autodist_tpu_torch.obs import spans as obs_spans
from autodist_tpu_torch.obs.doctor import diagnose
from autodist_tpu_torch.obs.recorder import flight_dir, read_records
from autodist_tpu_torch.ops import crossover
from autodist_tpu_torch.strategy import PS, AllReduce
from helpers import torch_dist as td

MLP = dict(in_dim=16, hidden=(32,), num_classes=4)
BATCH = 8
NORM_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh():
    AutoDist.reset_default()
    yield
    AutoDist.reset_default()
    flight._default = None
    flight._resolved = False
    chaos_hooks.clear()


def _inputs(seed=0):
    """JAX's mlp, numpy params from ``seed`` and JAX's example batch."""
    jspec = jax_get_model("mlp", **MLP)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.3).astype(s.dtype),
                          jax.eval_shape(jspec.init, jax.random.PRNGKey(0)))
    return jspec, params, jax.tree.map(np.asarray, jspec.example_batch(BATCH))


def _port_step(params, batch, optimizer=None, **build):
    spec = get_model_spec("mlp", **MLP)
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    tparams = params_from_jax(params, device="cpu")
    step = ad.build(spec.loss_fn, tparams, td.to_torch(batch), optimizer=optimizer, **build)
    return step, tparams, td.to_torch(batch)


def _tiny_step():
    _, params, batch = _inputs()
    step, tparams, tbatch = _port_step(params, batch)
    return step, tparams, tbatch


def _jax_step(jspec, params, batch, opt=None, **kw):
    """JAX's step of the mlp on one CPU device."""
    rs = JResourceSpec(resource_dict={"nodes": [
        {"address": "localhost", "chips": 1, "chief": True}]})
    opt = opt or jmi.OptimizerSpec("sgd", {"learning_rate": 0.01})
    item = jmi.ModelItem.from_params(params, optimizer_spec=opt, loss_fn=jspec.loss_fn,
                                     example_batch=batch)
    strategy = jstrat.StrategyCompiler(item).compile(jstrat.AllReduce().build(item, rs))
    plan = JGraphTransformer(strategy, item, jbuild_mesh(rs, devices=jax.devices()[:1])
                             ).transform()
    return JStep(plan, jspec.loss_fn, opt.make(), **kw)


# ------------------------------------------------------------------ profiler
def test_step_profiler_flops_match_window_cost():
    step, params, batch = _tiny_step()
    reg = M.MetricsRegistry()
    tracer = obs.SpanTracer(trace_id="prof", process=0)
    prof = obs.StepProfiler(step, registry=reg, tracer=tracer)
    state = step.init(params)
    for _ in range(2):
        state, metrics = prof.run(state, batch, 4)
    assert np.isfinite(float(metrics["loss"][-1]))
    rep = prof.report()
    want = step.window_cost(state, batch, 1)["flops"]
    assert want > 0
    assert rep["flops_per_step"] == pytest.approx(want, rel=1e-9)
    assert rep["wall_s"] >= rep["dispatch_gap_s"] >= 0
    # The port's rendering on the CPU: the host is the device.
    assert rep["device_s"] == rep["wall_s"]
    assert all(w["device_s"] == w["wall_s"] for w in prof.windows)
    assert rep["compiles"]["count"] >= 1
    snap = reg.snapshot()
    assert snap["obs_profiled_windows_total"] == 2
    assert snap["obs_flops_per_step"] == pytest.approx(want, rel=1e-9)
    windows = [s for s in tracer.spans() if s.name == "profiler.window"]
    assert len(windows) == 2
    assert all(s.attrs["flops_per_step"] == pytest.approx(want, rel=1e-9) for s in windows)
    assert rep["n_devices"] == 1 and "mfu" not in rep     # no peak known for the CPU


def test_step_profiler_roofline_position():
    step, params, batch = _tiny_step()
    prof = obs.StepProfiler(step, registry=M.MetricsRegistry(),
                            tracer=obs.SpanTracer(trace_id="r", process=0),
                            peak_flops_per_chip=1e12, hbm_bw_bytes_per_s=1e11)
    state = step.init(params)
    state, _ = prof.run(state, batch, 2)
    rep = prof.report()
    roof = rep["roofline"]
    assert roof["t_roofline_s"] == pytest.approx(max(roof["t_mxu_s"], roof["t_hbm_lower_s"]))
    assert roof["vs_roofline"] > 0
    assert 0 < rep["mfu"] < 1
    assert 0 <= rep["exposed_comm_fraction"] <= 1
    assert prof.exposed_comm_fraction == rep["exposed_comm_fraction"]


@pytest.mark.slow
def test_profiler_overhead_guard():
    step, params, batch = _tiny_step()
    state = step.init(params)
    state, m = step.run(state, batch, 4)
    prof = obs.StepProfiler(step, registry=M.MetricsRegistry(),
                            tracer=obs.SpanTracer(trace_id="o", process=0))
    state, _ = prof.run(state, batch, 4)

    def window_plain():
        nonlocal state
        state, m = step.run(state, batch, 4)
        float(m["loss"][-1])

    def window_profiled():
        nonlocal state
        state, _ = prof.run(state, batch, 4)

    import time

    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        window_plain()
    plain = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        window_profiled()
    profiled = time.perf_counter() - t0
    assert profiled < plain * 2.0 + 0.25, (profiled, plain)


def test_window_cost_is_per_step_and_stacked_slices():
    step, params, batch = _tiny_step()
    state = step.init(params)
    c1 = step.window_cost(state, batch, 1)
    c4 = step.window_cost(state, batch, 4)
    assert c1 == c4
    assert c1["flops"] > 0 and c1["bytes_accessed"] > 0 and c1["temp_bytes"] > 0
    assert c1["output_bytes"] > 0 and c1["argument_bytes"] > c1["temp_bytes"] / 100
    stacked = tuple(torch.stack([t] * 3) for t in batch) if isinstance(batch, tuple) else \
        {k: torch.stack([t] * 3) for k, t in batch.items()}
    assert step.window_cost(state, stacked, 3, stacked=True) == c1


def test_window_cost_flops_at_most_jax_xla_count():
    jspec, params, batch = _inputs()
    step, tparams, tbatch = _port_step(params, batch)
    got = step.window_cost(step.init(tparams), tbatch, 1)
    jstep = _jax_step(jspec, params, batch)
    want = jstep.window_cost(jstep.init(params), batch, 1)
    print(f"mlp window_cost FLOPs: port {got['flops']:.0f}, JAX XLA {want['flops']:.0f} "
          f"(port / JAX {got['flops'] / want['flops']:.4f})")
    assert 0 < got["flops"] <= want["flops"]
    # The port's count is the walk of the loss's value and gradient: the
    # optimizer adds no product.
    from autodist_tpu.utils import roofline as jroofline

    walked = jroofline.traffic_bounds(jax.value_and_grad(jspec.loss_fn), params, batch)
    assert got["flops"] == walked["flops"]


def test_window_cost_on_a_split_mesh_raises_naming_the_roadmap(monkeypatch):
    step, params, batch = _tiny_step()
    monkeypatch.setitem(step.plan.mesh.shape, "model", 2)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        step.window_cost(step.init(params), batch, 1)


def _transformer_cost(impl, device=None):
    """``window_cost`` of a 1-layer bf16 transformer at seq 128 (the H100
    flash table's crossover) with ``attention_impl=impl``, its plan's
    device set to ``device`` (the walk runs on meta tensors, so a CPU
    install can count the step a card would run)."""
    AutoDist.reset_default()
    spec = get_model_spec("transformer", vocab_size=64, num_layers=1, d_model=32,
                          num_heads=2, d_ff=64, max_seq_len=128, attention_impl=impl,
                          dtype="bfloat16")
    params, batch = spec.init(0, device="cpu"), spec.example_batch(2, device="cpu")
    step = AutoDist(strategy_builder=AllReduce(), device="cpu").build(spec.loss_fn, params,
                                                                      batch)
    state = step.init(params)
    if device is not None:
        step.plan.mesh = dataclasses.replace(step.plan.mesh, device=torch.device(device))
    return step.window_cost(state, batch, 1)


def test_window_cost_resolves_auto_attention_on_the_steps_device():
    """Default "auto" counts the attention the step runs on its own
    device: on the card the flash kernels' work (the backward's
    recomputation, no score tensors in the bytes), on the CPU the dot
    path's (its crossover is 1024)."""
    flash, dot = _transformer_cost("flash"), _transformer_cost("dot")
    assert flash["flops"] > dot["flops"] and flash["bytes_accessed"] < dot["bytes_accessed"]
    assert _transformer_cost("auto", "cuda") == flash
    assert _transformer_cost("auto") == dot


def test_meta_resolves_as_is_per_thread():
    seen = []

    def other():
        seen.append(crossover.resolve_attention_impl("auto", 512, "meta", torch.bfloat16))

    with crossover.meta_resolves_as("cuda"):
        assert crossover.resolve_attention_impl("auto", 512, "meta", torch.bfloat16) == "flash"
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert seen == ["dot"]
    assert crossover.resolve_attention_impl("auto", 512, "meta", torch.bfloat16) == "dot"


def test_compile_log_records_fresh_programs():
    step, params, batch = _tiny_step()
    state = step.init(params)
    assert step.compile_log == []
    state, _ = step(state, batch)
    state, _ = step(state, batch)
    state, _ = step.run(state, batch, 3)
    state, _ = step.run(state, batch, 3)
    assert [e["program"] for e in step.compile_log] == ["step", "run[3]"]
    assert all(e["first_call_s"] > 0 for e in step.compile_log)


def test_detect_peak_flops():
    assert obs.detect_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert obs.detect_peak_flops("NVIDIA H100 SXM5 80GB") == 989e12
    assert obs.detect_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert obs.detect_peak_flops("NVIDIA H100 NVL") == 835e12
    assert obs.detect_peak_flops("NVIDIA A100-SXM4-80GB") is None
    assert obs.detect_peak_flops(torch.device("cpu")) is None


def test_unported_profiler_methods_name_the_roadmap():
    """``attribute`` waits for the program-level analysis (item 7);
    ``calibration_record`` is ported: the profile's measured step beside
    the strategy's analytic cost, as JAX's ``record_from_profiler`` pairs
    them."""
    from autodist_tpu_torch.strategy.cost_model import CostModel

    from autodist_tpu_torch.api import get_default_autodist

    step, params, batch = _tiny_step()
    prof = obs.StepProfiler(step, registry=M.MetricsRegistry())
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        prof.attribute(None, None)
    state = step.init(params)
    for _ in range(2):
        state, _ = prof.run(state, batch, 2)
    rep = prof.report()
    ad = get_default_autodist()
    cost = CostModel(ad.model_item, ad.resource_spec).strategy_cost(ad.strategy)
    rec = prof.calibration_record(cost, name="AllReduce")
    assert rec.name == "AllReduce" and rec.measured_s == rep["step_wall_s"] > 0
    assert rec.dispatch_gap_s == pytest.approx(rep["dispatch_gap_s"] / 2)
    assert rec.flops_per_step == rep["flops_per_step"] > 0
    assert rec.predicted_s == pytest.approx(cost.total_s)


# ------------------------------------------------------ recorder and sentry
def test_profiler_feeds_recorder_and_sentry(tmp_path):
    from autodist_tpu.obs.doctor import diagnose as jdiagnose

    step, params, batch = _tiny_step()
    rec = flight.enable(flight_dir(str(tmp_path)))
    sentry = obs.Sentry(config=obs.SentryConfig(min_history=8, hbm_min_history=8),
                        registry=M.MetricsRegistry(), recorder=rec)
    prof = obs.StepProfiler(step, registry=M.MetricsRegistry(),
                            tracer=obs.SpanTracer(trace_id="t", process=0), sentry=sentry)
    assert prof.recorder is rec
    state = step.init(params)
    for _ in range(3):
        state, _ = prof.run(state, batch, 4)
    rec.close(ok=True)
    records = read_records(flight_dir(str(tmp_path)))
    steps = [r for r in records if r.get("kind") == "step"]
    assert [r["step"] for r in steps] == [4, 8, 12]
    for r in steps:
        assert r["steps"] == 4 and r["step_wall_s"] > 0 and "loss" in r
        assert r["flops_per_step"] == prof.report()["flops_per_step"]
    assert any(r.get("kind") == "compile" for r in records)
    assert sentry.findings == []
    assert diagnose(str(tmp_path)).verdict == jdiagnose(str(tmp_path)).verdict == "clean"


def test_step_error_recorded_for_doctor(tmp_path):
    step, params, batch = _tiny_step()
    flight.enable(flight_dir(str(tmp_path)))
    state = step.init(params)
    bad = tuple(torch.zeros(3, 999) for _ in batch) if isinstance(batch, tuple) else \
        {k: torch.zeros(3, 999) for k in batch}
    with pytest.raises(Exception):
        step.run(state, bad, 2)
    errs = [r for r in read_records(flight_dir(str(tmp_path))) if r.get("kind") == "error"]
    assert errs and "run[2]" in errs[-1].get("program", "")
    assert diagnose(str(tmp_path)).verdict == "crash"


def test_obs_runtime_wires_flight_and_sentry(tmp_path):
    rt = obs.ObsRuntime(obs.ObsConfig(flight=True, flight_dir=str(tmp_path / "flight"),
                                      sentry=True), registry=M.MetricsRegistry())
    assert rt.recorder is not None and rt.sentry is not None
    assert rt.sentry.recorder is rt.recorder
    rt.close()
    recs = read_records(str(tmp_path / "flight"))
    assert recs and recs[-1]["kind"] == "run_end"


def test_obs_config_resolves_like_jax(tmp_path, monkeypatch):
    from autodist_tpu.obs.config import ObsConfig as JObsConfig

    monkeypatch.setenv("AUTODIST_FT_DIR", str(tmp_path))
    for kw in ({}, {"aggregate": True}, {"flight": False}, {"flight_dir": "/x/y"}):
        port, ref = obs.ObsConfig(**kw).resolved(), JObsConfig(**kw).resolved()
        assert {k: v for k, v in port.__dict__.items()} == \
            {k: v for k, v in ref.__dict__.items()}, kw
    monkeypatch.setenv("AUTODIST_NO_FLIGHT", "1")
    assert obs.ObsConfig(flight_dir="/x").resolved().flight is False


def test_obs_runtime_through_autodist(tmp_path, monkeypatch):
    monkeypatch.setenv("AUTODIST_FT_DIR", str(tmp_path / "ft"))
    # The runtime counts into the process-wide registry, which other tests
    # of this worker process (another file's profiled run) may have fed:
    # this run's counter starts from a fresh one.
    monkeypatch.setattr(M, "registry", M.MetricsRegistry())
    _, params, batch = _inputs()
    spec = get_model_spec("mlp", **MLP)
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu",
                  observability=obs.ObsConfig(metrics_path=str(tmp_path / "train.prom"),
                                              metrics_interval_s=60.0))
    assert ad.obs is not None and ad.obs.exporter is not None
    tparams = params_from_jax(params, device="cpu")
    step = ad.build(spec.loss_fn, tparams, td.to_torch(batch))
    prof = ad.obs.profiler(step)
    assert prof.recorder is ad.obs.recorder and prof.sentry is ad.obs.sentry
    state = step.init(tparams)
    state, _ = prof.run(state, td.to_torch(batch), 2)
    ad.obs.close()
    samples = obs.parse_openmetrics(open(tmp_path / "train.prom").read())
    assert samples[("obs_profiled_windows_total", "")] == 1
    assert diagnose(str(tmp_path / "ft")).verdict == "clean"


def test_obs_runtime_attaches_the_ft_monitor(tmp_path):
    from autodist_tpu_torch.ft import FTConfig

    ad = AutoDist(strategy_builder=AllReduce(), device="cpu",
                  fault_tolerance=FTConfig(base_dir=str(tmp_path), heartbeat_interval_s=60.0),
                  observability=obs.ObsConfig(flight_dir=str(tmp_path / "flight"),
                                              aggregate=True,
                                              aggregate_dir=str(tmp_path / "obs")))
    try:
        assert ad.obs.sentry.monitor is ad.ft.monitor
        assert ad.obs.aggregator.monitor is ad.ft.monitor
    finally:
        ad.obs.close()
        ad.ft.shutdown()


# ------------------------------------------------------------- record_norms
def test_record_norms_match_jax_on_one_rank():
    jspec, params, batch = _inputs(1)
    jopt = jmi.OptimizerSpec("adam", {"learning_rate": 1e-2}, clip_norm=0.5)
    jstep = _jax_step(jspec, params, batch, opt=jopt, record_norms=True)
    _, jm = jstep.run(jstep.init(params), batch, 3)
    step, tparams, tbatch = _port_step(
        params, batch, optimizer=OptimizerSpec("adam", {"learning_rate": 1e-2}, clip_norm=0.5),
        record_norms=True)
    _, m = step.run(step.init(tparams), tbatch, 3)
    for key in ("grad_norm", "update_norm"):
        assert m[key].shape == (3,)
        np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]), rtol=NORM_RTOL,
                                   err_msg=key)
    AutoDist.reset_default()
    plain, _, _ = _port_step(params, batch)
    assert set(plain.run(plain.init(tparams), tbatch, 1)[1]) == {"loss"}


SMALL = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4, d_ff=64, max_seq_len=16,
             attention_impl="dot")
NORM_CASES = [
    dict(id="norms/tp", model="transformer", zoo="transformer", builder="TensorParallel",
         builder_kwargs={}, opt="adam", opt_kwargs={"learning_rate": 1e-2}, clip_norm=None,
         steps=3, mesh={"data": 2, "model": 2}, mesh_axes=("data", "model"),
         overrides=dict(SMALL, dtype="float32"), record_norms=True),
    dict(td.case("norms/zero1", "dense", "Zero1", {}, "adam"), record_norms=True),
]


def _jax_norms(c, params, batch, loss_fn):
    """JAX's per-step norms of a case on a 4-device mesh of its shape."""
    rs = JResourceSpec(resource_dict={
        "nodes": [{"address": "localhost", "chips": 4, "chief": True}],
        **({"mesh": c["mesh"]} if c.get("mesh") else {})})
    opt = jmi.OptimizerSpec(c["opt"], dict(c["opt_kwargs"]), clip_norm=c["clip_norm"])
    item = jmi.ModelItem.from_params(params, optimizer_spec=opt, loss_fn=loss_fn,
                                     example_batch=batch)
    strategy = jstrat.StrategyCompiler(item).compile(
        jstrat.from_name(c["builder"], **c["builder_kwargs"]).build(item, rs))
    axes = {"axes": c["mesh_axes"]} if c.get("mesh_axes") else {}
    mesh = jbuild_mesh(rs, devices=jax.devices()[:4], **axes)
    step = JStep(JGraphTransformer(strategy, item, mesh).transform(), loss_fn, opt.make(),
                 record_norms=True)
    state, out = step.init(params), []
    for _ in range(c["steps"]):
        state, m = step(state, batch)
        out.append({k: float(m[k]) for k in ("grad_norm", "update_norm")})
    return out


def test_record_norms_match_jax_on_four_ranks(tmp_path):
    jspec = jax_get_model("transformer", **dict(SMALL, dtype=jnp.float32))
    rng = np.random.default_rng(2)
    tparams = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(s.dtype),
                           jax.eval_shape(jspec.init, jax.random.PRNGKey(0)))
    np_inputs = dict(td.inputs(), transformer=(
        tparams, jax.tree.map(np.asarray, jspec.example_batch(8))))
    torch_inputs = {k: (params_from_jax(p, device="cpu"), td.to_torch(b))
                    for k, (p, b) in np_inputs.items() if k in ("transformer", "dense")}
    results = td.run_ranks(tmp_path, torch_inputs, NORM_CASES)
    losses = {"transformer": jspec.loss_fn, "dense": td.JAX_LOSSES["dense"]}
    for c in NORM_CASES:
        got = results[0][c["id"]]["norms"]
        for rank, res in enumerate(results[1:], 1):
            assert res[c["id"]]["norms"] == got, (c["id"], rank)
        want = _jax_norms(c, *np_inputs[c["model"]], losses[c["model"]])
        assert len(got) == len(want) == c["steps"]
        for g, w in zip(got, want):
            for key in ("grad_norm", "update_norm"):
                np.testing.assert_allclose(g[key], w[key], rtol=NORM_RTOL,
                                           err_msg=f"{c['id']} {key}")
    split = [n for n, (kind, _) in results[0]["norms/tp"]["renderings"].items()
             if kind == "partitioned"]
    assert split


# ------------------------------------------------------------------ seams
def _poison(batch, **ctx):
    return tuple(torch.full_like(t, float("nan")) if t.is_floating_point() else t
                 for t in batch) if isinstance(batch, tuple) else \
        {k: torch.full_like(t, float("nan")) if t.is_floating_point() else t
         for k, t in batch.items()}


def test_batch_plant_trips_snt001_in_a_profiled_run():
    step, params, batch = _tiny_step()
    sentry = obs.Sentry(registry=M.MetricsRegistry())
    prof = obs.StepProfiler(step, registry=M.MetricsRegistry(), recorder=None, sentry=sentry,
                            tracer=obs.SpanTracer(trace_id="c", process=0))
    state = step.init(params)
    state, _ = prof.run(state, batch, 2)
    assert sentry.codes() == []
    chaos_hooks.install(chaos_hooks.SEAM_TRAIN_BATCH, _poison)
    state, m = prof.run(state, batch, 2)
    assert not np.isfinite(float(m["loss"][-1]))
    assert sentry.codes() == ["SNT001"]


def test_seams_see_jax_context():
    jspec, params, batch = _inputs()
    step, tparams, tbatch = _port_step(params, batch)
    jstep = _jax_step(jspec, params, batch)
    seen = {"port": [], "jax": []}

    def record(who):
        def on_batch(b, **ctx):
            seen[who].append(("batch", ctx))
            return b

        def on_metrics(m, **ctx):
            seen[who].append(("metrics", sorted(m), ctx))
            return m
        return on_batch, on_metrics

    from autodist_tpu.chaos import hooks as jhooks

    for who, hooks, st, s, b in (("port", chaos_hooks, step.init(tparams), step, tbatch),
                                 ("jax", jhooks, jstep.init(params), jstep, batch)):
        on_batch, on_metrics = record(who)
        hooks.install(hooks.SEAM_TRAIN_BATCH, on_batch)
        hooks.install(hooks.SEAM_TRAIN_METRICS, on_metrics)
        try:
            st, _ = s(st, b)
            st, _ = s.run(st, b, 3)
        finally:
            hooks.clear()
    assert seen["port"] == seen["jax"]


def test_empty_registry_costs_one_predicate_call(monkeypatch):
    step, params, batch = _tiny_step()
    state = step.init(params)
    calls = Counter()
    real_active = chaos_hooks.active

    def active():
        calls["active"] += 1
        return real_active()

    def apply(*a, **k):
        raise AssertionError("apply without a plant")

    monkeypatch.setattr(chaos_hooks, "active", active)
    monkeypatch.setattr(chaos_hooks, "apply", apply)
    state, _ = step(state, batch)
    assert calls["active"] == 1
    state, _ = step.run(state, batch, 3)
    assert calls["active"] == 2


# ---------------------------------------------------------------- tune audit
def test_tune_audit_recording():
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    tracer = obs_spans.get_tracer()
    before = Counter(s.name for s in tracer.spans())
    ad._record_tune_obs([("AllReduce", 0.002), ("PS", 0.005), ("Broken", float("inf"))],
                        "AllReduce")
    assert ad.last_tune_results["selected"] == "AllReduce"
    assert ad.last_tune_results["measured"]["PS"] == 0.005
    snap = M.registry.snapshot()
    assert snap["tune_measured_ms_AllReduce"] == pytest.approx(2.0)
    assert snap["tune_measured_ms_PS"] == pytest.approx(5.0)
    assert "tune_measured_ms_Broken" not in snap
    assert snap["tune_selected_ms"] == pytest.approx(2.0)
    after = Counter(s.name for s in tracer.spans())
    assert after["tune.candidate"] - before["tune.candidate"] == 3
    cands = [s for s in tracer.spans() if s.name == "tune.candidate"]
    sel = [s for s in cands if s.attrs.get("selected")]
    assert sel and sel[-1].attrs["candidate"] == "AllReduce"
    assert any(s.attrs.get("failed") and s.attrs["candidate"] == "Broken" for s in cands)


def test_tune_records_its_sweep():
    _, params, batch = _inputs()
    spec = get_model_spec("mlp", **MLP)
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    tparams = params_from_jax(params, device="cpu")
    before = Counter(s.name for s in obs_spans.get_tracer().spans())
    ad.tune(spec.loss_fn, tparams, td.to_torch(batch),
            candidates=[("AllReduce", AllReduce()), ("PS", PS())], window=2)
    after = Counter(s.name for s in obs_spans.get_tracer().spans())
    assert after["tune.candidate"] - before["tune.candidate"] == 2
    selected = ad.last_tune_results["selected"]
    assert M.registry.snapshot()["tune_selected_ms"] == pytest.approx(
        ad.last_tune_results["measured"][selected] * 1e3)
