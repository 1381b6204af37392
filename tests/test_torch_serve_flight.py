"""Port parity: the serving flight hooks — flight records, spans and chaos
seams of the batcher, the engine, the page pool and the speculative engine
— against the JAX package's, on the same requests and weights.

One seeded batcher run (requests queued before the scheduler starts, so
both packages take the same ticks) with a flight directory and spans on:
the record kinds and their fields, the deterministic fields' values, the
span names and attributes, and the fire count of every seam must equal
JAX's. Then the shed windows, ``die``, ``try_submit`` under a dead engine,
an engine death and page exhaustion through the seams, and the
speculative round's seams, span and record.
"""
import collections
import time

import numpy as np
import pytest

from autodist_tpu import metrics as JM
from autodist_tpu.chaos import hooks as jhooks
from autodist_tpu.obs import recorder as jrecorder
from autodist_tpu.obs import slo as jslo
from autodist_tpu.obs import spans as jspans
from autodist_tpu.serve.batcher import ContinuousBatcher as JBatcher
from autodist_tpu.serve.engine import EngineDeadError as JEngineDead
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.chaos import hooks
from autodist_tpu_torch.obs import SLOSpec, SLOTracker, recorder, spans
from autodist_tpu_torch.serve.batcher import Backpressure, ContinuousBatcher, RequestState
from autodist_tpu_torch.serve.engine import EngineDeadError
from helpers.torch_serve import engine_pair, prompts, record_shapes
from helpers.torch_spec import np_tree, port, rig  # noqa: F401
from helpers.torch_threads import one_torch_thread  # noqa: F401

MAX_NEW = 6
FIRE_SEAMS = ("SEAM_SERVE_ADMIT", "SEAM_SERVE_STEP", "SEAM_SERVE_PAGES", "SEAM_SERVE_DRAFT")
PORT = dict(batcher=ContinuousBatcher, registry=M.MetricsRegistry, hooks=hooks,
            recorder=recorder, spans=spans, slo=SLOTracker, spec=SLOSpec,
            dead=EngineDeadError)
JAX = dict(batcher=JBatcher, registry=JM.MetricsRegistry, hooks=jhooks,
           recorder=jrecorder, spans=jspans, slo=jslo.SLOTracker, spec=jslo.SLOSpec,
           dead=JEngineDead)


@pytest.fixture(scope="module")
def engines():
    return engine_pair(n_slots=8)


@pytest.fixture
def observed(tmp_path):
    """Count every fire seam in both packages, record flights into
    ``tmp_path/<side>`` and clear both span tracers; undone afterwards."""
    fires = {"port": collections.Counter(), "jax": collections.Counter()}
    for side, pkg in (("port", PORT), ("jax", JAX)):
        h = pkg["hooks"]
        for name in FIRE_SEAMS:
            h.install(getattr(h, name),
                      lambda _n=name, _c=fires[side], **ctx: _c.update([_n]))
        pkg["recorder"].enable(str(tmp_path / side))
        pkg["spans"].get_tracer().clear()
    yield fires
    for pkg in (PORT, JAX):
        pkg["hooks"].clear()
        pkg["recorder"].disable()
        pkg["spans"].get_tracer().clear()


def _run(pkg, engine, ps, rids, slo=None, **kw):
    batcher = pkg["batcher"](engine, registry=pkg["registry"](), slo=slo, **kw)
    reqs = [batcher.submit(p, MAX_NEW, request_id=rid) for p, rid in zip(ps, rids)]
    batcher.start()
    for r in reqs:
        r.wait(timeout=120)
    batcher.stop()
    return reqs


DETERMINISTIC = {
    ("step", "admit"): ("request_id", "prompt_len", "pages", "cached_tokens",
                        "pool_used", "pool_free"),
    ("step", "prefilled"): ("prompt_len", "chunks", "cached"),
    ("step", "request"): ("request_id", "state", "n_tokens", "cached", "temperature"),
    ("step", "decode"): ("decode_steps", "active_slots", "pool_utilization"),
    ("step", "tick"): ("active", "prefilling", "decoding", "pool_utilization",
                       "queue_depth"),
}


def test_batcher_run_records_spans_and_seams_equal_jax(tmp_path, engines, observed):
    jeng, teng = engines
    ps = prompts(20, seed=5, hi=28)
    rids = [f"f-{i}" for i in range(len(ps))]
    out = {}
    for side, pkg, eng in (("port", PORT, teng), ("jax", JAX, jeng)):
        tracker = pkg["slo"](registry=pkg["registry"]())
        reqs = _run(pkg, eng, ps, rids, slo=tracker)
        pkg["recorder"].disable()
        recs = pkg["recorder"].read_records(str(tmp_path / side))
        sp = pkg["spans"].get_tracer().spans()
        out[side] = dict(
            streams=[r.tokens for r in reqs], records=recs, shapes=record_shapes(recs),
            spans=collections.Counter(s.name for s in sp),
            span_attrs={s.name: sorted(s.attrs) for s in sp},
            report=tracker.report())
    port_, jax_ = out["port"], out["jax"]
    assert port_["streams"] == jax_["streams"]
    assert port_["shapes"] == jax_["shapes"]
    assert set(port_["shapes"]) >= {("step", "admit"), ("step", "prefilled"),
                                    ("step", "request"), ("step", "decode"),
                                    ("step", "tick"), ("pool_pressure", None)}
    for key, fields in DETERMINISTIC.items():
        rows = {side: [tuple(r.get(f) for f in fields) for r in o["records"]
                       if (r["kind"], r.get("event")) == key]
                for side, o in out.items()}
        assert rows["port"] == rows["jax"], key
    assert port_["spans"] == jax_["spans"]
    assert set(port_["spans"]) == {"serve.queue_wait", "serve.prefill_chunk",
                                   "serve.decode_step"}
    assert port_["span_attrs"] == jax_["span_attrs"]
    assert observed["port"] == observed["jax"]
    assert observed["port"]["SEAM_SERVE_STEP"] > 0 and observed["port"]["SEAM_SERVE_ADMIT"] > 0
    # The SLO feed saw the same requests (latencies differ: two engines).
    for key in ("requests", "errors", "sheds", "window_requests", "greedy_streams"):
        assert port_["report"]["counts"][key] == jax_["report"]["counts"][key] == \
            {"errors": 0, "sheds": 0}.get(key, len(ps))
    assert teng.pool.used_pages == 0


def test_prefix_copy_on_write_span_equals_jax(observed):
    from autodist_tpu.serve.server import _tiny_engine
    from helpers.torch_serve import TINY
    from autodist_tpu_torch.models import get_model
    from autodist_tpu_torch.models.convert import params_from_jax
    from autodist_tpu_torch.models.transformer import decode_model
    from autodist_tpu_torch.serve.engine import InferenceEngine

    jeng, jparams, _ = _tiny_engine(n_slots=8, prefix_cache=True)
    teng = InferenceEngine(params_from_jax(np_tree(jparams), device="cpu"),
                           decode_model(get_model("transformer", **TINY)), n_slots=8,
                           page_len=8, n_pages=jeng.pool.n_pages, prefill_chunk=8,
                           device="cpu", prefix_cache=True)
    base = list(range(1, 20))
    for eng in (teng, jeng):
        eng.generate(np.asarray(base, np.int32), 4)
        eng.generate(np.asarray(base[:13] + [50, 51], np.int32), 4)   # diverges mid-page
    got = [(s.name, sorted(s.attrs)) for s in spans.get_tracer().spans()
           if s.name == "serve.cow_copy"]
    want = [(s.name, sorted(s.attrs)) for s in jspans.get_tracer().spans()
            if s.name == "serve.cow_copy"]
    assert got == want == [("serve.cow_copy", ["dst", "src"])]


def _shed_events(pkg, d):
    return [(r["reason"], r["total_shed"], r["src"].split("-")[0])
            for r in pkg["recorder"].read_records(d) if r["kind"] == "shed"]


def test_shed_windows_equal_jax(tmp_path, engines, observed):
    """One shed event opens each fixed window and carries the cumulative
    count; the SLO tracker counts every shed."""
    jeng, teng = engines
    out = {}
    for side, pkg, eng in (("port", PORT, teng), ("jax", JAX, jeng)):
        tracker = pkg["slo"](registry=pkg["registry"]())
        b = pkg["batcher"](eng, max_queue=2, registry=pkg["registry"](), slo=tracker)
        b._SHED_WINDOW_S = 3600.0
        for i in range(7):                         # 2 queued, 5 shed in one window
            b.try_submit([1, 2, 3], 4, request_id=f"s-{i}")
        b.try_submit(list(range(1, 70)), 4)         # unservable: shed, typed 400
        b._SHED_WINDOW_S = -1.0                     # every shed opens a window
        for i in range(2):
            b.try_submit([1, 2, 3], 4)
        b.stop(drain=False)
        pkg["recorder"].disable()
        out[side] = (_shed_events(pkg, str(tmp_path / side)),
                     tracker.report()["counts"]["sheds"])
    assert out["port"] == out["jax"]
    events, sheds = out["port"]
    assert [n for _, n, _ in events] == [1, 7, 8] and sheds == 8
    assert events[0][0] == "admission queue full (2 requests)"


def test_die_sheds_all_work_typed_like_jax(tmp_path, engines, observed):
    jeng, teng = engines
    out = {}
    for side, pkg, eng in (("port", PORT, teng), ("jax", JAX, jeng)):
        b = pkg["batcher"](eng, registry=pkg["registry"]())
        reqs = [b.submit(p, MAX_NEW) for p in prompts(11, seed=6)]
        b._tick()                                   # 8 active, 3 queued
        active = eng.active_slots
        b.die("chaos kill")
        late = b.try_submit([1, 2, 3], 4)
        pkg["recorder"].disable()
        kinds = [r["kind"] for r in pkg["recorder"].read_records(str(tmp_path / side))
                 if r["kind"] in ("error", "shed")]
        out[side] = (active, [(r.state.value, r.error) for r in reqs],
                     (late.state.value, late.error), kinds, eng.pool.used_pages,
                     b.stopped)
        b.die("again")                              # idempotent
    assert out["port"] == out["jax"]
    active, states, late, kinds, used, stopped = out["port"]
    assert active == 8 and used == 0 and stopped
    assert set(states) == {("rejected", "engine died mid-decode: chaos kill")}
    assert late == ("rejected", "admission rejected: batcher is stopped")
    assert kinds == ["error", "shed"]


def test_engine_death_at_the_step_seam_sheds_typed(tmp_path, engines, observed):
    jeng, teng = engines
    out = {}
    for side, pkg, eng in (("port", PORT, teng), ("jax", JAX, jeng)):
        h = pkg["hooks"]

        def boom(_dead=pkg["dead"], **ctx):
            raise _dead(f"chaos: engine died on host {ctx['host']}")

        h.install(h.SEAM_SERVE_STEP, boom)
        b = pkg["batcher"](eng, registry=pkg["registry"]())
        reqs = [b.submit(p, MAX_NEW) for p in prompts(6, seed=7)]
        t0 = time.monotonic()
        b.start()
        assert all(r.wait(timeout=60).done for r in reqs)
        waited = time.monotonic() - t0
        pkg["recorder"].disable()
        errors = [r["error"] for r in pkg["recorder"].read_records(str(tmp_path / side))
                  if r["kind"] == "error"]
        out[side] = ([(r.state.value, r.error) for r in reqs], errors,
                     eng.pool.used_pages, b.stopped)
        b.stop(drain=False)
        assert waited < 30
    assert out["port"] == out["jax"]
    states, errors, used, stopped = out["port"]
    assert set(states) == {("rejected",
                            "engine died mid-decode: chaos: engine died on host 0")}
    assert errors == ["EngineDeadError: chaos: engine died on host 0"]
    assert used == 0 and stopped


@pytest.mark.parametrize("seam,directive", [("SEAM_SERVE_PAGES", "exhaust"),
                                            ("SEAM_SERVE_ADMIT", "defer")])
def test_admission_pressure_seams_defer_then_recover(tmp_path, engines, observed,
                                                     seam, directive):
    """An exhaustion (or deferral) window keeps every request queued with
    one pool_pressure event a window; when it closes, all complete."""
    jeng, teng = engines
    out = {}
    for side, pkg, eng in (("port", PORT, teng), ("jax", JAX, jeng)):
        h = pkg["hooks"]
        h.install(getattr(h, seam), lambda **ctx: directive)
        b = pkg["batcher"](eng, registry=pkg["registry"]())
        b._SHED_WINDOW_S = 3600.0
        reqs = [b.submit(p, MAX_NEW) for p in prompts(5, seed=8)]
        b.start()
        time.sleep(0.3)
        stalled = (b.outstanding, eng.active_slots)
        h.install(getattr(h, seam), lambda **ctx: None)
        assert all(r.wait(timeout=120).state.value == "done" for r in reqs)
        b.stop()
        pkg["recorder"].disable()
        pressure = [r["reason"] for r in
                    pkg["recorder"].read_records(str(tmp_path / side))
                    if r["kind"] == "pool_pressure"]
        out[side] = (stalled, pressure[:1], len(pressure), eng.pool.used_pages)
    assert out["port"] == out["jax"]
    stalled, first, n, used = out["port"]
    assert stalled == (5, 0) and n == 1 and used == 0


def test_spec_round_seams_span_and_record_equal_jax(tmp_path, rig, port, observed):  # noqa: F811
    """The spec round fires SEAM_SERVE_STEP and SEAM_SERVE_DRAFT; a garbage
    draft leaves the stream the target's; the verify span and the sampled
    decode record carry JAX's fields."""
    plain, spec = port
    jspec = rig.spec_engine(spec_k=3, same_draft=False)
    teng = spec(3, False)
    prompt = np.array([5, 17, 3, 88, 2, 9, 40, 41, 7], np.int32)
    want = plain.generate(prompt, 10)
    spans.get_tracer().clear()                      # the spec runs only
    observed["port"].clear()
    for side, h in (("port", hooks), ("jax", jhooks)):
        h.install(h.SEAM_SERVE_DRAFT, lambda _c=observed[side], **ctx:
                  _c.update(["SEAM_SERVE_DRAFT"]) or "garbage")
    got = teng.generate(prompt, 10, request_id="g")
    jgot = jspec.generate(prompt, 10, request_id="g")
    assert got == jgot == want
    assert teng.spec_stats()["accepted"] == jspec.spec_stats()["accepted"]
    assert teng.spec_stats()["rounds"] == jspec.spec_stats()["rounds"]
    for pkg in (PORT, JAX):
        pkg["recorder"].disable()
    shapes = {side: record_shapes(pkg["recorder"].read_records(str(tmp_path / side)))
              for side, pkg in (("port", PORT), ("jax", JAX))}
    assert shapes["port"][("step", "decode")] == shapes["jax"][("step", "decode")]
    assert "spec_rounds" in shapes["port"][("step", "decode")]
    names = {side: collections.Counter(s.name for s in pkg["spans"].get_tracer().spans())
             for side, pkg in (("port", PORT), ("jax", JAX))}
    assert names["port"] == names["jax"] and names["port"]["serve.spec_verify"] > 0
    verify = [sorted(s.attrs) for s in spans.get_tracer().spans()
              if s.name == "serve.spec_verify"]
    assert verify[0] == ["active", "k", "request_ids"]
    # The seam counts of the spec run: the round's two seams, JAX's counts.
    assert observed["port"]["SEAM_SERVE_DRAFT"] == observed["jax"]["SEAM_SERVE_DRAFT"] > 0
    assert observed["port"]["SEAM_SERVE_STEP"] == observed["jax"]["SEAM_SERVE_STEP"]


def test_on_tick_observes_progressing_ticks(engines):
    _, teng = engines
    ticks = []
    b = ContinuousBatcher(teng, registry=M.MetricsRegistry(), on_tick=ticks.append)
    reqs = [b.submit(p, 3) for p in prompts(3, seed=9)]
    b.start()
    for r in reqs:
        r.wait(timeout=60)
    b.stop()
    assert all(r.state is RequestState.DONE for r in reqs)
    assert len(ticks) >= 3 and all(t >= 0 for t in ticks)


def test_try_submit_after_stop_is_typed(engines):
    _, teng = engines
    b = ContinuousBatcher(teng, registry=M.MetricsRegistry()).start()
    b.stop()
    with pytest.raises(Backpressure, match="stopped"):
        b.submit([1, 2], 2)
    assert b.try_submit([1, 2], 2).state is RequestState.REJECTED
