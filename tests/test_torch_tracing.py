"""Port parity: ``utils/tracing.py`` and ``DistributedTrainStep.trace_step``
against the JAX package's (``tests/test_tracing.py``).

``trace`` writes a ``torch.profiler`` Chrome trace where JAX's writes an
xplane; ``trace_step`` returns ``((state, metrics), trace_dir)`` as JAX's
does, its loss equal to JAX's step's on the same numpy inputs (1e-6
relative), and its trace holds the step's ops. ``dump_hlo`` writes the
same file, byte for byte, as JAX's. (``dump_compiled`` and
``AUTODIST_DUMP_HLO`` wait for the port's program text, ROADMAP.md Queue
1 item 7.)
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from autodist_tpu.utils import tracing as jtracing
from autodist_tpu_torch import const
from autodist_tpu_torch.api import AutoDist
from autodist_tpu_torch.obs import profiler
from autodist_tpu_torch.strategy import AllReduce
from autodist_tpu_torch.utils import tracing


@pytest.fixture(autouse=True)
def _fresh():
    AutoDist.reset_default()
    yield
    AutoDist.reset_default()


def _events(trace_dir):
    with open(os.path.join(trace_dir, tracing.TRACE_FILE), encoding="utf-8") as f:
        return json.load(f)["traceEvents"]


def test_dump_hlo_writes_the_same_stage_file_as_jax(tmp_path):
    p = tracing.dump_hlo("t", "0-stablehlo", "module {}", hlo_dir=str(tmp_path / "port"))
    j = jtracing.dump_hlo("t", "0-stablehlo", "module {}", hlo_dir=str(tmp_path / "jax"))
    assert os.path.basename(p) == os.path.basename(j)
    assert open(p, "rb").read() == open(j, "rb").read() == b"module {}"


def test_dump_hlo_falls_back_to_default_hlo_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(const, "DEFAULT_HLO_DIR", str(tmp_path))
    p = tracing.dump_hlo("step", "1-fx", "graph()")
    assert os.path.dirname(p) == str(tmp_path) and open(p).read() == "graph()"


def test_step_timer_summary():
    t = tracing.StepTimer(items_per_step=128, warmup=1)
    for _ in range(4):
        with t:
            time.sleep(0.01)
    s = t.summary()
    assert s["steps"] == 4 and s["measured"] == 3
    assert s["mean_s"] >= 0.009
    assert s["items_per_sec"] == pytest.approx(128 / s["mean_s"])
    assert tracing.StepTimer is profiler.StepTimer
    assert tracing.StepTimer(warmup=2).summary() == {"steps": 0, "measured": 0}


def test_trace_context_writes_a_chrome_trace(tmp_path):
    with tracing.trace("unit", trace_dir=str(tmp_path / "tr")) as d:
        torch.mm(torch.ones(16, 16), torch.ones(16, 16))
        with tracing.annotate("inner-region"):
            torch.relu(torch.ones(8))
    assert d == str(tmp_path / "tr")
    names = {e.get("name") for e in _events(d)}
    assert {"aten::mm", "unit", "inner-region", "aten::relu"} <= names


def test_trace_default_dir_is_under_the_trace_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(const, "DEFAULT_TRACE_DIR", str(tmp_path))
    with tracing.trace("named") as d:
        torch.ones(2).sum()
    assert os.path.dirname(d) == str(tmp_path) and os.path.basename(d).startswith("named-")
    assert os.path.exists(os.path.join(d, tracing.TRACE_FILE))


def test_trace_step_returns_result_and_dir_like_jax(tmp_path, monkeypatch):
    import jax.numpy as jnp

    from autodist_tpu import strategy as jstrat
    from autodist_tpu.api import AutoDist as JAutoDist
    from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec

    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 1)).astype(np.float32)
    x = rng.standard_normal((16, 3)).astype(np.float32)

    JAutoDist.reset_default()
    try:
        jad = JAutoDist(resource_spec=JResourceSpec(resource_dict={
            "nodes": [{"address": "localhost", "chips": 8, "chief": True}]}),
            strategy_builder=jstrat.AllReduce())
        jstep = jad.build(lambda p, b: ((b["x"] @ p["w"]) ** 2).mean(), {"w": w}, {"x": x})
        monkeypatch.setattr(jtracing.const, "DEFAULT_TRACE_DIR", str(tmp_path / "jax"),
                            raising=False)
        (_, jmetrics), jdir = jstep.trace_step(jstep.init({"w": w}), {"x": x})
    finally:
        JAutoDist.reset_default()

    monkeypatch.setattr(const, "DEFAULT_TRACE_DIR", str(tmp_path / "port"))
    ad = AutoDist(strategy_builder=AllReduce(), device="cpu")
    params = {"w": torch.from_numpy(w.copy())}
    step = ad.build(lambda p, b: ((b["x"] @ p["w"]) ** 2).mean(), params,
                    {"x": torch.from_numpy(x)})
    (state, metrics), d = step.trace_step(step.init(params), {"x": torch.from_numpy(x)})
    assert os.path.isdir(d) and os.path.isdir(jdir)
    assert os.path.dirname(d) == str(tmp_path / "port")
    assert float(metrics["loss"]) == pytest.approx(float(jnp.asarray(jmetrics["loss"])),
                                                   rel=1e-6)
    assert state.step == 1
    names = {e.get("name") for e in _events(d)}
    assert "train_step" in names and "aten::mm" in names
    assert [e["program"] for e in step.compile_log] == ["step"]
