"""Port parity: the single-engine serving proofs (``serve/server.py::
selftest`` and ``_selftest_quant``) and their CLI.

The JAX package's proofs run as its CLI does (``python -m autodist_tpu.serve
--selftest [--kv-quant]``, one CPU device: the JAX engines round their rows
up to the mesh's data degree, so on the 8-device test mesh the bucketed
baseline would hold twice its rows). The port's run in process with
``device="cpu"`` on the same seed, and both return 0. Their JSON lines
carry JAX's keys, and every bar agrees: capacities, pool sizes and bytes,
the ratios, the bit-equality flags, the memory pass's verdict, dropped
requests and programs (exactly 2); the int8 logit drift of each side lies
under the shared bound 0.05 (the two packages' random weights differ).
The port's CLI (``python -m autodist_tpu_torch.serve --selftest --device
cpu`` and with ``--kv-quant``) exits 0, and a bar forced to fail (the
concurrency probe, the drift probe) exits 1.
"""
import json
import os
import subprocess
import sys

import pytest

from autodist_tpu_torch.serve import server
from autodist_tpu_torch.serve.__main__ import main
from helpers.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EQUAL = {
    "off": ("ok", "n_requests", "completed", "dropped", "tokens_generated",
            "queue_depth_final", "paged_capacity", "bucketed_capacity",
            "concurrency_x_vs_bucketed", "kv_pool_tokens", "paged_vs_bucketed_bit_equal",
            "kernel_vs_gather_bit_equal", "kv_quant", "programs_compiled", "page_len",
            "n_pages", "n_slots", "device"),
    "on": ("ok", "kv_quant", "n_requests", "completed", "dropped", "pool_bytes",
           "fp_pool_bytes", "n_pages_quant", "n_pages_fp", "quant_capacity_x",
           "quant_capacity", "fp_capacity", "concurrency_x_vs_fp", "logit_drift_bound",
           "kernel_vs_gather_bit_equal", "analyzer_prices_quant", "programs_compiled",
           "quant_pool_gauge_bytes", "page_len", "device"),
}
RUNS = {"jax-off": ("autodist_tpu.serve", ()),
        "jax-on": ("autodist_tpu.serve", ("--kv-quant",)),
        "port-off": ("autodist_tpu_torch.serve", ("--device", "cpu")),
        "port-on": ("autodist_tpu_torch.serve", ("--device", "cpu", "--kv-quant"))}


@pytest.fixture(scope="module")
def cli_runs():
    """{run: (exit code, last stdout line as JSON)} of the four CLI runs,
    started together (one CPU device for JAX, one torch thread for the
    port)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env["XLA_FLAGS"] = " ".join(f for f in env.get("XLA_FLAGS", "").split()
                                if "xla_force_host_platform_device_count" not in f)
    procs = {name: subprocess.Popen([sys.executable, "-m", module, "--selftest", *extra],
                                    cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, (module, extra) in RUNS.items()}
    out = {}
    try:
        for name, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            lines = stdout.strip().splitlines()
            assert lines, f"{name}: no output; stderr:\n{stderr[-2000:]}"
            out[name] = (proc.returncode, json.loads(lines[-1]))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _agree(got, want, kv_quant):
    assert set(want) <= set(got), set(want) - set(got)
    for key in EQUAL[kv_quant]:
        assert got[key] == want[key], (key, got[key], want[key])


def test_selftest_bars_match_jax(cli_runs, capsys):
    assert server.selftest(device="cpu") == 0
    got = _last_json(capsys)
    assert got["selftest"] == "autodist_tpu_torch.serve"
    rc, want = cli_runs["jax-off"]
    assert rc == 0 and want["ok"]
    _agree(got, want, "off")
    assert got["dropped"] == 0 and got["programs_compiled"] == 2
    assert got["concurrency_x_vs_bucketed"] >= 2.0
    assert got["batched_tokens_per_sec"] > got["sequential_tokens_per_sec"]


def test_selftest_quant_bars_match_jax(cli_runs, capsys):
    assert server._selftest_quant(device="cpu") == 0
    got = _last_json(capsys)
    assert got["selftest"] == "autodist_tpu_torch.serve.kv_quant"
    rc, want = cli_runs["jax-on"]
    assert rc == 0 and want["ok"]
    _agree(got, want, "on")
    for line in (got, want):
        assert line["logit_drift"] < line["logit_drift_bound"] == \
            server.QUANT_LOGIT_DRIFT_BOUND == 0.05
    assert got["quant_capacity_x"] == 3.2 and got["concurrency_x_vs_fp"] >= 2.0


@pytest.mark.parametrize("kv_quant", ["off", "on"])
def test_cli_selftest_exits_zero(cli_runs, kv_quant):
    rc, line = cli_runs[f"port-{kv_quant}"]
    assert rc == 0 and line["ok"] and line["device"] == "cpu"
    assert line["kv_quant"] == kv_quant
    _agree(line, cli_runs[f"jax-{kv_quant}"][1], kv_quant)


@pytest.mark.parametrize("bar", ["concurrency", "drift"])
def test_failed_bar_exits_one(bar, monkeypatch, capsys):
    argv = ["--selftest", "--device", "cpu", "--requests", "8"]
    if bar == "concurrency":
        monkeypatch.setattr(server, "_admission_capacity", lambda *a, **k: 1)
    else:
        monkeypatch.setattr(server, "_quant_logit_drift", lambda *a, **k: 1.0)
        argv.append("--kv-quant")
    assert main(argv) == 1
    line = _last_json(capsys)
    assert line["ok"] is False and line["completed"] == 8
    if bar == "concurrency":
        assert line["concurrency_x_vs_bucketed"] == 1.0
    else:
        assert line["logit_drift"] == 1.0
