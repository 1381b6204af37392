"""Port parity: one supervised serving replica (``serve/replica.py``), its
HTTP shapes (``serve/server.py``), the ``--ft-dir`` server mode
(``serve/__main__.py``) and the drain's preemption hook.

The ``Replica`` lifecycle and heartbeat payloads, ``/healthz``, ``POST
/drain`` and ``GET /slo`` against the JAX package's on stub engines (the
cases of ``tests/test_router.py:403-450``); then the CLI as a user runs it,
in a subprocess on the CPU: ``POST /drain`` persists the undone work,
SIGTERM exits 0 with the span part-file written, a restart on the same
directory replays the journal once (each stream equal to the engine's own
greedy stream) and consumes it, and ``GET /slo`` equals the report replayed
from the flight records. Last, ``DrainController.install_preempt_hook`` in
a child process: SIGTERM persists the queue and chains a previous handler.
"""
import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from autodist_tpu import metrics as JM
from autodist_tpu.ft.heartbeat import MemoryTransport as JTransport
from autodist_tpu.obs import slo as jslo
from autodist_tpu.serve.engine import AdmissionDenied as JDenied
from autodist_tpu.serve.replica import Replica as JReplica
from autodist_tpu.serve.server import ServeFrontend as JFrontend
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.ft import MemoryTransport
from autodist_tpu_torch.obs import SLOTracker
from autodist_tpu_torch.serve.batcher import ContinuousBatcher
from autodist_tpu_torch.serve.engine import AdmissionDenied
from autodist_tpu_torch.serve.replica import Replica
from autodist_tpu_torch.serve.server import ServeFrontend
from autodist_tpu_torch.utils import retry

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _stub(denied):
    """Enough engine for admission and queueing, no device work: admission
    always defers, so submitted work parks in the queue (the JAX router
    tests' stub, for either package)."""

    class Stub:
        decode_model = SimpleNamespace(eos_id=None)
        n_slots, max_len, chaos_host = 4, 64, 0
        page_utilization = page_fragmentation = 0.0
        active_slots = prefilling_slots = decoding_slots = 0
        prefix_cache, kv_quant = None, False
        pool = SimpleNamespace(free_pages=0, used_pages=0, utilization=0.0)

        @staticmethod
        def check_admissible(prompt_len, max_new_tokens):
            if prompt_len + max_new_tokens > 64:
                return denied("over stub ceiling", retryable=False)
            return None

        @staticmethod
        def admit(prompt, max_new_tokens, request_id="", sampling=None):
            return denied("no free row (stub)", retryable=True)

        @staticmethod
        def prefill_pending():
            return []

        @staticmethod
        def release(slot):
            pass

    return Stub


class _Beats:
    """A transport that keeps every payload (the state sequence)."""

    def __init__(self, inner):
        self.inner, self.payloads = inner, []

    def publish(self, pid, payload):
        self.payloads.append(dict(payload))
        self.inner.publish(pid, payload)


def _pair(tmp_path, **kw):
    port = Replica(0, _stub(AdmissionDenied), _Beats(MemoryTransport()),
                   persist_path=str(tmp_path / "port.json"),
                   registry=M.MetricsRegistry(), heartbeat_interval_s=0.02, **kw)
    ref = JReplica(0, _stub(JDenied), _Beats(JTransport()),
                   persist_path=str(tmp_path / "jax.json"),
                   registry=JM.MetricsRegistry(), heartbeat_interval_s=0.02, **kw)
    return port, ref


def _states(rep):
    out = []
    for p in rep.transport.payloads:
        if not out or out[-1] != p["state"]:
            out.append(p["state"])
    return out


class _Writer:
    def __init__(self):
        self.data = b""

    def write(self, b):
        self.data += b


def _http_of(call):
    w = _Writer()
    call(w)
    head, _, body = w.data.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), json.loads(body)


def test_lifecycle_and_heartbeats_equal_jax(tmp_path):
    port, ref = _pair(tmp_path, drain_deadline_s=0.2)
    for rep in (port, ref):
        assert rep.state.value == "starting" and rep.outstanding == 0
        rep.start()
        assert rep.wait_ready(5.0)
        rep.submit([1, 2, 3], max_new_tokens=4, request_id="park-1")
        assert rep.outstanding == 1
        rep.quiesce()
        assert rep.drain() == {"drained": 0, "persisted": 1}
        rep.restart()
        assert rep.restarts == 1 and rep.state.value == "ready"
        rep.kill("chaos")
        assert rep.state.value == "dead"
    assert _states(port) == _states(ref) == ["starting", "ready", "draining", "starting",
                                             "ready", "dead"]
    keys = {tuple(sorted(p)) for p in port.transport.payloads}
    assert keys == {tuple(sorted(p)) for p in ref.transport.payloads}
    assert keys == {("outstanding", "page_pool_utilization", "pid", "replica_id",
                     "restarts", "state", "time")}
    with open(tmp_path / "port.json", "rb") as f, open(tmp_path / "jax.json", "rb") as g:
        assert f.read() == g.read()
    assert port.healthz() == ref.healthz()


def test_batcher_death_under_a_ready_replica_reports_dead(tmp_path):
    port, ref = _pair(tmp_path)
    for rep in (port, ref):
        rep.start()
        req = rep.submit([1, 2, 3], max_new_tokens=4)
        rep.batcher.die("chaos")
        assert req.wait(5).state.value == "rejected"
        assert retry.wait_until(lambda: rep.state.value == "dead", 10.0)
        rep.stop()                      # drains what is left: "draining"
    assert _states(port) == _states(ref) == ["starting", "ready", "dead", "draining"]


def test_healthz_and_drain_http_shapes_equal_jax(tmp_path):
    port, ref = _pair(tmp_path, drain_deadline_s=0.2)
    fe = ServeFrontend(None, replica=port, registry=M.MetricsRegistry())
    jfe = JFrontend(None, replica=ref, registry=JM.MetricsRegistry())
    seen = {}
    for name, f, rep in (("port", fe, port), ("jax", jfe, ref)):
        got = [_http_of(f._healthz)]                       # STARTING
        rep.start()
        got.append(_http_of(f._healthz))                   # READY
        rep.submit([1, 2, 3], max_new_tokens=4, request_id="park-1")
        got.append(_http_of(lambda w, f=f: asyncio.run(f._drain(w))))
        got.append(_http_of(f._healthz))                   # DRAINING, batcher gone
        got.append(_http_of(f._slo))                       # no tracker: 404
        seen[name] = got
        rep.stop()
    for (code, body), (jcode, jbody) in zip(seen["port"], seen["jax"]):
        assert code == jcode and sorted(body) == sorted(jbody)
        assert {k: v for k, v in body.items() if k != "error"} == \
            {k: v for k, v in jbody.items() if k != "error"}
    codes = [c for c, _ in seen["port"]]
    assert codes == [503, 200, 200, 503, 404]
    assert seen["port"][0][1]["state"] == "starting"
    assert seen["port"][2][1] == {"drained": 0, "persisted": 1}


def test_bare_batcher_drain_and_slo_shapes_equal_jax(tmp_path):
    from helpers.torch_serve import engine_pair

    jeng, teng = engine_pair(n_slots=8)
    seen = {}
    for name, fe_cls, b_cls, reg, tr in (
            ("port", ServeFrontend, ContinuousBatcher, M.MetricsRegistry, SLOTracker),
            ("jax", JFrontend, None, JM.MetricsRegistry, jslo.SLOTracker)):
        if b_cls is None:
            from autodist_tpu.serve.batcher import ContinuousBatcher as b_cls
        eng = teng if name == "port" else jeng
        b = b_cls(eng, registry=reg(), slo=tr(registry=reg()))
        b.submit([1, 2, 3], 4, request_id="a")
        fe = fe_cls(b, registry=reg())
        slo_code, slo_body = _http_of(fe._slo)
        health = _http_of(fe._healthz)
        drain = _http_of(lambda w: asyncio.run(fe._drain(w)))
        seen[name] = (slo_code, sorted(slo_body), health[0], sorted(health[1]), drain)
    assert seen["port"] == seen["jax"]
    assert seen["port"][4] == (200, {"drained": 0, "persisted": 0, "preempted": 1})


# ------------------------------------------------------------ the CLI
TINY_ARGS = ["--model-arg", "vocab_size=128", "--model-arg", "num_layers=2",
             "--model-arg", "d_model=32", "--model-arg", "num_heads=2",
             "--model-arg", "d_ff=64", "--model-arg", "max_seq_len=64",
             "--model-arg", "dtype=float32"]
N_REQ, MAX_NEW = 12, 40


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _call(port, method, path, body=None, timeout=60.0):
    data = json.dumps(body).encode() if body is not None else b""
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(f"{method} {path} HTTP/1.1\r\nHost: x\r\n"
                  f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
        raw = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            raw += chunk
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(payload)


def _serve(ft, trace, flight, port):
    env = dict(os.environ, AUTODIST_FLIGHT_DIR=flight, PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    env.pop("AUTODIST_PROCESS_ID", None)
    env.pop("AUTODIST_TRACE_ID", None)
    return subprocess.Popen(
        [sys.executable, "-m", "autodist_tpu_torch.serve", "--device", "cpu",
         *TINY_ARGS, "--slots", "2", "--port", str(port), "--ft-dir", ft,
         "--replica-id", "0", "--trace-out", trace], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def _wait_ready(port, proc, timeout=120.0):
    """Poll /healthz until 200; returns the status codes seen."""
    codes, deadline = [], time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.stderr.read()
        try:
            code, body = _call(port, "GET", "/healthz", timeout=5.0)
        except OSError:
            time.sleep(0.05)
            continue
        codes.append((code, body["state"]))
        if code == 200:
            return codes
        time.sleep(0.02)
    raise AssertionError(f"replica not READY in {timeout}s: {codes[-3:]}")


def _sigterm(proc, timeout=60.0):
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()


def test_cli_replica_drains_persists_and_replays_once(tmp_path):
    from autodist_tpu_torch.models import get_model
    from autodist_tpu_torch.models.transformer import decode_model, init_params
    from autodist_tpu_torch.obs import recorder, replay_flight_records
    from autodist_tpu_torch.serve.engine import InferenceEngine

    ft, trace = str(tmp_path / "ft"), str(tmp_path / "trace")
    port = _free_port()
    rng = np.random.default_rng(0)
    prompts = {f"cli-{i}": [int(t) for t in rng.integers(1, 127, size=int(rng.integers(4, 12)))]
               for i in range(N_REQ)}
    proc = _serve(ft, trace, str(tmp_path / "flight1"), port)
    try:
        codes = _wait_ready(port, proc)
        results = {}

        def post(rid):
            results[rid] = _call(port, "POST", "/generate",
                                 {"tokens": prompts[rid], "max_new_tokens": MAX_NEW,
                                  "request_id": rid}, timeout=120.0)

        threads = [threading.Thread(target=post, args=(rid,)) for rid in prompts]
        for t in threads:
            t.start()
        assert retry.wait_until(
            lambda: _call(port, "GET", "/healthz")[1]["outstanding"]
            + len(results) >= N_REQ, 30.0, interval_s=0.005)
        done_before = sum(body["state"] == "done" for _, body in list(results.values()))
        code, drained = _call(port, "POST", "/drain", timeout=120.0)
        for t in threads:
            t.join(timeout=120.0)
        after = _call(port, "GET", "/healthz")
        rc = _sigterm(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0, proc.stderr.read()
    assert codes[-1] == (200, "ready")
    assert code == 200 and sorted(drained) == ["drained", "persisted"]
    assert after[0] == 503 and after[1]["state"] == "draining"
    states = {rid: body["state"] for rid, (_, body) in results.items()}
    assert set(states.values()) <= {"done", "preempted"} and len(states) == N_REQ
    preempted = sorted(rid for rid, s in states.items() if s == "preempted")
    assert drained["persisted"] == len(preempted) > 0
    assert drained["drained"] + drained["persisted"] == N_REQ - done_before
    journal = os.path.join(ft, "serve_queue-0.json")
    with open(journal, encoding="utf-8") as f:
        doc = json.load(f)
    assert doc["format_version"] == 2
    assert sorted(e["request_id"] for e in doc["entries"]) == preempted
    parts = [n for n in os.listdir(trace) if n.startswith("obs-part-")]
    assert len(parts) == 1
    with open(os.path.join(trace, parts[0]), encoding="utf-8") as f:
        names = {e["name"] for e in json.load(f)["traceEvents"] if e.get("ph") == "X"}
    assert {"serve.queue_wait", "serve.prefill_chunk", "serve.decode_step"} <= names

    # The restart on the same directory replays the journal once.
    port = _free_port()
    flight2 = str(tmp_path / "flight2")
    replayed_log = os.path.join(ft, "serve_replayed-0.jsonl")
    proc = _serve(ft, trace, flight2, port)
    try:
        _wait_ready(port, proc)
        assert retry.wait_until(
            lambda: os.path.exists(replayed_log)
            and len(open(replayed_log, encoding="utf-8").readlines()) >= len(preempted),
            120.0, interval_s=0.05)
        slo_code, live = _call(port, "GET", "/slo")
        rc = _sigterm(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0, proc.stderr.read()
    assert not os.path.exists(journal)
    with open(replayed_log, encoding="utf-8") as f:
        rows = [json.loads(ln) for ln in f]
    assert sorted(r["request_id"] for r in rows) == preempted        # exactly once
    cfg = get_model("transformer", vocab_size=128, num_layers=2, d_model=32, num_heads=2,
                    d_ff=64, max_seq_len=64, dtype="float32")
    engine = InferenceEngine(init_params(cfg, seed=0, device="cpu"), decode_model(cfg),
                             n_slots=2, page_len=16, device="cpu")
    for r in rows:
        assert r["state"] == "done"
        assert r["tokens"] == engine.generate(prompts[r["request_id"]], MAX_NEW)
    assert slo_code == 200 and live["counts"]["requests"] == len(preempted)
    replay = replay_flight_records(recorder.read_records(flight2)).report()
    for key in ("ttft_p50_s", "ttft_p99_s", "itl_p50_s", "itl_p99_s", "queue_wait_p99_s"):
        assert live["measured"][key] == pytest.approx(replay["measured"][key], rel=1e-9)


@pytest.mark.parametrize("mode", ["replica", "bare", "replica-open-socket"])
def test_cli_sigterm_after_drain_exits_0_within_10s(tmp_path, mode):
    """SIGTERM right after ``POST /drain`` (and, in one case, with a client
    holding an idle connection) ends the server with exit 0 within 10 s,
    with a replica (``--ft-dir``) and with a bare batcher."""
    port = _free_port()
    env = dict(os.environ, AUTODIST_FLIGHT_DIR=str(tmp_path / "flight"), PYTHONPATH=ROOT,
               OMP_NUM_THREADS="1")
    env.pop("AUTODIST_PROCESS_ID", None)
    extra = (["--ft-dir", str(tmp_path / "ft"), "--trace-out", str(tmp_path / "trace")]
             if mode != "bare" else [])
    proc = subprocess.Popen(
        [sys.executable, "-m", "autodist_tpu_torch.serve", "--device", "cpu", *TINY_ARGS,
         "--slots", "2", "--port", str(port), *extra], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    idle = None
    try:
        _wait_ready(port, proc)
        results = []
        threads = [threading.Thread(target=lambda i=i: results.append(_call(
            port, "POST", "/generate", {"tokens": [1 + i, 2, 3, 4], "max_new_tokens": 40,
                                        "request_id": f"t-{i}"}, timeout=60.0)))
            for i in range(6)]
        for t in threads:
            t.start()
        assert retry.wait_until(
            lambda: _call(port, "GET", "/healthz")[1]["outstanding"] + len(results) >= 6,
            30.0, interval_s=0.005)
        code, drained = _call(port, "POST", "/drain", timeout=60.0)
        for t in threads:
            t.join(timeout=60.0)
        if mode == "replica-open-socket":
            idle = socket.create_connection(("127.0.0.1", port), timeout=10.0)
        # SIGTERM as soon as the last response's connection closes.
        last = _call(port, "GET", "/healthz")
        t0 = time.monotonic()
        rc = _sigterm(proc, timeout=10.0)
        took = time.monotonic() - t0
    finally:
        if idle is not None:
            idle.close()
        if proc.poll() is None:
            proc.kill()
    assert rc == 0, proc.stderr.read()[-3000:]
    assert took < 10.0
    assert code == 200 and len(results) == 6
    assert {body["state"] for _, body in results} <= {"done", "preempted"}
    assert last[0] == 503                          # drained: no longer ready
    if mode == "bare":
        assert drained["persisted"] == 0 and drained["drained"] + drained["preempted"] >= 1
    else:
        assert drained["drained"] + drained["persisted"] >= 1


CHILD = r"""
import os, signal, sys
sys.path.insert(0, {root!r})
import torch
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.ft import DrainController
from autodist_tpu_torch.models import get_model
from autodist_tpu_torch.models.transformer import decode_model, init_params
from autodist_tpu_torch.serve.batcher import ContinuousBatcher
from autodist_tpu_torch.serve.engine import InferenceEngine

cfg = get_model("transformer", vocab_size=128, num_layers=1, d_model=16, num_heads=1,
                d_ff=32, max_seq_len=32, dtype="float32")
eng = InferenceEngine(init_params(cfg, seed=0, device="cpu"), decode_model(cfg),
                      n_slots=2, page_len=8, device="cpu")
batcher = ContinuousBatcher(eng, registry=M.MetricsRegistry())
for i in range(5):
    batcher.submit([i + 1, 2, 3], 4, request_id=f"pre-{{i}}")
if {chain}:
    signal.signal(signal.SIGTERM, lambda s, f: open({marker!r}, "w").write("chained"))
DrainController(batcher, {journal!r}, drain_deadline_s=1.0).install_preempt_hook()
os.kill(os.getpid(), signal.SIGTERM)
print("survived", flush=True)
"""


@pytest.mark.parametrize("chain", [True, False], ids=["chained", "default"])
def test_preempt_hook_persists_and_chains(tmp_path, chain):
    journal, marker = str(tmp_path / "q.json"), str(tmp_path / "marker")
    code = CHILD.format(root=ROOT, chain=chain, marker=marker, journal=journal)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=100, env=dict(os.environ, OMP_NUM_THREADS="1"))
    with open(journal, encoding="utf-8") as f:
        entries = json.load(f)["entries"]
    assert [e["request_id"] for e in entries] == [f"pre-{i}" for i in range(5)]
    if chain:
        assert out.returncode == 0 and "survived" in out.stdout, out.stderr
        assert open(marker).read() == "chained"
    else:
        assert out.returncode == -signal.SIGTERM and "survived" not in out.stdout
        assert not os.path.exists(marker)
