"""Port parity: the serve drain journal (``ft/drain.py``) against the JAX
package's, on the same requests and the same tiny engine weights.

Journals are byte-for-byte equal and replay in either package; the
multi-journal merge, the backpressure remainder and the corrupt/unservable
hardening give JAX's results on the same files; a ``DrainController`` on
the port's engine persists the same entries as JAX's on the same prompts,
and the replayed streams equal an uninterrupted run's (the cases of
``tests/test_ft.py:383-506`` and ``tests/test_router.py:326-400``).
"""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from autodist_tpu import metrics as JM
from autodist_tpu.ft import drain as jdrain
from autodist_tpu.serve.batcher import ContinuousBatcher as JBatcher
from autodist_tpu.serve.batcher import RequestState as JState
from autodist_tpu.serve.sampling import SamplingParams as JSampling
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.ft import DrainController, drain, persist_requests, replay_requests
from autodist_tpu_torch.serve.batcher import ContinuousBatcher, RequestState
from autodist_tpu_torch.serve.sampling import SamplingParams
from helpers.torch_serve import engine_pair, prompts
from helpers.torch_threads import one_torch_thread  # noqa: F401

MAX_NEW = 6


def _req(rid, prompt, tokens=(), max_new=8, sampling=None):
    return SimpleNamespace(prompt=np.asarray(prompt, np.int32), max_new_tokens=max_new,
                           deadline=None, request_id=rid, tokens=list(tokens),
                           sampling=sampling)


@pytest.fixture(scope="module")
def engines():
    return engine_pair(n_slots=4)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_journal_bytes_equal_jax(tmp_path):
    reqs = [_req("a", [1, 2, 3], tokens=[7, 8]), _req("", [4, 5]),
            _req("hot", [9], sampling=SamplingParams(temperature=0.7, top_k=5, seed=3))]
    jreqs = [_req("a", [1, 2, 3], tokens=[7, 8]), _req("", [4, 5]),
             _req("hot", [9], sampling=JSampling(temperature=0.7, top_k=5, seed=3))]
    assert persist_requests(str(tmp_path / "p.json"), reqs) == 3
    assert jdrain.persist_requests(str(tmp_path / "j.json"), jreqs) == 3
    assert _read(tmp_path / "p.json") == _read(tmp_path / "j.json")
    doc = json.loads(_read(tmp_path / "p.json"))
    assert doc["format_version"] == 2
    a, b, hot = doc["entries"]
    assert a["request_id"] == "a" and a["delivered"] == 2 and a["tokens"] == [7, 8]
    assert "request_id" not in b and "delivered" not in b
    assert hot["sampling"] == {"temperature": 0.7, "top_k": 5, "top_p": 1.0, "seed": 3}


def test_deadline_persists_as_remaining_seconds(tmp_path):
    import time

    req = _req("d", [1, 2])
    req.deadline = time.monotonic() + 30.0
    persist_requests(str(tmp_path / "p.json"), [req])
    jdrain.persist_requests(str(tmp_path / "j.json"), [req])
    left = [json.loads(_read(tmp_path / n))["entries"][0]["timeout_s"]
            for n in ("p.json", "j.json")]
    assert all(29.0 < t <= 30.0 for t in left)
    assert abs(left[0] - left[1]) < 1.0


@pytest.mark.parametrize("case", ["dedupe", "v1", "corrupt", "missing"])
def test_merge_equals_jax(tmp_path, case):
    def make(root, mod):
        p1, p2 = str(root / "r0.json"), str(root / "r1.json")
        if case == "dedupe":
            mod.persist_requests(p1, [_req("shared", [1, 2], tokens=[9, 9]),
                                      _req("only-r0", [3], tokens=[5])])
            mod.persist_requests(p2, [_req("shared", [1, 2], tokens=[9, 9, 9, 9]),
                                      _req("only-r1", [4])])
        elif case == "v1":
            for p in (p1, p2):
                with open(p, "w", encoding="utf-8") as f:
                    json.dump({"format_version": 1, "entries": [
                        {"prompt": [1], "max_new_tokens": 4, "timeout_s": None},
                        {"prompt": [2], "max_new_tokens": 4, "timeout_s": None}]}, f)
        elif case == "corrupt":
            with open(p1, "w", encoding="utf-8") as f:
                f.write("{not json")
            mod.persist_requests(p2, [_req("x", [5])])
        return [p1, p2]

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = drain.merge_journal_entries(make(tmp_path / "port", drain))
    want = jdrain.merge_journal_entries(make(tmp_path / "jax", jdrain))
    assert got == want
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    if case == "dedupe":
        assert [e["request_id"] for e in got] == ["shared", "only-r0", "only-r1"]
        assert got[0]["delivered"] == 4


class _Recorder:
    """A stand-in batcher that records what replay submits."""

    def __init__(self, admit=10**9, unservable=()):
        self.submitted, self.admit, self.unservable = [], admit, set(unservable)

    def submit(self, prompt, max_new_tokens, timeout_s=None, request_id=None,
               sampling=None, backpressure=Exception):
        if len(self.submitted) >= self.admit:
            raise backpressure("queue full")
        self.submitted.append((list(prompt), max_new_tokens, timeout_s, request_id,
                               None if sampling is None else sampling.to_dict()))
        return SimpleNamespace(unservable=request_id in self.unservable, error="x")


def _replay_with(mod, batcher_cls, paths):
    from autodist_tpu.serve.batcher import Backpressure as JBack
    from autodist_tpu_torch.serve.batcher import Backpressure

    back = Backpressure if mod is drain else JBack
    rec = batcher_cls()

    class B:
        @staticmethod
        def submit(*a, **kw):
            return rec.submit(*a, backpressure=back, **kw)

    return rec, mod.replay_requests(paths, B)


@pytest.mark.parametrize("admit,unservable", [(10**9, ()), (2, ()), (10**9, ("y",))],
                         ids=["all", "backpressure", "unservable"])
def test_replay_consumes_like_jax(tmp_path, admit, unservable):
    results = {}
    for name, mod in (("port", drain), ("jax", jdrain)):
        root = tmp_path / name
        root.mkdir()
        p1, p2 = str(root / "a.json"), str(root / "b.json")
        mod.persist_requests(p1, [_req("x", [1, 2], tokens=[3])])
        mod.persist_requests(p2, [_req("x", [1, 2], tokens=[3, 4]), _req("y", [5]),
                                  _req("z", [6, 7], max_new=3)])
        rec, reqs = _replay_with(mod, lambda: _Recorder(admit, unservable), [p1, p2])
        left = {n: json.loads(_read(root / n)) for n in sorted(os.listdir(root))}
        results[name] = (rec.submitted, len(reqs), left)
    assert results["port"] == results["jax"]
    submitted, n, left = results["port"]
    assert [s[3] for s in submitted] == ["x", "y", "z"][:min(admit, 3)]
    if admit == 2:
        assert [e["request_id"] for e in left["a.json"]["entries"]] == ["z"]
    else:
        assert left == {} and n == 3 - len(unservable)


def test_replay_missing_file_returns_empty(tmp_path, engines):
    _, teng = engines
    batcher = ContinuousBatcher(teng, registry=M.MetricsRegistry())
    assert replay_requests(str(tmp_path / "absent.json"), batcher) == []


def test_replay_drops_unservable_entry_like_jax(tmp_path, engines):
    jeng, teng = engines
    for name, mod, batcher in (
            ("port", drain, ContinuousBatcher(teng, registry=M.MetricsRegistry())),
            ("jax", jdrain, JBatcher(jeng, registry=JM.MetricsRegistry()))):
        path = str(tmp_path / f"{name}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump({"format_version": 1, "entries": [
                {"prompt": list(range(1, 31)), "max_new_tokens": 50, "timeout_s": None},
                {"prompt": [7], "max_new_tokens": 2, "timeout_s": None}]}, f)
        reqs = mod.replay_requests(path, batcher)
        assert [int(r.prompt[0]) for r in reqs] == [7], name
        assert not os.path.exists(path)


def _queued_drain(batcher_cls, reg_cls, engine, path, ctl_cls, rids, ps):
    """A drain of a batcher that never started: every request is a
    leftover, in submission order (deterministic in both packages)."""
    reg = reg_cls()
    batcher = batcher_cls(engine, max_queue=64, registry=reg)
    reqs = [batcher.submit(p, MAX_NEW, request_id=rid) for rid, p in zip(rids, ps)]
    out = ctl_cls(batcher, path, drain_deadline_s=1.0, registry=reg).shutdown()
    return reqs, out


def test_drain_controller_persists_the_same_entries(tmp_path, engines):
    jeng, teng = engines
    ps = prompts(6, seed=1)
    rids = [f"q-{i}" for i in range(len(ps))]
    treqs, tout = _queued_drain(ContinuousBatcher, M.MetricsRegistry, teng,
                                str(tmp_path / "port.json"), DrainController, rids, ps)
    jreqs, jout = _queued_drain(JBatcher, JM.MetricsRegistry, jeng,
                                str(tmp_path / "jax.json"), jdrain.DrainController, rids, ps)
    assert tout == jout == {"drained": 0, "persisted": len(ps)}
    assert _read(tmp_path / "port.json") == _read(tmp_path / "jax.json")
    assert [r.state.value for r in treqs] == [r.state.value for r in jreqs] == \
        ["preempted"] * len(ps)
    assert [r.error for r in treqs] == [r.error for r in jreqs]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_journal_replays_across_packages(tmp_path, engines, direction):
    """A journal drained by one package replays in the other: the same
    requests served once, streams equal the uninterrupted run's, the file
    consumed and the replay counted."""
    jeng, teng = engines
    ps = prompts(5, seed=2)
    rids = [f"x-{i}" for i in range(len(ps))]
    path = str(tmp_path / "q.json")
    if direction == "jax_to_port":
        _queued_drain(JBatcher, JM.MetricsRegistry, jeng, path, jdrain.DrainController,
                      rids, ps)
        reg = M.MetricsRegistry()
        batcher = ContinuousBatcher(teng, registry=reg).start()
        replayed = DrainController(batcher, path, registry=reg).replay()
        done = RequestState.DONE
    else:
        _queued_drain(ContinuousBatcher, M.MetricsRegistry, teng, path, DrainController,
                      rids, ps)
        reg = JM.MetricsRegistry()
        batcher = JBatcher(jeng, registry=reg).start()
        replayed = jdrain.DrainController(batcher, path, registry=reg).replay()
        done = JState.DONE
    try:
        for r in replayed:
            r.wait(timeout=120)
    finally:
        batcher.stop()
    assert [r.request_id for r in replayed] == rids
    assert all(r.state is done for r in replayed)
    assert not os.path.exists(path)
    assert reg.snapshot()["serve_requests_replayed_total"] == len(ps)
    for p, r in zip(ps, replayed):
        assert r.tokens == teng.generate(p, MAX_NEW) == jeng.generate(p, MAX_NEW)


def test_drain_mid_load_then_replay_serves_each_request_once(tmp_path, engines):
    """The JAX acceptance bar on the port: drain a loaded batcher — in-flight
    requests finish, the undrained queue persists — and a restarted batcher
    replays it: every request served exactly once, none lost."""
    _, teng = engines
    reg = M.MetricsRegistry()
    persist = str(tmp_path / "queue.json")
    n = 24
    batcher = ContinuousBatcher(teng, max_queue=64, registry=reg)
    ctl = DrainController(batcher, persist, drain_deadline_s=60.0, registry=reg)
    batcher.start()
    reqs = [batcher.submit([i + 1, 5, 9], max_new_tokens=6) for i in range(n)]
    stats = ctl.shutdown()
    done1 = {int(r.prompt[0]) for r in reqs if r.state is RequestState.DONE}
    preempted = {int(r.prompt[0]) for r in reqs if r.state is RequestState.PREEMPTED}
    assert stats["persisted"] == len(preempted) > 0
    assert done1 | preempted == set(range(1, n + 1)) and not done1 & preempted
    assert all(r.error == "server draining; request persisted for replay"
               for r in reqs if r.state is RequestState.PREEMPTED)
    assert teng.pool.used_pages == 0
    batcher2 = ContinuousBatcher(teng, max_queue=64, registry=M.MetricsRegistry())
    batcher2.start()
    replayed = DrainController(batcher2, persist, registry=reg).replay()
    for r in replayed:
        r.wait(timeout=120)
    batcher2.stop()
    assert {int(r.prompt[0]) for r in replayed} == preempted
    assert all(r.state is RequestState.DONE for r in replayed)
    assert not os.path.exists(persist)
    assert reg.snapshot()["serve_requests_replayed_total"] == len(preempted)
    assert ctl.shutdown() == {"drained": 0, "persisted": 0}      # idempotent


def test_quiesce_refuses_new_submissions(engines):
    from autodist_tpu_torch.serve.batcher import Backpressure

    _, teng = engines
    batcher = ContinuousBatcher(teng, registry=M.MetricsRegistry())
    DrainController(batcher, "/nonexistent/q.json").quiesce()
    with pytest.raises(Backpressure, match="draining"):
        batcher.submit([1, 2], max_new_tokens=2)
    batcher.stop(drain=False)
