"""Port parity: the serving fleet's router (``serve/router.py``) against the
JAX package's.

Routing on stub engines runs the same scenario through both packages'
routers and compares where the work went (least outstanding work, the
straggler weight, SUSPECT replicas skipped, typed sheds, unservable
requests, prefix affinity through ``block_hashes``), the journal bytes of
the same leftovers, the typed overlap mismatch and the per-replica metrics
keys (``tests/test_router.py``'s TestRouting, TestJournalMerge). On real
fleets over the JAX fleet's weights (``tests/helpers/torch_router.py``):
exactly-once failover with streams bit-identical to the uninterrupted
control run and to the JAX control engine's, rolling upgrade with no
request dropped, recovery from the journaled watermark (in either
package), failover of prefix-shared, speculative and sampled streams
(``tests/test_serve_prefix.py:374``, ``tests/test_serve_spec.py:208``,
``autodist_tpu/serve/sampling.py``'s kill sweep), the overlap oracle on the
plain path, one 64-prompt run of each package's fleet with the same kill,
and ``--selftest-router --device cpu``.
"""
import contextlib
import json
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from autodist_tpu import metrics as JM
from autodist_tpu.chaos import hooks as jhooks
from autodist_tpu.ft import drain as jdrain
from autodist_tpu.obs.aggregate import HostAggregator as JAggregator
from autodist_tpu.serve import prefix as jprefix
from autodist_tpu.serve.batcher import Backpressure as JBackpressure
from autodist_tpu.serve.batcher import GenRequest as JRequest
from autodist_tpu.serve.engine import EngineDeadError as JEngineDeadError
from autodist_tpu.serve.router import _Flight as JFlight
from autodist_tpu.serve.router import build_test_fleet as jax_build_test_fleet
from autodist_tpu.serve.sampling import SamplingParams as JSampling
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.chaos import hooks
from autodist_tpu_torch.ft import drain
from autodist_tpu_torch.ft.heartbeat import MemoryTransport
from autodist_tpu_torch.obs import HostAggregator
from autodist_tpu_torch.serve import prefix
from autodist_tpu_torch.serve.batcher import Backpressure, GenRequest, RequestState
from autodist_tpu_torch.serve.engine import EngineDeadError
from autodist_tpu_torch.serve.replica import ReplicaState
from autodist_tpu_torch.serve.router import RouterConfig, _Flight
from autodist_tpu_torch.serve.sampling import SamplingParams
from autodist_tpu_torch.serve.server import mock_load_prompt
from autodist_tpu_torch.utils import retry
from helpers.torch_router import port_fleet, stub_routers
from helpers.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


# ---------------------------------------------------------------- routing
def _ready(router, rids, timeout=10.0):
    assert retry.wait_until(
        lambda: all(router.replica_state(r).value == "ready" for r in rids),
        timeout, interval_s=0.005), {r: router.replica_state(r) for r in rids}


def _placed(router, front, timeout=10.0):
    def placed():
        with router._lock:
            f = router._flights.get(front.request_id)
            return f is not None and f.replica_id is not None

    assert retry.wait_until(placed, timeout, interval_s=0.002)
    with router._lock:
        return router._flights[front.request_id].replica_id


def _both(scenario, **kw):
    """``scenario(router, pkg)`` on the port's and JAX's stub routers;
    returns ``{pkg: result}``."""
    out = {}
    for pkg, router in zip(("port", "jax"), stub_routers(**kw)):
        try:
            out[pkg] = scenario(router, pkg)
        finally:
            router.stop(drain=False)
    return out


def test_routes_least_loaded_ready_equal_jax():
    def scenario(router, _):
        router.start()
        _ready(router, [0, 1, 2])
        # Preload replicas 0 and 2 directly: replica 1 is the
        # least-outstanding-work READY target.
        for _ in range(3):
            router.replicas[0].submit([1, 2, 3], max_new_tokens=4)
        router.replicas[2].submit([1, 2, 3], max_new_tokens=4)
        front = router.submit([5, 6, 7], max_new_tokens=4)
        return _placed(router, front), router.dispatch_counts()

    seen = _both(scenario)
    assert seen["port"] == seen["jax"] == (1, {0: 0, 1: 1, 2: 0})


def test_straggler_score_demotes_slow_replica_equal_jax():
    def scenario(router, pkg):
        agg_cls, tr_cls, reg_cls = ((HostAggregator, MemoryTransport, M.MetricsRegistry)
                                    if pkg == "port" else
                                    (JAggregator, type(router.monitor.transport),
                                     JM.MetricsRegistry))
        transport = tr_cls()
        router.aggregator = agg_cls(transport, process_id=-1, registry=reg_cls())
        # Equal (zero) outstanding work, but replica 0's step-time p50 is 3x
        # the fleet median: the weighted rank prefers replica 1 over the id
        # tiebreak's 0.
        now = time.time()
        transport.publish(0, {"time": now, "p50": 0.3, "n": 16})
        transport.publish(1, {"time": now, "p50": 0.1, "n": 16})
        transport.publish(2, {"time": now, "p50": 0.1, "n": 16})
        router.start()
        _ready(router, [0, 1, 2])
        assert retry.wait_until(lambda: router._scores.get(0, 0) > 1.5, 5.0)
        front = router.submit([5, 6, 7], max_new_tokens=4)
        return _placed(router, front), dict(router._scores)

    seen = _both(scenario)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == 1 and seen["port"][1][0] == pytest.approx(3.0)


def test_suspect_replica_not_routed_equal_jax():
    def scenario(router, _):
        router.start()
        _ready(router, [0, 1, 2])
        # Silence replica 0's beats (a control-plane partition): SUSPECT,
        # and no new work.
        router.replicas[0]._hb_stop.set()
        assert retry.wait_until(
            lambda: router.replica_state(0).value == "suspect", 10.0)
        placed = [_placed(router, router.submit([5, 6, 7], max_new_tokens=4))
                  for _ in range(4)]
        return 0 in placed, router.dispatch_counts()[0]

    # DEAD needs a long silence here: the pin is SUSPECT routing.
    seen = _both(scenario, dead_after_misses=60)
    assert seen["port"] == seen["jax"] == (False, 0)


def test_typed_shed_when_all_replicas_saturated_equal_jax():
    def scenario(router, pkg):
        router.start()
        _ready(router, [0, 1, 2])
        fronts = [router.submit([1, 2], max_new_tokens=4) for _ in range(2)]
        assert all(not f.done for f in fronts)
        with pytest.raises(Backpressure if pkg == "port" else JBackpressure,
                           match="router queue full"):
            router.submit([1, 2], max_new_tokens=4)
        shed = router.try_submit([1, 2], max_new_tokens=4, request_id="shed-1")
        snap = router._reg.snapshot()
        return (shed.state.value, shed.error, shed.done, shed.request_id,
                snap["serve_router_requests_rejected_total"],
                snap["serve_router_requests_total"])

    seen = _both(scenario, max_queue=2)
    assert seen["port"] == seen["jax"]
    assert seen["port"][:3] == ("rejected", "admission rejected: router queue full "
                                "(2 requests)", True)


def test_unservable_and_stopped_are_typed_equal_jax():
    def scenario(router, _):
        router.replicas[0].start()           # gives the router a live engine
        front = router.submit(list(range(60)), max_new_tokens=30)
        out = [front.state.value, front.unservable, front.error]
        router.stop(drain=False)
        stopped = router.try_submit([1, 2], max_new_tokens=2)
        bad = router.try_submit([1, 2], max_new_tokens=0)
        return out + [stopped.error, bad.state.value, bad.error]

    seen = _both(scenario)
    assert seen["port"] == seen["jax"]
    assert seen["port"][:2] == ["rejected", True]
    assert seen["port"][3] == "admission rejected: router is stopped"


def test_queue_expiry_is_typed_timeout_equal_jax():
    def scenario(router, _):
        front = router.submit([1, 2, 3], max_new_tokens=4, timeout_s=0.01)
        time.sleep(0.03)
        router._expire()
        return front.state.value, front.error, router.outstanding

    seen = _both(scenario)
    assert seen["port"] == seen["jax"] == ("timeout", "deadline expired in router queue", 0)


@pytest.mark.parametrize("limit", [None, 1, 3])
def test_block_hashes_equal_jax(limit):
    rng = np.random.default_rng(5)
    for n in (0, 7, 8, 9, 31, 64):
        toks = rng.integers(1, 127, size=n).astype(np.int32)
        assert prefix.block_hashes(toks, 8, limit=limit) == \
            jprefix.block_hashes(toks, 8, limit=limit)


def test_affinity_tiebreak_and_rank_equal_jax():
    rng = np.random.default_rng(3)
    system = rng.integers(1, 127, size=24).astype(np.int32)
    prompt = np.concatenate([system, rng.integers(1, 127, size=5).astype(np.int32)])
    other = rng.integers(1, 127, size=29).astype(np.int32)

    def scenario(router, _):
        router._affinity_page_len = 8           # as probed from a page_len-8 engine
        hashes = router._affinity_hashes(prompt)
        cold = router._rank([0, 1, 2], hashes)
        router._record_warm(2, router._affinity_hashes(system))
        router._record_warm(1, router._affinity_hashes(other))
        warm = router._rank([0, 1, 2], hashes)
        depth = [router._affinity(r, hashes) for r in range(3)]
        router._scores = {2: 2.0}                # the straggler weight wins over warmth
        weighted = router._rank([0, 1, 2], hashes)
        return hashes, cold, warm, depth, weighted

    seen = _both(scenario)
    assert seen["port"] == seen["jax"]
    hashes, cold, warm, depth, weighted = seen["port"]
    assert len(hashes) == 3 and cold == [0, 1, 2]
    assert warm == [2, 0, 1] and depth == [0, 0, 3] and weighted == [0, 1, 2]


def test_overlap_mismatch_fails_typed_equal_jax():
    def scenario(router, pkg):
        req_cls, flight_cls = (GenRequest, _Flight) if pkg == "port" else (JRequest, JFlight)
        front = req_cls(prompt=np.asarray([1, 2, 3], np.int32), max_new_tokens=4,
                        request_id="mm-1")
        front.tokens = [7, 8]
        backend = req_cls(prompt=np.asarray([1, 2, 3, 7], np.int32), max_new_tokens=3,
                          request_id="mm-1")
        backend.tokens = [9, 5]                  # regenerates 9 where 8 was delivered
        flight = flight_cls(front=front, backend=backend, replica_id=2, skip=1, expect=8)
        router._flights[front.request_id] = flight
        router._harvest_flight(flight)
        snap = router._reg.snapshot()
        return (front.state.value, front.error, front.tokens,
                snap["serve_router_prefix_mismatch_total"], router.ledger())

    seen = _both(scenario)
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == "rejected" and seen["port"][2] == [7, 8]
    assert "regenerated 9, delivered prefix ends with 8" in seen["port"][1]
    assert seen["port"][3] == 1


def test_metrics_snapshot_and_slo_report_keys_equal_jax():
    def scenario(router, _):
        router.start()
        _ready(router, [0, 1, 2])
        router.replicas[1].submit([1, 2, 3], max_new_tokens=4)
        snap = router.metrics_snapshot()
        per_replica = {k: v for k, v in snap.items() if "{replica=" in k}
        report = router.slo_report()
        return (sorted(snap), per_replica, sorted(report), sorted(report["router"]),
                report["router"]["replicas"], report["router"]["dispatches"])

    seen = _both(scenario)
    assert seen["port"] == seen["jax"]
    per_replica = seen["port"][1]
    assert per_replica['serve_replica_outstanding{replica="1"}'] == 1.0
    assert per_replica['serve_replica_up{replica="0"}'] == 1.0


def test_stop_journals_leftovers_bytes_equal_jax(tmp_path):
    """Leftovers of a stopped router persist to its journal (JAX's drain v2
    entries), byte-equal to JAX's for the same requests; each package's
    router recovers the other's journal."""
    def scenario(router, pkg):
        router.journal_path = str(tmp_path / f"{pkg}-journal.json")
        sp = (SamplingParams if pkg == "port" else JSampling)(temperature=0.9, seed=4)
        fronts = [router.submit([1, 2, 3], max_new_tokens=4, request_id="j-0"),
                  router.submit([4, 5], max_new_tokens=6, request_id="j-1", sampling=sp)]
        router.stop(drain=False)
        with open(router.journal_path, "rb") as f:
            journal = f.read()
        return [f.state.value for f in fronts], journal

    seen = _both(scenario)
    assert seen["port"] == seen["jax"]          # the journals' bytes included
    assert seen["port"][0] == ["preempted", "preempted"]
    for pkg, (_, journal) in seen.items():
        with open(tmp_path / f"{pkg}-journal.json", "wb") as f:
            f.write(journal)
    entries = drain.merge_journal_entries([str(tmp_path / "port-journal.json")])
    assert [e["request_id"] for e in entries] == ["j-0", "j-1"]
    assert SamplingParams.from_dict(entries[1]["sampling"]) == SamplingParams(
        temperature=0.9, seed=4)

    # Cross-package recovery: each router resubmits the other's entries.
    def recover(router, pkg):
        src = "jax" if pkg == "port" else "port"
        router.journal_path = str(tmp_path / f"{src}-journal.json")
        return sorted(f.request_id for f in router.recover())

    seen = _both(recover)
    assert seen["port"] == seen["jax"] == ["j-0", "j-1"]


def test_router_journal_carries_sampling(tmp_path):
    """``tests/test_serve_sampling.py:334``: a journaled request keeps its
    sampling params."""
    sp = SamplingParams(temperature=1.1, seed=9)
    req = GenRequest(prompt=np.asarray([7, 8, 9], np.int32), max_new_tokens=4,
                     request_id="j", sampling=sp)
    path = str(tmp_path / "journal.json")
    drain.persist_requests(path, [req])
    entry = drain.merge_journal_entries([path])[0]
    assert SamplingParams.from_dict(entry["sampling"]) == sp
    jentry = jdrain.merge_journal_entries([path])[0]
    assert JSampling.from_dict(jentry["sampling"]) == JSampling(temperature=1.1, seed=9)


# ------------------------------------------------------- real fleets
@contextlib.contextmanager
def _kill_mid_decode(router, rid, timeout=60.0):
    """Replica ``rid`` of ``router`` (either package's) dies mid-decode:
    its engine raises ``EngineDeadError`` inside its own decode step
    (``SEAM_SERVE_STEP``, the ``replica_death`` fault's seam) once one of
    its in-flight requests has a token, and the replica reports DEAD. The
    requests submitted inside the block are the traffic; leaving it waits
    for the death. Deciding on the victim's own thread leaves it no window
    to finish that request first (a kill from the test thread, after a
    poll saw a token, came under load after the victim's last request was
    done: nothing was rerouted)."""
    seams, dead = ((hooks, EngineDeadError)
                   if type(router).__module__.startswith("autodist_tpu_torch.")
                   else (jhooks, JEngineDeadError))
    victim = router.replicas[rid]
    fired = threading.Event()

    def on_step(host=None, **_):
        if host != rid or fired.is_set():
            return
        batcher = victim.batcher
        with batcher._lock:
            armed = any(len(r.tokens) > 0 for r in batcher._active.values())
        if armed:
            fired.set()
            raise dead("test: mid-decode death")

    _ready(router, sorted(router.replicas), timeout=30.0)
    seams.install(seams.SEAM_SERVE_STEP, on_step)
    try:
        yield
        assert fired.wait(timeout), f"replica {rid} never decoded a started request"
    finally:
        seams.uninstall(seams.SEAM_SERVE_STEP)


@pytest.fixture(scope="module")
def jax_fleet(tmp_path_factory):
    """The JAX package's 3-replica test fleet and control engine (module
    scoped: the per-test state is requests)."""
    registry = JM.MetricsRegistry()
    router, control = jax_build_test_fleet(
        n_replicas=3, journal_dir=str(tmp_path_factory.mktemp("jax-fleet")),
        registry=registry)
    yield router, control, registry
    router.stop(drain=False)


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """The port's 2-replica fleet over the same weights."""
    registry = M.MetricsRegistry()
    router, control = port_fleet(n_replicas=2, registry=registry,
                                 journal_dir=str(tmp_path_factory.mktemp("port-fleet")))
    router.start()
    for rep in router.replicas.values():
        assert rep.wait_ready(60.0)
    yield router, control, registry
    router.stop(drain=False)


def _prompts(seed, n, lo=3, hi=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 127, size=int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


class TestFailover:
    def test_failover_streams_bit_identical(self, fleet, jax_fleet):
        router, control, registry = fleet
        prompts = _prompts(7, 8)
        expected = [control.generate(p, 8) for p in prompts]
        assert expected == [jax_fleet[1].generate(p, 8) for p in prompts]
        before = registry.counter("serve_router_requests_rerouted_total").value
        with _kill_mid_decode(router, 0):
            fronts = [router.submit(p, max_new_tokens=8) for p in prompts]
        states = [f.wait(120.0).state for f in fronts]
        assert all(s is RequestState.DONE for s in states), states
        # The delivered prefix from the dead replica + the survivor's resumed
        # continuation == the uninterrupted stream.
        assert [f.tokens for f in fronts] == expected
        assert registry.counter("serve_router_requests_rerouted_total").value > before
        assert all(v == 1 for v in router.ledger().values())
        assert registry.snapshot()["serve_router_prefix_mismatch_total"] == 0
        router.replicas[0].restart()           # later tests see 2 replicas again
        assert retry.wait_until(
            lambda: router.replica_state(0) is ReplicaState.READY, 30.0)

    def test_rolling_upgrade_zero_drop(self, fleet):
        router, control, _ = fleet
        prompts = _prompts(11, 16, hi=8)
        restarts = {rid: rep.restarts for rid, rep in router.replicas.items()}
        fronts = [router.submit(p, max_new_tokens=5) for p in prompts]
        results = router.rolling_upgrade(deadline_s=30.0, ready_timeout_s=60.0)
        assert [r["replica"] for r in results] == sorted(router.replicas)
        assert all(rep.restarts == restarts[rid] + 1
                   for rid, rep in router.replicas.items())
        assert all(f.wait(120.0).state is RequestState.DONE for f in fronts)
        assert [f.tokens for f in fronts] == [control.generate(p, 5) for p in prompts]
        assert all(v == 1 for v in router.ledger().values())
        # Each drained replica's own journal was consumed by the router.
        assert not any(os.path.exists(rep.persist_path)
                       for rep in router.replicas.values())


class TestJournalRecovery:
    def test_router_restart_resumes_from_watermark(self, tmp_path, jax_fleet):
        registry = M.MetricsRegistry()
        router, control = port_fleet(n_replicas=1, journal_dir=str(tmp_path),
                                     registry=registry)
        prompt = np.arange(1, 7, dtype=np.int32)
        expected = control.generate(prompt, 10)
        router.start()
        router.replicas[0].wait_ready(60.0)
        front = router.submit(prompt, max_new_tokens=10, request_id="wm-0")
        assert retry.wait_until(lambda: len(front.tokens) >= 2, 60.0, interval_s=0.001)
        router.stop(drain=False)
        assert front.state is RequestState.PREEMPTED
        delivered = list(front.tokens)
        assert 2 <= len(delivered) < 10
        with open(router.journal_path, encoding="utf-8") as f:
            doc = json.load(f)
        assert doc["format_version"] == 2
        (entry,) = doc["entries"]
        assert entry["request_id"] == "wm-0"
        assert entry["delivered"] == len(delivered) and entry["tokens"] == delivered
        # The same flight journaled by JAX's writer: the same bytes.
        jfront = SimpleNamespace(prompt=prompt, max_new_tokens=10, deadline=None,
                                 request_id="wm-0", tokens=delivered, sampling=None)
        jdrain.persist_requests(str(tmp_path / "jax.json"), [jfront])
        with open(router.journal_path, "rb") as f, open(tmp_path / "jax.json", "rb") as g:
            journal = f.read()
            assert journal == g.read()

        router2, _ = port_fleet(n_replicas=1, journal_dir=str(tmp_path), registry=registry)
        (resumed,) = router2.recover()
        assert resumed.request_id == "wm-0" and resumed.tokens == delivered
        router2.start()
        assert resumed.wait(60.0).state is RequestState.DONE
        assert resumed.tokens == expected       # resumed bit-identically
        router2.stop(drain=False)
        assert not os.path.exists(router2.journal_path)

        # JAX's router resumes the port's journal to the same stream.
        jrouter = jax_fleet[0]
        with open(tmp_path / "port-journal.json", "wb") as f:
            f.write(journal)
        saved, jrouter.journal_path = jrouter.journal_path, str(tmp_path / "port-journal.json")
        try:
            (jresumed,) = jrouter.recover()
        finally:
            jrouter.journal_path = saved
        jrouter.start()
        assert jresumed.wait(60.0).state.value == "done"
        assert jresumed.tokens == expected


def test_overlap_oracle_reprefill_reproduces_decode_tokens():
    """The failover oracle on the plain path: re-prefilling ``prompt +
    delivered[:-1]`` (chunks of page_len queries) regenerates the decode
    step's (one query) ``delivered[-1]`` bit for bit, at every watermark."""
    _, control = port_fleet(n_replicas=1, n_slots=4)
    for p in _prompts(21, 6, lo=3, hi=20):
        stream = control.generate(p, 12)
        for k in range(1, len(stream) + 1):
            resumed = np.concatenate([p, np.asarray(stream[:k - 1], np.int32)])
            assert control.generate(resumed, 1)[0] == stream[k - 1], (p, k)


class TestFailoverVariants:
    def test_failover_replays_shared_prefix_stream(self, jax_fleet):
        router, control = port_fleet(n_replicas=2, prefix_cache=True)
        router.start()
        try:
            for rep in router.replicas.values():
                rep.wait_ready(60.0)
            rng = np.random.default_rng(44)
            system = rng.integers(1, 127, size=16).astype(np.int32)
            prompts = [np.concatenate([system, rng.integers(1, 127, size=4)]).astype(np.int32)
                       for _ in range(8)]
            expected = [control.generate(p, 8) for p in prompts]
            assert expected == [jax_fleet[1].generate(p, 8) for p in prompts]
            with _kill_mid_decode(router, 0):
                fronts = [router.submit(p, max_new_tokens=8) for p in prompts]
            assert all(f.wait(120.0).state is RequestState.DONE for f in fronts)
            assert [f.tokens for f in fronts] == expected
            assert all(v == 1 for v in router.ledger().values())
            # The failover re-prefill repopulated the survivor's tree: one
            # more shared-prefix request hits it.
            survivor = router.replicas[1]
            extra = np.concatenate([system, np.asarray([5, 6, 7], np.int32)])
            assert router.submit(extra, max_new_tokens=2).wait(60.0).state is RequestState.DONE
            assert survivor.batcher.engine.prefix_stats()["inserts"] > 0
        finally:
            router.stop(drain=False)

    def test_failover_replay_reproduces_accepted_stream(self, jax_fleet):
        router, control = port_fleet(n_replicas=2, spec_decode=True, spec_k=4)
        router.start()
        try:
            for rep in router.replicas.values():
                rep.wait_ready(60.0)
            prompts = _prompts(7, 8)
            expected = [control.generate(p, 8) for p in prompts]
            with _kill_mid_decode(router, 0):
                fronts = [router.submit(p, max_new_tokens=8) for p in prompts]
            assert all(f.wait(120.0).state is RequestState.DONE for f in fronts)
            assert [f.tokens for f in fronts] == expected
            assert all(v == 1 for v in router.ledger().values())
            assert router.replica_state(1) is ReplicaState.READY
            assert sum(rep.engine.verify_invocations for rep in router.replicas.values()) > 0
        finally:
            router.stop(drain=False)

    def test_failover_of_sampled_streams(self):
        """JAX's kill sweep under stochastic traffic (``selftest_sampling``
        bar 5): spec replicas, a replica killed mid-stream, each stream
        equal to the control engine's draw for its ``(request_id, seed)``."""
        router, control = port_fleet(n_replicas=3, spec_decode=True, spec_k=3)
        grid = [None, SamplingParams(temperature=0.8, seed=2),
                SamplingParams(temperature=1.0, top_p=0.9, seed=3),
                SamplingParams(temperature=1.4, top_k=40, seed=4)]
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, 127, size=4 + (i % 9)).astype(np.int32) for i in range(16)]
        rids = [f"kill-{i}" for i in range(16)]
        expected = [control.generate(p, 8, request_id=rids[i], sampling=grid[i % 4])
                    for i, p in enumerate(prompts)]
        router.start()
        try:
            for rep in router.replicas.values():
                rep.wait_ready(60.0)
            with _kill_mid_decode(router, 1):
                fronts = [router.submit(p, 8, request_id=rids[i], sampling=grid[i % 4])
                          for i, p in enumerate(prompts)]
            assert all(f.wait(120.0).state is RequestState.DONE for f in fronts)
            assert [f.tokens for f in fronts] == expected
            snap = router._reg.snapshot()
            assert snap["serve_router_failovers_total"] == 1
            assert snap["serve_router_prefix_mismatch_total"] == 0
        finally:
            router.stop(drain=False)


def test_failover_of_int8_kv_streams():
    """``kv_quant=True``: every replica and the control engine serve from
    int8 pages, and the re-prefill on a survivor reproduces the dead
    replica's quantized stream."""
    router, control = port_fleet(n_replicas=2, kv_quant=True)
    prompts = _prompts(13, 8)
    expected = [control.generate(p, 8) for p in prompts]
    assert control.kv_quant
    router.start()
    try:
        for rep in router.replicas.values():
            rep.wait_ready(60.0)
        with _kill_mid_decode(router, 0):
            fronts = [router.submit(p, max_new_tokens=8) for p in prompts]
        assert all(f.wait(120.0).state is RequestState.DONE for f in fronts)
        assert [f.tokens for f in fronts] == expected
        assert router._reg.snapshot()["serve_router_prefix_mismatch_total"] == 0
    finally:
        router.stop(drain=False)


def test_rolling_upgrade_rereads_engine_kwargs():
    """``engine_kwargs`` is read at every factory build: a rolling upgrade
    brings each replica up on the new knobs."""
    knobs = {"n_slots": 4}
    router, _ = port_fleet(n_replicas=2, engine_kwargs=lambda: dict(knobs))
    router.start()
    try:
        for rep in router.replicas.values():
            rep.wait_ready(60.0)
        assert [rep.engine.n_slots for rep in router.replicas.values()] == [4, 4]
        knobs["n_slots"] = 2
        fronts = [router.submit(p, max_new_tokens=4) for p in _prompts(3, 6)]
        router.rolling_upgrade(deadline_s=30.0, ready_timeout_s=60.0)
        assert [rep.engine.n_slots for rep in router.replicas.values()] == [2, 2]
        assert all(f.wait(60.0).state is RequestState.DONE for f in fronts)
    finally:
        router.stop(drain=False)


N_PARITY, PARITY_NEW = 64, 8


def _routed(router, prompts, kill):
    """The prompts through ``router`` with request ids, replica ``kill``
    killed mid-decode; returns (streams, states, ledger, counters)."""
    router.start()
    for rep in router.replicas.values():
        rep.wait_ready(60.0)
    with _kill_mid_decode(router, kill):
        fronts = [router.submit(p, max_new_tokens=PARITY_NEW, request_id=f"par-{i}")
                  for i, p in enumerate(prompts)]
    states = [f.wait(240.0).state.value for f in fronts]
    journal_empty = retry.wait_until(lambda: not os.path.exists(router.journal_path), 5.0,
                                     interval_s=0.01)
    # Both survivors READY: a loaded CPU can delay a beat past the CPU-sim
    # SUSPECT window, or read a prefill as a TTFT regression whose SNT007
    # demotion holds for its 30 s cooldown, in either package.
    survivors_ready = retry.wait_until(
        lambda: router._reg.snapshot()["serve_router_replicas_ready"] == 2, 45.0,
        interval_s=0.01)
    snap = router._reg.snapshot()
    counters = {k: snap[k] for k in ("serve_router_requests_total",
                                     "serve_router_requests_completed_total",
                                     "serve_router_prefix_mismatch_total")}
    return ([f.tokens for f in fronts], states, router.ledger(), counters,
            (snap["serve_router_failovers_total"] >= 1,
             snap["serve_router_requests_rerouted_total"] >= 1, survivors_ready),
            journal_empty)


def test_same_64_prompts_and_kill_through_both_fleets(tmp_path):
    jrouter, jcontrol = jax_build_test_fleet(n_replicas=3, journal_dir=str(tmp_path / "jax"),
                                             registry=JM.MetricsRegistry())
    rng = np.random.default_rng(0)
    prompts = [np.asarray(mock_load_prompt(rng, i), np.int32) for i in range(N_PARITY)]
    want = [jcontrol.generate(p, PARITY_NEW) for p in prompts]
    router, control = port_fleet(n_replicas=3, journal_dir=str(tmp_path / "port"))
    assert [control.generate(p, PARITY_NEW) for p in prompts] == want
    try:
        port = _routed(router, prompts, kill=1)
    finally:
        router.stop(drain=False)
    try:
        ref = _routed(jrouter, prompts, kill=1)
    finally:
        jrouter.stop(drain=False)
    assert port[0] == ref[0] == want                # delivered streams
    assert port[1] == ref[1] == ["done"] * N_PARITY
    assert port[2] == ref[2] == {f"par-{i}": 1 for i in range(N_PARITY)}
    assert port[3] == ref[3] == {
        "serve_router_requests_total": N_PARITY,
        "serve_router_requests_completed_total": N_PARITY,
        "serve_router_prefix_mismatch_total": 0}
    # A failover, reroutes (timing decides how many) and both survivors READY.
    assert port[4] == ref[4] == (True, True, True)
    assert port[5] and ref[5]                       # both journals consumed


def test_calibrated_configs_raise_only_crossed_thresholds():
    from autodist_tpu_torch.obs.sentry import SentryConfig
    from autodist_tpu_torch.serve.router import calibrated_configs

    base, sentry = RouterConfig(heartbeat_interval_s=0.05), SentryConfig()
    calm = {"max_straggler_score": 1.2, "max_ttft_ratio_above_floor": 1.9,
            "max_itl_ratio_above_floor": 0.0}
    assert calibrated_configs(calm, base, sentry) == (base, sentry, {})
    loaded = dict(calm, max_straggler_score=3.0, max_itl_ratio_above_floor=4.0)
    config, sentry2, raised = calibrated_configs(loaded, base, sentry, margin=2.0)
    assert config == RouterConfig(heartbeat_interval_s=0.05, straggler_threshold=6.0)
    assert sentry2.itl_ratio == 8.0 and sentry2.ttft_ratio == sentry.ttft_ratio
    assert raised == {
        "straggler_threshold": dict(default=1.5, measured_max=3.0, set_to=6.0, margin=2.0),
        "itl_ratio": dict(default=2.0, measured_max=4.0, set_to=8.0, margin=2.0)}


def test_selftest_router_cli_cpu():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "autodist_tpu_torch.serve", "--selftest-router",
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["ok"] is True and line["device"] == "cpu"
    assert line["completed"] == line["n_requests"] == 64
    assert line["replicas_ready_after_kill"] == 2 and line["failovers"] >= 1
    assert line["streams_bit_identical_to_control"] is True
    assert set(line["thresholds_raised"]) <= {"straggler_threshold", "ttft_ratio", "itl_ratio"}


def test_fleet_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(Exception, match="(?i)cuda"):
        port_fleet(device="cuda")


class _Writer:
    def __init__(self):
        self.data = b""

    def write(self, b):
        self.data += b


def _healthz_of(frontend):
    w = _Writer()
    frontend._healthz(w)
    head, _, body = w.data.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), json.loads(body)


class TestHealthEndpoints:
    def test_router_healthz_503_until_ready_then_200_equal_jax(self):
        from autodist_tpu.serve.server import RouterFrontend as JFrontend
        from autodist_tpu_torch.serve.server import RouterFrontend

        def scenario(router, pkg):
            fe = (RouterFrontend if pkg == "port" else JFrontend)(router, port=0)
            before = _healthz_of(fe)                 # nothing READY yet
            router.start()
            _ready(router, [0, 1, 2])
            ready = _healthz_of(fe)
            router.replicas[2].kill("test")
            assert retry.wait_until(
                lambda: router.replica_state(2).value == "dead", 10.0, interval_s=0.005)
            return before, ready, _healthz_of(fe)

        seen = _both(scenario)
        assert seen["port"] == seen["jax"]
        before, ready, one_dead = seen["port"]
        assert before == (503, {"ok": False, "replicas": {"0": "starting", "1": "starting",
                                                           "2": "starting"},
                                "replicas_ready": 0, "outstanding": 0})
        assert ready[0] == 200 and ready[1]["replicas_ready"] == 3
        assert one_dead[0] == 200 and one_dead[1]["replicas"]["2"] == "dead"
