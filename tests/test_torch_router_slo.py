"""Port parity: the router's SLO, sentry demotion, trace, flight records and
fleet HTTP surface against the JAX package's.

The sentry-demotion overlay on stub fleets (SNT007 demotes then the
cooldown re-admits, a fleet-level burn never demotes replica 0, a
per-replica burn demotes its replica, a persistent regressor is demoted
again, the maintenance window suppresses, the last routable replica is
never demoted: ``tests/test_serve_slo.py:456-601``) runs the same seeded
observations through both packages' routers. One routed run of each
package's real 3-replica fleet with a mid-decode kill (``:606-755``): the
stitched failover trace, the ``slo_report``, the route spans, the flight
records' kinds and fields against JAX's, and the fleet's ``/metrics``
byte-equal to ``render_openmetrics`` with its ``{replica=...}`` samples
equal to JAX's. Then ``RouterFrontend`` over HTTP with tenant sampling
defaults (``parse_sampling`` against JAX's, ``tests/test_serve_sampling.py:
290-302``) and its shutdown with a client's idle connection open.
"""
import asyncio
import json
import math
import threading
import time

import numpy as np
import pytest

from autodist_tpu import metrics as JM
from autodist_tpu.obs import recorder as jrecorder
from autodist_tpu.obs import spans as jspans
from autodist_tpu.obs.exporter import parse_openmetrics as jparse
from autodist_tpu.serve.router import build_test_fleet as jax_build_test_fleet
from autodist_tpu.serve.sampling import SamplingParams as JSampling
from autodist_tpu.serve.server import RouterFrontend as JFrontend
from autodist_tpu.serve.server import mock_load_prompt as jmock
from autodist_tpu.serve.server import parse_sampling as jparse_sampling
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.obs import parse_openmetrics, recorder, render_openmetrics, spans
from autodist_tpu_torch.serve.batcher import ContinuousBatcher, RequestState
from autodist_tpu_torch.serve.replica import ReplicaState
from autodist_tpu_torch.serve.sampling import InvalidSamplingParams, SamplingParams
from autodist_tpu_torch.serve.server import (
    RouterFrontend,
    ServeFrontend,
    mock_load_prompt,
    parse_sampling,
)
from autodist_tpu_torch.utils import retry
from helpers.torch_router import port_fleet, stub_routers
from helpers.torch_serve import record_shapes
from helpers.torch_threads import one_torch_thread  # noqa: F401


# ----------------------------------------------------- sentry demotion
def _demotion(scenario, n=3):
    """``scenario(router)`` on both packages' stub routers (cooldown 0.3 s),
    all replicas READY first; returns ``{pkg: result}``."""
    out = {}
    for pkg, router in zip(("port", "jax"), stub_routers(n=n, sentry_demote_cooldown_s=0.3)):
        router.start()
        try:
            assert retry.wait_until(
                lambda: all(router.replica_state(r).value == "ready" for r in range(n)),
                10.0, interval_s=0.005)
            out[pkg] = scenario(router)
        finally:
            router.stop(drain=False)
    return out


def _seed_regression(router, rid, signal="ttft_s"):
    for _ in range(12):
        router.serve_sentry.observe_serve(replica_id=rid, **{signal: 0.2})
    for _ in range(4):
        router._observe_serve(replica_id=rid, **{signal: 50.0})


def _findings(router):
    return [(f.code, f.process_id, round(f.value, 6)) for f in router.serve_sentry.findings]


def test_snt007_demotes_then_cooldown_readmits_equal_jax():
    def scenario(router):
        _seed_regression(router, 1)
        router._sweep_health(force=True)
        demoted = router.replica_state(1).value, 1 in router._routable()
        readmitted = retry.wait_until(
            lambda: router.replica_state(1).value == "ready", 10.0, interval_s=0.01)
        return demoted, readmitted, _findings(router)

    seen = _demotion(scenario)
    assert seen["port"] == seen["jax"]
    assert seen["port"][:2] == (("suspect", False), True)


def test_fleet_burn_never_demotes_replica_zero_equal_jax():
    def scenario(router):
        router._apply_sentry_findings(router.serve_sentry.observe_serve(burn_rate=50.0))
        router._sweep_health(force=True)
        return (router.serve_sentry.codes(), dict(router._sentry_demoted),
                router.replica_state(0).value)

    seen = _demotion(scenario)
    assert seen["port"] == seen["jax"] == (["SNT009"], {}, "ready")


def test_per_replica_burn_demotes_the_failing_replica_equal_jax():
    def scenario(router):
        now = time.monotonic()
        with router._lock:
            router._replica_outcomes[2].extend((now, False) for _ in range(20))
        router._sweep_health(force=True)
        return (any(f.code == "SNT009" and f.process_id == 2
                    for f in router.serve_sentry.findings),
                sorted(router._sentry_demoted), router.replica_state(2).value)

    seen = _demotion(scenario)
    assert seen["port"] == seen["jax"] == (True, [2], "suspect")


def test_persistent_regressor_redemotes_after_cooldown_equal_jax():
    def scenario(router):
        _seed_regression(router, 1)
        router._sweep_health(force=True)
        first = router.replica_state(1).value
        assert retry.wait_until(
            lambda: router.replica_state(1).value == "ready", 10.0, interval_s=0.01)
        for _ in range(4):                       # the regression never stopped
            router._observe_serve(ttft_s=50.0, replica_id=1)
        return (first, 1 in router._sentry_demoted,
                [c for c, pid, _ in _findings(router) if c == "SNT007" and pid == 1])

    seen = _demotion(scenario)
    assert seen["port"] == seen["jax"] == ("suspect", True, ["SNT007", "SNT007"])


def test_maintenance_window_suppresses_demotion_equal_jax():
    def scenario(router):
        with router._lock:
            router._maintenance_until = float("inf")
        _seed_regression(router, 1)
        during = ("SNT007" in router.serve_sentry.codes(), 1 in router._sentry_demoted)
        with router._lock:                       # the window closes
            router._maintenance_until = time.monotonic() - 1.0
        _seed_regression(router, 2)
        return during, 2 in router._sentry_demoted

    seen = _demotion(scenario)
    assert seen["port"] == seen["jax"] == ((True, False), True)


def test_never_demotes_last_routable_replica_equal_jax():
    def scenario(router):
        _seed_regression(router, 0, signal="itl_s")
        return ("SNT008" in router.serve_sentry.codes(), 0 in router._sentry_demoted,
                retry.wait_until(lambda: router.replica_state(0).value == "ready", 10.0,
                                 interval_s=0.01))

    seen = _demotion(scenario, n=1)
    assert seen["port"] == seen["jax"] == (True, False, True)


# ------------------------------------------- real fleets: one routed run each
N_ROUTED, ROUTED_NEW = 24, 8


def _routed_run(router, registry, prompts, kill=1):
    router.start()
    for rep in router.replicas.values():
        assert rep.wait_ready(60.0)

    def killer():
        def armed():
            with router._lock:
                return any(f.replica_id == kill and len(f.front.tokens) > 0
                           for f in router._flights.values())

        if retry.wait_until(armed, 60.0, interval_s=0.002):
            router.replicas[kill].kill("test: injected mid-decode death")

    thread = threading.Thread(target=killer, daemon=True)
    thread.start()
    fronts = [router.submit(p, max_new_tokens=ROUTED_NEW) for p in prompts]
    states = [f.wait(240.0).state.value for f in fronts]
    thread.join(timeout=5.0)
    # Both survivors READY: a loaded CPU can delay a beat past the CPU-sim
    # SUSPECT window, or read a prefill as a TTFT regression whose SNT007
    # demotion holds for its 30 s cooldown, in either package.
    assert retry.wait_until(
        lambda: router.slo_report()["router"]["replicas_ready"] == 2, 45.0, interval_s=0.01)
    return {"router": router, "registry": registry, "fronts": fronts, "states": states}


@pytest.fixture(scope="module")
def routed(tmp_path_factory):
    """One real 3-replica routed run of each package with replica 1 killed
    mid-decode, flight recorders on (the JAX fleet's weights in both)."""
    base = tmp_path_factory.mktemp("routed")
    rng = np.random.default_rng(7)
    prompts = [np.asarray(mock_load_prompt(rng, i), np.int32) for i in range(N_ROUTED)]
    jrng = np.random.default_rng(7)
    assert all(np.array_equal(p, np.asarray(jmock(jrng, i), np.int32))
               for i, p in enumerate(prompts))
    out = {}
    recorder.enable(str(base / "port-flight"))
    spans.get_tracer().clear()
    registry = M.MetricsRegistry()
    router, _ = port_fleet(n_replicas=3, registry=registry, journal_dir=str(base / "port"))
    try:
        out["port"] = _routed_run(router, registry, prompts)
        out["port"]["trace"] = spans.get_tracer().to_chrome_trace()
    finally:
        recorder.disable()
    out["port"]["records"] = recorder.read_records(str(base / "port-flight"))

    jrecorder.enable(str(base / "jax-flight"))
    jspans.get_tracer().clear()
    jregistry = JM.MetricsRegistry()
    jrouter, _ = jax_build_test_fleet(n_replicas=3, registry=jregistry,
                                      journal_dir=str(base / "jax"))
    try:
        out["jax"] = _routed_run(jrouter, jregistry, prompts)
        out["jax"]["trace"] = jspans.get_tracer().to_chrome_trace()
    finally:
        jrecorder.disable()
    out["jax"]["records"] = jrecorder.read_records(str(base / "jax-flight"))
    out["jax"]["tokens"] = [f.tokens for f in out["jax"]["fronts"]]
    yield out
    router.stop(drain=False)
    jrouter.stop(drain=False)


class TestRoutedRun:
    def test_all_completed_with_failover_equal_jax(self, routed):
        port, ref = routed["port"], routed["jax"]
        assert port["states"] == ref["states"] == ["done"] * N_ROUTED
        assert [f.tokens for f in port["fronts"]] == ref["tokens"]
        snap = port["registry"].snapshot()
        assert snap["serve_router_requests_rerouted_total"] >= 1
        # The kill's failover (a survivor whose beats a loaded CPU delays
        # past the CPU-sim DEAD window fails over too, in either package).
        assert snap["serve_router_failovers_total"] >= 1

    def test_trace_continuity_across_failover(self, routed):
        """ONE trace id; a rerouted request's span chain crosses the killed
        replica and its survivor; the journal watermark rides the failover
        span; the span names equal those of a JAX chain."""
        names_of = {}
        for pkg, sp in (("port", spans), ("jax", jspans)):
            trace = routed[pkg]["trace"]
            found = None
            for ev in (e for e in trace["traceEvents"] if e.get("name") == "serve.failover"):
                chain = sp.events_for_request(trace, ev["args"]["request_id"])
                routes = {e["args"].get("replica") for e in chain
                          if e["name"] == "serve.router.route"}
                if len(routes) < 2 or ev["args"]["delivered"] < 1:
                    continue                     # a victim that had not delivered yet
                found = (ev, chain, routes, trace)
                break
            assert found is not None, f"{pkg}: no request's chain crossed two replicas"
            ev, chain, routes, trace = found
            names = [e["name"] for e in chain]
            names_of[pkg] = set(names)
            assert "serve.router.admit" in names and "serve.request" in names
            assert ev["args"]["from_replica"] == 1 and 1 in routes and routes - {1}
            assert any(n in ("serve.prefill_chunk", "serve.decode_step",
                             "serve.queue_wait") for n in names)
            assert {e["args"].get("trace_id") for e in chain} == {
                trace["otherData"]["trace_id"]}
            t_admit = min(e["ts"] for e in chain if e["name"] == "serve.router.admit")
            t_req = max(e["ts"] + e["dur"] for e in chain if e["name"] == "serve.request")
            assert t_admit <= ev["ts"] <= t_req
        assert {"serve.router.admit", "serve.router.route", "serve.failover",
                "serve.request"} <= names_of["port"]
        assert names_of["port"] >= names_of["jax"] - {"serve.prefill_chunk"}

    def test_slo_report_measured_and_bounded(self, routed):
        report = routed["port"]["router"].slo_report()
        jreport = routed["jax"]["router"].slo_report()
        assert sorted(report) == sorted(jreport)
        assert sorted(report["router"]) == sorted(jreport["router"])
        m = report["measured"]
        for key in ("ttft_p50_s", "ttft_p99_s", "itl_p50_s", "itl_p99_s", "queue_wait_p99_s"):
            assert math.isfinite(m[key]) and m[key] >= 0, key
        assert m["ttft_p99_s"] >= m["ttft_p50_s"]
        assert m["availability"] == 1.0
        assert report["compliant"]["overall"] is True
        assert report["router"]["replicas"] == jreport["router"]["replicas"] == {
            0: "ready", 1: "dead", 2: "ready"}
        assert report["router"]["replicas_ready"] == 2
        assert report["counts"]["requests"] == jreport["counts"]["requests"] == N_ROUTED

    def test_route_spans_carry_the_resume_watermark(self, routed):
        routes = [e for e in routed["port"]["trace"]["traceEvents"]
                  if e.get("name") == "serve.router.route"]
        assert len(routes) >= N_ROUTED
        assert any(e["args"].get("resume_from", 0) > 0 for e in routes)

    def test_flight_records_equal_jax_kinds_and_fields(self, routed):
        port = record_shapes(routed["port"]["records"])
        ref = record_shapes(routed["jax"]["records"])
        router_kinds = {k for k in ref if k[0] in ("replica_transition", "reroute")
                        or k[1] == "route"}
        assert router_kinds and {k: port.get(k) for k in router_kinds} == \
            {k: ref[k] for k in router_kinds}
        route = [r for r in routed["port"]["records"] if r.get("event") == "route"]
        assert len(route) >= N_ROUTED
        assert any(r["resume_from"] > 0 for r in route)
        assert all(set(r["loads"]) == {"0", "1", "2"} or set(r["loads"]) == {0, 1, 2}
                   for r in route)

    def test_fleet_metrics_byte_parity_and_labels(self, routed):
        router = routed["port"]["router"]
        jrouter = routed["jax"]["router"]
        router.stop(drain=False)              # quiesce: two renders of one state
        jrouter.stop(drain=False)

        async def fetch(frontend, path):
            server = await asyncio.start_server(frontend._handle, "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            writer.write(f"GET {path} HTTP/1.1\r\n\r\n".encode())
            await writer.drain()
            raw = await reader.read()
            writer.close()
            server.close()
            await server.wait_closed()
            head, _, body = raw.partition(b"\r\n\r\n")
            return head.split()[1].decode(), body

        status, body = asyncio.run(fetch(RouterFrontend(router, port=0), "/metrics"))
        assert status == "200"
        assert body == render_openmetrics(snapshot=router.metrics_snapshot()).encode()
        samples = parse_openmetrics(body.decode())
        _, jbody = asyncio.run(fetch(JFrontend(jrouter, port=0), "/metrics"))
        jsamples = jparse(jbody.decode())
        labelled = {k: v for k, v in samples.items() if k[1].startswith("replica=")}
        jlabelled = {k: v for k, v in jsamples.items() if k[1].startswith("replica=")}
        assert sorted(labelled) == sorted(jlabelled)    # up / outstanding / pool / restarts
        # The killed replica's pool keeps its pages when its scheduler outlives
        # the death's 2 s join (timing decides, in either package).
        dead_pool = ("serve_replica_page_pool_utilization", 'replica="1"')
        assert {k: v for k, v in labelled.items() if k != dead_pool} == \
            {k: v for k, v in jlabelled.items() if k != dead_pool}
        assert samples[("serve_replica_up", 'replica="1"')] == 0.0
        router_names = {k[0] for k in jsamples if k[0].startswith("serve_router_")}
        assert router_names and router_names <= {k[0] for k in samples}

        for path, keys in (("/slo", {"slo", "measured", "burn_rate", "compliant"}),
                           ("/healthz", {"ok", "replicas", "replicas_ready"})):
            status, body = asyncio.run(fetch(RouterFrontend(router, port=0), path))
            _, jbody = asyncio.run(fetch(JFrontend(jrouter, port=0), path))
            doc, jdoc = json.loads(body), json.loads(jbody)
            assert set(doc) >= keys and sorted(doc) == sorted(jdoc)
        assert json.loads(body)["replicas"] == json.loads(jbody)["replicas"]


# --------------------------------------------------------- HTTP front end
def test_parse_sampling_tenant_defaults_equal_jax():
    defaults = {"acme": SamplingParams(temperature=0.7, top_p=0.9, seed=11)}
    jdefaults = {"acme": JSampling(temperature=0.7, top_p=0.9, seed=11)}
    payloads = [{"tenant": "acme"}, {"tenant": "acme", "temperature": 1.4}, {},
                {"tenant": "other"}, {"tenant": "acme", "top_k": 5, "seed": 2},
                {"temperature": 0.5}]
    for payload in payloads:
        got, want = parse_sampling(payload, defaults), jparse_sampling(payload, jdefaults)
        assert (got is None) == (want is None), payload
        if got is not None:
            assert got.to_dict() == want.to_dict(), payload
    assert parse_sampling({"tenant": "acme"}, defaults) == defaults["acme"]
    got = parse_sampling({"tenant": "acme", "temperature": 1.4}, defaults)
    assert got.temperature == 1.4 and got.top_p == 0.9
    with pytest.raises(InvalidSamplingParams):
        parse_sampling({"tenant": "acme", "top_p": 0.0}, defaults)


async def _http(port, method, path, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nContent-Length: {len(data)}\r\n\r\n"
                 .encode() + data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), json.loads(payload)


def test_router_frontend_generate_with_tenant_defaults_and_shutdown():
    tenant = {"acme": SamplingParams(temperature=0.9, top_k=20, seed=5)}
    router, control = port_fleet(n_replicas=2)
    prompt = [5, 9, 14, 2, 7]
    want_greedy = control.generate(prompt, 6)
    want_sampled = control.generate(prompt, 6, request_id="t-1", sampling=tenant["acme"])

    async def main():
        fe = await RouterFrontend(router, port=0, tenant_defaults=tenant).start()
        serving = asyncio.ensure_future(fe.serve_forever())
        assert await asyncio.to_thread(
            retry.wait_until, lambda: router.replica_state(1) is ReplicaState.READY, 30.0)
        out = [await _http(fe.port, "POST", "/generate", {"tokens": prompt,
                                                          "max_new_tokens": 6}),
               await _http(fe.port, "POST", "/generate",
                           {"tokens": prompt, "max_new_tokens": 6, "tenant": "acme",
                            "request_id": "t-1"}),
               await _http(fe.port, "POST", "/generate",
                           {"tokens": prompt, "max_new_tokens": 6, "temperature": -1}),
               await _http(fe.port, "POST", "/generate",
                           {"tokens": list(range(1, 60)), "max_new_tokens": 30}),
               await _http(fe.port, "POST", "/generate", {"max_new_tokens": 6}),
               await _http(fe.port, "GET", "/healthz"),
               await _http(fe.port, "GET", "/nowhere")]
        # A client's idle connection does not hold the shutdown.
        _idle = await asyncio.open_connection("127.0.0.1", fe.port)
        serving.cancel()
        t0 = time.monotonic()
        try:
            await serving
        except asyncio.CancelledError:
            pass
        out.append(time.monotonic() - t0)
        _idle[1].close()
        await fe.close()                      # stops the router
        return out

    greedy, sampled, bad, unservable, malformed, health, missing, took = asyncio.run(main())
    assert greedy[0] == 200 and greedy[1]["tokens"] == want_greedy
    assert sampled[0] == 200 and sampled[1]["tokens"] == want_sampled
    assert sampled[1]["id"] == "t-1" and want_sampled != want_greedy
    assert bad == (400, bad[1]) and bad[1]["type"] == "invalid_sampling_params"
    assert unservable[0] == 400 and "admission rejected" in unservable[1]["error"]
    assert malformed[0] == 400 and missing[0] == 404
    assert health == (200, {"ok": True, "replicas": {"0": "ready", "1": "ready"},
                            "replicas_ready": 2, "outstanding": 0})
    assert took < 2.0
    assert router.try_submit([1, 2], 2).error == "admission rejected: router is stopped"


def test_router_frontend_backpressure_and_fleet_down_codes():
    router, _ = port_fleet(n_replicas=1)

    async def main():
        fe = await RouterFrontend(router, port=0).start()
        assert await asyncio.to_thread(router.replicas[0].wait_ready, 30.0)
        assert await asyncio.to_thread(
            retry.wait_until, lambda: router.replica_state(0) is ReplicaState.READY, 30.0)
        router.replicas[0].kill("test: the whole fleet down")
        assert await asyncio.to_thread(
            retry.wait_until, lambda: router.replica_state(0) is ReplicaState.DEAD, 30.0)
        down = await _http(fe.port, "GET", "/healthz")
        router.stop(drain=False)
        shed = await _http(fe.port, "POST", "/generate", {"tokens": [1, 2, 3]})
        await fe.close()
        return down, shed

    down, shed = asyncio.run(main())
    assert down[0] == 503 and down[1]["replicas"] == {"0": "dead"} and not down[1]["ok"]
    assert shed == (429, {"error": "router is stopped"})


def test_serve_frontend_tenant_defaults():
    _, control = port_fleet(n_replicas=1)
    tenant = {"acme": SamplingParams(temperature=1.1, seed=3)}
    want = control.generate([3, 4, 5], 5, request_id="s-1", sampling=tenant["acme"])

    async def main():
        fe = await ServeFrontend(ContinuousBatcher(control, registry=M.MetricsRegistry()),
                                 port=0, tenant_defaults=tenant).start()
        got = await _http(fe.port, "POST", "/generate",
                          {"tokens": [3, 4, 5], "max_new_tokens": 5, "tenant": "acme",
                           "request_id": "s-1"})
        await fe.close()
        return got

    code, body = asyncio.run(main())
    assert code == 200 and body["tokens"] == want and body["state"] == "done"
