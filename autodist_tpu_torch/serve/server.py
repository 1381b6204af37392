"""Asyncio HTTP front end over the continuous batcher (PyTorch port).

Ports ``ServeFrontend`` of the JAX package's ``serve/server.py``: a
dependency-free HTTP/1.1 listener on ``asyncio.start_server`` that bridges
requests onto the batcher's scheduler thread (completion callbacks resolve
asyncio futures via ``call_soon_threadsafe`` — the event loop never touches
the device). Routes:

- ``POST /generate`` ``{"tokens": [...], "max_new_tokens": N,
  "timeout_s": T?, "temperature": t?, "top_k": k?, "top_p": p?, "seed": s?,
  "tenant": name?, "request_id": id?}`` → ``{"tokens": [...], "state":
  "done"}``; 429 on backpressure, 400 on an unservable request or malformed
  sampling params (typed ``invalid_sampling_params``). Explicit sampling
  fields override the tenant's defaults (``tenant_defaults``); absent both,
  decode is greedy. ``temperature > 0`` draws the counter-based stochastic
  stream of ``(request_id, seed)`` (``serve/sampling.py``).
- ``GET /metrics`` → the metrics registry as OpenMetrics text.
- ``GET /slo`` → the ``slo_report`` of the batcher's
  :class:`~autodist_tpu_torch.obs.slo.SLOTracker` (NaN-safe JSON); 404 when
  none was wired.
- ``GET /healthz`` → typed readiness (``ReplicaState``) + queue/slot gauges
  + page-pool utilization as JSON: 200 only when ``READY``, 503 while
  ``STARTING``/``DRAINING`` (or ``DEAD``).
- ``POST /drain`` → graceful drain. Through a
  :class:`~autodist_tpu_torch.serve.replica.Replica` (quiesce → finish
  in-flight → persist leftovers) it reports ``{"drained": n, "persisted":
  n}``; over a bare batcher ``{"drained": n, "persisted": 0, "preempted":
  n}``.

With a replica the listener binds before the (possibly long) engine build,
which runs on a thread: a probe during the build gets a typed 503, not a
refused connection.

:class:`RouterFrontend` is the fleet's address in front of a
:class:`~autodist_tpu_torch.serve.router.Router` (``POST /generate``, the
fleet's ``GET /metrics``, ``/healthz`` and ``/slo``). Both front ends share
one shutdown path: closing the listener cancels every connection still
open, so ``serve_forever`` returns even when a client holds a socket, and
:func:`serve_until_signal` turns SIGTERM into that return through the
event loop (never an exception raised between two of asyncio's own
bytecodes, which can leave a closed connection counted open forever).
"""
from __future__ import annotations

import asyncio
import json
import signal
import threading
import time
from typing import Any, Dict, Optional, Set

import numpy as np
import torch

from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.serve.batcher import (
    Backpressure,
    ContinuousBatcher,
    RequestState,
)
from autodist_tpu_torch.serve.sampling import InvalidSamplingParams, SamplingParams
from autodist_tpu_torch.utils import logging


#: Seconds a closing listener waits for its cancelled connections to end.
CLOSE_TIMEOUT_S = 5.0


async def async_generate(batcher: ContinuousBatcher, tokens,
                         max_new_tokens: int = 32,
                         timeout_s: Optional[float] = None,
                         request_id: Optional[str] = None,
                         sampling: Optional[SamplingParams] = None):
    """Submit + await one request from the event loop. ``batcher`` is
    anything with the ``submit`` contract (a batcher or a router)."""
    loop = asyncio.get_running_loop()
    fut: asyncio.Future = loop.create_future()
    req = batcher.submit(tokens, max_new_tokens, timeout_s=timeout_s,
                         request_id=request_id, sampling=sampling)
    req.add_done_callback(
        lambda r: loop.call_soon_threadsafe(
            lambda: fut.done() or fut.set_result(r)))
    return await fut


def parse_sampling(payload: Dict[str, Any],
                   tenant_defaults: Optional[Dict[str, SamplingParams]] = None,
                   ) -> Optional[SamplingParams]:
    """One request's sampling params: the body fields (``temperature`` /
    ``top_k`` / ``top_p`` / ``seed``) override the ``tenant``'s defaults,
    which override greedy. None (greedy) when neither the body nor the
    tenant names any. Raises :class:`InvalidSamplingParams` on out-of-range
    or non-numeric values."""
    tenant = payload.get("tenant")
    base = (tenant_defaults or {}).get(tenant) if tenant else None
    fields = {k: payload[k] for k in ("temperature", "top_k", "top_p", "seed")
              if k in payload}
    if base is None and not fields:
        return None
    doc = (base or SamplingParams()).to_dict()
    doc.update(fields)
    try:
        params = SamplingParams(
            temperature=float(doc["temperature"]), top_k=int(doc["top_k"]),
            top_p=float(doc["top_p"]), seed=int(doc["seed"]))
    except (TypeError, ValueError) as e:
        raise InvalidSamplingParams(f"bad sampling params: {e}") from e
    return params.validate()


def mock_load_prompt(rng, i: Optional[int] = None, long_every: int = 8,
                     vocab: int = 127):
    """The canonical mixed serving load: mostly short chat-style prompts
    (3-11 tokens) with every ``long_every``-th request a long
    (multi-chunk-prefill, 30-44 tokens) one; token ids in ``[1, vocab)``."""
    if i is not None and i % long_every == long_every // 2:
        return rng.integers(1, vocab, size=int(rng.integers(30, 45)))
    return rng.integers(1, vocab, size=int(rng.integers(3, 12)))


class _Listener:
    """The HTTP listener both front ends share: it binds, tracks each
    connection's handler task, and on close cancels the ones still open
    before it waits for the server, so closing never waits on a client."""

    host: str
    port: int
    _server: Optional[asyncio.AbstractServer] = None

    async def _listen(self, name: str) -> None:
        self._conns: Set[asyncio.Task] = set()
        self._server = await asyncio.start_server(self._connection, self.host,
                                                  self.port)
        addr = self._server.sockets[0].getsockname()
        self.port = addr[1]
        logging.info("%s listening on %s:%d", name, *addr[:2])

    async def _connection(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        try:
            await self._handle(reader, writer)
        finally:
            self._conns.discard(task)

    async def _handle(self, reader, writer) -> None:
        raise NotImplementedError

    async def serve_forever(self) -> None:
        """Serve until cancelled; the listener is closed on the way out.
        (Not ``Server.serve_forever``: cancelled, it waits for every open
        connection to close before it returns, a client's idle socket
        included.)"""
        if self._server is None:
            await self.start()
        try:
            await asyncio.get_running_loop().create_future()
        finally:
            await self._close_listener()

    async def _close_listener(self) -> None:
        server, self._server = self._server, None
        if server is None:
            return
        server.close()
        conns = set(self._conns)
        for task in conns:
            task.cancel()
        try:
            if conns:
                await asyncio.wait(conns, timeout=CLOSE_TIMEOUT_S)
            await asyncio.wait_for(server.wait_closed(), CLOSE_TIMEOUT_S)
        except asyncio.TimeoutError:
            logging.warning("listener on port %d: connections still open after "
                            "%.0f s; closing anyway", self.port, CLOSE_TIMEOUT_S)


def serve_until_signal(frontend) -> None:
    """Run ``frontend.serve_forever()`` on a new event loop until SIGTERM
    (or SIGINT) and return once the listener is closed. The signal is taken
    by the event loop, so the shutdown starts between two callbacks and
    never inside one."""

    async def main() -> None:
        loop = asyncio.get_running_loop()
        task = asyncio.current_task()
        loop.add_signal_handler(signal.SIGTERM, task.cancel)
        try:
            await frontend.serve_forever()
        except asyncio.CancelledError:
            pass
        finally:
            loop.remove_signal_handler(signal.SIGTERM)

    asyncio.run(main())


class ServeFrontend(_Listener):
    """Minimal HTTP server over one batcher (or one
    :class:`~autodist_tpu_torch.serve.replica.Replica`, which adds typed
    readiness to ``/healthz`` and a persisting drain to ``POST /drain``)."""

    def __init__(self, batcher: Optional[ContinuousBatcher], host: str = "127.0.0.1",
                 port: int = 8476, registry: Optional[M.MetricsRegistry] = None,
                 replica=None,
                 tenant_defaults: Optional[Dict[str, SamplingParams]] = None):
        self._batcher = batcher
        self.host, self.port = host, port
        self.replica = replica
        self.registry = registry or (replica.registry if replica is not None
                                     else batcher._registry)
        # tenant name -> default SamplingParams; a request's explicit body
        # fields override them (parse_sampling).
        self.tenant_defaults = dict(tenant_defaults or {})

    @property
    def batcher(self) -> Optional[ContinuousBatcher]:
        """The live batcher: a replica swaps its batcher across drain and
        restart, so the front end always asks it."""
        if self.replica is not None and self.replica.batcher is not None:
            return self.replica.batcher
        return self._batcher

    async def start(self) -> "ServeFrontend":
        if self.replica is not None:
            threading.Thread(target=self.replica.start, name="replica-start",
                             daemon=True).start()
        else:
            self.batcher.start()
        await self._listen("serve frontend")
        return self

    async def close(self) -> None:
        await self._close_listener()
        if self.replica is not None:
            self.replica.stop()
        elif self.batcher is not None:
            self.batcher.stop()

    # ----------------------------------------------------------------- http
    @staticmethod
    async def _read_request(reader) -> Optional[tuple]:
        line = await reader.readline()
        if not line:
            return None
        try:
            method, path, _ = line.decode().split(None, 2)
        except ValueError:
            return None
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        body = b""
        n = int(headers.get("content-length", 0) or 0)
        if n:
            body = await reader.readexactly(n)
        return method.upper(), path, headers, body

    @staticmethod
    def _respond(writer, status: int, payload, content_type="application/json"):
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  429: "Too Many Requests", 500: "Internal Server Error",
                  503: "Service Unavailable"}
        body = (json.dumps(payload).encode()
                if content_type == "application/json" else payload.encode())
        writer.write(
            f"HTTP/1.1 {status} {reason.get(status, '')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: close\r\n\r\n".encode() + body)

    async def _handle(self, reader, writer) -> None:
        try:
            parsed = await self._read_request(reader)
            if parsed is None:
                return
            method, path, _, body = parsed
            if method == "GET" and path == "/metrics":
                self._respond(writer, 200, self.registry.render_text(),
                              content_type="text/plain")
            elif method == "GET" and path == "/slo":
                self._slo(writer)
            elif method == "GET" and path == "/healthz":
                self._healthz(writer)
            elif method == "POST" and path == "/drain":
                await self._drain(writer)
            elif method == "POST" and path == "/generate":
                await self._generate(writer, body)
            else:
                self._respond(writer, 404, {"error": f"no route {path}"})
            await writer.drain()
        except Exception as e:  # noqa: BLE001 - per-connection isolation
            try:
                self._respond(writer, 500, {"error": str(e)})
                await writer.drain()
            except Exception:  # noqa: BLE001
                pass
        finally:
            writer.close()

    def _slo(self, writer) -> None:
        """The batcher's ``slo_report`` (404 when no tracker was wired)."""
        from autodist_tpu_torch.obs.slo import json_safe

        batcher = self.batcher
        tracker = getattr(batcher, "slo", None) if batcher else None
        if tracker is None:
            self._respond(writer, 404, {
                "error": "no SLO tracker wired; construct the batcher/"
                         "replica with slo=obs.slo.SLOTracker(spec)"})
            return
        self._respond(writer, 200, json_safe(tracker.report()))

    def _healthz(self, writer) -> None:
        """Typed readiness probe: 200 only when READY, else 503."""
        from autodist_tpu_torch.serve.replica import ReplicaState

        if self.replica is not None:
            doc = self.replica.healthz()
            state = self.replica.state
        else:
            # A bare batcher has no STARTING phase to observe; a stopped one
            # (engine death) can serve nothing.
            b = self.batcher
            state = (ReplicaState.DRAINING if b.draining
                     else ReplicaState.DEAD if b.stopped else ReplicaState.READY)
            doc = {
                "state": state.value,
                "outstanding": b.outstanding,
                "page_pool_utilization": round(float(b.engine.page_utilization), 4),
            }
        batcher = self.batcher
        doc["ok"] = state is ReplicaState.READY
        doc["queue_depth"] = batcher.queue_depth if batcher else 0
        doc["active_slots"] = batcher.engine.active_slots if batcher else 0
        self._respond(writer, 200 if doc["ok"] else 503, doc)

    async def _drain(self, writer) -> None:
        """Admin drain, off the event loop (it blocks up to its deadline)."""
        if self.replica is not None:
            out = await asyncio.to_thread(self.replica.drain)
        else:
            finished, leftovers = await asyncio.to_thread(self.batcher.drain)
            out = {"drained": finished, "persisted": 0,
                   "preempted": len(leftovers)}
        self._respond(writer, 200, out)

    async def _generate(self, writer, body: bytes) -> None:
        try:
            payload = json.loads(body.decode() or "{}")
            tokens = payload["tokens"]
            max_new = int(payload.get("max_new_tokens", 32))
            sampling = parse_sampling(payload, self.tenant_defaults)
            batcher = self.batcher
            if batcher is None:
                self._respond(writer, 503, {"error": "replica is not ready "
                                                     "(starting or draining)"})
                return
            req = await async_generate(
                batcher, tokens, max_new,
                timeout_s=payload.get("timeout_s"),
                request_id=payload.get("request_id") or None,
                sampling=sampling)
        except InvalidSamplingParams as e:
            self._respond(writer, 400, {"error": str(e),
                                        "type": "invalid_sampling_params"})
            return
        except Backpressure as e:
            self._respond(writer, 429, {"error": str(e)})
            return
        except (ValueError, KeyError, TypeError) as e:
            self._respond(writer, 400, {"error": f"bad request: {e}"})
            return
        if req.state is RequestState.REJECTED and req.unservable:
            self._respond(writer, 400, {"error": req.error})
            return
        self._respond(writer, 200, {
            "id": req.id,
            "state": req.state.value,
            "tokens": req.tokens,
            "latency_s": req.latency_s,
        })


class RouterFrontend(_Listener):
    """HTTP front end of the multi-replica control plane
    (:class:`~autodist_tpu_torch.serve.router.Router`): the fleet's single
    client-visible address. Routes:

    - ``POST /generate`` — admitted through the router (journaled,
      exactly-once, failover-transparent), with the tenant's sampling
      defaults; 429 on router backpressure, 400 on an unservable request.
    - ``GET /metrics`` — the FLEET exposition: the shared registry plus
      per-replica samples labeled ``{replica="<id>"}``
      (``Router.metrics_snapshot``), rendered by ``render_openmetrics``
      (byte-identical to it on the same snapshot).
    - ``GET /healthz`` — fleet readiness JSON (per-replica states from
      the router's observer-combined view); 200 while at least one
      replica is READY, 503 otherwise.
    - ``GET /slo`` — the router's ``slo_report`` (NaN-safe JSON).
    """

    def __init__(self, router, host: str = "127.0.0.1", port: int = 8475,
                 tenant_defaults: Optional[Dict[str, SamplingParams]] = None):
        self.router = router
        self.host, self.port = host, port
        self.tenant_defaults = dict(tenant_defaults or {})

    async def start(self) -> "RouterFrontend":
        self.router.start()
        await self._listen("router frontend")
        return self

    async def close(self) -> None:
        await self._close_listener()
        self.router.stop()

    async def _handle(self, reader, writer) -> None:
        respond = ServeFrontend._respond
        try:
            parsed = await ServeFrontend._read_request(reader)
            if parsed is None:
                return
            method, path, _, body = parsed
            if method == "GET" and path == "/metrics":
                from autodist_tpu_torch.obs.exporter import render_openmetrics

                respond(writer, 200,
                        render_openmetrics(
                            snapshot=self.router.metrics_snapshot()),
                        content_type="text/plain")
            elif method == "GET" and path == "/healthz":
                self._healthz(writer)
            elif method == "GET" and path == "/slo":
                from autodist_tpu_torch.obs.slo import json_safe

                # json_safe: an empty-window report carries NaN
                # percentiles, and bare NaN is not RFC-8259 JSON.
                respond(writer, 200, json_safe(self.router.slo_report()))
            elif method == "POST" and path == "/generate":
                await self._generate(writer, body)
            else:
                respond(writer, 404, {"error": f"no route {path}"})
            await writer.drain()
        except Exception as e:  # noqa: BLE001 - per-connection isolation
            try:
                respond(writer, 500, {"error": str(e)})
                await writer.drain()
            except Exception:  # noqa: BLE001
                pass
        finally:
            writer.close()

    def _healthz(self, writer) -> None:
        states = {rid: self.router.replica_state(rid).value
                  for rid in sorted(self.router.replicas)}
        ready = sum(1 for s in states.values() if s == "ready")
        doc = {
            "ok": ready >= 1,
            "replicas": {str(k): v for k, v in states.items()},
            "replicas_ready": ready,
            "outstanding": self.router.outstanding,
        }
        ServeFrontend._respond(writer, 200 if doc["ok"] else 503, doc)

    async def _generate(self, writer, body: bytes) -> None:
        respond = ServeFrontend._respond
        try:
            payload = json.loads(body.decode() or "{}")
            tokens = payload["tokens"]
            max_new = int(payload.get("max_new_tokens", 32))
            sampling = parse_sampling(payload, self.tenant_defaults)
        except InvalidSamplingParams as e:
            respond(writer, 400, {
                "error": str(e), "type": "invalid_sampling_params"})
            return
        except (ValueError, KeyError) as e:
            respond(writer, 400, {"error": f"bad request body: {e}"})
            return
        try:
            req = await async_generate(
                self.router, tokens, max_new,
                timeout_s=payload.get("timeout_s"),
                request_id=payload.get("request_id") or None,
                sampling=sampling)
        except Backpressure as e:
            respond(writer, 429, {"error": str(e)})
            return
        except ValueError as e:
            respond(writer, 400, {"error": str(e)})
            return
        if req.state is RequestState.REJECTED and req.unservable:
            respond(writer, 400, {"error": req.error})
            return
        respond(writer, 200, {
            "id": req.request_id,
            "state": req.state.value,
            "tokens": req.tokens,
            "latency_s": req.latency_s,
        })


# ---------------------------------------------------------------- selftest
#: The bucketed baseline's geometry: 4 slots in each of three buckets = 448
#: KV timeline tokens resident on the device. The paged engine is sized to
#: the SAME 448 tokens (56 pages x 8, the scratch page included) — the
#: equal-memory axis of the >=2x concurrency proof.
_BASELINE_SLOTS = 4
_BASELINE_BUCKETS = (16, 32, 64)
_PAGE_LEN = 8
_N_PAGES = _BASELINE_SLOTS * sum(_BASELINE_BUCKETS) // _PAGE_LEN


def _tiny_cfg(**overrides):
    """The selftest's tiny fp32 causal transformer (vocab 128, 2 layers,
    d 32, 2 heads, 64 positions)."""
    from autodist_tpu_torch.models.transformer import TransformerConfig

    kw = dict(vocab_size=128, num_layers=2, d_model=32, num_heads=2, d_ff=64,
              max_seq_len=64, causal=True, dtype="float32")
    kw.update(overrides)
    return TransformerConfig(**kw)


def _tiny_engine(n_slots: int = 32, page_len: int = _PAGE_LEN,
                 n_pages: Optional[int] = _N_PAGES, prefix_cache: bool = False,
                 kv_quant: bool = False, paged_impl: Optional[str] = None,
                 device="cuda"):
    """A paged engine of the tiny transformer through the full
    ``AutoDist.build_inference`` path on ``device``. Returns ``(engine,
    params, cfg)`` so callers can stand a bucketed baseline on the same
    params. ``kv_quant`` serves from int8 KV pages; ``paged_impl`` forces
    ``"gather"`` or ``"kernel"`` (default: the config's ``"auto"``)."""
    from autodist_tpu_torch.api import AutoDist
    from autodist_tpu_torch.models.transformer import decode_model, init_params

    overrides = {}
    if kv_quant:
        overrides["kv_quant"] = True
    if paged_impl is not None:
        overrides["paged_attention_impl"] = paged_impl
    cfg = _tiny_cfg(**overrides)
    params = init_params(cfg, seed=0, device=device)
    AutoDist.reset_default()
    try:
        engine = AutoDist(device=device).build_inference(
            params, decode_model=decode_model(cfg), n_slots=n_slots, page_len=page_len,
            n_pages=n_pages, prefill_chunk=page_len, prefix_cache=prefix_cache)
    finally:
        AutoDist.reset_default()
    return engine, params, cfg


def _admission_capacity(engine, prompt_len: int, max_new: int, limit: int = 1024) -> int:
    """How many concurrent requests the engine holds admitted at once (an
    idle probe: reserve until denied, then release everything). For the
    paged engine admission is page bookkeeping; for the bucketed baseline
    each admit runs its prefill — both count capacity, the memory figure the
    >=2x bar compares."""
    from autodist_tpu_torch.serve.engine import AdmissionDenied

    held = []
    prompt = np.arange(1, prompt_len + 1, dtype=np.int32)
    for _ in range(limit):
        got = engine.admit(prompt, max_new)
        if got is None or isinstance(got, AdmissionDenied):
            break
        held.append(got[0] if isinstance(got, tuple) else got)
    for slot in held:
        engine.release(slot)
    return len(held)


#: The logit-drift bound of int8 KV pages against the fp oracle
#: (teacher-forced max |Δlogit| on the tiny selftest model), the JAX
#: package's.
QUANT_LOGIT_DRIFT_BOUND = 0.05


def _quant_logit_drift(params, cfg, page_len: int = _PAGE_LEN, steps: int = 6) -> float:
    """Teacher-forced max |logit| drift of int8 KV pages against the fp
    oracle: both caches replay the SAME token history (the fp oracle's
    stream), so the number is quantization error, not divergence
    compounding. It runs the model's forwards directly, never an engine's,
    so no engine's program count moves."""
    from autodist_tpu_torch.models.transformer import (
        forward_paged_decode_step, forward_paged_prefill_chunk, init_paged_kv_cache)

    dev = params["embed"]["embedding"].device
    prompt = torch.arange(1, page_len + 1, dtype=torch.int32, device=dev)  # one page
    table_row = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device=dev)
    caches = [init_paged_kv_cache(cfg, 6, page_len, quantized=q, device=dev)
              for q in (False, True)]
    token = None
    with torch.no_grad():
        for i in range(2):
            nt, caches[i] = forward_paged_prefill_chunk(
                params, prompt[None], 0, page_len, caches[i], table_row, cfg)
            if i == 0:
                token = nt                       # the fp oracle drives both
        tables = table_row[None]
        pos = page_len
        drift = 0.0
        for _ in range(steps):
            step_logits = []
            for i in range(2):
                nt, lg, caches[i] = forward_paged_decode_step(
                    params, token, torch.tensor([pos], dtype=torch.int32, device=dev),
                    caches[i], tables, cfg, return_logits=True)
                step_logits.append(lg)
                if i == 0:
                    next_token = nt
            drift = max(drift, float((step_logits[0] - step_logits[1]).abs().max()))
            token, pos = next_token, pos + 1
    return drift


def _decode_impl(engine, cfg) -> str:
    """The paged attention a decode step of ``engine`` takes under the
    config's ``"auto"``: the measured crossover on CUDA, gather on the
    CPU."""
    from autodist_tpu_torch.ops import paged_attention as pa_ops

    return pa_ops.resolve_impl(cfg.paged_attention_impl, engine.device,
                               batch=engine.n_slots, table_pages=engine.max_pages,
                               page_len=engine.page_len, heads=cfg.num_heads)


def _run_clients(batcher, prompts, max_new: int):
    """``prompts`` as concurrent mock clients through the asyncio bridge,
    arrivals staggered a millisecond apart in groups of 8."""
    async def client(i, prompt):
        await asyncio.sleep(0.001 * (i % 8))
        return await async_generate(batcher, prompt, max_new)

    async def run():
        return await asyncio.gather(*(client(i, p) for i, p in enumerate(prompts)))

    batcher.start()
    try:
        return asyncio.run(asyncio.wait_for(run(), timeout=300))
    finally:
        batcher.stop(drain=False)


def selftest(n_requests: int = 64, n_slots: int = 32, max_new: int = 12,
             seed: int = 0, kv_quant: bool = False, device="cuda") -> int:
    """The single-engine acceptance proof on ``device``; returns a process
    exit code and prints one JSON line with the JAX selftest's keys.

    Paged against bucketed: a :class:`~autodist_tpu_torch.serve.engine.
    BucketedInferenceEngine` over the SAME params holds 448 KV timeline
    tokens; the paged engine (gather attention), sized to the same 448
    tokens, must hold >=2x the concurrently admitted requests on a short
    mix (6 prompt + 6 new) and give bit-identical greedy streams on shared
    prompts (short, page-crossing, multi-chunk). A second paged engine on
    the paged kernel must stream bit-identically to the gather engine.
    Then single requests back to back (the sequential baseline) and
    ``n_requests`` concurrent mock clients (mixed short and long prompts)
    through the asyncio bridge and the continuous batcher: zero dropped,
    batched tokens/s above sequential, and exactly two serving programs
    (:attr:`~autodist_tpu_torch.serve.engine.InferenceEngine.
    compiled_programs`) after the whole mixed-length run.

    ``kv_quant=True`` runs :func:`_selftest_quant` instead.
    """
    if kv_quant:
        return _selftest_quant(n_requests=n_requests, max_new=max_new, seed=seed,
                               device=device)
    from autodist_tpu_torch.models.transformer import decode_model
    from autodist_tpu_torch.serve.engine import BucketedInferenceEngine

    registry = M.MetricsRegistry()
    rng = np.random.default_rng(seed)
    engine, params, cfg = _tiny_engine(n_slots=n_slots, paged_impl="gather", device=device)
    bucketed = BucketedInferenceEngine(
        params, decode_model(cfg), n_slots=_BASELINE_SLOTS,
        bucket_lens=_BASELINE_BUCKETS, device=device)
    paged_pool_tokens = engine.pool.n_pages * engine.page_len
    if paged_pool_tokens > bucketed.kv_pool_tokens:
        raise AssertionError(
            f"equal-memory premise broken: paged pool holds {paged_pool_tokens} "
            f"timeline tokens vs bucketed {bucketed.kv_pool_tokens}")

    # ---- concurrency at equal KV memory (short-request mix: 6 + 6).
    paged_cap = _admission_capacity(engine, 6, 6)
    bucketed_cap = _admission_capacity(bucketed, 6, 6)
    concurrency_x = paged_cap / max(bucketed_cap, 1)

    # ---- greedy bit-equality on the same params.
    parity_prompts = [
        np.array([5, 17, 3, 88, 2], np.int32),
        rng.integers(1, 127, size=20).astype(np.int32),   # crosses pages
        rng.integers(1, 127, size=41).astype(np.int32),   # many chunks
    ]
    parity_ok = all(engine.generate(p, 10) == bucketed.generate(p, 10)
                    for p in parity_prompts)

    # ---- the paged kernel against the gather path: bit-identical streams.
    kernel_engine, _, _ = _tiny_engine(n_slots=4, paged_impl="kernel", device=device)
    kernel_parity_ok = all(engine.generate(p, 10) == kernel_engine.generate(p, 10)
                           for p in parity_prompts)

    def mock_prompt(i=None):
        return mock_load_prompt(rng, i)

    engine.generate(mock_prompt(), max_new)   # warm-up outside both timed phases
    t0 = time.monotonic()
    seq_tokens = sum(len(engine.generate(mock_prompt(), max_new)) for _ in range(8))
    seq_tps = seq_tokens / (time.monotonic() - t0)

    batcher = ContinuousBatcher(engine, max_queue=max(n_requests, 64), registry=registry)
    t1 = time.monotonic()
    results = _run_clients(batcher, [mock_prompt(i) for i in range(n_requests)], max_new)
    dt_batched = time.monotonic() - t1

    batched_tps = sum(len(r.tokens) for r in results) / dt_batched
    states = {s: sum(1 for r in results if r.state is s) for s in RequestState}
    snap = registry.snapshot()
    lat = snap.get("serve_request_latency_s", {})
    programs = engine.compiled_programs
    done = states.get(RequestState.DONE, 0)
    ok = (done == n_requests and batched_tps > seq_tps and concurrency_x >= 2.0
          and parity_ok and kernel_parity_ok and programs == 2)
    line = {
        "selftest": "autodist_tpu_torch.serve",
        "ok": bool(ok),
        "n_requests": n_requests,
        "completed": done,
        "dropped": n_requests - done,
        "p50_latency_s": round(lat.get("p50", float("nan")), 4),
        "p99_latency_s": round(lat.get("p99", float("nan")), 4),
        "batched_tokens_per_sec": round(batched_tps, 1),
        "sequential_tokens_per_sec": round(seq_tps, 1),
        "speedup": round(batched_tps / seq_tps, 2) if seq_tps else None,
        "tokens_generated": int(snap.get("serve_tokens_generated_total", 0)),
        "queue_depth_final": int(snap.get("serve_queue_depth", 0)),
        "paged_capacity": paged_cap,
        "bucketed_capacity": bucketed_cap,
        "concurrency_x_vs_bucketed": round(concurrency_x, 2),
        "kv_pool_tokens": paged_pool_tokens,
        "paged_vs_bucketed_bit_equal": bool(parity_ok),
        "kernel_vs_gather_bit_equal": bool(kernel_parity_ok),
        "kv_quant": "off",
        "programs_compiled": programs,
        "page_len": engine.page_len,
        "n_pages": engine.pool.n_pages,
        "n_slots": engine.n_slots,
        "paged_impl": "gather",
        "kernel_engine_impl": "kernel",
        "device": engine.device.type,
    }
    print(json.dumps(line), flush=True)
    if not ok:
        logging.warning(
            "selftest failed: states=%s seq=%.1f batched=%.1f concurrency_x=%.2f "
            "parity=%s kernel_parity=%s programs=%d",
            {s.value: n for s, n in states.items() if n}, seq_tps, batched_tps,
            concurrency_x, parity_ok, kernel_parity_ok, programs)
    return 0 if ok else 1


def _selftest_quant(n_requests: int = 64, max_new: int = 12, seed: int = 0,
                    device="cuda") -> int:
    """The int8-KV-pages acceptance proof (``--selftest --kv-quant``) on
    ``device``: an fp paged engine (the oracle) and an int8 one sized to the
    SAME pool bytes, both with copy-on-write prefix sharing on. The int8
    pool funds 3.2x the pages (int8 + fp32 scales against fp32 KV at
    head_dim 16), which must buy >=2x admitted concurrency; the batched
    phase drops nothing; the teacher-forced logit drift against the fp
    oracle stays within :data:`QUANT_LOGIT_DRIFT_BOUND`; the paged kernel
    over the same int8 pages streams bit-identically to the gather path;
    the memory pass (``analysis/passes.py::hbm_budget``) prices the
    PHYSICAL quantized bytes with the capacity multiplier beside them; and
    the int8 engine runs exactly two serving programs."""
    from autodist_tpu_torch.analysis.passes import hbm_budget
    from autodist_tpu_torch.models.transformer import init_paged_kv_cache

    registry = M.MetricsRegistry()
    rng = np.random.default_rng(seed)
    n_slots = 96   # past both pools' page capacity: pages bind, as compared
    fp_engine, params, cfg = _tiny_engine(n_slots=n_slots, prefix_cache=True,
                                          device=device)
    fp_pool_bytes = fp_engine.page_pool_bytes

    # Size the int8 pool to the fp pool's byte budget.
    quant_page_bytes = sum(
        t.numel() * t.element_size() for t in init_paged_kv_cache(
            cfg, 1, _PAGE_LEN, quantized=True, device="meta").values())
    n_pages_q = int(fp_pool_bytes // quant_page_bytes)
    engine, _, _ = _tiny_engine(n_slots=n_slots, n_pages=n_pages_q, kv_quant=True,
                                prefix_cache=True, device=device)
    equal_bytes_ok = engine.page_pool_bytes <= fp_pool_bytes

    # ---- admitted concurrency at equal pool bytes (6 prompt + 6 new).
    quant_cap = _admission_capacity(engine, 6, 6)
    fp_cap = _admission_capacity(fp_engine, 6, 6)
    concurrency_x = quant_cap / max(fp_cap, 1)

    # ---- teacher-forced logit drift against the fp oracle.
    drift = _quant_logit_drift(params, cfg)
    drift_ok = drift < QUANT_LOGIT_DRIFT_BOUND

    # ---- kernel against gather over the same int8 pages.
    parity_prompts = [
        np.array([5, 17, 3, 88, 2], np.int32),
        rng.integers(1, 127, size=20).astype(np.int32),
        rng.integers(1, 127, size=41).astype(np.int32),
    ]
    kernel_engine, _, _ = _tiny_engine(n_slots=4, kv_quant=True, paged_impl="kernel",
                                       device=device)
    gather_small, _, _ = _tiny_engine(n_slots=4, kv_quant=True, paged_impl="gather",
                                      device=device)
    kernel_parity_ok = all(gather_small.generate(p, 10) == kernel_engine.generate(p, 10)
                           for p in parity_prompts)

    # ---- the memory pass: the pool tenant carries the PHYSICAL quantized
    # bytes; the capacity multiplier rides the summary.
    _, mem = hbm_budget(engine.plan, serve_pool_bytes=engine.page_pool_bytes,
                        serve_quant_capacity_x=engine.quant_capacity_x)
    analyzer_ok = (abs(mem["serve_pool_gb_per_chip"] * 1e9 - engine.page_pool_bytes) < 1.0
                   and mem["serve_quant_capacity_x"] >= 2.0)

    # ---- batched phase through the int8 engine: zero dropped.
    def mock_prompt(i=None):
        return mock_load_prompt(rng, i)

    engine.generate(mock_prompt(), max_new)   # warm-up
    batcher = ContinuousBatcher(engine, max_queue=max(n_requests, 64), registry=registry)
    results = _run_clients(batcher, [mock_prompt(i) for i in range(n_requests)], max_new)
    states = {s: sum(1 for r in results if r.state is s) for s in RequestState}
    programs = engine.compiled_programs
    snap = registry.snapshot()
    done = states.get(RequestState.DONE, 0)
    ok = (done == n_requests and equal_bytes_ok and concurrency_x >= 2.0 and drift_ok
          and kernel_parity_ok and analyzer_ok and programs == 2)
    line = {
        "selftest": "autodist_tpu_torch.serve.kv_quant",
        "ok": bool(ok),
        "kv_quant": "on",
        "n_requests": n_requests,
        "completed": done,
        "dropped": n_requests - done,
        "pool_bytes": int(engine.page_pool_bytes),
        "fp_pool_bytes": int(fp_pool_bytes),
        "n_pages_quant": engine.pool.n_pages,
        "n_pages_fp": fp_engine.pool.n_pages,
        "quant_capacity_x": round(engine.quant_capacity_x, 2),
        "quant_capacity": quant_cap,
        "fp_capacity": fp_cap,
        "concurrency_x_vs_fp": round(concurrency_x, 2),
        "logit_drift": round(drift, 5),
        "logit_drift_bound": QUANT_LOGIT_DRIFT_BOUND,
        "kernel_vs_gather_bit_equal": bool(kernel_parity_ok),
        "analyzer_prices_quant": bool(analyzer_ok),
        "programs_compiled": programs,
        "quant_pool_gauge_bytes": float(snap.get("serve_page_pool_physical_bytes", 0.0)),
        "page_len": engine.page_len,
        "paged_impl": _decode_impl(engine, cfg),
        "fp_paged_impl": _decode_impl(fp_engine, cfg),
        "kernel_engine_impl": "kernel",
        "gather_engine_impl": "gather",
        "device": engine.device.type,
    }
    print(json.dumps(line), flush=True)
    if not ok:
        logging.warning(
            "kv-quant selftest failed: states=%s equal_bytes=%s concurrency_x=%.2f "
            "drift=%.5f kernel_parity=%s analyzer=%s programs=%d",
            {s.value: n for s, n in states.items() if n}, equal_bytes_ok, concurrency_x,
            drift, kernel_parity_ok, analyzer_ok, programs)
    return 0 if ok else 1
