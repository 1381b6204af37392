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
from typing import Any, Dict, Optional, Set

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
