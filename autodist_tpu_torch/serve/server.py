"""Asyncio HTTP front end over the continuous batcher (PyTorch port).

Ports ``ServeFrontend`` of the JAX package's ``serve/server.py``: a
dependency-free HTTP/1.1 listener on ``asyncio.start_server`` that bridges
requests onto the batcher's scheduler thread (completion callbacks resolve
asyncio futures via ``call_soon_threadsafe`` — the event loop never touches
the device). Routes:

- ``POST /generate`` ``{"tokens": [...], "max_new_tokens": N,
  "timeout_s": T?, "temperature": t?, "top_k": k?, "top_p": p?, "seed": s?,
  "request_id": id?}`` → ``{"tokens": [...], "state": "done"}``; 429 on
  backpressure, 400 on an unservable request or sampling params this port
  cannot serve (typed ``invalid_sampling_params`` /
  ``stochastic_sampling_not_ported``).
- ``GET /metrics`` → the metrics registry as OpenMetrics text.
- ``GET /healthz`` → readiness + queue/slot gauges + page-pool utilization
  as JSON; 503 while draining.
- ``POST /drain`` → graceful drain, reports ``{"drained": n, "preempted": n}``.
"""
from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, Optional

from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.serve.batcher import (
    Backpressure,
    ContinuousBatcher,
    RequestState,
)
from autodist_tpu_torch.serve.sampling import (
    InvalidSamplingParams,
    SamplingParams,
    StochasticSamplingNotPorted,
)
from autodist_tpu_torch.utils import logging


async def async_generate(batcher: ContinuousBatcher, tokens,
                         max_new_tokens: int = 32,
                         timeout_s: Optional[float] = None,
                         request_id: Optional[str] = None,
                         sampling: Optional[SamplingParams] = None):
    """Submit + await one request from the event loop."""
    loop = asyncio.get_running_loop()
    fut: asyncio.Future = loop.create_future()
    req = batcher.submit(tokens, max_new_tokens, timeout_s=timeout_s,
                         request_id=request_id, sampling=sampling)
    req.add_done_callback(
        lambda r: loop.call_soon_threadsafe(
            lambda: fut.done() or fut.set_result(r)))
    return await fut


def parse_sampling(payload: Dict[str, Any]) -> Optional[SamplingParams]:
    """One request's sampling params from the body fields
    (``temperature`` / ``top_k`` / ``top_p`` / ``seed``); None (greedy) when
    the body names none. Raises :class:`InvalidSamplingParams` on
    out-of-range or non-numeric values."""
    fields = {k: payload[k] for k in ("temperature", "top_k", "top_p", "seed")
              if k in payload}
    if not fields:
        return None
    doc = SamplingParams().to_dict()
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


class ServeFrontend:
    """Minimal HTTP server over one batcher."""

    def __init__(self, batcher: ContinuousBatcher, host: str = "127.0.0.1",
                 port: int = 8476, registry: Optional[M.MetricsRegistry] = None):
        self.batcher = batcher
        self.host, self.port = host, port
        self.registry = registry or batcher._registry
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> "ServeFrontend":
        self.batcher.start()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        addr = self._server.sockets[0].getsockname()
        self.port = addr[1]
        logging.info("serve frontend listening on %s:%d", *addr[:2])
        return self

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
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
            elif method == "GET" and path == "/healthz":
                self._healthz(writer)
            elif method == "POST" and path == "/drain":
                finished, leftovers = await asyncio.to_thread(self.batcher.drain)
                self._respond(writer, 200, {"drained": finished,
                                            "preempted": len(leftovers)})
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

    def _healthz(self, writer) -> None:
        """Readiness probe: 200 when serving, 503 while draining/stopped."""
        b = self.batcher
        ready = not (b.draining or b.stopped)
        doc = {
            "state": "ready" if ready else "draining",
            "ok": ready,
            "outstanding": b.outstanding,
            "queue_depth": b.queue_depth,
            "active_slots": b.engine.active_slots,
            "page_pool_utilization": round(float(b.engine.page_utilization), 4),
        }
        self._respond(writer, 200 if ready else 503, doc)

    async def _generate(self, writer, body: bytes) -> None:
        try:
            payload = json.loads(body.decode() or "{}")
            tokens = payload["tokens"]
            max_new = int(payload.get("max_new_tokens", 32))
            sampling = parse_sampling(payload)
            req = await async_generate(
                self.batcher, tokens, max_new,
                timeout_s=payload.get("timeout_s"),
                request_id=payload.get("request_id") or None,
                sampling=sampling)
        except InvalidSamplingParams as e:
            kind = ("stochastic_sampling_not_ported"
                    if isinstance(e, StochasticSamplingNotPorted)
                    else "invalid_sampling_params")
            self._respond(writer, 400, {"error": str(e), "type": kind})
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
