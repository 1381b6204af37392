#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — paged-KV greedy serving of the full-width
``transformer`` (vocab 32000, 12 layers, d_model 768, 12 heads, d_ff 3072,
bf16 compute, page_len 16) through ``ContinuousBatcher`` and the HTTP
``ServeFrontend`` — with seeded random weights, once with bf16 KV pages and
once with int8 pages. Phases, each printing one JSON line:

1. ``device``: CUDA must be present; prints the ``nvidia-smi`` name and
   power limit.
2. ``build``: builds ``autodist_tpu_torch/csrc/paged_attention.cu`` with
   nvcc from this checkout.
3. ``kernel_parity``: the CUDA kernel against its plain PyTorch version at
   the main path's shapes (decode B=32 Q=1, prefill B=1 Q=16, verify B=32
   Q=5; H=12, D=64, page_len 16, 32-page shuffled tables, positions that
   reach the last slot), with fp32, bf16 and int8 pages, timed beside the
   plain version, SDPA over the gathered timeline, and the bound.
4. ``serve``: 64 mixed-length requests (max_new 32) per KV mode; every one
   completes, no page leaks, and the kernel's launch count equals
   ``num_layers x (prefill chunks + decode steps)``; then 4 ``POST
   /generate`` and one ``GET /metrics`` over HTTP.
5. ``stream_check``: teacher-forced bf16 logits through the kernel path vs
   the plain path within a stated bound, and identical greedy streams of
   an fp32 2-layer full-width model.

Then the kernel table line, the card line and, last, the result line.
Exits non-zero (printing no result) without CUDA, outside a checkout of the
repo, or when any phase fails.
"""
from __future__ import annotations

import asyncio
import json
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.models import get_model
from autodist_tpu_torch.models import transformer as tt
from autodist_tpu_torch.ops import _build
from autodist_tpu_torch.ops import paged_attention as pa
from autodist_tpu_torch.serve.batcher import ContinuousBatcher, RequestState
from autodist_tpu_torch.serve.engine import InferenceEngine
from autodist_tpu_torch.serve.server import ServeFrontend, mock_load_prompt

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate and per-type rates.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

H, D, PAGE_LEN, P = 12, 64, 16, 32
# bf16 kernel vs a plain version computed in fp32 on the same bf16 values:
# the kernel rounds its fp32 result to bf16 once (relative 2^-9), so 1e-2
# bounds it with room; fp32 inputs differ only in summation order.
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# Teacher-forced max |Δlogit| of the kernel path vs the plain (bf16 gather)
# path at full width: the two round attention to bf16 at different points
# (the kernel once, at its output; the gather path also in its einsums). At
# the random-weight model's |logits| < 4 one bf16 step is at most 2^-6; the
# bound is 8 such steps.
STREAM_LOGIT_BOUND = 0.125
SEED = 0
N_REQUESTS, MAX_NEW = 64, 32


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, groups: int = 15, per_group: int = 20) -> float:
    """Median over ``groups`` CUDA-event timings of ``per_group`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_group):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / per_group)
    return statistics.median(samples)


# ------------------------------------------------------------ kernel parity
def parity_case(shape: str, page_kind: str, gen: torch.Generator, dev):
    b, n_q = {"decode": (32, 1), "prefill": (1, 16), "verify": (32, 5)}[shape]
    qdt = torch.float32 if page_kind == "float32" else torch.bfloat16
    n_pages = b * P + 1
    timeline = P * PAGE_LEN
    q4 = torch.randn((b, n_q, H, D), generator=gen, device=dev).to(qdt)
    k = torch.randn((n_pages, PAGE_LEN, H, D), generator=gen, device=dev)
    v = torch.randn((n_pages, PAGE_LEN, H, D), generator=gen, device=dev)
    ks = vs = None
    if page_kind == "int8":
        k, ks = pa.quantize_kv(k)
        v, vs = pa.quantize_kv(v)
    else:
        k, v = k.to(qdt), v.to(qdt)
    # Shuffled distinct pages per row (page 0 stays scratch).
    tables = (torch.randperm(n_pages - 1, generator=gen, device=dev)[: b * P] + 1)
    tables = tables.reshape(b, P).to(torch.int32).contiguous()
    if shape == "prefill":
        qpos = torch.arange(timeline - n_q, timeline, device=dev)[None]
    else:
        base = torch.randint(0, timeline, (b,), generator=gen, device=dev)
        base[0] = timeline - n_q
        qpos = torch.clamp(base[:, None] + torch.arange(n_q, device=dev)[None],
                           max=timeline - 1)
    qpos = qpos.to(torch.int32).contiguous()

    out = pa.paged_attention(q4, k, v, tables, qpos, ks, vs)
    torch.cuda.synchronize()
    # Reference: the plain version in fp32 on the same (bf16 / int8) values.
    ref = pa.paged_attention_plain(
        q4.float(), k if ks is not None else k.float(),
        v if vs is not None else v.float(), tables, qpos, ks, vs)
    err = (out.float() - ref).abs().max().item()
    tol = TOL[qdt]
    check(torch.allclose(out.float(), ref, atol=tol, rtol=tol),
          f"kernel vs plain {shape}/{page_kind}: max |err| {err} > tol {tol}")

    kernel_ms = time_ms(lambda: pa.paged_attention(q4, k, v, tables, qpos, ks, vs))
    plain_ms = time_ms(lambda: pa.paged_attention_plain(q4, k, v, tables, qpos, ks, vs),
                       groups=7, per_group=5)
    # Library yardstick: SDPA over the gathered (dequantised) timeline.
    kg = pa._gather_timeline(k, ks, tables, qdt).transpose(1, 2).contiguous()
    vg = pa._gather_timeline(v, vs, tables, qdt).transpose(1, 2).contiguous()
    mask = pa.position_mask(timeline, qpos)[:, None]          # [B, 1, Q, T]
    qh = q4.transpose(1, 2).contiguous()
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kg, vg,
                                                                attn_mask=mask))
    nbytes = pa.kernel_bytes(q4, k, tables, qpos, quantized=ks is not None)
    flops = pa.kernel_flops(q4, k, tables, qpos)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[qdt]
    row = dict(shape=shape, pages=page_kind, B=b, Q=n_q, H=H, D=D,
               page_len=PAGE_LEN, P=P, max_abs_err=err, tol=tol,
               kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    emit("kernel_parity", **row)
    return row


# -------------------------------------------------------------------- serve
async def _http(port: int, method: str, path: str, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode() if body is not None else b""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: localhost\r\n"
                 f"Content-Length: {len(data)}\r\n\r\n".encode() + data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, payload = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), payload.decode()


async def _frontend_round(batcher, prompts):
    fe = await ServeFrontend(batcher, host="127.0.0.1", port=0).start()
    try:
        gens = await asyncio.gather(*(
            _http(fe.port, "POST", "/generate",
                  {"tokens": [int(t) for t in p], "max_new_tokens": 8})
            for p in prompts))
        metrics = await _http(fe.port, "GET", "/metrics")
    finally:
        await fe.close()
    return gens, metrics


def serve_run(params, kv_quant: bool, dev):
    cfg = get_model("transformer", kv_quant=kv_quant)
    engine = InferenceEngine(params, tt.decode_model(cfg), n_slots=32,
                             page_len=PAGE_LEN, prefill_chunk=PAGE_LEN, device=dev)
    engine.generate([1, 2, 3], 2)                        # warm-up, not counted
    torch.cuda.synchronize()
    registry = M.MetricsRegistry()
    rng = np.random.default_rng(SEED)
    prompts = [mock_load_prompt(rng, i, vocab=cfg.vocab_size)
               for i in range(N_REQUESTS)]

    # The main path's window: counts to 0 just before, read just after.
    pa.paged_attention.launches = 0
    engine.decode_invocations = engine.prefill_invocations = 0
    batcher = ContinuousBatcher(engine, max_queue=256, registry=registry)
    reqs = [batcher.submit(p, MAX_NEW) for p in prompts]
    t0 = time.perf_counter()
    batcher.start()
    for r in reqs:
        r.wait(timeout=600)
    wall = time.perf_counter() - t0
    batcher.stop()
    snap = registry.snapshot()
    states = [r.state for r in reqs]
    check(all(s is RequestState.DONE for s in states),
          f"kv_quant={kv_quant}: states {[s.value for s in states]}")
    check(all(len(r.tokens) == MAX_NEW for r in reqs), "short token streams")
    check(snap["serve_requests_rejected_total"] == 0, "requests rejected")
    gens, metrics = asyncio.run(_frontend_round(
        ContinuousBatcher(engine, registry=registry), prompts[:4]))
    launches = pa.paged_attention.launches
    programs = engine.prefill_invocations + engine.decode_invocations
    torch.cuda.synchronize()

    check(all(code == 200 for code, _ in gens) and metrics[0] == 200,
          f"HTTP codes {[c for c, _ in gens]} /metrics {metrics[0]}")
    check(all(len(json.loads(body)["tokens"]) == 8 for _, body in gens),
          "HTTP streams short")
    check(engine.pool.used_pages == 0
          and engine.pool.free_pages == engine.pool.usable_pages, "page leak")
    check(launches == cfg.num_layers * programs,
          f"launches {launches} != {cfg.num_layers} x {programs} programs")
    gen_tokens = sum(len(r.tokens) for r in reqs)
    decode_tokens = gen_tokens - len(reqs)
    row = dict(kv_quant=kv_quant, requests=len(reqs), completed=len(reqs),
               n_pages=engine.pool.n_pages, wall_s=wall,
               tokens_per_s=gen_tokens / wall,
               decode_tokens=decode_tokens,
               decode_tokens_per_s_gauge=snap["serve_decode_tokens_per_sec"],
               ttft_p50_s=snap["serve_ttft_s"]["p50"],
               ttft_p99_s=snap["serve_ttft_s"]["p99"],
               itl_p50_s=snap["serve_itl_s"]["p50"],
               latency_p50_s=snap["serve_request_latency_s"]["p50"],
               prefill_chunks=engine.prefill_invocations,
               decode_steps=engine.decode_invocations,
               kernel_launches=launches,
               http_generate=[c for c, _ in gens], http_metrics=metrics[0],
               peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    emit("serve", **row)
    return row


# ------------------------------------------------------------- stream check
def stream_check(params, dev):
    cfg = get_model("transformer")
    paths = {"kernel": replace(cfg, paged_attention_impl="kernel"),
             "gather": replace(cfg, paged_attention_impl="gather")}
    b, plen, steps = 8, 24, 16
    n_pages = 1 + b * 4
    tables = (torch.arange(1, n_pages, device=dev).reshape(b, 4)
              .to(torch.int32).contiguous())
    rng = np.random.default_rng(SEED + 1)
    prompts = torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(b, plen))
                               ).to(dev, torch.int32)
    caches = {m: tt.init_paged_kv_cache(c, n_pages, PAGE_LEN, device=dev)
              for m, c in paths.items()}
    first = {}
    with torch.no_grad():
        for m, c in paths.items():
            toks = []
            for row in range(b):
                for start in range(0, plen, PAGE_LEN):
                    chunk = torch.zeros((1, PAGE_LEN), dtype=torch.int32, device=dev)
                    part = prompts[row, start:start + PAGE_LEN]
                    chunk[0, :part.numel()] = part
                    t, caches[m] = tt.forward_paged_prefill_chunk(
                        params, chunk, start, plen, caches[m], tables[row], c)
                toks.append(int(t[0]))
            first[m] = toks
        tok = torch.tensor(first["kernel"], dtype=torch.int32, device=dev)
        pos = torch.full((b,), plen, dtype=torch.int32, device=dev)
        drift, agree = 0.0, 0
        for _ in range(steps):
            out = {m: tt.forward_paged_decode_step(params, tok, pos, caches[m],
                                                   tables, c, return_logits=True)
                   for m, c in paths.items()}
            drift = max(drift, (out["kernel"][1] - out["gather"][1]).abs().max().item())
            agree += int((out["kernel"][0] == out["gather"][0]).sum())
            tok, pos = out["kernel"][0], pos + 1         # teacher-forced
    check(drift <= STREAM_LOGIT_BOUND,
          f"bf16 kernel-vs-plain logit drift {drift} > {STREAM_LOGIT_BOUND}")

    # fp32, full width, 2 layers: kernel and plain greedy streams identical.
    f32 = get_model("transformer", num_layers=2, dtype="float32")
    p32 = tt.init_params(f32, seed=SEED + 2, device=dev)
    streams = {}
    for m in ("kernel", "gather"):
        eng = InferenceEngine(p32, tt.decode_model(replace(f32, paged_attention_impl=m)),
                              n_slots=4, page_len=PAGE_LEN, n_pages=64, device=dev)
        rng = np.random.default_rng(SEED + 3)
        streams[m] = [eng.generate(mock_load_prompt(rng, i, vocab=f32.vocab_size), 24)
                      for i in range(8)]
    same = streams["kernel"] == streams["gather"]
    check(same, "fp32 kernel and plain greedy streams differ")
    emit("stream_check", bf16_max_abs_logit_diff=drift, bound=STREAM_LOGIT_BOUND,
         bf16_token_agreement=agree / (b * steps), fp32_streams_identical=same,
         fp32_streams=len(streams["kernel"]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    pa.build_kernel()
    ptxas = [ln.strip() for ln in _build.build_logs.get("paged_attention", "").splitlines()
             if "registers" in ln or "smem" in ln]
    emit("build", seconds=time.perf_counter() - t0,
         nvcc_seconds=_build.build_seconds.get("paged_attention"), ptxas=ptxas[:12])

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = [parity_case(shape, kind, gen, dev)
            for shape in ("decode", "prefill", "verify")
            for kind in ("bfloat16", "int8", "float32")]

    params = tt.init_params(get_model("transformer"), seed=SEED, device=dev)
    serve_rows = [serve_run(params, kv_quant, dev) for kv_quant in (False, True)]
    stream_check(params, dev)

    main_row = rows[0]                  # decode, bf16 pages: the serving hot shape
    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "autodist_tpu_torch/csrc/paged_attention.cu",
        "replaces": "autodist_tpu/ops/paged_attention.py:137",
        "launches": sum(r["kernel_launches"] for r in serve_rows),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
