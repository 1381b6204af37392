#!/usr/bin/env python3
"""Where the time of one serving step goes, for the PyTorch/CUDA port.

    python3 tools/torch_serve_profile.py [--kv-quant] [--steps 20] [--out FILE]

Builds the full-width ``transformer`` (seeded random weights) in the port's
``InferenceEngine`` on the card, fills all 32 decode rows (prompts of 16
tokens), then times and profiles decode steps and prefill chunks:

- host wall per step (host clock around each call, ending in a
  synchronize): the mean and the median over ``--steps`` calls;
- time to first token of one request of TTFT_PROMPT tokens (three prefill
  chunks) on an otherwise idle engine, admission to first token, median
  and range over ``--steps`` requests;
- device busy time per step: the sum of the CUDA kernels' durations from
  ``torch.profiler`` over the same steps, and the busy share of the wall;
- the top kernels by device time, and the paged-attention kernels' share
  (its split walk and its merge);
- the top host operators by their own CPU time.

Prints one JSON line per program (prefill, TTFT, decode) and writes the full
tables to ``--out`` (default ``profile_out/torch_serve_profile.json``).
Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from autodist_tpu_torch.models import get_model  # noqa: E402
from autodist_tpu_torch.models import transformer as tt  # noqa: E402
from autodist_tpu_torch.serve.engine import InferenceEngine  # noqa: E402

#: Prompt tokens of the TTFT request: the longest prompt of chip_smoke.py's
#: serve phase, three chunks of 16.
TTFT_PROMPT = 44


def _kernel_times(prof):
    """{kernel name: (total device us, calls)} from the profiler's events."""
    out = {}
    for e in prof.events():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        name = e.name
        tot, n = out.get(name, (0.0, 0))
        out[name] = (tot + us, n + 1)
    return out


def _measure(label, fn, steps, attn_name="paged_"):   # paged_{split,merge}_kernel
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sum(walls) / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels = _kernel_times(prof)
    busy_us = sum(t for t, _ in kernels.values()) / steps
    attn_us = sum(t for name, (t, _) in kernels.items() if attn_name in name) / steps
    launches = sum(n for _, n in kernels.values()) / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    host_ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:12]
    row = {
        "program": label,
        "host_wall_ms": wall_ms,
        "host_wall_ms_median": float(np.median(walls)),
        "device_busy_ms": busy_us / 1e3 if kernels else "not measured",
        "device_busy_share": (busy_us / 1e3) / wall_ms if kernels else "not measured",
        "paged_attention_ms": attn_us / 1e3 if kernels else "not measured",
        "kernels_per_step": launches,
        "top_kernels_ms_per_step": {n[:80]: t / 1e3 / steps for n, (t, _) in top},
        "top_host_ops_ms_per_step": {a.key[:80]: a.self_cpu_time_total / 1e3 / steps
                                     for a in host_ops},
    }
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join("profile_out",
                                                  "torch_serve_profile.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = get_model("transformer", kv_quant=args.kv_quant)
    params = tt.init_params(cfg, seed=0, device="cuda")
    engine = InferenceEngine(params, tt.decode_model(cfg), n_slots=32,
                             page_len=16, prefill_chunk=16, device="cuda")
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, cfg.vocab_size, size=16)

    def prefill():
        slot = engine.admit(prompt, 16)
        engine.prefill_step(slot)
        engine.release(slot)

    rows = [_measure("prefill_chunk", prefill, args.steps)]
    ttft = []
    for i in range(args.steps + 3):
        t0 = time.perf_counter()
        slot = engine.admit(rng.integers(1, cfg.vocab_size, size=TTFT_PROMPT), 16)
        while engine.prefill_step(slot) is None:
            pass
        if i >= 3:                                         # 3 warm-up requests
            ttft.append((time.perf_counter() - t0) * 1e3)
        engine.release(slot)
    rows.append({"program": f"ttft_{TTFT_PROMPT}_tokens_idle",
                 "ttft_ms_median": float(np.median(ttft)),
                 "ttft_ms_min": min(ttft), "ttft_ms_max": max(ttft)})
    print(json.dumps(rows[-1]), flush=True)
    for _ in range(32):
        slot = engine.admit(rng.integers(1, cfg.vocab_size, size=16), 400)
        while engine.prefill_step(slot) is None:
            pass
    rows.append(_measure("decode_step", engine.step, args.steps))
    doc = {"card": card, "kv_quant": args.kv_quant, "rows": rows}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
