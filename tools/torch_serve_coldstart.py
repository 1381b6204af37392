#!/usr/bin/env python3
"""Where a fresh serving process's first request spends its time, on the card.

    python3 tools/torch_serve_coldstart.py [--profile]

A new process (as a restarted replica is) times each stage of getting the
full-width ``transformer`` (bf16, 32 slots, page_len 16) to its first token:
the CUDA context, loading the paged-attention library, the first bf16
matmul, the seeded parameters, the engine, then the first and second
prefill chunks and decode steps (host clock, each ending in a synchronize).
``--profile`` adds a ``torch.profiler`` table of the first prefill chunk's
top operators by host time. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

T_START = time.perf_counter()

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from autodist_tpu_torch.models import get_model  # noqa: E402
from autodist_tpu_torch.models import transformer as tt  # noqa: E402
from autodist_tpu_torch.ops import paged_attention as pa  # noqa: E402
from autodist_tpu_torch.serve.engine import InferenceEngine  # noqa: E402

T_IMPORTED = time.perf_counter()


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--profile", action="store_true",
                    help="profile the first prefill chunk's operators")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_coldstart: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    row = {"import_s": T_IMPORTED - T_START}
    t0 = time.perf_counter()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    row["cuda_context_s"] = time.perf_counter() - t0
    row["paged_library_load_s"] = _timed(pa.build_kernel)[1]
    a = torch.randn(32, 768, device=dev, dtype=torch.bfloat16)
    b = torch.randn(768, 3072, device=dev, dtype=torch.bfloat16)
    row["first_matmul_s"] = _timed(lambda: a @ b)[1]
    row["second_matmul_s"] = _timed(lambda: a @ b)[1]
    cfg = get_model("transformer")
    params, row["init_params_s"] = _timed(lambda: tt.init_params(cfg, seed=0, device=dev))
    engine, row["engine_s"] = _timed(lambda: InferenceEngine(
        params, tt.decode_model(cfg), n_slots=32, page_len=16, prefill_chunk=16, device=dev))
    rng = np.random.default_rng(0)
    slots = [engine.admit(rng.integers(1, cfg.vocab_size, size=12), 8) for _ in range(2)]
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            row["first_prefill_chunk_s"] = _timed(lambda: engine.prefill_step(slots[0]))[1]
        row["first_prefill_top_ops"] = [
            {"name": e.key, "cpu_ms": e.self_cpu_time_total / 1e3, "calls": e.count}
            for e in sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:12]]
    else:
        row["first_prefill_chunk_s"] = _timed(lambda: engine.prefill_step(slots[0]))[1]
    row["second_prefill_chunk_s"] = _timed(lambda: engine.prefill_step(slots[1]))[1]
    row["first_decode_step_s"] = _timed(engine.step)[1]
    row["second_decode_step_s"] = _timed(engine.step)[1]
    row["paged_launches"] = pa.paged_attention.launches
    row["card"] = card
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
