#!/usr/bin/env python3
"""Measure the port's attention crossovers on one NVIDIA GPU.

    python3 tools/torch_crossover_sweep.py [--out DIR]   # default profile_out/crossover

The counterpart of the JAX package's ``examples/benchmark/flash_crossover.py``
and ``paged_crossover.py``; writes the two tables that
``autodist_tpu_torch/ops/crossover.py`` reads (copy them into
``autodist_tpu_torch/ops/measured/`` to commit them):

- ``flash_crossover.json``: one bert_base train step (d_model 768, 12
  heads, d_ff 3072, 12 layers, non-causal MLM, bf16 compute, SGD) through
  ``AutoDist(strategy_builder=AllReduce()).build`` with ``attention_impl``
  "dot" and "flash", at seq 128, 256, 384, 512, 1024 and 2048, batch
  ``16384 // seq`` (``max_seq_len`` raised to the seq);
- ``paged_crossover.json``: one decode step's paged attention
  (``ops/paged_attention.py::paged_decode_attention``) with the gather and
  the kernel, at batch 8 and 32, 12 heads, head_dim 64, page_len 16, bf16
  pages, full timelines of 16 (one page) to 4096 positions through
  shuffled tables.

Each point is timed by CUDA events around a window of calls, after a
warm-up; the median of 3 windows is kept. Events time the card's stream,
host gaps included where the host cannot keep the card busy, as the eager
step pays them. Every row carries the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them. Prints each row as a JSON line, then the two tables; exits 2 without
CUDA.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from autodist_tpu_torch.api import AutoDist  # noqa: E402
from autodist_tpu_torch.models import get_model_spec  # noqa: E402
from autodist_tpu_torch.ops import _build  # noqa: E402
from autodist_tpu_torch.ops import flash_attention as fa  # noqa: E402
from autodist_tpu_torch.ops import paged_attention as pa  # noqa: E402
from autodist_tpu_torch.strategy import AllReduce  # noqa: E402

FLASH_SEQS = (128, 256, 384, 512, 1024, 2048)
FLASH_TOKENS = 16384
FLASH_WINDOW, PAGED_WINDOW, WINDOWS = 5, 50, 3
PAGED_BATCHES = (8, 32)
PAGED_TABLE_PAGES = (1, 2, 4, 8, 16, 32, 64, 128, 256)
HEADS, HEAD_DIM, PAGE_LEN = 12, 64, 16
SEED = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def window_ms(fn, calls: int) -> float:
    """Median over ``WINDOWS`` CUDA-event timings of ``calls`` calls, in ms a
    call, after one warm-up window."""
    for _ in range(max(2, calls // 5)):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(WINDOWS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    return statistics.median(samples)


def flash_rows(dev, device_name: str, power: str) -> list:
    rows = []
    for seq in FLASH_SEQS:
        batch_size = FLASH_TOKENS // seq
        for impl in ("dot", "flash"):
            spec = get_model_spec("bert_base", max_seq_len=seq, attention_impl=impl)
            params = spec.init(SEED, device=dev)
            batch = spec.example_batch(batch_size, device=dev)
            AutoDist.reset_default()
            step = AutoDist(strategy_builder=AllReduce(), device=dev).build(
                spec.loss_fn, params, batch)
            box = {"state": step.init(params)}

            def one():
                box["state"], _ = step(box["state"], batch)

            ms = window_ms(one, FLASH_WINDOW)
            row = {"seq": seq, "impl": impl, "batch": batch_size,
                   "tokens_per_sec": batch_size * seq / (ms / 1e3), "ms_per_step": ms,
                   "device": device_name, "power_limit": power}
            print(json.dumps({"phase": "flash", **row}), flush=True)
            rows.append(row)
            del step, box, params, batch
            AutoDist.reset_default()
            torch.cuda.empty_cache()
    return rows


def paged_rows(dev, device_name: str, power: str) -> list:
    rows = []
    rng = np.random.default_rng(SEED)
    for b in PAGED_BATCHES:
        for table_pages in PAGED_TABLE_PAGES:
            n_pages = 1 + b * table_pages
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED)
            shape = (n_pages, PAGE_LEN, HEADS, HEAD_DIM)
            k_pages = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            v_pages = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            q = torch.randn((b, HEADS, HEAD_DIM), generator=gen, device=dev
                            ).to(torch.bfloat16)
            perm = rng.permutation(np.arange(1, n_pages)).reshape(b, table_pages)
            tables = torch.from_numpy(perm.astype(np.int32)).to(dev)
            timeline = table_pages * PAGE_LEN
            positions = torch.full((b,), timeline - 1, dtype=torch.int32, device=dev)
            for impl in ("gather", "kernel"):
                def one(impl=impl):
                    pa.paged_decode_attention(q, k_pages, v_pages, tables, positions,
                                              impl=impl)

                ms = window_ms(one, PAGED_WINDOW)
                row = {"batch": b, "table_pages": table_pages, "page_len": PAGE_LEN,
                       "heads": HEADS, "head_dim": HEAD_DIM, "impl": impl,
                       "tokens_per_sec": b / (ms / 1e3), "us_per_step": ms * 1e3,
                       "device": device_name, "power_limit": power}
                print(json.dumps({"phase": "paged", **row}), flush=True)
                rows.append(row)
            del k_pages, v_pages
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join("profile_out", "crossover"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_crossover_sweep: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    device_name, _, power = card.partition(", ")
    print(card, flush=True)
    _build.build(("paged_attention", "flash_attention"))   # one nvcc each, together
    pa.build_kernel()
    fa.build_kernel()
    tables = {
        "flash_crossover.json": {
            "model": {"name": "bert_base", "d_model": 768, "num_heads": 12,
                      "num_layers": 12, "d_ff": 3072, "causal": False,
                      "dtype": "bfloat16"},
            "tokens_per_step": FLASH_TOKENS, "window": FLASH_WINDOW, "windows": WINDOWS,
            "rows": flash_rows(dev, device_name, power)},
        "paged_crossover.json": {
            "page_len": PAGE_LEN, "heads": HEADS, "head_dim": HEAD_DIM,
            "pages": "bfloat16", "window": PAGED_WINDOW, "windows": WINDOWS,
            "rows": paged_rows(dev, device_name, power)},
    }
    os.makedirs(args.out, exist_ok=True)
    for name, table in tables.items():
        with open(os.path.join(args.out, name), "w", encoding="utf-8") as f:
            json.dump(table, f, indent=2)
            f.write("\n")
        print(json.dumps({"table": name, **table}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
