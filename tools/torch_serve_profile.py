#!/usr/bin/env python3
"""Where the time of one serving step goes, for the PyTorch/CUDA port.

    python3 tools/torch_serve_profile.py [--kv-quant] [--steps 20] [--out FILE]
        [--temperature T] [--spec-k K [--draft-layers N]] [--prefix-prompt-len N]

Builds the full-width ``transformer`` (seeded random weights) in the port's
``InferenceEngine`` on the card, fills all 32 decode rows (prompts of 16
tokens), then times and profiles decode steps and prefill chunks. The new
serving paths, each beside the same measurements:

- ``--temperature T``: every request samples (``top_k`` 50, ``top_p`` 0.9,
  its own seed): the counter-based draw in the final prefill chunk and in
  each decode step;
- ``--spec-k K``: the ``SpecDecodeEngine``, its draft the target's own
  weights, or with ``--draft-layers N`` an N-layer draft of its own seeded
  weights; the decode program is then one speculative round (K + 1 draft
  steps and one verify), with the tokens it emits a row;
- ``--prefix-prompt-len N``: a prefix cache and an N-token system prompt:
  the TTFT of a cached admission (the system prompt matched, a 16-token
  suffix prefilled) against a cold one of the same length.

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
from autodist_tpu_torch.serve.sampling import SamplingParams  # noqa: E402
from autodist_tpu_torch.serve.spec import SpecDecodeEngine  # noqa: E402

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
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sample every request at this temperature (0: greedy)")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decode with K draft tokens a round")
    ap.add_argument("--draft-layers", type=int, default=None,
                    help="with --spec-k: an N-layer draft of its own weights "
                         "(default: the target's own weights)")
    ap.add_argument("--prefix-prompt-len", type=int, default=0,
                    help="prefix cache with a system prompt of N tokens")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serve_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    # The positional table covers the system prompt, a suffix and the
    # decode rows' 400 tokens.
    max_seq = 512 if args.prefix_prompt_len + 416 <= 512 else 1024
    cfg = get_model("transformer", kv_quant=args.kv_quant, max_seq_len=max_seq)
    params = tt.init_params(cfg, seed=0, device="cuda")
    kw = dict(n_slots=32, page_len=16, prefill_chunk=16, device="cuda",
              prefix_cache=args.prefix_prompt_len > 0)
    if args.spec_k:
        draft_cfg, draft_params = cfg, params
        if args.draft_layers is not None:
            draft_cfg = get_model("transformer", kv_quant=args.kv_quant,
                                  max_seq_len=max_seq, num_layers=args.draft_layers)
            draft_params = tt.init_params(draft_cfg, seed=1, device="cuda")
        engine = SpecDecodeEngine(params, tt.decode_model(cfg), draft_params,
                                  tt.decode_model(draft_cfg), spec_k=args.spec_k, **kw)
    else:
        engine = InferenceEngine(params, tt.decode_model(cfg), **kw)
    rng = np.random.default_rng(0)
    prompt = rng.integers(1, cfg.vocab_size, size=16)
    n_req = iter(range(1 << 30))

    def sampling():
        if args.temperature <= 0:
            return None
        return SamplingParams(temperature=args.temperature, top_k=50, top_p=0.9,
                              seed=next(n_req))

    def admit(tokens, max_new):
        return engine.admit(tokens, max_new, request_id=f"p{next(n_req)}",
                            sampling=sampling())

    def prefill():
        slot = admit(prompt, 16)
        engine.prefill_step(slot)
        engine.release(slot)

    rows = [_measure("prefill_chunk", prefill, args.steps)]

    def ttft_ms(make_prompt):
        walls = []
        for i in range(args.steps + 3):
            tokens = make_prompt()
            t0 = time.perf_counter()
            slot = admit(tokens, 16)
            while engine.prefill_step(slot) is None:
                pass
            if i >= 3:                                     # 3 warm-up requests
                walls.append((time.perf_counter() - t0) * 1e3)
            engine.release(slot)
        return {"ttft_ms_median": float(np.median(walls)), "ttft_ms_min": min(walls),
                "ttft_ms_max": max(walls)}

    def fresh(n):
        return lambda: rng.integers(1, cfg.vocab_size, size=n)

    rows.append({"program": f"ttft_{TTFT_PROMPT}_tokens_idle",
                 **ttft_ms(fresh(TTFT_PROMPT))})
    print(json.dumps(rows[-1]), flush=True)
    if args.prefix_prompt_len:
        system = rng.integers(1, cfg.vocab_size, size=args.prefix_prompt_len)
        n = args.prefix_prompt_len + 16
        cached = ttft_ms(lambda: np.concatenate([system, fresh(16)()]))
        rows.append({"program": f"ttft_{n}_tokens_prefix", "cold": ttft_ms(fresh(n)),
                     "cached": cached, "prefix_stats": engine.prefix_stats()})
        print(json.dumps(rows[-1]), flush=True)
    for _ in range(32):
        slot = admit(rng.integers(1, cfg.vocab_size, size=16), 400)
        while engine.prefill_step(slot) is None:
            pass
    if args.spec_k:
        emitted = []
        rows.append(_measure(f"spec_round_k{args.spec_k}", lambda: emitted.append(
            sum(len(t) for t in engine.step_many().values())), args.steps))
        rows[-1]["tokens_per_round"] = float(np.mean(emitted)) / 32
        rows[-1]["spec_stats"] = engine.spec_stats()
        print(json.dumps({k: rows[-1][k] for k in ("program", "tokens_per_round")}))
    else:
        rows.append(_measure("decode_step", engine.step, args.steps))
    doc = {"card": card, "kv_quant": args.kv_quant, "temperature": args.temperature,
           "spec_k": args.spec_k, "draft_layers": args.draft_layers,
           "prefix_prompt_len": args.prefix_prompt_len, "rows": rows}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
