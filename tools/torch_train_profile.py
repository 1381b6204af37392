#!/usr/bin/env python3
"""Where the time of one training step goes, for the PyTorch/CUDA port.

    python3 tools/torch_train_profile.py [--model bert_base] [--batch 32]
        [--attention flash] [--steps 5] [--out FILE]
    python3 tools/torch_train_profile.py --model resnet [--batch 128]
    python3 tools/torch_train_profile.py --model inception|densenet|vgg|lstm_lm|ncf|
        moe_transformer|mlp [--batch N]

Builds the zoo model (a transformer at seq 512; the others at the published
widths of the JAX package's ``examples/benchmark/train.py``, the port's
``models.PUBLISHED``: ResNet-50, DenseNet-121 and VGG-16 at 224 px,
Inception-v3 at 299 px, the LM1B LSTM, NCF and the MoE transformer at their
defaults; any other zoo model at its defaults, batch 4096; seeded random
weights)
through ``AutoDist(strategy_builder=AllReduce()).build`` on the card, runs
two warm-up steps, then times ``step.run`` and profiles the same window:

- host wall per step (host clock around work ending in a synchronize);
- device busy time per step: the sum of the CUDA kernels' durations from
  ``torch.profiler``, and the busy share of the wall;
- device time by group: the port's kernels (flash attention, the fused
  1x1-conv + BatchNorm-statistics kernel), cuDNN convolutions, matrix
  products (cuBLAS / CUTLASS kernels), elementwise and reduction kernels
  (BatchNorm, ReLU, casts, the optimizer), and everything else; the top
  kernels;
- the top host operators by their own CPU time per step, and the host's
  own speed before and after the window (``host_probe``: microseconds per
  call of a small CPU-only PyTorch op, which no kernel change moves), so
  that runs whose host wall differs can be told apart from runs on a
  slower or busier host.

Prints one JSON line and writes the full table to ``--out`` (default
``profile_out/torch_train_profile.json``). Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from autodist_tpu_torch.api import AutoDist  # noqa: E402
from autodist_tpu_torch.models import PUBLISHED, get_model_spec  # noqa: E402
from autodist_tpu_torch.strategy import AllReduce  # noqa: E402

_GEMM_MARKERS = ("gemm", "xmma", "cutlass", "cublas", "nvjet", "sm90_")
_CONV_MARKERS = ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit")
_ELEMENTWISE_MARKERS = ("elementwise", "reduce", "batch_norm", "vectorized", "unrolled",
                        "copy", "fill")


def _group(name: str) -> str:
    low = name.lower()
    if "flash_" in low:
        return "flash_attention"
    if "conv_stats" in low or "sum_partials" in low:
        return "fused_conv_stats"
    if any(m in low for m in _CONV_MARKERS):
        return "conv"
    if any(m in low for m in _GEMM_MARKERS):
        return "matmul"
    if any(m in low for m in _ELEMENTWISE_MARKERS):
        return "elementwise"
    return "other"


# The transformers take --seq and --attention; every other --model (a zoo
# name) its published (overrides, batch, the rate's unit), else
# ({}, 4096, "examples").
TRANSFORMERS = ("transformer", "bert_base", "bert_large")
BY_ZOO = {zoo: (overrides, batch, unit) for zoo, overrides, batch, unit in PUBLISHED.values()}


def host_probe(calls: int = 20000) -> float:
    """Microseconds per ``add_`` on a small CPU tensor: the host's dispatch
    speed at this moment, the same for every version of the port."""
    x = torch.zeros(8)
    t0 = time.perf_counter()
    for _ in range(calls):
        x.add_(1.0)
    return (time.perf_counter() - t0) * 1e6 / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="bert_base")
    ap.add_argument("--batch", type=int, default=None,
                    help="default 32 (transformers), 128 (resnet)")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--attention", default="flash", help="flash | dot")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join("profile_out",
                                                  "torch_train_profile.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    zoo = args.model not in TRANSFORMERS
    if zoo:
        overrides, default_batch, unit = BY_ZOO.get(args.model, ({}, 4096, "examples"))
        spec = get_model_spec(args.model, **overrides)
        args.batch = args.batch or default_batch
    else:
        spec = get_model_spec(args.model, max_seq_len=args.seq,
                              attention_impl=args.attention)
        args.batch = args.batch or 32
        unit = "tokens"
    params = spec.init(0, device="cuda")
    batch = spec.example_batch(args.batch, device="cuda")
    # Tokens a sequence: the positions the loss predicts (the LSTM and the
    # MoE shift their inputs by one; the transformers shift their logits).
    per_example = 1
    if unit == "tokens":
        per_example = batch["tokens"].shape[1] - 1 if zoo else args.seq
    step = AutoDist(strategy_builder=AllReduce()).build(
        spec.loss_fn, params, batch, sparse_names=spec.sparse_names,
        expert_names=spec.expert_names)
    state, _ = step.run(step.init(params), batch, 2)          # warm-up
    torch.cuda.synchronize()
    probe_before = host_probe()
    t0 = time.perf_counter()
    state, _ = step.run(state, batch, args.steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step.run(state, batch, args.steps)
        torch.cuda.synchronize()
    probe_after = host_probe()
    kernels = {}
    for e in prof.events():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        tot, n = kernels.get(e.name, (0.0, 0))
        kernels[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(t for t, _ in kernels.values()) / 1e3 / args.steps
    groups = {}
    for name, (t, _) in kernels.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + t / 1e3 / args.steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    row = {
        "model": spec.name, "batch": args.batch, "steps": args.steps,
        **({} if zoo else {"seq": args.seq, "attention_impl": args.attention}),
        "host_wall_ms": wall_ms,
        f"{unit}_per_s": args.batch * per_example / wall_ms * 1e3,
        "mfu": (spec.flops_per_example * args.batch / (wall_ms / 1e3) / 989e12
                if spec.flops_per_example else None),
        "device_busy_ms": busy_ms if kernels else "not measured",
        "device_busy_share": busy_ms / wall_ms if kernels else "not measured",
        "device_ms_by_group": groups if kernels else "not measured",
        "kernels_per_step": sum(n for _, n in kernels.values()) / args.steps,
        "top_kernels_ms_per_step": {n[:90]: t / 1e3 / args.steps for n, (t, _) in top},
        "host_probe_us": [probe_before, probe_after],
        "top_host_ops_ms_per_step": {
            a.key[:80]: a.self_cpu_time_total / 1e3 / args.steps
            for a in sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:15]},
        "card": card,
    }
    print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(row, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
