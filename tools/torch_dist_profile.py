#!/usr/bin/env python3
"""What the distributed step costs over the plain step, on one card.

    python3 tools/torch_dist_profile.py [--model bert_base|resnet]
        [--strategy AllReduce|Zero1|PartitionedPS|...] [--bucket-mib 25]
        [--steps 10] [--pairs 3] [--out FILE]

Forms a one-rank NCCL group in this process (``file://`` rendezvous in a
temporary directory) and builds the same model and strategy twice, from
the same seeded params: the distributed step through
``AutoDist(init_method=..., world_size=1, rank=0).build`` (every gradient
and the loss through NCCL, buckets flattened and copied), and the
one-process step (``GraphTransformer`` on a mesh without a group: no
collective). bert_base runs at seq 512, flash, batch 32; ResNet-50 at 224
px, batch 128; Adam at 1e-4 for both. After two warm-up steps each, the
two alternate in windows of ``--steps`` steps (plain, dist, dist, plain,
``--pairs`` times) on the host clock around work ending in a synchronize,
then one window of each under ``torch.profiler``: device busy ms a step
(the kernels' summed durations), NCCL kernel ms, the kernels a step, and
the kernels and host operators (self time) whose ms a step grew most from
the plain step's.

Prints one JSON line (and writes it to ``--out``, default
``profile_out/torch_dist_profile.json``), then the card's name and power
limit. Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from autodist_tpu_torch.api import AutoDist  # noqa: E402
from autodist_tpu_torch.kernel import DistributedTrainStep, GraphTransformer  # noqa: E402
from autodist_tpu_torch.kernel import build_mesh  # noqa: E402
from autodist_tpu_torch.model_item import ModelItem, OptimizerSpec  # noqa: E402
from autodist_tpu_torch.models import get_model_spec  # noqa: E402
from autodist_tpu_torch.resource_spec import ResourceSpec  # noqa: E402
from autodist_tpu_torch.runtime import process_group as pg  # noqa: E402
from autodist_tpu_torch.strategy import StrategyCompiler, from_name  # noqa: E402

OPT = OptimizerSpec("adam", {"learning_rate": 1e-4})


def _plain_step(builder, loss_fn, params, batch, dev):
    item = ModelItem.from_params(params, optimizer_spec=OPT, loss_fn=loss_fn,
                                 example_batch=batch)
    spec = ResourceSpec.from_local_devices(dev)
    strategy = StrategyCompiler(item).compile(builder.build(item, spec))
    plan = GraphTransformer(strategy, item, build_mesh(spec, device=dev)).transform()
    return DistributedTrainStep(plan, loss_fn, OPT.make())


def _window(step, state, batch, steps):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    return state, (time.perf_counter() - t0) * 1e3 / steps


def _profiled(step, state, batch, steps):
    """A profiled window: device busy ms a step, NCCL kernel ms, kernels a
    step, device ms by kernel name and host ms by operator (self time)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = _window(step, state, batch, steps)
    by_kernel = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not by_kernel:
        return state, {"device_busy_ms": "not measured"}
    kernels = sum(1 for e in prof.events()
                  if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    host = {a.key: a.self_cpu_time_total for a in prof.key_averages()}
    return state, {
        "device_busy_ms": sum(by_kernel.values()) / 1e3 / steps,
        "nccl_ms": sum(t for n, t in by_kernel.items() if "nccl" in n.lower()) / 1e3 / steps,
        "kernels_per_step": kernels / steps,
        "_kernel_ms": {n: t / 1e3 / steps for n, t in by_kernel.items()},
        "_host_ms": {n: t / 1e3 / steps for n, t in host.items()},
    }


def _top_deltas(plain: dict, dist: dict, count: int = 12) -> dict:
    """The names whose ms a step grew most from the plain step's."""
    delta = {n: dist.get(n, 0.0) - plain.get(n, 0.0) for n in set(plain) | set(dist)}
    return {n[:90]: d for n, d in sorted(delta.items(), key=lambda kv: -kv[1])[:count]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="bert_base", help="bert_base | resnet")
    ap.add_argument("--strategy", default="AllReduce")
    ap.add_argument("--bucket-mib", type=float, default=25.0,
                    help="bucket_bytes in MiB for AllReduce and Zero1 (0: none)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", default=os.path.join("profile_out", "torch_dist_profile.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dist_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    if args.model == "resnet":
        spec, batch_size = get_model_spec("resnet"), 128
    else:
        spec, batch_size = get_model_spec(args.model, max_seq_len=512,
                                          attention_impl="flash"), 32
    kwargs = {}
    if args.strategy in ("AllReduce", "Zero1") and args.bucket_mib:
        kwargs["bucket_bytes"] = int(args.bucket_mib * (1 << 20))
    params = spec.init(0, device=dev)
    batch = spec.example_batch(batch_size, device=dev)
    with tempfile.TemporaryDirectory() as work:
        autodist = AutoDist(strategy_builder=from_name(args.strategy, **kwargs),
                            device="cuda", init_method=f"file://{work}/pg", world_size=1,
                            rank=0)
        dist = autodist.build(spec.loss_fn, params, batch, optimizer=OPT)
        plain = _plain_step(from_name(args.strategy, **kwargs), spec.loss_fn, params,
                            batch, dev)
        states = {}
        for name, step in (("plain", plain), ("dist", dist)):
            states[name], _ = _window(step, step.init(params), batch, 2)   # warm-up
        walls = {"plain": [], "dist": []}
        for _ in range(args.pairs):
            for name in ("plain", "dist", "dist", "plain"):
                step = plain if name == "plain" else dist
                states[name], ms = _window(step, states[name], batch, args.steps)
                walls[name].append(ms)
        device = {}
        for name, step in (("plain", plain), ("dist", dist)):
            states[name], device[name] = _profiled(step, states[name], batch, args.steps)
        deltas = {}
        if "_kernel_ms" in device["plain"] and "_kernel_ms" in device["dist"]:
            for key in ("_kernel_ms", "_host_ms"):
                deltas[key[1:] + "_top_growth"] = _top_deltas(device["plain"].pop(key),
                                                              device["dist"].pop(key))
        row = {
            "model": spec.name, "batch": batch_size, "strategy": args.strategy,
            "strategy_kwargs": kwargs, "world": 1, "steps": args.steps, "pairs": args.pairs,
            "plain_wall_ms": walls["plain"], "dist_wall_ms": walls["dist"],
            "plain_median_ms": statistics.median(walls["plain"]),
            "dist_median_ms": statistics.median(walls["dist"]),
            "dist_minus_plain_ms": statistics.median(walls["dist"])
            - statistics.median(walls["plain"]),
            "collectives": dist.last_collectives,
            "device": device, **deltas, "card": card,
        }
        pg.leave()
    print(json.dumps(row), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as f:
        json.dump(row, f, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
