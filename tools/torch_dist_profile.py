#!/usr/bin/env python3
"""What the distributed step costs over the plain step, on one card.

    python3 tools/torch_dist_profile.py [--model bert_base|resnet]
        [--strategy AllReduce|Zero1|PartitionedPS|...] [--bucket-mib 25]
        [--compressor NAME | --staleness K | --host-offload | --async-workers W]
        [--steps 10] [--pairs 3] [--out FILE]

Forms a one-rank NCCL group in this process (``file://`` rendezvous in a
temporary directory) and builds two steps of the same model from the same
seeded params, then times them in turn in windows of ``--steps`` steps
(plain, dist, dist, plain, ``--pairs`` times) on the host clock around
work ending in a synchronize, after two warm-up steps each, and profiles
one window of each under ``torch.profiler``: device busy ms a step (the
kernels' summed durations), NCCL kernel ms, the kernels a step, and the
kernels and host operators (self time) whose ms a step grew most.
bert_base runs at seq 512, flash, batch 32; ResNet-50 at 224 px, batch 128;
Adam at 1e-4 for both.

- Without an option: ``--strategy`` through ``AutoDist(init_method=...,
  world_size=1, rank=0).build`` (every gradient and the loss through NCCL,
  buckets flattened and copied) against the one-process step
  (``GraphTransformer`` on a mesh without a group: no collective).
- ``--compressor NAME``: ``AllReduce(compressor=NAME)`` against
  ``AllReduce()``, both through NCCL and without buckets. Also: the
  compressors' ``step`` over one step's local gradients against the plain
  mean all-reduce of the same gradients (ms, CUDA-synchronized, median of
  ``--pairs`` x 2), and the gradient wire's bytes a step by kind against the
  compressors' payload shapes and ``wire_factor``'s prediction.
- ``--staleness K``: ``PS(staleness=K)`` against ``PS()``.
- ``--host-offload``: ``PS()`` built with ``host_offload=True`` against the
  resident ``PS()``: also the bytes the step copies (host to device and
  back), each state's bytes on the card and the host between steps, and
  each step's own peak (``torch.cuda.max_memory_allocated`` over its
  windows less the other step's state on the card).
- ``--async-workers W``: ``PS(sync=False)`` with W workers on this card
  (``round_robin`` and ``threads``, ``--steps`` pushes a window) against
  ``PS()``'s step: ms a push against ms a step.

At world size 1 the NCCL collectives are local: these figures are what an
option costs, not what it saves on a wire. Prints one JSON line (and
writes it to ``--out``, default ``profile_out/torch_dist_profile.json``),
then the card's name and power limit. Needs an NVIDIA GPU.
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
from autodist_tpu_torch.models.convert import flatten_params  # noqa: E402
from autodist_tpu_torch.resource_spec import ResourceSpec  # noqa: E402
from autodist_tpu_torch.runtime import process_group as pg  # noqa: E402
from autodist_tpu_torch.runtime.async_ps import AsyncPSTrainer  # noqa: E402
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


def _state_bytes(state) -> dict:
    """Bytes of a train state's params and optimizer slots on the card and
    on the host."""
    out = {"card": 0, "host": 0}
    leaves = list(flatten_params(state.params).values())
    for value in state.opt_state.values():
        if isinstance(value, list):
            for slot in value:
                leaves += list(slot.values()) if isinstance(slot, dict) else [slot]
    for t in leaves:
        out["card" if t.is_cuda else "host"] += t.numel() * t.element_size()
    return out


def _autodist_step(builder, spec, params, batch, work, **kwargs):
    AutoDist.reset_default()
    autodist = AutoDist(strategy_builder=builder, device="cuda",
                        init_method=f"file://{work}/pg", world_size=1, rank=0)
    return autodist, autodist.build(spec.loss_fn, params, batch, optimizer=OPT, **kwargs)


def _median_ms(fn, reps: int) -> float:
    """Median wall of ``fn()`` over ``reps`` runs, each ending in a
    synchronize."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _compressor_report(step, state, batch, reps: int) -> dict:
    """The compressors' step over one step's local gradients against the
    plain mean all-reduce of the same ones (state copies, so the step's own
    state is untouched), and one step's gradient wire in bytes by kind
    against the payloads the compressors' shapes give and ``wire_factor``."""
    _, _, grads = step.loss_and_grads(state, batch)
    names = [n for n, _ in step._floating(state.params)]
    grads = dict(zip(names, grads))
    comps = step.compressors
    n = step.coll.size

    def compressed():
        for name, comp in comps.items():
            st = state.comp_state[name]
            comp.step(grads[name], {k: t.clone() for k, t in st["local"].items()},
                      st["shared"], step.coll)

    def plain():
        for name in comps:
            step.coll.all_reduce(grads[name].clone(), "grad", mean=True)

    before = step.coll.bytes_snapshot().get("grad", {})
    state, _ = step(state, batch)
    after = step.coll.bytes_snapshot().get("grad", {})
    measured = {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}
    payload, dense, predicted = {}, 0, 0.0
    for name in names:
        shape, numel = tuple(grads[name].shape), grads[name].numel()
        dense += 4 * numel
        comp = comps.get(name)
        predicted += 4 * numel * (comp.wire_factor(shape, nshards=n) if comp else 1.0)
        kind, nbytes = "all_reduce", 4 * numel
        if comp is not None and comp.name.startswith("Horovod"):
            nbytes = 2 * numel
        elif comp is not None and comp.name == "PowerSGDCompressor" and len(shape) >= 2:
            m_rows, k = shape[0], numel // shape[0]
            nbytes = 4 * (m_rows + k) * min(comp.rank, k, m_rows)
        elif comp is not None and comp.name == "TopKCompressor" and numel >= comp.min_size:
            kind, nbytes = "all_gather", 8 * comp._k(shape) * n
        payload[kind] = payload.get(kind, 0) + nbytes
    return {
        "compressed_vars": len(comps), "vars": len(names),
        "compress_ms": _median_ms(compressed, reps), "plain_all_reduce_ms": _median_ms(plain, reps),
        "wire_bytes_measured": measured, "wire_bytes_from_shapes": payload,
        "dense_fp32_bytes": dense, "wire_factor_bytes": predicted,
        "note": "wire_factor prices an all-gather as the psum payload of equal ring "
                "traffic (4 k n bytes); the gather itself moves 8 k n (values and indices)",
    }


def _async_report(spec, params, batch, workers: int, pushes: int, reps: int) -> dict:
    """ms a push of PS(sync=False) with ``workers`` workers on this card,
    each schedule, median of ``reps`` runs of ``pushes`` pushes."""
    AutoDist.reset_default()
    autodist = AutoDist(strategy_builder=from_name("PS", sync=False), device="cuda",
                        resource_spec=ResourceSpec(resource_dict={"nodes": [
                            {"address": "localhost", "gpus": workers}]}))
    built = autodist.build(spec.loss_fn, params, batch, optimizer=OPT)
    out = {}
    for schedule in ("round_robin", "threads"):
        trainer = AsyncPSTrainer(built.loss_fn, built.tx, built.n_workers,
                                 staleness=built.staleness, schedule=schedule,
                                 has_aux=built.has_aux, device=built.device)
        state = trainer.init(params)
        state, _ = trainer.run(state, lambda tick: batch, workers)          # warm-up
        out[schedule] = _median_ms(lambda: trainer.run(state, lambda tick: batch, pushes),
                                   reps) / pushes
    return {"async_workers": workers, "ms_per_push": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="bert_base", help="bert_base | resnet")
    ap.add_argument("--strategy", default="AllReduce")
    ap.add_argument("--bucket-mib", type=float, default=25.0,
                    help="bucket_bytes in MiB for AllReduce and Zero1 (0: none)")
    option = ap.add_mutually_exclusive_group()
    option.add_argument("--compressor", help="AllReduce(compressor=...) vs AllReduce()")
    option.add_argument("--staleness", type=int, help="PS(staleness=K) vs PS()")
    option.add_argument("--host-offload", action="store_true",
                        help="PS() with host_offload=True vs resident")
    option.add_argument("--async-workers", type=int, help="PS(sync=False) vs PS()")
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
    params = spec.init(0, device=dev)
    batch = spec.example_batch(batch_size, device=dev)
    extra = {}
    with tempfile.TemporaryDirectory() as work:
        if args.compressor:
            path = f"AllReduce(compressor={args.compressor})"
            _, dist = _autodist_step(from_name("AllReduce", compressor=args.compressor),
                                     spec, params, batch, work)
            _, plain = _autodist_step(from_name("AllReduce"), spec, params, batch, work)
        elif args.staleness is not None:
            path = f"PS(staleness={args.staleness})"
            _, dist = _autodist_step(from_name("PS", staleness=args.staleness), spec, params,
                                     batch, work)
            _, plain = _autodist_step(from_name("PS"), spec, params, batch, work)
        elif args.host_offload or args.async_workers:
            path = "PS(), host_offload=True" if args.host_offload else "PS() (async's base)"
            _, dist = _autodist_step(from_name("PS"), spec, params, batch, work,
                                     host_offload=bool(args.host_offload))
            _, plain = _autodist_step(from_name("PS"), spec, params, batch, work)
        else:
            kwargs = {}
            if args.strategy in ("AllReduce", "Zero1") and args.bucket_mib:
                kwargs["bucket_bytes"] = int(args.bucket_mib * (1 << 20))
            path = f"{args.strategy}({kwargs})"
            _, dist = _autodist_step(from_name(args.strategy, **kwargs), spec, params, batch,
                                     work)
            plain = _plain_step(from_name(args.strategy, **kwargs), spec.loss_fn, params,
                                batch, dev)
        states, walls, peaks = {}, {"plain": [], "dist": []}, {}
        for name, step in (("plain", plain), ("dist", dist)):
            states[name], _ = _window(step, step.init(params), batch, 2)   # warm-up
        for _ in range(args.pairs):
            for name in ("plain", "dist", "dist", "plain"):
                step = plain if name == "plain" else dist
                torch.cuda.reset_peak_memory_stats(dev)
                states[name], ms = _window(step, states[name], batch, args.steps)
                walls[name].append(ms)
                peaks[name] = max(peaks.get(name, 0), torch.cuda.max_memory_allocated(dev))
        device = {}
        for name, step in (("plain", plain), ("dist", dist)):
            states[name], device[name] = _profiled(step, states[name], batch, args.steps)
        deltas = {}
        if "_kernel_ms" in device["plain"] and "_kernel_ms" in device["dist"]:
            for key in ("_kernel_ms", "_host_ms"):
                deltas[key[1:] + "_top_growth"] = _top_deltas(device["plain"].pop(key),
                                                              device["dist"].pop(key))
        if args.compressor:
            extra = _compressor_report(dist, states["dist"], batch, 2 * args.pairs)
        if args.host_offload:
            held = {name: _state_bytes(states[name]) for name in states}
            # Both states live in this process: a window's peak less the
            # other step's state on the card is the step's own.
            extra = {"offloaded_bytes": held["dist"]["host"],
                     "copied_bytes_per_step": 2 * held["dist"]["host"],
                     "state_bytes": held,
                     "own_peak_bytes": {
                         name: peaks[name] - held["dist" if name == "plain" else "plain"]["card"]
                         for name in peaks}}
        if args.async_workers:
            del states, dist
            torch.cuda.empty_cache()
            extra = _async_report(spec, params, batch, args.async_workers, args.steps,
                                  args.pairs)
        row = {
            "model": spec.name, "batch": batch_size, "path": path, "world": 1,
            "steps": args.steps, "pairs": args.pairs,
            "plain_wall_ms": walls["plain"], "dist_wall_ms": walls["dist"],
            "plain_median_ms": statistics.median(walls["plain"]),
            "dist_median_ms": statistics.median(walls["dist"]),
            "dist_minus_plain_ms": statistics.median(walls["dist"])
            - statistics.median(walls["plain"]),
            "collectives": plain.last_collectives if args.async_workers
            else dist.last_collectives,
            "device": device, **deltas, **extra, "card": card,
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
