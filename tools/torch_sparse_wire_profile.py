#!/usr/bin/env python3
"""The sparse touched-rows wire on several devices, this tree against a base
tree, in turn.

    python3 tools/torch_sparse_wire_profile.py [--base DIR] [--pairs 2] [--tune]
    python3 tools/torch_sparse_wire_profile.py --device cpu --small [--tune]

Starts ``--ranks`` (4) processes with ``torch.distributed.run`` for each
turn, in the order base, this, this, base, ... (``--pairs`` turns of each;
without ``--base`` this tree alone), each turn in the tree's own root with
this script copied into its ``tools/``, so that a drift of the host falls
on both trees alike. On a data axis of ``--ranks`` (NCCL on the cards, gloo
with ``--device cpu``), Adam at 1e-4, each run is ``--warmup`` (1) steps
and ``--steps`` (5) timed steps (host clock around work ending in a
synchronize):

- LM1B (``lstm_lm`` at the zoo's widths: vocab 8192, embed 512, hidden
  1024, 2 layers, seq 32) at batch 128 and NCF (6040 users, 3706 items) at
  batch 4096, the zoo's batches (``models.PUBLISHED``);
- ``embed``: JAX's ``tests/test_sparse_wire.py`` model widened to a
  1,048,576 x 64 fp32 table (256 MiB), 4096 ids a step;

each under ``Parallax`` and ``AllReduce``. A run reports: ms a step, the
bytes of the last step's collectives by purpose and kind, their sum, the
step's own prediction of them (``step.predicted_bytes``, where the tree has
it), the largest single payload, and the tables' bytes. Each turn also
times the group's collective latency: 200 one-element all-reduces issued
back to back (host µs a call) and 50 each waited on. With ``--tune`` (the
first turn of this tree only) each model's ``Auto`` pick is set beside
``AutoDist.tune``'s measured pick over ``candidate_slate()`` (window 2).
Rank 0 of each turn writes its JSON lines to ``--out``; the launching
process prints one JSON line a (tree, model, builder) with the turns'
values and medians.
``--small`` cuts widths to a CPU rehearsal (a 4096 x 16 table, LM1B at
vocab 4096, NCF at 4096 users).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join("tools", "torch_sparse_wire_profile.py")
OPT = ("adam", {"learning_rate": 1e-4})
BUILDERS = ("Parallax", "AllReduce")
#: model -> (zoo name or "embed", overrides, global batch); small widths.
MODELS = {"lm1b": ("lstm_lm", {}, 128), "ncf": ("ncf", {}, 4096),
          "embed": ("embed", {"vocab": 1 << 20, "dim": 64}, 4096)}
SMALL = {"lm1b": ("lstm_lm", {"vocab_size": 4096, "embed_dim": 16, "hidden": 32,
                              "num_layers": 2, "seq_len": 8}, 8),
         "ncf": ("ncf", {"num_users": 4096, "num_items": 2048, "mf_dim": 8,
                         "mlp_dims": (16, 16, 8)}, 64),
         "embed": ("embed", {"vocab": 4096, "dim": 16}, 64)}
LATENCY_CALLS, LATENCY_SYNCED = 200, 50


# ------------------------------------------------------------------ a rank
def _inputs(zoo: str, overrides: dict, batch_size: int, dev):
    """(loss, params, batch, sparse names) of a run, from seed 0."""
    import torch

    from autodist_tpu_torch.models import get_model_spec

    if zoo == "embed":
        gen = torch.Generator(device=dev).manual_seed(0)
        vocab, dim = overrides["vocab"], overrides["dim"]
        params = {"embedding": torch.randn(vocab, dim, generator=gen, device=dev) * 0.01,
                  "w": torch.randn(dim, 1, generator=gen, device=dev)}
        batch = (torch.randint(0, vocab, (batch_size,), generator=gen, device=dev),
                 torch.randn(batch_size, generator=gen, device=dev))

        def loss(p, b):
            ids, y = b
            return torch.mean(((p["embedding"][ids] @ p["w"]).squeeze(-1) - y) ** 2)
        return loss, params, batch, ("embedding",)
    spec = get_model_spec(zoo, **overrides)
    return (spec.loss_fn, spec.init(0, device=dev), spec.example_batch(batch_size, device=dev),
            tuple(spec.sparse_names))


def _delta(after: dict, before: dict) -> dict:
    return {p: {k: v - before.get(p, {}).get(k, 0) for k, v in kinds.items()
                if v - before.get(p, {}).get(k, 0)} for p, kinds in after.items()
            if any(v - before.get(p, {}).get(k, 0) for k, v in kinds.items())}


def _latency(dev, group) -> dict:
    """Host µs a one-element all-reduce: issued back to back, and each
    waited on (the cost model's latency term)."""
    import torch
    import torch.distributed as dist

    t = torch.ones(1, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(20):
        dist.all_reduce(t, group=group)
    sync()
    t0 = time.perf_counter()
    for _ in range(LATENCY_CALLS):
        dist.all_reduce(t, group=group)
    sync()
    issued = (time.perf_counter() - t0) / LATENCY_CALLS * 1e6
    t0 = time.perf_counter()
    for _ in range(LATENCY_SYNCED):
        dist.all_reduce(t, group=group)
        sync()
    waited = (time.perf_counter() - t0) / LATENCY_SYNCED * 1e6
    return {"allreduce_issued_us": issued, "allreduce_waited_us": waited}


def _run(model, zoo, overrides, batch_size, builder, args, dev, world, out):
    import torch

    from autodist_tpu_torch.api import AutoDist
    from autodist_tpu_torch.model_item import OptimizerSpec
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy import from_name

    loss, params, batch, sparse = _inputs(zoo, overrides, batch_size, dev)
    AutoDist.reset_default()
    spec = ResourceSpec(resource_dict={"nodes": [{"address": "localhost", "gpus": world}]})
    ad = AutoDist(strategy_builder=from_name(builder), resource_spec=spec, device=args.device)
    step = ad.build(loss, params, batch, optimizer=OptimizerSpec(*OPT), sparse_names=sparse)
    state = step.init(params)
    for _ in range(args.warmup):
        state, _ = step(state, batch)
    sync = (lambda: torch.cuda.synchronize(step.plan.device)) \
        if step.plan.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        before = step.coll.bytes_snapshot()
        state, m = step(state, batch)
    sync()
    ms = (time.perf_counter() - t0) / args.steps * 1e3
    moved = _delta(step.coll.bytes_snapshot(), before)
    wire = {p: k for p, k in moved.items() if p in ("grad", "param", "sparse", "table")}
    predicted = (step.predicted_bytes(state, batch)
                 if hasattr(step, "predicted_bytes") else None)
    largest = getattr(step.coll, "largest", None)
    row = dict(model=model, builder=builder, world=world, global_batch=batch_size,
               steps=args.steps, ms_per_step=ms, loss=float(m["loss"]),
               wire_bytes=wire, wire_bytes_total=sum(v for k in wire.values()
                                                     for v in k.values()),
               predicted_bytes=predicted, predicted_equal=(predicted == wire
                                                           if predicted is not None else None),
               largest_payload=({p: dict(k) for p, k in largest.items()
                                 if p not in ("init", "view")} if largest is not None else None),
               renderings={n: step.plan.rendering(n)[0] for n in step.plan.var_plans
                           if step.plan.var_plans[n].var.sparse_update},
               table_bytes={n: p.var.size * 4 for n, p in step.plan.var_plans.items()
                            if p.var.sparse_update},
               collectives=step.last_collectives,
               peak_mem_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                            if dev.type == "cuda" else None))
    out.append(row)
    del step, state, ad
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _picks(model, zoo, overrides, batch_size, args, dev, world, out):
    """Auto's pick against tune's measured pick for one model."""
    import torch

    from autodist_tpu_torch.api import AutoDist
    from autodist_tpu_torch.model_item import OptimizerSpec
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy import Auto
    from autodist_tpu_torch.strategy.cost_model import CostModel, candidate_slate

    loss, params, batch, sparse = _inputs(zoo, overrides, batch_size, dev)
    spec = ResourceSpec(resource_dict={"nodes": [{"address": "localhost", "gpus": world}],
                                       **({"gpu": ResourceSpec.from_local_devices(
                                           args.device).gpu.to_dict()}
                                          if dev.type == "cuda" else {})})
    AutoDist.reset_default()
    ad = AutoDist(strategy_builder=Auto(), resource_spec=spec, device=args.device)
    ad.build(loss, params, batch, optimizer=OptimizerSpec(*OPT), sparse_names=sparse)
    item = ad.model_item
    slate = candidate_slate()
    ranked = CostModel(item, spec).rank([(n, b.build(item, spec)) for n, b in slate])
    auto = Auto().build(item, spec)
    auto_pick = next(n for n, b in slate
                     if b.build(item, spec).node_config == auto.node_config)
    AutoDist.reset_default()
    ad = AutoDist(resource_spec=spec, device=args.device)
    ad.tune(loss, params, batch, candidates=slate, window=2,
            optimizer=OptimizerSpec(*OPT), sparse_names=sparse)
    rec = ad.last_tune_results
    out.append(dict(kind="picks", model=model, world=world, auto=auto_pick,
                    tune=rec["selected"],
                    predicted_ms={n: c.total_s * 1e3 for n, c in ranked},
                    measured_ms={n: dt * 1e3 for n, dt in rec["measured"].items()}))
    del ad
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def rank_main(args) -> int:
    sys.path.insert(0, os.getcwd())
    import torch
    import torch.distributed as dist

    from autodist_tpu_torch.runtime import process_group as pg

    dev = pg.local_device(torch.device(args.device), int(os.environ.get("RANK", "0")))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = pg.join(dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    models = SMALL if args.small else MODELS
    out = [dict(kind="latency", world=world, device=str(dev), torch=torch.__version__,
                name=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                **_latency(dev, group))]
    for model, (zoo, overrides, batch_size) in models.items():
        for builder in BUILDERS:
            _run(model, zoo, overrides, batch_size, builder, args, dev, world, out)
    if args.tune:
        for model, (zoo, overrides, batch_size) in models.items():
            _picks(model, zoo, overrides, batch_size, args, dev, world, out)
    if rank == 0:
        with open(args.rank_out, "w", encoding="utf-8") as f:
            for row in out:
                f.write(json.dumps(row) + "\n")
                print(json.dumps(row), flush=True)
    pg.leave()
    return 0


# ------------------------------------------------------- the turns
def _turn(root: str, label: str, i: int, args, tune: bool) -> list:
    path = os.path.join(os.path.abspath(args.out), f"turn{i}_{label}.jsonl")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(args.ranks), "--master_port", str(args.port + i), SCRIPT, "--rank-mode",
           "--device", args.device, "--steps", str(args.steps), "--warmup", str(args.warmup),
           "--rank-out", path]
    cmd += ["--small"] if args.small else []
    cmd += ["--tune"] if tune else []
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root)
    if args.device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    subprocess.run(cmd, cwd=root, env=env, check=True)
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", default="", help="the other tree's root (a git archive)")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--tune", action="store_true")
    ap.add_argument("--port", type=int, default=29561)
    ap.add_argument("--out", default=os.path.join("profile_out", "sparse_wire"))
    ap.add_argument("--rank-mode", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rank-out", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank_mode:
        return rank_main(args)
    os.makedirs(args.out, exist_ok=True)
    trees = {"this": HERE}
    if args.base:
        trees["base"] = os.path.abspath(args.base)
        shutil.copy(os.path.join(HERE, SCRIPT), os.path.join(trees["base"], SCRIPT))
    order = []
    for i in range(args.pairs):
        pair = ("base", "this") if i % 2 == 0 else ("this", "base")
        order += [t for t in pair if t in trees]
    runs: dict = {}
    tuned = False
    for i, label in enumerate(order):
        tune = args.tune and label == "this" and not tuned
        tuned = tuned or tune
        for row in _turn(trees[label], label, i, args, tune):
            key = (label, row.get("kind", "run"), row.get("model", ""), row.get("builder", ""))
            runs.setdefault(key, []).append(row)
    for (label, kind, model, builder), rows in runs.items():
        summary = {"tree": label, "kind": kind, "model": model, "builder": builder,
                   "turns": len(rows)}
        for k, v in rows[0].items():
            vals = [r[k] for r in rows]
            if all(isinstance(x, (int, float)) and not isinstance(x, bool) for x in vals):
                summary[k] = {"runs": vals, "median": statistics.median(vals)}
            elif k not in summary:
                summary[k] = v
        print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
