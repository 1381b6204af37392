#!/usr/bin/env python3
"""Train a zoo model on several processes, one per device, through the port.

    python -m torch.distributed.run --nproc_per_node 4 tools/torch_dist_train.py \\
        --device cpu [--model mlp] [--strategy Zero1] [--steps 5] [--batch 64]
    python -m torch.distributed.run --nproc_per_node <cards> tools/torch_dist_train.py \\
        --model bert_base --strategy AllReduce --bucket-mib 25 --batch 32

Each rank reads its place from the ``torchrun`` environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``):
``AutoDist`` joins the group (gloo on the CPU, NCCL on ``cuda:LOCAL_RANK``),
rank 0 builds the strategy, every rank builds the same seeded params and
global batch, trains on its rows and prints one JSON line (rank 0 also the
plan's collectives a step). bert_base runs at seq 512 with flash
attention; the other zoo models at their defaults.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from autodist_tpu_torch.api import AutoDist  # noqa: E402
from autodist_tpu_torch.model_item import OptimizerSpec  # noqa: E402
from autodist_tpu_torch.models import get_model_spec  # noqa: E402
from autodist_tpu_torch.runtime import process_group as pg  # noqa: E402
from autodist_tpu_torch.strategy import from_name  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    ap.add_argument("--model", default="mlp")
    ap.add_argument("--strategy", default="AllReduce")
    ap.add_argument("--bucket-mib", type=float, default=0.0,
                    help="bucket_bytes in MiB for AllReduce and Zero1")
    ap.add_argument("--batch", type=int, default=64, help="the global batch")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--lr", type=float, default=1e-3)
    args = ap.parse_args()
    if args.device == "cpu":
        torch.set_num_threads(1)
    overrides = {"max_seq_len": 512, "attention_impl": "flash"} \
        if args.model.startswith("bert") else {}
    spec = get_model_spec(args.model, **overrides)
    kwargs = {}
    if args.strategy in ("AllReduce", "Zero1") and args.bucket_mib:
        kwargs["bucket_bytes"] = int(args.bucket_mib * (1 << 20))
    autodist = AutoDist(strategy_builder=from_name(args.strategy, **kwargs),
                        device=args.device)
    dev = autodist.device
    params = spec.init(0, device=dev)
    batch = spec.example_batch(args.batch, device=dev)
    step = autodist.build(spec.loss_fn, params, batch,
                          optimizer=OptimizerSpec("adam", {"learning_rate": args.lr}),
                          sparse_names=spec.sparse_names, expert_names=spec.expert_names)
    state = step.init(params)
    t0 = time.perf_counter()
    state, metrics = step.run(state, batch, args.steps)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    row = {"rank": autodist.mesh.rank, "world": autodist.mesh.data_size,
           "device": str(dev), "model": spec.name, "strategy": args.strategy,
           "losses": metrics["loss"].tolist(),
           "ms_per_step": (time.perf_counter() - t0) * 1e3 / args.steps,
           "collectives_last_step": step.last_collectives}
    if row["rank"] == 0:
        row["plan_wire_per_step"] = autodist.plan.collectives_per_step()
    print(json.dumps(row), flush=True)
    pg.leave()
    return 0


if __name__ == "__main__":
    sys.exit(main())
