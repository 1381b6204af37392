#!/usr/bin/env python3
"""Tensor and expert parallelism against data parallelism, on one process
group of several devices.

    python -m torch.distributed.run --nproc_per_node 4 tools/torch_tp_profile.py
    python -m torch.distributed.run --nproc_per_node 4 tools/torch_tp_profile.py \\
        --device cpu --small          # the same runs at toy widths, gloo

Every rank reads its place from the ``torchrun`` environment and joins the
group once; each run then builds its own ``AutoDist`` over that group with
its own ``mesh:`` block. The runs, at ``--ranks`` (the world size, 4):

- bert_base (seq 512, flash, batch 32) under ``AllReduce`` on ``{data 4}``
  and under ``TensorParallel`` on ``{data 2, model 2}`` and ``{data 1,
  model 4}``;
- the MoE (12 layers, d_model 768, 8 experts, d_ff 3072, seq 128, batch 32)
  under ``AllReduce`` on ``{data 4}``, and with its experts split on
  ``{data 2, expert 2}`` and ``{data 1, expert 4}``;
- ResNet-50 (224 px, batch 128, bf16) under ``AllReduce`` on ``{data 4}``
  and under ``TensorParallel`` on ``{data 2, model 2}`` and ``{data 1,
  model 4}``: its convs split on ``cout`` and ``cin``, the fused conv-stats
  kernel launched on each rank's column block (``--models resnet50``).

Each: one warm-up step, then ``--steps`` steps (Adam 1e-4) timed on the
host clock around work ending in a synchronize; rank 0 prints one JSON line
a run: ms a step, the losses, the collectives of the last step by purpose
and kind (``model`` / ``expert``: ``DTensor``'s own), the plan's data-axis
wire, the flash kernels' launches and the heads they ran on, the fused
conv-stats kernel's launches, images/s for ResNet, the peak memory, and the
first loss's distance from rank 0's one-process step on the same global
batch (the ``{data 1, ...}`` runs compute the same loss).
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
from autodist_tpu_torch.kernel import DistributedTrainStep, GraphTransformer  # noqa: E402
from autodist_tpu_torch.kernel import build_mesh  # noqa: E402
from autodist_tpu_torch.model_item import ModelItem, OptimizerSpec  # noqa: E402
from autodist_tpu_torch.models import get_model_spec  # noqa: E402
from autodist_tpu_torch.ops import flash_attention as fa  # noqa: E402
from autodist_tpu_torch.ops import fused_conv_stats as fcs  # noqa: E402
from autodist_tpu_torch.resource_spec import ResourceSpec  # noqa: E402
from autodist_tpu_torch.runtime import process_group as pg  # noqa: E402
from autodist_tpu_torch.strategy import AllReduce, StrategyCompiler, from_name  # noqa: E402

OPT = ("adam", {"learning_rate": 1e-4})
MODELS = {
    "bert_base": ("bert_base", {"max_seq_len": 512, "attention_impl": "flash"}, 32, "model",
                  "TensorParallel", ()),
    "moe": ("moe_transformer", {"num_layers": 12, "d_model": 768, "num_heads": 12,
                                "d_ff": 3072, "num_experts": 8}, 32, "expert", "AllReduce",
            ("expert_",)),
    "resnet50": ("resnet", {"depth": 50, "image_size": 224}, 128, "model", "TensorParallel",
                 ()),
}
SMALL = {
    "bert_base": {"vocab_size": 64, "num_layers": 2, "d_model": 64, "num_heads": 4,
                  "d_ff": 128, "max_seq_len": 128, "attention_impl": "flash",
                  "dtype": "float32"},
    "moe": {"vocab_size": 64, "num_layers": 2, "d_model": 32, "num_heads": 4, "d_ff": 64,
            "max_seq_len": 16, "num_experts": 4, "dtype": "float32"},
    "resnet50": {"depth": 18, "image_size": 32, "num_classes": 10},
}


def _one_process_loss(spec, params, batch, dev) -> float:
    """The first loss of the plain AllReduce step in this process alone."""
    opt = OptimizerSpec(*OPT)
    item = ModelItem.from_params(params, optimizer_spec=opt, loss_fn=spec.loss_fn,
                                 example_batch=batch)
    rs = ResourceSpec.from_local_devices(dev)
    strategy = StrategyCompiler(item).compile(AllReduce().build(item, rs))
    plan = GraphTransformer(strategy, item, build_mesh(rs, device=dev)).transform()
    step = DistributedTrainStep(plan, spec.loss_fn, opt.make())
    _, metrics = step(step.init(params), batch)
    return float(metrics["loss"])


def _heads_spy() -> set:
    """The head counts the flash kernels are launched on, from now on."""
    seen = set()
    check_args = fa._check_kernel_args

    def spy(**tensors):
        seen.add(int(tensors["q"].shape[2]))
        return check_args(**tensors)

    fa._check_kernel_args = spy
    return seen


def run(key, mesh, builder, spec, params, batch, experts, args, ref_loss, heads) -> dict:
    AutoDist.reset_default()
    axes = tuple(mesh)
    autodist = AutoDist(strategy_builder=from_name(builder), device=args.device,
                        resource_spec=ResourceSpec(resource_dict={
                            "nodes": [{"address": "localhost", "gpus": args.ranks}],
                            "mesh": mesh}), mesh_axes=axes)
    dev = autodist.device
    step = autodist.build(spec.loss_fn, params, batch, optimizer=OptimizerSpec(*OPT),
                          expert_names=experts)
    state = step.init(params)
    state, first = step(state, batch)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launches()
    fcs.fused_matmul_stats.launches = 0
    heads.clear()
    losses = [float(first["loss"])]
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, m = step(state, batch)
        losses.append(m["loss"])
    if cuda:
        torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3 / args.steps
    plan = autodist.plan
    images = batch["images"].shape[0] if isinstance(batch, dict) and "images" in batch else None
    return {"model": key, "strategy": builder, "mesh": mesh, "device": str(dev),
            "card": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "ms_per_step": ms, "losses": [float(x) for x in losses],
            "first_loss_vs_one_process": abs(losses[0] - ref_loss) / abs(ref_loss),
            "collectives_last_step": step.last_collectives,
            "plan_wire_per_step": plan.collectives_per_step(),
            "split_vars": sum(1 for n in plan.var_plans
                              if plan.rendering(n)[0] in ("partitioned", "expert")),
            "flash_launches": {"fwd": fa.flash_fwd.launches, "dkdv": fa.flash_dkdv.launches,
                               "dq": fa.flash_dq.launches},
            "flash_heads": sorted(heads),
            "fused_conv_launches": fcs.fused_matmul_stats.launches,
            "images_per_s": images / ms * 1e3 if images else None,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    ap.add_argument("--small", action="store_true", help="toy widths (the CPU rehearsal)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--models", default="bert_base,moe")
    args = ap.parse_args()
    if args.device == "cpu":
        torch.set_num_threads(1)
    AutoDist.reset_default()
    args.ranks = int(os.environ.get("WORLD_SIZE", "1"))
    pg.join(torch.device(args.device) if args.device == "cpu" else torch.device("cuda"))
    heads = _heads_spy()
    rank = torch.distributed.get_rank()
    for key in args.models.split(","):
        name, overrides, batch_size, axis, builder, experts = MODELS[key]
        spec = get_model_spec(name, **(SMALL[key] if args.small else overrides))
        dev = pg.local_device(torch.device(args.device), rank)
        params = spec.init(0, device=dev)
        batch = spec.example_batch(batch_size, device=dev)
        ref_loss = _one_process_loss(spec, params, batch, dev)
        n = args.ranks
        for mesh, b in (({"data": n}, "AllReduce"), ({"data": n // 2, axis: 2}, builder),
                        ({"data": 1, axis: n}, builder)):
            row = run(key, mesh, b, spec, params, batch, experts, args, ref_loss, heads)
            if rank == 0:
                print(json.dumps(row), flush=True)
    pg.leave()
    return 0


if __name__ == "__main__":
    sys.exit(main())
