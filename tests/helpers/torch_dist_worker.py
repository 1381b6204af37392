"""One rank of the port's multi-process tests (gloo, on the CPU).

    python tests/helpers/torch_dist_worker.py JOB RANK WORLD INIT_FILE OUT_DIR

``JOB`` is a ``torch.save``d dict: ``inputs`` (per model key, ``(params,
global batch)``) and ``cases`` (each a dict: ``id``, ``model``, ``builder``,
``builder_kwargs``, ``opt``, ``opt_kwargs``, ``clip_norm``, ``steps``,
``accum``, ``overrides`` for the zoo models, ``comp_state``: the JAX
step's initial compressor state as numpy, carried to each rank). The rank
joins the group at
``file://INIT_FILE`` (with a timeout) through ``AutoDist(init_method=...)``,
trains each case through ``AutoDist.build`` and the step on the global
batch, and saves ``OUT_DIR/rank<RANK>.pt``: per case the losses, the
logical params after the last step, the collectives of each step and the
plan's prediction, and the compressor and staleness state of the trained
step. Imports only torch, numpy and the port, so a child does
not pay for JAX; ``tests/helpers/torch_dist.py`` starts and reads it.
"""
import os
import sys

import torch

from autodist_tpu_torch import api, model_item
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.models.convert import comp_state_from_jax, flatten_params
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime import process_group as pg
from autodist_tpu_torch.strategy import from_name

GROUP_TIMEOUT_S = 60.0


def dense_loss(params, batch):
    x, y = batch
    pred = x @ params["w"] + params["b"]
    return torch.mean((pred - y) ** 2)


def embed_loss(params, batch):
    ids, y = batch
    x = params["embedding"][ids]
    pred = (x @ params["w"]).squeeze(-1)
    return torch.mean((pred - y) ** 2)


def masked_loss(params, batch):
    """A masked mean: the normaliser is the batch's count of kept rows."""
    x, y, mask = batch
    err = torch.mean((x @ params["w"] + params["b"] - y) ** 2, dim=-1)
    return torch.sum(err * mask) / torch.sum(mask)


LOSSES = {"dense": dense_loss, "embed": embed_loss, "masked": masked_loss,
          "masked_equal": masked_loss}


def resnet_loss(depth):
    """ResNet's loss in fp32 (the zoo spec computes in bf16)."""
    from autodist_tpu_torch.models import layers as L
    from autodist_tpu_torch.models import resnet as R

    def loss(params, batch):
        return L.softmax_xent(R.forward(params, batch["images"], depth,
                                        dtype=torch.float32), batch["labels"])
    return loss


def loss_for(case):
    """The port's loss of a case: a toy model above, ResNet in fp32, else a
    zoo spec's."""
    if case["model"] in LOSSES:
        return LOSSES[case["model"]]
    if case["zoo"] == "resnet":
        return resnet_loss(case["depth"])
    return get_model_spec(case["zoo"], **case.get("overrides", {})).loss_fn


def train(case, params, batch, **autodist_kwargs):
    """``(autodist, step, state, losses, per-step collectives, loss of the
    trained state on the batch)`` of a case."""
    api.AutoDist.reset_default()
    ad = api.AutoDist(strategy_builder=from_name(case["builder"],
                                                 **case.get("builder_kwargs", {})),
                      device="cpu", **autodist_kwargs)
    opt = model_item.OptimizerSpec(case["opt"], dict(case["opt_kwargs"]),
                                   clip_norm=case.get("clip_norm"))
    step = ad.build(loss_for(case), params, batch, optimizer=opt,
                    grad_accum_steps=case.get("accum", 1))
    state = step.init(params)
    if case.get("comp_state") is not None:
        state.comp_state = comp_state_from_jax(case["comp_state"], rank=ad.plan.mesh.rank,
                                               device="cpu")
    if case.get("local_feed"):
        # A loader that holds only this rank's rows: the plan assembles
        # the global batch from every rank's.
        batch = ad.plan.global_batch_from_local(ad.plan.local_batch(batch))
    losses, wire = [], []
    for _ in range(case["steps"]):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        wire.append(step.last_collectives)
    return ad, step, state, losses, wire, float(step.evaluate(state, batch)["loss"])


def main(job_path, rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    spec = ResourceSpec(resource_dict={"nodes": [
        {"address": "localhost", "gpus": world, "chief": True}]})
    out = {}
    for case in job["cases"]:
        params, batch = job["inputs"][case["model"]]
        ad, step, state, losses, wire, evaluated = train(
            case, params, batch, resource_spec=spec, init_method=f"file://{init_file}",
            world_size=world, rank=rank, timeout_s=GROUP_TIMEOUT_S)
        logical = step.logical_params(state)
        out[case["id"]] = {
            "losses": losses,
            "eval": evaluated,
            "params": {k: v.numpy().copy() for k, v in flatten_params(logical).items()},
            "collectives": wire,
            "predicted": ad.plan.collectives_per_step(bucketed=step.accum == 1),
            "manual": step.manual,
            "renderings": {n: ad.plan.rendering(n) for n in ad.plan.var_plans},
            "padded": [n for n, p in ad.plan.var_plans.items() if p.storage_shape],
            "comp_state": {n: {part: {k: t.numpy().copy() for k, t in st[part].items()}
                               for part in ("local", "shared")}
                           for n, st in state.comp_state.items()},
            "stale_state": {n: t.numpy().copy() for n, t in state.stale_state.items()},
        }
    pg.leave()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
