"""One rank of the port's multi-process tests (gloo, on the CPU).

    python tests/helpers/torch_dist_worker.py JOB RANK WORLD INIT_FILE OUT_DIR

``JOB`` is a ``torch.save``d dict: ``inputs`` (per model key, ``(params,
global batch)``) and ``cases`` (each a dict: ``id``, ``model``, ``builder``,
``builder_kwargs``, ``opt``, ``opt_kwargs``, ``clip_norm``, ``steps``,
``accum``, ``overrides`` for the zoo models, ``comp_state``: the JAX
step's initial compressor state as numpy, carried to each rank; ``mesh``
and ``mesh_axes``: the resource spec's mesh block and the AutoDist's axes,
for tensor and expert parallelism; ``expert_names``; ``tune``: candidate
builder names to run ``AutoDist.tune`` over instead of training, with
``fail_rank``: the rank whose loss fails in the candidates' steps;
``bad_id``: an id outside the table put into the embed model's batch;
``bucket_bytes``: gradient buckets put into the strategy of a builder
without that option; ``data_fit``: a dataset directory to train from with
``DataLoader.from_files(process_slice=True)`` and ``fit(window=)``, and an
eval batch for ``metrics.evaluate_dataset``). The rank
joins the group at
``file://INIT_FILE`` (with a timeout) through ``AutoDist(init_method=...)``,
trains each case through ``AutoDist.build`` and the step on the global
batch, and saves ``OUT_DIR/rank<RANK>.pt``: per case the losses, the
logical params after the last step, the collectives of each step and the
plan's prediction, the bytes of each step's collectives with the step's
prediction of them (``predicted_bytes``) and the largest single payload
by purpose and kind, the compressor and staleness state of the trained
step, and a case's checkpoint work (``save``: a directory to write the
trained state to; ``restore``: directories to restore a fresh state from,
each reported as this rank's data of every leaf). Imports only torch, numpy and the port, so a child does
not pay for JAX; ``tests/helpers/torch_dist.py`` starts and reads it.
"""
import os
import sys

import numpy as np
import torch

from autodist_tpu_torch import api, model_item
from autodist_tpu_torch.checkpoint import Saver, ShardedLeaf
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.models.convert import comp_state_from_jax, flatten_params
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime import process_group as pg
from autodist_tpu_torch.strategy import StrategyBuilder, from_name

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


LOSSES = {"dense": dense_loss, "dense8": dense_loss, "embed": embed_loss,
          "embed_wide": embed_loss, "masked": masked_loss, "masked_equal": masked_loss}


def resnet_loss(depth):
    """ResNet's loss in fp32 (the zoo spec computes in bf16)."""
    from autodist_tpu_torch.models import layers as L
    from autodist_tpu_torch.models import resnet as R

    def loss(params, batch):
        return L.softmax_xent(R.forward(params, batch["images"], depth,
                                        dtype=torch.float32), batch["labels"])
    return loss


def lstm_loss(num_layers, hidden):
    """LM1B's loss with its LSTM in fp32 (the zoo spec computes in bf16)."""
    from autodist_tpu_torch.models import layers as L
    from autodist_tpu_torch.models import lstm_lm as M

    def loss(params, batch):
        tokens = batch["tokens"]
        return L.softmax_xent(M.forward(params, tokens[:, :-1], num_layers, hidden,
                                        dtype=torch.float32), tokens[:, 1:])
    return loss


def cnn_loss(zoo, overrides):
    """VGG's, DenseNet's or Inception's loss in fp32 (the zoo specs compute
    in bf16)."""
    from autodist_tpu_torch.models import densenet, inception, vgg
    from autodist_tpu_torch.models import layers as L

    o, f32 = overrides, torch.float32
    forward = {
        "vgg": lambda p, x: vgg.forward(p, x, o["depth"], dtype=f32),
        "densenet": lambda p, x: densenet.forward(p, x, o.get("depth", 121), dtype=f32,
                                                  blocks=o.get("blocks")),
        "inception": lambda p, x: inception.forward(p, x, dtype=f32),
    }[zoo]

    def loss(params, batch):
        return L.softmax_xent(forward(params, batch["images"]), batch["labels"])
    return loss


def loss_for(case):
    """The port's loss of a case: a toy model above, ResNet, LM1B or another
    CNN in fp32, else a zoo spec's."""
    if case["model"] in LOSSES:
        return LOSSES[case["model"]]
    if case["zoo"] == "resnet":
        return resnet_loss(case["depth"])
    if case["zoo"] == "lstm_lm" and case.get("fp32"):
        o = case["overrides"]
        return lstm_loss(o["num_layers"], o["hidden"])
    if case["zoo"] in ("vgg", "densenet", "inception") and case.get("fp32"):
        return cnn_loss(case["zoo"], case["overrides"])
    return get_model_spec(case["zoo"], **case.get("overrides", {})).loss_fn


class _Bucketed(StrategyBuilder):
    """A builder's strategy with gradient buckets of ``nbytes`` (its graph
    config's ``bucket_bytes``), for builders without that option."""

    def __init__(self, inner, nbytes: int):
        self.inner, self.nbytes = inner, nbytes

    def build(self, model_item, resource_spec):
        strategy = self.inner.build(model_item, resource_spec)
        strategy.graph_config.bucket_bytes = self.nbytes
        return strategy


def train(case, params, batch, **autodist_kwargs):
    """``(autodist, step, state, losses, per-step collectives, loss of the
    trained state on the batch)`` of a case."""
    api.AutoDist.reset_default()
    builder = from_name(case["builder"], **case.get("builder_kwargs", {}))
    if case.get("bucket_bytes"):
        builder = _Bucketed(builder, case["bucket_bytes"])
    ad = api.AutoDist(strategy_builder=builder, device="cpu", **autodist_kwargs)
    opt = model_item.OptimizerSpec(case["opt"], dict(case["opt_kwargs"]),
                                   clip_norm=case.get("clip_norm"))
    step = ad.build(loss_for(case), params, batch, optimizer=opt,
                    grad_accum_steps=case.get("accum", 1),
                    expert_names=case.get("expert_names", ()))
    state = step.init(params)
    if case.get("comp_state") is not None:
        state.comp_state = comp_state_from_jax(case["comp_state"],
                                               rank=ad.plan.mesh.data_rank, device="cpu")
    if case.get("local_feed"):
        # A loader that holds only this rank's rows: the plan assembles
        # the global batch from every rank's.
        batch = ad.plan.global_batch_from_local(ad.plan.local_batch(batch))
    losses, wire = [], []
    for _ in range(case["steps"]):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        wire.append((step.last_collectives, step.last_bytes))
    return ad, step, state, losses, wire, float(step.evaluate(state, batch)["loss"])


class _Refuses(StrategyBuilder):
    """A tune candidate whose builder raises (on the chief, where it runs)."""

    def build(self, model_item, resource_spec):
        raise ValueError("this builder refuses every model")


def _fails_on_device(loss_fn):
    """The loss, raising wherever it computes (a rank out of memory in
    its steps); the meta trace of the build still passes."""

    def loss(params, batch):
        first = batch[0] if isinstance(batch, (tuple, list)) else next(iter(batch.values()))
        if not first.is_meta:
            raise MemoryError("out of memory (injected by the test)")
        return loss_fn(params, batch)

    return loss


def tune(case, params, batch, **autodist_kwargs):
    """``AutoDist.tune`` over the case's candidate names (``"Refuses"``: a
    builder that raises): what was selected, each candidate's measured
    seconds and the builder the AutoDist kept; or the error it raised
    (``fail_rank``: the rank whose loss fails in its steps)."""
    api.AutoDist.reset_default()
    ad = api.AutoDist(device="cpu", **autodist_kwargs)
    opt = model_item.OptimizerSpec(case["opt"], dict(case["opt_kwargs"]))
    loss = loss_for(case)
    if case.get("fail_rank") == autodist_kwargs["rank"]:
        loss = _fails_on_device(loss)
    candidates = [(n, _Refuses() if n == "Refuses" else from_name(n)) for n in case["tune"]]
    try:
        ad.tune(loss, params, batch, candidates=candidates, window=1, optimizer=opt)
    except RuntimeError as e:
        return {"error": str(e)}
    return {"selected": ad.last_tune_results["selected"],
            "measured": ad.last_tune_results["measured"],
            "builder": type(ad.strategy_builder).__name__}


def bad_id(case, params, batch, **autodist_kwargs):
    """The error each rank raises when the global batch of the embed model
    holds ``bad_id`` (``None``: it trained)."""
    ids, y = batch
    ids = ids.clone()
    ids[5] = case["bad_id"]
    try:
        train(case, params, (ids, y), **autodist_kwargs)
    except IndexError as e:
        return {"error": str(e)}
    return {"error": None}


def data_fit(case, params, batch, **autodist_kwargs):
    """The data pipeline and training loop on the ranks: each rank opens the
    case's dataset directory with ``process_slice=True`` (its contiguous
    quarter of the rows), ``fit(window=)`` trains on the global batches the
    plan assembles, and ``evaluate_dataset`` scores the trained state with
    ``classification_metrics`` on the eval batch; also the error
    ``fit(window>1)`` raises over a generic iterator."""
    from autodist_tpu_torch import metrics
    from autodist_tpu_torch.data import DataLoader

    api.AutoDist.reset_default()
    ad = api.AutoDist(strategy_builder=from_name(case["builder"]), device="cpu",
                      **autodist_kwargs)
    spec = get_model_spec("mlp", **case["overrides"])
    opt = model_item.OptimizerSpec(case["opt"], dict(case["opt_kwargs"]))
    step = ad.build(spec.loss_fn, params, batch, optimizer=opt)
    f = case["data_fit"]
    loader = DataLoader.from_files(f["dir"], batch_size=f["local_batch"], process_slice=True,
                                   seed=f["seed"], engine="native", plan=ad.plan)
    state, history = step.fit(step.init(params), loader, window=f["window"])
    mfn = metrics.classification_metrics(spec.apply, input_key="x", label_key="y",
                                         top_k=(1, 2))
    evaluated = metrics.evaluate_dataset(step, state, [f["eval_batch"]], metrics_fn=mfn)
    try:
        step.fit(state, iter([batch, batch]), window=2)
        window_error = None
    except ValueError as e:
        window_error = str(e)
    return {"engine": loader.engine, "losses": history["loss"], "steps": state.step,
            "params": {k: v.numpy().copy()
                       for k, v in flatten_params(step.logical_params(state)).items()},
            "evaluated": evaluated, "window_error": window_error,
            "padded": [n for n, p in ad.plan.var_plans.items() if p.storage_shape]}


def _local_blocks(step, state):
    """This rank's data of each checkpoint leaf: ``{name: (start, stop,
    array)}`` in logical coordinates (whole leaves from ``(0, ...)``)."""
    out = {}
    for name, leaf, view in step.checkpoint_leaves(state, restore=True):
        if isinstance(leaf, int):
            out[name] = ((), (), np.asarray(leaf))
        elif isinstance(leaf, ShardedLeaf):
            for j in leaf.local:
                start, stop = leaf.blocks[j]
                out[name] = (start, stop, view.detach().numpy().copy())
        else:
            shape = tuple(view.shape)
            out[name] = ((0,) * len(shape), shape, view.detach().numpy().copy())
    return out


def checkpoint(case, ad, step, state, params):
    """A case's checkpoint work: ``save`` writes the trained state under
    that directory (every rank its own blocks) and reports the files this
    rank wrote; ``restore`` (a list of directories) restores each into a
    fresh state of the same step and reports this rank's data of every
    leaf."""
    out = {}
    if case.get("save"):
        saver = Saver(case["save"])
        _, files = saver._collect(step.logical_state(state))
        out["files"] = sorted(f for f, _, _ in files)
        out["path"] = step.save(saver, state)
    for directory in case.get("restore", ()):
        restored = step.init_or_restore(params, Saver(directory))
        out.setdefault("restored", {})[directory] = {
            "step": restored.step, "count": restored.opt_state["count"],
            "blocks": _local_blocks(step, restored),
            "params": {k: v.detach().numpy().copy() for k, v in
                       flatten_params(step.logical_params(restored)).items()}}
    return out


def main(job_path, rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    out = {}
    for case in job["cases"]:
        params, batch = job["inputs"][case["model"]]
        mesh = {"mesh": case["mesh"]} if case.get("mesh") else {}
        spec = ResourceSpec(resource_dict={"nodes": [
            {"address": "localhost", "gpus": world, "chief": True}], **mesh})
        axes = {"mesh_axes": case["mesh_axes"]} if case.get("mesh_axes") else {}
        if case.get("tune") or "bad_id" in case or "data_fit" in case:
            run = tune if case.get("tune") else data_fit if "data_fit" in case else bad_id
            out[case["id"]] = run(case, params, batch, resource_spec=spec,
                                  init_method=f"file://{init_file}", world_size=world,
                                  rank=rank, timeout_s=GROUP_TIMEOUT_S)
            continue
        ad, step, state, losses, wire, evaluated = train(
            case, params, batch, resource_spec=spec, init_method=f"file://{init_file}",
            world_size=world, rank=rank, timeout_s=GROUP_TIMEOUT_S, **axes)
        logical = step.logical_params(state)
        out[case["id"]] = {
            "losses": losses,
            "eval": evaluated,
            "params": {k: v.numpy().copy() for k, v in flatten_params(logical).items()},
            "collectives": [counts for counts, _ in wire],
            "bytes": [moved for _, moved in wire],
            "predicted": ad.plan.collectives_per_step(bucketed=step.accum == 1),
            "predicted_bytes": step.predicted_bytes(state, batch),
            "largest": {p: dict(k) for p, k in step.coll.largest.items()},
            "manual": step.manual,
            "renderings": {n: ad.plan.rendering(n) for n in ad.plan.var_plans},
            "padded": [n for n, p in ad.plan.var_plans.items() if p.storage_shape],
            "comp_state": {n: {part: {k: t.numpy().copy() for k, t in st[part].items()}
                               for part in ("local", "shared")}
                           for n, st in state.comp_state.items()},
            "stale_state": {n: t.numpy().copy() for n, t in state.stale_state.items()},
            "checkpoint": checkpoint(case, ad, step, state, params),
        }
    pg.leave()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
