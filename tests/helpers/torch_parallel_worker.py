"""One rank of the port's sequence- and pipeline-parallel tests (gloo, on
the CPU).

    python tests/helpers/torch_parallel_worker.py JOB RANK WORLD INIT_FILE OUT_DIR

``JOB`` is a ``torch.save``d dict (``helpers/torch_dist.py``'s
``run_ranks`` writes it): ``inputs`` (per key, a tuple of numpy arrays or
trees) and ``cases``, each a dict with ``id``, ``kind``, ``mesh`` (the
resource spec's ``mesh:`` block, its keys the mesh axes) and the kind's
fields:

- ``attn``: ``impl`` (``ring`` / ``ulysses``), ``causal``; inputs ``(q, k,
  v, g)``. Reports the output and the gradients of ``sum(out * g)`` with
  respect to q, k and v (every rank holds them whole);
- ``attn_error``: the ``ValueError`` text of the call (``None``: none);
- ``pipe_apply``: ``stage`` (``tanh`` / ``two_layer``), ``schedule``,
  ``n_micro``, ``remat``; inputs ``(stacked params, x)``. Reports the
  output and the gradients of ``sum(out ** 2)``: this rank's stage slice of
  each stacked leaf (``stage``: its index) and ``x``'s whole gradient;
- ``pipe_vg``: ``pipeline_value_and_grad`` with ``loss_head`` ``mean((o -
  t) ** 2)``; inputs ``(stacked params, x, targets)``;
- ``pipe_memory``: for each ``n_micro`` of the case, the peak bytes saved
  for backward (``saved_tensors_hooks``: live tensors, each counted once)
  under ``gpipe``, ``1f1b`` and the interleaved loop;
- ``pipe_error``: the ``ValueError`` text of ``pipeline_apply`` with
  ``stages`` stacked stages and ``schedule``;
- ``pipe_step``: ``AutoDist.build_pipeline`` (SGD at ``lr``, 4
  microbatches): evaluate, one step, the gathered stack, ``run`` of
  ``run_steps``, evaluate again; inputs ``(stacked params, x, targets)``;
- ``mesh_groups``: the mesh of ``mesh`` (over ``mesh_axes``, default its
  keys): this rank's coordinates and the global ranks of its groups;
- ``pipe_step_error``: the ``ValueError`` text of one ``build_pipeline``
  step whose stage calls ``ring_attention`` (``ring_stage``);
- ``train``: ``AutoDist.build`` on a case of ``torch_dist_worker.py``
  (its fields; inputs ``(torch params, torch batch)``), reported as that
  worker reports its losses, logical params, collectives, the plan's
  prediction and renderings.

The group forms at ``file://INIT_FILE``; ``OUT_DIR/rank<RANK>.pt`` holds
the results by case id. Imports only torch, numpy and the port.
"""
import os
import sys
import weakref

import numpy as np
import torch
import torch.distributed as dist

from autodist_tpu_torch import api
from autodist_tpu_torch.kernel import build_mesh
from autodist_tpu_torch.model_item import OptimizerSpec
from autodist_tpu_torch.parallel import (pipeline_apply, pipeline_value_and_grad,
                                         ring_attention, ulysses_attention)
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime import process_group as pg

GROUP_TIMEOUT_S = 60.0
ATTENTION = {"ring": ring_attention, "ulysses": ulysses_attention}


def tanh_stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def two_layer_stage(p, h):
    h = torch.tanh(h @ p["w1"])
    return torch.tanh(h @ p["w2"] + p["b"])


def ring_stage(p, h):
    """A stage whose rows are 4 tokens of one 2-wide head, attended by ring
    attention over the mesh's seq axis."""
    q = torch.tanh(h @ p["w"] + p["b"]).reshape(h.shape[0], 4, 1, 2)
    return ring_attention(q, q, q).reshape(h.shape)


STAGES = {"tanh": tanh_stage, "two_layer": two_layer_stage, "ring": ring_stage}


def mse_head(o, t):
    return torch.mean((o - t) ** 2)


def square_head(o):
    return torch.mean(o ** 2)


def tensors(tree):
    if isinstance(tree, dict):
        return {k: tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tensors(v) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True))


def numpy(tree):
    if isinstance(tree, dict):
        return {k: numpy(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def mesh_of(case, world):
    spec = ResourceSpec(resource_dict={"nodes": [
        {"address": "localhost", "gpus": world, "chief": True}], "mesh": case["mesh"]})
    return build_mesh(spec, device="cpu", group=dist.group.WORLD,
                      axes=case.get("mesh_axes", tuple(case["mesh"])))


class SavedBytes:
    """Bytes of the tensors saved for backward that are still alive, each
    (data pointer, size, dtype) counted once, and their peak."""

    class _Box:
        def __init__(self, t):
            self.t = t

    def __init__(self):
        self.live, self.peak, self.refs = 0, 0, {}

    def pack(self, t):
        key = (t.data_ptr(), t.numel(), t.dtype)
        if self.refs.get(key, 0) == 0:
            self.live += t.numel() * t.element_size()
            self.peak = max(self.peak, self.live)
        self.refs[key] = self.refs.get(key, 0) + 1
        box = self._Box(t)
        weakref.finalize(box, self._release, key, t.numel() * t.element_size())
        return box

    def _release(self, key, nbytes):
        self.refs[key] -= 1
        if self.refs[key] == 0:
            self.live -= nbytes

    @staticmethod
    def unpack(box):
        return box.t

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self.pack, self.unpack)


def attn(case, inputs, mesh):
    q, k, v, g = (tensors(a).requires_grad_(i < 3) for i, a in enumerate(inputs))
    out = ATTENTION[case["impl"]](q, k, v, causal=case["causal"], mesh=mesh)
    torch.sum(out * g).backward()
    return {"out": numpy(out), "dq": numpy(q.grad), "dk": numpy(k.grad),
            "dv": numpy(v.grad)}


def attn_error(case, inputs, mesh):
    q, k, v = (tensors(a) for a in inputs[:3])
    try:
        ATTENTION[case["impl"]](q, k, v, causal=case.get("causal", False), mesh=mesh)
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def _stage_index(mesh):
    return mesh.coords.get("pipe", 0)


def pipe_apply(case, inputs, mesh):
    params = {n: t.requires_grad_(True) for n, t in tensors(inputs[0]).items()}
    x = tensors(inputs[1]).requires_grad_(True)
    out = pipeline_apply(STAGES[case["stage"]], params, x, case["n_micro"], mesh=mesh,
                         remat_stages=case.get("remat", False),
                         schedule=case.get("schedule", "gpipe"))
    torch.sum(out ** 2).backward()
    s = _stage_index(mesh)
    return {"out": numpy(out), "stage": s, "gx": numpy(x.grad),
            "grads": {n: numpy(p.grad[s]) for n, p in params.items()},
            "other_grads_zero": all(bool((torch.cat([p.grad[:s], p.grad[s + 1:]]) == 0).all())
                                    for p in params.values())}


def pipe_vg(case, inputs, mesh):
    params, x, tgt = (tensors(a) for a in inputs)
    loss, grads, gx = pipeline_value_and_grad(STAGES[case["stage"]], params, x, mse_head,
                                              case["n_micro"], targets=tgt, mesh=mesh)
    s = _stage_index(mesh)
    return {"loss": float(loss), "stage": s, "gx": numpy(gx),
            "grads": {n: numpy(g[s]) for n, g in grads.items()}}


def pipe_memory(case, inputs, mesh):
    params = tensors(inputs[0])
    gen = torch.Generator().manual_seed(7)
    out = {}
    for n_micro in case["n_micros"]:
        x = torch.randn(n_micro * 4, 16, generator=gen)
        peaks = {}
        for schedule in ("gpipe", "1f1b"):
            leaves = {n: t.clone().requires_grad_(True) for n, t in params.items()}
            meter = SavedBytes()
            with meter.hooks():
                y = pipeline_apply(two_layer_stage, leaves, x, n_micro, mesh=mesh,
                                   schedule=schedule)
                torch.sum(y ** 2).backward()
            peaks[schedule] = meter.peak
        meter = SavedBytes()
        with meter.hooks():
            pipeline_value_and_grad(two_layer_stage, params, x, square_head, n_micro,
                                    mesh=mesh)
        peaks["interleaved"] = meter.peak
        out[n_micro] = peaks
    return out


def pipe_error(case, inputs, mesh):
    params, x = tensors(inputs[0]), tensors(inputs[1])
    params = {n: t[:case["stages"]] for n, t in params.items()}
    try:
        pipeline_apply(STAGES[case["stage"]], params, x, 2, mesh=mesh,
                       schedule=case.get("schedule", "gpipe"))
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def _pipeline_step(case, world, rank, init_file):
    api.AutoDist.reset_default()
    spec = ResourceSpec(resource_dict={"nodes": [
        {"address": "localhost", "gpus": world, "chief": True}], "mesh": case["mesh"]})
    ad = api.AutoDist(resource_spec=spec, device="cpu", init_method=f"file://{init_file}",
                      world_size=world, rank=rank, timeout_s=GROUP_TIMEOUT_S,
                      mesh_axes=tuple(case["mesh"]))
    return ad.build_pipeline(STAGES[case["stage"]], mse_head, n_microbatches=4,
                             optimizer=OptimizerSpec("sgd", {"learning_rate": case["lr"]}),
                             donate_state=False)


def pipe_step_error(case, inputs, world, rank, init_file):
    params, x, tgt = (tensors(a) for a in inputs)
    step = _pipeline_step(case, world, rank, init_file)
    try:
        step(step.init(params), (x, tgt))
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def train(case, inputs, world, rank, init_file):
    import torch_dist_worker as worker
    from autodist_tpu_torch.models.convert import flatten_params

    spec = ResourceSpec(resource_dict={"nodes": [
        {"address": "localhost", "gpus": world, "chief": True}], "mesh": case["mesh"]})
    ad, step, state, losses, wire, _ = worker.train(
        case, *inputs, resource_spec=spec, init_method=f"file://{init_file}",
        world_size=world, rank=rank, timeout_s=GROUP_TIMEOUT_S, mesh_axes=case["mesh_axes"])
    return {"losses": losses,
            "params": {k: v.numpy().copy() for k, v in
                       flatten_params(step.logical_params(state)).items()},
            "collectives": [counts for counts, _ in wire],
            "predicted": ad.plan.collectives_per_step(bucketed=step.accum == 1),
            "renderings": {n: ad.plan.rendering(n) for n in ad.plan.var_plans}}


def pipe_step(case, inputs, world, rank, init_file):
    params, x, tgt = (tensors(a) for a in inputs)
    step = _pipeline_step(case, world, rank, init_file)
    state = step.init(params)
    ev0 = float(step.evaluate(state, (x, tgt))["loss"])
    state1, m = step(state, (x, tgt))
    one = {n: t.detach().numpy().copy() for n, t in step.logical_params(state1).items()}
    unchanged = all(torch.equal(a, b) for a, b in
                    zip(state.params.values(), step.init(params).params.values()))
    state3, ms = step.run(state1, (x, tgt), case["run_steps"])
    return {"loss": float(m["loss"]), "params": one, "eval0": ev0,
            "run_losses": [float(v) for v in ms["loss"]], "steps": state3.step,
            "eval1": float(step.evaluate(state3, (x, tgt))["loss"]),
            "local_shape": {n: tuple(t.shape) for n, t in state1.params.items()},
            "donated_state_unchanged": unchanged}


def mesh_groups(case, inputs, mesh):
    """This rank's coordinates, the global ranks of its data, seq and pipe
    groups, its shard axes and the ranks of its shard mesh."""
    def ranks(group):
        return [dist.get_global_rank(group, i) for i in range(dist.get_world_size(group))]

    shard = mesh.shard_mesh()
    return {"coords": mesh.coords, "data": ranks(mesh.group), "shard_axes": mesh.shard_axes,
            "shard_mesh": None if shard is None else shard.mesh.tolist(),
            **{ax: ranks(mesh.axis_group(ax)) for ax in ("seq", "pipe")
               if mesh.shape.get(ax, 1) > 1}}


CASES = {"attn": attn, "attn_error": attn_error, "pipe_apply": pipe_apply,
         "pipe_vg": pipe_vg, "pipe_memory": pipe_memory, "pipe_error": pipe_error,
         "mesh_groups": mesh_groups}
#: The kinds that build an AutoDist of their own over the group.
GROUP_CASES = {"pipe_step": pipe_step, "pipe_step_error": pipe_step_error, "train": train}


def main(job_path, rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    pg.join(torch.device("cpu"), f"file://{init_file}", world, rank, GROUP_TIMEOUT_S)
    out = {}
    for case in job["cases"]:
        inputs = job["inputs"][case["inputs"]]
        if case["kind"] in GROUP_CASES:
            out[case["id"]] = GROUP_CASES[case["kind"]](case, inputs, world, rank, init_file)
        else:
            out[case["id"]] = CASES[case["kind"]](case, inputs, mesh_of(case, world))
    pg.leave()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
