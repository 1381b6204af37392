"""Elastic restart: rebuild the plan over the surviving ranks, restore the
latest verified snapshot into it (the port's counterpart of the JAX
package's ``ft/elastic.py``).

JAX recompiles its sharded program over the surviving *devices*; the port
runs one process per device, so the survivors are *ranks*. The plan is a
pure function of (strategy, mesh), so elasticity is: derive a fresh
``ResourceSpec`` from the ranks that survived, form their process group
(``dist.new_group(ranks)`` when they are a strict subset of the world, by
the survivors alone), rebuild Strategy → ShardingPlan →
``DistributedTrainStep`` over it, and restore the snapshot through the
Saver's per-rank block reads (``logical_state(restore=True)`` →
``load_logical``). No state migration protocol: a checkpoint holds logical
shapes, which restore into any plan.

- :func:`recompile_on` + :func:`resume_from_snapshot` — the functional
  pieces;
- :class:`ElasticController` — glues a
  :class:`~autodist_tpu_torch.ft.heartbeat.HealthMonitor` to the rebuild:
  peer death flips ``restart_needed``, and ``resume(...)`` performs the
  rebuild and restore in one call.

Losses after an elastic resume match the uninterrupted run when the
global batch is unchanged: the data-parallel degree is not part of the
math (the mean over the global batch is the same sum in another order).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch.distributed as dist

from autodist_tpu_torch.ft.heartbeat import HealthMonitor, PeerState
from autodist_tpu_torch.ft.snapshot import SnapshotManager
from autodist_tpu_torch.kernel import DistributedTrainStep, GraphTransformer, build_mesh
from autodist_tpu_torch.model_item import ModelItem, OptimizerSpec
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.utils import logging


def surviving_resource_spec(ranks: Sequence[int],
                            template: Optional[ResourceSpec] = None
                            ) -> ResourceSpec:
    """The cluster description of the ranks that survived.

    Rank ``r`` is the ``r``-th of ``template.gpu_devices`` (chief first,
    then by address), so each survivor is counted on its node; nodes left
    with none are dropped, and the chief is the node of the lowest
    surviving rank. Without a template the survivors are one local node.
    ``template`` also donates the GPU node model (bandwidths, HBM); its
    ``mesh:`` block named the original size and is dropped.
    """
    ranks = sorted({int(r) for r in ranks})
    if not ranks:
        raise ValueError("no surviving ranks to build a ResourceSpec from")
    if template is None:
        return ResourceSpec(resource_dict={"nodes": [
            {"address": "localhost", "gpus": len(ranks), "chief": True}]})
    table = [d.host_address for d in template.gpu_devices]
    if ranks[-1] >= max(len(table), 1):
        raise ValueError(f"ranks {ranks} exceed the template's {len(table)} devices")
    if not table:                   # a CPU spec: one process stands for one slot
        table = ["localhost"] * (ranks[-1] + 1)
    counts: dict = {}
    for r in ranks:
        counts[table[r]] = counts.get(table[r], 0) + 1
    chief = table[ranks[0]]
    d = template.to_dict()
    d.pop("mesh", None)
    d["nodes"] = [{"address": a, "gpus": n, "chief": a == chief} for a, n in counts.items()]
    return ResourceSpec(resource_dict=d)


def survivors_group(ranks: Sequence[int]):
    """The process group of ``ranks``: the default group when they are all
    of it, a new group of theirs (formed by them alone) when a strict
    subset, ``None`` for a lone process without a group."""
    ranks = sorted({int(r) for r in ranks})
    if not dist.is_initialized():
        if ranks != [0]:
            raise ValueError(f"ranks {ranks} without a process group")
        return None
    if ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(ranks, use_local_synchronization=True)


def recompile_on(
    ranks: Sequence[int],
    loss_fn: Callable,
    params: Any,
    example_batch: Any = None,
    strategy_builder=None,
    optimizer=None,
    mesh_axes: Sequence[str] = ("data",),
    spec_template: Optional[ResourceSpec] = None,
    sparse_names: Sequence[str] = (),
    device=None,
    group=None,
    **step_kwargs,
) -> DistributedTrainStep:
    """Strategy → plan → step over exactly ``ranks`` (called by each of
    them; ``group`` given, or formed by :func:`survivors_group`).

    The same capture → strategy → compile → lower pipeline as
    ``AutoDist.build``, against an explicit survivor list: each survivor
    builds the strategy itself (the builders are deterministic, seeded
    where random), as the JAX package's elastic path does.
    """
    from autodist_tpu_torch.strategy import AllReduce, StrategyCompiler

    spec = surviving_resource_spec(ranks, template=spec_template)
    if group is None:
        group = survivors_group(ranks)
    mesh = build_mesh(spec, device=device, group=group, axes=tuple(mesh_axes))
    builder = strategy_builder or AllReduce()
    if isinstance(optimizer, OptimizerSpec):
        opt_spec, tx = optimizer, optimizer.make()
    elif optimizer is None:
        opt_spec = OptimizerSpec("sgd", {"learning_rate": 0.01})
        tx = opt_spec.make()
    else:
        opt_spec, tx = OptimizerSpec("custom"), optimizer
    model_item = ModelItem.from_params(
        params, optimizer_spec=opt_spec, loss_fn=loss_fn,
        example_batch=example_batch, sparse_names=sparse_names,
    )
    strategy = builder.build(model_item, spec)
    compiled = StrategyCompiler(model_item).compile(strategy)
    plan = GraphTransformer(compiled, model_item, mesh).transform()
    logging.info("elastic rebuild: ranks %s, mesh %s, strategy %s",
                 list(ranks), mesh.shape, type(builder).__name__)
    return DistributedTrainStep(plan, loss_fn, tx, **step_kwargs)


def resume_from_snapshot(step: DistributedTrainStep, params: Any,
                         snapshots: SnapshotManager):
    """Fresh-or-restored state for ``step``, from the newest snapshot that
    passes integrity verification (ring fallback on corruption): exactly
    ``DistributedTrainStep.init_or_restore`` with the manager's verified
    restore plugged in. Each rank reads only its blocks."""
    return step.init_or_restore(params, restore_fn=snapshots.restore_latest_valid)


class ElasticController:
    """Failure detection → recompile → restore.

    Wraps a :class:`HealthMonitor` (peer death sets ``restart_needed``)
    and a :class:`SnapshotManager`; :meth:`resume` rebuilds over the ranks
    the caller says survived (default: this process and every peer the
    monitor does not hold dead) and re-points the manager at their group.
    """

    def __init__(self, monitor: Optional[HealthMonitor],
                 snapshots: SnapshotManager):
        self.monitor = monitor
        self.snapshots = snapshots
        self.restart_needed = False
        if monitor is not None:
            monitor.on_transition(self._on_transition)

    def _on_transition(self, pid: int, old: PeerState, new: PeerState) -> None:
        if new is PeerState.DEAD:
            logging.warning("peer %d declared dead; flagging elastic restart", pid)
            self.restart_needed = True

    def survivors(self):
        """This process and every peer the monitor does not hold dead (all
        ranks of the world without a monitor)."""
        world = dist.get_world_size() if dist.is_initialized() else 1
        if self.monitor is None:
            return list(range(world))
        dead = {pid for pid, p in self.monitor.peers().items()
                if p.state is PeerState.DEAD}
        return [r for r in range(world) if r not in dead]

    def resume(
        self,
        loss_fn: Callable,
        params: Any,
        example_batch: Any = None,
        ranks: Optional[Sequence[int]] = None,
        **recompile_kwargs,
    ) -> Tuple[DistributedTrainStep, Any]:
        """(rebuilt step, restored-or-fresh state) over the surviving ranks.
        Clears ``restart_needed``."""
        ranks = list(ranks) if ranks is not None else self.survivors()
        if recompile_kwargs.get("group") is None:
            recompile_kwargs["group"] = survivors_group(ranks)
        step = recompile_on(ranks, loss_fn, params, example_batch, **recompile_kwargs)
        self.snapshots.set_group(recompile_kwargs["group"])
        state = resume_from_snapshot(step, params, self.snapshots)
        self.restart_needed = False
        return step, state
