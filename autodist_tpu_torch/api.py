"""User API: the ``AutoDist`` entry point (PyTorch port of ``api.py``).

Usage, as with the JAX package::

    from autodist_tpu_torch.api import AutoDist
    from autodist_tpu_torch.strategy import AllReduce

    autodist = AutoDist(strategy_builder=AllReduce())      # device="cuda"
    step = autodist.build(loss_fn, params, example_batch)
    state = step.init(params)
    state, metrics = step.run(state, batch, num_steps=10)

``build`` is capture -> strategy -> compile -> lower: a :class:`ModelItem`
of the params (sparse-update parameters found by a meta-tensor trace of the
loss), the strategy from the builder (built and serialized to
``const.DEFAULT_STRATEGY_DIR`` by the chief, loaded by id by a worker),
pruned and validated by the :class:`StrategyCompiler`, lowered by the
:class:`GraphTransformer` into the :class:`DistributedTrainStep`. One
AutoDist per process; the default builder is ``PSLoadBalancing``. It runs on
``cuda`` unless ``device="cpu"`` is passed; asking for CUDA without it
raises.

Several processes, one per device, train as one: started by
``torchrun`` (or ``python -m torch.distributed.run``), or given
``init_method``, ``world_size`` and ``rank``, each ``AutoDist`` joins the
``torch.distributed`` group (``runtime/process_group.py``: NCCL on
``cuda:LOCAL_RANK``, gloo on the CPU, never the one in place of the other)
and builds its mesh over it; rank 0 builds the strategy and the others
receive it over the group. Each rank then calls the step with the same
global batch (or assembles it with ``plan.global_batch_from_local``) and
trains on its rows. A ``mesh:`` block (over ``mesh_axes``, default
``("data", "model")`` as in JAX) may make any mix of ``data``, ``model``,
``expert``, ``seq`` and ``pipe`` wider than 1 (``kernel/mesh.py``): the
variables the plan puts on the model or expert axis (``TensorParallel``'s
Megatron pairs, the MoE's experts under ``expert_names``) are sharded and
the forward runs on ``DTensor``s (``kernel/lowering.py``); every zoo model
trains so, the CNNs' convolutions on split weights through ``local_map``
(``models/layers.py``). ``remat`` rematerialises the forward in the backward
(:func:`_remat`); ``grad_accum_steps`` splits each step into micro-batches
(``kernel/lowering.py``). A strategy that is ``sync=False`` throughout is
routed to the host-driven asynchronous PS (``runtime/async_ps.py``).
``build_inference`` builds a serving engine on the same device (paged
decode, the one-shot ``apply_fn`` forward, or both), from a checkpoint if
asked.

``strategy_builder="Auto"`` lets the cost model choose the builder from
the model and the resource spec's GPU node model
(``strategy/auto_strategy.py``); :meth:`AutoDist.tune` measures instead:
it trains each candidate of the slate for a few windows on the device,
keeps the fastest and fits the cost model's calibration to the times
(and the planner's per-topology one). ``strategy_builder="plan"`` searches
the per-variable strategy space instead, with a persistent plan cache
(``plan/``).
``fault_tolerance=FTConfig(...)`` gives ``autodist.ft`` (``ft/``: a
started heartbeat monitor, the snapshot ring and its preemption hook);
:meth:`AutoDist.elastic_rebuild` rebuilds over the surviving ranks' group
and restores the newest verified snapshot into it. A process started by
the port's launcher (``runtime/launcher.py``) joins the group from the
environment it sets. :meth:`AutoDist.build_pipeline` trains a stacked stage
stack over the mesh's ``pipe`` axis (``parallel/pipeline.py``); a ``seq``
axis carries the transformer's ring or Ulysses attention
(``parallel/ring_attention.py``). ``observability=ObsConfig(...)`` gives
``autodist.obs`` (``obs/config.py``: spans, the metrics file, the flight
recorder and the sentry, the cross-process aggregator, and
``autodist.obs.profiler(step)`` for the live MFU); ``build(record_norms=
True)`` adds the global gradient and update norms to the step's metrics.
"""
from __future__ import annotations

import contextlib
import datetime
import functools
import math
import os
import time
from typing import TYPE_CHECKING, Any, Callable, Optional, Sequence, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from autodist_tpu_torch import const
from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.kernel import DistributedTrainStep, GraphTransformer, build_mesh
from autodist_tpu_torch.kernel.lowering import ShardingPlan
from autodist_tpu_torch.model_item import ModelItem, Optimizer, OptimizerSpec
from autodist_tpu_torch.models.convert import map_params, map_tree, to_tensor
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime import process_group as pg
from autodist_tpu_torch.runtime.async_ps import AsyncPSTrainer
from autodist_tpu_torch.strategy import PSLoadBalancing, Strategy, StrategyBuilder
from autodist_tpu_torch.strategy import StrategyCompiler, from_name
from autodist_tpu_torch.strategy.ir import PSSynchronizer, iter_synchronizers
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.retry import wait_until

if TYPE_CHECKING:
    from autodist_tpu_torch.ft import FTConfig, FTRuntime
    from autodist_tpu_torch.obs import ObsConfig, ObsRuntime

_default_autodist: Optional["AutoDist"] = None


def get_default_autodist() -> Optional["AutoDist"]:
    """The AutoDist of this process, if one was made."""
    return _default_autodist


def resolve_mesh(mesh=None, need: Optional[str] = None):
    """``mesh``, else the default AutoDist's mesh; None without either, or a
    ValueError naming ``need`` when it is given."""
    if mesh is None and _default_autodist is not None:
        mesh = _default_autodist.mesh
    if mesh is None and need is not None:
        raise ValueError(f"{need} needs a mesh: pass mesh= or construct an AutoDist first")
    return mesh


#: Timed windows a ``tune()`` candidate runs after its warm-up window.
_TUNE_TRIAL_WINDOWS = 4


def _cast_compute(loss_fn: Callable, compute_dtype: str) -> Callable:
    """Mixed precision: floating params enter the loss in ``compute_dtype``
    while the state stays fp32; autograd through the cast brings the
    gradients back to the params' dtype."""
    dtype = getattr(torch, compute_dtype)
    if not dtype.is_floating_point:
        raise ValueError(f"compute_dtype must be floating, got {compute_dtype!r}")

    def wrapped(params, batch):
        return loss_fn(map_params(
            lambda t: t.to(dtype) if t.is_floating_point() else t, params), batch)

    return wrapped


_aten = torch.ops.aten
_MATMULS = (_aten.mm.default, _aten.addmm.default)
_DOTS = _MATMULS + (_aten.bmm.default, _aten.convolution.default)
#: The JAX package's ``jax.checkpoint_policies`` names -> the aten ops whose
#: outputs the policy saves (``None``: every op). ``True`` saves nothing.
_REMAT_SAVED = {
    "nothing_saveable": (),
    "everything_saveable": None,
    "dots_saveable": _DOTS,
    "checkpoint_dots": _DOTS,
    "dots_with_no_batch_dims_saveable": _MATMULS,
    "checkpoint_dots_with_no_batch_dims": _MATMULS,
}


def _remat_contexts(saved):
    """``context_fn`` of ``torch.utils.checkpoint``: save the outputs of the
    ops in ``saved`` (every op when ``None``), recompute the rest."""
    def policy(ctx, op, *args, **kwargs):
        keep = saved is None or op in saved
        return CheckpointPolicy.MUST_SAVE if keep else CheckpointPolicy.PREFER_RECOMPUTE
    return create_selective_checkpoint_contexts(policy)


def _remat(loss_fn: Callable, remat: Union[bool, str]) -> Callable:
    """The loss under ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``:
    the backward runs the forward again instead of keeping its activations
    (the JAX package's ``jax.checkpoint(loss_fn, policy=...)``). ``True``
    and ``"nothing_saveable"`` save nothing; ``"everything_saveable"``
    saves every op's output; ``"dots_saveable"`` and ``"checkpoint_dots"``
    save the outputs of ``aten.mm``, ``aten.addmm``, ``aten.bmm`` and
    ``aten.convolution`` (JAX's policy saves ``dot_general`` and
    ``conv_general_dilated``); the two ``*_no_batch_dims`` policies save
    ``mm`` and ``addmm`` but neither ``bmm`` nor a convolution (JAX's dots
    without batch dims). The hand-written kernels'
    ``autograd.Function``s (flash attention, fused conv-stats) are not aten
    ops, so every policy runs them again. Anything else raises
    ``ValueError``, as in the JAX package."""
    if remat is True:
        saved = ()
    elif isinstance(remat, str) and remat in _REMAT_SAVED:
        saved = _REMAT_SAVED[remat]
    else:
        raise ValueError(f"unknown remat policy {remat!r}; use True or one of "
                         f"{tuple(_REMAT_SAVED)}")
    context_fn = noop_context_fn if saved == () else (lambda: _remat_contexts(saved))

    @functools.wraps(loss_fn)
    def wrapped(params, batch):
        return checkpoint(loss_fn, params, batch, use_reentrant=False,
                          context_fn=context_fn)

    return wrapped


def _resolve_optimizer(optimizer):
    """(OptimizerSpec, Optimizer): a spec is made; ``None`` is SGD at 0.01
    (the JAX package's default); an :class:`Optimizer` is taken as given."""
    if isinstance(optimizer, OptimizerSpec):
        return optimizer, optimizer.make()
    if optimizer is None:
        spec = OptimizerSpec("sgd", {"learning_rate": 0.01})
        return spec, spec.make()
    return OptimizerSpec("custom"), optimizer


class AutoDist:
    """Distributed-training entry point bound to one cluster description."""

    def __init__(self, resource_spec_file: Optional[str] = None,
                 strategy_builder: Union[StrategyBuilder, str, None] = None,
                 resource_spec: Optional[ResourceSpec] = None, device=None,
                 init_method: Optional[str] = None, world_size: Optional[int] = None,
                 rank: Optional[int] = None,
                 timeout_s: float = pg.DEFAULT_TIMEOUT_S,
                 mesh_axes: Sequence[str] = ("data", "model"),
                 fault_tolerance: "Optional[FTConfig]" = None,
                 observability: "Optional[ObsConfig]" = None):
        global _default_autodist
        if _default_autodist is not None:
            raise RuntimeError("Only one AutoDist instance is supported per process; "
                               "call AutoDist.reset_default() first if you really "
                               "need another.")
        # A launcher's AUTODIST_* contract completes the torchrun variables
        # pg.join reads (no-op for a single process or under torchrun).
        from autodist_tpu_torch.runtime.launcher import initialize_from_env

        initialize_from_env()
        self.device = resolve_device(device)
        self.mesh_axes = tuple(mesh_axes)
        self.group = pg.join(self.device, init_method, world_size, rank, timeout_s)
        self._timeout_s = float(timeout_s)
        self._handoffs = 0  # strategy handoffs over the group (tune's agreement)
        world = torch.distributed.get_world_size(self.group) if self.group is not None else 1
        if self.group is not None:
            self.device = pg.local_device(self.device, torch.distributed.get_rank())
        if resource_spec is not None:
            self.resource_spec = resource_spec
        elif resource_spec_file:
            self.resource_spec = ResourceSpec(resource_spec_file)
        elif ENV.AUTODIST_RESOURCE_SPEC.val:
            self.resource_spec = ResourceSpec(ENV.AUTODIST_RESOURCE_SPEC.val)
        else:
            self.resource_spec = ResourceSpec.from_local_devices(self.device, world)
        if isinstance(strategy_builder, str):
            strategy_builder = from_name(strategy_builder)
        self.strategy_builder = strategy_builder or PSLoadBalancing()
        self._mesh = None
        self._built: Optional[DistributedTrainStep] = None
        self._strategy: Optional[Strategy] = None
        self._model_item: Optional[ModelItem] = None
        self.last_tune_results: Optional[dict] = None
        # Fault tolerance: a started HealthMonitor + SnapshotManager bundle
        # over this process's group, or None when the knob is off.
        self.ft: "Optional[FTRuntime]" = None
        if fault_tolerance is not None:
            from autodist_tpu_torch.ft import FTRuntime

            self.ft = FTRuntime(fault_tolerance, group=self.group)
        # Observability: spans, exporters, the flight recorder and sentry,
        # cross-process aggregation; None when the knob is off.
        self.obs: "Optional[ObsRuntime]" = None
        if observability is not None:
            from autodist_tpu_torch.obs import ObsRuntime

            self.obs = ObsRuntime(observability)
            if self.ft is not None:
                # Straggler scores and sentry findings escalate through the
                # ft HealthMonitor.
                self.obs.attach_monitor(self.ft.monitor)
        _default_autodist = self

    @classmethod
    def reset_default(cls) -> None:
        """Allow another AutoDist in this process (tests)."""
        global _default_autodist
        _default_autodist = None

    @property
    def mesh(self):
        if self._mesh is None:
            self._mesh = build_mesh(self.resource_spec, device=self.device,
                                    group=self.group, axes=self.mesh_axes)
        return self._mesh

    @property
    def is_chief(self) -> bool:
        """True in the chief (strategy-building) process."""
        return const.is_chief_process()

    def _build_or_load_strategy(self, model_item: ModelItem) -> Strategy:
        """The chief builds and serializes the strategy (and exports its id
        to child processes); a worker loads the chief's by
        ``AUTODIST_STRATEGY_ID``. In a process group rank 0 builds it and
        the other ranks receive its JSON over the group (nothing when the
        chief's builder raised: then every rank raises)."""
        if self.group is not None:
            box, failure = [None], None
            if torch.distributed.get_rank() == 0:
                try:
                    strategy = self.strategy_builder.build(model_item, self.resource_spec)
                    strategy.serialize()
                    box = [strategy.to_json()]
                except Exception as e:  # noqa: BLE001 - every rank raises, below
                    failure = e
            torch.distributed.broadcast_object_list(box, src=0, group=self.group)
            self._handoffs += 1
            if failure is not None:
                raise failure
            if box[0] is None:
                raise RuntimeError("the chief's strategy builder raised (see its log)")
            return Strategy.from_json(box[0])
        if const.is_chief_process():
            strategy = self.strategy_builder.build(model_item, self.resource_spec)
            strategy.serialize()
            os.environ[ENV.AUTODIST_STRATEGY_ID.name] = strategy.id
            return strategy
        strategy_id = ENV.AUTODIST_STRATEGY_ID.val
        if not strategy_id:
            raise RuntimeError("AUTODIST_WORKER is set but AUTODIST_STRATEGY_ID is empty: "
                               "workers must be launched with the chief's strategy id")
        path = os.path.join(const.DEFAULT_STRATEGY_DIR, strategy_id)
        if not wait_until(lambda: os.path.exists(path), 60.0, interval_s=0.2):
            raise FileNotFoundError(f"strategy {strategy_id!r} not found at {path}")
        return Strategy.deserialize(strategy_id)

    def build(self, loss_fn: Callable, params: Any, example_batch: Any = None,
              optimizer: Union[OptimizerSpec, Optimizer, None] = None,
              has_aux: bool = False, sparse_names: Sequence[str] = (),
              expert_names: Sequence[str] = (), host_offload: Union[bool, str] = False,
              grad_accum_steps: int = 1, remat: Union[bool, str] = False,
              compute_dtype: Optional[str] = None, record_norms: bool = False
              ) -> Union[DistributedTrainStep, AsyncPSTrainer]:
        """Capture -> strategy -> compile -> lower. ``optimizer`` is an
        :class:`OptimizerSpec` (default SGD at 0.01) or an
        :class:`Optimizer`; ``compute_dtype="bfloat16"`` casts floating
        params on entry to the loss (master weights stay fp32);
        ``grad_accum_steps=k`` averages ``k`` micro-batches a step;
        ``remat`` is ``True`` or a policy name (:func:`_remat`);
        ``record_norms=True`` adds the global gradient and update L2 norms
        to every step's metrics (``grad_norm``, ``update_norm``: the flight
        recorder's and the sentry's signals). ``host_offload=True`` keeps
        every PS variable's parameter and optimizer slots on the host
        between steps (pinned on CUDA),
        ``"from_strategy"`` those whose reduction destination is a host CPU
        (``kernel/lowering.py``). A ``sync=False`` strategy returns an
        :class:`AsyncPSTrainer`, whose ``run(state, next_batch, n_pushes)``
        takes a batch source instead of one batch."""
        opt_spec, tx = _resolve_optimizer(optimizer)
        model_item = ModelItem.from_params(
            params, optimizer_spec=opt_spec, loss_fn=loss_fn, example_batch=example_batch,
            sparse_names=sparse_names, expert_names=expert_names)
        strategy = self._build_or_load_strategy(model_item)
        compiled = StrategyCompiler(model_item).compile(strategy)
        if compute_dtype is not None:
            # After capture: sparse detection traces the bare loss_fn.
            loss_fn = _cast_compute(loss_fn, compute_dtype)
        trainer = self._maybe_build_async(compiled, model_item, loss_fn, tx, has_aux=has_aux,
                                          host_offload=host_offload,
                                          grad_accum_steps=grad_accum_steps, remat=remat)
        if trainer is not None:
            return trainer
        plan = GraphTransformer(compiled, model_item, self.mesh,
                                host_offload=host_offload).transform()
        logging.debug("sharding plan:\n%s", plan.describe())
        if remat:
            # After capture and the cast, as in the JAX package.
            loss_fn = _remat(loss_fn, remat)
        step = DistributedTrainStep(plan, loss_fn, tx, has_aux=has_aux,
                                    grad_accum_steps=grad_accum_steps,
                                    record_norms=record_norms)
        self._built, self._strategy, self._model_item = step, compiled, model_item
        return step

    def _maybe_build_async(self, compiled: Strategy, model_item: ModelItem,
                           loss_fn: Callable, tx: Optimizer, *, has_aux, host_offload,
                           grad_accum_steps, remat) -> Optional[AsyncPSTrainer]:
        """The :class:`AsyncPSTrainer` of a strategy whose every node is an
        asynchronous PS (``None`` when none is): one worker a replica,
        staleness the largest of the nodes'. A strategy that mixes sync and
        async nodes, or async with ``host_offload``, ``grad_accum_steps`` or
        ``remat``, raises as in the JAX package."""
        async_nodes = [n for n in compiled.node_config
                       if any(isinstance(s, PSSynchronizer) and not s.sync
                              for s in iter_synchronizers(n))]
        if not async_nodes:
            return None
        if len(async_nodes) != len(compiled.node_config):
            raise NotImplementedError(
                "strategies mixing sync and async synchronizers have no rendering: "
                "under the host-driven async loop every variable's update applies "
                "per push. Make the strategy uniformly sync or uniformly async "
                "(sync=False).")
        unsupported = [name for name, on in (("host_offload", host_offload),
                                             ("grad_accum_steps", grad_accum_steps != 1),
                                             ("remat", remat)) if on]
        if unsupported:
            raise NotImplementedError(
                f"async PS (sync=False) does not compose with {', '.join(unsupported)}; "
                f"these knobs belong to the synchronous lowering path.")
        staleness = max((s.staleness for n in async_nodes for s in iter_synchronizers(n)
                         if isinstance(s, PSSynchronizer)), default=0)
        n_workers = max(1, len(compiled.graph_config.replicas))
        trainer = AsyncPSTrainer(loss_fn, tx, n_workers=n_workers, staleness=staleness,
                                 has_aux=has_aux, device=self.device)
        self._built, self._strategy, self._model_item = trainer, compiled, model_item
        logging.info("sync=False strategy: routed to host-driven AsyncPSTrainer "
                     "(%d workers, staleness=%d)", n_workers, staleness)
        return trainer

    # ------------------------------------------------------------- pipeline
    def build_pipeline(self, stage_fn: Callable, loss_head: Callable, n_microbatches: int,
                       optimizer: Union[OptimizerSpec, Optimizer, None] = None,
                       donate_state: bool = True):
        """Pipeline-parallel train step over this AutoDist's mesh, the
        counterpart of :meth:`build` for stage-stack models
        (``stage_fn(stage_params, h) -> h`` shape-preserving, params given
        stacked ``[S, ...]`` to ``init``): a
        :class:`~autodist_tpu_torch.parallel.PipelineTrainStep` running the
        interleaved 1F1B loop over the mesh's ``pipe`` axis while the batch
        splits over ``data``."""
        from autodist_tpu_torch.parallel import PipelineTrainStep

        _, tx = _resolve_optimizer(optimizer)
        return PipelineTrainStep(stage_fn, loss_head, tx, n_microbatches, mesh=self.mesh,
                                 donate_state=donate_state)

    # -------------------------------------------------------------- elastic
    def elastic_rebuild(self, loss_fn: Callable, params: Any, example_batch: Any = None,
                        ranks: Optional[Sequence[int]] = None,
                        optimizer: Union[OptimizerSpec, Optimizer, None] = None,
                        **recompile_kwargs):
        """Elastic restart onto the SURVIVING ranks (called by each of
        them): re-derive the resource spec from the ranks still alive
        (default: those the heartbeat monitor does not hold dead), form
        their group, rebuild Strategy → plan → step over it, and restore
        the newest integrity-verified snapshot into it (``ft/elastic.py``;
        requires ``fault_tolerance=FTConfig(...)``).

        Returns ``(step, state)``. This AutoDist's ``resource_spec``,
        ``group`` and ``mesh`` are re-pointed at the survivors, so later
        ``build`` calls plan for the cluster the restored state lives on."""
        if self.ft is None:
            raise RuntimeError("elastic_rebuild needs fault tolerance enabled: construct "
                               "AutoDist(fault_tolerance=FTConfig(...))")
        from autodist_tpu_torch.ft.elastic import surviving_resource_spec, survivors_group

        ranks = list(ranks) if ranks is not None else self.ft.elastic.survivors()
        group = survivors_group(ranks)
        recompile_kwargs.setdefault("mesh_axes", self.mesh_axes)
        step, state = self.ft.elastic.resume(
            loss_fn, params, example_batch, ranks=ranks,
            strategy_builder=self.strategy_builder, optimizer=optimizer,
            spec_template=self.resource_spec, device=self.device, group=group,
            **recompile_kwargs)
        self.resource_spec = surviving_resource_spec(ranks, template=self.resource_spec)
        self.group = group
        self._mesh = step.plan.mesh
        self._built = step
        return step, state

    # ----------------------------------------------------------------- tune
    def tune(self, loss_fn: Callable, params: Any, example_batch: Any,
             candidates: Optional[Sequence] = None, window: int = 8,
             calibration_path: Optional[str] = None, **build_kwargs
             ) -> DistributedTrainStep:
        """Measured strategy selection: build each candidate (default: the
        slate of ``Auto`` plus Parallax, ``cost_model.candidate_slate``),
        run one warm-up window and then ``_TUNE_TRIAL_WINDOWS`` (4) windows
        of ``window`` training steps on the device with one synchronize at
        the end, and keep the fastest. A candidate that fails to build or
        run is skipped with a warning. The (predicted, measured) pairs fit a
        :class:`~autodist_tpu_torch.strategy.cost_model.Calibration`, which
        the chief writes (``calibration_path``, default the port's working
        directory) for ``explain``.

        In a process group every rank times every candidate in lockstep
        (the steps' collectives keep the ranks together), and after each
        one the ranks agree on how it went over a gloo group of the sweep's
        own, which no step collective can pair with. A candidate that every
        rank refused after the strategy handoff and before its step (the
        chief's builder raised, or the strategy does not lower) is skipped
        on every rank. A failure anywhere else (one rank out of memory in
        its steps, say) may leave the ranks' collectives out of step, so
        the sweep stops there on every rank with a ``RuntimeError``: peers
        held in a collective of the failed candidate reach the agreement
        when the group's timeout ends that collective (NCCL's watchdog may
        end the process instead). The chief's times decide and it
        broadcasts the winner's index, so every rank builds the same
        winner. ``last_tune_results`` holds the table, the calibration and
        each candidate's measured seconds (``inf``: failed) with the one
        selected; the sweep is also recorded in the metrics registry and
        the span timeline (:meth:`_record_tune_obs`)."""
        from autodist_tpu_torch.strategy.cost_model import CostModel, candidate_slate

        candidates = list(candidates) if candidates is not None else candidate_slate()
        side = None
        if self.group is not None:
            self.mesh  # noqa: B018 - its subgroups form here, before any candidate
            side = torch.distributed.new_group(
                backend="gloo", timeout=datetime.timedelta(seconds=2 * self._timeout_s))
        results, predicted, best = [], {}, None
        try:
            for name, builder in candidates:
                self.strategy_builder = builder
                step = state = failure = None
                handoffs = self._handoffs
                try:
                    step = self.build(loss_fn, params, example_batch, **build_kwargs)
                    batch = step._to_device(example_batch)
                    state = step.init(params)
                    state, _ = step.run(state, batch, window)
                    self._sync_device()
                    t0 = time.perf_counter()
                    for _ in range(_TUNE_TRIAL_WINDOWS):
                        state, _ = step.run(state, batch, window)
                    self._sync_device()
                    dt = (time.perf_counter() - t0) / (_TUNE_TRIAL_WINDOWS * window)
                except Exception as e:  # noqa: BLE001 - candidate-level isolation
                    failure = e
                finally:
                    state = None  # noqa: F841 - free it before the next candidate
                if side is not None:
                    # 0: ran; 1: refused after the handoff, before any step
                    # collective; 2: failed where peers may wait.
                    code = (0 if failure is None else
                            1 if step is None and self._handoffs > handoffs else 2)
                    why = None if failure is None else f"{type(failure).__name__}: {failure}"[:300]
                    every = [None] * torch.distributed.get_world_size(side)
                    torch.distributed.all_gather_object(every, (code, why), group=side)
                    codes = [c for c, _ in every]
                    if 2 in codes or 0 < codes.count(0) < len(codes):
                        bad = {r: w for r, (c, w) in enumerate(every) if c}
                        raise RuntimeError(
                            f"tune(): candidate {name} failed on rank(s) {bad}; the ranks' "
                            f"collectives may be out of step, so the sweep stops") from failure
                if failure is not None:
                    logging.warning("tune: candidate %s failed (%s); skipped", name, failure)
                    results.append((name, math.inf))
                    continue
                logging.info("tune: %-16s %.3f ms/step", name, dt * 1e3)
                results.append((name, dt))
                try:
                    predicted[name] = CostModel(self._model_item,
                                                self.resource_spec).strategy_cost(self._strategy)
                except Exception:  # noqa: BLE001 - calibration is best-effort
                    pass
                if side is None and (best is None or dt < best[1]):
                    best = (name, dt, builder, step, self._strategy, self._model_item)
                step = None
        finally:
            if side is not None:
                torch.distributed.destroy_process_group(side)
        self._record_calibration(results, predicted, calibration_path)
        if side is not None:
            best_name = self._elect(results)
            self.last_tune_results["selected"] = best_name
            self._record_tune_obs(results, best_name)
            self.strategy_builder = dict(candidates)[best_name]
            return self.build(loss_fn, params, example_batch, **build_kwargs)
        if best is None:
            raise RuntimeError("tune(): every candidate strategy failed to build/run")
        best_name, best_dt, best_builder, best_step, best_strategy, best_item = best
        logging.info("tune selected %s (%.3f ms/step)", best_name, best_dt * 1e3)
        self.last_tune_results["selected"] = best_name
        self._record_tune_obs(results, best_name)
        self.strategy_builder = best_builder
        os.environ[ENV.AUTODIST_STRATEGY_ID.name] = best_strategy.id
        self._built, self._strategy, self._model_item = best_step, best_strategy, best_item
        return best_step

    def _record_tune_obs(self, results, selected: str) -> None:
        """An auditable selection: every candidate's name and measured
        seconds (``inf``: failed) and the winner go into the process's
        metrics registry (``tune_measured_ms_<name>``, ``tune_selected_ms``,
        ``tune_candidates``, ``tune_runs_total``), the span timeline (one
        ``tune.candidate`` span each) and ``last_tune_results["measured"]``
        / ``["selected"]``. Best-effort: it never fails a tune."""
        try:
            from autodist_tpu_torch import metrics as M
            from autodist_tpu_torch.obs import spans

            reg = M.registry
            reg.counter("tune_runs_total").inc()
            reg.gauge("tune_candidates").set(len(results))
            now = time.time()
            for name, dt in results:
                failed = not dt < math.inf
                if not failed:
                    reg.gauge(f"tune_measured_ms_{name}").set(dt * 1e3)
                spans.add_span("tune.candidate", now, 0.0 if failed else dt, candidate=name,
                               failed=failed, selected=name == selected)
            sel_dt = dict(results).get(selected)
            if sel_dt is not None and sel_dt < math.inf:
                reg.gauge("tune_selected_ms").set(sel_dt * 1e3)
            self.last_tune_results = {**(self.last_tune_results or {}),
                                      "measured": dict(results), "selected": selected}
        except Exception:  # noqa: BLE001 - diagnostics must not break tune
            logging.warning("tune: obs audit recording failed", exc_info=True)

    def _sync_device(self) -> None:
        """Wait for the device's queued work (the CPU runs eagerly)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _elect(self, results) -> str:
        """The winner of a sweep over the process group, whose candidates
        ran on every rank or on none: the chief's fastest, its index
        broadcast from the chief."""
        box = [None]
        if torch.distributed.get_rank() == 0:
            valid = [i for i, (_, dt) in enumerate(results) if math.isfinite(dt)]
            box = [min(valid, key=lambda i: results[i][1]) if valid else -1]
        torch.distributed.broadcast_object_list(box, src=0, group=self.group)
        if box[0] < 0:
            raise RuntimeError("tune(): every candidate strategy failed to build/run")
        name = results[box[0]][0]
        logging.info("tune (group) selected %s: chief-measured", name)
        return name

    def _record_calibration(self, results, predicted, path: Optional[str] = None) -> None:
        """Fit measured seconds a step against each timed strategy's
        predicted cost (:class:`Calibration`), the chief writes it, and
        ``last_tune_results`` takes the table. The chief also fits the
        planner's per-topology, per-component calibration from the same
        sweep (``plan/calibrate.py``: one record a timed candidate, saved
        under the port's plan directory) and returns it as
        ``plan_calibration``, so a later ``strategy_builder="plan"`` prices
        this topology; a failure there logs and never fails ``tune``."""
        from autodist_tpu_torch.strategy.cost_model import Calibration

        meas, pred, table = [], [], {}
        for name, dt in results:
            cost = predicted.get(name)
            if cost is None or not math.isfinite(dt):
                continue
            meas.append(dt)
            pred.append(cost.total_s)
            table[name] = {"measured_s": dt, "predicted_s": cost.total_s}
        device = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda"
                  else "cpu")
        calib = Calibration.fit(pred, meas, device=device) if meas else None
        chief = self.group is None or torch.distributed.get_rank() == 0
        saved = calib.save(path) if calib is not None and chief else None
        plan_calib = None
        if chief and meas:
            try:
                from autodist_tpu_torch.plan.calibrate import (
                    CalibrationRecord, calibrate_from_records)

                plan_calib = calibrate_from_records(
                    [CalibrationRecord.from_cost(predicted[n], dt, name=n)
                     for n, dt in results if n in predicted and math.isfinite(dt)],
                    self.resource_spec, device_kind=device)
            except Exception:  # noqa: BLE001 - the planner's feed is optional
                logging.warning("tune: plan calibration recording failed", exc_info=True)
        self.last_tune_results = {"table": table, "calibration": calib,
                                  "calibration_path": saved,
                                  "plan_calibration": plan_calib,
                                  "measured": dict(results)}
        if calib is not None:
            logging.info("tune calibration: measured ≈ %.3fms + %.2f × predicted "
                         "(%d candidates, %s)%s", calib.base_s * 1e3, calib.scale,
                         calib.n_points, device, f" -> {saved}" if saved else "")

    # ------------------------------------------------------------ inference
    def build_inference(self, params: Any, apply_fn: Optional[Callable] = None,
                        decode_model=None, checkpoint: Optional[str] = None,
                        n_slots: int = 8, max_len: Optional[int] = None,
                        page_len: int = 16, n_pages: Optional[int] = None,
                        prefill_chunk: Optional[int] = None, draft_params: Any = None,
                        draft_decode_model=None, draft_checkpoint: Optional[str] = None,
                        spec_k: int = 4, draft_n_pages: Optional[int] = None,
                        prefix_cache: bool = False):
        """An inference engine on this AutoDist's device: the serving
        counterpart of :meth:`build`. The port's engine serves on one
        device with every parameter whole, so no strategy or sharding plan
        is built for it (the JAX package's shards the params over its mesh;
        ``engine.plan`` is the one-device ``AllReduce`` plan, built when
        read).

        ``apply_fn(params, batch)`` enables the one-shot forward
        (``InferenceEngine.infer``); with ``apply_fn`` alone the engine is
        one-shot only. ``decode_model``
        (``models.transformer.decode_model(cfg)``) serves
        autoregressive paged decode behind the continuous batcher: ``n_slots``
        rows over a pool of ``page_len``-token KV pages (``n_pages``, or
        sized from the card's memory), prompts prefilled in
        ``prefill_chunk``-token chunks. ``checkpoint`` restores the params
        from a ``Saver`` checkpoint (a ``ckpt-N`` or Saver directory; a
        training checkpoint's ``params/`` subtree), ``params`` giving names
        and shapes (meta tensors will do). ``draft_params`` +
        ``draft_decode_model`` make it a
        :class:`~autodist_tpu_torch.serve.spec.SpecDecodeEngine`
        (``draft_checkpoint`` restored the same way, ``spec_k`` proposals a
        round, ``draft_n_pages`` pages); ``prefix_cache=True`` shares prompt
        prefixes copy-on-write."""
        from autodist_tpu_torch.serve.engine import InferenceEngine
        from autodist_tpu_torch.serve.spec import SpecDecodeEngine

        if apply_fn is None and decode_model is None:
            raise ValueError("build_inference needs apply_fn (one-shot), decode_model "
                             "(the paged decode adapter, e.g. "
                             "models.transformer.decode_model(cfg)), or both")
        engine_kwargs = dict(n_slots=n_slots, page_len=page_len, n_pages=n_pages,
                             prefill_chunk=prefill_chunk, max_len=max_len,
                             device=self.device, prefix_cache=prefix_cache)
        if draft_params is not None:
            return SpecDecodeEngine.build(params, draft_params, decode_model,
                                          draft_decode_model, checkpoint=checkpoint,
                                          draft_checkpoint=draft_checkpoint, spec_k=spec_k,
                                          draft_n_pages=draft_n_pages, **engine_kwargs)
        return InferenceEngine.build(params, decode_model, apply_fn=apply_fn,
                                     checkpoint=checkpoint, **engine_kwargs)

    @property
    def strategy(self) -> Optional[Strategy]:
        return self._strategy

    @property
    def plan(self) -> Optional[ShardingPlan]:
        return getattr(self._built, "plan", None)

    @property
    def model_item(self) -> Optional[ModelItem]:
        return self._model_item

    def function(self, fn: Callable) -> Callable:
        """Wrap a step function of tensors (the JAX package's
        ``AutoDist.function``). A call before :meth:`build` raises; after
        it, the arguments' tensors (numpy arrays become tensors), nested in
        dicts, lists and tuples, are moved to the plan's device and ``fn``
        runs on them whole. Where JAX shards the arguments over the data
        axis and GSPMD gives every device the replicated result, each rank
        here computes the whole result itself."""
        def wrapper(*args):
            plan = self.plan
            if plan is None:
                raise RuntimeError("call AutoDist.build(...) before .function(...)")
            dev = plan.device
            return fn(*map_tree(lambda t: to_tensor(t).to(dev), args))

        return wrapper

    @contextlib.contextmanager
    def scope(self):
        """The model-definition scope of the JAX package's API: PyTorch
        captures nothing here, so it yields this AutoDist."""
        yield self
