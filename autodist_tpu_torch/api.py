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
trains on its rows. ``remat`` rematerialises the forward in the backward
(:func:`_remat`); ``grad_accum_steps`` splits each step into micro-batches
(``kernel/lowering.py``). A strategy that is ``sync=False`` throughout is
routed to the host-driven asynchronous PS (``runtime/async_ps.py``).
``tune``, ``build_inference``, ``build_pipeline``, ``elastic_rebuild``,
fault tolerance and observability are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import functools
import os
from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from autodist_tpu_torch import const
from autodist_tpu_torch.const import ENV
from autodist_tpu_torch.kernel import DistributedTrainStep, GraphTransformer, build_mesh
from autodist_tpu_torch.kernel.lowering import ShardingPlan
from autodist_tpu_torch.model_item import ModelItem, Optimizer, OptimizerSpec
from autodist_tpu_torch.models.convert import map_params
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.runtime import process_group as pg
from autodist_tpu_torch.runtime.async_ps import AsyncPSTrainer
from autodist_tpu_torch.strategy import PSLoadBalancing, Strategy, StrategyBuilder
from autodist_tpu_torch.strategy import StrategyCompiler, from_name
from autodist_tpu_torch.strategy.ir import PSSynchronizer, iter_synchronizers
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.device import resolve_device
from autodist_tpu_torch.utils.retry import wait_until

_default_autodist: Optional["AutoDist"] = None


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
                 timeout_s: float = pg.DEFAULT_TIMEOUT_S):
        global _default_autodist
        if _default_autodist is not None:
            raise RuntimeError("Only one AutoDist instance is supported per process; "
                               "call AutoDist.reset_default() first if you really "
                               "need another.")
        self.device = resolve_device(device)
        self.group = pg.join(self.device, init_method, world_size, rank, timeout_s)
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
                                    group=self.group)
        return self._mesh

    def _build_or_load_strategy(self, model_item: ModelItem) -> Strategy:
        """The chief builds and serializes the strategy (and exports its id
        to child processes); a worker loads the chief's by
        ``AUTODIST_STRATEGY_ID``. In a process group rank 0 builds it and
        the other ranks receive its JSON over the group."""
        if self.group is not None:
            box = [None]
            if torch.distributed.get_rank() == 0:
                strategy = self.strategy_builder.build(model_item, self.resource_spec)
                strategy.serialize()
                box = [strategy.to_json()]
            torch.distributed.broadcast_object_list(box, src=0, group=self.group)
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
              compute_dtype: Optional[str] = None
              ) -> Union[DistributedTrainStep, AsyncPSTrainer]:
        """Capture -> strategy -> compile -> lower. ``optimizer`` is an
        :class:`OptimizerSpec` (default SGD at 0.01) or an
        :class:`Optimizer`; ``compute_dtype="bfloat16"`` casts floating
        params on entry to the loss (master weights stay fp32);
        ``grad_accum_steps=k`` averages ``k`` micro-batches a step;
        ``remat`` is ``True`` or a policy name (:func:`_remat`).
        ``host_offload=True`` keeps every PS variable's parameter and
        optimizer slots on the host between steps (pinned on CUDA),
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
                                    grad_accum_steps=grad_accum_steps)
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

    @property
    def strategy(self) -> Optional[Strategy]:
        return self._strategy

    @property
    def plan(self) -> Optional[ShardingPlan]:
        return getattr(self._built, "plan", None)

    @property
    def model_item(self) -> Optional[ModelItem]:
        return self._model_item
