"""Strategy lowering: Strategy IR -> plan -> train step (PyTorch port of
``kernel/lowering.py``).

The JAX package lowers each variable's synchronizer to ``NamedSharding``s
over a mesh and lets XLA insert the collectives. This slice runs on one
device, where every rendering the JAX package has collapses to the same
thing: AllReduce and PS variables alike take the plain update (gradient of
the loss, optimizer, new parameters), exactly what the JAX package's program
computes on a one-device mesh. What needs more than one device, or is not
ported yet, raises ``NotImplementedError`` naming ROADMAP.md instead of
training as something else: a mesh of more than one device, gradient
compressors, bucketing, ``shard_update`` (ZeRO-1), staleness, asynchronous
PS, per-shard configs and host offload.

Gradient accumulation (``grad_accum_steps=k``) follows the JAX core: every
batched leaf ``[B, ...]`` splits into ``k`` micro-batches of ``B/k`` rows
(``ValueError`` when ``k`` does not divide ``B``), a broadcast leaf (rank 0
or leading dim at most 1) goes to every micro-step whole, and the loss, the
gradients and the aux average as ``a + x/k`` from zeros (the aux in at least
fp32). The JAX package scans over the micro-batches; here it is a Python
loop, each micro-step's activations freed by its backward before the next.

:class:`DistributedTrainStep` keeps the JAX step's interface: ``init``,
``__call__``, ``run(state, batch, num_steps, stacked=False)`` (a Python
loop here, returning per-step stacked losses), ``evaluate`` and
``logical_params``. Where JAX donates the train state to the compiled step,
the port updates the state's parameter and optimizer tensors in place
under ``torch.no_grad()``: the state passed in is consumed, and the one
returned holds the same (updated) tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, Tuple

import torch

from autodist_tpu_torch.kernel.mesh import Mesh
from autodist_tpu_torch.model_item import ModelItem, Optimizer, VarItem
from autodist_tpu_torch.models.convert import flatten_params, map_params
from autodist_tpu_torch.strategy.base import check_staleness_supported, check_sync_supported
from autodist_tpu_torch.strategy.ir import (
    AllReduceSynchronizer,
    NodeConfig,
    PSSynchronizer,
    Strategy,
)


class SyncKind(Enum):
    ALL_REDUCE = "all_reduce"
    PS = "ps"


@dataclass
class VarPlan:
    """Resolved per-variable lowering decision (on one device: which
    synchronizer the strategy chose, all of them lowered to the plain
    update)."""

    var: VarItem
    kind: SyncKind
    reduction_destination: str = ""


@dataclass
class TrainState:
    """Train state: step count, nested params dict, optimizer state."""

    step: int
    params: Any
    opt_state: Any


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; see ROADMAP.md")


class GraphTransformer:
    """Lower a compiled Strategy over a mesh into a :class:`ShardingPlan`."""

    def __init__(self, strategy: Strategy, model_item: ModelItem, mesh: Mesh,
                 host_offload: bool = False):
        if host_offload:
            raise _not_ported("host_offload")
        self.strategy = strategy
        self.model_item = model_item
        self.mesh = mesh

    def transform(self) -> "ShardingPlan":
        if self.mesh.size > 1:
            raise _not_ported(f"lowering onto a {self.mesh.size}-device mesh "
                              "(multi-device runtime)")
        if self.strategy.graph_config.bucket_bytes > 0:
            raise _not_ported("gradient bucketing (bucket_bytes > 0)")
        plans: Dict[str, VarPlan] = {}
        for node in self.strategy.node_config:
            var = self.model_item.var(node.var_name)
            plans[var.name] = self._lower_node(node, var)
        # Non-trainable variables: replicated, no strategy node.
        for var in self.model_item.variables:
            plans.setdefault(var.name, VarPlan(var=var, kind=SyncKind.ALL_REDUCE))
        return ShardingPlan(mesh=self.mesh, var_plans=plans)

    @staticmethod
    def _lower_node(node: NodeConfig, var: VarItem) -> VarPlan:
        if node.part_config:
            raise _not_ported(f"per-shard part_config ({var.name})")
        sync = node.synchronizer
        if isinstance(sync, AllReduceSynchronizer):
            if sync.compressor != "NoneCompressor":
                raise _not_ported(f"gradient compressor {sync.compressor} ({var.name})")
            if sync.shard_update:
                raise _not_ported(f"shard_update / ZeRO-1 ({var.name})")
            return VarPlan(var=var, kind=SyncKind.ALL_REDUCE)
        if not isinstance(sync, PSSynchronizer):
            raise TypeError(f"unknown synchronizer {type(sync).__name__}")
        check_sync_supported(sync.sync)
        check_staleness_supported(sync.staleness)
        return VarPlan(var=var, kind=SyncKind.PS,
                       reduction_destination=sync.reduction_destination)


@dataclass
class ShardingPlan:
    """The lowered strategy: mesh + per-variable plans."""

    mesh: Mesh
    var_plans: Dict[str, VarPlan]

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]

    def plan_for(self, name: str) -> VarPlan:
        return self.var_plans[name]

    def describe(self) -> str:
        lines = [f"ShardingPlan(mesh={self.mesh.shape}, device={self.device})"]
        for name, p in self.var_plans.items():
            dest = f" dest={p.reduction_destination}" if p.reduction_destination else ""
            lines.append(f"  {name}: {p.kind.value}{dest}")
        return "\n".join(lines)


def _is_broadcast(t) -> bool:
    """The JAX package's ``is_broadcast_leaf``: rank 0 or leading dim <= 1."""
    return t.dim() == 0 or t.shape[0] <= 1


def _zeros_at_least_f32(t):
    return torch.zeros(t.shape, dtype=torch.promote_types(t.dtype, torch.float32),
                       device=t.device)


class DistributedTrainStep:
    """The train step users call like a single-device step."""

    def __init__(self, plan: ShardingPlan, loss_fn: Callable, optimizer: Optimizer,
                 has_aux: bool = False, grad_accum_steps: int = 1):
        if grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
        self.plan = plan
        self.loss_fn = loss_fn
        self.tx = optimizer
        self.has_aux = has_aux
        self.accum = grad_accum_steps

    def _to_device(self, tree):
        dev = self.plan.device
        return map_params(lambda t: t.to(dev, non_blocking=True), tree)

    def init(self, params) -> TrainState:
        """The initial state on the plan's device. Copies the params, so the
        in-place updates never touch the caller's tensors."""
        dev = self.plan.device

        def copy(t):
            t = t.detach().to(dev, copy=True)
            return t.requires_grad_(True) if t.is_floating_point() else t

        params = map_params(copy, params)
        leaves = [t for t in flatten_params(params).values() if t.is_floating_point()]
        return TrainState(step=0, params=params, opt_state=self.tx.init(leaves))

    def logical_params(self, state: TrainState):
        """The user-shaped parameter view of a train state (detached)."""
        return map_params(lambda t: t.detach(), state.params)

    def _grads(self, params, leaves, batch):
        """``(loss, aux, grads)`` of one (micro-)batch."""
        out = self.loss_fn(params, batch)
        loss, aux = out if self.has_aux else (out, None)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss, aux, [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]

    def _accumulated_grads(self, params, leaves, batch):
        """``(loss, aux, grads)`` averaged over ``accum`` micro-batches (the
        JAX package's ``_accumulated_grads`` + ``_scan_accumulate``)."""
        k = self.accum
        for t in (flatten_params(batch).values() if isinstance(batch, dict) else [batch]):
            if not _is_broadcast(t) and t.shape[0] % k:
                raise ValueError(
                    f"grad_accum_steps={k} requires every batched leaf's leading dim "
                    f"to be divisible by {k}; got shape {tuple(t.shape)}")

        def cut(t, i):
            rows = t.shape[0] // k
            return t if _is_broadcast(t) else t[i * rows:(i + 1) * rows]

        loss_acc = torch.zeros((), dtype=torch.float32, device=self.plan.device)
        grads_acc = [torch.zeros_like(p) for p in leaves]
        aux_acc = None
        for i in range(k):
            micro = map_params(lambda t: cut(t, i), batch)
            loss, aux, grads = self._grads(params, leaves, micro)
            with torch.no_grad():
                loss_acc = loss_acc + loss.detach() / k
                grads_acc = [a + g / k for a, g in zip(grads_acc, grads)]
                if aux is not None:
                    if aux_acc is None:
                        aux_acc = map_params(_zeros_at_least_f32, aux)
                    aux_acc = map_params(lambda a, x: a + x.detach() / k, aux_acc, aux)
        return loss_acc, aux_acc, grads_acc

    def loss_and_grads(self, state: TrainState, batch):
        """``(loss, aux, grads)`` of one step on ``batch`` without updating
        the state: ``grads`` in the order of the floating leaves of
        ``flatten_params(state.params)``, averaged over ``grad_accum_steps``
        micro-batches."""
        leaves = [t for t in flatten_params(state.params).values() if t.is_floating_point()]
        batch = self._to_device(batch)
        if self.accum > 1:
            return self._accumulated_grads(state.params, leaves, batch)
        return self._grads(state.params, leaves, batch)

    def _step(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        leaves = [t for t in flatten_params(state.params).values() if t.is_floating_point()]
        loss, aux, grads = self.loss_and_grads(state, batch)
        with torch.no_grad():
            updates = self.tx.update(grads, state.opt_state, leaves)
            for p, u in zip(leaves, updates):
                p.add_(u.to(p.dtype))
        metrics = {"loss": loss.detach()}
        if aux is not None:
            metrics["aux"] = map_params(lambda t: t.detach(), aux)
        return TrainState(state.step + 1, state.params, state.opt_state), metrics

    def __call__(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        return self._step(state, self._to_device(batch))

    def run(self, state: TrainState, batch, num_steps: int, stacked: bool = False):
        """``num_steps`` train steps. ``stacked=False``: ``batch`` is reused
        every step; ``stacked=True``: every batch leaf has a leading
        ``num_steps`` axis, one slice per step. Returns ``(state, metrics)``
        with per-step stacked metric leaves (``metrics["loss"].shape ==
        (num_steps,)``)."""
        batch = self._to_device(batch)
        leaves = flatten_params(batch).values() if isinstance(batch, dict) else [batch]
        if stacked and any(t.dim() < 1 or t.shape[0] != num_steps for t in leaves):
            raise ValueError(f"stacked=True requires every batch leaf to have leading "
                             f"dim num_steps={num_steps}")
        history = []
        for i in range(num_steps):
            b = batch
            if stacked:
                b = map_params(lambda t: t[i], batch)
            state, m = self._step(state, b)
            history.append(m)
        # Per-step metrics -> one leading step axis, leaf by leaf.
        return state, map_params(lambda *steps: torch.stack(steps), *history)

    def evaluate(self, state: TrainState, batch):
        """Loss (+aux) on a batch without gradients or state mutation."""
        with torch.no_grad():
            out = self.loss_fn(state.params, self._to_device(batch))
        if self.has_aux:
            loss, aux = out
            return {"loss": loss, "aux": aux}
        return {"loss": out}
