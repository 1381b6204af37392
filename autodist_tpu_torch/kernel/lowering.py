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
PS, per-shard configs, host offload and gradient accumulation.

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


def _stack(values):
    """Per-step metrics -> one leading step axis (dicts leaf by leaf)."""
    if isinstance(values[0], dict):
        return {k: _stack([v[k] for v in values]) for k in values[0]}
    return torch.stack(values)


class DistributedTrainStep:
    """The train step users call like a single-device step."""

    def __init__(self, plan: ShardingPlan, loss_fn: Callable, optimizer: Optimizer,
                 has_aux: bool = False, grad_accum_steps: int = 1):
        if grad_accum_steps != 1:
            raise _not_ported(f"grad_accum_steps={grad_accum_steps}")
        self.plan = plan
        self.loss_fn = loss_fn
        self.tx = optimizer
        self.has_aux = has_aux

    def _to_device(self, tree):
        dev = self.plan.device
        if isinstance(tree, dict):
            return map_params(lambda t: t.to(dev, non_blocking=True), tree)
        return tree.to(dev, non_blocking=True)

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

    def _step(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        leaves = [t for t in flatten_params(state.params).values() if t.is_floating_point()]
        out = self.loss_fn(state.params, batch)
        loss, aux = out if self.has_aux else (out, None)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        with torch.no_grad():
            updates = self.tx.update(grads, state.opt_state, leaves)
            for p, u in zip(leaves, updates):
                p.add_(u.to(p.dtype))
        metrics = {"loss": loss.detach()}
        if aux is not None:
            metrics["aux"] = map_params(lambda t: t.detach(), aux) \
                if isinstance(aux, dict) else aux.detach()
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
                b = map_params(lambda t: t[i], batch) if isinstance(batch, dict) else batch[i]
            state, m = self._step(state, b)
            history.append(m)
        return state, _stack(history)

    def evaluate(self, state: TrainState, batch):
        """Loss (+aux) on a batch without gradients or state mutation."""
        with torch.no_grad():
            out = self.loss_fn(state.params, self._to_device(batch))
        if self.has_aux:
            loss, aux = out
            return {"loss": loss, "aux": aux}
        return {"loss": out}
