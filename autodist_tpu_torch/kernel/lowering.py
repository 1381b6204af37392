"""Strategy lowering: Strategy IR -> plan -> train step (PyTorch port of
``kernel/lowering.py``).

The JAX step is one SPMD program: each variable's synchronizer lowers to a
sharding over the mesh and GSPMD inserts the collectives. The port runs one
process per device on ``torch.distributed`` and issues them itself. Rank
``r`` of ``n`` (the data axis) takes rows block ``r`` of the global batch
(a broadcast leaf, of rank 0 or leading dim at most 1, goes whole to every
rank; a batched leaf ``n`` does not divide raises), computes its local mean
loss and gradients, and syncs each variable by its plan
(:meth:`ShardingPlan.rendering`):

- **replicated** (AllReduce, a sparse or PS variable no axis of which
  divides, any variable at ``n == 1``): mean all-reduce of the gradient,
  the full update on every rank;
- **zero1** (``shard_update`` active, or dense PS with a proxy): the
  parameter stays replicated; its gradient is reduce-scattered (mean)
  along ``update_dim``, this rank's slice updated with slice-shaped
  optimizer slots, and the new values all-gathered;
- **sharded** (dense PS without a proxy, partitioned variables, row-sharded
  sparse tables): the state holds this rank's block along ``storage_dim``
  of the (zero-padded) storage; it is all-gathered to the logical view
  before the forward, the gradient is reduce-scattered and the block
  updated in place. Padded entries get zero gradients and stay zero.

The JAX step has two semantics, and the port keeps both. Without ZeRO-1
or buckets it is one GSPMD program, where every reduction over the batch
is global: the port then reduces BatchNorm's statistics over the group
(``runtime.process_group.batch_stats_over``). With either, JAX runs its
manual ``shard_map`` sync, where the loss is taken per shard: BatchNorm's
statistics stay local. A loss whose normaliser depends on the rows (a
masked mean) is averaged over ranks in both, where the GSPMD program
normalises over the whole batch (ROADMAP.md, Queue 3).

Gradient buckets (``bucket_bytes > 0``) sync from hooks inside the
backward (``kernel/bucketing.py``); they are off under gradient
accumulation, as in the JAX package. Every collective of the step is
counted by purpose and kind (``step.coll.counts``; the last step's in
``step.last_collectives``), and the plan predicts the gradient and
parameter wire (:meth:`ShardingPlan.collectives_per_step`).

Gradient accumulation (``grad_accum_steps=k``) splits each step into ``k``
micro-batches and averages loss, gradients and aux as ``a + x/k`` from
zeros; as in JAX, the GSPMD semantics cut the global batch into micro
batches and give each rank its block of each, the manual one cuts each
rank's block. ``init`` broadcasts the caller's parameters from rank 0.

The synchronizer's options:

- **compressors** (``AllReduce(compressor=...)``, ``kernel/compressor.py``):
  a variable that is not sharded over the data axis syncs through its
  compressor's ``step`` (a sharded one ignores it, with a warning, as
  JAX does). Any active compressor puts the step into the manual
  semantics. ``state.comp_state[name]`` holds ``{"local": ..., "shared":
  ...}``: this rank's own EF residual (JAX keeps the ranks' residuals under
  a leading data-axis dimension) and the state every rank shares
  (PowerSGD's ``q``, broadcast from rank 0 at ``init``);
- **bounded staleness** (PS ``staleness=K``): ``state.stale_state[name]``
  is a zero-filled ``[K, ...]`` buffer shaped like the gradient the
  optimizer sees on this rank; the optimizer gets the synced gradient of
  exactly K steps ago (zeros for the first K steps), as in JAX;
- **host offload** (``GraphTransformer(host_offload=True |
  "from_strategy")``): an offloaded variable's parameter and optimizer
  slots live on the host between steps, in pinned memory when the step
  runs on CUDA (pinning that fails raises). The step copies them to the
  device (``non_blocking``), computes and updates there, copies the
  results back into the same host tensors and returns once the copies are
  complete. On ``device="cpu"`` the host is the device: the plan keeps
  JAX's flags (as when JAX's gate passes) and the step streams between two
  CPU tensors. JAX's own gate turns offload off with a warning off the
  TPU; the port does not.

Asynchronous PS (``sync=False``) has no rendering in this step: lowering it
raises, and ``AutoDist.build`` routes it to ``runtime/async_ps.py``. The
expert and model axes raise ``NotImplementedError`` naming ROADMAP.md.

:class:`DistributedTrainStep` keeps the JAX step's interface: ``init``,
``__call__``, ``run(state, batch, num_steps, stacked=False)`` (a Python
loop here, returning per-step stacked losses), ``evaluate`` and
``logical_params``. Where JAX donates the train state to the compiled step,
the port updates the state's tensors in place under ``torch.no_grad()``:
the state passed in is consumed, and the one returned holds the same
(updated) tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.kernel import bucketing
from autodist_tpu_torch.kernel.compressor import Compressor, get_compressor
from autodist_tpu_torch.kernel.degrade import is_active_compressor, zero1_degradation_reasons
from autodist_tpu_torch.kernel.mesh import Mesh
from autodist_tpu_torch.model_item import ModelItem, Optimizer, VarItem
from autodist_tpu_torch.models.convert import (
    flatten_params, map_params, map_tree, tree_leaves)
from autodist_tpu_torch.runtime import process_group as pg
from autodist_tpu_torch.strategy.base import check_sync_supported
from autodist_tpu_torch.strategy.ir import (
    AllReduceSynchronizer,
    NodeConfig,
    PSSynchronizer,
    Strategy,
)
from autodist_tpu_torch.utils import logging


class SyncKind(Enum):
    ALL_REDUCE = "all_reduce"
    PS = "ps"


@dataclass
class VarPlan:
    """Resolved per-variable lowering decision. ``storage_dim`` is the axis
    the parameter itself is sharded on over the data axis (the JAX plan's
    ``pspec``), ``update_dim`` the axis of its optimizer slots and update
    (``update_pspec``); ``None`` is replicated. ``storage_shape`` is the
    zero-padded shape when no axis divides (``None``: the logical shape)."""

    var: VarItem
    kind: SyncKind
    storage_dim: Optional[int] = None
    update_dim: Optional[int] = None
    compressor: str = "NoneCompressor"
    group: int = 0
    staleness: int = 0
    reduction_destination: str = ""
    local_replication: bool = False
    num_shards: int = 1
    shard_destinations: Tuple[str, ...] = ()
    storage_shape: Optional[Tuple[int, ...]] = None
    shard_update: bool = False
    degradations: Tuple[str, ...] = ()
    offload: bool = False

    @property
    def shape(self) -> Tuple[int, ...]:
        """The stored (padded) shape."""
        return tuple(self.storage_shape or self.var.shape)


@dataclass
class TrainState:
    """Train state: step count, nested params dict (a sharded variable's
    leaf is this rank's block), optimizer state, compressor state
    (``{var: {"local": ..., "shared": ...}}``, this rank's) and staleness
    buffers (``{var: [K, ...]}``); the last two are empty when unused."""

    step: int
    params: Any
    opt_state: Any
    comp_state: Dict[str, Any] = field(default_factory=dict)
    stale_state: Dict[str, torch.Tensor] = field(default_factory=dict)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; see ROADMAP.md")


def _pspec(rank: int, dim: Optional[int], axis: str) -> str:
    """The JAX ``PartitionSpec`` string of a one-axis sharding."""
    entries = [None] * rank if dim is not None else []
    if dim is not None:
        entries[dim] = axis
    return f"PartitionSpec{tuple(entries)!r}"


def _is_float(dtype: str) -> bool:
    return dtype.startswith(("float", "bfloat"))


def _itemsize(dtype: str) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


def _is_cpu_device(dest: str) -> bool:
    """True when a device string (``host:TYPE:index``) names a host CPU; an
    unparseable one reads as not a CPU, as in the JAX package."""
    try:
        _, kind, index = dest.rsplit(":", 2)
        int(index)
    except ValueError:
        return False
    return kind == "CPU"


class GraphTransformer:
    """Lower a compiled Strategy over a mesh into a :class:`ShardingPlan`,
    rule for rule as the JAX package's ``_lower_node``. ``host_offload``:
    ``False`` (never), ``True`` (every PS variable) or ``"from_strategy"``
    (the PS variables whose node or shard reduction destination is a host
    CPU); see the module docstring for what the step does with it."""

    OFFLOAD_MODES = (False, True, "from_strategy")

    def __init__(self, strategy: Strategy, model_item: ModelItem, mesh: Mesh,
                 host_offload: "bool | str" = False):
        if host_offload not in self.OFFLOAD_MODES:
            raise ValueError(f"host_offload={host_offload!r}: expected one of "
                             f"{self.OFFLOAD_MODES}")
        self.strategy = strategy
        self.model_item = model_item
        self.mesh = mesh
        self.host_offload = host_offload

    def transform(self) -> "ShardingPlan":
        wide = {ax: d for ax, d in self.mesh.shape.items()
                if ax not in (self.mesh.data_axis, const.MESH_AXIS_EXPERT) and d > 1}
        if wide:
            raise _not_ported(f"lowering onto mesh axes {wide} (tensor parallelism)")
        plans: Dict[str, VarPlan] = {}
        for node in self.strategy.node_config:
            var = self.model_item.var(node.var_name)
            plans[var.name] = self._lower_node(node, var)
        for var in self.model_item.variables:
            plans.setdefault(var.name, VarPlan(var=var, kind=SyncKind.ALL_REDUCE))
        return ShardingPlan(mesh=self.mesh, var_plans=plans,
                            bucket_bytes=int(self.strategy.graph_config.bucket_bytes or 0))

    @staticmethod
    def _fold_part_config(node: NodeConfig) -> dict:
        """Fold per-shard configs into the one wire of the variable: the
        synchronizer kind, sync, staleness, proxy and compressor must be
        uniform across shards (else ``ValueError``) and a uniform value
        overrides the node's (a default compressor or a ``False``
        ``shard_update`` defers to the node); PS shard destinations become
        the plan's ``shard_destinations``."""
        parts = node.part_config
        folded: dict = {}
        if not parts:
            return folded
        if len(parts) != node.num_shards:
            raise ValueError(f"{node.var_name!r}: {len(parts)} part configs but "
                             f"partitioner {node.partitioner!r} implies {node.num_shards}")
        kinds = {type(p.synchronizer) for p in parts} | {type(node.synchronizer)}
        if len(kinds) > 1:
            raise ValueError(f"{node.var_name!r}: per-shard synchronizers mix "
                             f"{sorted(k.__name__ for k in kinds)}; shards of one "
                             "variable share a single gradient wire")

        def uniform(field_name: str):
            vals = {getattr(p.synchronizer, field_name) for p in parts}
            if len(vals) > 1:
                raise ValueError(f"{node.var_name!r}: per-shard {field_name} differs "
                                 f"across shards ({sorted(map(str, vals))}); one "
                                 f"variable has one gradient wire")
            return vals.pop()

        if isinstance(node.synchronizer, PSSynchronizer):
            if not uniform("sync"):
                check_sync_supported(False)
            folded["staleness"] = uniform("staleness")
            folded["proxy"] = uniform("local_replication")
            folded["shard_destinations"] = tuple(p.synchronizer.reduction_destination
                                                 for p in parts)
        else:
            part_comp = uniform("compressor")
            if part_comp != "NoneCompressor":
                folded["compressor"] = part_comp
            if uniform("shard_update"):
                folded["shard_update"] = True
        return folded

    def _lower_node(self, node: NodeConfig, var: VarItem) -> VarPlan:
        sync = node.synchronizer
        rank = len(var.shape)
        folded = self._fold_part_config(node)
        if isinstance(sync, AllReduceSynchronizer):
            kind = SyncKind.ALL_REDUCE
            compressor, group = folded.get("compressor", sync.compressor), sync.group
            staleness, dest, proxy = 0, "", False
            shard_update = folded.get("shard_update", sync.shard_update)
        elif isinstance(sync, PSSynchronizer):
            check_sync_supported(sync.sync)
            kind = SyncKind.PS
            compressor, group = "NoneCompressor", 0
            staleness = folded.get("staleness", sync.staleness)
            dest = sync.reduction_destination
            proxy = folded.get("proxy", sync.local_replication)
            shard_update = False
        else:
            raise TypeError(f"unknown synchronizer {type(sync).__name__}")

        n = self.mesh.data_size
        n_expert = self.mesh.shape.get(const.MESH_AXIS_EXPERT, 1)

        def divisible(axis: int) -> bool:
            return var.shape[axis] % n == 0 and var.shape[axis] >= n

        def padded(axis: int) -> Tuple[int, ...]:
            shape = list(var.shape)
            shape[axis] = -(-shape[axis] // n) * n
            return tuple(shape)

        storage_shape = None
        part_axis = node.active_partition_axis
        fallback = self._fallback_axis(var, n)
        if var.expert and rank > 0 and n_expert > 1 and var.shape[0] % n_expert == 0:
            raise _not_ported(f"expert-axis sharding ({var.name})")
        if part_axis is not None and rank > 0 and divisible(part_axis):
            storage_dim = update_dim = part_axis
        elif part_axis is not None and rank > 0 and fallback is not None:
            storage_dim = update_dim = fallback
        elif part_axis is not None and rank > 0 and var.shape[part_axis] > n:
            storage_shape = padded(part_axis)
            storage_dim = update_dim = part_axis
        elif var.sparse_update and rank > 0 and divisible(0):
            storage_dim = update_dim = 0
        elif var.sparse_update and rank > 0 and var.shape[0] > n:
            storage_shape = padded(0)
            storage_dim = update_dim = 0
        elif kind is SyncKind.PS and rank > 0:
            # Dense PS: with a proxy the parameter stays replicated and the
            # update shards (ZeRO-1); without one it is sharded (ZeRO-3).
            update_dim = self._weight_update_dim(var)
            storage_dim = None if proxy else update_dim
        elif kind is SyncKind.ALL_REDUCE and shard_update and rank > 0:
            storage_dim, update_dim = None, self._weight_update_dim(var)
        else:
            storage_dim = update_dim = None

        su_active, degradations = False, ()
        if kind is SyncKind.ALL_REDUCE and shard_update:
            degradations = zero1_degradation_reasons(
                var.shape, sparse_update=var.sparse_update, expert=var.expert,
                part_axis=part_axis, compressor=compressor, n_data=n,
                n_model=self.mesh.shape.get(const.MESH_AXIS_MODEL, 1), n_expert=n_expert)
            su_active = not degradations
            structural = storage_dim is None and update_dim is not None
            if su_active != (structural and "compressed" not in degradations):
                raise RuntimeError(f"var {var.name!r}: zero1 rendering (storage_dim="
                                   f"{storage_dim}, update_dim={update_dim}) disagrees "
                                   f"with degradation reasons {degradations!r}")
            if structural and "compressed" in degradations:
                # The compressor syncs the whole gradient: no reduce-scatter
                # to render, so the update stays replicated (as in JAX).
                logging.warning("var %s: shard_update ignored — compressor %s syncs "
                                "the full gradient (no reduce-scatter rendering); "
                                "optimizer state stays replicated for this var",
                                var.name, compressor)
                update_dim = None
            elif degradations:
                logging.debug("var %s: shard_update has no effect (%s)", var.name,
                              ", ".join(degradations))
        shard_dests = folded.get("shard_destinations", ())
        offload = False
        if kind is SyncKind.PS and self.host_offload == "from_strategy":
            # The shard table, where there is one, decides; an empty entry
            # falls back to the node's destination.
            dests = [d or dest for d in shard_dests] if shard_dests else [dest]
            offload = any(_is_cpu_device(d) for d in dests if d)
        elif kind is SyncKind.PS and self.host_offload:
            offload = True
        return VarPlan(var=var, kind=kind, storage_dim=storage_dim, update_dim=update_dim,
                       compressor=compressor, group=group, staleness=staleness,
                       reduction_destination=dest, local_replication=proxy,
                       num_shards=node.num_shards, shard_destinations=shard_dests,
                       storage_shape=storage_shape, shard_update=su_active,
                       degradations=degradations, offload=offload)

    @staticmethod
    def _fallback_axis(var: VarItem, n: int) -> Optional[int]:
        """Largest axis ``n`` divides evenly, or None."""
        cands = [i for i, d in enumerate(var.shape) if d % n == 0 and d >= n]
        return max(cands, key=lambda i: var.shape[i]) if cands else None

    def _weight_update_dim(self, var: VarItem) -> Optional[int]:
        """Largest axis the data axis divides, else None (replicated)."""
        n = self.mesh.data_size
        if n <= 1 or not var.shape:
            return None
        return self._fallback_axis(var, n)


def _block(t: torch.Tensor, dim: int, n: int, r: int) -> torch.Tensor:
    """Block ``r`` of ``n`` of ``t`` along ``dim`` (a view)."""
    k = t.shape[dim] // n
    return t.narrow(dim, r * k, k)


def _is_broadcast(t) -> bool:
    """The JAX package's ``is_broadcast_leaf``: rank 0 or leading dim <= 1."""
    return t.dim() == 0 or t.shape[0] <= 1


def _rows(t, n: int, r: int, what: str = "global batch"):
    """Rows block ``r`` of ``n`` of a batched leaf (a broadcast leaf whole)."""
    if _is_broadcast(t) or n == 1:
        return t
    if t.shape[0] % n:
        raise ValueError(f"{what} dim {t.shape[0]} not divisible by data-parallel "
                         f"degree {n}")
    return _block(t, 0, n, r)


def _map_named(fn: Callable, params, prefix: str = ""):
    """``fn(name, leaf)`` over nested params, nesting and key order kept."""
    if not isinstance(params, dict):
        return fn(prefix, params)
    return {k: _map_named(fn, v, f"{prefix}/{k}" if prefix else str(k))
            for k, v in params.items()}


@dataclass
class ShardingPlan:
    """The lowered strategy: mesh + per-variable plans + bucket target."""

    mesh: Mesh
    var_plans: Dict[str, VarPlan]
    bucket_bytes: int = 0

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def plan_for(self, name: str) -> VarPlan:
        return self.var_plans[name]

    @property
    def has_offload(self) -> bool:
        return any(p.offload for p in self.var_plans.values())

    def compressors(self, warn: bool = False) -> Dict[str, Compressor]:
        """Variable name -> its compressor, for the variables whose strategy
        asks for an active one and that are not sharded over the data axis
        (the JAX step's ``_resolve_compressors``; the others sync as their
        rendering says, with a warning when ``warn``)."""
        out = {}
        for name, p in self.var_plans.items():
            if not is_active_compressor(p.compressor):
                continue
            if p.storage_dim is not None:
                if warn:
                    logging.warning(
                        "compressor %s on %s ignored: var is sharded over the data axis "
                        "(sparse/ZeRO path has no gradient all-reduce to compress). "
                        "NOTE: with any compressor active this var enters the compressed "
                        "grad region replicated, so its sync pays full-size (table-scale) "
                        "wire — avoid compressors on embedding-heavy AllReduce models",
                        p.compressor, name)
                continue
            out[name] = get_compressor(p.compressor)
        return out

    def rendering(self, name: str) -> Tuple[str, Optional[int]]:
        """How the step syncs a variable: ``("replicated", None)``,
        ``("zero1", update_dim)`` or ``("sharded", storage_dim)``. A data
        axis of one renders every variable replicated (nothing to shard)."""
        p = self.var_plans.get(name)
        if p is None or self.mesh.data_size == 1:
            return "replicated", None
        if p.storage_dim is not None:
            return "sharded", p.storage_dim
        if p.update_dim is not None:
            return "zero1", p.update_dim
        return "replicated", None

    def bucket_assignment(self) -> Tuple[Tuple[str, ...], ...]:
        """The buckets of the eligible variables (``kernel/bucketing.py``):
        reverse model order, greedy fill to ``bucket_bytes``."""
        if self.bucket_bytes <= 0:
            return ()
        sized = []
        for name, p in self.var_plans.items():
            if bucketing.plan_exclusion_reasons(p):
                continue
            elems = 1
            for d in (p.shape or (1,)):
                elems *= int(d)
            sized.append((name, elems * _itemsize(p.var.dtype)))
        return bucketing.assign_buckets(sized, self.bucket_bytes)

    def pad(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A logical leaf zero-padded to its plan's storage shape."""
        p = self.var_plans.get(name)
        if p is None or p.storage_shape is None or tuple(t.shape) != tuple(p.var.shape):
            return t
        pads = []
        for d, s in zip(reversed(p.storage_shape), reversed(p.var.shape)):
            pads += [0, d - s]
        return torch.nn.functional.pad(t, pads)

    def unpad(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A storage leaf sliced back to its logical shape."""
        p = self.var_plans.get(name)
        if p is None or p.storage_shape is None or tuple(t.shape) != tuple(p.storage_shape):
            return t
        for dim, s in enumerate(p.var.shape):
            t = t.narrow(dim, 0, s)
        return t

    def pad_params(self, params):
        """Logical -> storage view of a params tree."""
        return _map_named(self.pad, params)

    def unpad_params(self, params):
        """Storage -> logical view of a params tree (the model's shapes)."""
        return _map_named(self.unpad, params)

    def local_batch(self, batch):
        """This rank's rows: block ``rank`` along dim 0 of every batched
        leaf (the JAX plan's ``batch_shardings``, ``P("data")`` on dim 0);
        a non-divisible batched leaf raises."""
        n, r = self.mesh.data_size, self.mesh.rank
        return map_tree(lambda t: _rows(t, n, r), batch)

    def global_batch_from_local(self, local_batch, broadcast=None):
        """The global batch from each rank's rows (for a loader that
        already holds this rank's slice): batched leaves all-gathered along
        dim 0 in rank order, broadcast leaves (``broadcast``, a tree of bools
        of the batch's nesting; default: local leading dim <= 1) whole."""
        coll = pg.Collectives(self.mesh.group)
        flags = iter(tree_leaves(broadcast)) if broadcast is not None else None

        def leaf(t):
            bcast = next(flags) if flags is not None else _is_broadcast(t)
            if bcast or t.dim() == 0:
                return t
            return coll.all_gather(t.contiguous(), 0, "batch")

        return map_tree(leaf, local_batch)

    def collectives_per_step(self, bucketed: bool = True) -> Dict[str, int]:
        """The gradient and parameter wire one step issues, by kind: a mean
        all-reduce per replicated variable or bucket of them, a
        reduce-scatter per ZeRO-1 or sharded variable (or bucket of ZeRO-1
        ones), an all-gather per ZeRO-1 variable (new values) and per
        sharded one (its logical view); a compressed variable issues its
        compressor's collectives instead of its all-reduce. The step adds its
        own loss metric, BatchNorm and optimizer reductions under other
        purposes."""
        counts = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0}
        compressors = self.compressors()
        buckets = self.bucket_assignment() if bucketed else ()
        in_bucket = {name for b in buckets for name in b}
        for b in buckets:
            kinds = {self.rendering(name)[0] for name in b}
            counts["all_reduce"] += "replicated" in kinds
            counts["reduce_scatter"] += "zero1" in kinds
        for name, p in self.var_plans.items():
            if not _is_float(p.var.dtype):
                continue
            kind = self.rendering(name)[0]
            if kind != "replicated":
                counts["all_gather"] += 1
            if name in in_bucket:
                continue
            if name in compressors:
                for k, c in compressors[name].collectives(p.var.shape).items():
                    counts[k] += c
                continue
            counts["all_reduce" if kind == "replicated" else "reduce_scatter"] += 1
        return counts

    def describe(self) -> str:
        """One line per variable, in the JAX plan's ``describe`` layout."""
        ax = self.mesh.data_axis
        lines = [f"ShardingPlan(mesh={dict(self.mesh.shape)})"]
        for name, p in self.var_plans.items():
            rank = len(p.var.shape)
            lines.append(
                f"  {name}: {p.kind.value} param={_pspec(rank, p.storage_dim, ax)} "
                f"update={_pspec(rank, p.update_dim, ax)}"
                + (" shard_update=zero1" if p.shard_update else "")
                + (f" dest={p.reduction_destination}" if p.reduction_destination else "")
                + (f" shard_dests={list(p.shard_destinations)}"
                   if p.shard_destinations else "")
                + (" offload=pinned_host" if p.offload else ""))
        return "\n".join(lines)


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
        mesh = plan.mesh
        self.n, self.rank = mesh.data_size, mesh.rank
        self.coll = pg.Collectives(mesh.group)
        if mesh.group is None and self.n > 1:
            raise ValueError(f"a data axis of {self.n} needs a process group")
        if mesh.group is not None and self.coll.size != self.n:
            raise ValueError(f"data axis {self.n} != group size {self.coll.size}")
        self.render = {name: plan.rendering(name) for name in plan.var_plans}
        buckets = plan.bucket_assignment()
        if buckets and grad_accum_steps > 1:
            logging.warning("bucketed grad sync (bucket_bytes=%d) disabled under "
                            "grad_accum_steps=%d: collectives fire once per step, after "
                            "accumulation", plan.bucket_bytes, grad_accum_steps)
            buckets = ()
        self.buckets = buckets
        self.compressors = plan.compressors(warn=True)
        # The JAX step's manual sync (shard_map): per-shard batch statistics.
        self.manual = (bool(buckets) or bool(self.compressors)
                       or any(p.shard_update for p in plan.var_plans.values()))
        self.zero1_dims = {name: d for name, (kind, d) in self.render.items()
                           if kind == "zero1"}
        self._sharded = any(kind == "sharded" for kind, _ in self.render.values())
        self.stale = {name: p.staleness for name, p in plan.var_plans.items()
                      if p.staleness > 0}
        self.offloaded = {name for name, p in plan.var_plans.items() if p.offload}
        self.last_collectives: Dict[str, Dict[str, int]] = {}

    # ------------------------------------------------------------- helpers
    def _to_device(self, tree):
        dev = self.plan.device
        return map_tree(lambda t: t.to(dev, non_blocking=True), tree)

    def _render(self, name: str) -> Tuple[str, Optional[int]]:
        return self.render.get(name, ("replicated", None))

    def _floating(self, params) -> List[Tuple[str, torch.Tensor]]:
        return [(n, t) for n, t in flatten_params(params).items() if t.is_floating_point()]

    def _update_view(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The part of a stored leaf this rank updates: a ZeRO-1 variable's
        block, else the stored tensor."""
        kind, d = self._render(name)
        return _block(t, d, self.n, self.rank) if kind == "zero1" else t

    def _layout(self, params) -> List[Optional[Tuple[int, Tuple[int, ...]]]]:
        """Per floating leaf, ``(dim, storage shape)`` when the optimizer
        sees a block of it, else None."""
        out = []
        for name, _ in self._floating(params):
            kind, d = self._render(name)
            out.append(None if kind == "replicated" else (d, self.plan.var_plans[name].shape))
        return out

    def _psum(self, t: torch.Tensor) -> torch.Tensor:
        self.coll.all_reduce(t, "optimizer")
        return t

    # -------------------------------------------------------- host offload
    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of ``t``: pinned when the step runs on CUDA (a
        failure to pin raises); on the CPU device a copy."""
        host = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                           pin_memory=self.plan.device.type == "cuda")
        return host.copy_(t.detach())

    def _to_dev(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.plan.device, non_blocking=True, copy=True)

    def _offload_index(self, params) -> set:
        """Positions of the offloaded leaves among the floating ones (the
        optimizer's per-leaf lists)."""
        return {i for i, (n, _) in enumerate(self._floating(params)) if n in self.offloaded}

    def _offloaded_slots(self, opt_state, fn: Callable, index: set) -> Dict[str, Any]:
        """A shallow copy of ``opt_state`` whose slots of offloaded leaves
        (entry ``i in index`` of every per-leaf list) are ``fn`` of the
        slot."""
        out = dict(opt_state)
        for key, value in opt_state.items():
            if isinstance(value, list):
                out[key] = [map_params(fn, v) if i in index else v
                            for i, v in enumerate(value)]
        return out

    def _stream_params(self, params):
        """The params with each offloaded leaf copied to the device (a
        fresh gradient target)."""
        if not self.offloaded:
            return params

        def leaf(name, t):
            if name not in self.offloaded:
                return t
            t = self._to_dev(t)
            return t.requires_grad_(True) if t.is_floating_point() else t

        return _map_named(leaf, params)

    def _stream_back(self, host: TrainState, params, opt_state, index: set) -> None:
        """The updated device copies into the host tensors of ``host``, and
        the optimizer's count; returns once the copies are complete."""
        dev_params = flatten_params(params)
        for name, t in flatten_params(host.params).items():
            if name in self.offloaded:
                t.copy_(dev_params[name].detach(), non_blocking=True)
        for key, value in opt_state.items():
            if not isinstance(value, list):
                host.opt_state[key] = value
                continue
            for i in index:
                map_params(lambda h, d: h.copy_(d, non_blocking=True),
                           host.opt_state[key][i], value[i])
        if self.plan.device.type == "cuda":
            torch.cuda.current_stream(self.plan.device).synchronize()

    # ---------------------------------------------------------------- init
    def init(self, params) -> TrainState:
        """The initial state on this rank's device: the caller's params
        copied, broadcast from rank 0, sharded variables padded and cut to
        this rank's block. The in-place updates never touch the caller's
        tensors."""
        dev = self.plan.device

        def place(name, t):
            t = t.detach().to(dev).clone(memory_format=torch.contiguous_format)
            self.coll.broadcast(t, "init")
            kind, d = self._render(name)
            if kind == "sharded":
                t = _block(self.plan.pad(name, t), d, self.n, self.rank).contiguous()
            return t.requires_grad_(True) if t.is_floating_point() else t

        params = _map_named(place, params)
        floating = self._floating(params)
        views = [self._update_view(n, t) for n, t in floating]
        opt_state = self.tx.init(views, self._layout(params))
        stale = {n: torch.zeros((self.stale[n],) + tuple(v.shape), dtype=v.dtype, device=dev)
                 for (n, _), v in zip(floating, views) if n in self.stale}
        if self.offloaded:
            opt_state = self._offloaded_slots(opt_state, self._to_host,
                                              self._offload_index(params))
            params = _map_named(
                lambda n, t: self._to_host(t) if n in self.offloaded else t, params)
        return TrainState(step=0, params=params, opt_state=opt_state,
                          comp_state=self._init_comp_state(), stale_state=stale)

    def _init_comp_state(self) -> Dict[str, Any]:
        """Each compressed variable's ``{"local", "shared"}`` state on this
        rank's device; shared state is broadcast from rank 0."""
        dev, out = self.plan.device, {}
        for name, comp in self.compressors.items():
            var = self.plan.var_plans[name].var
            local = {k: t.to(dev) for k, t in comp.init_local(var).items()}
            shared = {k: self.coll.broadcast(t.to(dev).contiguous(), "init")
                      for k, t in comp.init_shared(var).items()}
            out[name] = {"local": local, "shared": shared}
        return out

    def logical_params(self, state: TrainState):
        """The user-shaped parameter view of a train state (detached).
        Sharded variables are all-gathered, so every rank calls it."""
        def view(name, t):
            kind, d = self._render(name)
            t = t.detach()
            if kind == "sharded":
                t = t.to(self.plan.device)
                t = self.plan.unpad(name, self.coll.all_gather(t, d, "view"))
            return t

        return _map_named(view, state.params)

    # ------------------------------------------------------------- forward
    def _forward_params(self, params):
        """``(params for the loss, {name: gradient target})``: a sharded
        variable is all-gathered into a fresh leaf (its target) and sliced
        to its logical shape; the others are their own targets."""
        if not self._sharded:
            return params, dict(self._floating(params))
        targets = {}

        def view(name, t):
            if not t.is_floating_point():
                return t
            kind, d = self._render(name)
            if kind != "sharded":
                targets[name] = t
                return t
            with torch.no_grad():
                full = self.coll.all_gather(t.detach(), d, "param")
            full = full.detach().requires_grad_(True)
            targets[name] = full
            return self.plan.unpad(name, full)

        return _map_named(view, params), targets

    def _grads(self, params, targets, batch):
        """``(loss, aux, {name: gradient})`` of one (micro-)batch, unused
        gradients as zeros."""
        out = self.loss_fn(params, batch)
        loss, aux = out if self.has_aux else (out, None)
        names = list(targets)
        grads = torch.autograd.grad(loss, [targets[n] for n in names], allow_unused=True)
        return loss, aux, {n: torch.zeros_like(targets[n]) if g is None else g
                           for n, g in zip(names, grads)}

    def _micro_batches(self, batch):
        """The ``accum`` micro-batches of this rank, in the JAX step's
        order (see the module docstring)."""
        k, n, r = self.accum, self.n, self.rank
        if k == 1:
            return [self.plan.local_batch(batch)]
        if self.manual:
            local = self.plan.local_batch(batch)
            return [map_tree(lambda t: _rows(t, k, i, "rank batch"), local)
                    for i in range(k)]
        for t in tree_leaves(batch):
            if not _is_broadcast(t) and t.shape[0] % k:
                raise ValueError(
                    f"grad_accum_steps={k} requires every batched leaf's leading dim "
                    f"to be divisible by {k}; got shape {tuple(t.shape)}")
        return [map_tree(lambda t: _rows(_rows(t, k, i), n, r, "micro batch"), batch)
                for i in range(k)]

    def _local_loss_and_grads(self, params, targets, batch, sync=None):
        """``(loss, aux, grads)`` averaged over the micro-batches."""
        stats = None if self.manual else self.coll
        micro = self._micro_batches(batch)
        with pg.batch_stats_over(stats if self.coll.group is not None else None):
            if sync is not None:
                sync.hook(targets)
            if len(micro) == 1:
                return self._grads(params, targets, micro[0])
            k = len(micro)
            loss_acc = torch.zeros((), dtype=torch.float32, device=self.plan.device)
            grads_acc = {n: torch.zeros_like(t) for n, t in targets.items()}
            aux_acc = None
            for mb in micro:
                loss, aux, grads = self._grads(params, targets, mb)
                with torch.no_grad():
                    loss_acc = loss_acc + loss.detach() / k
                    grads_acc = {n: a + grads[n] / k for n, a in grads_acc.items()}
                    if aux is not None:
                        if aux_acc is None:
                            aux_acc = map_params(_zeros_at_least_f32, aux)
                        aux_acc = map_params(lambda a, x: a + x.detach() / k, aux_acc, aux)
            return loss_acc, aux_acc, grads_acc

    def loss_and_grads(self, state: TrainState, batch):
        """``(loss, aux, grads)`` of this rank's rows without syncing or
        updating: ``grads`` in the order of the floating leaves of
        ``flatten_params(state.params)``, with respect to their logical
        (gathered) values, averaged over ``grad_accum_steps``
        micro-batches."""
        params, targets = self._forward_params(self._stream_params(state.params))
        loss, aux, grads = self._local_loss_and_grads(params, targets,
                                                      self._to_device(batch))
        return loss, aux, [grads[n] for n in targets]

    # ---------------------------------------------------------------- step
    def _sync(self, grads: Dict[str, torch.Tensor], done: Dict[str, torch.Tensor],
              comp_state: Dict[str, Any]):
        """Each gradient synced by its rendering or its compressor, in leaf
        order (those in ``done`` came from the buckets); a compressor's new
        state is copied into ``comp_state`` in place."""
        out = {}
        for name, g in grads.items():
            if name in done:
                out[name] = done[name]
                continue
            g = g.contiguous()
            kind, d = self._render(name)
            if name in self.compressors:
                st = comp_state[name]
                out[name], local, shared = self.compressors[name].step(
                    g, st["local"], st["shared"], self.coll)
                for old, new in ((st["local"], local), (st["shared"], shared)):
                    for k, t in new.items():
                        old[k].copy_(t)
            elif kind == "replicated":
                self.coll.all_reduce(g, "grad", mean=True)
                out[name] = g
            else:
                out[name] = self.coll.reduce_scatter(g, d, "grad")
        return out

    def _apply_staleness(self, grads: Dict[str, torch.Tensor],
                         stale_state: Dict[str, torch.Tensor]) -> None:
        """Each stale variable's fresh gradient enters the tail of its
        buffer and the head, computed K steps ago, takes its place."""
        for name, buf in stale_state.items():
            delayed = buf[0].clone()
            buf.copy_(torch.cat([buf[1:], grads[name].unsqueeze(0).to(buf.dtype)]))
            grads[name] = delayed

    def _step(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        before = self.coll.snapshot()
        host, opt_state = state, state.opt_state
        if self.offloaded:
            state = TrainState(state.step, self._stream_params(state.params), opt_state,
                               state.comp_state, state.stale_state)
        params, targets = self._forward_params(state.params)
        sync = None
        if self.buckets and self.coll.group is not None:
            sync = bucketing.BucketSync(self.coll, self.buckets, self.zero1_dims)
        loss, aux, grads = self._local_loss_and_grads(params, targets, batch, sync)
        with torch.no_grad():
            done = sync.finish(targets) if sync is not None else {}
            grads = self._sync(grads, done, state.comp_state)
            if self.stale:
                self._apply_staleness(grads, state.stale_state)
            floating = self._floating(state.params)
            views = [self._update_view(n, t) for n, t in floating]
            if self.offloaded:
                # The slots come over only now, after the backward's peak.
                index = self._offload_index(host.params)
                opt_state = self._offloaded_slots(opt_state, self._to_dev, index)
            updates = self.tx.update([grads[n] for n, _ in floating], opt_state,
                                     views, self._layout(state.params), self._psum)
            for (name, p), v, u in zip(floating, views, updates):
                if self._render(name)[0] == "zero1":
                    d = self._render(name)[1]
                    p.copy_(self.coll.all_gather(v + u.to(p.dtype), d, "param"))
                else:
                    p.add_(u.to(p.dtype))
            if self.offloaded:
                self._stream_back(host, state.params, opt_state, index)
            loss = loss.detach().clone()
            self.coll.all_reduce(loss, "metric", mean=True)
            metrics = {"loss": loss}
            if aux is not None:
                metrics["aux"] = map_params(self._mean_metric, aux)
        after = self.coll.snapshot()
        self.last_collectives = {
            p: {k: v - before.get(p, {}).get(k, 0) for k, v in kinds.items()
                if v - before.get(p, {}).get(k, 0)}
            for p, kinds in after.items()}
        self.last_collectives = {p: k for p, k in self.last_collectives.items() if k}
        return TrainState(host.step + 1, host.params, host.opt_state, host.comp_state,
                          host.stale_state), metrics

    def _mean_metric(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if self.coll.group is None:
            return t
        t = t.clone() if t.is_floating_point() else t.to(torch.float32)
        self.coll.all_reduce(t.contiguous(), "metric", mean=True)
        return t

    def __call__(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        return self._step(state, self._to_device(batch))

    def run(self, state: TrainState, batch, num_steps: int, stacked: bool = False):
        """``num_steps`` train steps. ``stacked=False``: ``batch`` (the
        global batch) is reused every step; ``stacked=True``: every batch
        leaf has a leading ``num_steps`` axis, one slice per step. Returns
        ``(state, metrics)`` with per-step stacked metric leaves
        (``metrics["loss"].shape == (num_steps,)``)."""
        batch = self._to_device(batch)
        if stacked and any(t.dim() < 1 or t.shape[0] != num_steps
                           for t in tree_leaves(batch)):
            raise ValueError(f"stacked=True requires every batch leaf to have leading "
                             f"dim num_steps={num_steps}")
        history = []
        for i in range(num_steps):
            b = map_tree(lambda t: t[i], batch) if stacked else batch
            state, m = self._step(state, b)
            history.append(m)
        return state, map_params(lambda *steps: torch.stack(steps), *history)

    def evaluate(self, state: TrainState, batch):
        """Loss (+aux) on a global batch without gradients or state
        mutation: each rank's rows where the batch divides (then averaged
        over ranks, BatchNorm over the group), else the whole batch on every
        rank."""
        batch = self._to_device(batch)
        try:
            local, split = self.plan.local_batch(batch), self.n > 1
        except ValueError:
            local, split = batch, False
        with torch.no_grad():
            params, _ = self._forward_params(self._stream_params(state.params))
            with pg.batch_stats_over(self.coll if split else None):
                out = self.loss_fn(params, local)
        loss, aux = out if self.has_aux else (out, None)
        if split:
            loss = self._mean_metric(loss)
            aux = map_params(self._mean_metric, aux) if aux is not None else None
        return {"loss": loss, "aux": aux} if self.has_aux else {"loss": loss}
