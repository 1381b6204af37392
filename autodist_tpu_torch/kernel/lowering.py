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
  sparse tables under the manual semantics below): the state holds this
  rank's block along ``storage_dim`` of the (zero-padded) storage; it is
  all-gathered to the logical view before the forward, the gradient is
  reduce-scattered and the block updated in place. Padded entries get zero
  gradients and stay zero;
- **sparse** (a sparse-update table split by rows over a data axis larger
  than 1, in the GSPMD semantics, on a mesh without a model or expert
  axis): the state holds this rank's row block as for ``sharded``, but the
  loss gets it as a ``kernel/sparse.py`` ``RowSplitTable``, whose row reads
  move the step's touched rows (all-gathered ids, reduce-scattered rows,
  all-gathered row gradients: the wire of the JAX package's GSPMD lookup)
  and whose other uses gather the table whole; the block's gradient comes
  out of the backward already averaged over ranks.

The JAX step has two semantics, and the port keeps both. Without ZeRO-1
or buckets it is one GSPMD program, where every reduction over the batch
is global: the port then reduces BatchNorm's statistics over the group
(``runtime.process_group.batch_stats_over``). With either, JAX runs its
manual ``shard_map`` sync, where the loss is taken per shard: BatchNorm's
statistics stay local. A loss whose normaliser depends on the rows (a
masked mean) is averaged over ranks in both, where the GSPMD program
normalises over the whole batch (ROADMAP.md, Queue 3). The manual
``shard_map`` takes every parameter in replicated and all-reduces a sparse
table's dense gradient: there the port keeps the ``sharded`` whole-table
wire, the GSPMD semantics get the ``sparse`` one.

Gradient buckets (``bucket_bytes > 0``) sync from hooks inside the
backward (``kernel/bucketing.py``); they are off under gradient
accumulation, as in the JAX package. Every collective of the step is
counted by purpose and kind (``step.coll.counts``, the bytes in
``step.coll.nbytes``; the last step's in ``step.last_collectives`` and
``step.last_bytes``), and the plan predicts the gradient and parameter wire
(:meth:`ShardingPlan.collectives_per_step`), with its bytes and a sparse
table's (:meth:`ShardingPlan.bytes_per_step`,
:meth:`DistributedTrainStep.predicted_bytes`). It also exports the wire it
promises, var for var, in the JAX package's terms
(:meth:`ShardingPlan.promised_wire`).

Gradient accumulation (``grad_accum_steps=k``) splits each step into ``k``
micro-batches and averages loss, gradients and aux as ``a + x/k`` from
zeros; as in JAX, the GSPMD semantics cut the global batch into micro
batches and give each rank its block of each, the manual one cuts each
rank's block. ``init`` broadcasts the caller's parameters from rank 0.

The synchronizer's options:

- **compressors** (``AllReduce(compressor=...)``, ``kernel/compressor.py``):
  a variable that is not sharded over the data axis syncs through its
  compressor's ``step`` (a sharded one ignores it, with a warning, as
  JAX does). A variable split over the model or expert axis syncs its
  block through an elementwise compressor (Horovod, Horovod-EF). PowerSGD
  and TopK compress its logical gradient, as JAX does (a low-rank factor
  or top-k of a block is not that of the whole): the blocks are
  all-gathered over the variable's own axis (counted under that axis's
  name), the compressor runs on the whole, and each rank keeps its block
  of the result; their state is the whole variable's, the same on every
  rank of that axis. Any active compressor puts the step into the manual
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
raises, and ``AutoDist.build`` routes it to ``runtime/async_ps.py``.

**Tensor and expert parallelism.** On a mesh whose ``model`` (or
``expert``) axis is larger than 1, the lowering puts partitioned, fallback,
padded and sparse row-split variables on that axis (the JAX package's
``_shard_axis_name``) and the MoE's ``[E, ...]`` kernels on ``expert``; the
plan renders them ``("partitioned", dim)`` / ``("expert", 0)``, JAX's
``promised_wire`` names. Each variable is split over one axis at most, as
in JAX's plans. The state holds this rank's block. The step renders the
JAX step's GSPMD forward with ``torch.distributed.tensor``: each split
block enters the loss as a ``DTensor`` on the mesh's shard mesh (the
``DeviceMesh`` of the wide model and/or expert axes, one dim or two),
``Shard(dim)`` on its own axis's dim and ``Replicate`` on the other,
every other parameter and each batch leaf as a ``Replicate`` one, and
the forward and its backward run under
``DTensor``'s sharding propagation and ``implicit_replication`` (for the
plain tensors a model makes itself), which derive the collectives as GSPMD
does. The choice keeps the models sharding-agnostic, as JAX's are under
GSPMD: explicit Megatron collectives would need model code that knows the
mesh. ``from_local``'s backward hands each block its gradient (a
``Partial`` gradient of a replicated parameter reduced over the axis), and
the data-axis sync above then runs on those local blocks over the data
subgroup; the optimizer updates blocks in place, its slots block-shaped.
Its whole-tensor reductions (the global norm of ``clip_norm``, lamb's trust
ratios, adafactor's factored moments and RMS) add each block's partial sum
over the group that holds the variable's other blocks: its own axis's
group for a model- or expert-split variable, the data group for a ZeRO-1,
sharded or sparse one, and count a replicated leaf once. ``DTensor``'s
collectives are counted under the name of the axis whose group issues
them. Ranks along a seq or pipe axis hold every parameter whole, replicated
as over the data ranks of one block.

:class:`DistributedTrainStep` keeps the JAX step's interface: ``init``,
``__call__``, ``run(state, batch, num_steps, stacked=False)`` (a Python
loop here, returning per-step stacked losses), ``evaluate``, ``fit`` (per
step, or ``window=k`` host batches stacked into one ``run(stacked=True)``),
``compile_metrics``,
``logical_params``, and the checkpoint trio ``logical_state`` / ``save`` /
``init_or_restore``: the state under the JAX ``TrainState``'s names and
logical shapes (optimizer slots under optax's paths,
``checkpoint/names.py``), a leaf split over ranks as this rank's block
(``checkpoint/saver.py``'s ``ShardedLeaf``), so a checkpoint moves between
plans and between the packages. Where JAX donates the train state to the compiled step,
the port updates the state's tensors in place under ``torch.no_grad()``:
the state passed in is consumed, and the one returned holds the same
(updated) tensors; :func:`steps_in_flight` tells the preemption hook
(``ft/snapshot.py``) when a step is running. As the JAX step does, the
first call of a program records a ``compile`` flight event (``obs/
recorder.py``), a failure an ``error`` event, and ``GraphTransformer``
a ``lowering.transform`` span (``obs/spans.py``).
"""
from __future__ import annotations

import contextlib
import itertools
import math
import time
from dataclasses import dataclass, field, replace
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.checkpoint.names import (
    factored_names, optimizer_paths, restored_count)
from autodist_tpu_torch.checkpoint.saver import ShardedLeaf, flatten_with_names
from autodist_tpu_torch.kernel import bucketing
from autodist_tpu_torch.kernel.compressor import Compressor, get_compressor
from autodist_tpu_torch.kernel.degrade import is_active_compressor, zero1_degradation_reasons
from autodist_tpu_torch.kernel.mesh import SHARD_AXES, Mesh
from autodist_tpu_torch.kernel.sparse import RowSplitTable
from autodist_tpu_torch.kernel.sparse import predicted_bytes as table_bytes
from autodist_tpu_torch.model_item import ModelItem, Optimizer, VarItem, _factored_dims
from autodist_tpu_torch.models.convert import (
    flatten_params, map_params, map_tree, to_tensor, tree_leaves)
from autodist_tpu_torch.runtime import process_group as pg
from autodist_tpu_torch.strategy.base import check_sync_supported
from autodist_tpu_torch.strategy.ir import (
    AllReduceSynchronizer,
    NodeConfig,
    PSSynchronizer,
    Strategy,
)
from autodist_tpu_torch.obs import recorder as flight
from autodist_tpu_torch.obs import spans as obs_spans
from autodist_tpu_torch.utils import logging
from autodist_tpu_torch.utils.placement import placement_list

#: Train steps running now in this process (their state is being updated in
#: place): the preemption hook (``ft/snapshot.py``) takes no snapshot while
#: one is, and defers to the next step boundary.
_steps_in_flight = 0


def steps_in_flight() -> int:
    """How many train steps of this process are running now."""
    return _steps_in_flight


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
    #: The mesh axis ``storage_dim`` is sharded over: the data axis, or
    #: ``model`` / ``expert`` (the JAX plan's ``pspec`` axis name).
    storage_axis: str = const.MESH_AXIS_DATA

    @property
    def shape(self) -> Tuple[int, ...]:
        """The stored (padded) shape."""
        return tuple(self.storage_shape or self.var.shape)

    @property
    def model_sharded(self) -> bool:
        """Sharded over the model or expert axis (a ``DTensor`` in the step)."""
        return self.storage_dim is not None and self.storage_axis in SHARD_AXES


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
        t_wall, t0 = time.time(), time.perf_counter()
        plans: Dict[str, VarPlan] = {}
        for node in self.strategy.node_config:
            var = self.model_item.var(node.var_name)
            plans[var.name] = self._lower_node(node, var)
        for var in self.model_item.variables:
            plans.setdefault(var.name, VarPlan(var=var, kind=SyncKind.ALL_REDUCE))
        # Retroactive span (the JAX package's): how long lowering took and
        # how many variables carry the zero1 reduce-scatter/all-gather.
        obs_spans.add_span(
            "lowering.transform", t_wall, time.perf_counter() - t0,
            n_nodes=len(self.strategy.node_config),
            shard_update_vars=sum(1 for p in plans.values() if p.shard_update))
        return ShardingPlan(mesh=self.mesh, var_plans=plans,
                            bucket_bytes=int(self.strategy.graph_config.bucket_bytes or 0))

    def _shard_axis_name(self) -> str:
        """The axis variable partitioning lands on: ``model`` when it is
        larger than 1, else the data axis (ZeRO-style sharding)."""
        if self.mesh.shape.get(const.MESH_AXIS_MODEL, 1) > 1:
            return const.MESH_AXIS_MODEL
        return self.mesh.data_axis

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
        shard_ax = self._shard_axis_name()
        n_shard = self.mesh.shape[shard_ax]
        n_expert = self.mesh.shape.get(const.MESH_AXIS_EXPERT, 1)

        def divisible(axis: int) -> bool:
            return var.shape[axis] % n_shard == 0 and var.shape[axis] >= n_shard

        def padded(axis: int) -> Tuple[int, ...]:
            shape = list(var.shape)
            shape[axis] = -(-shape[axis] // n_shard) * n_shard
            return tuple(shape)

        storage_shape = None
        storage_axis = shard_ax
        part_axis = node.active_partition_axis
        fallback = self._fallback_axis(var, n_shard)
        if var.expert and rank > 0 and n_expert > 1 and var.shape[0] % n_expert == 0:
            # Expert parallelism: the leading (expert) dim over the expert axis.
            storage_dim = update_dim = 0
            storage_axis = const.MESH_AXIS_EXPERT
        elif part_axis is not None and rank > 0 and divisible(part_axis):
            storage_dim = update_dim = part_axis
        elif part_axis is not None and rank > 0 and fallback is not None:
            storage_dim = update_dim = fallback
        elif part_axis is not None and rank > 0 and var.shape[part_axis] > n_shard:
            storage_shape = padded(part_axis)
            storage_dim = update_dim = part_axis
        elif var.sparse_update and rank > 0 and divisible(0):
            storage_dim = update_dim = 0
        elif var.sparse_update and rank > 0 and var.shape[0] > n_shard:
            storage_shape = padded(0)
            storage_dim = update_dim = 0
        elif kind is SyncKind.PS and rank > 0:
            # Dense PS: with a proxy the parameter stays replicated and the
            # update shards (ZeRO-1); without one it is sharded (ZeRO-3),
            # both over the data axis.
            update_dim = self._weight_update_dim(var)
            storage_dim = None if proxy else update_dim
            storage_axis = self.mesh.data_axis
        elif kind is SyncKind.ALL_REDUCE and shard_update and rank > 0:
            storage_dim, update_dim = None, self._weight_update_dim(var)
            storage_axis = self.mesh.data_axis
        else:
            storage_dim = update_dim = None
            storage_axis = self.mesh.data_axis

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
                       degradations=degradations, offload=offload,
                       storage_axis=storage_axis)

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


#: The renderings of variables split over the model or expert axis.
_MODEL_KINDS = ("partitioned", "expert")
#: The renderings whose state is this rank's block along the data axis.
_DATA_BLOCKS = ("sharded", "sparse")


@dataclass(frozen=True)
class VarWire:
    """One variable's part of the collective wire the plan promises
    (:meth:`ShardingPlan.promised_wire`), in the JAX package's terms: the
    rendering, the op kinds that must appear (``require``) and that may
    carry up to its whole storage (``allow``), its storage, the ZeRO-1 and
    sparse flags, compressor, degradations, and its gradient bucket with
    the bucket's summed elements."""

    var: str
    rendering: str
    require: Tuple[str, ...] = ()
    allow: Tuple[str, ...] = ()
    storage_elements: int = 0
    storage_bytes: int = 0
    shard_update: bool = False
    sparse_row_sharded: bool = False
    compressor: str = "NoneCompressor"
    degradations: Tuple[str, ...] = ()
    bucket: Optional[int] = None
    bucket_elements: int = 0


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
            if p.storage_dim is not None and not p.model_sharded:
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

    def manual_semantics(self, bucketed: bool = True) -> bool:
        """True when the step runs the JAX step's manual ``shard_map``
        semantics: gradient buckets (``bucketed``: the step's buckets are off
        under gradient accumulation), an active compressor, or ZeRO-1."""
        return ((bucketed and bool(self.bucket_assignment())) or bool(self.compressors())
                or any(p.shard_update for p in self.var_plans.values()))

    def rendering(self, name: str, manual: Optional[bool] = None
                  ) -> Tuple[str, Optional[int]]:
        """How the step syncs a variable: ``("replicated", None)``,
        ``("zero1", update_dim)``, ``("sharded", storage_dim)`` or
        ``("sparse", 0)`` over the data axis, or ``("partitioned",
        storage_dim)`` / ``("expert", 0)`` over the model / expert axis
        (JAX's ``promised_wire`` names; the step holds this rank's block and
        its gradient is all-reduced over the data axis). A data axis of one
        renders the others replicated (nothing to shard). ``sparse`` is a
        sparse-update table split by rows over the data axis in the GSPMD
        semantics (``manual`` false; default :meth:`manual_semantics`) on a
        mesh without a model or expert axis; otherwise such a table is
        ``sharded`` (the module docstring says why)."""
        p = self.var_plans.get(name)
        if p is not None and p.model_sharded:
            kind = "expert" if p.storage_axis == const.MESH_AXIS_EXPERT else "partitioned"
            return kind, p.storage_dim
        if p is None or self.mesh.data_size == 1:
            return "replicated", None
        if p.storage_dim == 0 and p.var.sparse_update and not self.mesh.shard_axes:
            if not (self.manual_semantics() if manual is None else manual):
                return "sparse", 0
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
        n, r = self.mesh.data_size, self.mesh.data_rank
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

    def global_batch_from_rows(self, batch):
        """The global batch from this rank's loader rows (numpy or tensors):
        every leaf copied to the plan's device and all-gathered along dim 0
        in rank order. A loader's leaves are batched by construction, so a
        rank's batch of one row is concatenated across ranks, not taken for
        a broadcast leaf."""
        dev = self.device
        local = map_tree(lambda t: to_tensor(t).to(dev), batch)
        return self.global_batch_from_local(local, broadcast=map_tree(lambda _: False, local))

    def window_shardings(self, stacked_batch):
        """The JAX ``PartitionSpec`` string of each leaf of a stacked data
        window ``[num_steps, batch, ...]`` (a tree of the window's nesting):
        the step axis unsplit and each step's slice split over the data axis
        on its dim 0, as :meth:`local_batch` splits a batch; a broadcast
        slice is replicated. A window is training data, so a slice dim that
        the data axis does not divide raises."""
        n = self.mesh.data_size
        split, whole = (f"PartitionSpec{(None, const.MESH_AXIS_DATA)!r}",
                        f"PartitionSpec{(None,)!r}")

        def leaf(t):
            shape = tuple(t.shape)[1:]
            if len(shape) == 0 or shape[0] <= 1:
                return whole
            if shape[0] % n:
                raise ValueError(f"global batch dim {shape[0]} not divisible by "
                                 f"data-parallel degree {n}")
            return split

        return map_tree(leaf, stacked_batch)

    def window_from_local(self, stacked_local):
        """This rank's stacked host window -> the global window on the
        plan's device. ``stacked_local`` leaves are ``[num_steps,
        local_batch, ...]`` (numpy or tensors: this rank's rows of
        ``num_steps`` consecutive batches); each is copied to the device once
        and all-gathered along dim 1 over the data group in rank order (at
        one rank, just copied): the bridge between the DataLoader and
        ``run(stacked=True)``. Window leaves are batched by construction, so
        dim 1 always concatenates across ranks."""
        coll, dev = pg.Collectives(self.mesh.group), self.device

        def leaf(x):
            t = to_tensor(x).to(dev)
            return coll.all_gather(t, 1, "batch") if t.dim() >= 2 else t

        return map_tree(leaf, stacked_local)

    def collectives_per_step(self, bucketed: bool = True) -> Dict[str, int]:
        """The gradient and parameter wire one step issues over the data
        axis, by kind: a mean all-reduce per replicated, partitioned or
        expert variable (the last two: of this rank's block) or bucket of
        them, a reduce-scatter per ZeRO-1 or sharded variable (or bucket of
        ZeRO-1 ones), an all-gather per ZeRO-1 variable (new values) and per
        sharded one (its logical view); a compressed variable issues its
        compressor's collectives instead of its all-reduce. The step adds its
        own loss metric, BatchNorm and optimizer reductions, and ``DTensor``'s
        own over the model or expert axis, under other purposes."""
        counts = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0}
        compressors = self.compressors()
        buckets = self.bucket_assignment() if bucketed else ()
        manual = self.manual_semantics(bucketed)
        in_bucket = {name for b in buckets for name in b}
        for b in buckets:
            kinds = {self.rendering(name, manual)[0] for name in b}
            counts["all_reduce"] += "replicated" in kinds
            counts["reduce_scatter"] += "zero1" in kinds
        for name, p in self.var_plans.items():
            if not _is_float(p.var.dtype):
                continue
            kind = self.rendering(name, manual)[0]
            if kind == "sparse":
                continue        # its wire is the reads' ("sparse" / "table")
            data_wire = kind in ("zero1", "sharded")
            if data_wire:
                counts["all_gather"] += 1
            if name in in_bucket:
                continue
            if name in compressors:
                for k, c in compressors[name].collectives(self.compressed_shape(name)).items():
                    counts[k] += c
                continue
            counts["reduce_scatter" if data_wire else "all_reduce"] += 1
        return counts

    def bytes_per_step(self, table_uses: Optional[Dict[str, list]] = None,
                       bucketed: bool = True) -> Dict[str, Dict[str, int]]:
        """The bytes :meth:`collectives_per_step`'s wire moves, by purpose
        (``"grad"``, ``"param"``) and kind, in the units
        ``Collectives.nbytes`` records (an all-reduce: the tensor; a
        reduce-scatter: its input; an all-gather: its output), with the
        ``"sparse"`` and ``"table"`` bytes of each ``sparse`` variable's
        recorded uses (``table_uses``, from
        :meth:`DistributedTrainStep.table_uses`; ``kernel/sparse.py``'s
        ``predicted_bytes``). A compressed variable's payload is its
        compressor's and is left out (``wire_factor`` prices it)."""
        out: Dict[str, Dict[str, int]] = {}

        def add(purpose, kind, nbytes):
            if nbytes:
                out.setdefault(purpose, {}).setdefault(kind, 0)
                out[purpose][kind] += int(nbytes)

        compressors = self.compressors()
        buckets = self.bucket_assignment() if bucketed else ()
        manual = self.manual_semantics(bucketed)
        in_bucket = {name for b in buckets for name in b}

        def nbytes(name, shape):
            return math.prod(shape) * _itemsize(self.var_plans[name].var.dtype)

        for b in buckets:
            for name in b:
                kind = self.rendering(name, manual)[0]
                add("grad", "reduce_scatter" if kind == "zero1" else "all_reduce",
                    nbytes(name, self.local_shape(name)))
        for name, p in self.var_plans.items():
            if not _is_float(p.var.dtype):
                continue
            kind = self.rendering(name, manual)[0]
            if kind in ("zero1", "sharded"):
                add("param", "all_gather", nbytes(name, p.shape))
            if name in in_bucket or name in compressors or kind == "sparse":
                continue
            if kind in ("zero1", "sharded"):
                add("grad", "reduce_scatter", nbytes(name, p.shape))
            else:
                add("grad", "all_reduce", nbytes(name, self.local_shape(name)))
        for name, uses in (table_uses or {}).items():
            for purpose, kinds in table_bytes(uses, self.mesh.data_size).items():
                for kind, k in kinds.items():
                    add(purpose, kind, k)
        return out

    def promised_wire(self) -> Dict[str, VarWire]:
        """The collective wire this plan promises, var for var, in the JAX
        package's terms and precedence (``ShardingPlan.promised_wire``):
        ``nontrainable``; ``zero1`` (ZeRO-1: reduce-scatter and all-gather
        required); ``sparse`` (a sparse-update table split over an axis
        larger than 1: nothing may carry the whole table); ``expert``;
        ``zero3`` (split over the data axis: all-gather required when it is
        larger than 1); ``partitioned``; ``ps1`` and ``replicated`` (dense
        all-reduce wire at full payload). This is JAX's plan-level promise:
        under the manual semantics the port's step moves a ``sparse``
        table whole, as JAX's manual step does (:meth:`rendering`)."""
        ax_d = self.mesh.data_axis
        sizes = self.mesh.shape
        bucket_of = {n: bi for bi, names in enumerate(self.bucket_assignment())
                     for n in names}
        wires: Dict[str, VarWire] = {}
        for name, p in self.var_plans.items():
            elems = math.prod(p.storage_shape or tuple(p.var.shape) or (1,))
            axes = ({p.storage_axis} if p.storage_dim is not None
                    and sizes.get(p.storage_axis, 1) > 1 else set())
            if not p.var.trainable:
                rendering, require, allow = "nontrainable", (), ()
            elif p.shard_update:
                rendering = "zero1"
                require = allow = ("reduce-scatter", "all-gather")
            elif p.var.sparse_update and axes:
                rendering, require, allow = "sparse", (), ()
            elif const.MESH_AXIS_EXPERT in axes:
                rendering, require = "expert", ()
                allow = ("all-reduce", "all-gather", "all-to-all")
            elif ax_d in axes:
                rendering = "zero3"
                require = ("all-gather",) if sizes.get(ax_d, 1) > 1 else ()
                allow = ("all-gather", "reduce-scatter", "all-reduce")
            elif axes:
                rendering, require = "partitioned", ()
                allow = ("all-gather", "reduce-scatter", "all-reduce")
            elif p.kind is SyncKind.PS:
                rendering, require, allow = "ps1", (), ("all-reduce", "all-gather")
            else:
                rendering, require, allow = "replicated", (), ("all-reduce", "all-gather")
            wires[name] = VarWire(
                var=name, rendering=rendering, require=require, allow=allow,
                storage_elements=elems, storage_bytes=elems * _itemsize(p.var.dtype),
                shard_update=p.shard_update,
                sparse_row_sharded=p.var.sparse_update and bool(axes),
                compressor=p.compressor, degradations=p.degradations,
                bucket=bucket_of.get(name))
        sums: Dict[int, int] = {}
        for name, bi in bucket_of.items():
            sums[bi] = sums.get(bi, 0) + wires[name].storage_elements
        for name, bi in bucket_of.items():
            wires[name] = replace(wires[name], bucket_elements=sums[bi])
        return wires

    def local_shape(self, name: str) -> Tuple[int, ...]:
        """The shape of this rank's part of a variable in the step: a
        partitioned or expert variable's block, else its logical shape."""
        p = self.var_plans[name]
        if not p.model_sharded:
            return tuple(p.var.shape)
        shape = list(p.shape)
        shape[p.storage_dim] //= self.mesh.shape[p.storage_axis]
        return tuple(shape)

    def compressed_shape(self, name: str) -> Tuple[int, ...]:
        """The shape of the gradient a variable's compressor takes: the
        logical shape under a compressor of :data:`_WHOLE_GRADIENT` (JAX
        compresses the logical gradient), else :meth:`local_shape`."""
        p = self.var_plans[name]
        if p.model_sharded and get_compressor(p.compressor).name in _WHOLE_GRADIENT:
            return tuple(p.var.shape)
        return self.local_shape(name)

    def describe(self) -> str:
        """One line per variable, in the JAX plan's ``describe`` layout."""
        ax = self.mesh.data_axis
        lines = [f"ShardingPlan(mesh={dict(self.mesh.shape)})"]
        for name, p in self.var_plans.items():
            rank = len(p.var.shape)
            update_ax = p.storage_axis if p.storage_dim is not None else ax
            lines.append(
                f"  {name}: {p.kind.value} param={_pspec(rank, p.storage_dim, p.storage_axis)} "
                f"update={_pspec(rank, p.update_dim, update_ax)}"
                + (" shard_update=zero1" if p.shard_update else "")
                + (f" dest={p.reduction_destination}" if p.reduction_destination else "")
                + (f" shard_dests={list(p.shard_destinations)}"
                   if p.shard_destinations else "")
                + (" offload=pinned_host" if p.offload else ""))
        return "\n".join(lines)


def _zeros_at_least_f32(t):
    return torch.zeros(t.shape, dtype=torch.promote_types(t.dtype, torch.float32),
                       device=t.device)


#: Compressors whose result on a block is not the block of their result on
#: the whole gradient (a low-rank factor, a top-k).
_WHOLE_GRADIENT = ("PowerSGDCompressor", "TopKCompressor")


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
        self.n, self.rank = mesh.data_size, mesh.data_rank
        self.coll = pg.Collectives(mesh.group)
        # Tensor / expert parallelism: the DeviceMesh of those axes (one dim
        # or two), and per axis its size, this rank's coordinate and its
        # group's collectives.
        self.shard_axes = mesh.shard_axes
        self.dmesh = mesh.shard_mesh()
        if self.shard_axes and self.dmesh is None:
            raise ValueError(f"mesh axes {self.shard_axes} need a process group")
        self.n_shard = {ax: mesh.shape[ax] for ax in self.shard_axes}
        self.shard_rank = {ax: mesh.coords[ax] for ax in self.shard_axes}
        self.world = self.coll.over(mesh.world_group) if self.shard_axes else self.coll
        self.shard_coll = {ax: self.coll.over(mesh.axis_group(ax, required=True))
                           for ax in self.shard_axes}
        self.shard_ranks = {ax: tuple(torch.distributed.get_process_group_ranks(c.group))
                            for ax, c in self.shard_coll.items()}
        if mesh.group is None and self.n > 1:
            raise ValueError(f"a data axis of {self.n} needs a process group")
        if mesh.group is not None and self.coll.size != self.n:
            raise ValueError(f"data axis {self.n} != group size {self.coll.size}")
        buckets = plan.bucket_assignment()
        if buckets and grad_accum_steps > 1:
            logging.warning("bucketed grad sync (bucket_bytes=%d) disabled under "
                            "grad_accum_steps=%d: collectives fire once per step, after "
                            "accumulation", plan.bucket_bytes, grad_accum_steps)
            buckets = ()
        self.buckets = buckets
        self.compressors = plan.compressors(warn=True)
        # Split variables whose compressor takes the logical gradient.
        self.whole_grad = {name for name, comp in self.compressors.items()
                           if plan.var_plans[name].model_sharded
                           and comp.name in _WHOLE_GRADIENT}
        # The JAX step's manual sync (shard_map): per-shard batch statistics,
        # sparse tables moved whole.
        self.manual = plan.manual_semantics(bucketed=grad_accum_steps == 1)
        self.render = {name: plan.rendering(name, self.manual) for name in plan.var_plans}
        self.zero1_dims = {name: d for name, (kind, d) in self.render.items()
                           if kind == "zero1"}
        self._sharded = any(kind in _DATA_BLOCKS for kind, _ in self.render.values())
        self.stale = {name: p.staleness for name, p in plan.var_plans.items()
                      if p.staleness > 0}
        self.offloaded = {name for name, p in plan.var_plans.items() if p.offload}
        self.last_collectives: Dict[str, Dict[str, int]] = {}
        self.last_bytes: Dict[str, Dict[str, int]] = {}
        # First calls, as the JAX step's compile log (program, first_call_s),
        # and the count of steps completed (the preemption hook's staleness
        # check on a registered state).
        self.compile_log: List[Dict[str, Any]] = []
        self.steps_taken = 0

    # ------------------------------------------------------------- helpers
    def _to_device(self, tree):
        """A batch on the step's device; numpy leaves become tensors."""
        dev = self.plan.device
        return map_tree(lambda t: to_tensor(t).to(dev, non_blocking=True), tree)

    def _render(self, name: str) -> Tuple[str, Optional[int]]:
        return self.render.get(name, ("replicated", None))

    def _floating(self, params) -> List[Tuple[str, torch.Tensor]]:
        return [(n, t) for n, t in flatten_params(params).items() if t.is_floating_point()]

    def _update_view(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The part of a stored leaf this rank updates: a ZeRO-1 variable's
        block, else the stored tensor."""
        kind, d = self._render(name)
        return _block(t, d, self.n, self.rank) if kind == "zero1" else t

    def _split_axis(self, name: str) -> Optional[str]:
        """The model or expert axis a variable is split over, else None."""
        kind, _ = self._render(name)
        return self.plan.var_plans[name].storage_axis if kind in _MODEL_KINDS else None

    def _layout(self, params) -> List[Optional[Tuple[int, Tuple[int, ...], str]]]:
        """Per floating leaf, ``(dim, storage shape, axis)`` when the
        optimizer sees a block of it, else None: ``axis`` names the group
        holding its other blocks, the variable's own axis (``"model"`` or
        ``"expert"``) for one split on the model or expert axis, ``"data"``
        for a ZeRO-1, sharded or sparse one."""
        out = []
        for name, _ in self._floating(params):
            kind, d = self._render(name)
            axis = self._split_axis(name) or "data"
            out.append(None if kind == "replicated" else
                       (d, self.plan.var_plans[name].shape, axis))
        return out

    def _psum(self, t: torch.Tensor, lay) -> torch.Tensor:
        """Sum a partial sum of blocks over the ranks holding the other
        blocks: the model or expert group for the blocks of a variable
        split on that axis (replicated over the data ranks and the other
        axes), else the data group (those of a ZeRO-1, sharded or sparse
        variable, replicated over the model ranks). No block is counted
        twice."""
        self.shard_coll.get(lay[2], self.coll).all_reduce(t, "optimizer")
        return t

    # ------------------------------------------------- tensor parallelism
    def _placements(self, name: str):
        """A variable's placements on the shard mesh: ``Shard(dim)`` on its
        own axis's dim when it is split, ``Replicate`` elsewhere."""
        from torch.distributed.tensor import Replicate, Shard

        ax = self._split_axis(name)
        return placement_list(self.dmesh, ax,
                              Shard(self._render(name)[1]) if ax else Replicate())

    def _dtensor(self, t: torch.Tensor, placements=None):
        """``t`` (this rank's block, or the whole) as a ``DTensor`` on the
        shard mesh (``Replicate`` on every dim by default);
        differentiable."""
        from torch.distributed.tensor import DTensor, Replicate

        return DTensor.from_local(t, self.dmesh,
                                  placements or placement_list(self.dmesh, None, Replicate()),
                                  run_check=False)

    @contextlib.contextmanager
    def _sharded_forward(self):
        """The block a forward (and its backward) runs in: under tensor or
        expert parallelism, ``DTensor``'s implicit replication of plain
        tensors (the models' own ``arange``s and masks) and the count of
        its collectives, each under the name of the axis whose group
        issued it; else nothing."""
        if not self.shard_axes:
            yield
            return
        from torch.distributed.tensor.experimental import implicit_replication

        with self.coll.count_dtensor(self.shard_axes[0], self.shard_ranks), \
                implicit_replication():
            yield

    @staticmethod
    def _local(t):
        """A loss or metric as a plain tensor (a ``DTensor`` made whole)."""
        from torch.distributed.tensor import DTensor

        return t.full_tensor() if isinstance(t, DTensor) else t

    def _loss(self, params, batch):
        """``(loss, aux)`` of the loss function, plain tensors."""
        if self.shard_axes:
            batch = map_tree(self._dtensor, batch)
        out = self.loss_fn(params, batch)
        loss, aux = out if self.has_aux else (out, None)
        if self.shard_axes:
            loss = self._local(loss)
            aux = map_params(self._local, aux) if aux is not None else None
        return loss, aux

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
            self.world.broadcast(t, "init")
            kind, d = self._render(name)
            if kind in _DATA_BLOCKS:
                t = _block(self.plan.pad(name, t), d, self.n, self.rank).contiguous()
            elif kind in _MODEL_KINDS:
                ax = self._split_axis(name)
                t = _block(self.plan.pad(name, t), d, self.n_shard[ax],
                           self.shard_rank[ax]).contiguous()
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
        rank's device, shaped like the gradient its compressor takes (a
        split variable's block, or under :data:`_WHOLE_GRADIENT` its
        logical shape); shared state is broadcast from rank 0."""
        dev, out = self.plan.device, {}
        for name, comp in self.compressors.items():
            var = self.plan.var_plans[name].var
            if name not in self.whole_grad:
                var = replace(var, shape=self.plan.local_shape(name))
            local = {k: t.to(dev) for k, t in comp.init_local(var).items()}
            shared = {k: self.coll.broadcast(t.to(dev).contiguous(), "init")
                      for k, t in comp.init_shared(var).items()}
            out[name] = {"local": local, "shared": shared}
        return out

    def logical_params(self, state: TrainState):
        """The user-shaped parameter view of a train state (detached).
        Sharded variables are all-gathered, so every rank calls it."""
        return self._logical(state.params)

    def _logical(self, params):
        """:meth:`logical_params` of a state's params tree."""
        def view(name, t):
            kind, d = self._render(name)
            t = t.detach()
            if kind in _DATA_BLOCKS:
                t = t.to(self.plan.device)
                t = self.plan.unpad(name, self.coll.all_gather(t, d, "view"))
            elif kind in _MODEL_KINDS:
                t = self.plan.unpad(name, self.shard_coll[self._split_axis(name)].all_gather(
                    t.to(self.plan.device), d, "view"))
            return t

        return _map_named(view, params)

    # ---------------------------------------------------------- checkpoints
    def _split(self, t: torch.Tensor, logical, dim: int, per_rank: int, n: int, r: int):
        """``(blocks, this rank's block index or None, its view of t)`` of a
        leaf stored on each rank as the ``per_rank``-long block ``r`` along
        ``dim`` of a storage as long as ``per_rank * n``: the blocks clipped
        to the logical extent ``logical[dim]``, an empty one dropped."""
        size = logical[dim]
        blocks = []
        for j in range(n):
            lo = j * per_rank
            if lo >= size:
                break
            start = [0] * len(logical)
            stop = list(logical)
            start[dim], stop[dim] = lo, min(lo + per_rank, size)
            blocks.append((tuple(start), tuple(stop)))
        lo = r * per_rank
        if lo >= size:
            return blocks, None, None
        return blocks, r, t.narrow(dim, 0, min(per_rank, size - lo))

    def _first_holder(self, *split: str) -> bool:
        """Whether this rank is the first of those that hold its block of
        a leaf split over the ``split`` axes (``"data"``: the batch axis):
        its coordinate is 0 on every other axis."""
        mesh = self.plan.mesh
        split = {mesh.data_axis if ax == "data" else ax for ax in split}
        return all(c == 0 for ax, c in mesh.coords.items() if ax not in split)

    def _leaf(self, t: torch.Tensor, logical, dim: Optional[int], per_rank: int = 0,
              axis: str = "data", restore: bool = False):
        """A state tensor as a checkpoint leaf: whole (the same on every
        rank) when ``dim`` is None, else this rank's :class:`ShardedLeaf`
        block of a split over the data axis or (``axis="model"`` or
        ``"expert"``) that axis; and the view of ``t`` that holds its
        logical data. Of the ranks holding one block, only the first along
        the other axes writes it; as a ``restore`` target every rank lists
        its block."""
        if dim is None:
            return t, t
        if axis == "data":
            n, r = self.n, self.rank
        else:
            n, r = self.n_shard[axis], self.shard_rank[axis]
        first = self._first_holder(axis)
        blocks, j, view = self._split(t, tuple(logical), dim, per_rank, n, r)
        local = {j: view} if j is not None and (first or restore) else {}
        return ShardedLeaf(tuple(logical), t.dtype, blocks, local), view

    def checkpoint_leaves(self, state: TrainState, restore: bool = False):
        """``(name, leaf, view)`` of every leaf of the state's checkpoint:
        ``step``; ``params/<var>``; the optimizer's slots and counts under
        optax's paths (``checkpoint/names.py``); ``comp_state/<var>/
        local|shared/<key>`` (a rank's local state is its row of JAX's
        ``[n, ...]`` stack); ``stale_state/<var>``. ``leaf`` is a tensor
        (whole, written by rank 0), a :class:`ShardedLeaf` (this rank's
        block of a leaf split over ranks, in logical coordinates) or an int
        (``step``, ``count``); ``view`` is the part of the state's tensor
        holding the leaf's (or block's) logical data, where a restore
        copies to. ``restore``: the leaves as a restore target (see
        :meth:`_leaf`)."""
        out = [("step", int(state.step), None)]
        plans = self.plan.var_plans

        def var_leaf(name, t, lead: int = 0, param: bool = False):
            """A leaf shaped ``lead`` dims + the variable's block on this
            rank: a parameter's stored block (split only when sharded over
            an axis), a slot's or delay buffer's updated one (ZeRO-1 too)."""
            kind, d = self._render(name)
            p = plans.get(name)
            if kind == "replicated" or p is None or (param and kind == "zero1"):
                return self._leaf(t, t.shape, None)
            logical = tuple(t.shape[:lead]) + tuple(p.var.shape)
            if kind in _MODEL_KINDS:
                ax = self._split_axis(name)
                return self._leaf(t, logical, lead + d, p.shape[d] // self.n_shard[ax], ax,
                                  restore)
            return self._leaf(t, logical, lead + d, p.shape[d] // self.n, restore=restore)

        for name, t in flatten_params(state.params).items():
            out.append((f"params/{name}",) + var_leaf(name, t.detach(), param=True))
        paths = optimizer_paths(self.tx)
        opt = state.opt_state
        for p in paths["count"]:
            out.append((f"opt_state/{p}", int(opt["count"]), None))
        floating = [n for n, _ in self._floating(state.params)]
        slots = [k for k in opt if k != "count"]
        if sorted(slots) != sorted(k for k in paths if k != "count"):
            raise ValueError(f"optimizer state keys {slots} do not match its checkpoint "
                             f"names {sorted(paths)}")
        for key in slots:
            for name, slot in zip(floating, opt[key]):
                if key != "v":
                    out.append((f"opt_state/{paths[key]}/{name}",) + var_leaf(name, slot))
                    continue
                for field, prefix in factored_names(paths["v"]).items():
                    full = f"opt_state/{prefix}/{name}"
                    if field not in slot:
                        ph = torch.zeros((1,), dtype=torch.float32)   # optax's placeholder
                        out.append((full, ph, None))
                    elif field == "v":
                        out.append((full,) + var_leaf(name, slot[field]))
                    else:
                        out.append((full,) + self._factored_leaf(name, field, slot[field],
                                                                 restore))
        for name, st in state.comp_state.items():
            for k, t in st["local"].items():
                stacked = t.unsqueeze(0)
                if plans[name].model_sharded and name not in self.whole_grad:
                    out.append((f"comp_state/{name}/local/{k}",)
                               + self._model_split_local(name, stacked, restore))
                    continue
                if self.n == 1:
                    out.append((f"comp_state/{name}/local/{k}", stacked, stacked))
                    continue
                logical = (self.n,) + tuple(t.shape)
                # A whole-gradient state is the same on the ranks of the
                # variable's axis; the first of them writes it.
                out.append((f"comp_state/{name}/local/{k}",)
                           + self._leaf(stacked, logical, 0, 1, restore=restore))
            for k, t in st["shared"].items():
                out.append((f"comp_state/{name}/shared/{k}", t, t))
        for name, buf in state.stale_state.items():
            out.append((f"stale_state/{name}",) + var_leaf(name, buf, lead=1))
        return out

    def _model_split_local(self, name: str, stacked: torch.Tensor, restore: bool = False):
        """A compressor's local state of a model-split variable (this rank's
        ``[1, block]``) as a checkpoint leaf: JAX's ``[n, *var.shape]``
        stack, one row a data rank, as the variable's own
        :class:`ShardedLeaf` gives it: each rank writes its block of its
        row, the first of the ranks holding that block (along the axes
        other than the data and the variable's own)."""
        p = self.plan.var_plans[name]
        d, ax = self._render(name)[1], self._split_axis(name)
        logical = (self.n,) + tuple(p.var.shape)
        cols, j, view = self._split(stacked, logical, d + 1, p.shape[d] // self.n_shard[ax],
                                    self.n_shard[ax], self.shard_rank[ax])
        blocks = [((i,) + start[1:], (i + 1,) + stop[1:])
                  for i in range(self.n) for start, stop in cols]
        first = self._first_holder("data", ax)
        local = {} if j is None or not (first or restore) else {self.rank * len(cols) + j: view}
        return ShardedLeaf(logical, stacked.dtype, blocks, local), view

    def _factored_leaf(self, name: str, field: str, t: torch.Tensor,
                       restore: bool = False):
        """Adafactor's row or column statistics of a variable: the stored
        shape without the factored dim, whole when the variable is not
        split or is split along that dim (the ranks' statistics are then
        the same), else split along the variable's dim as it falls in the
        statistics."""
        kind, d = self._render(name)
        if kind == "replicated":
            return self._leaf(t, t.shape, None)
        full = self.plan.var_plans[name].shape
        d1, d0 = _factored_dims(full, self.tx.hp["min_dim_size_to_factor"])
        removed = d0 if field == "row" else d1
        if d == removed:
            return self._leaf(t, t.shape, None)
        logical = tuple(s for i, s in enumerate(full) if i != removed)
        if kind in _MODEL_KINDS:
            ax = self._split_axis(name)
            return self._leaf(t, logical, d - (d > removed), full[d] // self.n_shard[ax], ax,
                              restore)
        return self._leaf(t, logical, d - (d > removed), full[d] // self.n,
                          restore=restore)

    def logical_state(self, state: TrainState, restore: bool = False) -> Dict[str, Any]:
        """The checkpoint view of a train state: a nested dict named as the
        JAX package's ``TrainState`` flattens (``step``, ``params/...``,
        ``opt_state/<optax path>``, ``comp_state/...``, ``stale_state/...``)
        with every leaf in its logical shape, so that a checkpoint restores
        into any plan of either package. A leaf split over ranks is this
        rank's :class:`~autodist_tpu_torch.checkpoint.ShardedLeaf` block
        (nothing is gathered); ``step`` and counts are ints (int32 on
        disk). ``saver.save(step.logical_state(state))`` is
        :meth:`save`. As a restore target (``restore``) a block held by
        several ranks is listed on each."""
        tree: Dict[str, Any] = {}
        for name, leaf, _ in self.checkpoint_leaves(state, restore):
            node = tree
            parts = name.split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = leaf
        return tree

    def load_logical(self, state: TrainState, logical) -> TrainState:
        """Copy a restored checkpoint view (``Saver.restore(path,
        target=step.logical_state(state, restore=True))``) into ``state`` in place: each
        leaf's logical data into the state's tensors (a padded variable's
        padding stays zero), the step and the optimizer's count. Returns
        ``state``."""
        flat = dict(flatten_with_names(logical))
        counts = {}
        with torch.no_grad():
            for name, _, view in self.checkpoint_leaves(state, restore=True):
                value = flat[name]
                if name == "step":
                    state.step = int(value)
                elif view is None and isinstance(value, int):
                    counts[name[len("opt_state/"):]] = value
                elif isinstance(value, ShardedLeaf):
                    if value.local:
                        view.copy_(next(iter(value.local.values())))
                elif view is not None:
                    view.copy_(value)
        state.opt_state["count"] = restored_count(optimizer_paths(self.tx), counts,
                                                  state.step)
        return state

    def save(self, saver, state: TrainState, path: Optional[str] = None,
             step: Optional[int] = None, block: bool = True) -> str:
        """Checkpoint ``state`` in its logical shapes (:meth:`logical_state`);
        the checkpoint step defaults to the state's own. Every rank calls
        it; :meth:`init_or_restore` is the matching load."""
        if step is None:
            step = int(state.step)
        return saver.save(self.logical_state(state), path=path, step=step, block=block)

    def init_or_restore(self, params, saver=None, restore_fn=None) -> TrainState:
        """A fresh state, or the newest checkpoint when there is one: the
        resume entry point. The checkpoint may come from any plan of either
        package (it holds logical shapes); each rank reads only its blocks,
        and a padded plan re-pads them into its storage. ``restore_fn(
        target=...)`` overrides where the state comes from (default
        ``saver.restore_latest``)."""
        if restore_fn is None:
            restore_fn = saver.restore_latest
        state = self.init(params)
        restored = restore_fn(target=self.logical_state(state, restore=True))
        if restored is None:
            return state
        return self.load_logical(state, restored)

    # ------------------------------------------------------------- forward
    def _forward_params(self, params):
        """``(params for the loss, {name: gradient target})``: a sharded
        variable is all-gathered into a fresh leaf (its target) and sliced
        to its logical shape, a sparse one's block is wrapped as a
        :class:`~autodist_tpu_torch.kernel.sparse.RowSplitTable`; the
        others (and the sparse blocks) are their own targets."""
        if not self._sharded and not self.shard_axes:
            return params, dict(self._floating(params))
        targets, gathered = {}, {}
        def wrap(t, name=None):
            """``t`` on the shard mesh (placed as ``name`` is), if any."""
            if not self.shard_axes:
                return t
            return self._dtensor(t, self._placements(name) if name else None)

        def view(name, t):
            if not t.is_floating_point():
                return wrap(t)
            kind, d = self._render(name)
            if kind == "sparse":
                targets[name] = t
                return RowSplitTable(t, self.coll, self.plan.var_plans[name].var.shape[0],
                                     self.rank, gathered=gathered)
            if kind != "sharded":
                targets[name] = t
                return self.plan.unpad(name, wrap(t, name))
            with torch.no_grad():
                full = self.coll.all_gather(t.detach(), d, "param")
            full = full.detach().requires_grad_(True)
            targets[name] = full
            return self.plan.unpad(name, wrap(full))

        return _map_named(view, params), targets

    def _grads(self, params, targets, batch):
        """``(loss, aux, {name: gradient})`` of one (micro-)batch, unused
        gradients as zeros (this rank's block of a partitioned or expert
        variable's)."""
        names = list(targets)
        with self._sharded_forward():
            loss, aux = self._loss(params, batch)
            grads = torch.autograd.grad(loss, [targets[n] for n in names],
                                        allow_unused=True)
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
            if kind == "sparse":
                out[name] = g       # averaged over ranks in the backward
            elif name in self.compressors:
                if name in self.whole_grad:
                    # A split variable: JAX's manual sync compresses the
                    # logical gradient, so the step runs on the unpadded
                    # whole and this rank keeps its block of the result.
                    ax = self._split_axis(name)
                    g = self.plan.unpad(
                        name, self.shard_coll[ax].all_gather(g, d, ax)).contiguous()
                st = comp_state[name]
                synced, local, shared = self.compressors[name].step(
                    g, st["local"], st["shared"], self.coll)
                for old, new in ((st["local"], local), (st["shared"], shared)):
                    for k, t in new.items():
                        old[k].copy_(t)
                if name in self.whole_grad:
                    synced = _block(self.plan.pad(name, synced), d, self.n_shard[ax],
                                    self.shard_rank[ax]).contiguous()
                out[name] = synced
            elif kind == "replicated" or kind in _MODEL_KINDS:
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

    def table_uses(self, state: TrainState, batch) -> Dict[str, list]:
        """Each ``sparse`` variable's uses in one step of this rank, from a
        forward of the loss on meta tensors with this rank's (micro-)batch
        shapes, its tables recording instead of communicating
        (``kernel/sparse.py``): per row read the ids a rank reads, per
        whole-table use the gathered storage; repeated per micro-batch."""
        sparse = [n for n, (kind, _) in self.render.items() if kind == "sparse"]
        if not sparse:
            return {}
        uses: Dict[str, list] = {n: [] for n in sparse}
        gathered: dict = {}

        def meta(name, t):
            if name in uses:
                return RowSplitTable(torch.empty(t.shape, dtype=t.dtype, device="meta"), None,
                                     self.plan.var_plans[name].var.shape[0], self.rank,
                                     uses=uses[name], world=self.n, gathered=gathered)
            return torch.empty(self.plan.var_plans[name].var.shape, dtype=t.dtype,
                               device="meta")

        micro = self._micro_batches(batch)
        params = _map_named(meta, state.params)
        with torch.no_grad():
            self.loss_fn(params, map_tree(
                lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), micro[0]))
        return {n: u * len(micro) for n, u in uses.items()}

    def predicted_bytes(self, state: TrainState, batch) -> Dict[str, Dict[str, int]]:
        """The step's predicted wire bytes by purpose and kind
        (:meth:`ShardingPlan.bytes_per_step` with :meth:`table_uses`), to
        hold ``last_bytes`` against."""
        return self.plan.bytes_per_step(self.table_uses(state, batch),
                                        bucketed=self.accum == 1)

    def _step(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        global _steps_in_flight
        _steps_in_flight += 1
        try:
            out = self._update(state, batch)
        finally:
            _steps_in_flight -= 1
        self.steps_taken += 1
        return out

    def _update(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        before = self.coll.snapshot()
        bytes_before = self.coll.bytes_snapshot()
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
        moved = self.coll.bytes_snapshot()
        self.last_bytes = {
            p: {k: v - bytes_before.get(p, {}).get(k, 0) for k, v in kinds.items()
                if v - bytes_before.get(p, {}).get(k, 0)}
            for p, kinds in moved.items()}
        self.last_bytes = {p: k for p, k in self.last_bytes.items() if k}
        return TrainState(host.step + 1, host.params, host.opt_state, host.comp_state,
                          host.stale_state), metrics

    def _mean_metric(self, t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if self.coll.group is None:
            return t
        t = t.clone() if t.is_floating_point() else t.to(torch.float32)
        self.coll.all_reduce(t.contiguous(), "metric", mean=True)
        return t

    def _recorded(self, program: str, fn: Callable):
        """``fn()``, flight-recorded as the JAX step's programs are: the
        first call of a program (its warm-up: allocation, kernel builds
        and autotuning where the JAX step compiles) appends to
        ``compile_log`` and records a ``compile`` event; a failure records
        an ``error`` event before it propagates."""
        fresh = all(e["program"] != program for e in self.compile_log)
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception as e:
            flight.record_event("error", program=program,
                                error=f"{type(e).__name__}: {e}"[:500])
            raise
        if fresh:
            entry = {"program": program, "first_call_s": time.perf_counter() - t0}
            self.compile_log.append(entry)
            flight.record_event("compile", critical=False, **entry)
        return out

    def __call__(self, state: TrainState, batch) -> Tuple[TrainState, Dict[str, Any]]:
        return self._recorded("step", lambda: self._step(state, self._to_device(batch)))

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

        def window():
            st, history = state, []
            for i in range(num_steps):
                b = map_tree(lambda t: t[i], batch) if stacked else batch
                st, m = self._step(st, b)
                history.append(m)
            return st, map_params(lambda *steps: torch.stack(steps), *history)

        return self._recorded(f"run[{num_steps}{'/stacked' if stacked else ''}]", window)

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
            with pg.batch_stats_over(self.coll if split else None), self._sharded_forward():
                loss, aux = self._loss(params, local)
        if split:
            loss = self._mean_metric(loss)
            aux = map_params(self._mean_metric, aux) if aux is not None else None
        return {"loss": loss, "aux": aux} if self.has_aux else {"loss": loss}

    # ------------------------------------------------------------------ fit
    def fit(self, state: TrainState, batches, steps: Optional[int] = None, eval_batch=None,
            eval_every: int = 0, log_every: int = 0, window: int = 0,
            eval_metrics_fn=None):
        """A Keras-``fit``-shaped training loop over an iterable of batches
        (a :class:`~autodist_tpu_torch.data.DataLoader` or any iterator of
        batches, numpy or tensors), after the JAX step's ``fit``.

        Returns ``(state, history)``: ``history["loss"]`` holds each step's
        loss and ``history["eval_loss"]`` the periodic eval losses
        (``eval_every`` > 0 with ``eval_batch``). ``eval_metrics_fn``, a
        ``(params, batch) -> {name: value}`` function (the factories of
        ``autodist_tpu_torch.metrics``), adds ``history["eval_<name>"]``
        series computed at the same points on the logical parameters.
        ``steps`` cuts the iterator with ``islice``, so a shared iterator
        loses no batch beyond those run.

        ``window=k`` (k > 1) stacks ``k`` consecutive host batches and runs
        them as one ``run(stacked=True)``; windows are cut so that eval and
        ``steps`` boundaries land between them, and the per-step history is
        that of ``window=0``.
        """
        if window and window > 1:
            return self._fit_windowed(state, batches, steps, eval_batch, eval_every,
                                      log_every, window, eval_metrics_fn)
        history = {"loss": []}
        eval_metrics = self._make_eval_metrics(eval_metrics_fn)
        if eval_every and eval_batch is not None:
            history["eval_loss"] = []
        if steps is not None:
            batches = itertools.islice(batches, steps)
        for i, batch in enumerate(batches):
            state, metrics = self(state, batch)
            loss = float(metrics["loss"])
            history["loss"].append(loss)
            if log_every and (i + 1) % log_every == 0:
                logging.info("fit step %d: loss=%.6f", i + 1, loss)
            if eval_every and eval_batch is not None and (i + 1) % eval_every == 0:
                self._eval_point(state, eval_batch, history, eval_metrics, i + 1, log_every)
        return state, history

    def _eval_point(self, state, eval_batch, history, eval_metrics, step_i, log_every):
        ev_loss = float(self.evaluate(state, eval_batch)["loss"])
        history["eval_loss"].append(ev_loss)
        eval_metrics(state, eval_batch, history)
        if log_every:
            logging.info("fit step %d: eval_loss=%.6f", step_i, ev_loss)

    def compile_metrics(self, metrics_fn: Callable, state: TrainState) -> Callable:
        """A ``(params, batch) -> {name: value}`` callable that runs a task
        metric function on this step's stored parameters: under
        ``torch.no_grad()`` it copies offloaded leaves to the device (the
        path :meth:`evaluate` uses), gathers split variables and slices
        padded storage back to the logical shapes, and calls ``metrics_fn``
        on the logical parameters and the batch on the device. The JAX
        step jits the same function; nothing is compiled here, so ``state``
        is not read. ``metrics.evaluate_dataset`` and ``fit``'s eval hook
        both come through here."""
        del state

        def fn(params, batch):
            with torch.no_grad():
                params = self.plan.unpad_params(self._logical(self._stream_params(params)))
                return metrics_fn(params, self._to_device(batch))

        return fn

    def _make_eval_metrics(self, eval_metrics_fn):
        """``fit``'s task-metric hook: appends ``eval_<name>`` series to the
        history. ``<name>__weight`` entries (``metrics.evaluate_dataset``'s
        masked-metric convention) are dropped, since one eval point has no
        cross-batch weighting, and a metric named ``loss`` is recorded as
        ``eval_metrics_loss`` so that it never interleaves with the
        ``eval_loss`` series."""
        if eval_metrics_fn is None:
            return lambda state, batch, history: None
        compiled = None

        def run(state, batch, history):
            nonlocal compiled
            if compiled is None:
                compiled = self.compile_metrics(eval_metrics_fn, state)
            for k, v in compiled(state.params, batch).items():
                if k.endswith("__weight"):
                    continue
                name = "eval_metrics_loss" if k == "loss" else f"eval_{k}"
                history.setdefault(name, []).append(float(v))

        return run

    def _fit_windowed(self, state, batches, steps, eval_batch, eval_every, log_every,
                      window, eval_metrics_fn=None):
        """The ``fit(window=k)`` body (see :meth:`fit`).

        A DataLoader gives its ``host_batches()`` (this rank's numpy
        batches), stacked before the device copy and assembled by
        ``ShardingPlan.window_from_local``; any other iterable is stacked as
        it comes, which holds only at world size 1. A batch whose leaf
        shapes differ from the window's (a ragged final batch) ends the
        window and runs in the next: it is carried as ``pending``, never
        pulled twice or dropped, so the batches consumed are those run.
        """
        from_loader = hasattr(batches, "host_batches")
        if from_loader:
            it = iter(batches.host_batches())
        else:
            if self.world.size > 1:
                raise ValueError(
                    "fit(window>1) over several ranks needs a DataLoader: a generic "
                    "iterator's batches cannot be assembled into global windows")
            it = iter(batches)

        history = {"loss": []}
        eval_metrics = self._make_eval_metrics(eval_metrics_fn)
        if eval_every and eval_batch is not None:
            history["eval_loss"] = []

        def sig(b):
            return tuple(tuple(leaf.shape if hasattr(leaf, "shape") else np.shape(leaf))
                         for leaf in tree_leaves(b))

        _end = object()
        pending = None
        step_i = 0
        while steps is None or step_i < steps:
            # Cut the window so that steps and eval boundaries land between windows.
            chunk = window
            if steps is not None:
                chunk = min(chunk, steps - step_i)
            if eval_every and eval_batch is not None:
                chunk = min(chunk, eval_every - (step_i % eval_every))
            buf = []
            while len(buf) < chunk:
                if pending is not None:
                    b, pending = pending, None
                else:
                    b = next(it, _end)
                    if b is _end:
                        break
                if buf and sig(b) != sig(buf[0]):
                    pending = b          # a ragged or reshaped batch: the next window
                    break
                buf.append(b)
            if not buf:
                break
            if len(buf) == 1:
                batch = buf[0]
                if from_loader:
                    batch = self.plan.global_batch_from_rows(batch)
                state, metrics = self(state, batch)
                losses = [float(metrics["loss"])]
            else:
                stacked = _stack(buf)
                wnd = self.plan.window_from_local(stacked) if from_loader else stacked
                state, metrics = self.run(state, wnd, len(buf), stacked=True)
                losses = metrics["loss"].tolist()
            for loss in losses:
                step_i += 1
                history["loss"].append(loss)
                if log_every and step_i % log_every == 0:
                    logging.info("fit step %d: loss=%.6f", step_i, loss)
            if eval_every and eval_batch is not None and step_i % eval_every == 0:
                self._eval_point(state, eval_batch, history, eval_metrics, step_i, log_every)
        return state, history


def _stack(batches: List[Any]):
    """``k`` batches of one nesting stacked leaf by leaf on a new leading
    axis: numpy leaves with ``np.stack``, tensors with ``torch.stack``."""
    first = batches[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in batches]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([b[i] for b in batches]) for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack([to_tensor(b) for b in batches])
    return np.stack([np.asarray(b) for b in batches])
