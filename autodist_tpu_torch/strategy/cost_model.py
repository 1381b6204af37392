"""Analytical cost model for strategy selection (PyTorch port of
``strategy/cost_model.py``).

Given a built :class:`Strategy`, a :class:`ModelItem` and a
:class:`ResourceSpec`, it estimates, per step and per GPU:

- **synchronization time**: gradient bytes over the intra-node group
  (NVLink, or PCIe on a node without it) and the inter-node network, by
  the ring and hierarchical all-reduce formulas, with the PS destination's
  network port serializing its host's traffic;
- **weight-update time**: the optimizer's HBM traffic (params, gradients,
  slots), divided by each variable's residency shard count;
- **memory**: params, optimizer slots and a gradient buffer, against the
  card's usable HBM.

Compute is left out: every candidate runs the same FLOPs a GPU under data
parallelism, so it cannot change the ranking. The formulas are the JAX
package's, rule for rule (which axis shards a variable, when divisibility
forces replication, ZeRO-1 and ZeRO-3 residency, sparse tables priced as
the rows a step touches). Where the JAX package reads its TPU slice (ICI,
DCN, the TPU generation's HBM) the port reads the node model of
``resource_spec.py`` (:class:`~autodist_tpu_torch.resource_spec.GPUNode`):
ICI becomes the intra-node group, DCN the inter-node network a GPU.

Bandwidths, capacity and per-call latencies come from the resource spec
(its ``gpu:`` block sets any of them); the policy figures below are the
JAX package's, kept as module constants. Units are bytes and seconds;
wire bandwidths come in Gbit/s, HBM in GB and GB/s.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from autodist_tpu_torch.model_item import ModelItem, VarItem
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.ir import (
    AllReduceSynchronizer,
    NodeConfig,
    PSSynchronizer,
    Strategy,
)
from autodist_tpu_torch.utils import logging

# The share of an overlappable bucket collective's wire time that still
# shows on the critical path (GraphConfig.bucket_bytes > 0). The JAX
# package's prior, kept as policy: not measured on the H100 yet (the port's
# buckets launch from backward hooks; a tune() sweep's Calibration fits
# the measured step time on top of it).
OVERLAP_EXPOSED_FRACTION = 0.25

# Predictions closer than this are a tie: the slate's preference order
# (simplest mechanism first) decides. The JAX package's bands, tuned on its
# TPU sweeps, kept as policy: the H100's run-to-run spread of a step is of
# the same order on one card (host walls drift by tens of percent between
# calls, PERF.md), and not measured across cards yet.
NEAR_TIE_REL = 0.05          # one-GPU meshes
NEAR_TIE_REL_MULTI = 0.01    # multi-GPU meshes

# Canonical preference order on prediction ties: candidate_slate() order,
# shared by CostModel.rank and preferred_prediction. Names absent from it
# rank last, alphabetically.
SLATE_PREFERENCE = (
    "AllReduce", "Zero1", "PartitionedAR", "TensorParallel",
    "PSLoadBalancing", "PS(zero3)", "PS(zero1)", "Parallax",
    "RandomAxisPartitionAR", "PartitionedPS", "UnevenPartitionedPS",
    "AllReduce+bf16", "AllReduce+topk",
)

# Activation bytes a tensor-parallel variable synchronizes a step, when the
# ModelItem captured no batch; with one, batch x shape[-1] x 2 (bf16).
DEFAULT_ACT_BYTES = 1 << 20
ACT_BYTES_PER_ELEMENT = 2

# Fraction of an embedding table's rows a step touches (sparse wire).
DEFAULT_SPARSE_TOUCH = 0.05

# Fraction of HBM usable for state; the rest holds activations and
# workspace.
HBM_USABLE_FRACTION = 0.75

# Optimizer-slot count per parameter byte; unknown optimizers (a custom
# one) take adam's 2, so the memory check stays conservative.
OPTIMIZER_SLOT_FACTOR = {
    "sgd": 0.0, "momentum": 1.0, "adam": 2.0, "adamw": 2.0, "adagrad": 1.0,
    "rmsprop": 1.0, "lamb": 2.0, "lion": 1.0, "adafactor": 1.0,
}


def _tie_winner(times: Dict[str, float], order: Sequence[str], rel: float,
                memory: Optional[Dict[str, float]] = None) -> str:
    """Cheapest entry, except entries within ``rel`` of it form a tie,
    broken by position in ``order``, then lower ``memory``, then name:
    deterministic whatever the order of ``times``."""
    t0 = min(times.values())
    tied = [n for n, t in times.items() if t <= t0 * (1.0 + rel)]
    rank_of = {n: i for i, n in enumerate(order)}
    mem = memory or {}
    return min(tied, key=lambda n: (rank_of.get(n, len(order)),
                                    mem.get(n, float("inf")), n))


def _shard_weights(var: VarItem, node, n_dests: int) -> List[float]:
    """Fraction of ``var``'s wire each shard destination carries: the
    floor/ceil row split of the active axis (even when it is unknown)."""
    axis = node.active_partition_axis
    if axis is None or axis >= len(var.shape) or n_dests <= 0:
        return [1.0 / max(n_dests, 1)] * max(n_dests, 1)
    dim = int(var.shape[axis])
    base, rem = divmod(dim, n_dests)
    rows = [base + 1 if i < rem else base for i in range(n_dests)]
    total = float(sum(rows)) or 1.0
    return [r / total for r in rows]


_warned_compressors: set = set()


def compressor_wire_factor(name: Optional[str], shape, nshards: int = 1) -> float:
    """Wire-size multiplier of a gradient of ``shape`` under a compressor
    synced over ``nshards`` data shards: the compressor's own
    ``wire_factor`` (``kernel/compressor.py``). An unknown name is priced
    dense, with a warning once."""
    from autodist_tpu_torch.kernel.compressor import (canonical_compressor_name,
                                                      get_compressor)

    if not name or canonical_compressor_name(name) == "NoneCompressor":
        return 1.0
    try:
        comp = get_compressor(name)
    except ValueError:
        if name not in _warned_compressors:
            _warned_compressors.add(name)
            logging.warning("unknown compressor %r: pricing wire as dense", name)
        return 1.0
    return float(comp.wire_factor(tuple(shape), max(nshards, 1)))


def preferred_prediction(predicted_s: Dict[str, float], rel: float = NEAR_TIE_REL) -> str:
    """Auto's selection rule on a ``name -> predicted seconds`` table: the
    cheapest, or among those within ``rel`` of it the earliest
    :data:`SLATE_PREFERENCE` name."""
    return _tie_winner(predicted_s, SLATE_PREFERENCE, rel)


def candidate_slate(chunk_size: int = 128, include_sparse: bool = True,
                    full: bool = False) -> List[Tuple[str, object]]:
    """The candidates of Auto, ``AutoDist.tune`` and ``explain``.
    ``include_sparse`` adds Parallax; ``full`` the other builders and the
    two compressed wires (which change numerics: only ``explain`` lists
    them)."""
    from autodist_tpu_torch.strategy.all_reduce_strategy import AllReduce
    from autodist_tpu_torch.strategy.parallax_strategy import Parallax
    from autodist_tpu_torch.strategy.partitioned_all_reduce_strategy import PartitionedAR
    from autodist_tpu_torch.strategy.partitioned_ps_strategy import PartitionedPS
    from autodist_tpu_torch.strategy.ps_lb_strategy import PSLoadBalancing
    from autodist_tpu_torch.strategy.ps_strategy import PS
    from autodist_tpu_torch.strategy.random_axis_partition_all_reduce_strategy import (
        RandomAxisPartitionAR)
    from autodist_tpu_torch.strategy.tensor_parallel_strategy import TensorParallel
    from autodist_tpu_torch.strategy.uneven_partition_ps_strategy import UnevenPartitionedPS
    from autodist_tpu_torch.strategy.zero1_strategy import Zero1

    slate: List[Tuple[str, object]] = [
        ("AllReduce", AllReduce(chunk_size=chunk_size)),
        ("Zero1", Zero1(chunk_size=chunk_size)),
        ("PartitionedAR", PartitionedAR(chunk_size=chunk_size)),
        ("TensorParallel", TensorParallel()),
        ("PSLoadBalancing", PSLoadBalancing()),
        ("PS(zero3)", PS(local_proxy_variable=False)),
        ("PS(zero1)", PS(local_proxy_variable=True)),
    ]
    if include_sparse:
        slate.append(("Parallax", Parallax(chunk_size=chunk_size)))
    if full:
        slate.extend([
            ("RandomAxisPartitionAR", RandomAxisPartitionAR(chunk_size=chunk_size)),
            ("PartitionedPS", PartitionedPS()),
            ("UnevenPartitionedPS", UnevenPartitionedPS()),
            ("AllReduce+bf16", AllReduce(chunk_size=chunk_size, compressor="bf16")),
            ("AllReduce+topk", AllReduce(chunk_size=chunk_size, compressor="topk")),
        ])
    return slate


def lossless_slate(model_item: ModelItem, resource_spec: ResourceSpec) -> Dict[str, object]:
    """The full slate built for (model x cluster), without the builders
    that fail there and the strategies whose compressed wire changes
    numerics (the search's seed policy): name -> Strategy."""
    from autodist_tpu_torch.strategy.explain import _lossy

    slate = {}
    for name, builder in candidate_slate(full=True):
        try:
            built = builder.build(model_item, resource_spec)
        except Exception:  # noqa: BLE001 - an unbuildable seed is skipped
            continue
        if not _lossy(built):
            slate[name] = built
    return slate


def default_calibration_path() -> str:
    """Where ``tune()`` writes, and ``Calibration.load()`` reads, the
    port's calibration: its own working directory."""
    from autodist_tpu_torch import const

    return os.path.join(const.DEFAULT_WORKING_DIR, "calibration.json")


@dataclass
class Calibration:
    """A measured correction on top of the analytical model, fitted by
    ``AutoDist.tune``: ``measured_step_s ~= base_s + scale x
    predicted_total_s`` (``base_s`` takes the compute every candidate
    shares, ``scale`` the achieved fraction of peak). Monotonic for
    ``scale > 0``, so it leaves the ranking as it is."""

    base_s: float = 0.0
    scale: float = 1.0
    device: str = ""
    n_points: int = 0

    @classmethod
    def fit(cls, predicted: Sequence[float], measured: Sequence[float],
            device: str = "") -> "Calibration":
        """Least squares over (predicted, measured) pairs. One point (or
        predictions all equal) pins ``base_s`` only; a fitted scale <= 0
        falls back to 1."""
        pred = np.asarray(predicted, np.float64)
        meas = np.asarray(measured, np.float64)
        ok = np.isfinite(pred) & np.isfinite(meas)
        pred, meas = pred[ok], meas[ok]
        if pred.size == 0:
            return cls(device=device)
        if pred.size == 1 or float(np.ptp(pred)) < 1e-12:
            return cls(base_s=float(np.mean(meas - pred)), scale=1.0, device=device,
                       n_points=int(pred.size))
        scale, base = np.polyfit(pred, meas, 1)
        if scale <= 0:
            scale, base = 1.0, float(np.mean(meas - pred))
        return cls(base_s=float(base), scale=float(scale), device=device,
                   n_points=int(pred.size))

    def predict_s(self, cost: "StrategyCost") -> float:
        return self.base_s + self.scale * cost.total_s

    def save(self, path: Optional[str] = None) -> str:
        """Write atomically (a reader never sees a torn file); default
        :func:`default_calibration_path`."""
        path = path or default_calibration_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"base_s": self.base_s, "scale": self.scale, "device": self.device,
                       "n_points": self.n_points}, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: Optional[str] = None) -> Optional["Calibration"]:
        """The calibration at ``path`` (default
        :func:`default_calibration_path`), or ``None`` when it is missing
        or unreadable."""
        path = path or default_calibration_path()
        if not os.path.exists(path):
            return None
        try:
            with open(path, "r", encoding="utf-8") as f:
                d = json.load(f)
        except (json.JSONDecodeError, OSError):
            return None
        return cls(base_s=float(d.get("base_s", 0.0)), scale=float(d.get("scale", 1.0)),
                   device=str(d.get("device", "")), n_points=int(d.get("n_points", 0)))


@dataclass
class StrategyCost:
    """Estimated per-step cost of one strategy on one cluster."""

    comm_s: float          # gradient/param synchronization (wire) time
    update_s: float        # optimizer HBM traffic time
    latency_s: float       # per-collective latency
    act_sync_s: float      # tensor-parallel activation synchronization
    per_chip_bytes: float  # resident state a GPU: params + slots + grad buffer
    hbm_bytes: float       # usable capacity a GPU (already derated)
    n_collectives: int
    gather_s: float = 0.0  # ZeRO-1's parameter all-gather
    opt_bytes: float = 0.0  # optimizer slots a GPU (part of per_chip_bytes)
    # Bucketed wire that the backward can hide (all buckets but the last).
    overlap_s: float = 0.0

    @property
    def total_s(self) -> float:
        return (self.comm_s + self.update_s + self.latency_s + self.act_sync_s
                + self.gather_s + OVERLAP_EXPOSED_FRACTION * self.overlap_s)

    @property
    def feasible(self) -> bool:
        return self.per_chip_bytes <= self.hbm_bytes

    def describe(self) -> str:
        return (f"total {self.total_s * 1e3:.3f} ms "
                f"(comm {self.comm_s * 1e3:.3f}, update {self.update_s * 1e3:.3f}, "
                f"lat {self.latency_s * 1e3:.3f}, act {self.act_sync_s * 1e3:.3f}, "
                f"gather {self.gather_s * 1e3:.3f}, overlap {self.overlap_s * 1e3:.3f}) "
                f"mem {self.per_chip_bytes / 1e9:.2f}/{self.hbm_bytes / 1e9:.2f} GB "
                f"(opt {self.opt_bytes / 1e9:.2f}) {'ok' if self.feasible else 'OVER'}")


class CostModel:
    """Per-step time and memory of candidate strategies on one cluster, by
    the lowering's residency rules (``kernel/lowering.py``): a partition
    request shards over the model axis when the spec's mesh makes it
    larger than 1, else over the data axis (ZeRO); gradients reduce over
    the data axis; dense PS variables get ZeRO-1 (proxy) or ZeRO-3
    residency; sparse tables are row-sharded and priced as touched rows.
    Per-call latencies come from the node model (``resource_spec.gpu``);
    the policy figures are this module's constants."""

    def __init__(self, model_item: ModelItem, resource_spec: ResourceSpec, *,
                 act_bytes: Optional[float] = None,
                 sparse_touch_fraction: float = DEFAULT_SPARSE_TOUCH):
        self.model_item = model_item
        self.spec = resource_spec
        gpu = resource_spec.gpu
        self.act_bytes = float(act_bytes) if act_bytes is not None else None
        self.sparse_touch = float(sparse_touch_fraction)
        self.intra_latency = gpu.intra_latency_us * 1e-6
        self.inter_latency = gpu.inter_latency_us * 1e-6

        self.n = max(resource_spec.num_gpus, 1)
        self.m = max(resource_spec.num_nodes, 1)
        self.chips_per_node = max(self.n // self.m, 1)
        mesh_shape = resource_spec.mesh_shape(("data", "model"))
        self.n_data = max(int(mesh_shape.get("data", 1)), 1)
        self.n_model = max(int(mesh_shape.get("model", 1)), 1)
        self.n_expert = max(int(mesh_shape.get("expert", 1)), 1)
        self.n_shard = self.n_model if self.n_model > 1 else self.n_data
        self.bw_intra = gpu.intra_node_gbps * 1e9 / 8.0
        self.bw_inter = resource_spec.network_bandwidth * 1e9 / 8.0
        self.hbm_bw = gpu.hbm_bandwidth_bytes
        self.hbm_cap = gpu.hbm_bytes * HBM_USABLE_FRACTION
        # One GPU issues no collectives at all: no latency term there.
        self.latency = (0.0 if self.n <= 1 else self.intra_latency if self.m == 1
                        else self.inter_latency)
        self.slot_factor = OPTIMIZER_SLOT_FACTOR.get(model_item.optimizer_spec.name, 2.0)

    # ----------------------------------------------------------- primitives
    def allreduce_s(self, nbytes: float, participants: Optional[int] = None) -> float:
        """Ring all-reduce of ``nbytes`` over the data group (default):
        inside a node on its intra-node group; across nodes hierarchical
        (intra-node reduce-scatter, inter-node all-reduce of the shards)."""
        p = participants if participants is not None else self.n_data
        if p <= 1:
            return 0.0
        if self.m == 1 or p <= self.chips_per_node:
            return 2.0 * nbytes * (p - 1) / p / self.bw_intra
        c = max(p // self.m, 1)
        intra = 2.0 * nbytes * (c - 1) / c / self.bw_intra if c > 1 else 0.0
        inter = 2.0 * (nbytes / c) * (self.m - 1) / self.m / self.bw_inter
        return intra + inter

    def _group_latency(self, participants: int) -> float:
        """Latency of a collective over ``participants`` GPUs: intra-node
        when the group fits inside a node."""
        if self.m == 1 or participants <= self.chips_per_node:
            return self.intra_latency
        return self.inter_latency

    def _oneway_s(self, nbytes: float, participants: Optional[int] = None) -> float:
        """All-gather / reduce-scatter: half an all-reduce."""
        return self.allreduce_s(nbytes, participants) / 2.0

    def _sharded(self, var: VarItem, axis: Optional[int]) -> int:
        """Residency shard count the lowering realizes for a partition
        request on ``axis`` (divisible, the largest divisible fallback, or
        pad-and-mask past the degree), else 1."""
        k = self.n_shard
        if k <= 1 or not var.shape or axis is None:
            return 1
        if var.shape[axis] % k == 0 and var.shape[axis] >= k:
            return k
        if any(d % k == 0 and d >= k for d in var.shape) or var.shape[axis] > k:
            return k
        return 1

    def _residency_bytes(self, var: VarItem, axis: Optional[int], shards: int) -> float:
        """Stored bytes: the zero-padded size under pad-and-mask, else the
        logical size."""
        B = float(var.byte_size)
        if shards <= 1 or axis is None or not var.shape:
            return B
        if var.shape[axis] % shards == 0 or any(
                d % shards == 0 and d >= shards for d in var.shape):
            return B
        padded = -(-var.shape[axis] // shards) * shards
        return B * padded / var.shape[axis]

    def _act_bytes_for(self, var: VarItem) -> float:
        """Activation bytes one tensor-parallel collective moves for
        ``var``: ``act_bytes`` when given, else batch x shape[-1] x 2, else
        :data:`DEFAULT_ACT_BYTES`."""
        if self.act_bytes is not None:
            return self.act_bytes
        bs = self.model_item.batch_size
        if bs and var.shape:
            return float(bs) * float(var.shape[-1]) * ACT_BYTES_PER_ELEMENT
        return DEFAULT_ACT_BYTES

    def _update_axis_shards(self, var: VarItem) -> int:
        """Slot sharding of PS variables over the data axis."""
        k = self.n_data
        if k <= 1 or not var.shape:
            return 1
        return k if any(d % k == 0 and d >= k for d in var.shape) else 1

    def _zero1_degradations(self, var: VarItem, part_axis, compressor):
        from autodist_tpu_torch.kernel.degrade import zero1_degradation_reasons

        return zero1_degradation_reasons(
            var.shape, sparse_update=var.sparse_update, expert=var.expert,
            part_axis=part_axis, compressor=compressor, n_data=self.n_data,
            n_model=self.n_model, n_expert=self.n_expert)

    def _sparse_cost(self, var: VarItem, update_traffic_factor: float):
        """(comm_s, update_s, param_bytes, extra_bytes, opt_bytes, shards)
        of a row-sharded sparse table: the touched rows' gather forward and
        scatter backward; row-sharded residency (padded if need be) when
        the table has at least the axis's rows."""
        B = float(var.byte_size)
        wire = B * self.sparse_touch
        comm = 2.0 * self._oneway_s(wire)
        if var.shape and self.n_shard > 1 and var.shape[0] >= self.n_shard:
            shards = self.n_shard
            res = self._residency_bytes(var, 0, shards)
        else:
            shards = self._update_axis_shards(var)
            res = B
        update = update_traffic_factor * B * self.sparse_touch / shards / self.hbm_bw
        params = res / shards
        opt = self.slot_factor * res / shards
        return comm, update, params, opt + wire, opt, shards

    # ------------------------------------------------------------ node costs
    def _node_cost(self, node: NodeConfig, var: VarItem):
        """(comm_s, update_s, act_s, gather_s, param_bytes, slot+grad bytes,
        opt_bytes, n_collectives, shard_update_active, ps_host_loads) of
        one variable."""
        B = float(var.byte_size)
        sync = node.synchronizer
        update_traffic_factor = 3.0 + 2.0 * self.slot_factor  # param rw + grad r + slots rw
        ps_loads: Dict[str, float] = {}

        if var.expert and var.shape and self.n_expert > 1 and \
                var.shape[0] % self.n_expert == 0:
            # Expert-sharded: 1/n_expert resident, gradient reduced over the
            # data group only.
            res = B / self.n_expert
            comm = self.allreduce_s(res)
            update = update_traffic_factor * res / self.hbm_bw
            opt = self.slot_factor * res
            return comm, update, 0.0, 0.0, res, opt + res, opt, 1, False, ps_loads

        if isinstance(sync, AllReduceSynchronizer):
            part_axis = node.active_partition_axis
            if var.sparse_update and part_axis is None:
                from autodist_tpu_torch.kernel.compressor import is_active_compressor

                if is_active_compressor(sync.compressor) and self.n_model == 1:
                    # An active compressor puts the step in the manual
                    # semantics: the table enters whole and its dense
                    # gradient syncs at table size.
                    comm = self._oneway_s(B) + self.allreduce_s(B)
                    update = update_traffic_factor * B / self.hbm_bw
                    opt = self.slot_factor * B
                    return comm, update, 0.0, 0.0, B, opt + B, opt, 1, False, ps_loads
                comm, update, params, extra, opt, _ = self._sparse_cost(
                    var, update_traffic_factor)
                return comm, update, 0.0, 0.0, params, extra, opt, 1, False, ps_loads
            shards = self._sharded(var, part_axis)
            res = self._residency_bytes(var, part_axis, shards)
            act = 0.0
            if shards <= 1:
                upd_shards = self._update_axis_shards(var)
                if sync.shard_update and not self._zero1_degradations(
                        var, part_axis, sync.compressor):
                    # ZeRO-1: the ring's reduce-scatter and all-gather
                    # halves, slots and update 1/n, two collectives.
                    comm = self._oneway_s(B)
                    gather = self._oneway_s(B)
                    update = update_traffic_factor * B / upd_shards / self.hbm_bw
                    opt = self.slot_factor * B / upd_shards
                    return comm, update, 0.0, gather, B, opt + B, opt, 2, True, ps_loads
                comm = self.allreduce_s(
                    res * compressor_wire_factor(sync.compressor, var.shape, self.n_data))
            elif self.n_model > 1:
                # Tensor parallelism on the model axis: each GPU's slice
                # reduced over the data group (compressed as a slice, which
                # is what the port's compressor sees), an activation
                # all-gather over the model group forward and backward.
                slice_shape = list(var.shape)
                if part_axis is not None and part_axis < len(slice_shape):
                    slice_shape[part_axis] = max(1, -(-slice_shape[part_axis] // shards))
                comm = self.allreduce_s((res / shards) * compressor_wire_factor(
                    sync.compressor, slice_shape, self.n_data))
                act = 2.0 * (self._group_latency(self.n_shard)
                             + self._oneway_s(self._act_bytes_for(var), self.n_shard))
            else:
                # Data-axis parameter sharding (ZeRO-3): all-gathered for
                # forward and backward, gradient reduce-scattered; no
                # compressor applies.
                comm = 3.0 * self._oneway_s(res)
            update = update_traffic_factor * res / shards / self.hbm_bw
            opt = self.slot_factor * res / shards
            return comm, update, act, 0.0, res / shards, opt + res, opt, 1, False, ps_loads

        assert isinstance(sync, PSSynchronizer)
        if var.sparse_update:
            comm, update, params, extra, opt, shards = self._sparse_cost(
                var, update_traffic_factor)
        else:
            part_axis = node.active_partition_axis
            if part_axis is not None:
                upd_shards = self._sharded(var, part_axis)
                res = self._residency_bytes(var, part_axis, upd_shards)
            else:
                upd_shards = self._update_axis_shards(var)
                res = B
            if sync.local_replication and part_axis is None:
                # ZeRO-1: replicated param, gradient all-reduced, the owner
                # shard's update broadcast back.
                comm = self.allreduce_s(B) + self._oneway_s(B)
                params = B
            else:
                # ZeRO-3 / partitioned: reduce-scatter + all-gather on use.
                comm = 3.0 * self._oneway_s(res)
                params = res / upd_shards
            update = update_traffic_factor * res / upd_shards / self.hbm_bw
            opt = self.slot_factor * res / upd_shards
            extra = opt + res
        if self.m > 1:
            # Across nodes the destination host's network port serializes
            # this variable's traffic, each shard destination its slice.
            wire_inter = (B * self.sparse_touch) if var.sparse_update else B
            load = 2.0 * (self.m - 1) * wire_inter / self.bw_inter
            node_dest = sync.reduction_destination or "chief"
            if node.part_config and len(node.part_config) != node.num_shards:
                raise ValueError(f"{node.var_name!r}: {len(node.part_config)} part configs "
                                 f"but partitioner {node.partitioner!r} implies "
                                 f"{node.num_shards}")
            shard_dests = [p.synchronizer.reduction_destination or node_dest
                           for p in node.part_config
                           if isinstance(p.synchronizer, PSSynchronizer)]
            if shard_dests:
                weights = _shard_weights(var, node, len(shard_dests))
                for d, w in zip(shard_dests, weights):
                    host = d.split(":", 1)[0]
                    ps_loads[host] = ps_loads.get(host, 0.0) + load * w
            else:
                host = node_dest.split(":", 1)[0]
                ps_loads[host] = ps_loads.get(host, 0.0) + load
        return comm, update, 0.0, 0.0, params, extra, opt, 2, False, ps_loads

    def _bucketable(self, node: NodeConfig, var: VarItem) -> bool:
        """Bucket eligibility by the one shared predicate
        (``kernel/bucketing.py``) on this model's mesh degrees."""
        from autodist_tpu_torch.kernel.bucketing import bucket_exclusion_reasons

        try:
            part_axis = node.active_partition_axis
        except ValueError:
            part_axis = None
        return not bucket_exclusion_reasons(
            var.shape, trainable=var.trainable,
            is_ps=not isinstance(node.synchronizer, AllReduceSynchronizer),
            sparse_update=var.sparse_update, expert=var.expert, part_axis=part_axis,
            compressor=getattr(node.synchronizer, "compressor", "NoneCompressor"),
            n_data=self.n_data, n_model=self.n_model, n_expert=self.n_expert)

    # -------------------------------------------------------------- strategy
    def strategy_cost(self, strategy: Strategy) -> StrategyCost:
        comm = update = act = gather = params_bytes = extra_bytes = opt_bytes = 0.0
        groups: set = set()
        su_groups: set = set()
        n_ps_coll = 0
        host_loads: Dict[str, float] = {}
        bucket_bytes = int(getattr(strategy.graph_config, "bucket_bytes", 0) or 0)
        # (name, var bytes, comm, shard_update) of each bucketed variable,
        # in model order: the lowering's assignment input.
        bucket_rows: List[Tuple[str, float, float, bool]] = []
        for node in strategy.node_config:
            try:
                var = self.model_item.var(node.var_name)
            except KeyError:
                continue
            c, u, a, g, p, e, ob, n_coll, su_active, loads = self._node_cost(node, var)
            comm += c
            update += u
            act += a
            gather += g
            params_bytes += p
            extra_bytes += e
            opt_bytes += ob
            for h, load in loads.items():
                host_loads[h] = host_loads.get(h, 0.0) + load
            sync = node.synchronizer
            if isinstance(sync, AllReduceSynchronizer):
                if bucket_bytes > 0 and self._bucketable(node, var):
                    bucket_rows.append((var.name, float(var.byte_size), c, su_active))
                    continue
                leaf_groups = ([p.synchronizer.group for p in node.part_config
                                if isinstance(p.synchronizer, AllReduceSynchronizer)]
                               or [sync.group])
                (su_groups if su_active else groups).update(leaf_groups)
            else:
                n_ps_coll += n_coll
        # Buckets: the lowering's reverse-order greedy assignment; every
        # bucket's wire but the last-closing one overlaps the backward.
        overlap = 0.0
        n_bucket_coll = 0
        if bucket_rows:
            from autodist_tpu_torch.kernel.bucketing import assign_buckets

            buckets = assign_buckets([(nm, b) for nm, b, _, _ in bucket_rows], bucket_bytes)
            comm_of = {nm: c for nm, _, c, _ in bucket_rows}
            per_bucket = [sum(comm_of[nm] for nm in names) for names in buckets]
            overlap = sum(per_bucket[:-1])
            n_bucket_coll = len(buckets) + (1 if any(su for *_, su in bucket_rows) else 0)
        # The PS destination's port serializes its host's traffic: charge
        # the slower of the two, before the overlappable wire comes out.
        if host_loads:
            comm = max(comm, max(host_loads.values()))
        comm = max(comm - overlap, 0.0)
        n_collectives = len(groups) + 2 * len(su_groups) + n_ps_coll + n_bucket_coll
        return StrategyCost(
            comm_s=comm, update_s=update, latency_s=n_collectives * self.latency,
            act_sync_s=act, gather_s=gather, overlap_s=overlap,
            per_chip_bytes=params_bytes + extra_bytes, hbm_bytes=self.hbm_cap,
            n_collectives=n_collectives, opt_bytes=opt_bytes)

    @property
    def tie_band(self) -> float:
        """The relative band within which predictions tie on this mesh."""
        return NEAR_TIE_REL if self.n <= 1 else NEAR_TIE_REL_MULTI

    def rank(self, candidates: Sequence[Tuple[str, Strategy]]
             ) -> List[Tuple[str, StrategyCost]]:
        """Cost each candidate; feasible ones first, each tier by time (the
        infeasible by memory). Within :attr:`tie_band` of the best feasible
        prediction :data:`SLATE_PREFERENCE` decides, then lower memory,
        then name: never the caller's order."""
        costed = [(name, self.strategy_cost(s)) for name, s in candidates]
        ranked = sorted(costed, key=lambda nc: (
            not nc[1].feasible, nc[1].total_s if nc[1].feasible else nc[1].per_chip_bytes))
        if ranked and ranked[0][1].feasible:
            feas = {name: c.total_s for name, c in ranked if c.feasible}
            mem = {name: c.per_chip_bytes for name, c in ranked if c.feasible}
            win_name = _tie_winner(feas, SLATE_PREFERENCE, self.tie_band, memory=mem)
            winner = next(nc for nc in ranked if nc[0] == win_name)
            ranked.remove(winner)
            ranked.insert(0, winner)
        return ranked
