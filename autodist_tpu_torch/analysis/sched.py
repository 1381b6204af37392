"""The schedule screen: plan arithmetic the planner runs on every candidate
(PyTorch port of the screen of the JAX package's ``analysis/sched.py``).

Before the search prices a candidate strategy, :func:`screen_schedule`
rejects two schedule defects from shapes and mesh degrees alone, with no
lowering and no program:

- **SLO001**: the candidate sets ``bucket_bytes > 0`` but no variable is
  bucket-eligible (every gradient rides a PS, sparse, expert, partitioned or
  compressed wire), so the bucketed sync has nothing to overlap;
- **SLM003**: the static state fits the memory headroom but the bucketed
  ZeRO-1 transient pushes the peak over. In the port's ``BucketSync``
  (``kernel/bucketing.py``) a bucket's ZeRO-1 gradients are concatenated
  into one flat, full-size staging buffer for the reduce-scatter while the
  gradients themselves still live; the largest bucket bounds those extra
  bytes, the same count the JAX package prices for its full-shape zero-fill
  buffer.

The passes over a compiled program's schedule (per-bucket overlap,
scheduled liveness, channel cycles) are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from autodist_tpu_torch.analysis.report import ERROR, Finding


@dataclass
class ScheduleScreen:
    """Pure-arithmetic projection of the schedule passes onto an unlowered
    Strategy: what the planner's search can afford on every candidate."""

    findings: List[Finding] = field(default_factory=list)
    state_bytes: float = 0.0
    transient_bytes: float = 0.0
    n_buckets: int = 0
    n_eligible: int = 0


def screen_schedule(strategy, model_item, resource_spec=None,
                    headroom: float = 0.75) -> List[Finding]:
    """The pre-lowering SLO001/SLM003 screen (the module docstring)."""
    return _screen_schedule(strategy, model_item, resource_spec, headroom).findings


def _screen_schedule(strategy, model_item, resource_spec=None,
                     headroom: float = 0.75) -> ScheduleScreen:
    from autodist_tpu_torch.kernel.bucketing import assign_buckets, bucket_exclusion_reasons
    from autodist_tpu_torch.strategy.cost_model import OPTIMIZER_SLOT_FACTOR
    from autodist_tpu_torch.strategy.ir import AllReduceSynchronizer, PSSynchronizer

    out = ScheduleScreen()
    bucket_bytes = int(getattr(strategy.graph_config, "bucket_bytes", 0) or 0)
    mesh = (resource_spec.mesh_shape(("data", "model")) if resource_spec
            else {"data": 1, "model": 1})
    n_data = max(int(mesh.get("data", 1)), 1)
    n_model = max(int(mesh.get("model", 1)), 1)
    slot_factor = OPTIMIZER_SLOT_FACTOR.get(
        getattr(model_item.optimizer_spec, "name", ""), 2.0)

    eligible: List[Tuple[str, int]] = []
    bucketed_su: Dict[str, int] = {}
    state = 0.0
    for node in strategy.node_config:
        try:
            var = model_item.var(node.var_name)
        except KeyError:
            continue  # screen_strategy's SLS001 owns unknown vars
        b = float(var.byte_size)
        sync = node.synchronizer
        try:
            part_axis = node.active_partition_axis
        except ValueError:
            part_axis = None
        shards = max(int(node.num_shards), 1) if part_axis is not None else 1
        shard_update = bool(isinstance(sync, AllReduceSynchronizer) and sync.shard_update)
        contrib = b / shards
        if var.trainable:
            contrib += slot_factor * b / (n_data if shard_update else shards)
            contrib += b  # full-gradient transient (the SLM001 accounting)
        state += contrib
        if not var.trainable:
            continue
        reasons = bucket_exclusion_reasons(
            var.shape, trainable=var.trainable, is_ps=isinstance(sync, PSSynchronizer),
            sparse_update=var.sparse_update, expert=var.expert, part_axis=part_axis,
            compressor=getattr(sync, "compressor", "") or "NoneCompressor",
            n_data=n_data, n_model=n_model)
        if not reasons:
            eligible.append((node.var_name, int(b)))
            if shard_update:
                bucketed_su[node.var_name] = int(b)
    out.state_bytes = state
    out.n_eligible = len(eligible)

    if bucket_bytes > 0:
        buckets = assign_buckets(eligible, bucket_bytes)
        out.n_buckets = len(buckets)
        if not eligible:
            out.findings.append(Finding(
                code="SLO001", severity=ERROR, pass_name="sched",
                message=(
                    f"candidate requests bucketed overlap "
                    f"(bucket_bytes={bucket_bytes}) but NO variable is "
                    f"bucket-eligible — every gradient rides a "
                    f"PS/sparse/expert/partitioned/compressed wire, so "
                    f"the bucket machinery is structurally unable to "
                    f"overlap anything"),
                details={"bucket_bytes": bucket_bytes, "n_eligible": 0},
            ))
        else:
            # The ZeRO-1 staging transient of the largest bucket.
            out.transient_bytes = max(
                (sum(bucketed_su.get(nm, 0) for nm in bucket) for bucket in buckets),
                default=0.0)
    if resource_spec is not None and out.transient_bytes > 0:
        usable = float(resource_spec.gpu.hbm_bytes) * headroom
        if usable > 0 and state <= usable < state + out.transient_bytes:
            out.findings.append(Finding(
                code="SLM003", severity=ERROR, pass_name="sched",
                message=(
                    f"scheduled-peak estimate {state / 1e6:.3f} MB state "
                    f"+ {out.transient_bytes / 1e6:.3f} MB bucket "
                    f"ZeRO-1 staging transient overcommits "
                    f"{usable / 1e6:.3f} MB usable even though the static "
                    f"state alone fits — shrink bucket_bytes or drop the "
                    f"bucketed rendering for this topology"),
                details={
                    "state_bytes": state,
                    "transient_bytes": out.transient_bytes,
                    "usable_bytes": usable,
                    "n_buckets": out.n_buckets,
                },
            ))
    return out
