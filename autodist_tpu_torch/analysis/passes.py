"""The plan-level static passes of the PyTorch port.

Ports the passes of the JAX package's ``analysis/passes.py`` that read a
lowered plan or an unlowered strategy, no program text:

- :func:`hbm_budget`: per device, params (sharded per the plan's storage
  axis, padded storage shapes) + optimizer slots (sharded per the update
  axis) + a full-gradient transient, plus a compiled temp/peak figure and a
  serving engine's KV page pool when given, against the spec's per-GPU
  memory with a headroom (SLM001/SLM002): an overcommit is a lint error,
  not an OOM at step one;
- :func:`degradation_check` (SLH003): the plan's ``shard_update`` flags
  against the one shared degradation predicate (``kernel/degrade.py``);
- :func:`screen_strategy` (SLS001): the defects that make a candidate
  strategy unlowerable, as findings, before the planner prices it.

The passes that read a compiled program (wire conformance, rendezvous and
alias hazards, measured wire) are not ported.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from autodist_tpu_torch.analysis.report import ERROR, WARNING, Finding

# Default fraction of per-device memory the static state may use; the cost
# model's HBM_USABLE_FRACTION, so lint and pricing agree on "fits".
DEFAULT_HEADROOM = 0.75


def _itemsize(dtype) -> int:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype).element_size()


def hbm_budget(
    plan,
    resource_spec=None,
    optimizer: str = "",
    headroom: float = DEFAULT_HEADROOM,
    temp_bytes: float = 0.0,
    serve_pool_bytes: float = 0.0,
    serve_shared_fraction: float = 0.0,
    serve_quant_capacity_x: float = 1.0,
) -> Tuple[List[Finding], Dict]:
    """Static per-device memory budget from the lowered plan.

    State = params (sharded over their storage axis, padded storage shapes)
    + optimizer slots (sharded over the update axis) + one full-gradient
    transient per trainable var; ``temp_bytes`` adds a program's own
    temp/peak figure. ``serve_pool_bytes`` adds a serving engine's static
    KV page pool (``InferenceEngine.page_pool_bytes``) as the named tenant
    ``serve.page_pool``, which can head the overcommit blame line.
    Host-offloaded vars live in pinned host memory and are left out.

    ``serve_shared_fraction`` (0..1, the engine's ``shared_fraction``) and
    ``serve_quant_capacity_x`` (>= 1, the engine's ``quant_capacity_x``:
    fp-equivalent bytes per physical pool byte) ride the summary only: the
    pool tenant's bytes are its PHYSICAL allocation, shared pages counted
    once and int8 pages at their quantized size, so neither changes the
    SLM001/002 verdict.

    The resource spec's ``gpu.hbm_bytes`` is the per-device capacity and
    ``num_gpus`` the device count (the JAX pass reads ``tpu.hbm_bytes`` and
    ``num_chips``); the summary keeps the JAX pass's keys.
    """
    from autodist_tpu_torch.strategy.cost_model import OPTIMIZER_SLOT_FACTOR

    findings: List[Finding] = []
    sizes = plan.mesh.shape
    data_axis = plan.mesh.data_axis
    slot_factor = OPTIMIZER_SLOT_FACTOR.get(optimizer, 2.0)

    def shards(dim, axis) -> int:
        return max(int(sizes.get(axis, 1)), 1) if dim is not None else 1

    state = 0.0
    per_var: Dict[str, float] = {}
    for name, p in plan.var_plans.items():
        elems = math.prod(p.storage_shape or tuple(p.var.shape) or (1,))
        b = float(elems) * _itemsize(p.var.dtype)
        if p.offload:
            continue  # pinned-host residency: not a device tenant
        update_axis = p.storage_axis if p.storage_dim is not None else data_axis
        contrib = b / shards(p.storage_dim, p.storage_axis)
        if p.var.trainable:
            contrib += slot_factor * b / shards(p.update_dim, update_axis)
            contrib += b  # transient full-gradient buffer
        state += contrib
        per_var[name] = contrib
    if serve_pool_bytes:
        state += float(serve_pool_bytes)
        per_var["serve.page_pool"] = float(serve_pool_bytes)
    capacity = float(resource_spec.gpu.hbm_bytes) if resource_spec else 0.0
    usable = capacity * headroom
    n_chips = max(int(resource_spec.num_gpus), 1) if resource_spec else 1
    top_vars = sorted(per_var, key=per_var.get, reverse=True)[:5]
    quant_x = max(float(serve_quant_capacity_x), 1.0)
    summary = {
        "state_gb_per_chip": state / 1e9,
        "temp_gb_per_chip": float(temp_bytes) / 1e9,
        "serve_pool_gb_per_chip": float(serve_pool_bytes) / 1e9,
        "serve_shared_fraction": min(max(float(serve_shared_fraction), 0.0), 1.0),
        "serve_quant_capacity_x": quant_x,
        "serve_pool_fp_equiv_gb_per_chip": float(serve_pool_bytes) * quant_x / 1e9,
        "capacity_gb_per_chip": capacity / 1e9,
        "usable_gb_per_chip": usable / 1e9,
        "headroom": headroom,
        "n_chips": n_chips,
        "top_vars": top_vars,
    }
    # An overcommit is actionable only if it names the tenants: the top three
    # (param + slots + gradient transient, per device) ride the message.
    top3 = ", ".join(f"{name} ({per_var[name] / 1e9:.3f} GB)" for name in top_vars[:3])
    if resource_spec is None:
        return findings, summary
    if state > usable:
        findings.append(Finding(
            code="SLM001", severity=ERROR, pass_name="memory",
            message=(
                f"static state {state / 1e9:.3f} GB/chip overcommits "
                f"{usable / 1e9:.3f} GB usable "
                f"({headroom:.0%} headroom of {capacity / 1e9:.2f} GB "
                f"HBM): OOM at step 1, re-shard or offload"
                + (f" — top contributors: {top3}" if top3 else "")),
            details=summary,
        ))
    elif temp_bytes and state + float(temp_bytes) > usable:
        findings.append(Finding(
            code="SLM002", severity=ERROR, pass_name="memory",
            message=(
                f"state {state / 1e9:.3f} GB + compiled temp "
                f"{float(temp_bytes) / 1e9:.3f} GB/chip overcommits "
                f"{usable / 1e9:.3f} GB usable"
                + (f" — top state contributors: {top3}" if top3 else "")),
            details=summary,
        ))
    return findings, summary


# ------------------------------------------------------------------- hazards
def degradation_check(plan, strategy=None) -> List[Finding]:
    """Plan flags against the one shared degradation predicate (SLH003).

    With ``strategy`` given, each node's ``shard_update`` request is replayed
    through ``kernel.degrade.zero1_degradation_reasons`` on this mesh and
    compared with what the plan flags: the check that catches a lowering
    rule drifting away from pricing and analysis within one package version.
    Degradations themselves are declared, never errors.
    """
    from autodist_tpu_torch import const
    from autodist_tpu_torch.kernel.degrade import (
        DEGRADATION_REASONS,
        zero1_degradation_reasons,
    )
    from autodist_tpu_torch.strategy.ir import AllReduceSynchronizer

    findings: List[Finding] = []
    sizes = plan.mesh.shape
    n_data = int(sizes.get(plan.mesh.data_axis, 1))
    n_model = int(sizes.get(const.MESH_AXIS_MODEL, 1))
    n_expert = int(sizes.get(const.MESH_AXIS_EXPERT, 1))
    nodes = {n.var_name: n for n in strategy.node_config} if strategy is not None else {}

    for name, p in plan.var_plans.items():
        unknown = [r for r in p.degradations if r not in DEGRADATION_REASONS]
        if unknown:
            findings.append(Finding(
                code="SLH003", severity=ERROR, var=name, pass_name="hazard",
                message=(f"plan declares unknown degradation reason(s) "
                         f"{unknown}: not in the shared predicate's "
                         f"vocabulary"),
            ))
        if p.shard_update and p.degradations:
            findings.append(Finding(
                code="SLH003", severity=ERROR, var=name, pass_name="hazard",
                message=("plan flags shard_update ACTIVE while declaring "
                         f"degradations {list(p.degradations)}"),
            ))
        node = nodes.get(name)
        if node is None or not isinstance(node.synchronizer, AllReduceSynchronizer):
            continue
        requested = bool(node.synchronizer.shard_update)
        if not requested and not p.shard_update:
            continue
        try:
            part_axis = node.active_partition_axis
        except ValueError:
            part_axis = None
        reasons = zero1_degradation_reasons(
            p.var.shape, sparse_update=p.var.sparse_update, expert=p.var.expert,
            part_axis=part_axis, compressor=p.compressor,
            n_data=n_data, n_model=n_model, n_expert=n_expert)
        expect_active = requested and not reasons
        if p.shard_update != expect_active:
            findings.append(Finding(
                code="SLH003", severity=ERROR, var=name, pass_name="hazard",
                message=(
                    f"strategy requests shard_update={requested} and the "
                    f"shared predicate says "
                    f"{'active' if expect_active else 'degrade'}"
                    f"{' (' + ', '.join(reasons) + ')' if reasons else ''}, "
                    f"but the plan rendered "
                    f"shard_update={p.shard_update} — lowering has drifted "
                    f"from kernel/degrade.py"),
                details={"reasons": list(reasons)},
            ))
        elif requested and reasons and tuple(p.degradations) != reasons:
            findings.append(Finding(
                code="SLH003", severity=WARNING, var=name, pass_name="hazard",
                message=(
                    f"quiet degradation is undeclared: predicate says "
                    f"{list(reasons)}, plan declares "
                    f"{list(p.degradations)}"),
            ))
    return findings


# -------------------------------------------------------------------- screen
def screen_strategy(strategy, model_item, resource_spec) -> List[Finding]:
    """Pre-lowering strategy screen (SLS001): the defects that make a
    candidate unlowerable or meaningless, cheap enough to run on every
    search seed before any pricing. Mirrors the hard errors
    ``GraphTransformer._fold_part_config`` and ``StrategyCompiler`` raise,
    as findings instead of exceptions.

    Asynchronous PS (``sync=False``) is rejected as the JAX package's
    screen rejects it, although ``AutoDist.build`` runs it through the
    host-driven ``AsyncPSTrainer``: the planner searches the lockstep step's
    space only, in both packages, so their winners stay the same."""
    from autodist_tpu_torch.kernel.lowering import GraphTransformer
    from autodist_tpu_torch.strategy.ir import PSSynchronizer

    findings: List[Finding] = []
    for node in strategy.node_config:
        try:
            var = model_item.var(node.var_name)
        except KeyError:
            findings.append(Finding(
                code="SLS001", severity=ERROR, var=node.var_name, pass_name="screen",
                message=f"strategy names unknown variable {node.var_name!r}"))
            continue
        try:
            axis = node.active_partition_axis
        except ValueError as e:
            findings.append(Finding(
                code="SLS001", severity=ERROR, var=node.var_name, pass_name="screen",
                message=f"invalid partitioner: {e}"))
            continue
        if axis is not None:
            if axis >= len(var.shape):
                findings.append(Finding(
                    code="SLS001", severity=ERROR, var=node.var_name, pass_name="screen",
                    message=(f"partition axis {axis} out of range for "
                             f"shape {tuple(var.shape)}")))
            elif node.num_shards > max(int(var.shape[axis]), 1):
                findings.append(Finding(
                    code="SLS001", severity=ERROR, var=node.var_name, pass_name="screen",
                    message=(f"{node.num_shards} shards exceed axis "
                             f"{axis} size {var.shape[axis]}")))
        sync = node.synchronizer
        if isinstance(sync, PSSynchronizer) and not sync.sync:
            findings.append(Finding(
                code="SLS001", severity=ERROR, var=node.var_name, pass_name="screen",
                message="async PS (sync=False) has no rendering in the lockstep step"))
        try:
            GraphTransformer._fold_part_config(node)
        except ValueError as e:
            findings.append(Finding(
                code="SLS001", severity=ERROR, var=node.var_name, pass_name="screen",
                message=str(e)))
    return findings
