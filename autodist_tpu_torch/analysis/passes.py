"""The plan-level static memory pass of the PyTorch port.

Ports :func:`hbm_budget` of the JAX package's ``analysis/passes.py``: plain
arithmetic over a lowered plan's variables and a resource spec, no program
text. Per device: params (sharded per the plan's storage axis, padded
storage shapes) + optimizer slots (sharded per the update axis) + a
full-gradient transient, plus a compiled temp/peak figure and a serving
engine's KV page pool when given, against the spec's per-GPU memory with a
headroom (SLM001/SLM002): an overcommit is a lint error, not an OOM at step
one. The passes that read a compiled program (wire conformance, hazards,
schedule) are not ported.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from autodist_tpu_torch.analysis.report import ERROR, Finding

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
