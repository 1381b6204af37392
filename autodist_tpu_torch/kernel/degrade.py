"""The one predicate that decides whether ``shard_update`` (ZeRO-1) renders
for a variable (PyTorch port of ``kernel/degrade.py``).

``shard_update`` is a capability request: a variable claimed by a more
specific rendering (expert sharding, explicit partitioning, sparse
row-sharding), carried by a compressed wire, or with no dimension the data
axis divides keeps its usual rendering instead of erroring. The lowering
renders ZeRO-1 exactly where this returns no reason, and records the
reasons in the plan. Pure arithmetic on shapes and mesh degrees.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from autodist_tpu_torch.kernel.compressor import is_active_compressor

#: Every reason, in emission order.
DEGRADATION_REASONS = (
    "scalar",          # rank-0 var: nothing to scatter
    "compressed",      # an active compressor owns the wire
    "expert",          # expert-axis sharding claims the var first
    "partitioned",     # an explicit partition request lands (incl. fallback/pad)
    "sparse",          # sparse-update row-sharding claims the var first
    "non_divisible",   # no dimension divides the data axis: nothing shards
)


def zero1_degradation_reasons(
    shape: Sequence[int], *, sparse_update: bool = False, expert: bool = False,
    part_axis: Optional[int] = None, compressor: str = "NoneCompressor",
    n_data: int = 1, n_model: int = 1, n_expert: int = 1,
) -> Tuple[str, ...]:
    """Why a ``shard_update`` request would not render for a variable (in
    :data:`DEGRADATION_REASONS` order); empty = ZeRO-1 is active. Mirrors
    the lowering's precedence: expert > explicit partition (divisible,
    largest divisible fallback, or pad-and-mask) > sparse rows > ZeRO-1."""
    shape = tuple(int(d) for d in (shape or ()))
    n_data, n_model, n_expert = (max(int(x), 1) for x in (n_data, n_model, n_expert))
    n_shard = n_model if n_model > 1 else n_data
    reasons = []
    if not shape:
        reasons.append("scalar")
    if is_active_compressor(compressor):
        reasons.append("compressed")
    if shape and expert and n_expert > 1 and shape[0] % n_expert == 0:
        reasons.append("expert")
    if shape and part_axis is not None and part_axis < len(shape):
        d = shape[part_axis]
        divisible = d % n_shard == 0 and d >= n_shard
        fallback = any(x % n_shard == 0 and x >= n_shard for x in shape)
        if divisible or fallback or d > n_shard:
            reasons.append("partitioned")
    if shape and sparse_update and "partitioned" not in reasons:
        if (shape[0] % n_shard == 0 and shape[0] >= n_shard) or shape[0] > n_shard:
            reasons.append("sparse")
    if shape and (n_data <= 1 or not any(d % n_data == 0 and d >= n_data for d in shape)):
        reasons.append("non_divisible")
    return tuple(r for r in DEGRADATION_REASONS if r in reasons)
