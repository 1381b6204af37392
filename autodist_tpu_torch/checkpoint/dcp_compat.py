"""``torch.distributed.checkpoint`` interop: the torch-ecosystem
counterpart of the JAX package's Orbax bridge (``orbax_compat.py``).

The native :class:`~autodist_tpu_torch.checkpoint.Saver` owns the
production path (the JAX package's format, per-rank blocks, asynchronous
writes, cross-sharding restore). This bridge is for the ecosystem
boundary: DCP is the de-facto PyTorch checkpoint format, and a user moving
a train state between this port and a DCP-based codebase should not need
a conversion script.

The contract is the JAX bridge's: what crosses is the logical state
(``step.logical_state``: every leaf in the model's own shapes), stored as a
flat ``{"path/to/leaf": tensor}`` dict, so the restore side never depends
on a nested structure, and a foreign DCP checkpoint whose names match loads
too. Like the JAX bridge (one host), it exports a state whose leaves are
whole on this process: a step at world size 1. Import builds a fresh state
on the live step's plan and copies the loaded leaves into it, re-padded
and placed as the plan keeps them; a missing leaf raises before anything
is read.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from autodist_tpu_torch.checkpoint.saver import ShardedLeaf, flatten_with_names, map_with_names
from autodist_tpu_torch.utils import logging


def _flatten(tree) -> Dict[str, torch.Tensor]:
    """The flat ``{"path/to/leaf": tensor}`` view (the Saver's names); an int
    (``step``, a count) as a 0-d int32 tensor, as the JAX package stores
    it."""
    flat: Dict[str, torch.Tensor] = {}
    for name, leaf in flatten_with_names(tree):
        if name in flat:
            raise ValueError(f"flat name collision at {name!r}: two distinct leaves map "
                             f"to one checkpoint entry")
        if isinstance(leaf, ShardedLeaf):
            raise NotImplementedError(
                f"{name!r} is split over ranks: the DCP bridge carries whole leaves (a "
                f"step at world size 1), as the JAX package's Orbax bridge does one host")
        if isinstance(leaf, int):
            leaf = torch.tensor(leaf, dtype=torch.int32)
        flat[name] = leaf.detach().cpu().clone()
    return flat


def export_dcp(step, state, directory: str) -> str:
    """Write ``state``'s logical view as a DCP checkpoint of flat names."""
    import torch.distributed.checkpoint as dcp

    flat = _flatten(step.logical_state(state))
    dcp.save(flat, checkpoint_id=directory, no_dist=True)
    logging.info("exported %d leaves to DCP -> %s", len(flat), directory)
    return directory


def import_dcp(step, params, directory: str):
    """A fresh state of ``step`` (``step.init(params)``) filled from a DCP
    checkpoint written by :func:`export_dcp`, or any DCP checkpoint whose
    flat names match; a missing leaf raises ``KeyError``, a shape that
    differs ``ValueError``."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader

    state = step.init(params)
    logical = step.logical_state(state)
    template = _flatten(logical)
    stored = FileSystemReader(directory).read_metadata().state_dict_metadata
    missing = sorted(set(template) - set(stored))
    if missing:
        raise KeyError(f"DCP checkpoint is missing {len(missing)} leaves, e.g. "
                       f"{missing[:4]} — not a checkpoint of this state structure")
    for name, t in template.items():
        size = getattr(stored[name], "size", None)
        if size is not None and tuple(size) != tuple(t.shape):
            raise ValueError(f"DCP leaf {name!r} has shape {tuple(size)}, expected "
                             f"{tuple(t.shape)} (checkpoints hold logical shapes)")
    dcp.load(template, checkpoint_id=directory, no_dist=True)

    def restored(name, leaf: Any):
        value = template[name]
        return int(value.item()) if isinstance(leaf, int) else value.to(leaf.dtype)

    step.load_logical(state, map_with_names(restored, logical))
    logging.info("imported %d DCP leaves from %s", len(template), directory)
    return state


__all__ = ["export_dcp", "import_dcp"]
