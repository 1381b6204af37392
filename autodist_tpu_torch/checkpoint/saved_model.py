"""Serving export: a ``torch.export`` program plus its params (PyTorch port
of ``checkpoint/saved_model.py``).

The JAX package serializes ``jax.export``'s StableHLO program beside a
``Saver`` checkpoint of the params. Here the program is
``torch.export.export`` of ``apply_fn(params, *args)`` over the flat list
of the params' leaves in JAX's order (dicts, sequences and named tuples;
the structure is closed over at trace time, so loading never needs the
params' classes), saved as ``program.pt2``; the
params go through :class:`~autodist_tpu_torch.checkpoint.Saver` under
``params/`` with zero-padded index names, and ``saved_model.json`` is the
JAX package's manifest (``n_params``, ``leaf_index_width``,
``n_example_args``, ``in_avals``, ``out_avals``) plus the device type the
program was traced on.

The kernels run inside an exported program: while ``torch.export`` traces,
the model calls each kernel's ``torch.library`` operator
(``ops/library.py``), whose implementation is the kernel's wrapper, so the
loaded program launches the CUDA kernels on the card. The parity note
against StableHLO's "no model code": loading needs the port's operators
registered, which ``import autodist_tpu_torch`` does (this module imports
it); it needs no model code beyond that.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

import autodist_tpu_torch  # noqa: F401 - registers the kernels' operators
from autodist_tpu_torch.checkpoint.saver import (Saver, dtype_name, flatten_with_names,
                                                 map_with_names)
from autodist_tpu_torch.utils import logging

_PROGRAM_FILE = "program.pt2"
_META_FILE = "saved_model.json"
_PARAMS_DIR = "params"


def _aval(t) -> str:
    """JAX's ``ShapedArray`` string of a tensor: ``float32[5,8]``."""
    return f"{dtype_name(t.dtype)}[{','.join(str(int(d)) for d in t.shape)}]"


class _FlatApply(torch.nn.Module):
    """``apply_fn`` over the flat leaf list of the params, in the JAX
    package's leaf order (a dict's keys sorted): ``skeleton`` is the params'
    structure with each leaf's name in its place."""

    def __init__(self, apply_fn: Callable, skeleton, names):
        super().__init__()
        self.apply_fn, self.skeleton = apply_fn, skeleton
        self.index = {n: i for i, n in enumerate(names)}

    def forward(self, leaves, *args):
        params = map_with_names(lambda name, _: leaves[self.index[name]], self.skeleton)
        return self.apply_fn(params, *args)


class SavedModelBuilder:
    """Export ``apply_fn(params, *args)`` and trained params for serving."""

    def __init__(self, apply_fn: Callable):
        self.apply_fn = apply_fn

    def save(self, directory: str, params: Any, *example_args: Any) -> str:
        """Trace ``apply_fn`` on ``(params, *example_args)`` under
        ``torch.no_grad()``, save the program, the params and the manifest.
        The program runs on the device type it was traced on."""
        os.makedirs(directory, exist_ok=True)
        named = flatten_with_names(params)
        names, leaves = [n for n, _ in named], [t.detach() for _, t in named]
        skeleton = map_with_names(lambda name, _: name, params)
        with torch.no_grad():
            exported = torch.export.export(_FlatApply(self.apply_fn, skeleton, names),
                                           (leaves, *example_args), strict=False)
        torch.export.save(exported, os.path.join(directory, _PROGRAM_FILE))
        width = max(4, len(str(len(leaves))))
        Saver().save({str(i).zfill(width): t for i, t in enumerate(leaves)},
                     os.path.join(directory, _PARAMS_DIR))
        out_node = next(n for n in exported.graph.nodes if n.op == "output")
        outs = [a.meta["val"] for a in pytree.tree_leaves(out_node.args[0])
                if hasattr(a, "meta") and "val" in a.meta]
        args = [a for a in pytree.tree_leaves(list(example_args))
                if isinstance(a, torch.Tensor)]
        device = (leaves + args)[0].device.type if leaves + args else "cpu"
        meta = {
            "format": "autodist_tpu_torch.saved_model",
            "version": 1,
            "n_params": len(leaves),
            "leaf_index_width": width,
            "n_example_args": len(example_args),
            "in_avals": [_aval(t) for t in leaves + args],
            "out_avals": [_aval(t) for t in outs],
            "device": device,
        }
        with open(os.path.join(directory, _META_FILE), "w", encoding="utf-8") as f:
            json.dump(meta, f, indent=2)
        logging.info("saved model -> %s", directory)
        return directory


def load_saved_model(directory: str, device=None) -> Callable:
    """Load an exported model as ``fn(*args)`` with its params bound, on
    ``device`` (default: the device type it was traced on). The returned
    callable runs the exported program; ``fn.params`` are the leaves and
    ``fn.exported`` the ``ExportedProgram``."""
    with open(os.path.join(directory, _META_FILE), "r", encoding="utf-8") as f:
        meta = json.load(f)
    exported = torch.export.load(os.path.join(directory, _PROGRAM_FILE))
    leaf_dict = Saver().restore(os.path.join(directory, _PARAMS_DIR))
    dev = torch.device(device if device is not None else meta["device"])
    # Zero-padded index names: sorted order is the export's leaf order.
    leaves = [leaf_dict[k].to(dev) for k in sorted(leaf_dict)]
    if len(leaves) != meta["n_params"]:
        raise ValueError(f"saved model at {directory} has {len(leaves)} param leaves, "
                         f"manifest says {meta['n_params']}")
    module = exported.module()

    def serve(*args: Any):
        with torch.no_grad():
            return module(leaves, *args)

    serve.params = leaves  # type: ignore[attr-defined]
    serve.exported = exported  # type: ignore[attr-defined]
    return serve


__all__ = ["SavedModelBuilder", "load_saved_model"]
