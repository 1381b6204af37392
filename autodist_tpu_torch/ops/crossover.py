"""Measured attention crossovers: when "auto" picks a CUDA kernel (PyTorch
port of ``ops/crossover.py``).

``tools/torch_crossover_sweep.py`` times a bert_base-width train step with
``attention_impl`` "dot" against "flash", and a decode step's paged
attention with the gather against the page-walking kernel, on the card,
and records the two tables this module reads:
``ops/measured/flash_crossover.json`` (rows ``seq``/``impl``/
``tokens_per_sec``) and ``ops/measured/paged_crossover.json`` (rows
``batch``/``table_pages``/``page_len``/``heads``/``impl``/
``tokens_per_sec``), the JAX package's row formats, each row with the
card's ``device`` name and ``power_limit``.

The rules are the JAX package's, unchanged:

- :func:`flash_crossover_seq`: the smallest measured sequence length from
  which "flash" never loses to "dot" again; the packaged default (1024)
  when the table is missing, unreadable or records no crossover;
- :func:`resolve_attention_impl`: "flash" at and above that length when
  the sequence is block-aligned (the kernel's own constraint), else "dot";
- :func:`paged_crossover_timeline`: the same over timeline widths (table
  pages x page_len), for the nearest recorded (batch, heads) bucket;
- :func:`resolve_paged_impl`: "kernel" at and above that timeline.

Each result is cached per path (and per bucket).

The device rule: the tables are the H100's, so they decide only for CUDA
tensors. On the CPU, which runs the plain versions and serves as the test
vehicle, "auto" resolves as the JAX package's rules do off its own
accelerator: the flash side against the packaged default of 1024 (the
table is not read), the paged side always "gather" (JAX's rule off the
TPU).

The dtype rule (flash side): the H100 flash table records the compute
dtype it was measured in (``model.dtype``, bfloat16) and decides only for
CUDA attention in that dtype. Other dtypes (the fp32 kernels are other
designs, never timed against "dot"), and a call that names no dtype,
resolve against the packaged default of 1024. A table that records no
dtype (the JAX package's) decides for every dtype.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import torch

#: Fallback when no measured table is readable: the JAX package's packaged
#: breakeven (flash ties dot at s=1024 and wins beyond, on its accelerator).
DEFAULT_FLASH_CROSSOVER_SEQ = 1024
#: Fallback paged crossover (timeline width, table pages x page_len).
DEFAULT_PAGED_CROSSOVER_TIMELINE = 1024

#: The flash kernel's block alignment (``ops/flash_attention.py::BLOCK``;
#: other sequences take the plain reference).
_FLASH_BLOCK = 128

_MEASURED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "measured")
FLASH_TABLE = os.path.join(_MEASURED_DIR, "flash_crossover.json")
PAGED_TABLE = os.path.join(_MEASURED_DIR, "paged_crossover.json")

_cache: dict = {}


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


def _flash_table(path: Optional[str] = None):
    """``(crossover seq, recorded dtype name or None)`` of the flash table
    at ``path`` (default: the packaged H100 table). Cached per path."""
    key = path or "__default__"
    if key in _cache:
        return _cache[key]
    out, dtype = DEFAULT_FLASH_CROSSOVER_SEQ, None
    try:
        with open(path or FLASH_TABLE, "r", encoding="utf-8") as f:
            table = json.load(f)
        rows = table.get("rows", [])
        model = table.get("model")
        dtype = model.get("dtype") if isinstance(model, dict) else None
        by_seq: dict = {}
        for r in rows:
            by_seq.setdefault(int(r["seq"]), {})[str(r["impl"])] = float(
                r["tokens_per_sec"])
        seqs = sorted(s for s, v in by_seq.items() if "dot" in v and "flash" in v)
        for i, s in enumerate(seqs):
            if all(by_seq[t]["flash"] >= by_seq[t]["dot"] for t in seqs[i:]):
                out = s
                break
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        pass  # unmeasured installs use the packaged default
    _cache[key] = (out, dtype)
    return out, dtype


def flash_crossover_seq(path: Optional[str] = None) -> int:
    """Smallest measured seq length from which "flash" never loses to "dot"
    (tokens/sec) in the table at ``path`` (default: the packaged H100
    table); the packaged default when the file is missing, unreadable, or
    records no crossover. Cached per path."""
    return _flash_table(path)[0]


def resolve_attention_impl(impl: str, seq_len: int, device=None, dtype=None) -> str:
    """The ``attention_impl="auto"`` rule: "flash" at and above the
    crossover when the sequence is block-aligned, else "dot". The crossover
    is the packaged table's for CUDA attention in the table's dtype and the
    packaged default of 1024 otherwise (see the module docstring). Explicit
    impls pass through untouched."""
    if impl != "auto":
        return impl
    crossover = DEFAULT_FLASH_CROSSOVER_SEQ
    if _is_cuda(device):
        seq, table_dtype = _flash_table()
        name = str(dtype).replace("torch.", "") if dtype is not None else None
        if table_dtype is None or name == table_dtype:
            crossover = seq
    if seq_len >= crossover and seq_len % _FLASH_BLOCK == 0:
        return "flash"
    return "dot"


def paged_crossover_timeline(batch: Optional[int] = None, heads: Optional[int] = None,
                             path: Optional[str] = None) -> int:
    """Smallest measured timeline width from which "kernel" never loses to
    "gather" (tokens/sec) for the nearest recorded (batch, heads) bucket of
    the table at ``path`` (default: the packaged H100 table); the packaged
    default when the file is missing, unreadable, or records no crossover.
    Cached per (path, batch, heads)."""
    key = ("paged", path or "__default__", batch, heads)
    if key in _cache:
        return _cache[key]
    out = DEFAULT_PAGED_CROSSOVER_TIMELINE
    try:
        with open(path or PAGED_TABLE, "r", encoding="utf-8") as f:
            rows = json.load(f).get("rows", [])

        # Nearest recorded (batch, heads) bucket: the sweep records a few
        # decode-shaped points, not the full cross product.
        def _dist(r):
            d = 0.0
            if batch is not None and "batch" in r:
                d += abs(float(r["batch"]) - batch)
            if heads is not None and "heads" in r:
                d += abs(float(r["heads"]) - heads)
            return d

        if rows and (batch is not None or heads is not None):
            best = min(_dist(r) for r in rows)
            rows = [r for r in rows if _dist(r) == best]
        by_tl: dict = {}
        for r in rows:
            tl = int(r["table_pages"]) * int(r["page_len"])
            by_tl.setdefault(tl, {})[str(r["impl"])] = float(r["tokens_per_sec"])
        tls = sorted(t for t, v in by_tl.items() if "gather" in v and "kernel" in v)
        for i, t in enumerate(tls):
            if all(by_tl[u]["kernel"] >= by_tl[u]["gather"] for u in tls[i:]):
                out = t
                break
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        pass  # unmeasured installs use the packaged default
    _cache[key] = out
    return out


def resolve_paged_impl(impl: str, batch: int, table_pages: int, page_len: int,
                       heads: int, device=None) -> str:
    """The ``paged_attention_impl="auto"`` rule: "kernel" at and above the
    measured timeline crossover for the nearest recorded (batch, heads)
    shape, on CUDA only; elsewhere "auto" is always "gather". Explicit
    impls pass through untouched."""
    if impl != "auto":
        return impl
    if not _is_cuda(device):
        return "gather"
    if table_pages * page_len >= paged_crossover_timeline(batch, heads):
        return "kernel"
    return "gather"


__all__ = [
    "DEFAULT_FLASH_CROSSOVER_SEQ", "DEFAULT_PAGED_CROSSOVER_TIMELINE", "FLASH_TABLE",
    "PAGED_TABLE", "flash_crossover_seq", "resolve_attention_impl",
    "paged_crossover_timeline", "resolve_paged_impl",
]
