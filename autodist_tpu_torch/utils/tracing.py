"""``torch.profiler`` wrappers and text-artifact dumps (PyTorch port of
``utils/tracing.py``).

- :func:`trace` profiles a block with ``torch.profiler`` (CPU activity,
  and CUDA activity where a card is present) and writes its Chrome trace
  into a directory it yields; ``DistributedTrainStep.trace_step`` traces
  one step with it. The JAX package writes a ``jax.profiler`` xplane there.
- :func:`annotate` names a region of a trace (``record_function``, plus an
  NVTX range on the card).
- :func:`dump_hlo` writes one text artifact of a program stage.
- :class:`StepTimer` is re-exported from ``obs/profiler.py``, as the JAX
  package keeps it here for its older import path.

The JAX package's ``dump_compiled`` (a compiled program's HLO) and its
``AUTODIST_DUMP_HLO`` switch wait for the port's program text (FX graphs,
ROADMAP.md Queue 1 item 7).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from autodist_tpu_torch import const
from autodist_tpu_torch.obs.profiler import StepTimer  # noqa: F401
from autodist_tpu_torch.utils import logging

__all__ = ["trace", "annotate", "dump_hlo", "StepTimer", "TRACE_FILE"]

#: The Chrome trace's file name inside a trace directory.
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(name: str = "trace", trace_dir: Optional[str] = None):
    """Profile everything inside the block with ``torch.profiler`` and write
    its Chrome trace to ``<trace_dir>/trace.json`` when the block ends.
    ``trace_dir`` (default ``<const.DEFAULT_TRACE_DIR>/<name>-<unix
    time>``) is created with its parents and yielded. CUDA activity is
    traced where a card is present; a block that launches work on the card
    should synchronize before it ends.

    Usage::

        with tracing.trace("step-100") as td:
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
    """
    from torch.profiler import ProfilerActivity, profile

    trace_dir = trace_dir or os.path.join(const.DEFAULT_TRACE_DIR,
                                          f"{name}-{int(time.time())}")
    os.makedirs(trace_dir, exist_ok=True)
    logging.info("profiler trace -> %s", trace_dir)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with torch.profiler.record_function(name):
            yield trace_dir
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str):
    """A named region inside a trace: ``torch.profiler.record_function``,
    and an NVTX range when a card is present."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def dump_hlo(tag: str, stage: str, text: str, hlo_dir: Optional[str] = None) -> str:
    """Write one program-stage artifact, ``<dir>/<tag>-<stage>.txt``, into
    ``hlo_dir``, else ``const.DEFAULT_HLO_DIR``; returns its path."""
    d = hlo_dir or const.DEFAULT_HLO_DIR
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{tag}-{stage}.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    logging.debug("dumped %s/%s (%d bytes)", tag, stage, len(text))
    return path
