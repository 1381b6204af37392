"""The port's kernels as ``torch.library`` custom ops, for ``torch.export``.

The kernels are bound through ``ctypes`` (``ops/_build.py``), which
``torch.export`` cannot trace: a traced call of a wrapper would read
``data_ptr()`` of a fake tensor. So each kernel's forward entry is also an
operator of the ``autodist_tpu_torch`` namespace, with a fake (shape-only)
implementation for tracing and the wrapper itself as its implementation:

- ``flash_fwd(q, k, v, causal) -> (O, lse)``: ``ops/flash_attention.py``;
- ``paged_attention(q4, k_pages, v_pages, page_tables, q_positions,
  k_scale, v_scale) -> O``: ``ops/paged_attention.py``;
- ``fused_matmul_stats(x, w) -> (y, s1, s2)``: ``ops/fused_conv_stats.py``.

While ``torch.export`` traces (``torch.compiler.is_exporting()``), the
model-facing entries (``flash_attention``, ``paged_attention``,
``layers.conv_batchnorm``) call these operators, so an exported program
calls the CUDA kernel on the card (and counts its launches) as the eager
model does; on the CPU the wrappers run their plain versions. The eager
path keeps calling the wrappers directly: no dispatcher hop per call.

Registration happens when this module is imported, which
``import autodist_tpu_torch`` does: an exported program of the port loads
only in a process that has imported the package (where a StableHLO export
of the JAX package needs no model code at all). Nothing is built here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from autodist_tpu_torch.ops import flash_attention as fa
from autodist_tpu_torch.ops import fused_conv_stats as fcs
from autodist_tpu_torch.ops import paged_attention as pa

NAMESPACE = "autodist_tpu_torch"


@torch.library.custom_op(f"{NAMESPACE}::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    return fa.flash_fwd(q, k, v, causal)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, causal):
    b, s, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, s), dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::paged_attention", mutates_args=())
def paged_attention(q4: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    page_tables: torch.Tensor, q_positions: torch.Tensor,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    if q4.device.type == "cpu":
        return pa.paged_attention_plain(q4, k_pages, v_pages, page_tables, q_positions,
                                        k_scale, v_scale)
    return pa._launch(q4, k_pages, v_pages, page_tables, q_positions, k_scale, v_scale)


@paged_attention.register_fake
def _paged_attention_fake(q4, k_pages, v_pages, page_tables, q_positions,
                          k_scale=None, v_scale=None):
    return torch.empty_like(q4)


@torch.library.custom_op(f"{NAMESPACE}::fused_matmul_stats", mutates_args=())
def fused_matmul_stats(x: torch.Tensor, w: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return fcs.fused_matmul_stats(x, w)


@fused_matmul_stats.register_fake
def _fused_matmul_stats_fake(x, w):
    m, n = x.shape[0], w.shape[1]
    return (x.new_empty((m, n)), x.new_empty((n,), dtype=torch.float32),
            x.new_empty((n,), dtype=torch.float32))


__all__ = ["NAMESPACE", "flash_fwd", "paged_attention", "fused_matmul_stats"]
