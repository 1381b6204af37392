#!/usr/bin/env python3
"""Quick check of the flash-attention kernels on one NVIDIA GPU, after an edit
of ``autodist_tpu_torch/csrc/flash_attention.cu``.

    python3 tools/torch_flash_quick.py [--seq 512] [--causal] [--dtype bfloat16]

Builds the flash library from this checkout (or loads it as built), prints
``chip_smoke.py``'s build report for it (registers, spills and HMMA count of
the tensor-core kernels) and runs ``chip_smoke.py``'s flash_parity case at
one shape (B=32, H=12, D=64): the forward, dK/dV and dQ kernels against
their plain versions within the smoke's bounds, timed beside SDPA and the
bound. Each row is one JSON line; any failed check raises. Takes about a
minute on an H100, against several for the whole smoke.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=smoke.TRAIN_SEQ)
    ap.add_argument("--causal", action="store_true")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_quick: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke.emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smoke.card_line())
    smoke._build.build(["flash_attention"])
    smoke.fa.build_kernel()
    ptxas = smoke._build.ptxas_report("flash_attention")
    smoke.emit("build", nvcc_seconds=smoke._build.build_seconds["flash_attention"],
               ptxas=ptxas, flash_tensor_core=smoke.tensor_core_report(ptxas))
    gen = torch.Generator(device=dev)
    gen.manual_seed(smoke.SEED)
    smoke.flash_case(args.seq, args.causal, getattr(torch, args.dtype), gen, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
