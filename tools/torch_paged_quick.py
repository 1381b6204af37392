#!/usr/bin/env python3
"""Quick check of the paged-attention kernel on one NVIDIA GPU, after an edit
of ``autodist_tpu_torch/csrc/paged_attention.cu``.

    python3 tools/torch_paged_quick.py [--shape decode] [--pages bfloat16]

Builds the paged library from this checkout (or loads it as built), prints
its registers and spills (``-Xptxas -v``) and runs ``chip_smoke.py``'s
kernel_parity case at each chosen shape (decode B=32 Q=1, prefill B=1 Q=16,
verify B=32 Q=5; H=12, D=64, page_len 16, 32-page tables) and page kind:
the kernel against its plain version at its own split count and at
``chip_smoke.PAGED_SPLITS``, a repeated launch bitwise equal, each timed
beside SDPA over the gathered timeline and the bound. Each row is one JSON
line; any failed check raises.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as smoke  # noqa: E402

SHAPES = ("decode", "prefill", "verify")
KINDS = ("bfloat16", "int8", "float32")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", choices=SHAPES, action="append")
    ap.add_argument("--pages", choices=KINDS, action="append")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_paged_quick: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smoke.emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smoke.card_line())
    smoke._build.build(["paged_attention"])
    smoke.pa.build_kernel()
    smoke.emit("build", nvcc_seconds=smoke._build.build_seconds["paged_attention"],
               ptxas=smoke._build.ptxas_report("paged_attention"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(smoke.SEED)
    for shape in args.shape or SHAPES:
        for kind in args.pages or KINDS:
            smoke.parity_case(shape, kind, gen, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
