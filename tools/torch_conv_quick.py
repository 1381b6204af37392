#!/usr/bin/env python3
"""Quick check of the fused 1x1-conv + BatchNorm-statistics kernel on one
NVIDIA GPU, after an edit of ``autodist_tpu_torch/csrc/fused_conv_stats.cu``.

    python3 tools/torch_conv_quick.py [--shape 64x64x64 --shape 1000x200x200 ...]
                                      [--resnet] [--dtype bfloat16]
                                      [--base _archive/parent [--pairs 1]]

Builds only the conv-stats library from this checkout (or loads it as
built), prints ``chip_smoke.py``'s build report for it (registers, spills
and HGMMA count of each bf16 kernel instance, and the shared-memory plan
against the wrapper's mirror) and runs ``chip_smoke.py``'s
conv_stats_parity case at each shape ``MxKxN``: by default a single tile
(64x64x64) and ragged ones (M, K and N not multiples of the tiles);
``--resnet`` takes the 15 ResNet-50 shapes of ``chip_smoke.CONV_SHAPES``
and prints their forward totals. Each row is one JSON line; any failed
check raises.

With ``--base DIR`` (another tree of the repo, e.g. the parent unpacked with
``git archive`` into the gitignored ``_archive/``) the cases run in child
processes in turn, base, this, this, base (``--pairs`` times), each through
its own tree's ``chip_smoke.conv_stats_case``, and a last ``conv_ab`` line
gives each shape's kernel ms in every run. Takes about a minute on an H100
for the default shapes, several with ``--resnet --base``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_SHAPES = ("64x64x64", "1000x200x200", "4097x72x24", "300x2048x2048")


def _smoke(root: str):
    """``chip_smoke`` of the tree at ``root`` (its package first on the path)."""
    sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def _shapes(args, smoke):
    if args.resnet:
        return [(shape, launches) for shape, launches in smoke.CONV_SHAPES]
    return [(tuple(int(v) for v in s.split("x")), 0) for s in args.shape or DEFAULT_SHAPES]


def run_cases(root: str, shapes, dtype: str, report: bool) -> list:
    """Build the library of the tree at ``root``, print its report (this
    tree's only: a base tree may predate it) and run each case."""
    import torch

    smoke = _smoke(root)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke._build.build(["fused_conv_stats"])
    smoke.fcs.build_kernel()
    if report:
        ptxas = smoke._build.ptxas_report("fused_conv_stats")
        log = smoke._build.build_logs["fused_conv_stats"]
        smoke.emit("build", nvcc_seconds=smoke._build.build_seconds["fused_conv_stats"],
                   nvcc_warnings=[x for x in log.splitlines() if "warning" in x.lower()],
                   ptxas=ptxas, conv_tensor_core=smoke.conv_tensor_core_report(ptxas))
    gen = torch.Generator(device=dev)
    gen.manual_seed(smoke.SEED)
    dt = getattr(torch, dtype)
    rows = [smoke.conv_stats_case(*shape, dt, gen, dev) for shape, _ in shapes]
    for row, (_, launches) in zip(rows, shapes):
        row["launches_per_forward"] = launches
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", action="append", help="MxKxN (repeatable)")
    ap.add_argument("--resnet", action="store_true", help="chip_smoke.CONV_SHAPES")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--base", help="another tree of the repo to time in turn")
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_conv_quick: CUDA is not available", file=sys.stderr)
        return 2
    if args.child:
        rows = run_cases(args.child, _shapes(args, _smoke(args.child)), args.dtype,
                         report=args.child == ROOT)
        print("ROWS " + json.dumps(rows), flush=True)
        return 0
    smoke = _smoke(ROOT)
    smoke.emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smoke.card_line())
    shapes = _shapes(args, smoke)
    if not args.base:
        rows = run_cases(ROOT, shapes, args.dtype, report=True)
        if args.resnet:
            smoke.emit("conv_stats_forward", **smoke.conv_forward_totals(rows))
        return 0
    base = os.path.abspath(args.base)
    runs = []
    for _ in range(args.pairs):
        for tree in (base, ROOT, ROOT, base):
            # This tree's shapes, passed on: a base tree may list others.
            cmd = [sys.executable, os.path.abspath(__file__), "--child", tree,
                   "--dtype", args.dtype]
            for shape, _ in shapes:
                cmd += ["--shape", "x".join(map(str, shape))]
            out = subprocess.run(cmd, cwd=tree, capture_output=True, text=True,
                                 timeout=1800)
            sys.stdout.write(out.stdout.replace("ROWS ", "rows of " + tree + ": ", 1))
            if out.returncode != 0:
                sys.stderr.write(out.stderr)
                raise RuntimeError(f"torch_conv_quick: {tree} failed (rc={out.returncode})")
            line = next(x for x in out.stdout.splitlines() if x.startswith("ROWS "))
            runs.append(("base" if tree == base else "this", json.loads(line[5:])))
    ab = []
    for i, (shape, launches) in enumerate(shapes):
        ab.append(dict(shape="x".join(map(str, shape)), launches_per_forward=launches,
                       base_ms=[rows[i]["kernel_ms"] for who, rows in runs if who == "base"],
                       this_ms=[rows[i]["kernel_ms"] for who, rows in runs if who == "this"],
                       bound_ms=runs[0][1][i]["bound_ms"]))
    smoke.emit("conv_ab", order="base, this, this, base", shapes=ab)
    return 0


if __name__ == "__main__":
    sys.exit(main())
