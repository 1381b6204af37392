#!/usr/bin/env python3
"""Profile two trees of the port in turn on one NVIDIA GPU.

    python3 tools/torch_ab_profile.py --base DIR [--pairs 6] [--out DIR] \\
        train --model transformer --batch 8 --steps 20
    python3 tools/torch_ab_profile.py --base DIR serve [--kv-quant]

Runs this checkout's ``tools/torch_<kind>_profile.py`` with the given
arguments against the port in DIR (a base tree, for example a ``git
archive`` of the parent commit) and against this checkout's port, each run
in a process of its own, in the order base, this, this, base, base, this,
... (``--pairs`` runs of each), so that a drift of the host over the call
falls on both sides alike. The one profile script serves both trees: it is
copied into DIR's ``tools/`` first. Each run's JSON goes to ``--out``; the
end prints, for each tree, the main metrics of its runs in order and their
medians, one JSON line a tree. Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_KEYS = ("host_wall_ms", "device_busy_ms", "kernels_per_step")
SERVE_KEYS = ("host_wall_ms", "host_wall_ms_median", "device_busy_ms",
              "paged_attention_ms", "kernels_per_step", "ttft_ms_median")


def metrics(kind: str, doc: dict) -> dict:
    """``{metric: value}`` of one run's JSON (``program/metric`` for serve)."""
    if kind == "train":
        out = {k: doc[k] for k in TRAIN_KEYS}
        out["host_probe_us"] = max(doc["host_probe_us"])
        groups = doc["device_ms_by_group"]
        if isinstance(groups, dict) and "fused_conv_stats" in groups:
            out["fused_conv_stats_ms"] = groups["fused_conv_stats"]
        return out
    return {f"{row['program']}/{k}": row[k] for row in doc["rows"]
            for k in SERVE_KEYS if k in row}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="the other tree's root")
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--out", default=os.path.join("profile_out", "ab"))
    ap.add_argument("kind", choices=("train", "serve"))
    ap.add_argument("args", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    script = os.path.join("tools", f"torch_{args.kind}_profile.py")
    base = os.path.abspath(args.base)
    shutil.copy(os.path.join(HERE, script), os.path.join(base, script))
    out_dir = os.path.abspath(args.out)
    os.makedirs(out_dir, exist_ok=True)
    runs = {"base": [], "this": []}
    for i in range(args.pairs):
        for label in (("base", "this") if i % 2 == 0 else ("this", "base")):
            root = base if label == "base" else HERE
            path = os.path.join(out_dir, f"{args.kind}_{i}_{label}.json")
            subprocess.run([sys.executable, script, *args.args, "--out", path],
                           cwd=root, check=True)
            with open(path) as f:
                runs[label].append(metrics(args.kind, json.load(f)))
    for label, rows in runs.items():
        summary = {}
        for k in rows[0]:
            vals = [r[k] for r in rows]
            numeric = all(isinstance(v, (int, float)) for v in vals)
            summary[k] = {"runs": vals,
                          "median": statistics.median(vals) if numeric else None}
        print(json.dumps({"tree": label, "root": base if label == "base" else HERE,
                          "kind": args.kind, **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
