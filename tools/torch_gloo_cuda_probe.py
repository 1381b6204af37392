#!/usr/bin/env python3
"""Which collectives gloo carries over CUDA tensors, for several ranks on
one card (NCCL refuses two ranks on one device).

    python3 tools/torch_gloo_cuda_probe.py [--world 2]

For each collective, starts ``--world`` fresh processes on ``cuda:0`` (a
crash in one hides no other), joins them in a gloo group and issues, on
CUDA tensors, the collective that the port's step and
``DTensor`` use over a model axis: ``all_reduce`` (fp32 and bf16), ``broadcast``,
``all_gather_into_tensor`` (1-D and 2-D), ``reduce_scatter_tensor``, the
functional all-gather ``DTensor`` issues (1-D and 2-D), and ``DTensor``'s
own redistributions (``Shard -> Replicate``, ``Partial -> Replicate``,
``Replicate -> Shard``, ``Partial -> Shard``) on a ``DeviceMesh("cuda")``.
Prints a JSON line per collective as it finishes, then one with them all:
per collective ``"ok"`` (the right values), the error text or the exit
codes of a crash, and ``all_ok``.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile

import torch

#: A rank left waiting by a crashed peer gives up after this (seconds).
GROUP_TIMEOUT_S = 15.0


def _checks(world: int, rank: int) -> dict:
    """Each probed collective: a callable returning True on the right values."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dev = torch.device("cuda", 0)
    base = torch.arange(world * 4, dtype=torch.float32, device=dev)
    total = world * base + sum(range(world))

    def all_reduce(dtype):
        def fn():
            t = (base + rank).to(dtype)
            dist.all_reduce(t)
            return torch.equal(t, total.to(dtype))
        return fn

    def broadcast():
        t = base + rank
        dist.broadcast(t, src=0)
        return torch.equal(t, base)

    def all_gather():
        out = torch.empty(world * 4, device=dev)
        dist.all_gather_into_tensor(out, base[:4] + rank)
        return torch.equal(out, torch.cat([base[:4] + r for r in range(world)]))

    def reduce_scatter():
        out = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(out, base + rank)
        return torch.equal(out, total[rank * 4:(rank + 1) * 4])

    full = torch.arange(world * 8, dtype=torch.float32, device=dev).reshape(world * 2, 4)
    block = full[rank * 2:(rank + 1) * 2]

    def all_gather_2d():
        out = torch.empty_like(full)
        dist.all_gather_into_tensor(out, block.clone())
        return torch.equal(out, full)

    def funcol_all_gather(local, want):
        def fn():
            import torch.distributed._functional_collectives as funcol

            got = funcol.all_gather_tensor(local.clone(), 0, dist.group.WORLD)
            return torch.equal(funcol.wait_tensor(got), want)
        return fn

    def redistribute(src, dst, local, want):
        def fn():
            mesh = DeviceMesh("cuda", list(range(world)), mesh_dim_names=("model",))
            d = DTensor.from_local(local, mesh, [src], run_check=False)
            return torch.equal(d.redistribute(mesh, [dst]).to_local(), want)
        return fn

    return {
        "all_gather_into_tensor 2-D": all_gather_2d,
        "functional all_gather 1-D": funcol_all_gather(
            base[:4] + rank, torch.cat([base[:4] + r for r in range(world)])),
        "functional all_gather 2-D": funcol_all_gather(block, full),
        "all_reduce float32": all_reduce(torch.float32),
        "all_reduce bfloat16": all_reduce(torch.bfloat16),
        "broadcast": broadcast,
        "all_gather_into_tensor": all_gather,
        "reduce_scatter_tensor": reduce_scatter,
        "dtensor Shard->Replicate": redistribute(Shard(0), Replicate(), block, full),
        "dtensor Partial->Replicate": redistribute(Partial(), Replicate(), full,
                                                   world * full),
        "dtensor Replicate->Shard": redistribute(Replicate(), Shard(0), full, block),
        "dtensor Partial->Shard": redistribute(Partial(), Shard(0), full, world * block),
    }


def _one(name: str, rank: int, world: int, init: str) -> int:
    """One rank of one collective: exit 0 on the right values, 1 on wrong
    ones, 3 with the error on stderr."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        ok = _checks(world, rank)[name]()
    except Exception as e:  # noqa: BLE001 - the probe reports every failure
        print(f"{type(e).__name__}: {e}"[:400], file=sys.stderr, flush=True)
        return 3
    dist.destroy_process_group()
    return 0 if ok else 1


def probe(world: int = 2, timeout_s: float = 3 * GROUP_TIMEOUT_S) -> dict:
    """``{collective: "ok" | "wrong values" | error or signal}`` and
    ``all_ok``: each collective in ``world`` fresh processes on cuda:0 (a
    crash in one does not hide the others)."""
    results = {}
    for name in _NAMES:
        with tempfile.TemporaryDirectory() as work:
            procs = [subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--one", name, "--rank", str(r),
                 "--world", str(world), "--init", f"file://{work}/pg"],
                stderr=subprocess.PIPE, text=True) for r in range(world)]
            codes, errs = [], []
            for p in procs:
                try:
                    _, err = p.communicate(timeout=timeout_s)
                except subprocess.TimeoutExpired:
                    p.kill()
                    _, err = p.communicate()
                codes.append(p.returncode)
                errs.append((err or "").strip().splitlines()[-1:] )
        if all(c == 0 for c in codes):
            results[name] = "ok"
        elif any(c is not None and c < 0 for c in codes):
            results[name] = f"crashed: exit codes {codes} (negative: the signal)"
        elif 1 in codes:
            results[name] = "wrong values"
        else:
            results[name] = f"error: {[e for e in errs if e]}"
        print(json.dumps({"collective": name, "result": results[name]}), flush=True)
    return {"world": world, "results": results,
            "all_ok": all(v == "ok" for v in results.values())}


_NAMES = ("all_reduce float32", "all_reduce bfloat16", "broadcast", "all_gather_into_tensor",
          "all_gather_into_tensor 2-D", "reduce_scatter_tensor", "functional all_gather 1-D",
          "functional all_gather 2-D", "dtensor Shard->Replicate",
          "dtensor Partial->Replicate", "dtensor Replicate->Shard", "dtensor Partial->Shard")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--world", type=int, default=2)
    parser.add_argument("--one", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_gloo_cuda_probe: CUDA is not available", file=sys.stderr)
        return 2
    if args.one is not None:
        return _one(args.one, args.rank, args.world, args.init)
    print(json.dumps({"torch": torch.__version__, **probe(args.world)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
