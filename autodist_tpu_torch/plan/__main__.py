"""CLI: ``python -m autodist_tpu_torch.plan --selftest`` (PyTorch port of
the JAX package's ``plan/__main__.py``).

The planner's proof on the CPU. It plans the zoo ``mlp`` for one node of
four GPUs and exits 1 if any claim fails:

1. **search beats the slate**: the beam search visits at least 20
   candidates and its winner's predicted cost is at most the best lossless
   slate member's; ZeRO-1 is in the space and the bucket gene is searched
   and round-trips through Strategy JSON;
2. **calibration learns**: a fit to a replayed profile (measured times from
   an efficiency model the nominal constants do not know) lowers the mean
   relative error of the predictions;
3. **the cache hit is byte-identical**: a second ``Plan.build`` of the same
   question is a hit that skips the search (``n_visited == 0``) and returns
   the stored winner's JSON byte for byte, after the dry run lowered and
   analyzed it on a live group of the spec's four ranks: this process is
   rank 0 of a gloo group and three helper processes hold the other ranks
   (a skipped dry run fails the claim);
4. **invalidation is loud, never fatal**: a corrupt entry falls back to a
   fresh search with a warning.

It prints one JSON line.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile

#: The spec's GPU count, and the gloo group's world size of claim 3.
SELFTEST_GPUS = 4
_GROUP_TIMEOUT_S = 120

_HELPER = (
    "import datetime, sys, torch.distributed as d\n"
    "d.init_process_group('gloo', init_method=sys.argv[1], rank=int(sys.argv[2]),\n"
    "                     world_size=int(sys.argv[3]),\n"
    "                     timeout=datetime.timedelta(seconds=int(sys.argv[4])))\n"
    "d.barrier()\n"
    "d.destroy_process_group()\n"
)


class _Group:
    """This process as rank 0 of a gloo group of ``world`` ranks whose
    other ranks are idle helper processes, released at exit."""

    def __init__(self, world: int, tmpdir: str):
        self.world = world
        self.init_method = "file://" + os.path.join(tmpdir, "pg")
        self.helpers = [subprocess.Popen(
            [sys.executable, "-c", _HELPER, self.init_method, str(r), str(world),
             str(_GROUP_TIMEOUT_S)]) for r in range(1, world)]

    def __enter__(self):
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=self.init_method, rank=0,
                                world_size=self.world,
                                timeout=datetime.timedelta(seconds=_GROUP_TIMEOUT_S))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        try:
            dist.barrier()
            dist.destroy_process_group()
        finally:
            self.reap(30)
        return False

    def reap(self, wait_s: float = 0.0) -> None:
        """Wait up to ``wait_s`` for each helper, then kill what is left
        (after a failure before the group formed)."""
        for p in self.helpers:
            try:
                p.wait(timeout=wait_s)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def selftest(min_candidates: int = 20, n: int = SELFTEST_GPUS) -> int:
    """Returns a process exit code; prints ONE JSON line."""
    from autodist_tpu_torch.model_item import ModelItem
    from autodist_tpu_torch.models import get_model_spec
    from autodist_tpu_torch.plan import (
        BUCKET_GENE_CHOICES,
        CalibrationRecord,
        Plan,
        PlanConfig,
        PlanGenome,
        TopologyCalibration,
        VarGene,
        genome_to_strategy,
        prediction_error,
        strategy_to_genome,
    )
    from autodist_tpu_torch.plan.search import KINDS
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.strategy.cost_model import CostModel, lossless_slate
    from autodist_tpu_torch.strategy.ir import Strategy

    failures = []
    spec = ResourceSpec(resource_dict={
        "nodes": [{"address": "localhost", "gpus": n, "chief": True}]})
    model = get_model_spec("mlp", in_dim=4 * n, hidden=(8 * n, 4 * n), num_classes=8)
    item = ModelItem.from_params(model.init(0, device="cpu"), loss_fn=model.loss_fn,
                                 example_batch=model.example_batch(2 * n, device="cpu"))
    tmpdir = tempfile.mkdtemp(prefix="plan-selftest-")
    cache_dir = os.path.join(tmpdir, "cache")
    # The helpers import torch while the search runs.
    group = _Group(n, tmpdir)

    try:
        # ------------------------------------------------------ 1. search wins
        planner = Plan(PlanConfig(cache_dir=cache_dir, calibration=None, search_mesh=True))
        strategy1 = planner.build(item, spec)
        first = dict(planner.last_result or {})
        prov = first.get("provenance", {})
        n_visited = int(first.get("n_visited", 0))
        if first.get("cache_hit"):
            failures.append("first build reported a cache hit on an empty cache")
        if n_visited < min_candidates:
            failures.append(f"search visited {n_visited} candidates (< {min_candidates})")
        cm = CostModel(item, spec)
        winner_cost = cm.strategy_cost(strategy1)
        slate_costs = {name: cm.strategy_cost(built)
                       for name, built in lossless_slate(item, spec).items()}
        best_slate = min(slate_costs.values(), key=lambda c: c.total_s)
        if winner_cost.total_s > best_slate.total_s * (1 + 1e-9):
            failures.append(f"winner predicted {winner_cost.total_s} > best slate "
                            f"{best_slate.total_s}")
        if "Zero1" not in slate_costs:
            failures.append("Zero1 slate seed missing from the selftest bound")
        if "zero1" not in KINDS:
            failures.append("zero1 gene kind missing from the search space")

        # The bucket gene: at least 2 sizes visited, rendered onto
        # GraphConfig.bucket_bytes, kept through JSON, projected back, priced.
        bucket_sizes = list(prov.get("bucket_sizes_visited", []))
        if len(bucket_sizes) < 2:
            failures.append(f"search visited {bucket_sizes} bucket sizes; the bucket gene "
                            f"is not being explored")
        # The probe buckets every variable's plain all-reduce (a winner that
        # partitions its variables has nothing to bucket) at a size small
        # enough to split this model into >= 2 buckets.
        probe_bytes = 4096
        assert probe_bytes not in BUCKET_GENE_CHOICES
        bucketed = genome_to_strategy(
            PlanGenome(genes=tuple(VarGene() for _ in item.trainable_variables),
                       bucket_bytes=probe_bytes), item, spec)
        if bucketed.graph_config.bucket_bytes != probe_bytes:
            failures.append("bucket gene did not render onto GraphConfig.bucket_bytes")
        round_tripped = Strategy.from_json(bucketed.to_json())
        if round_tripped.graph_config.bucket_bytes != probe_bytes:
            failures.append("bucket_bytes lost in Strategy JSON serde")
        if strategy_to_genome(round_tripped, item, spec).bucket_bytes != probe_bytes:
            failures.append("bucket_bytes lost projecting back to the genome")
        if not cm.strategy_cost(bucketed).overlap_s > 0:
            failures.append("bucketed candidate priced overlap_s == 0: the cost model is "
                            "not seeing the bucket gene")

        # ------------------------------------------------- 2. calibration learns
        # Wire at 55% of nominal, HBM at 80%, a 2.5 ms compute floor.
        truth = {"comm_s": 1.0 / 0.55, "update_s": 1.0 / 0.80, "latency_s": 1.5,
                 "act_sync_s": 1.0, "gather_s": 1.0 / 0.65}
        records = []
        for i, (name, cost) in enumerate(sorted(slate_costs.items())):
            measured = 2.5e-3 + sum(truth[k] * getattr(cost, k) for k in truth)
            measured *= 1.0 + 0.01 * ((i % 3) - 1)  # deterministic "noise"
            records.append(CalibrationRecord.from_cost(cost, measured, name=name))
        err_before = prediction_error(records, None)
        calib = TopologyCalibration.fit(records, device="cpu-selftest", topology="selftest")
        err_after = prediction_error(records, calib)
        if not err_after < err_before:
            failures.append(f"calibration did not reduce error: {err_before} -> {err_after}")
        cpath = calib.save(os.path.join(tmpdir, "calibration-selftest.json"), records=records)
        reloaded = TopologyCalibration.load(cpath)
        if reloaded is None or abs(reloaded.base_s - calib.base_s) > 1e-12:
            failures.append("calibration save/load did not round-trip")

        # --------------------------------- 3. cache hit, byte-identical, lowered
        entries = [e for e in os.listdir(cache_dir) if not e.startswith(".")]
        round_trip = stored = b""
        validated = False
        with group:
            if len(entries) != 1:
                failures.append(f"expected exactly one cache entry, found {entries}")
            else:
                with open(os.path.join(cache_dir, entries[0], "strategy.json"), "rb") as f:
                    stored = f.read()
                planner2 = Plan(PlanConfig(cache_dir=cache_dir, calibration=None))
                strategy2 = planner2.build(item, spec)
                second = dict(planner2.last_result or {})
                validated = bool(second.get("validated"))
                if not second.get("cache_hit"):
                    failures.append("second build was not a cache hit")
                if int(second.get("n_visited", -1)) != 0:
                    failures.append("cache hit still visited search candidates")
                if not validated:
                    failures.append(f"the cache hit was not dry-run lowered on the live "
                                    f"group of {n} ranks")
                round_trip = json.dumps(strategy2.to_json(), indent=2,
                                        sort_keys=True).encode("utf-8")
                if round_trip != stored:
                    failures.append("cache hit strategy is not byte-identical to the stored "
                                    "winner")
                if strategy1.to_json() != strategy2.to_json():
                    failures.append("cache hit differs from the searched winner")

                # ------------------------------------ 4. corrupt => fallback
                with open(os.path.join(cache_dir, entries[0], "strategy.json"), "ab") as f:
                    f.write(b"garbage")
                planner3 = Plan(PlanConfig(cache_dir=cache_dir, calibration=None))
                try:
                    planner3.build(item, spec)
                except Exception as e:  # noqa: BLE001 - the claim is "never a crash"
                    failures.append(f"corrupt cache entry crashed the planner: {e}")
                else:
                    if (planner3.last_result or {}).get("cache_hit"):
                        failures.append("corrupt cache entry was served as a hit")
                    if planner3.cache.stats.get("invalidated", 0) < 1:
                        failures.append("corrupt entry was not counted as invalidated")

    finally:
        group.reap()
        shutil.rmtree(tmpdir, ignore_errors=True)

    ok = not failures
    line = {
        "selftest": "autodist_tpu_torch.plan",
        "ok": ok,
        "candidates_visited": n_visited,
        "winner_predicted_ms": round(winner_cost.total_s * 1e3, 6),
        "best_slate_predicted_ms": round(best_slate.total_s * 1e3, 6),
        "improvement_vs_best_seed": prov.get("improvement_vs_best_seed"),
        "calibration_err_before": round(err_before, 6),
        "calibration_err_after": round(err_after, 6),
        "bucket_sizes_visited": bucket_sizes,
        "cache_hit_byte_identical": bool(stored) and round_trip == stored,
        "dryrun_validated": validated,
        "group_world_size": n,
        "device": "cpu",
        "n_gpus": n,
    }
    if failures:
        line["failures"] = failures
    print(json.dumps(line))
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m autodist_tpu_torch.plan",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--selftest", action="store_true",
                    help="run the planner's proof on the CPU and exit")
    ap.add_argument("--min-candidates", type=int, default=20,
                    help="selftest: minimum search candidates visited")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest(min_candidates=args.min_candidates)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
