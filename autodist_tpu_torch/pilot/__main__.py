"""CLI: ``python -m autodist_tpu_torch.pilot --selftest [--device cuda|cpu]``
(PyTorch port of the JAX package's ``pilot/__main__.py``).

The autopilot proof, mirroring ``plan``/``serve``/``obs --selftest``. It
drives the REAL closed loop end to end on the device it is given (the
card by default; ``--device cpu`` for the plain path) and **exits nonzero
if any acceptance claim fails**:

1. **drift -> refit -> re-search -> rollout -> measured improvement** — a
   stale plan is deployed; the measured-vs-priced wire divergence (a
   replayed ground-truth profile the analytic constants don't know) opens
   a ``wire_drift`` episode; the controller refits ``plan/calibrate.py``
   from the live records, re-searches with ``PlanSearch``, deploys the
   winner through the REAL drain -> ``ft/elastic.recompile_on`` rollout,
   and the canary (the same replayed profile) measures a strict
   improvement — journaled ``committed`` with expected vs measured;
2. **poisoned calibration never deploys** — a chaos
   ``poisoned_calibration`` plant corrupts one live record at the refit
   seam; the trusted-set fit-error gate rejects the refit, the journal
   shows trigger -> ``rejected``, and the persisted calibration file is
   BYTE-identical to before;
3. **canary regression rolls back** — an unmeasured flag set is canaried
   (never trusted: ``measured: false`` makes it a tuning candidate); the
   replayed profile says it regresses, and the controller restores the
   prior state BIT-exactly, journaling ``rolled_back``;
4. **serve rollout drops nothing** — an SLO burn episode grows the KV
   page pool; the new knob reaches every replica through the router's
   REAL ``rolling_upgrade()`` (engine factories re-read the deployed
   ``PilotState``) while a background loader keeps submitting: zero
   dropped requests, exactly-once ledger, one restart per replica, every
   engine on the new pool size.

One torch process has no mesh of eight devices, as the JAX selftest
forces: plans are searched and priced for one node of
:data:`SELFTEST_GPUS` GPUs (at one GPU every wire costs 0 and no drift
could open), and each rebuild is ``recompile_on`` at world 1 on the
deployed genome re-rendered for the one-device spec
(:class:`Rerendered`). Every canary runs real steps of the deployed step
and times them; its verdict metric is the replayed profile's price, as
JAX's is. ``chip_smoke.py``'s ``pilot`` phase calls :func:`train_episodes`
and :func:`serve_rollout` on bert_base and the full-width transformer.

It prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time
from types import SimpleNamespace
from typing import Any, Callable, Dict, List

#: The GPU count the selftest's plans are searched and priced for.
SELFTEST_GPUS = 8
#: The replayed ground-truth profile (the JAX selftest's): wire at 35% of
#: nominal, HBM at 80%, latency 1.5x, gather at 65%, above a compute floor.
TRUTH = {"comm_s": 1.0 / 0.35, "update_s": 1.0 / 0.80, "latency_s": 1.5,
         "act_sync_s": 1.0, "gather_s": 1.0 / 0.65}
FLOOR_S = 2.5e-3
#: The flag set the replayed profile says regresses the step, and by how much.
REGRESSING_FLAG_SET, FLAG_REGRESSION = "vmem128m", 1.3
#: The unmeasured flag-set document the selftest canaries from.
UNMEASURED_FLAGS = {"chosen": {"name": "overlap_all"}, "measured": False,
                    "session_stable": False, "results_ms_per_step": {}}


def _sync(device) -> None:
    import torch

    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize(device)


def replayed_price(cost_model, floor_s: float = FLOOR_S) -> Callable:
    """Seconds a step of a strategy takes in the replayed profile."""
    def price(strategy) -> float:
        cost = cost_model.strategy_cost(strategy)
        return floor_s + sum(TRUTH[k] * getattr(cost, k) for k in TRUTH)
    return price


def profile_records(slate: Dict[str, Any], cost_model, price: Callable) -> list:
    """One calibration record per slate member, measured through the
    replayed profile with a deterministic +-1% "noise"."""
    from autodist_tpu_torch.plan.calibrate import CalibrationRecord

    records = []
    for i, (name, strat) in enumerate(sorted(slate.items())):
        measured = price(strat) * (1.0 + 0.01 * ((i % 3) - 1))
        records.append(CalibrationRecord.from_cost(cost_model.strategy_cost(strat), measured,
                                                   name=name))
    return records


class Rerendered:
    """Strategy builder pinned to a deployed artifact: the artifact itself
    on its own spec's GPU count, else its genome re-rendered for the spec
    ``recompile_on`` hands it (partitions capped at that degree, PS
    destinations taken modulo its devices)."""

    def __init__(self, strategy, model_item, resource_spec):
        self.strategy = strategy
        self.model_item = model_item
        self.resource_spec = resource_spec

    def build(self, model_item, resource_spec):
        from autodist_tpu_torch.plan.search import genome_to_strategy, strategy_to_genome

        if resource_spec.num_gpus == self.resource_spec.num_gpus:
            return self.strategy
        genome = strategy_to_genome(self.strategy, self.model_item, self.resource_spec)
        return genome_to_strategy(genome, model_item, resource_spec)


class TrainLoop:
    """The deployed train step the rollout drains, rebuilds and canaries.

    ``rebuild(state)`` loads the artifact ``state.plan_id`` names (with its
    bucket gene), rebuilds through ``recompile_on`` at world 1 on
    ``device``, initialises a fresh state from ``params`` and takes one
    untimed step; ``canary(n)`` runs ``n`` real steps of it, timed, and
    returns the replayed profile's price as its verdict metric.
    ``deployed`` keeps one row a rebuild: plan id, flag set, replayed ms,
    measured ms a step (the fastest timed window after the untimed step)
    and the first loss."""

    def __init__(self, loss_fn, params, batch, item, spec, pdir: str, store, price,
                 device, optimizer=None):
        self.loss_fn, self.params, self.batch = loss_fn, params, batch
        self.item, self.spec, self.pdir = item, spec, pdir
        self.store, self.price, self.device = store, price, device
        self.optimizer = optimizer
        self.step = self.train_state = self.strategy = None
        self.drains = self.rebuilds = self.steps_run = 0
        self.deployed: List[dict] = []

    def drain(self) -> None:
        # One process steps synchronously: between canaries nothing is in
        # flight, so the drain is the device's queue.
        _sync(self.device)
        self.drains += 1

    def rebuild(self, state) -> None:
        from autodist_tpu_torch.ft.elastic import recompile_on
        from autodist_tpu_torch.pilot.actions import load_plan_artifact
        from autodist_tpu_torch.plan.search import (
            PlanGenome,
            genome_to_strategy,
            strategy_to_genome,
        )

        strat = load_plan_artifact(self.pdir, state.plan_id)
        if state.bucket_bytes and strat.graph_config.bucket_bytes != state.bucket_bytes:
            g = strategy_to_genome(strat, self.item, self.spec)
            strat = genome_to_strategy(
                PlanGenome(genes=g.genes, bucket_bytes=state.bucket_bytes), self.item, self.spec)
        t0 = time.perf_counter()
        self.step = recompile_on([0], self.loss_fn, self.params, example_batch=self.batch,
                                 strategy_builder=Rerendered(strat, self.item, self.spec),
                                 optimizer=self.optimizer, device=self.device)
        self.train_state = self.step.init(self.params)
        _sync(self.device)
        self.strategy = strat
        self.rebuilds += 1
        self.deployed.append(dict(plan_id=state.plan_id, xla_flag_set=state.xla_flag_set,
                                  rebuild_s=time.perf_counter() - t0,
                                  replayed_ms=self.replayed_s() * 1e3,
                                  measured_ms=None, first_loss=None, steps=0))
        # One untimed step first: the timed windows leave out first-call cost.
        self.deployed[-1]["first_loss"] = self._run(1)[0]

    def replayed_s(self) -> float:
        from autodist_tpu_torch.pilot.state import PilotState

        v = self.price(self.strategy)
        if (self.store.load() or PilotState()).xla_flag_set == REGRESSING_FLAG_SET:
            v *= FLAG_REGRESSION
        return v

    def _run(self, n: int) -> List[float]:
        self.train_state, metrics = self.step.run(self.train_state, self.batch, n)
        self.deployed[-1]["steps"] += n
        self.steps_run += n
        return [float(x) for x in metrics["loss"].tolist()]

    def steps(self, n: int) -> List[float]:
        """``n`` real steps of the deployed step, timed; their losses."""
        _sync(self.device)
        t0 = time.perf_counter()
        losses = self._run(n)
        _sync(self.device)
        row = self.deployed[-1]
        ms = (time.perf_counter() - t0) * 1e3 / n
        row["measured_ms"] = ms if row["measured_ms"] is None else min(row["measured_ms"], ms)
        return losses

    def canary(self, n: int) -> Dict[str, float]:
        self.steps(n)
        return {"step_s": self.replayed_s()}


def train_episodes(loss_fn, params, batch, item, spec, device, tmpdir: str,
                   floor_s: float = FLOOR_S, device_kind: str = "",
                   optimizer=None, n_pages: int = 41) -> tuple:
    """Proofs 1-3 on one model: ``(summary, failures, loop)``. Plans are
    searched and priced on ``spec``; every rebuild runs on ``device``. The
    deployed state starts with the KV pool at ``n_pages`` pages (the serve
    half's fleet size). ``summary["wiring"]`` is what :func:`serve_rollout`
    continues with: the store, the journal, the context, the guard rails
    and the clock."""
    from autodist_tpu_torch.chaos.schedule import ChaosEvent, ChaosPlant, ChaosSchedule
    from autodist_tpu_torch.pilot import (
        Controller,
        ControllerConfig,
        DecisionJournal,
        PilotContext,
        PilotState,
        PilotStateStore,
        TrainRollout,
        build_actions,
        load_plan_artifact,
        save_plan_artifact,
    )
    from autodist_tpu_torch.plan.calibrate import topology_key
    from autodist_tpu_torch.plan.search import SearchConfig
    from autodist_tpu_torch.strategy.cost_model import CostModel, lossless_slate

    failures: List[str] = []
    calib_dir = os.path.join(tmpdir, "calib")
    pdir = os.path.join(tmpdir, "pilot")
    os.makedirs(calib_dir, exist_ok=True)
    os.makedirs(pdir, exist_ok=True)
    store = PilotStateStore(os.path.join(pdir, "state.json"))
    journal = DecisionJournal(os.path.join(pdir, "decisions.jsonl"))
    flags_path = os.path.join(tmpdir, "xla_flags.json")
    with open(flags_path, "w", encoding="utf-8") as f:
        json.dump(UNMEASURED_FLAGS, f)

    cm = CostModel(item, spec)
    price = replayed_price(cm, floor_s)
    slate = lossless_slate(item, spec)
    records = profile_records(slate, cm, price)
    # Deploy the STALE plan: the slate member the replayed profile likes
    # least (the analytically-planned pick gone bad after a topology
    # drift). The autopilot must find and deploy something better.
    stale_name = max(slate, key=lambda k: price(slate[k]))
    stale = slate[stale_name]
    stale_id = save_plan_artifact(pdir, stale)
    store.save(PilotState().with_knobs(plan_id=stale_id,
                                       bucket_bytes=stale.graph_config.bucket_bytes,
                                       n_pages=n_pages))
    ctx = PilotContext(
        model_item=item, resource_spec=spec, device_kind=device_kind,
        calibration_dir=calib_dir, pilot_dir=pdir, xla_flags_path=flags_path,
        live_records=lambda: list(records),
        current_strategy=lambda: (load_plan_artifact(pdir, store.load().plan_id)
                                  if (store.load() or PilotState()).plan_id else None),
        search_config=SearchConfig(beam_width=4, generations=3, mutations_per_survivor=6,
                                   seed=0))
    loop = TrainLoop(loss_fn, params, batch, item, spec, pdir, store, price, device,
                     optimizer=optimizer)
    loop.rebuild(store.load())  # prove the stale artifact deploys at all
    clk = [1000.0]
    cc = ControllerConfig(cooldown_s=60.0, canary_window=2, canary_regression_frac=0.05)
    ctrl = Controller(store, journal, build_actions(ctx),
                      TrainRollout(store, loop.drain, loop.rebuild, loop.canary),
                      config=cc, clock=lambda: clk[0])

    # ------------------------- 1. drift -> refit -> re-search -> improvement
    priced_stale = cm.strategy_cost(stale).total_s
    measured_stale = price(stale)
    drift = abs(measured_stale - priced_stale) / priced_stale
    if drift <= cc.drift_bound:
        failures.append(f"selftest profile produced drift {drift:.3f} <= bound "
                        f"{cc.drift_bound}; the episode would never open")
    n_fail = len(failures)
    rec1 = ctrl.ingest_measured_wire(measured_stale, priced_stale,
                                     {"source": "selftest-profile"})
    if rec1 is None or rec1.verdict != "committed":
        failures.append(f"wire-drift episode did not commit a refit "
                        f"(got {rec1.verdict if rec1 else None!r})")
    else:
        if rec1.action != "refit_replan" or rec1.trigger != "wire_drift":
            failures.append(f"wrong decision routed: {rec1.trigger} -> {rec1.action}")
        exp = rec1.expected
        if not exp.get("priced_new_ms", 1e9) <= exp.get("priced_stale_ms", 0):
            failures.append(f"re-search did not beat the stale plan under the new "
                            f"calibration: {exp.get('priced_new_ms')} vs "
                            f"{exp.get('priced_stale_ms')}")
        base_m = rec1.measured.get("baseline", {}).get("step_s")
        can_m = rec1.measured.get("canary", {}).get("step_s")
        if not (base_m and can_m and can_m < base_m):
            failures.append(f"canary measured no improvement: {base_m} -> {can_m}")
    new_measured = price(loop.strategy)
    if not new_measured < measured_stale:
        failures.append(f"deployed plan not measurably better on the replayed profile: "
                        f"{measured_stale:.6f} -> {new_measured:.6f}")
    st1 = store.load()
    if st1 is None or st1.plan_id == stale_id or st1.plan_id == "":
        failures.append("store still names the stale plan after commit")
    if st1 is not None and st1.to_json() != ctrl.state.to_json():
        failures.append("persisted state diverged from controller state")
    if loop.drains < 1 or loop.rebuilds != loop.drains + 1:
        failures.append(f"rollout skipped the drain->rebuild path "
                        f"(drains={loop.drains}, rebuilds={loop.rebuilds})")
    improvement = (measured_stale - new_measured) / measured_stale
    proof1 = len(failures) == n_fail

    # ------------------------------ 2. poisoned calibration never deploys
    n_fail = len(failures)
    key = topology_key(spec, device_kind)
    calib_path = os.path.join(calib_dir, f"calibration-{key}.json")
    with open(calib_path, "rb") as f:
        calib_bytes_before = f.read()
    clk[0] += 120.0  # past the cooldown
    ctrl.rearm("wire_drift")
    plant = ChaosPlant(ChaosSchedule(seed=17, events=(
        ChaosEvent("poisoned_calibration", at_step=0),)))
    with plant:
        rec2 = ctrl.ingest_measured_wire(measured_stale, priced_stale,
                                         {"source": "selftest-poison"})
    if plant.injected("poisoned_calibration") != 1:
        failures.append("chaos plant never corrupted a live record")
    if rec2 is None or rec2.verdict != "rejected":
        failures.append(f"poisoned refit was not rejected "
                        f"(got {rec2.verdict if rec2 else None!r})")
    elif "poisoned_calibration" not in rec2.note:
        failures.append(f"rejection not attributed to the poison gate: {rec2.note!r}")
    with open(calib_path, "rb") as f:
        calib_byte_identical = f.read() == calib_bytes_before
    if not calib_byte_identical:
        failures.append("poisoned refit modified the persisted calibration file")
    if st1 is None or store.load().to_json() != st1.to_json():
        failures.append("poisoned refit changed the deployed state")
    proof2 = len(failures) == n_fail

    # --------------------------------- 3. canary regression rolls back
    n_fail = len(failures)
    clk[0] += 120.0
    before3 = store.load().to_json()
    rec3 = ctrl.ingest_finding({"code": "SNT005", "value": 1.0,
                                "message": "hbm high-water creep"})
    if rec3 is None or rec3.verdict != "rolled_back":
        failures.append(f"canary regression did not roll back "
                        f"(got {rec3.verdict if rec3 else None!r})")
    else:
        if rec3.knobs_after.get("xla_flag_set") != REGRESSING_FLAG_SET:
            failures.append(f"unmeasured flag doc did not round-robin a candidate: "
                            f"{rec3.knobs_after.get('xla_flag_set')!r}")
        if not rec3.expected.get("stale"):
            failures.append("unmeasured flag set was treated as a trusted baseline, not a "
                            "stale candidate")
        if rec3.measured.get("regressed_on") != ["step_s"]:
            failures.append(f"rollback not pinned on the regressed metric: "
                            f"{rec3.measured.get('regressed_on')}")
    if store.load().to_json() != before3:
        failures.append("rollback did not restore the prior knobs bit-exactly")
    if ctrl.state.to_json() != before3:
        failures.append("controller state diverged from the restored knobs")
    rollback_bit_exact = (store.load().to_json() == before3
                          and ctrl.state.to_json() == before3)
    proof3 = len(failures) == n_fail

    summary = {
        "drift": drift,
        "measured_stale_ms": measured_stale * 1e3,
        "measured_new_ms": new_measured * 1e3,
        "improvement_frac": improvement,
        "stale_plan": stale_name,
        "poisoned_refit_rejected": bool(rec2 and rec2.verdict == "rejected"),
        "calibration_byte_identical": calib_byte_identical,
        "canary_rollback_bit_exact": rollback_bit_exact,
        "proofs": {"drift_refit_commit": proof1, "poisoned_refit_rejected": proof2,
                   "canary_rollback_bit_exact": proof3},
        "expected": rec1.expected if rec1 is not None else {},
        "wiring": SimpleNamespace(store=store, journal=journal, ctx=ctx, config=cc,
                                  clock=clk),
    }
    return summary, failures, loop


def serve_rollout(router, wiring, prompts: list, max_new: int,
                  wait_s: float = 120.0) -> tuple:
    """Proof 4 on a started fleet whose engine factories read the
    ``n_pages`` of ``wiring.store`` (:func:`train_episodes`'s wiring): an
    SLO burn report grows the pool through ``ServeRollout`` while a loader
    thread submits ``prompts`` in turn, every 20 ms while fewer than one
    replica's slots are in flight, from before the report (once every
    replica holds work, or after 10 s) until the rollout returns. Returns ``(summary, failures, fronts)``;
    ``fronts[i]`` served ``prompts[i % len(prompts)]``. ``summary``'s
    ``drained`` and ``persisted`` are each replica's counts from its drain
    (requests that finished during it, and leftovers that failed over)."""
    from autodist_tpu_torch.pilot import Controller, PilotState, ServeRollout, build_actions
    from autodist_tpu_torch.serve.batcher import Backpressure, RequestState
    from autodist_tpu_torch.serve.replica import ReplicaState
    from autodist_tpu_torch.utils import retry

    failures: List[str] = []
    store = wiring.store
    base_pages = int((store.load() or PilotState()).n_pages)
    pool_before = {rid: rep.engine.pool.n_pages for rid, rep in router.replicas.items()}
    restarts_before = {rid: rep.restarts for rid, rep in router.replicas.items()}

    def serve_canary(k: int):
        dropped = 0
        for i in range(k):
            holder = []

            def _try_submit(i=i, holder=holder):
                try:
                    holder.append(router.submit(prompts[i % len(prompts)],
                                                max_new_tokens=max_new))
                    return True
                except Backpressure:
                    return False

            retry.wait_until(_try_submit, 10.0, interval_s=0.02)
            if not holder or holder[0].wait(wait_s).state is not RequestState.DONE:
                dropped += 1
        return {"dropped": float(dropped)}

    rollout = ServeRollout(store, router, serve_canary, deadline_s=30.0,
                           ready_timeout_s=wait_s)
    clock = wiring.clock
    ctrl = Controller(store, wiring.journal, build_actions(wiring.ctx), rollout,
                      config=wiring.config, clock=lambda: clock[0])
    clock[0] += 120.0
    fronts = []
    stop_load = threading.Event()

    # A closed loop: at most one replica's slots in flight over the fleet,
    # so every replica holds work and the one left serving while another
    # drains is not queued past its slots (an open loop outran the card's
    # fleet, and its queue outlasted the canary's wait).
    cap = min(rep.engine.n_slots for rep in router.replicas.values())

    def loader():
        while not stop_load.is_set():
            if sum(1 for f in fronts if not f.done) < cap:
                try:
                    fronts.append(router.submit(prompts[len(fronts) % len(prompts)],
                                                max_new_tokens=max_new))
                except Backpressure:
                    pass  # typed shed at the edge; never a drop
            stop_load.wait(0.02)

    thread = threading.Thread(target=loader, daemon=True)
    thread.start()
    try:
        # The first drain should find work in flight.
        retry.wait_until(lambda: all(rep.outstanding > 0 for rep in router.replicas.values()),
                         10.0, interval_s=0.005)
        t0 = time.perf_counter()
        recs = ctrl.ingest_slo_report({"burn_rate": {"fast": 3.2, "slow": 0.4,
                                                     "windows_s": [300, 3600]}})
    finally:
        stop_load.set()
        thread.join(timeout=10.0)
    rollout_s = time.perf_counter() - t0
    rec = recs[0] if recs else None
    if rec is None or rec.verdict != "committed":
        failures.append(f"slo-burn episode did not commit a pool grow "
                        f"(got {rec.verdict if rec else None!r})")
    elif rec.action != "tune_pool":
        failures.append(f"burn trigger routed to {rec.action}")
    if int((store.load() or PilotState()).n_pages) <= base_pages:
        failures.append("pool knob did not grow in the deployed state")
    if not retry.wait_until(
            lambda: all(router.replica_state(rid) is ReplicaState.READY
                        for rid in router.replicas), 30.0, interval_s=0.02):
        failures.append("fleet not fully READY after the serve rollout")
    restarts = {rid: rep.restarts - restarts_before[rid]
                for rid, rep in router.replicas.items()}
    if not all(v == 1 for v in restarts.values()):
        failures.append(f"a replica did not restart exactly once: {restarts}")
    pool_after = {rid: rep.engine.pool.n_pages for rid, rep in router.replicas.items()}
    if len(set(pool_after.values())) != 1:
        failures.append(f"fleet left MIXED pool sizes: {pool_after}")
    if not all(pool_after[rid] > pool_before[rid] for rid in pool_after):
        failures.append(f"new pool knob never reached the engines: "
                        f"{pool_before} -> {pool_after}")
    states = [f.wait(wait_s).state for f in fronts]
    n_done = sum(1 for s in states if s is RequestState.DONE)
    zero_drops = n_done == len(fronts)
    if not zero_drops:
        failures.append(f"{len(fronts) - n_done} of {len(fronts)} requests dropped during "
                        f"the serve rollout")
    ledger = router.ledger()
    exactly_once = all(v == 1 for v in ledger.values())
    if not exactly_once:
        zero_drops = False
        failures.append("exactly-once violated during the serve rollout")
    upgrade = list(rollout.last_upgrade or [])
    summary = {
        "verdict": rec.verdict if rec else None,
        "pool_before": pool_before, "pool_after": pool_after, "restarts": restarts,
        "serve_zero_drops": zero_drops, "exactly_once": exactly_once,
        "serve_requests": len(fronts), "rollout_s": rollout_s,
        "restart_s": {int(r["replica"]): r["duration_s"] for r in upgrade},
        "drained": {int(r["replica"]): int(r.get("drained", 0)) for r in upgrade},
        "persisted": {int(r["replica"]): int(r.get("persisted", 0)) for r in upgrade},
    }
    return summary, failures, fronts


def selftest(device="cuda") -> int:
    """Returns a process exit code; prints ONE JSON line. Raises
    ``RuntimeError`` when ``device`` is CUDA and no card is usable."""
    import numpy as np

    from autodist_tpu_torch import metrics as M
    from autodist_tpu_torch.model_item import ModelItem
    from autodist_tpu_torch.models import get_model_spec
    from autodist_tpu_torch.pilot import PilotState
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.serve.router import build_test_fleet
    from autodist_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    n = SELFTEST_GPUS
    spec = ResourceSpec(resource_dict={
        "nodes": [{"address": "localhost", "gpus": n, "chief": True}]})
    model = get_model_spec("mlp", in_dim=4 * n, hidden=(8 * n, 4 * n), num_classes=8)
    params = model.init(0, device=dev)
    batch = model.example_batch(2 * n, device=dev)
    item = ModelItem.from_params(params, loss_fn=model.loss_fn, example_batch=batch)
    tmpdir = tempfile.mkdtemp(prefix="pilot-selftest-")
    try:
        train, failures, loop = train_episodes(model.loss_fn, params, batch, item, spec, dev,
                                               tmpdir)
        store = train["wiring"].store

        # --------------------------- 4. serve rollout under load, zero drops
        router, _control = build_test_fleet(
            n_replicas=2, n_slots=4, page_len=8, n_pages=41, registry=M.MetricsRegistry(),
            journal_dir=os.path.join(tmpdir, "router-journal"), device=dev,
            engine_kwargs=lambda: {
                "n_pages": int((store.load() or PilotState()).n_pages) or 41})
        rng = np.random.default_rng(23)
        prompts = [rng.integers(1, 127, size=int(rng.integers(3, 8))).astype(np.int32)
                   for _ in range(64)]
        try:
            router.start()
            for rep in router.replicas.values():
                rep.wait_ready(120.0)
            serve, serve_failures, _ = serve_rollout(router, train["wiring"], prompts,
                                                     max_new=4)
        finally:
            router.stop(drain=False)
        failures += serve_failures
        verdicts = [r.verdict for r in train["wiring"].journal.read()]
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    ok = not failures
    line = {
        "selftest": "autodist_tpu_torch.pilot",
        "ok": ok,
        "drift": round(train["drift"], 4),
        "measured_stale_ms": round(train["measured_stale_ms"], 6),
        "measured_new_ms": round(train["measured_new_ms"], 6),
        "improvement_frac": round(train["improvement_frac"], 4),
        "poisoned_refit_rejected": train["poisoned_refit_rejected"],
        "canary_rollback_bit_exact": train["canary_rollback_bit_exact"],
        "serve_zero_drops": serve["serve_zero_drops"],
        "serve_requests": serve["serve_requests"],
        "proofs": dict(train["proofs"], serve_rollout_zero_drops=not serve_failures),
        "journal_verdicts": verdicts,
        "deployed": [{k: r[k] for k in ("plan_id", "xla_flag_set", "replayed_ms",
                                        "measured_ms", "steps")} for r in loop.deployed],
        "restart_s": serve["restart_s"],
        "drained": serve["drained"],
        "persisted": serve["persisted"],
        "device": dev.type,
        "n_gpus_priced": n,
        "rebuild_world": 1,
    }
    if failures:
        line["failures"] = failures
    print(json.dumps(line), flush=True)
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m autodist_tpu_torch.pilot",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--selftest", action="store_true",
                    help="run the closed-loop autopilot proof and exit")
    ap.add_argument("--device", default="cuda",
                    help="selftest: the device the rebuilds and the fleet run on (default "
                         "cuda; cpu for the plain path)")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest(device=args.device)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
