"""Fault catalog: every injectable fault class, its seam, and what the
ft/obs stack is expected to do about it (PyTorch port of the JAX
package's ``chaos/faults.py``: the same kinds, seams, contracts and
injectors, so one schedule and seed inject the same faults, and write the
same trace, in both packages).

The catalog is the chaos subsystem's source of truth: each
:class:`FaultSpec` names the **seam** the fault enters through
(:mod:`autodist_tpu_torch.chaos.hooks`), the **detection** the stack must
produce (a sentry ``SNT###`` code, a doctor ``DOC###`` verdict, or a typed
degradation), and the **recovery** contract the soak harness asserts (the JAX package's ``chaos/harness.py``; the port's
harness is ROADMAP item 6d, and its two ``"process"`` kinds have no hook
here).

Injector implementations live here too — :func:`make_handlers` builds the
per-seam hook closures a :class:`~autodist_tpu_torch.chaos.schedule.ChaosPlant`
installs. All randomness (which byte to flip, which file to truncate)
comes from the plant's seeded RNG and lands in the injection trace, so a
schedule replay is byte-for-byte reproducible.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List

from autodist_tpu_torch.chaos import hooks

__all__ = ["CATALOG", "FaultSpec", "make_handlers"]


@dataclass(frozen=True)
class FaultSpec:
    """One injectable fault class."""

    kind: str
    seam: str          # hooks.SEAM_* ("process" for launcher-level kills)
    description: str
    detects: str       # expected SNT/DOC code or typed outcome
    recovery: str      # the graceful-degradation / recovery contract


CATALOG: Dict[str, FaultSpec] = {s.kind: s for s in (
    FaultSpec(
        "nan_loss", hooks.SEAM_TRAIN_BATCH,
        "poison the training batch with NaN at step N (NaN gradients and "
        "loss by construction)",
        "SNT001 + DOC001",
        "restore the newest verified snapshot, replay clean steps; tail "
        "matches the uninterrupted run (elastic-resume tolerance)"),
    FaultSpec(
        "loss_spike", hooks.SEAM_TRAIN_BATCH,
        "scale the training batch by a large factor at step N (finite "
        "loss spike, z-score past threshold)",
        "SNT003 + DOC000",
        "restore the newest verified snapshot, replay clean steps; tail "
        "matches the uninterrupted run"),
    FaultSpec(
        "straggler", hooks.SEAM_AGG_SWEEP,
        "multiply one host's published step-time quantiles while the "
        "fault window is open",
        "SNT006 + HealthMonitor SUSPECT escalation",
        "score renormalizes when the window closes; the sentry episode "
        "re-arms (exactly one finding per episode)"),
    FaultSpec(
        "heartbeat_drop", hooks.SEAM_HB_PUBLISH,
        "drop one host's heartbeat publishes for the fault window "
        "(transport loss / network delay)",
        "peer HEALTHY -> SUSPECT -> DEAD transitions",
        "first fresh beat after the window returns the peer to HEALTHY "
        "(escalation backoff resets)"),
    FaultSpec(
        "heartbeat_partition", hooks.SEAM_HB_SWEEP,
        "hide every peer from the sweeping side (full partition: the "
        "observer sees a silent fleet)",
        "fleet_hung + hang bundle -> DOC003",
        "the launcher watchdog writes an attributable doctor bundle and "
        "terminates the fleet for a supervised restart"),
    FaultSpec(
        "snapshot_corrupt", hooks.SEAM_SNAPSHOT_WRITTEN,
        "flip one byte of a landed snapshot file after its manifest is "
        "written (bit rot / torn storage)",
        "verify() fails; ft_snapshots_corrupt_total increments",
        "latest_valid() falls back to the previous ring entry; restore "
        "succeeds from it"),
    FaultSpec(
        "snapshot_partial", hooks.SEAM_SNAPSHOT_WRITTEN,
        "truncate a landed snapshot file to half (partial write / full "
        "disk at the wrong moment)",
        "verify() fails; ft_snapshots_corrupt_total increments",
        "latest_valid() falls back to the previous ring entry"),
    FaultSpec(
        "snapshot_unwritable", hooks.SEAM_SNAPSHOT_WRITE,
        "raise OSError from the snapshot write path for the first K "
        "attempts (transient mount/permission loss)",
        "utils.retry heals it within policy (write retries counted); a "
        "permanent failure surfaces loudly via wait()",
        "snapshot lands on a retry attempt; no skipped ring slot"),
    FaultSpec(
        "serve_admission", hooks.SEAM_SERVE_ADMIT,
        "make engine admission defer (no free slot) while the window is "
        "open, backing the admission queue up",
        "typed REJECTED results with a reason + shed flight events "
        "(doctor timeline shows shed-load windows)",
        "queued work completes once the window closes; overflow is shed "
        "at the edge, nothing hangs"),
    FaultSpec(
        "page_exhaustion", hooks.SEAM_SERVE_PAGES,
        "report the KV page pool exhausted to every allocation while the "
        "window is open (a burst past pool capacity)",
        "admissions defer typed (requests stay QUEUED); queue overflow "
        "sheds typed REJECTED + shed flight events (doctor timeline shows "
        "the pressure window)",
        "pages recycle when the window closes: queued work completes, "
        "overflow was shed at the edge — no hang, no OOM"),
    FaultSpec(
        "eviction_storm", hooks.SEAM_SERVE_PAGES,
        "report the pool exhausted to every allocation while the window "
        "is open, against a prefix-cache engine holding a warm radix "
        "tree: sustained pressure forces eviction churn down to an "
        "empty tree before admission degrades",
        "admissions evict cold refcount-0 prefixes (prefix_stats "
        "evictions) then degrade typed (requests stay QUEUED); eviction "
        "never touches a live request's pages and no request ever reads "
        "another's KV (streams bit-identical)",
        "after the window admissions recompute the evicted prefixes and "
        "re-insert them; refcounts balance to zero at drain, pages "
        "leak-check to zero — eviction costs recompute, never "
        "correctness"),
    FaultSpec(
        "engine_death", hooks.SEAM_SERVE_STEP,
        "raise EngineDeadError from the decode step mid-batch",
        "every in-flight/queued request finished typed REJECTED with an "
        "engine-death reason; error event -> DOC006",
        "the batcher sheds all load with explicit rejections and stops; "
        "no client ever blocks in wait()"),
    FaultSpec(
        "worker_kill", "process",
        "SIGKILL a supervised fleet process mid-run (the harness child "
        "kills itself; no hook — the fault is the process dying)",
        "supervised restart with jittered exponential backoff",
        "restart budget and backoff reset on snapshot-ring progress; the "
        "relaunched attempt completes"),
    FaultSpec(
        "replica_death", hooks.SEAM_SERVE_STEP,
        "raise EngineDeadError from ONE replica's decode step "
        "(host-targeted) while the survivors keep serving behind the "
        "router",
        "replica self-reports DEAD; router failover — every in-flight "
        "request completes exactly once on survivors with the delivered "
        "stream bit-identical to an uninterrupted run; error event -> "
        "DOC006",
        "the router reroutes journaled work with prefix resume (the "
        "overlap token re-derived and asserted bit-equal); no duplicate "
        "delivery, no drop"),
    FaultSpec(
        "kill_mid_stochastic_stream", hooks.SEAM_SERVE_STEP,
        "raise EngineDeadError from ONE replica's decode step while it "
        "serves STOCHASTIC (temperature > 0) streams behind the router",
        "router failover resumes every sampled stream on a survivor with "
        "delivered tokens bit-identical to an uninterrupted control — "
        "the counter-based draws (serve/sampling.py) depend only on "
        "(request_id, seed, position), never on which replica, slot, or "
        "cache state produced them; error event -> DOC006",
        "journaled prefix resume re-derives the overlap token's draw "
        "from the same counter and asserts it bit-equal; exactly-once "
        "delivery holds for sampled streams exactly as for greedy"),
    FaultSpec(
        "kill_mid_quantized_stream", hooks.SEAM_SERVE_STEP,
        "raise EngineDeadError from ONE replica's decode step while it "
        "serves from int8 QUANTIZED KV pages behind the router",
        "router failover resumes every stream on a survivor with "
        "delivered tokens bit-identical to an uninterrupted quantized "
        "control — quantize-on-scatter is deterministic (amax/127 per "
        "(position, head)), so the survivor's re-prefill reproduces the "
        "dead replica's pages bit-exactly and the documented drift bound "
        "holds trivially across the failover; error event -> DOC006",
        "journaled prefix resume re-derives the overlap token against "
        "freshly quantized pages and asserts it bit-equal; exactly-once "
        "delivery holds for quantized serving exactly as for fp pages"),
    FaultSpec(
        "replica_partition", hooks.SEAM_HB_PUBLISH,
        "drop ONE replica's control-plane beats for the window (the "
        "replica itself keeps serving — a partition, not a death)",
        "router view READY -> SUSPECT; new work routed around the "
        "suspect",
        "beats resume -> READY -> routed again; work that stayed on the "
        "partitioned replica delivers exactly once (no duplicate, no "
        "drop, no spurious failover)"),
    FaultSpec(
        "draft_divergence", hooks.SEAM_SERVE_DRAFT,
        "garble the speculative-decode draft proposals (a seeded draft "
        "that proposes garbage) for the whole window",
        "acceptance collapses toward 0 (spec_stats / "
        "serve_spec_acceptance_rate); delivered streams stay "
        "bit-identical to plain greedy; no crash",
        "the target's verify program rejects every garbled proposal and "
        "still emits its own correct token each round — cadence degrades "
        "to ~1 token/round (bounded ITL), correctness and page "
        "accounting are untouched"),
    FaultSpec(
        "poisoned_calibration", hooks.SEAM_PILOT_REFIT,
        "corrupt one live calibration record at the pilot's refit intake "
        "(measured_s scaled by an adversarial factor) before the fit "
        "runs",
        "the pilot's fit-error regression gate (candidate graded on the "
        "TRUSTED records vs the pre-refit coefficients) rejects the "
        "refit; decision journal shows trigger -> rejected; the run "
        "stays DOC000",
        "persisted calibration coefficients unchanged (bit-equal) — the "
        "poisoned fit is never deployed; a subsequent clean refit "
        "proceeds normally (keep-best in plan/calibrate.py is the "
        "second, independent guard)"),
    FaultSpec(
        "rolling_upgrade_under_load", "process",
        "drain + restart every replica in turn under sustained traffic "
        "(no hook — the 'fault' is the upgrade itself)",
        "zero dropped requests; only typed shed; p99 bounded; every "
        "replica restarted exactly once",
        "each drained replica's leftovers fail over through the journal "
        "(ids + delivered watermarks); the restarted replica re-admits "
        "on its READY beat"),
)}


# ------------------------------------------------------------- injectors
def _poison_tree(tree, fill=None, scale=None):
    """NaN-fill or scale every floating leaf (tensors or numpy arrays);
    a tensor stays a tensor on its device."""
    import numpy as np
    import torch
    from torch.utils._pytree import tree_map

    def leaf(x):
        if isinstance(x, torch.Tensor):
            if not x.is_floating_point():
                return x
            if fill is not None:
                return torch.full_like(x, fill)
            return x * torch.tensor(scale, dtype=x.dtype, device=x.device)
        a = np.asarray(x)
        if not np.issubdtype(a.dtype, np.floating):
            return x
        if fill is not None:
            return np.full_like(a, fill)
        return a * np.asarray(scale, a.dtype)

    return tree_map(leaf, tree)


def make_handlers(plant) -> Dict[str, Callable]:
    """Build the seam->hook map for ``plant``'s schedule. Only seams whose
    faults actually appear in the schedule get handlers, so an installed
    plant perturbs nothing it was not asked to."""
    seams = {CATALOG[e.fault].seam for e in plant.schedule.events
             if e.fault in CATALOG}
    handlers: Dict[str, Callable] = {}

    def events(seam: str, step=None) -> List:
        return [e for e in plant.schedule.events
                if CATALOG.get(e.fault) is not None
                and CATALOG[e.fault].seam == seam
                and e.active(plant.step if step is None else step)]

    if hooks.SEAM_TRAIN_BATCH in seams:
        def train_batch(batch, num_steps=1, **_):
            # A window [step, step+num_steps) is poisoned when any of its
            # steps falls inside an event window; the harness uses
            # num_steps=1 so injection is per-step exact.
            for e in plant.schedule.events:
                if CATALOG[e.fault].seam != hooks.SEAM_TRAIN_BATCH:
                    continue
                if not any(e.active(plant.step + i)
                           for i in range(max(1, int(num_steps)))):
                    continue
                if e.fault == "nan_loss":
                    plant.record("nan_loss", detail="batch poisoned with NaN")
                    batch = _poison_tree(batch, fill=float("nan"))
                elif e.fault == "loss_spike":
                    scale = float(e.param("scale", 64.0))
                    plant.record("loss_spike", detail=f"batch scaled x{scale:g}")
                    batch = _poison_tree(batch, scale=scale)
            return batch

        handlers[hooks.SEAM_TRAIN_BATCH] = train_batch

    # The metrics seam always installs alongside train faults: it is where
    # the plant's step counter advances (post-window), keeping batch and
    # metrics views of "the current step" consistent.
    if hooks.SEAM_TRAIN_BATCH in seams:
        def train_metrics(metrics, num_steps=1, **_):
            plant.advance(max(1, int(num_steps)))
            return metrics

        handlers[hooks.SEAM_TRAIN_METRICS] = train_metrics

    if hooks.SEAM_HB_PUBLISH in seams:
        def hb_publish(payload, process_id=0, **_):
            for e in events(hooks.SEAM_HB_PUBLISH):
                if e.fault == "heartbeat_drop" and int(e.host) == int(process_id):
                    plant.record("heartbeat_drop", host=int(process_id))
                    return None  # the beat never lands
                if (e.fault == "replica_partition"
                        and int(e.host) == int(process_id)):
                    # record_once: replica heartbeat threads publish on a
                    # wall-clock cadence, so a per-drop trace would be
                    # timing-dependent — one entry per window keeps the
                    # trace replay-deterministic.
                    plant.record_once(("replica_partition", e.at_step,
                                       int(process_id)),
                                      "replica_partition",
                                      host=int(process_id),
                                      detail="control-plane beats dropped")
                    return None
            return payload

        handlers[hooks.SEAM_HB_PUBLISH] = hb_publish

    if hooks.SEAM_HB_SWEEP in seams:
        def hb_sweep(board, **_):
            for e in events(hooks.SEAM_HB_SWEEP):
                if e.fault == "heartbeat_partition":
                    plant.record_once(("heartbeat_partition", e.at_step),
                                      "heartbeat_partition",
                                      detail=f"hiding {len(board)} peer(s)")
                    return {}
            return board

        handlers[hooks.SEAM_HB_SWEEP] = hb_sweep

    if hooks.SEAM_AGG_SWEEP in seams:
        def agg_sweep(fleet, **_):
            for e in events(hooks.SEAM_AGG_SWEEP):
                if e.fault != "straggler":
                    continue
                host = int(e.host)
                summary = fleet.get(host)
                if isinstance(summary, dict):
                    scale = float(e.param("scale", 3.0))
                    slowed = dict(summary)
                    for k in ("p50", "p90", "p99", "mean"):
                        if k in slowed:
                            slowed[k] = float(slowed[k]) * scale
                    fleet = {**fleet, host: slowed}
                    plant.record_once(("straggler", e.at_step, host),
                                      "straggler", host=host,
                                      detail=f"p50 x{scale:g}")
            return fleet

        handlers[hooks.SEAM_AGG_SWEEP] = agg_sweep

    if hooks.SEAM_SNAPSHOT_WRITE in seams:
        def snapshot_write(path="", step=None, **_):
            for e in events(hooks.SEAM_SNAPSHOT_WRITE):
                if e.fault != "snapshot_unwritable":
                    continue
                times = int(e.param("times", 1))
                used = plant.state.setdefault(("unwritable", id(e)), 0)
                if used < times:
                    plant.state[("unwritable", id(e))] = used + 1
                    plant.record("snapshot_unwritable", step=step,
                                 detail=f"write attempt {used + 1} refused")
                    raise OSError(
                        f"chaos: snapshot dir unwritable (injected, "
                        f"attempt {used + 1}/{times})")

        handlers[hooks.SEAM_SNAPSHOT_WRITE] = snapshot_write

    if hooks.SEAM_SNAPSHOT_WRITTEN in seams:
        def snapshot_written(path="", step=None, **_):
            for e in events(hooks.SEAM_SNAPSHOT_WRITTEN):
                if e.fault not in ("snapshot_corrupt", "snapshot_partial"):
                    continue
                names = sorted(
                    os.path.join(r, f)
                    for r, _, fs in os.walk(path) for f in fs
                    if f != "MANIFEST.json")
                if not names:
                    continue
                victim = names[plant.rng.randrange(len(names))]
                size = os.path.getsize(victim)
                if size <= 0:
                    continue
                rel = os.path.relpath(victim, path)
                if e.fault == "snapshot_corrupt":
                    offset = plant.rng.randrange(size)
                    with open(victim, "r+b") as f:
                        f.seek(offset)
                        byte = f.read(1)
                        f.seek(offset)
                        f.write(bytes([(byte[0] ^ 0xFF) if byte else 0xFF]))
                    plant.record("snapshot_corrupt", step=step, file=rel,
                                 detail=f"flipped byte {offset}")
                else:
                    with open(victim, "r+b") as f:
                        f.truncate(size // 2)
                    plant.record("snapshot_partial", step=step, file=rel,
                                 detail=f"truncated {size} -> {size // 2}")

        handlers[hooks.SEAM_SNAPSHOT_WRITTEN] = snapshot_written

    if hooks.SEAM_SERVE_ADMIT in seams:
        def serve_admit(**_):
            for e in events(hooks.SEAM_SERVE_ADMIT):
                if e.fault == "serve_admission":
                    plant.record_once(("serve_admission", e.at_step),
                                      "serve_admission",
                                      detail="admission deferred")
                    return "defer"
            return None

        handlers[hooks.SEAM_SERVE_ADMIT] = serve_admit

    if hooks.SEAM_SERVE_PAGES in seams:
        def serve_pages(**_):
            for e in events(hooks.SEAM_SERVE_PAGES):
                if e.fault == "page_exhaustion":
                    plant.record_once(("page_exhaustion", e.at_step),
                                      "page_exhaustion",
                                      detail="pool reported exhausted")
                    return "exhaust"
                if e.fault == "eviction_storm":
                    # Same directive, different victim: against a
                    # prefix-cache engine the evict-retry loop drains the
                    # radix tree (churn) before the typed None lands.
                    plant.record_once(("eviction_storm", e.at_step),
                                      "eviction_storm",
                                      detail="sustained pool pressure")
                    return "exhaust"

        handlers[hooks.SEAM_SERVE_PAGES] = serve_pages

    if hooks.SEAM_SERVE_DRAFT in seams:
        def serve_draft(host=0, **_):
            for e in events(hooks.SEAM_SERVE_DRAFT):
                if (e.fault == "draft_divergence"
                        and int(e.host) == int(host)):
                    # record_once: the seam fires every spec round from a
                    # scheduler thread — one trace entry per window keeps
                    # replay byte-deterministic (the garbling itself is a
                    # deterministic offset, no RNG draw needed).
                    plant.record_once(("draft_divergence", e.at_step,
                                       int(host)),
                                      "draft_divergence", host=int(host),
                                      detail="draft proposals garbled")
                    return "garbage"
            return None

        handlers[hooks.SEAM_SERVE_DRAFT] = serve_draft

    if hooks.SEAM_PILOT_REFIT in seams:
        def pilot_refit(records, **_):
            from dataclasses import replace as _replace

            for e in events(hooks.SEAM_PILOT_REFIT):
                if e.fault != "poisoned_calibration" or not records:
                    continue
                scale = float(e.param("scale", 1000.0))
                idx = plant.rng.randrange(len(records))
                records = list(records)
                records[idx] = _replace(
                    records[idx],
                    measured_s=float(records[idx].measured_s) * scale)
                plant.record("poisoned_calibration", index=idx,
                             detail=f"measured_s x{scale:g}")
            return records

        handlers[hooks.SEAM_PILOT_REFIT] = pilot_refit

    if hooks.SEAM_SERVE_STEP in seams:
        def serve_step(host=0, **_):
            for e in events(hooks.SEAM_SERVE_STEP):
                if e.fault == "engine_death":
                    from autodist_tpu_torch.serve.engine import EngineDeadError

                    plant.record_once(("engine_death", e.at_step),
                                      "engine_death",
                                      detail="decode step raised")
                    raise EngineDeadError(
                        "chaos: injected engine death mid-decode")
                if (e.fault == "replica_death"
                        and int(e.host) == int(host)):
                    from autodist_tpu_torch.serve.engine import EngineDeadError

                    plant.record_once(("replica_death", e.at_step,
                                       int(host)),
                                      "replica_death", host=int(host),
                                      detail="decode step raised")
                    raise EngineDeadError(
                        f"chaos: injected replica {host} death mid-decode")
                if (e.fault == "kill_mid_stochastic_stream"
                        and int(e.host) == int(host)):
                    from autodist_tpu_torch.serve.engine import EngineDeadError

                    plant.record_once(("kill_mid_stochastic_stream",
                                       e.at_step, int(host)),
                                      "kill_mid_stochastic_stream",
                                      host=int(host),
                                      detail="decode step raised mid-"
                                             "stochastic-stream")
                    raise EngineDeadError(
                        f"chaos: injected replica {host} death mid-"
                        f"stochastic-stream")
                if (e.fault == "kill_mid_quantized_stream"
                        and int(e.host) == int(host)):
                    from autodist_tpu_torch.serve.engine import EngineDeadError

                    plant.record_once(("kill_mid_quantized_stream",
                                       e.at_step, int(host)),
                                      "kill_mid_quantized_stream",
                                      host=int(host),
                                      detail="decode step raised mid-"
                                             "quantized-stream")
                    raise EngineDeadError(
                        f"chaos: injected replica {host} death mid-"
                        f"quantized-stream")

        handlers[hooks.SEAM_SERVE_STEP] = serve_step

    return handlers
