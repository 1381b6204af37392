#!/usr/bin/env python3
"""Sequence and pipeline parallelism on the cards of one machine.

    python3 tools/torch_parallel_profile.py [--rehearsal] [--out DIR]
    python3 tools/torch_parallel_profile.py --three-axis [--rehearsal] [--out DIR]

Builds the flash-attention library from the checkout, then runs
``chip_smoke.py``'s ``seq_parallel`` and ``pipeline`` phases with one NCCL
rank a card (the seq and pipe axes the largest power of two up to
min(cards, 4)): the full-width causal transformer at a 4096-token context
under ring and Ulysses attention, held to flash on rank 0 alone (and the
flash kernels held to their plain versions at that phase's shapes), and
bert_base as a 4-stage pipeline through ``AutoDist.build_pipeline``, held
to the plain sequential step and timed against the sequential fallback,
with the peak memory and ms of one call of each schedule (gpipe, 1f1b,
interleaved) where there is more than one card.
``--rehearsal`` adds the 4-gloo-rank CPU rehearsal. Prints the phases' JSON
lines, then one summary line (the card's name and power limit beside it);
``--out DIR`` also writes the summary to ``DIR/parallel_profile.json``.
Run it on a machine with four cards to cross NVLink (about two minutes).

``--three-axis`` runs ``chip_smoke.py``'s ``three_axis`` phase instead: on
four cards the 2 x 2 meshes with data 1 (the MoE at model x expert,
bert_base under Ulysses and ring at seq x model, the bert_base stage stack
through ``build_pipeline`` at pipe x model and seq x pipe), each held to the
one-process step by one fp32 SGD step, with ms a bf16 step beside data 4
and the two-axis meshes they extend, and ``DTensor``'s collectives of a
step by axis (``--rehearsal``: the 8-gloo-rank CPU rehearsal too). Below
four cards the phase runs its one-card placed checks. The summary goes to
``DIR/three_axis_profile.json``.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearsal", action="store_true")
    ap.add_argument("--three-axis", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_parallel_profile: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = c.card_line()
    if args.three_axis:
        return _three_axis(card, args)
    c._build.build(("flash_attention",))
    c.fa.build_kernel()
    seq_rows, pipe_rows = c.parallel_train(card, dev)
    flash_rows = c.seq_flash_cases(torch.Generator(device=dev).manual_seed(c.SEED), dev)
    if args.rehearsal:
        c.parallel_rehearsal()
    by_impl = {r["attention_impl"]: r for r in seq_rows}
    lead = pipe_rows[0]
    summary = {
        "card": card, "cards": torch.cuda.device_count(), "torch": torch.__version__,
        "seq": {"world": by_impl["ring"]["world"], "seq_len": c.SEQ_LEN,
                "batch": c.SEQ_BATCH,
                "ms_per_step": {k: r["ms_per_step"] for k, r in by_impl.items()},
                "peak_mem_gb": {k: r["peak_mem_gb"] for k, r in by_impl.items()},
                "flash_launches": {k: r["kernel_launches"] for k, r in by_impl.items()},
                "flash_kernels": [{k: r[k] for k in ("kernel", "B", "S", "H", "max_abs_err",
                                                     "err_over_bound", "rel_l2", "rel_l2_limit",
                                                     "kernel_ms",
                                                     "plain_ms", "library_ms", "bound_ms")}
                                  for r in flash_rows]},
        "pipeline": {"world": lead["world"], "stages": lead["stages"],
                     "microbatches": lead["microbatches"],
                     "ms_per_step": lead["ms_per_step"],
                     "plain_ms_per_step": lead["plain_ms_per_step"],
                     "sequential_ms_per_step": lead["sequential_ms_per_step"],
                     "bubble_vs_sequential": lead.get("bubble_vs_sequential"),
                     "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in pipe_rows],
                     "schedules_by_rank": [r.get("schedules") for r in pipe_rows],
                     "flash_launches": lead["kernel_launches"]},
    }
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "parallel_profile.json"), "w",
                  encoding="utf-8") as f:
            json.dump(summary, f, indent=1)
    return 0


def _three_axis(card: str, args) -> int:
    """The three_axis phase and its summary (the module docstring)."""
    c._build.build(("flash_attention", "fused_conv_stats"))
    c.fa.build_kernel()
    c.fcs.build_kernel()
    res = c.three_axis(card)
    if args.rehearsal:
        c.three_axis_rehearsal()
    summary = {"card": card, "cards": torch.cuda.device_count(), "torch": torch.__version__}
    if "placed" in res:
        summary["placed"] = {k: {f: v[f] for f in ("bitwise", "grads", "kernel_launches")}
                             for k, v in res["placed"].items()}
    else:
        base = {(b["kind"], b["impl"], json.dumps(b["mesh"], sort_keys=True)): b["ms_per_step"]
                for b in res["baselines"]}
        summary["meshes"] = [{
            "id": r["id"], "mesh": r["mesh"], "ms_per_step": r["ms_per_step"],
            "data4_ms_per_step": base[(r["model"], "flash" if r["model"] == "bert" else None,
                                       json.dumps({"data": 4}, sort_keys=True))],
            "dtensor_collectives_by_axis": {ax: r["collectives"].get(ax, {})
                                            for ax in ("model", "expert")},
            "losses": r["losses"], "fp32_sgd": r["fp32_sgd"],
            "flash_launches": r["kernel_launches"]} for r in res["meshes"]]
        summary["baselines"] = res["baselines"]
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "three_axis_profile.json"), "w",
                  encoding="utf-8") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
