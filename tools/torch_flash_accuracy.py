#!/usr/bin/env python3
"""Accuracy of the flash-attention path's gradients, for the PyTorch/CUDA port.

    python3 tools/torch_flash_accuracy.py [--device cuda] [--small] [--out FILE]

One step's loss and gradients of ``bert_base`` at seq 512 (``--small``: 4
layers, d_model 256, seq 128, vocab 1000; batch 8, or 2 with ``--small``),
seeded weights, through three paths, each held against the same model run
in fp32 with ``dot`` attention:

- ``flash``: bf16 compute through the flash kernels (the CPU runs their
  plain versions), delta = rowsum(dO * O) from the bf16-rounded O, as the
  JAX package's backward takes it;
- ``flash_fp32_delta``: the same, but delta from O computed in fp32 (the
  forward's plain version on widened inputs), everything else unchanged;
- ``dot``: bf16 compute through plain attention.

Per path it prints the whole gradient's relative L2 error, the worst tensor
among those of at least 1e-3 of the gradient's norm, and the worst tensor
of all (the key biases, whose true gradient is 0, left out). On the card it
also counts, in fp32, the elements where each flash kernel differs from its
plain version, and prints the card's name and power limit. Prints JSON
lines; the full per-tensor table goes to ``--out`` (default
``profile_out/torch_flash_accuracy.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from autodist_tpu_torch.models import get_model_spec  # noqa: E402
from autodist_tpu_torch.models.convert import flatten_params, unflatten_params  # noqa: E402
from autodist_tpu_torch.ops import flash_attention as fa  # noqa: E402
from autodist_tpu_torch.utils.device import resolve_device  # noqa: E402

FLOOR = 1e-3


class _Fp32DeltaFlash(fa.FlashAttentionFn):
    """FlashAttentionFn with delta taken from an fp32 O."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = fa.flash_fwd(q, k, v, causal)
        out32, _ = fa.flash_fwd_plain(q.float(), k.float(), v.float(), causal)
        ctx.save_for_backward(q, k, v, out32, lse)
        ctx.causal = causal
        return out


def _loss_and_grads(spec, params, batch):
    flat = {n: t.detach().clone().requires_grad_(True)
            for n, t in flatten_params(params).items()}
    loss = spec.loss_fn(unflatten_params(flat), batch)
    return loss.item(), dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))


def _compare(grads, ref):
    total = torch.sqrt(sum((g.float() ** 2).sum() for g in ref.values()))
    diff = torch.sqrt(sum(((grads[n].float() - g.float()) ** 2).sum()
                          for n, g in ref.items()))
    # The key biases' true gradient is 0 (softmax ignores a per-query
    # constant): theirs is rounding noise in every path, so no relative error.
    rows = {n: {"rel": ((grads[n].float() - g.float()).norm() / g.float().norm()).item(),
                "norm_share": (g.float().norm() / total).item()}
            for n, g in ref.items() if not n.endswith("attn/wk/bias")}
    over = {n: r for n, r in rows.items() if r["norm_share"] >= FLOOR}
    worst_over = max(over, key=lambda n: over[n]["rel"])
    worst_all = max(rows, key=lambda n: rows[n]["rel"])
    return {"whole_rel": (diff / total).item(),
            "worst_over_floor": [worst_over, over[worst_over]],
            "worst_any": [worst_all, rows[worst_all]]}, rows


def _kernel_vs_plain(dev):
    """Elements where each fp32 kernel output differs from its plain version."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    out = {}
    for causal in (False, True):
        q, k, v, g = (torch.randn((4, 256, 3, 64), generator=gen, device=dev)
                      for _ in range(4))
        o, lse = fa.flash_fwd(q, k, v, causal)
        po, plse = fa.flash_fwd_plain(q, k, v, causal)
        delta = (po * g).sum(-1).permute(0, 2, 1).contiguous()
        dk, dv = fa.flash_dkdv(q, k, v, g, plse, delta, causal)
        dq = fa.flash_dq(q, k, v, g, plse, delta, causal)
        pk, pv = fa.flash_dkdv_plain(q, k, v, g, plse, delta, causal)
        pq = fa.flash_dq_plain(q, k, v, g, plse, delta, causal)
        torch.cuda.synchronize()
        out["causal" if causal else "full"] = {
            name: [int((a != b).sum()), a.numel(), (a - b).abs().max().item()]
            for name, a, b in (("o", o, po), ("lse", lse, plse), ("dk", dk, pk),
                               ("dv", dv, pv), ("dq", dq, pq))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=os.path.join("profile_out",
                                                  "torch_flash_accuracy.json"))
    args = ap.parse_args()
    dev = resolve_device(args.device)
    kw = dict(max_seq_len=512)
    batch_size = 8
    if args.small:
        kw = dict(vocab_size=1000, num_layers=4, d_model=256, num_heads=4, d_ff=512,
                  max_seq_len=128)
        batch_size = 2
    specs = {name: get_model_spec("bert_base", attention_impl=impl, **kw, **extra)
             for name, impl, extra in (("flash", "flash", {}), ("dot", "dot", {}),
                                       ("fp32", "dot", {"dtype": "float32"}))}
    params = specs["flash"].init(4, device=dev)
    batch = specs["flash"].example_batch(batch_size, device=dev)
    runs = {name: _loss_and_grads(spec, params, batch) for name, spec in specs.items()}
    original = fa.FlashAttentionFn
    fa.FlashAttentionFn = _Fp32DeltaFlash
    try:
        runs["flash_fp32_delta"] = _loss_and_grads(specs["flash"], params, batch)
    finally:
        fa.FlashAttentionFn = original
    ref_loss, ref = runs["fp32"]
    doc = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
           "config": {**kw, "batch": batch_size}, "loss_fp32": ref_loss, "paths": {},
           "tensors": {}}
    for name in ("flash", "flash_fp32_delta", "dot"):
        summary, rows = _compare(runs[name][1], ref)
        doc["paths"][name] = {"loss": runs[name][0], **summary}
        doc["tensors"][name] = rows
        print(json.dumps({"path": name, "loss": runs[name][0], **summary}), flush=True)
    if dev.type == "cuda":
        doc["kernel_vs_plain_fp32"] = _kernel_vs_plain(dev)
        print(json.dumps({"kernel_vs_plain_fp32": doc["kernel_vs_plain_fp32"]}))
        doc["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        print(doc["card"])
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
