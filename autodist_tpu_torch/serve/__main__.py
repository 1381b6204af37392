"""CLI: ``python -m autodist_tpu_torch.serve`` — serve a zoo model over HTTP.

The weights come from a seeded ``torch.Generator``, or from a checkpoint
(``--checkpoint``: a ``Saver`` directory or one ``ckpt-N``, such as a
training run's ``step.save``; either package's)::

    python -m autodist_tpu_torch.serve --model transformer \\
        --model-arg num_layers=2 --slots 32 --port 8476 --device cuda \\
        [--checkpoint DIR]

The engine comes from ``AutoDist.build_inference``. ``--draft-model
transformer --draft-arg num_layers=2 --spec-k 4`` serves through the
speculative engine (``serve/spec.py``; ``--draft-checkpoint`` restores the
draft); ``--prefix-cache`` shares
prompt prefixes copy-on-write (``serve/prefix.py``); a POST body's
``temperature`` / ``top_k`` / ``top_p`` / ``seed`` draw the counter-based
stochastic stream (``serve/sampling.py``). The CPU proofs, each printing
one JSON line and exiting non-zero on a failed bar: ``--selftest-spec``,
``--selftest-prefix``, ``--selftest-sampling``.
"""
from __future__ import annotations

import argparse
import asyncio
import signal
import sys


def _parse_overrides(pairs):
    out = {}
    for pair in pairs or ():
        k, _, v = pair.partition("=")
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = {"true": True, "false": False}.get(v.lower(), v)
    return out


def build_frontend(args):
    """Engine + batcher + front end from parsed CLI args."""
    from autodist_tpu_torch.api import AutoDist
    from autodist_tpu_torch.models import get_model
    from autodist_tpu_torch.models.transformer import decode_model, init_params
    from autodist_tpu_torch.serve.batcher import ContinuousBatcher
    from autodist_tpu_torch.serve.server import ServeFrontend

    overrides = _parse_overrides(args.model_arg)
    if args.kv_quant:
        overrides["kv_quant"] = True
    cfg = get_model(args.model, **overrides)
    params = init_params(cfg, seed=args.seed, device=args.device)
    kwargs = dict(n_slots=args.slots, page_len=args.page_len, n_pages=args.pages,
                  prefill_chunk=args.prefill_chunk, prefix_cache=args.prefix_cache,
                  checkpoint=args.checkpoint)
    if args.draft_model:
        draft_overrides = _parse_overrides(args.draft_arg)
        if args.kv_quant:
            draft_overrides["kv_quant"] = True
        draft_cfg = get_model(args.draft_model, **draft_overrides)
        kwargs.update(draft_params=init_params(draft_cfg, seed=args.seed + 1,
                                               device=args.device),
                      draft_decode_model=decode_model(draft_cfg),
                      draft_checkpoint=args.draft_checkpoint, spec_k=args.spec_k)
    AutoDist.reset_default()
    engine = AutoDist(device=args.device).build_inference(
        params, decode_model=decode_model(cfg), **kwargs)
    return ServeFrontend(ContinuousBatcher(engine), host=args.host, port=args.port)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m autodist_tpu_torch.serve",
                                 description=__doc__)
    ap.add_argument("--model", default="transformer", help="zoo model name")
    ap.add_argument("--model-arg", action="append", metavar="K=V",
                    help="model config override (repeatable)")
    ap.add_argument("--slots", type=int, default=8, help="decode slot rows")
    ap.add_argument("--page-len", type=int, default=16,
                    help="KV-cache page length in tokens")
    ap.add_argument("--pages", type=int, default=None,
                    help="page-pool size (default: sized from the card's memory)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prefill chunk tokens (default: one page)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="serve from int8 KV pages with fp32 scales")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share prompt prefixes across requests (copy-on-write "
                         "pages)")
    ap.add_argument("--draft-model", default=None,
                    help="zoo model name of a speculative-decode draft (same "
                         "transformer family); enables the SpecDecodeEngine")
    ap.add_argument("--draft-arg", action="append", metavar="K=V",
                    help="draft model config override (repeatable)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per slot per round")
    ap.add_argument("--checkpoint", default=None,
                    help="Saver directory or ckpt-N path to restore")
    ap.add_argument("--draft-checkpoint", default=None,
                    help="Saver directory or ckpt-N path for the draft")
    ap.add_argument("--seed", type=int, default=0,
                    help="weight init seed (the draft's is seed + 1)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8476)
    for name in ("spec", "prefix", "sampling"):
        ap.add_argument(f"--selftest-{name}", action="store_true",
                        help=f"run the CPU proof of serve/{name}.py and exit")
    args = ap.parse_args(argv)

    if args.selftest_spec:
        from autodist_tpu_torch.serve.spec import selftest_spec

        return selftest_spec()
    if args.selftest_prefix:
        from autodist_tpu_torch.serve.prefix import selftest_prefix

        return selftest_prefix()
    if args.selftest_sampling:
        from autodist_tpu_torch.serve.sampling import selftest_sampling

        return selftest_sampling()

    frontend = build_frontend(args)
    # A supervisor stops the server with SIGTERM; route it through the
    # KeyboardInterrupt path so shutdown unwinds.
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    try:
        asyncio.run(frontend.serve_forever())
    except KeyboardInterrupt:
        pass
    finally:
        frontend.batcher.stop(drain=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
