"""CLI: ``python -m autodist_tpu_torch.serve`` — serve a zoo model over HTTP.

Server mode only (the JAX package's selftests are not ported). Weights come
from a seeded ``torch.Generator``; checkpoint restore is a later slice::

    python -m autodist_tpu_torch.serve --model transformer \\
        --model-arg num_layers=2 --slots 32 --port 8476 --device cuda
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
    from autodist_tpu_torch.models import get_model
    from autodist_tpu_torch.models.transformer import decode_model, init_params
    from autodist_tpu_torch.serve.batcher import ContinuousBatcher
    from autodist_tpu_torch.serve.engine import InferenceEngine
    from autodist_tpu_torch.serve.server import ServeFrontend

    overrides = _parse_overrides(args.model_arg)
    if args.kv_quant:
        overrides["kv_quant"] = True
    cfg = get_model(args.model, **overrides)
    params = init_params(cfg, seed=args.seed, device=args.device)
    engine = InferenceEngine(
        params, decode_model(cfg), n_slots=args.slots, page_len=args.page_len,
        n_pages=args.pages, prefill_chunk=args.prefill_chunk, device=args.device)
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
    ap.add_argument("--seed", type=int, default=0, help="weight init seed")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8476)
    args = ap.parse_args(argv)

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
