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
stochastic stream (``serve/sampling.py``). The proofs, each printing one
JSON line and exiting non-zero on a failed bar: ``--selftest`` (the
single-engine serving proof of ``serve/server.py::selftest`` on
``--device``: >=2x the concurrency of the bucketed baseline at equal KV
memory, bit-identical paged/bucketed and kernel/gather greedy streams,
zero dropped among ``--requests`` concurrent requests of ``--max-new``
tokens on ``--slots`` rows (default 32), batched above sequential, two
serving programs; with ``--kv-quant`` the int8-pages proof instead),
``--selftest-spec``,
``--selftest-prefix``, ``--selftest-sampling``, and ``--selftest-router``
(3 in-process replicas behind the ``serve/router.py`` router, one killed
mid-decode under ``--requests`` concurrent requests of ``--max-new``
tokens on ``--slots`` rows each, every stream bit-identical to an
uninterrupted control run, exactly once; on ``--device``)::

    python -m autodist_tpu_torch.serve --selftest [--kv-quant] --device cpu
    python -m autodist_tpu_torch.serve --selftest-router --device cpu

Every server measures its own SLO position (``GET /slo``, an
``obs.slo.SLOTracker`` with the default spec). With ``--ft-dir DIR`` the
process runs as a supervised :class:`~autodist_tpu_torch.serve.replica.
Replica`: the HTTP listener binds at once and the engine builds on a
thread, so ``/healthz`` answers 503 (``starting``) until the replica is
``READY``; readiness and load beat through the ``FileTransport`` under
``DIR/heartbeats``; ``POST /drain`` persists the undone work to
``DIR/serve_queue-<replica-id>.json`` (the ft journal, format v2), and a
server started again on the same ``DIR`` replays that journal once,
consumes it and appends each replayed request's outcome to
``DIR/serve_replayed-<replica-id>.jsonl``::

    python -m autodist_tpu_torch.serve --device cuda --slots 32 \
        --ft-dir DIR --replica-id 0 [--trace-out T]

``--trace-out T`` flushes this process's span part-file into ``T`` at exit
(``obs/spans.py``). SIGTERM closes the listener (cancelling the connections
still open) and exits 0, as the JAX package's server does: it does not
drain (``POST /drain`` does). ``AUTODIST_FLIGHT_DIR`` turns on the flight
recorder.
"""
from __future__ import annotations

import argparse
import os
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


def build_engine(args):
    """The engine of parsed CLI args: seeded params (or a checkpoint's)
    through ``AutoDist.build_inference``, warmed up by one short request."""
    import numpy as np

    from autodist_tpu_torch.api import AutoDist
    from autodist_tpu_torch.models import get_model
    from autodist_tpu_torch.models.transformer import decode_model, init_params

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
    # The first forward of a fresh process loads the CUDA modules its
    # kernels use (5.4-8.8 s for the full-width transformer on an H100,
    # tools/torch_serve_coldstart.py): pay that here, before the server
    # answers READY, and not in the first requests' TTFT.
    engine.generate(np.arange(1, 4, dtype=np.int32), 2, request_id="warm-up")
    return engine


def build_frontend(args):
    """Engine + batcher (under a replica with ``--ft-dir``) + front end
    from parsed CLI args, with an SLO tracker."""
    from autodist_tpu_torch.obs.slo import SLOTracker
    from autodist_tpu_torch.serve.batcher import ContinuousBatcher
    from autodist_tpu_torch.serve.server import ServeFrontend
    from autodist_tpu_torch.utils.device import resolve_device

    slo = SLOTracker()
    if not getattr(args, "ft_dir", None):
        return ServeFrontend(ContinuousBatcher(build_engine(args), slo=slo),
                             host=args.host, port=args.port)
    from autodist_tpu_torch.ft.heartbeat import FileTransport
    from autodist_tpu_torch.serve.replica import Replica

    resolve_device(args.device)     # no card: raise here, not on the build thread
    rid = args.replica_id
    replica = Replica(
        rid, lambda: build_engine(args),
        FileTransport(os.path.join(args.ft_dir, "heartbeats")),
        persist_path=os.path.join(args.ft_dir, f"serve_queue-{rid}.json"),
        slo=slo, replayed_path=os.path.join(args.ft_dir, f"serve_replayed-{rid}.jsonl"))
    return ServeFrontend(None, host=args.host, port=args.port, replica=replica)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m autodist_tpu_torch.serve",
                                 description=__doc__)
    ap.add_argument("--model", default="transformer", help="zoo model name")
    ap.add_argument("--model-arg", action="append", metavar="K=V",
                    help="model config override (repeatable)")
    ap.add_argument("--slots", type=int, default=None,
                    help="decode slot rows (default: 32 for --selftest, 8 otherwise; "
                         "a replica's with --selftest-router)")
    ap.add_argument("--page-len", type=int, default=16,
                    help="KV-cache page length in tokens")
    ap.add_argument("--pages", type=int, default=None,
                    help="page-pool size (default: sized from the card's memory)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prefill chunk tokens (default: one page)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="serve from int8 KV pages with fp32 scales; with "
                         "--selftest, prove the int8 bars instead (>=2x admitted "
                         "concurrency at equal pool bytes vs fp pages, zero "
                         "dropped, logit drift within the bound, kernel-vs-gather "
                         "bit-identity, the memory pass pricing int8 bytes)")
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
    ap.add_argument("--ft-dir", default=None,
                    help="run as a supervised replica: readiness through the ft "
                         "FileTransport under DIR/heartbeats, POST /drain "
                         "persists to DIR/serve_queue-<id>.json, replayed at "
                         "the next start")
    ap.add_argument("--replica-id", type=int, default=0,
                    help="this replica's id on the ft transport (with --ft-dir)")
    ap.add_argument("--trace-out", default=None,
                    help="flush this process's span part-file into DIR at exit")
    ap.add_argument("--selftest", action="store_true",
                    help="run the single-engine serving proof on --device and exit")
    for name in ("spec", "prefix", "sampling", "router"):
        ap.add_argument(f"--selftest-{name}", action="store_true",
                        help=f"run the CPU proof of serve/{name}.py and exit")
    ap.add_argument("--requests", type=int, default=64,
                    help="--selftest, --selftest-router: concurrent mock requests "
                         "(>=64 proves the acceptance bar)")
    ap.add_argument("--max-new", type=int, default=12,
                    help="--selftest, --selftest-router: tokens generated per request")
    args = ap.parse_args(argv)

    if args.selftest:
        from autodist_tpu_torch.serve.server import selftest

        return selftest(n_requests=args.requests, n_slots=args.slots or 32,
                        max_new=args.max_new, kv_quant=args.kv_quant, device=args.device)
    if args.slots is None:
        args.slots = 8

    if args.selftest_spec:
        from autodist_tpu_torch.serve.spec import selftest_spec

        return selftest_spec()
    if args.selftest_prefix:
        from autodist_tpu_torch.serve.prefix import selftest_prefix

        return selftest_prefix()
    if args.selftest_sampling:
        from autodist_tpu_torch.serve.sampling import selftest_sampling

        return selftest_sampling()
    if args.selftest_router:
        from autodist_tpu_torch.serve.router import selftest_router

        return selftest_router(n_requests=args.requests, max_new=args.max_new,
                               n_slots=args.slots, device=args.device)

    if args.ft_dir and "AUTODIST_PROCESS_ID" not in os.environ:
        # Part-files and flight records identify as this replica unless a
        # launcher already pinned a process id.
        os.environ["AUTODIST_PROCESS_ID"] = str(args.replica_id)
    if args.trace_out:
        from autodist_tpu_torch.obs import spans as obs_spans

        obs_spans.enable_trace_out(args.trace_out)
    from autodist_tpu_torch.serve.server import serve_until_signal

    frontend = build_frontend(args)
    # A supervisor stops the server with SIGTERM: the event loop takes it
    # and closes the listener, and the process exits 0 (the --trace-out
    # part-file is flushed at exit).
    try:
        serve_until_signal(frontend)
    except KeyboardInterrupt:
        pass
    finally:
        batcher = frontend.batcher
        if batcher is not None:
            batcher.stop(drain=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
