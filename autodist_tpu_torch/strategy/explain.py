"""Explain strategy selection for a model on a cluster (PyTorch port of
``strategy/explain.py``).

Prints what :class:`~autodist_tpu_torch.strategy.cost_model.CostModel`
predicts for every builder on a (model x cluster) pair: the step's sync,
update, latency and activation time, memory a GPU against its HBM, and
whether it fits, so the choice can be read before any card time is spent::

    python -m autodist_tpu_torch.strategy.explain --model bert_base
    python -m autodist_tpu_torch.strategy.explain --model lstm_lm \\
        --resource-spec spec.yml --batch-size 256 --device cpu

Without ``--resource-spec`` it plans for this host's card
(``ResourceSpec.from_local_devices``), and raises without one unless
``--device cpu`` is given. ``--model-kwargs`` passes zoo overrides as
``k=v`` pairs. The JAX package's ``--lint``, ``--wire-measured`` and
``--plan-provenance`` read ``analysis/``, ``obs/attrib`` and ``plan/``,
which are not ported yet (ROADMAP.md Queue 1 item 11): they raise
``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional, Tuple

from autodist_tpu_torch.model_item import ModelItem, OptimizerSpec
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.cost_model import Calibration, CostModel, candidate_slate

_UNPORTED = ("{} reads the JAX package's {}, which is not ported yet; see ROADMAP.md "
             "Queue 1 item 11")


def _coerce(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


def _lossy(strategy) -> bool:
    """True when any synchronizer of ``strategy`` (node or shard level)
    carries an active gradient compressor."""
    from autodist_tpu_torch.kernel.compressor import is_active_compressor
    from autodist_tpu_torch.strategy.ir import iter_synchronizers

    return any(is_active_compressor(getattr(s, "compressor", "") or "")
               for n in strategy.node_config for s in iter_synchronizers(n))


def explain(model_item: ModelItem, resource_spec: ResourceSpec,
            candidates: Optional[List[Tuple[str, object]]] = None, out=None,
            measured: Optional[dict] = None, calibration=None,
            cost_model: Optional[CostModel] = None) -> List[Tuple[str, object]]:
    """Rank candidate builders (default: the full slate) for (model x
    cluster) and print the table and a ``recommended:`` line.

    ``measured`` maps candidate names to measured seconds a step (a
    ``tune()`` table or a saved sweep): an extra column. ``calibration`` is
    a :class:`Calibration` (``"auto"``: the one ``tune()`` last wrote in
    the port's working directory): a calibrated step-time column.
    ``cost_model`` prices with other constants (default: the spec's).

    Returns the raw ranking ``[(name, StrategyCost), ...]``, which may put
    a compressed (lossy) wire first; the printed recommendation takes the
    fastest lossless candidate then, as the JAX package's does."""
    out = out if out is not None else sys.stdout
    if calibration == "auto":
        calibration = Calibration.load()
    cm = cost_model or CostModel(model_item, resource_spec)
    built = []
    for name, builder in candidates or candidate_slate(full=True):
        try:
            built.append((name, builder.build(model_item, resource_spec)))
        except Exception as e:  # noqa: BLE001 - keep explaining the rest
            print(f"{name:22s} failed to build: {e}", file=out)
    ranked = cm.rank(built)
    total_bytes = sum(v.byte_size for v in model_item.variables)
    print(f"\n{resource_spec!r}\n"
          f"model: {len(model_item.variables)} vars, "
          f"{len(model_item.sparse_variables)} sparse, {total_bytes / 1e6:.1f} MB params, "
          f"optimizer={model_item.optimizer_spec.name}\n", file=out)
    if calibration is not None:
        print(f"calibration: measured ≈ {calibration.base_s * 1e3:.3f}ms + "
              f"{calibration.scale:.2f} × predicted ({calibration.n_points} candidates on "
              f"{calibration.device or 'unknown device'})\n", file=out)
    header = (f"{'strategy':22s} {'total':>10s} {'comm':>10s} {'update':>9s} "
              f"{'latency':>9s} {'act':>9s} {'gather':>9s} {'mem/chip':>10s} "
              f"{'opt/chip':>10s} {'fits':>5s}"
              + (f" {'calib':>10s}" if calibration is not None else "")
              + (f" {'measured':>10s}" if measured else ""))
    print(header, file=out)
    print("-" * len(header), file=out)
    for name, cost in ranked:
        row = (f"{name:22s} {cost.total_s * 1e3:8.3f}ms {cost.comm_s * 1e3:8.3f}ms "
               f"{cost.update_s * 1e3:7.3f}ms {cost.latency_s * 1e3:7.3f}ms "
               f"{cost.act_sync_s * 1e3:7.3f}ms {cost.gather_s * 1e3:7.3f}ms "
               f"{cost.per_chip_bytes / 1e9:8.2f}GB {cost.opt_bytes / 1e9:8.2f}GB "
               f"{'yes' if cost.feasible else 'NO':>5s}")
        if calibration is not None:
            row += f" {calibration.predict_s(cost) * 1e3:8.3f}ms"
        if measured:
            m = measured.get(name)
            row += f" {m * 1e3:8.3f}ms" if m is not None else f" {'—':>10s}"
        print(row, file=out)
    if ranked and not ranked[0][1].feasible:
        print(f"\nWARNING: no candidate fits per-chip HBM "
              f"({ranked[0][1].hbm_bytes / 1e9:.2f} GB usable) — showing the "
              f"least-over-budget candidate; expect OOM without a bigger "
              f"chip, more shards, or host offload.", file=out)
    best = ranked[0][0] if ranked else "(none)"
    lossy_names = {name for name, s in built if _lossy(s)}
    if best in lossy_names:
        lossless = next((n for n, _ in ranked if n not in lossy_names), None)
        if lossless is not None:
            print(f"\nrecommended: {lossless} (fastest priced: {best}, but its "
                  f"compressed wire changes numerics — opt in explicitly via its "
                  f"compressor knob)", file=out)
        else:
            print(f"\nrecommended: {best} — NOTE: every ranked candidate carries a "
                  f"compressed (lossy) wire; there is no lossless default here, so "
                  f"treat this as an explicit opt-in", file=out)
        return ranked
    print(f"\nrecommended: {best}", file=out)
    return ranked


def explain_provenance(provenance: dict, out=None) -> None:
    """The JAX package's plan-search provenance record: not ported."""
    raise NotImplementedError(_UNPORTED.format("explain_provenance", "plan/ search"))


def lint(*args, **kwargs) -> int:
    """The JAX package's static sharding analyzer: not ported."""
    raise NotImplementedError(_UNPORTED.format("lint", "analysis/ (shardlint)"))


def wire_measured(*args, **kwargs) -> int:
    """The JAX package's planned / priced / measured wire table: not
    ported."""
    raise NotImplementedError(_UNPORTED.format("wire_measured", "obs/attrib"))


def model_item_for(model: str, batch_size: int, device, optimizer: str = "sgd",
                   **overrides) -> ModelItem:
    """The :class:`ModelItem` of a zoo model at ``batch_size``, its loss
    traced (sparse names and expert names as the zoo marks them), params
    made on ``device``."""
    from autodist_tpu_torch.models import get_model_spec

    spec = get_model_spec(model, **overrides)
    params = spec.init(0, device=device)
    batch = spec.example_batch(batch_size, device=device)
    return ModelItem.from_params(params, optimizer_spec=OptimizerSpec(optimizer),
                                 loss_fn=spec.loss_fn, example_batch=batch,
                                 sparse_names=spec.sparse_names,
                                 expert_names=tuple(spec.expert_names or ()))


def main(argv=None, out=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m autodist_tpu_torch.strategy.explain",
        description="Rank strategy builders for a model on a cluster (cost model).")
    p.add_argument("--model", help="zoo model name (e.g. bert_base, resnet, lstm_lm)")
    p.add_argument("--model-kwargs", default="", help='comma "k=v" factory overrides')
    p.add_argument("--resource-spec", default="",
                   help="cluster yml (default: this host's card, or the CPU with "
                        "--device cpu)")
    p.add_argument("--batch-size", type=int, default=32, help="planning batch size")
    p.add_argument("--optimizer", default="sgd", help="optimizer name the model is priced "
                   "with (its slots)")
    p.add_argument("--device", default="cuda",
                   help="where the model's params are made for the trace, and the "
                        "device the default cluster describes (cuda, or cpu)")
    p.add_argument("--measured-file", default="",
                   help='JSON {"name": seconds_per_step} (or tune()\'s table); adds a '
                        'measured column')
    p.add_argument("--calibration", default="",
                   help='a tune()-written calibration.json, or "auto" for the port\'s '
                        'working directory; adds a calibrated column')
    p.add_argument("--plan-provenance", default="",
                   help="not ported: needs plan/ (ROADMAP.md Queue 1 item 11)")
    p.add_argument("--lint", action="store_true",
                   help="not ported: needs analysis/ (ROADMAP.md Queue 1 item 11)")
    p.add_argument("--builder", default="AllReduce", help="--lint/--wire-measured's builder")
    p.add_argument("--wire-measured", default="",
                   help="not ported: needs obs/attrib (ROADMAP.md Queue 1 item 11)")
    args = p.parse_args(argv)

    if args.plan_provenance:
        explain_provenance({})
    if not args.model:
        p.error("--model is required")
    kwargs = {}
    if args.model_kwargs:
        for pair in args.model_kwargs.split(","):
            k, v = pair.split("=", 1)
            kwargs[k.strip()] = _coerce(v.strip())
    if args.resource_spec:
        rs = ResourceSpec(args.resource_spec)
    else:
        rs = ResourceSpec.from_local_devices(args.device)
    if args.lint:
        return lint()
    if args.wire_measured:
        return wire_measured()
    item = model_item_for(args.model, args.batch_size, args.device, args.optimizer,
                          **kwargs)
    measured = None
    if args.measured_file:
        with open(args.measured_file, "r", encoding="utf-8") as f:
            raw = json.load(f)
        measured = {k: (v["measured_s"] if isinstance(v, dict) else float(v))
                    for k, v in raw.items()}
    calibration = None
    if args.calibration == "auto":
        calibration = "auto"
    elif args.calibration:
        calibration = Calibration.load(args.calibration)
        if calibration is None:
            raise FileNotFoundError(f"--calibration file {args.calibration!r} is missing "
                                    f"or unreadable")
    explain(item, rs, measured=measured, calibration=calibration, out=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
