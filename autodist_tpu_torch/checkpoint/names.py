"""Checkpoint names of the optimizer state: the port's slots under optax's
tree paths.

The JAX package's ``opt_state`` is an optax chain, so a checkpoint names
its leaves by the chain's tree paths (``opt_state/1/0/mu/<var>``). The
port's :class:`~autodist_tpu_torch.model_item.Optimizer` keeps ``{"count":
int, "mu": [...], ...}`` with one entry a floating parameter, in
``flatten_params`` order. :func:`optimizer_paths` is the map between the
two, for every optimizer kind with and without ``clip_norm``, written out
from optax's own chains (no optax is imported):

- ``clip_norm`` chains ``clip_by_global_norm`` (no leaves) in front:
  every path gains a leading ``1/``;
- sgd / momentum: ``trace`` (with momentum), ``scale_by_learning_rate``;
- adam: ``scale_by_adam`` (``count``, ``mu``, ``nu``), the learning rate;
  adamw: the same, ``add_decayed_weights``, the learning rate; lamb: those
  and ``scale_by_trust_ratio`` before the learning rate;
- adagrad: ``scale_by_rss`` (``sum_of_squares``), the learning rate;
- rmsprop: ``scale_by_rms`` (``nu``), or ``scale_by_stddev`` (``mu``,
  ``nu``) when centered, either with a ``count`` under bias correction;
  the learning rate, ``trace`` (with momentum);
- lion: ``scale_by_lion`` (``count``, ``mu``), the decay, the learning
  rate;
- adafactor: ``scale_by_factored_rms`` (``count``, ``v_row``, ``v_col``,
  ``v``; a leaf that is not factored keeps ``v`` and ``(1,)`` zeros in
  ``v_row``/``v_col``, a factored one the reverse), then the optional
  block-RMS clip, learning rate, parameter scale, ``ema`` (``count``,
  ``ema``: the port's ``trace``) and decay, then ``scale(-1)``.

A learning-rate schedule adds a ``count`` where the learning rate sits.
Every ``count`` of the chain counts the updates, as the port's single
``count`` does; a chain with none (constant-rate sgd, adagrad, rmsprop
without bias correction)
restores the port's ``count`` from the state's ``step``.
"""
from __future__ import annotations

from typing import Dict, List, Optional

#: The slot lists of the port's state whose leaves are shaped like their
#: parameter, by optimizer state key.
PARAM_SHAPED = ("mu", "nu", "trace")


def optimizer_paths(opt) -> Dict[str, object]:
    """``{"count": [paths], slot: path prefix}`` for ``opt`` (an
    :class:`~autodist_tpu_torch.model_item.Optimizer`): every path of a
    ``count`` scalar, and for each slot list of the port's state (``mu``,
    ``nu``, ``trace``, ``v``) the prefix its leaves take
    (``<prefix>/<var>``; adafactor's ``v`` stands for the three prefixes
    ``<prefix>/v_row``, ``/v_col`` and ``/v``)."""
    kind, hp = opt.kind, opt.hp
    schedule = getattr(opt, "schedule", False)
    c = "1/" if opt.clip_norm is not None else ""
    counts: List[str] = []
    out: Dict[str, object] = {}

    def lr_at(i: int) -> None:
        if schedule:
            counts.append(f"{c}{i}/count")

    if kind in ("sgd", "momentum"):
        if hp["momentum"] is not None:
            out["trace"] = f"{c}0/trace"
        lr_at(1)
    elif kind in ("adam", "adamw", "lamb"):
        counts.append(f"{c}0/count")
        out["mu"], out["nu"] = f"{c}0/mu", f"{c}0/nu"
        lr_at({"adam": 1, "adamw": 2, "lamb": 3}[kind])
    elif kind == "adagrad":
        out["nu"] = f"{c}0/sum_of_squares"
        lr_at(1)
    elif kind == "rmsprop":
        if hp["bias_correction"]:
            counts.append(f"{c}0/count")
        if hp["centered"]:
            out["mu"] = f"{c}0/mu"
        out["nu"] = f"{c}0/nu"
        lr_at(1)
        if hp["momentum"] is not None:
            out["trace"] = f"{c}2/trace"
    elif kind == "lion":
        counts.append(f"{c}0/count")
        out["mu"] = f"{c}0/mu"
        lr_at(2)
    elif kind == "adafactor":
        counts.append(f"{c}0/count")
        out["v"] = f"{c}0"
        i = 1
        if hp["clipping_threshold"] is not None:
            i += 1
        if opt.lr is not None:
            lr_at(i)
            i += 1
        if hp["multiply_by_parameter_scale"]:
            i += 1
        if hp["momentum"] is not None:
            counts.append(f"{c}{i}/count")
            out["trace"] = f"{c}{i}/ema"
    else:
        raise ValueError(f"no checkpoint names for optimizer kind {kind!r}")
    out["count"] = sorted(counts)
    return out


def factored_names(prefix: str) -> Dict[str, str]:
    """Adafactor's per-leaf dict keys (``row``, ``col``, ``v``) -> optax's
    ``FactoredState`` fields under ``prefix``."""
    return {"row": f"{prefix}/v_row", "col": f"{prefix}/v_col", "v": f"{prefix}/v"}


def opt_state_names(opt, var_names: List[str]) -> List[str]:
    """Every optimizer-state name of a checkpoint of ``opt`` over the
    floating variables ``var_names`` (unprefixed by ``opt_state/``), in
    optax's flatten order."""
    paths = optimizer_paths(opt)
    names = list(paths["count"])
    for key in PARAM_SHAPED:
        if key in paths:
            names += [f"{paths[key]}/{v}" for v in var_names]
    if "v" in paths:
        for field in factored_names(paths["v"]).values():
            names += [f"{field}/{v}" for v in var_names]
    return sorted(names)


def restored_count(paths: Dict[str, object], values: Dict[str, int],
                   step: Optional[int]) -> int:
    """The port's ``count`` from a checkpoint's ``count`` values (by path),
    or from its ``step`` where the chain has none. Counts that disagree
    raise: the state was not written by one optimizer."""
    found = {int(values[p]) for p in paths["count"]}
    if len(found) > 1:
        raise ValueError(f"optimizer counts disagree: {dict(values)}")
    if found:
        return found.pop()
    return int(step or 0)


__all__ = ["PARAM_SHAPED", "optimizer_paths", "factored_names", "opt_state_names",
           "restored_count"]
