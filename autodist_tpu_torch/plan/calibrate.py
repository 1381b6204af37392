"""Measurement calibration: fit the cost model's constants to this topology
(PyTorch port of the JAX package's ``plan/calibrate.py``).

The analytic :class:`~autodist_tpu_torch.strategy.cost_model.CostModel`
prices a strategy as ``comm + update + latency + act_sync (+ gather +
exposed overlap)`` seconds from nominal bandwidth and latency constants and
leaves out the strategy-invariant compute floor. A set of ``(predicted
components, measured seconds)`` records fits per-component coefficients

    measured_s ≈ base + a·comm_s + b·update_s + c·latency_s + d·act_sync_s
                 + e·gather_s + f·overlap_s

where ``base`` absorbs the compute floor and fixed overhead, ``a..f`` the
achieved fraction of each nominal peak (``gather_s`` is ZeRO-1's parameter
all-gather, ``overlap_s`` the bucketed wire the backward can hide, whose
fitted coefficient is the measured exposed fraction). The fit reports its
own error (mean |rel| error before and after) and is kept per topology, one
file per (device × GPU count × mesh shape) under the port's plan directory,
so a calibration measured on one cluster never prices another. The JAX
package's TPU calibrations are never read.

:class:`~autodist_tpu_torch.strategy.cost_model.Calibration` is the scalar
``base + scale·total`` fit ``AutoDist.tune`` records and ``explain``
shows; this is its per-component superset for the planner. Below
:data:`MIN_COMPONENT_POINTS` records, or with a degenerate component
matrix, the fit falls back to the scalar form.

Records carrying ``measured_components`` (per-component device seconds a
trace attributes, :func:`record_from_attribution`) pin those components'
coefficients directly (Σmeasured/Σpredicted); the regression fits only what
the trace cannot see.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy.cost_model import StrategyCost
from autodist_tpu_torch.utils import logging

COMPONENTS = ("comm_s", "update_s", "latency_s", "act_sync_s", "gather_s", "overlap_s")
# Below this many records the per-component least squares is
# underdetermined: the scalar base + scale fit instead.
MIN_COMPONENT_POINTS = len(COMPONENTS) + 2


def _default_coefficients() -> Dict[str, float]:
    """Uncalibrated coefficients: 1.0 for every component except
    ``overlap_s``, which starts at the cost model's exposure prior, so an
    unfitted calibration predicts exactly ``StrategyCost.total_s``."""
    from autodist_tpu_torch.strategy.cost_model import OVERLAP_EXPOSED_FRACTION

    coef = {c: 1.0 for c in COMPONENTS}
    coef["overlap_s"] = OVERLAP_EXPOSED_FRACTION
    return coef


def default_calibration_dir() -> str:
    from autodist_tpu_torch import const

    return const.DEFAULT_PLAN_DIR


def topology_key(resource_spec: ResourceSpec, device_kind: str = "") -> str:
    """Filesystem-safe identity of what a calibration was measured on: the
    device (the runtime's ``torch.cuda.get_device_name`` wins over the
    spec's ``gpu.device``), the GPU count and the logical mesh shape — not
    the whole spec fingerprint: addresses and SSH blocks do not change the
    bandwidth achieved. One H100 reads ``nvidia_h100_80gb_hbm3-c1-1``."""
    kind = device_kind or resource_spec.gpu.device or "unknown"
    mesh = resource_spec.mesh_shape(("data", "model"))
    shape = "x".join(f"{k}{v}" for k, v in sorted(mesh.items()) if v > 1) or "1"
    raw = f"{kind}-c{resource_spec.num_gpus}-{shape}"
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", raw).lower()


@dataclass
class CalibrationRecord:
    """One (predicted, measured) pair: a strategy that actually ran."""

    comm_s: float
    update_s: float
    latency_s: float
    act_sync_s: float
    measured_s: float
    name: str = ""
    gather_s: float = 0.0
    overlap_s: float = 0.0
    dispatch_gap_s: float = 0.0
    flops_per_step: float = 0.0
    bytes_per_step: float = 0.0
    # Trace-attributed measured seconds per component; the fit pins those
    # components' coefficients directly. Components a trace cannot
    # attribute are absent.
    measured_components: Dict[str, float] = field(default_factory=dict)

    @property
    def predicted_s(self) -> float:
        """``StrategyCost.total_s`` (with the overlap-exposure prior), so
        the uncalibrated error grades the number the search ranks by."""
        from autodist_tpu_torch.strategy.cost_model import OVERLAP_EXPOSED_FRACTION

        return (self.comm_s + self.update_s + self.latency_s + self.act_sync_s
                + self.gather_s + OVERLAP_EXPOSED_FRACTION * self.overlap_s)

    @classmethod
    def from_cost(cls, cost: StrategyCost, measured_s: float, name: str = "",
                  **extra) -> "CalibrationRecord":
        return cls(comm_s=cost.comm_s, update_s=cost.update_s, latency_s=cost.latency_s,
                   act_sync_s=cost.act_sync_s, gather_s=getattr(cost, "gather_s", 0.0),
                   overlap_s=getattr(cost, "overlap_s", 0.0),
                   measured_s=float(measured_s), name=name, **extra)

    def to_json(self) -> dict:
        return {
            "comm_s": self.comm_s, "update_s": self.update_s,
            "latency_s": self.latency_s, "act_sync_s": self.act_sync_s,
            "measured_s": self.measured_s,
            **({"gather_s": self.gather_s} if self.gather_s else {}),
            **({"overlap_s": self.overlap_s} if self.overlap_s else {}),
            **({"name": self.name} if self.name else {}),
            **({"dispatch_gap_s": self.dispatch_gap_s} if self.dispatch_gap_s else {}),
            **({"flops_per_step": self.flops_per_step} if self.flops_per_step else {}),
            **({"bytes_per_step": self.bytes_per_step} if self.bytes_per_step else {}),
            **({"measured_components": dict(self.measured_components)}
               if self.measured_components else {}),
        }

    @classmethod
    def from_json(cls, d: dict) -> "CalibrationRecord":
        return cls(
            comm_s=float(d["comm_s"]), update_s=float(d["update_s"]),
            latency_s=float(d["latency_s"]), act_sync_s=float(d["act_sync_s"]),
            measured_s=float(d["measured_s"]), name=str(d.get("name", "")),
            gather_s=float(d.get("gather_s", 0.0)),
            overlap_s=float(d.get("overlap_s", 0.0)),
            dispatch_gap_s=float(d.get("dispatch_gap_s", 0.0)),
            flops_per_step=float(d.get("flops_per_step", 0.0)),
            bytes_per_step=float(d.get("bytes_per_step", 0.0)),
            measured_components={str(k): float(v)
                                 for k, v in (d.get("measured_components") or {}).items()
                                 if k in COMPONENTS},
        )


def record_from_profiler(report: Dict, cost: StrategyCost, name: str = "") -> CalibrationRecord:
    """Pair a ``StepProfiler.report()`` with the analytic cost of the
    strategy it profiled. The measured time is the per-step wall
    (``step_wall_s``); the dispatch gap (per step) and the step's FLOPs and
    bytes ride along. The port's ``dispatch_gap_s`` is the host time for
    ``run()`` to return (an eager step enqueues kernel by kernel), not the
    JAX package's time to dispatch one compiled program."""
    steps = float(report.get("steps_per_window", 1.0)) or 1.0
    return CalibrationRecord.from_cost(
        cost, measured_s=float(report.get("step_wall_s", 0.0)), name=name,
        dispatch_gap_s=float(report.get("dispatch_gap_s", 0.0)) / steps,
        flops_per_step=float(report.get("flops_per_step", 0.0)),
        bytes_per_step=float(report.get("bytes_per_step", 0.0)),
    )


def record_from_attribution(report: Dict, cost: StrategyCost, measured_wire,
                            name: str = "") -> CalibrationRecord:
    """:func:`record_from_profiler` plus the per-component seconds a
    measured-wire attribution reports (``measured_wire`` is any object with
    ``calibration_components() -> {component: seconds}``; the trace join
    that makes one waits for ROADMAP.md Queue 1 item 7)."""
    rec = record_from_profiler(report, cost, name=name)
    rec.measured_components = {k: float(v)
                               for k, v in measured_wire.calibration_components().items()
                               if k in COMPONENTS}
    return rec


@dataclass
class TopologyCalibration:
    """Fitted per-component correction for one topology."""

    coefficients: Dict[str, float] = field(default_factory=_default_coefficients)
    base_s: float = 0.0
    device: str = ""
    topology: str = ""
    n_points: int = 0
    # Mean |measured - predicted| / measured, uncalibrated and calibrated.
    error_before: float = float("nan")
    error_after: float = float("nan")

    def predict_s(self, cost) -> float:
        """Calibrated seconds of anything with the component attributes (a
        ``StrategyCost`` or a :class:`CalibrationRecord`): one formula for
        the error grader and the search objective."""
        c = self.coefficients
        return self.base_s + sum(c.get(comp, 1.0) * getattr(cost, comp, 0.0)
                                 for comp in COMPONENTS)

    def describe(self) -> dict:
        return {
            "coefficients": dict(self.coefficients),
            "base_ms": self.base_s * 1e3,
            "device": self.device,
            "topology": self.topology,
            "n_points": self.n_points,
            "mean_abs_rel_err_before": self.error_before,
            "mean_abs_rel_err_after": self.error_after,
        }

    # ------------------------------------------------------------------- fit
    @classmethod
    def fit(cls, records: Sequence[CalibrationRecord], device: str = "",
            topology: str = "") -> "TopologyCalibration":
        recs = [r for r in records if np.isfinite(r.measured_s) and r.measured_s > 0]
        out = cls(device=device, topology=topology, n_points=len(recs))
        if not recs:
            return out
        out.error_before = prediction_error(recs, None)

        # Direct attribution first: Σmeasured / Σpredicted over the records
        # that carry a component's trace evidence (0.0 is legitimate: a
        # fully hidden overlap wire costs nothing).
        direct: Dict[str, float] = {}
        for comp in COMPONENTS:
            num = den = 0.0
            for r in recs:
                if comp in getattr(r, "measured_components", {}):
                    num += float(r.measured_components[comp])
                    den += float(getattr(r, comp))
            if den > 1e-12 and num >= 0:
                direct[comp] = num / den

        def residual(r) -> float:
            return r.measured_s - sum(direct[c] * getattr(r, c) for c in direct)

        fitted = False
        free = [c for c in COMPONENTS if c not in direct]
        if len(recs) >= MIN_COMPONENT_POINTS and free:
            A = np.array([[getattr(r, c) for c in free] + [1.0] for r in recs], np.float64)
            y = np.array([residual(r) for r in recs], np.float64)
            # Columns that never vary carry no signal: left out (their
            # coefficient keeps its default).
            active = [i for i in range(len(free)) if float(np.ptp(A[:, i])) > 1e-12]
            if active:
                cols = active + [len(free)]
                coef, *_ = np.linalg.lstsq(A[:, cols], y, rcond=None)
                comp_coef = _default_coefficients()
                comp_coef.update(direct)
                free_coef = {free[col]: float(coef[i]) for i, col in enumerate(active)}
                base = float(coef[-1])
                # A negative coefficient is the fit chasing noise (a
                # "speedup" from sending more bytes): rejected.
                if base >= 0 and all(v > 0 for v in free_coef.values()):
                    comp_coef.update(free_coef)
                    out.coefficients = comp_coef
                    out.base_s = base
                    fitted = True
        if not fitted and direct:
            # The attributed components pinned, the rest at their default,
            # base_s the mean residual: one attributed record calibrates.
            comp_coef = _default_coefficients()
            comp_coef.update(direct)
            rest = [residual(r) - sum(comp_coef[c] * getattr(r, c) for c in free)
                    for r in recs]
            out.coefficients = comp_coef
            out.base_s = max(float(np.mean(rest)), 0.0)
            fitted = True
        if not fitted:
            # Scalar fallback: measured ≈ base + scale × predicted_total.
            pred = np.array([r.predicted_s for r in recs], np.float64)
            meas = np.array([r.measured_s for r in recs], np.float64)
            if len(recs) == 1 or float(np.ptp(pred)) < 1e-12:
                scale, base = 1.0, float(np.mean(meas - pred))
            else:
                scale, base = np.polyfit(pred, meas, 1)
                if scale <= 0:
                    scale, base = 1.0, float(np.mean(meas - pred))
            # predicted_s already charges the overlap prior, so the overlap
            # coefficient carries scale × prior.
            out.coefficients = {c: float(scale) * v
                                for c, v in _default_coefficients().items()}
            out.base_s = max(float(base), 0.0)
        out.error_after = prediction_error(recs, out)
        return out

    # ---------------------------------------------------------- persistence
    def path_for(self, directory: Optional[str] = None) -> str:
        d = directory or default_calibration_dir()
        return os.path.join(d, f"calibration-{self.topology or 'default'}.json")

    def save(self, path: Optional[str] = None, records: Sequence[CalibrationRecord] = (),
             rejected_fits: Sequence[dict] = ()) -> str:
        """Write the fit (and its records) atomically. Rejected refits (the
        keep-best guard of :func:`calibrate_from_records`) ride the file,
        the history carried forward on every save, newest 32 kept."""
        path = path or self.path_for()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            with open(path, "r", encoding="utf-8") as f:
                prior_rejected = list(json.load(f).get("rejected_fits", []))
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            prior_rejected = []
        doc = {
            "coefficients": self.coefficients,
            "base_s": self.base_s,
            "device": self.device,
            "topology": self.topology,
            "n_points": self.n_points,
            "error_before": self.error_before,
            "error_after": self.error_after,
            "records": [r.to_json() for r in records],
            "rejected_fits": (prior_rejected + list(rejected_fits))[-32:],
        }
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=2, sort_keys=True, default=float)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> Optional["TopologyCalibration"]:
        """The calibration at ``path``, or None when it is missing; a torn
        or stale file is None too, with a warning."""
        if not os.path.exists(path):
            return None
        try:
            with open(path, "r", encoding="utf-8") as f:
                d = json.load(f)
            defaults = _default_coefficients()
            coef = {c: float(d["coefficients"].get(c, defaults[c])) for c in COMPONENTS}
            return cls(coefficients=coef, base_s=float(d.get("base_s", 0.0)),
                       device=str(d.get("device", "")), topology=str(d.get("topology", "")),
                       n_points=int(d.get("n_points", 0)),
                       error_before=float(d.get("error_before", float("nan"))),
                       error_after=float(d.get("error_after", float("nan"))))
        except (OSError, ValueError, KeyError, TypeError, AttributeError) as e:
            logging.warning("plan calibration unreadable at %s (%s); ignoring it", path, e)
            return None

    @classmethod
    def load_for(cls, resource_spec: ResourceSpec, device_kind: str = "",
                 directory: Optional[str] = None) -> Optional["TopologyCalibration"]:
        key = topology_key(resource_spec, device_kind)
        d = directory or default_calibration_dir()
        return cls.load(os.path.join(d, f"calibration-{key}.json"))


def load_records(path: str) -> List[CalibrationRecord]:
    """The records a calibration file keeps (refits extend them)."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
        return [CalibrationRecord.from_json(r) for r in d.get("records", [])]
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return []


def prediction_error(records: Sequence[CalibrationRecord],
                     calibration: Optional[TopologyCalibration]) -> float:
    """Mean |predicted - measured| / measured over the records; with
    ``calibration=None`` the analytic totals are graded (the "before"
    column). NaN when no record qualifies."""
    errs = []
    for r in records:
        if not (np.isfinite(r.measured_s) and r.measured_s > 0):
            continue
        pred = r.predicted_s if calibration is None else calibration.predict_s(r)
        errs.append(abs(pred - r.measured_s) / r.measured_s)
    return float(np.mean(errs)) if errs else float("nan")


#: The persisted records are capped, newest kept: the file stays small
#: across unbounded ``tune()`` calls and one over-tuned configuration
#: cannot drown the least squares.
MAX_PERSISTED_RECORDS = 512


def _merge_records(old: Sequence[CalibrationRecord],
                   new: Sequence[CalibrationRecord]) -> List[CalibrationRecord]:
    """old + new, exact duplicates collapsed (newest kept), capped to the
    newest :data:`MAX_PERSISTED_RECORDS`."""
    merged: Dict[tuple, CalibrationRecord] = {}
    for r in list(old) + list(new):
        sig = (r.name, r.comm_s, r.update_s, r.latency_s, r.act_sync_s, r.gather_s,
               r.overlap_s, r.measured_s, tuple(sorted(r.measured_components.items())))
        merged.pop(sig, None)  # re-insert: the newest occurrence is last
        merged[sig] = r
    return list(merged.values())[-MAX_PERSISTED_RECORDS:]


def calibrate_from_records(records: Sequence[CalibrationRecord],
                           resource_spec: ResourceSpec, device_kind: str = "",
                           directory: Optional[str] = None,
                           persist: bool = True) -> TopologyCalibration:
    """Fit and (optionally) persist the per-topology calibration, the new
    records merged with those the existing file holds.

    Refits keep the best: when the fresh fit predicts the merged records
    worse than the persisted coefficients do, those are kept and the
    rejected fit is recorded in the file's ``rejected_fits``; the merged
    records persist either way."""
    key = topology_key(resource_spec, device_kind)
    d = directory or default_calibration_dir()
    path = os.path.join(d, f"calibration-{key}.json")
    merged = _merge_records(load_records(path), records)
    calib = TopologyCalibration.fit(merged, device=device_kind, topology=key)
    rejected_fits: List[dict] = []
    prior = TopologyCalibration.load(path)
    if prior is not None:
        prior_err = prediction_error(merged, prior)
        if (np.isfinite(prior_err) and np.isfinite(calib.error_after)
                and calib.error_after > prior_err + 1e-12):
            rejected_fits.append({
                "coefficients": dict(calib.coefficients),
                "base_s": calib.base_s,
                "n_points": calib.n_points,
                "error_after": calib.error_after,
                "error_best": prior_err,
            })
            logging.warning(
                "plan calibration (%s): refit rejected — error %.4f over the merged "
                "records vs %.4f for the persisted fit; keeping the previous "
                "coefficients (keep-best)", key, calib.error_after, prior_err)
            calib = TopologyCalibration(
                coefficients=dict(prior.coefficients), base_s=prior.base_s,
                device=device_kind or prior.device, topology=key,
                n_points=len(merged), error_before=calib.error_before,
                error_after=prior_err)
    if persist:
        calib.save(path, records=merged, rejected_fits=rejected_fits)
        logging.info(
            "plan calibration (%s): %d points, mean |rel err| %.1f%% -> %.1f%% -> %s",
            key, calib.n_points,
            calib.error_before * 100 if np.isfinite(calib.error_before) else float("nan"),
            calib.error_after * 100 if np.isfinite(calib.error_after) else float("nan"),
            path)
    return calib
