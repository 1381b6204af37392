"""Step profiler: dispatch gap, device time and wall per window, live MFU,
roofline position (PyTorch port of ``obs/profiler.py``).

:class:`StepProfiler` wraps a
:class:`~autodist_tpu_torch.kernel.DistributedTrainStep` (or any object
with the same ``run(state, batch, num_steps)`` contract) and times each
windowed run with one barrier at its end, a read of the last loss. Per
window:

- ``dispatch_gap_s``: the host time for ``run()`` to return (the eager
  step enqueues kernel by kernel, and may wait on a full launch queue);
- ``wall_s``: ``run()`` to the barrier, the whole window;
- ``device_s``: on the card, the time between two CUDA events recorded on
  the step's stream just before and just after the window (the window's
  device span); on the CPU the host is the device, so ``device_s`` is
  ``wall_s``. The JAX package's profiler takes ``wall_s - dispatch_gap_s``
  instead, which holds for one asynchronous dispatch of a compiled
  program but not for an eager step.

FLOPs and bytes come from the step's own count of one step
(``DistributedTrainStep.window_cost``: its aten ops walked on meta tensors,
the kernels counted as their plain versions, ``utils/roofline.py``), so the
MFU is ``flops_per_step / (device_s_per_step × peak)`` with the card's bf16
dense peak (:func:`detect_peak_flops`). The same roofline bound, with the
memory's rate (``resource_spec.HBM_BY_DEVICE`` by default on the card),
gives ``exposed_comm_fraction``: device time beyond the compute/memory
bound, wire and scheduling time not hidden under compute (an upper bound:
any other overhead inflates it). Compile counts come from the step's
``compile_log`` (each program's first call), the memory high-water mark
from ``torch.cuda.max_memory_allocated`` (None on the CPU). Each window
feeds the ``obs_*`` gauges of ``registry``, one ``profiler.window`` span,
one flight record (``obs/recorder.py``) and the sentry (``obs/sentry.py``).

:class:`StepTimer` is the JAX package's wall-clock step timer.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.obs import recorder as _flight
from autodist_tpu_torch.obs import spans as _spans
from autodist_tpu_torch.utils import logging

__all__ = ["StepProfiler", "StepTimer", "detect_peak_flops"]

#: Peak bf16 dense FLOP/s by substring of ``torch.cuda.get_device_name``
#: (NVIDIA's datasheets: H100 SXM 989.4 TFLOP/s, PCIe 756, NVL 835),
#: matched longest key first.
_PEAK_FLOPS = {
    "H100 80GB HBM3": 989e12,
    "H100 SXM": 989e12,
    "H100 PCIe": 756e12,
    "H100 NVL": 835e12,
}


def detect_peak_flops(device=None) -> Optional[float]:
    """The bf16 dense peak of a recognised card, from a ``torch.device``
    (a CUDA one is asked its name) or a device name; None for the CPU or an
    unlisted card: an MFU against a guessed peak misleads."""
    name = device
    if isinstance(device, (torch.device, int)) or device is None:
        dev = torch.device("cuda", device) if isinstance(device, int) else device
        if dev is None or dev.type != "cuda" or not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(dev)
    name = str(name).lower()
    for key in sorted(_PEAK_FLOPS, key=len, reverse=True):
        if key.lower() in name:
            return _PEAK_FLOPS[key]
    return None


def _hbm_bandwidth(device) -> Optional[float]:
    """The card's memory rate in bytes/s from ``resource_spec``'s table;
    None for the CPU."""
    if device is None or device.type != "cuda":
        return None
    from autodist_tpu_torch.resource_spec import hbm_spec_for_name

    return hbm_spec_for_name(torch.cuda.get_device_name(device))[1] * 1e9


def _hbm_high_water(device) -> Optional[int]:
    """``torch.cuda.max_memory_allocated`` of the step's card; None on the
    CPU."""
    if device is None or device.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(device))


def _step_device(step) -> Optional[torch.device]:
    plan = getattr(step, "plan", None)
    return plan.device if plan is not None else None


def _world_size() -> int:
    dist = torch.distributed
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class StepProfiler:
    """Profile windowed train-step execution.

    Usage::

        prof = obs.StepProfiler(step)
        for _ in range(n_windows):
            state, metrics = prof.run(state, batch, window)
        print(json.dumps(prof.report()))

    Each profiled window adds two CUDA events on the card, one host timing
    pair and one span; the step is untouched. ``registry`` receives the
    ``obs_*`` gauges on every window.
    """

    def __init__(self, step, registry: Optional[M.MetricsRegistry] = None,
                 tracer: Optional[_spans.SpanTracer] = None,
                 peak_flops_per_chip: Optional[float] = None,
                 hbm_bw_bytes_per_s: Optional[float] = None,
                 recorder=None, sentry=None):
        self.step = step
        self.tracer = tracer or _spans.get_tracer()
        # The flight recorder's feed: every profiled window appends one step
        # record and the sentry watches the same stream (by default the
        # process recorder, and a sentry over it wherever it exists).
        self.recorder = _flight.get_recorder() if recorder is None else recorder
        if sentry is None and self.recorder is not None:
            from autodist_tpu_torch.obs.sentry import Sentry

            sentry = Sentry(registry=registry, recorder=self.recorder)
        self.sentry = sentry
        # The plan's promised collective payload a step, stamped on every
        # flight record (None for a step without a plan).
        self._collective_bytes: Optional[float] = None
        try:
            wire = self.step.plan.promised_wire()
            self._collective_bytes = float(sum(w.storage_bytes for w in wire.values()))
        except Exception:  # noqa: BLE001 - telemetry only
            pass
        self.device = _step_device(step)
        self._n_devices = _world_size()
        self.peak_flops_per_chip = (peak_flops_per_chip if peak_flops_per_chip is not None
                                    else detect_peak_flops(self.device))
        self.hbm_bw_bytes_per_s = (hbm_bw_bytes_per_s if hbm_bw_bytes_per_s is not None
                                   else _hbm_bandwidth(self.device))
        self.windows: List[Dict[str, float]] = []
        self._steps_total = 0
        self._cost: Optional[Dict[str, float]] = None

        reg = registry or M.registry
        self._h_wall = reg.histogram("obs_step_wall_s")
        self._g_dispatch = reg.gauge("obs_dispatch_gap_s")
        self._g_device = reg.gauge("obs_device_compute_s")
        self._g_mfu = reg.gauge("obs_mfu")
        self._g_flops = reg.gauge("obs_flops_per_step")
        self._g_hbm = reg.gauge("obs_hbm_high_water_bytes")
        self._g_compiles = reg.gauge("obs_programs_compiled")
        self._g_exposed = reg.gauge("obs_exposed_comm_fraction")
        self._c_windows = reg.counter("obs_profiled_windows_total")

    # ------------------------------------------------------------------ run
    def run(self, state, batch, num_steps: int, stacked: bool = False):
        """``step.run`` with the window profiled; returns its result."""
        cuda = self.device is not None and self.device.type == "cuda"
        t_wall = time.time()
        t0 = time.perf_counter()
        if cuda:
            stream = torch.cuda.current_stream(self.device)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record(stream)
        state, metrics = self.step.run(state, batch, num_steps, stacked=stacked)
        if cuda:
            end.record(stream)
        dispatch = time.perf_counter() - t0
        # One barrier a window: a read of the last loss.
        loss = metrics.get("loss") if isinstance(metrics, dict) else None
        loss_val = None
        if loss is not None:
            loss_val = float(_last(loss))
        elif cuda:
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        device_s = start.elapsed_time(end) / 1e3 if cuda else wall
        # Norms (a step built with record_norms=True) ride the same metrics.
        norms = {}
        if isinstance(metrics, dict):
            for key in ("grad_norm", "update_norm"):
                if key in metrics:
                    norms[key] = float(_last(metrics[key]))
        self._record(num_steps, stacked, dispatch, wall, device_s, t_wall, state, batch,
                     loss_val, norms)
        return state, metrics

    def _record(self, num_steps, stacked, dispatch, wall, device_s, t_wall, state, batch,
                loss_val=None, norms=None) -> None:
        cost = self._step_cost(state, batch, num_steps, stacked)
        flops_step = cost.get("flops", 0.0)
        self.windows.append({"steps": float(num_steps), "dispatch_gap_s": dispatch,
                             "wall_s": wall, "device_s": device_s})
        self._c_windows.inc()
        self._h_wall.observe(wall)
        self._g_dispatch.set(dispatch)
        self._g_device.set(device_s)
        self._g_compiles.set(len(getattr(self.step, "compile_log", ())))
        if flops_step:
            self._g_flops.set(flops_step)
            mfu = self._mfu(flops_step, device_s / max(num_steps, 1))
            if mfu is not None:
                self._g_mfu.set(mfu)
        hbm = _hbm_high_water(self.device)
        if hbm is not None:
            self._g_hbm.set(hbm)
        self.tracer.add_span("profiler.window", t_wall, wall, steps=num_steps,
                             dispatch_gap_ms=round(dispatch * 1e3, 3),
                             device_ms=round(device_s * 1e3, 3), flops_per_step=flops_step)
        n = max(int(num_steps), 1)
        self._steps_total += n
        exposed = self._window_exposed_fraction(device_s / n, cost)
        if self.recorder is not None:
            rec = {"step": self._steps_total, "steps": int(num_steps),
                   "step_wall_s": wall / n, "dispatch_gap_s": dispatch,
                   "device_s": device_s}
            if loss_val is not None:
                rec["loss"] = loss_val
            if norms:
                rec.update(norms)
            if hbm is not None:
                rec["hbm_high_water"] = hbm
            if exposed is not None:
                rec["exposed_comm_fraction"] = exposed
            if flops_step:
                rec["flops_per_step"] = flops_step
            if self._collective_bytes:
                rec["collective_bytes_planned"] = self._collective_bytes
            self.recorder.record_step(**rec)
        if self.sentry is not None:
            norms = norms or {}
            self.sentry.observe_step(step=self._steps_total, loss=loss_val,
                                     step_time_s=wall / n, hbm_bytes=hbm,
                                     grad_norm=norms.get("grad_norm"),
                                     update_norm=norms.get("update_norm"))

    def _bounds(self, cost) -> Optional[Dict[str, float]]:
        """The roofline times of one step's cost; None until a cost, a peak
        and a bandwidth are all known."""
        if not cost or not self.hbm_bw_bytes_per_s or not self.peak_flops_per_chip:
            return None
        from autodist_tpu_torch.utils import roofline

        nbytes = cost.get("bytes_accessed", 0.0)
        bounds = {"flops": cost.get("flops", 0.0), "lower_bytes": nbytes,
                  "upper_bytes": nbytes}
        return roofline.roofline_times(bounds, self.peak_flops_per_chip,
                                       self.hbm_bw_bytes_per_s)

    def _window_exposed_fraction(self, step_device_s: float, cost) -> Optional[float]:
        """A window's exposed-communication fraction (the formula of
        :meth:`report`)."""
        times = self._bounds(cost)
        if times is None or step_device_s <= 0 or not times["t_roofline_s"]:
            return None
        return max(step_device_s - times["t_roofline_s"], 0.0) / step_device_s

    def _step_cost(self, state, batch, num_steps: int, stacked: bool) -> Dict[str, float]:
        """One step's cost, ``step.window_cost(state, batch, num_steps,
        stacked)``: counted once, on the first window, after its barrier
        (outside the timed span), from shapes only. A step without
        ``window_cost``, or one whose count fails, gives ``{}`` (logged):
        the profiler never fails training, and the FLOP and MFU fields stay
        unset."""
        if self._cost is None:
            wc = getattr(self.step, "window_cost", None)
            self._cost = {}
            if wc is not None:
                try:
                    self._cost = wc(state, batch, num_steps, stacked=stacked)
                except Exception as e:  # noqa: BLE001 - never fail training
                    logging.warning("window_cost unavailable: %s", e)
        return self._cost

    # --------------------------------------------------------------- report
    def _mfu(self, flops_per_step: float, device_s_per_step: float) -> Optional[float]:
        """Measured MFU. ``flops_per_step`` is this rank's (one device's),
        so the denominator is one card's peak."""
        if not flops_per_step or not device_s_per_step or self.peak_flops_per_chip is None:
            return None
        return flops_per_step / (device_s_per_step * self.peak_flops_per_chip)

    def report(self) -> Dict[str, Any]:
        """The median window split, per-step FLOPs, MFU, the roofline
        position (with a peak and a bandwidth), the compile log and the
        memory high-water mark."""
        out: Dict[str, Any] = {"windows": len(self.windows), "n_devices": self._n_devices}
        if not self.windows:
            return out
        med = lambda k: float(np.median([w[k] for w in self.windows]))  # noqa: E731
        steps = self.windows[-1]["steps"] or 1.0
        cost = self._cost or {}
        out.update({
            "steps_per_window": steps,
            "dispatch_gap_s": med("dispatch_gap_s"),
            "wall_s": med("wall_s"),
            "device_s": med("device_s"),
            "step_wall_s": med("wall_s") / steps,
            "step_device_s": med("device_s") / steps,
            "flops_per_step": cost.get("flops", 0.0),
            "bytes_per_step": cost.get("bytes_accessed", 0.0),
        })
        if out["flops_per_step"]:
            self._g_flops.set(out["flops_per_step"])
        mfu = self._mfu(out["flops_per_step"], out["step_device_s"])
        if mfu is not None:
            out["mfu"] = mfu
            self._g_mfu.set(mfu)
        times = self._bounds(cost)
        if times is not None:
            out["roofline"] = {
                **times,
                # > 1: the measured step above the hardware bound; ~1: at it.
                "vs_roofline": (out["step_device_s"] / times["t_roofline_s"]
                                if times["t_roofline_s"] else float("nan")),
            }
            if out["step_device_s"] > 0:
                exposed = max(out["step_device_s"] - times["t_roofline_s"], 0.0)
                out["exposed_comm_s_per_step"] = exposed
                out["exposed_comm_fraction"] = exposed / out["step_device_s"]
                self._g_exposed.set(out["exposed_comm_fraction"])
        compile_log = list(getattr(self.step, "compile_log", ()))
        out["compiles"] = {
            "count": len(compile_log),
            "total_first_call_s": round(sum(e.get("first_call_s", 0.0)
                                            for e in compile_log), 4),
        }
        hbm = _hbm_high_water(self.device)
        if hbm is not None:
            out["hbm_high_water_bytes"] = hbm
        return out

    def log_report(self, prefix: str = "profile") -> Dict[str, Any]:
        rep = self.report()
        logging.info("%s: %s", prefix, json.dumps(rep, sort_keys=True, default=float))
        return rep

    @property
    def exposed_comm_fraction(self) -> Optional[float]:
        """The step's exposed-communication fraction: the roofline residue
        of :meth:`report` (device time beyond the compute/memory bound),
        else None."""
        return self.report().get("exposed_comm_fraction")

    def attribute(self, *args, **kwargs):
        """Measured-wire attribution of a traced window (the JAX package's
        ``obs/attrib.py``): not ported yet."""
        raise NotImplementedError(
            "StepProfiler.attribute needs obs/attrib.py, which waits for ROADMAP.md "
            "Queue 1 item 7 (program-level analysis on torch.profiler traces)")

    def calibration_record(self, cost, name: str = ""):
        """This profile as a planner calibration point: the measured
        per-step wall (and the step's FLOPs and bytes) beside the analytic
        :class:`~autodist_tpu_torch.strategy.cost_model.StrategyCost` of the
        strategy that ran. Feed it to
        :func:`autodist_tpu_torch.plan.calibrate.calibrate_from_records` and
        the planner prices this topology."""
        from autodist_tpu_torch.plan.calibrate import record_from_profiler

        return record_from_profiler(self.report(), cost, name=name)


def _last(x) -> float:
    """The last element of a scalar or a stacked metric."""
    if isinstance(x, torch.Tensor):
        return x.detach().reshape(-1)[-1].item()
    return np.asarray(x).ravel()[-1]


# ----------------------------------------------------------------- StepTimer
class StepTimer:
    """Wall-clock step timing and throughput summary.

    ``items_per_step`` (e.g. global batch size, or tokens a step) turns
    times into throughput. The first ``warmup`` steps are excluded. Use as
    a context manager around each step.
    """

    def __init__(self, items_per_step: float = 0.0, warmup: int = 2):
        self.items_per_step = items_per_step
        self.warmup = warmup
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        assert self._t0 is not None
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None
        return False

    @property
    def measured(self) -> List[float]:
        return self.times[self.warmup:] if len(self.times) > self.warmup else []

    def summary(self) -> Dict[str, Any]:
        xs = sorted(self.measured)
        if not xs:
            return {"steps": len(self.times), "measured": 0}
        n = len(xs)
        mean = sum(xs) / n
        out = {
            "steps": len(self.times),
            "measured": n,
            "mean_s": mean,
            "p50_s": xs[n // 2],
            "p90_s": xs[min(n - 1, int(n * 0.9))],
            "min_s": xs[0],
        }
        if self.items_per_step:
            out["items_per_sec"] = self.items_per_step / mean
        return out

    def log_summary(self, prefix: str = "steps") -> Dict[str, Any]:
        s = self.summary()
        logging.info("%s: %s", prefix, json.dumps(s, sort_keys=True))
        return s
