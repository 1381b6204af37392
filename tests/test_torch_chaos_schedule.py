"""The port's chaos schedules and fault catalog (``autodist_tpu_torch/chaos/
{schedule,faults}.py``) against the JAX package's.

- ``TestSchedule`` and ``TestHooks``: ``tests/test_chaos.py``'s cases of
  the same names, run against the port; the schedule JSON and the catalog
  equal JAX's.
- ``test_handlers_equal_jax``: for every catalog kind with a seam (not the
  two ``"process"`` kinds the harness drives), one schedule and seed
  planted in both packages, the same input put through each package's
  seam handler: the returned values (or the raised exception's type
  name) and the plants' ``trace_bytes()`` are equal byte for byte, the
  seeded draws (``snapshot_corrupt``'s victim and offset,
  ``poisoned_calibration``'s record) included.

The fault classes' pins that need the soak harness wait for its port
(ROADMAP.md, Queue 1 item 6d).
"""
import os

import numpy as np
import pytest
import torch

from autodist_tpu.chaos import faults as jfaults
from autodist_tpu.chaos import hooks as jhooks
from autodist_tpu.chaos import schedule as jschedule
from autodist_tpu_torch.chaos import faults as tfaults
from autodist_tpu_torch.chaos import hooks
from autodist_tpu_torch.chaos import schedule as tschedule
from autodist_tpu_torch.chaos.faults import CATALOG
from autodist_tpu_torch.chaos.schedule import ChaosEvent, ChaosPlant, ChaosSchedule

PKGS = {
    "jax": (jschedule, jfaults, jhooks),
    "port": (tschedule, tfaults, hooks),
}


# ---------------------------------------------------------------- schedule
class TestSchedule:
    def test_json_round_trip(self):
        s = ChaosSchedule(seed=42, events=(
            ChaosEvent("nan_loss", at_step=3),
            ChaosEvent("straggler", at_step=1, until_step=4, host=2,
                       params=(("scale", 3.0),)),
        ))
        assert ChaosSchedule.from_json(s.to_json()) == s
        # The same document as the JAX package's, and each reads the other's.
        j = jschedule.ChaosSchedule(seed=42, events=(
            jschedule.ChaosEvent("nan_loss", at_step=3),
            jschedule.ChaosEvent("straggler", at_step=1, until_step=4, host=2,
                                 params=(("scale", 3.0),)),
        ))
        assert s.to_json() == j.to_json()
        assert jschedule.ChaosSchedule.from_json(s.to_json()) == j
        assert ChaosSchedule.from_json(j.to_json()) == s

    def test_unknown_fault_rejected(self):
        with pytest.raises(ValueError, match="unknown fault"):
            ChaosSchedule(events=(ChaosEvent("typo_fault"),))

    def test_event_window_semantics(self):
        e = ChaosEvent("nan_loss", at_step=3)            # single step
        assert e.active(3) and not e.active(2) and not e.active(4)
        w = ChaosEvent("nan_loss", at_step=3, until_step=6)
        assert w.active(5) and not w.active(6)

    def test_catalog_covers_every_scheduled_seam(self):
        seams = {getattr(hooks, n) for n in dir(hooks) if n.startswith("SEAM_")}
        for spec in CATALOG.values():
            assert spec.seam in seams or spec.seam == "process", spec.kind

    def test_catalog_equals_jax(self):
        assert list(CATALOG) == list(jfaults.CATALOG)
        assert len(CATALOG) == 20
        assert sum(1 for s in CATALOG.values() if s.seam == "process") == 2
        assert len({s.seam for s in CATALOG.values()} - {"process"}) == 11
        for kind, spec in CATALOG.items():
            j = jfaults.CATALOG[kind]
            assert (spec.seam, spec.description, spec.detects, spec.recovery) == \
                (j.seam, j.description, j.detects, j.recovery), kind


# ------------------------------------------------------------------- hooks
class TestHooks:
    def teardown_method(self):
        hooks.clear()

    def test_inert_without_plant(self):
        assert hooks.apply("no.such.seam", {"x": 1}) == {"x": 1}
        assert hooks.fire("no.such.seam") is None
        assert not hooks.active()

    def test_one_plant_at_a_time(self):
        owner_a, owner_b = object(), object()
        hooks.install("seam.a", lambda v, **k: v, owner=owner_a)
        with pytest.raises(RuntimeError, match="already installed"):
            hooks.install("seam.b", lambda v, **k: v, owner=owner_b)
        hooks.clear(owner=owner_a)
        hooks.install("seam.b", lambda v, **k: v, owner=owner_b)

    def test_plant_installs_only_scheduled_seams(self):
        s = ChaosSchedule(seed=1, events=(
            ChaosEvent("heartbeat_drop", at_step=0, host=1),))
        with ChaosPlant(s):
            installed = hooks.installed()
        assert hooks.SEAM_HB_PUBLISH in installed
        assert hooks.SEAM_TRAIN_BATCH not in installed
        assert hooks.installed() == []  # context exit cleared everything


# --------------------------------------------------- handlers against JAX's
def _outcome(fn, *args, **kwargs):
    """("value", result) or ("raise", the exception's type name)."""
    try:
        return ("value", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001 - the raised type is the outcome
        return ("raise", type(e).__name__)


def _plain(x):
    """Values as comparable python/numpy data (tensors to numpy)."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _batch():
    rng = np.random.default_rng(5)
    return {"x": rng.standard_normal((4, 3)).astype(np.float32),
            "y": np.arange(4, dtype=np.int32)}


def _records(pkg):
    from autodist_tpu.plan.calibrate import CalibrationRecord as J
    from autodist_tpu_torch.plan.calibrate import CalibrationRecord as T

    rng = np.random.default_rng(13)
    cls = J if pkg == "jax" else T
    return [cls(comm_s=float(c), update_s=float(u), latency_s=float(lat), act_sync_s=float(a),
                measured_s=float(2e-3 + 2 * c + u), name=f"rec{i}")
            for i, (c, u, lat, a) in enumerate(rng.uniform(1e-4, 5e-3, (6, 4)))]


def _snapshot_dir(root):
    """A landed snapshot's files (the same bytes in each package's copy)."""
    os.makedirs(os.path.join(root, "params"), exist_ok=True)
    for i, name in enumerate(("params/w.npy", "params/b.npy", "state.json", "MANIFEST.json")):
        with open(os.path.join(root, name), "wb") as f:
            f.write(bytes(range(i, i + 40 + 9 * i)))
    return root


def _dir_bytes(root):
    out = {}
    for r, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(r, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _train(h, seams, pkg, tmp):
    out = [_outcome(h[seams.SEAM_TRAIN_BATCH], _batch(), num_steps=1)]
    out.append(_outcome(h[seams.SEAM_TRAIN_METRICS], {"loss": 1.5}, num_steps=1))
    out.append(_outcome(h[seams.SEAM_TRAIN_BATCH], _batch(), num_steps=1))  # past the window
    return out


def _fleet():
    return {0: {"p50": 1.0, "p90": 2.0, "p99": 3.0, "mean": 1.25, "n": 4},
            1: {"p50": 1.5, "p90": 2.5, "p99": 4.0, "mean": 1.75, "n": 4}}


# kind -> (event kwargs, drive(handlers, seams module, package, tmp dir) -> outcomes)
SCENARIOS = {
    "nan_loss": (dict(at_step=0), _train),
    "loss_spike": (dict(at_step=0, params=(("scale", 8.0),)), _train),
    "straggler": (dict(at_step=0, host=1, params=(("scale", 3.0),)),
                  lambda h, s, p, t: [_outcome(h[s.SEAM_AGG_SWEEP], _fleet()),
                                      _outcome(h[s.SEAM_AGG_SWEEP], _fleet())]),
    "heartbeat_drop": (dict(at_step=0, host=2),
                       lambda h, s, p, t: [_outcome(h[s.SEAM_HB_PUBLISH], {"time": 1.0},
                                                    process_id=pid) for pid in (1, 2, 2)]),
    "heartbeat_partition": (dict(at_step=0),
                            lambda h, s, p, t: [_outcome(h[s.SEAM_HB_SWEEP],
                                                         {0: {"t": 1.0}, 1: {"t": 2.0}})
                                                for _ in range(2)]),
    "snapshot_corrupt": (dict(at_step=0), None),
    "snapshot_partial": (dict(at_step=0), None),
    "snapshot_unwritable": (dict(at_step=0, params=(("times", 2),)),
                            lambda h, s, p, t: [_outcome(h[s.SEAM_SNAPSHOT_WRITE],
                                                         path="/ckpt/3", step=3)
                                                for _ in range(3)]),
    "serve_admission": (dict(at_step=0),
                        lambda h, s, p, t: [_outcome(h[s.SEAM_SERVE_ADMIT]) for _ in range(2)]),
    "page_exhaustion": (dict(at_step=0),
                        lambda h, s, p, t: [_outcome(h[s.SEAM_SERVE_PAGES]) for _ in range(2)]),
    "eviction_storm": (dict(at_step=0),
                       lambda h, s, p, t: [_outcome(h[s.SEAM_SERVE_PAGES]) for _ in range(2)]),
    "engine_death": (dict(at_step=0),
                     lambda h, s, p, t: [_outcome(h[s.SEAM_SERVE_STEP], active=2, host=0)
                                         for _ in range(2)]),
    "replica_death": (dict(at_step=0, host=1), None),
    "kill_mid_stochastic_stream": (dict(at_step=0, host=1), None),
    "kill_mid_quantized_stream": (dict(at_step=0, host=1), None),
    "replica_partition": (dict(at_step=0, host=1),
                          lambda h, s, p, t: [_outcome(h[s.SEAM_HB_PUBLISH], {"time": 1.0},
                                                       process_id=pid) for pid in (0, 1, 1)]),
    "draft_divergence": (dict(at_step=0, host=1),
                         lambda h, s, p, t: [_outcome(h[s.SEAM_SERVE_DRAFT], host=hid)
                                             for hid in (0, 1, 1)]),
    "poisoned_calibration": (dict(at_step=0, params=(("scale", 1000.0),)),
                             lambda h, s, p, t: [
                                 (o[0], [r.measured_s for r in o[1]])
                                 for o in [_outcome(h[s.SEAM_PILOT_REFIT], _records(p))]]),
}


def _snapshot(h, s, p, t):
    root = _snapshot_dir(os.path.join(t, p, "step-3"))
    out = [_outcome(h[s.SEAM_SNAPSHOT_WRITTEN], path=root, step=3)]
    return out + [("files", _dir_bytes(root))]


def _host_death(h, s, p, t):
    return [_outcome(h[s.SEAM_SERVE_STEP], active=2, host=hid) for hid in (0, 1, 1)]


for _k in ("snapshot_corrupt", "snapshot_partial"):
    SCENARIOS[_k] = (SCENARIOS[_k][0], _snapshot)
for _k in ("replica_death", "kill_mid_stochastic_stream", "kill_mid_quantized_stream"):
    SCENARIOS[_k] = (SCENARIOS[_k][0], _host_death)


def test_scenarios_cover_every_hooked_kind():
    hooked = sorted(k for k, s in CATALOG.items() if s.seam != "process")
    assert sorted(SCENARIOS) == hooked and len(hooked) == 18


def _run(pkg, kind, tmp):
    schedule_mod, faults_mod, seams = PKGS[pkg]
    kw = dict(SCENARIOS[kind][0])
    event = schedule_mod.ChaosEvent(kind, **kw)
    plant = schedule_mod.ChaosPlant(schedule_mod.ChaosSchedule(seed=29, events=(event,)))
    handlers = faults_mod.make_handlers(plant)
    assert CATALOG[kind].seam in handlers
    outcomes = SCENARIOS[kind][1](handlers, seams, pkg, tmp)
    extra = None
    if pkg == "port" and kind in ("nan_loss", "loss_spike"):
        # A tensor batch through a fresh plant of the same schedule, at the
        # fault's step: tensors stay tensors.
        fresh = schedule_mod.ChaosPlant(schedule_mod.ChaosSchedule(seed=29, events=(event,)))
        batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
        extra = faults_mod.make_handlers(fresh)[seams.SEAM_TRAIN_BATCH](batch, num_steps=1)
    return outcomes, plant.trace_bytes(), sorted(handlers), extra


def _assert_same(a, b, what):
    a, b = _plain(a), _plain(b)
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), what
        for k in a:
            _assert_same(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, list):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{what}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("kind", sorted(SCENARIOS))
def test_handlers_equal_jax(kind, tmp_path):
    port = _run("port", kind, str(tmp_path))
    ref = _run("jax", kind, str(tmp_path))
    _assert_same(port[0], ref[0], kind)             # values / raised types / files
    assert port[1] == ref[1] and port[1]            # the traces, byte for byte
    assert port[2] == ref[2]                        # the seams handled
    if port[3] is not None:                         # a tensor batch: JAX's numbers
        jbatch = ref[0][0][1]
        assert isinstance(port[3]["x"], torch.Tensor) and port[3]["y"].dtype == torch.int32
        np.testing.assert_array_equal(port[3]["x"].numpy(), jbatch["x"])
        np.testing.assert_array_equal(port[3]["y"].numpy(), jbatch["y"])


@pytest.mark.parametrize("kind", sorted(k for k, s in CATALOG.items() if s.seam == "process"))
def test_process_kinds_install_no_hook(kind):
    """The harness drives ``worker_kill`` and ``rolling_upgrade_under_load``
    itself: a plant of either installs nothing, in both packages."""
    for pkg in ("port", "jax"):
        schedule_mod, faults_mod, _ = PKGS[pkg]
        plant = schedule_mod.ChaosPlant(schedule_mod.ChaosSchedule(
            seed=1, events=(schedule_mod.ChaosEvent(kind),)))
        assert faults_mod.make_handlers(plant) == {}, pkg
