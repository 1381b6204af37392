"""The port's autopilot (``autodist_tpu_torch/pilot``) against the JAX
package's, class by class of ``tests/test_pilot.py``: each scenario runs
through both packages on the same inputs (the same seeded
``_linear_records``, the same fakes, one injected clock) and the port is
held to JAX's answer.

- ``TestPolicy``: every code routes to the same rule; ``describe()`` and
  the refusals equal JAX's.
- ``TestPilotState``: states and store files byte for byte, read both ways.
- ``TestJournal``: journal files byte for byte, each package reading the
  other's (torn tail skipped), ``pilot_dir`` on the environment.
- ``TestControllerMatrix`` / ``TestCrashRecovery``: every decision flow of
  JAX's matrix through both controllers over the same fakes: verdicts,
  triggers, actions, ``knobs_before``/``knobs_after`` (the journal's
  bytes), stats, the rollout's applies and the final state JSON.
- ``TestActions``: every knob action's proposal equal to JAX's.
- ``TestRefitGates``: the trusted-set gate and keep-best on the same
  records (the calibration files equal JAX's); an accepted
  ``refit_replan`` and ``tune_bucket_bytes`` on the zoo ``mlp`` under
  ``helpers/torch_auto.py``'s equal constants: ``plan_id`` equal to the id
  of JAX's winner (its JSON with the device names of the card's), the
  priced ``expected`` values within 1e-9 relative.
- ``TestDoctorStitch``: the port's doctor stitches a journal that either
  package wrote, as JAX's doctor does.
- The ``--selftest --device cpu`` CLI, and the card as the default device.
"""
import dataclasses
import hashlib
import importlib
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import autodist_tpu.pilot as jpilot
import autodist_tpu_torch.pilot as tpilot
from autodist_tpu.pilot import actions as jactions
from autodist_tpu.pilot import journal as jjournal
from autodist_tpu.pilot import policy as jpolicy
from autodist_tpu.plan import calibrate as jcal
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.strategy import ir as jir
from autodist_tpu_torch.pilot import actions as tactions
from autodist_tpu_torch.pilot import journal as tjournal
from autodist_tpu_torch.pilot import policy as tpolicy
from autodist_tpu_torch.plan import calibrate as tcal
from autodist_tpu_torch.resource_spec import ResourceSpec
from autodist_tpu_torch.strategy import ir as tir
from helpers import torch_auto as ta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NS = {
    "jax": SimpleNamespace(name="jax", pilot=jpilot, actions=jactions, policy=jpolicy,
                           journal=jjournal, cal=jcal, ir=jir),
    "port": SimpleNamespace(name="port", pilot=tpilot, actions=tactions, policy=tpolicy,
                            journal=tjournal, cal=tcal, ir=tir),
}


def _spec(ns):
    if ns.name == "jax":
        return JResourceSpec(resource_dict={
            "nodes": [{"address": "localhost", "chips": 8, "chief": True}]})
    return ResourceSpec(resource_dict={
        "nodes": [{"address": "localhost", "gpus": 8, "chief": True}]})


def _linear_records(ns, n=10, seed=13):
    """``tests/test_pilot.py``'s fixed linear world (wire at 50%
    efficiency, 2 ms floor), as each package's records."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        comm, upd, lat, act = (float(x) for x in rng.uniform(1e-4, 5e-3, 4))
        measured = 2e-3 + 2.0 * comm + 1.25 * upd + 1.5 * lat + 1.0 * act
        out.append(ns.cal.CalibrationRecord(
            comm_s=comm, update_s=upd, latency_s=lat, act_sync_s=act,
            measured_s=measured, name=f"rec{i}"))
    return out


def _both(fn, tmp_path):
    """``fn(ns, dir)`` through both packages, each in its own dir."""
    out = {}
    for name, ns in NS.items():
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        out[name] = fn(ns, d)
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------------------------ policy
class TestPolicy:
    def test_default_table_routes_every_code(self):
        port, ref = tpolicy.default_policy_table(), jpolicy.default_policy_table()
        codes = {c for r in ref.rules for c in r.codes} | {"SNT001", "SNT006", "nope"}
        for code in sorted(codes):
            t, j = port.rule_for_code(code), ref.rule_for_code(code)
            assert (t is None) == (j is None), code
            if t is not None:
                assert dataclasses.asdict(t) == dataclasses.asdict(j), code
        expect = {
            "SLT001": "refit_replan", "wire_drift": "refit_replan",
            "SNT004": "tune_bucket_bytes", "SNT005": "tune_xla_flags",
            "SNT007": "tune_serve_latency", "SNT008": "tune_serve_latency",
            "SNT009": "tune_pool", "burn_rate": "tune_pool",
            "acceptance_drift": "tune_spec_k",
        }
        for code, action in expect.items():
            assert port.rule_for_code(code).action == action, code

    def test_every_rule_action_is_implemented(self):
        wired = set(tpilot.build_actions(tpilot.PilotContext()))
        assert wired == set(jpilot.build_actions(jpilot.PilotContext()))
        assert tpolicy.ACTIONS == jpolicy.ACTIONS
        for rule in tpolicy.default_policy_table().rules:
            assert rule.action in tpolicy.ACTIONS and rule.action in wired

    @pytest.mark.parametrize("rules", [
        [("a", ("SNT004",), "tune_bucket_bytes"), ("b", ("SNT004",), "tune_pool")],
        [("a", ("x",), "tune_pool"), ("a", ("y",), "tune_pool")],
    ], ids=["code_claimed_twice", "duplicate_trigger"])
    def test_duplicate_code_claim_refused(self, rules):
        msgs = []
        for ns in (NS["port"], NS["jax"]):
            with pytest.raises(ValueError) as e:
                ns.policy.PolicyTable([ns.policy.PolicyRule(*r) for r in rules])
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]

    def test_describe_renders_the_whole_table(self):
        rows = tpolicy.default_policy_table().describe()
        assert rows == jpolicy.default_policy_table().describe()
        assert [r["trigger"] for r in rows] == [
            "wire_drift", "step_time_regression", "hbm_regression",
            "serve_latency", "slo_burn", "acceptance_drift"]
        assert all(r["description"] for r in rows)


# ----------------------------------------------------------- state + store
class TestPilotState:
    def test_with_knobs_is_a_new_version(self):
        for ns in NS.values():
            s0 = ns.pilot.PilotState()
            s1 = s0.with_knobs(spec_k=6, n_pages=64)
            assert (s1.version, s1.spec_k, s1.n_pages) == (1, 6, 64)
            assert (s0.version, s0.spec_k, s0.n_pages) == (0, 4, 0)  # frozen
        assert tpilot.PilotState().with_knobs(spec_k=6).to_json() == \
            jpilot.PilotState().with_knobs(spec_k=6).to_json()

    @pytest.mark.parametrize("bad", [{"spec_kk": 5}, {"version": 9}])
    def test_unknown_knob_is_loud(self, bad):
        msgs = []
        for ns in (NS["port"], NS["jax"]):
            with pytest.raises(ValueError, match="unknown pilot knob") as e:
                ns.pilot.PilotState().with_knobs(**bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]

    def test_version_is_not_a_knob(self):
        assert tpilot.KNOBS == jpilot.KNOBS and "version" not in tpilot.KNOBS
        assert "version" not in tpilot.PilotState().knobs()
        assert tpilot.PilotState().knobs() == jpilot.PilotState().knobs()

    def test_json_round_trip(self):
        knobs = dict(plan_id="abc123", bucket_bytes=1 << 20, xla_flag_set="base",
                     spec_k=2, prefill_chunk=16, n_pages=128)
        s, j = tpilot.PilotState().with_knobs(**knobs), jpilot.PilotState().with_knobs(**knobs)
        assert tpilot.PilotState.from_json(s.to_json()) == s
        assert json.dumps(s.to_json(), sort_keys=True) == json.dumps(j.to_json(), sort_keys=True)
        assert tpilot.PilotState.from_json(j.to_json()) == s
        assert jpilot.PilotState.from_json(s.to_json()) == j

    def test_store_round_trip_and_missing(self, tmp_path):
        def run(ns, d):
            store = ns.pilot.PilotStateStore(str(d / "pilot" / "state.json"))
            assert store.load() is None
            s = ns.pilot.PilotState().with_knobs(plan_id="p1", n_pages=41)
            store.save(s)
            assert store.load() == s
            return store
        stores = _both(run, tmp_path)
        assert _read(stores["port"].path) == _read(stores["jax"].path)
        # each package reads the other's file
        assert stores["port"].load().to_json() == \
            tpilot.PilotStateStore(stores["jax"].path).load().to_json()
        assert jpilot.PilotStateStore(stores["port"].path).load() == stores["jax"].load()
        # a torn file degrades to None, never raises
        with open(stores["port"].path, "w", encoding="utf-8") as f:
            f.write('{"version": 1, "plan_')
        assert stores["port"].load() is None


# ----------------------------------------------------------------- journal
class TestJournal:
    RECORD = dict(decision_id="d1-1", trigger="wire_drift", code="wire_drift",
                  action="refit_replan", verdict="committed", t=12.5,
                  evidence={"drift": 0.4}, knobs_before={"version": 0},
                  knobs_after={"version": 1}, expected={"plan_id": "abc"},
                  measured={"baseline": {"step_s": 1.0}}, note="n")

    def test_record_round_trip(self):
        rec = tpilot.DecisionRecord(**self.RECORD)
        assert tpilot.DecisionRecord.from_json(rec.to_json()) == rec
        assert rec.to_json() == jpilot.DecisionRecord(**self.RECORD).to_json()
        assert jpilot.DecisionRecord.from_json(rec.to_json()) == \
            jpilot.DecisionRecord(**self.RECORD)

    def test_sparse_serialization(self):
        d = tpilot.DecisionRecord(decision_id="d1", trigger="t").to_json()
        assert set(d) == {"decision_id", "trigger", "verdict", "t"}
        assert d == jpilot.DecisionRecord(decision_id="d1", trigger="t").to_json()

    def test_append_read_and_torn_tail(self, tmp_path):
        def run(ns, d):
            path = str(d / "decisions.jsonl")
            j = ns.pilot.DecisionJournal(path, now=lambda: 7.0)
            j.append(ns.pilot.DecisionRecord(decision_id="a", trigger="x"))
            j.append(ns.pilot.DecisionRecord(decision_id="a", trigger="x",
                                             verdict="committed"))
            with open(path, "a", encoding="utf-8") as f:
                f.write('{"decision_id": "b", "trigg')  # crash mid-append
            return path
        paths = _both(run, tmp_path)
        assert _read(paths["port"]) == _read(paths["jax"])
        for reader in (tpilot.read_decisions, jpilot.read_decisions):
            for path in paths.values():
                recs = reader(path)
                assert [r.verdict for r in recs] == ["pending", "committed"]
                assert all(r.t == 7.0 for r in recs)

    def test_latest_folds_to_newest_per_id(self, tmp_path):
        path = str(tmp_path / "decisions.jsonl")
        j = jpilot.DecisionJournal(path)  # written by JAX, folded by the port
        j.append(jpilot.DecisionRecord(decision_id="a", trigger="x"))
        j.append(jpilot.DecisionRecord(decision_id="b", trigger="y"))
        j.append(jpilot.DecisionRecord(decision_id="a", trigger="x", verdict="rolled_back"))
        latest = tpilot.latest_decisions(path)
        assert list(latest) == list(jpilot.latest_decisions(path)) == ["a", "b"]
        assert latest["a"].verdict == "rolled_back"
        assert latest["b"].verdict == "pending"

    def test_ids_are_unique(self, tmp_path):
        t = tpilot.DecisionJournal(str(tmp_path / "d.jsonl"))
        j = jpilot.DecisionJournal(str(tmp_path / "e.jsonl"))
        ids = [t.next_id() for _ in range(10)]
        assert len(set(ids)) == 10 and ids == [j.next_id() for _ in range(10)]

    def test_pilot_dir_follows_the_environment(self, tmp_path, monkeypatch):
        base = str(tmp_path / "ft")
        assert tpilot.decisions_path(base) == jpilot.decisions_path(base) == \
            os.path.join(base, "pilot", "decisions.jsonl")
        monkeypatch.setenv("AUTODIST_PILOT_DIR", str(tmp_path / "p"))
        assert tpilot.pilot_dir() == jpilot.pilot_dir() == str(tmp_path / "p")
        monkeypatch.delenv("AUTODIST_PILOT_DIR")
        monkeypatch.setenv("AUTODIST_FT_DIR", base)
        assert tpilot.pilot_dir() == jpilot.pilot_dir() == os.path.join(base, "pilot")


# ------------------------------------------------- controller decision flow
class _Harness:
    """``tests/test_pilot.py``'s controller over fakes, in one package: a
    recording rollout, a scripted canary, an injected clock, one-knob
    actions for every policy action; the journal stamped at t = 7."""

    def __init__(self, ns, d, config=None, canary=None, actions=None, state=None):
        P = ns.pilot
        self.ns = ns
        self.store = P.PilotStateStore(str(d / "state.json"))
        self.store.save(state or P.PilotState().with_knobs(
            bucket_bytes=1 << 20, spec_k=4, prefill_chunk=64, n_pages=8))
        self.journal = P.DecisionJournal(str(d / "decisions.jsonl"), now=lambda: 7.0)
        self.applies = []
        self.canaries = list(canary or [])
        self.clk = [0.0]

        def _apply(old, new):
            self.store.save(new)
            self.applies.append((old.version, new.version))

        def _canary(n):
            return self.canaries.pop(0) if self.canaries else {"step_s": 1.0}

        def _nudge(knob, delta):
            def fn(state, ev):
                return P.ActionResult(knobs={knob: getattr(state, knob) + delta},
                                      expected={knob: getattr(state, knob) + delta})
            return fn

        if callable(actions):
            actions = actions(P)
        self.ctrl = P.Controller(
            self.store, self.journal,
            actions if actions is not None else {
                "refit_replan": _nudge("bucket_bytes", 1),
                "tune_bucket_bytes": _nudge("bucket_bytes", 1),
                "tune_xla_flags": lambda s, e: P.ActionResult(knobs={"xla_flag_set": "base"}),
                "tune_serve_latency": _nudge("spec_k", -1),
                "tune_pool": _nudge("n_pages", 2),
                "tune_spec_k": _nudge("spec_k", -1),
            },
            P.FunctionRollout(_apply, _canary),
            config=config or P.ControllerConfig(cooldown_s=0.0, canary_window=1),
            clock=lambda: self.clk[0])

    def verdicts(self):
        return [r.verdict for r in self.journal.read()]


def _v(rec):
    return None if rec is None else (rec.verdict, rec.trigger, rec.action, rec.code)


def _once_per_episode(h):
    out = [_v(h.ctrl.ingest_finding({"code": "SNT008", "value": 0.9}))]
    out += [_v(h.ctrl.ingest_finding({"code": "SNT008"})) for _ in range(3)]
    h.ctrl.rearm("serve_latency")
    out.append(_v(h.ctrl.ingest_finding({"code": "SNT008"})))
    assert out[0][0] == "committed" and out[1:4] == [None] * 3 and out[4][0] == "committed"
    assert h.ctrl.state.spec_k == 2 and h.ctrl.stats["episode_gated"] == 3
    return out


def _every_rule(h):
    out = []
    for code, action in [("wire_drift", "refit_replan"), ("SNT004", "tune_bucket_bytes"),
                         ("SNT005", "tune_xla_flags"), ("SNT007", "tune_serve_latency"),
                         ("SNT009", "tune_pool"), ("acceptance_drift", "tune_spec_k")]:
        rec = h.ctrl.ingest_finding({"code": code})
        assert rec is not None and rec.action == action and rec.verdict == "committed", code
        out.append(_v(rec))
    return out


def _cooldown(h):
    out = [_v(h.ctrl.ingest_finding({"code": "SNT008"}))]
    for t in (10.0, 20.0, 30.0):
        h.clk[0] = t
        h.ctrl.rearm("serve_latency")
        out.append(_v(h.ctrl.ingest_finding({"code": "SNT008"})))
    h.clk[0] = 100.0
    h.ctrl.rearm("serve_latency")
    out.append(_v(h.ctrl.ingest_finding({"code": "SNT008"})))
    assert out[1:4] == [None] * 3 and h.ctrl.stats["cooldown_suppressed"] == 3
    assert out[4][0] == "committed" and len(h.applies) == 2
    return out


def _rate_limiter(h):
    out = [_v(h.ctrl.ingest_finding({"code": c})) for c in ("SNT004", "SNT005", "SNT009")]
    h.clk[0] = 200.0
    h.ctrl.rearm("slo_burn")
    out.append(_v(h.ctrl.ingest_finding({"code": "SNT009"})))
    assert out[2] is None and h.ctrl.stats["rate_limited"] == 1 and out[3][0] == "committed"
    return out


def _canary_rollback(h):
    before = h.ctrl.state.to_json()
    rec = h.ctrl.ingest_finding({"code": "SNT008"})
    assert rec.verdict == "rolled_back" and rec.measured["regressed_on"] == ["step_s"]
    assert h.ctrl.state.to_json() == before and h.store.load().to_json() == before
    assert h.applies == [(1, 2), (2, 1)]
    return [_v(rec), rec.measured]


def _nan_canary(h):
    rec = h.ctrl.ingest_finding({"code": "SNT008"})
    assert rec.verdict == "committed"  # NaN baseline = no evidence
    return [_v(rec)]


def _apply_failure(h):
    calls = []

    def _apply(old, new):
        calls.append((old.version, new.version))
        if len(calls) == 1:
            raise RuntimeError("drain timed out")

    h.ctrl.rollout = h.ns.pilot.FunctionRollout(_apply, lambda n: {"m": 1.0})
    rec = h.ctrl.ingest_finding({"code": "SNT008"})
    assert rec.verdict == "rolled_back" and "drain timed out" in rec.note
    assert calls == [(1, 2), (2, 1)] and h.ctrl.state.version == 1
    return [_v(rec), rec.note, calls]


def _typed_rejection(h):
    rec = h.ctrl.ingest_finding({"code": "SNT009"})
    assert rec.verdict == "rejected" and rec.note == "pool at bound"
    assert h.applies == [] and h.verdicts() == ["rejected"]
    return [_v(rec), rec.note]


def _raising_action(h):
    rec = h.ctrl.ingest_finding({"code": "SNT009"})
    assert rec.verdict == "rejected" and "action raised: ValueError" in rec.note
    return [_v(rec), rec.note]


def _unwired(h):
    rec = h.ctrl.ingest_finding({"code": "SNT004"})
    assert rec.verdict == "rejected" and "no implementation" in rec.note
    return [_v(rec), rec.note]


def _write_ahead(h):
    seen = []
    real_apply = h.ctrl.rollout._apply

    def spying(old, new):
        seen.append([r.verdict for r in h.journal.read()])
        real_apply(old, new)

    h.ctrl.rollout = h.ns.pilot.FunctionRollout(spying, lambda n: {"m": 1.0})
    h.ctrl.ingest_finding({"code": "SNT008"})
    assert seen == [["pending"]]
    return seen


def _measured_wire(h):
    out = [_v(h.ctrl.ingest_measured_wire(1.1, 1.0)), _v(h.ctrl.ingest_measured_wire(2.0, 1.0))]
    pending = h.journal.read()[-2]
    assert pending.verdict == "pending" and pending.evidence["drift"] == pytest.approx(1.0)
    out += [_v(h.ctrl.ingest_measured_wire(*mp)) for mp in
            ((2.0, 1.0), (1.0, 1.0), (2.0, 1.0), (1.0, 0.0))]
    assert out[0] is None and out[1][1] == "wire_drift"
    assert out[2:4] == [None, None] and out[4] is not None and out[5] is None
    return out


def _slo_report(h):
    recs = h.ctrl.ingest_slo_report({
        "burn_rate": {"fast": 3.2, "slow": 0.4, "windows_s": [300, 3600]},
        "measured": {"acceptance_by_temperature": {"0.0": 0.10, "0.7": 0.80,
                                                   "nan": float("nan")}}})
    out = [[_v(r) for r in recs]]
    out.append(h.ctrl.ingest_slo_report({
        "burn_rate": {"fast": 0.2, "slow": 0.1},
        "measured": {"acceptance_by_temperature": {"0.0": 0.5}}}))
    out.append([_v(r) for r in h.ctrl.ingest_slo_report({"burn_rate": {"fast": 3.2},
                                                         "measured": {}})])
    assert [v[1] for v in out[0]] == ["slo_burn", "acceptance_drift"]
    assert out[1] == [] and out[2][0][1] == "slo_burn"
    return out


def _flight_replay(h):
    recs = h.ctrl.ingest_flight_records([
        {"kind": "step", "step": 1},
        {"kind": "sentry", "code": "SNT004", "value": 1.3},
        {"kind": "sentry", "code": "SNT004", "value": 1.4},  # latched
        {"kind": "error", "error": "x"},
    ])
    assert len(recs) == 1 and recs[0].code == "SNT004"
    return [_v(r) for r in recs]


def _boom(s, e):
    raise ValueError("bad evidence")


# name -> (scenario, harness kwargs (``actions`` may take the package's pilot))
MATRIX = {
    "trigger_fires_exactly_once_per_episode": (_once_per_episode, {}),
    "every_default_rule_fires_its_action": (_every_rule, {}),
    "cooldown_suppresses_flapping": (_cooldown, dict(config=lambda P: P.ControllerConfig(
        cooldown_s=50.0, canary_window=1))),
    "global_rate_limiter": (_rate_limiter, dict(config=lambda P: P.ControllerConfig(
        cooldown_s=0.0, max_actions_per_window=2, rate_window_s=100.0, canary_window=1))),
    "canary_regression_rolls_back_bit_exact": (_canary_rollback, dict(
        canary=[{"step_s": 1.0, "hbm": 3.0}, {"step_s": 2.0, "hbm": 3.0}])),
    "nan_canary_metric_never_regresses": (_nan_canary, dict(
        canary=[{"step_s": float("nan")}, {"step_s": 5.0}])),
    "apply_failure_rolls_back": (_apply_failure, {}),
    "typed_rejection_never_reaches_rollout": (_typed_rejection, dict(
        actions=lambda P: {"tune_pool": lambda s, e: P.ActionResult(rejected="pool at bound")})),
    "raising_action_is_a_typed_rejection": (_raising_action, dict(
        actions=lambda P: {"tune_pool": _boom})),
    "unwired_action_is_rejected": (_unwired, dict(actions=lambda P: {})),
    "write_ahead_pending_precedes_deploy": (_write_ahead, {}),
    "measured_wire_gates_on_drift_bound": (_measured_wire, {}),
    "slo_report_burn_and_acceptance": (_slo_report, {}),
    "flight_record_replay_only_reads_sentry": (_flight_replay, {}),
}


class TestControllerMatrix:
    @pytest.mark.parametrize("case", sorted(MATRIX))
    def test_matrix_equals_jax(self, case, tmp_path):
        scenario, kw = MATRIX[case]

        def run(ns, d):
            kwargs = dict(kw)
            if callable(kwargs.get("config")):
                kwargs["config"] = kwargs["config"](ns.pilot)
            h = _Harness(ns, d, **kwargs)
            transcript = scenario(h)
            return dict(transcript=transcript, stats=dict(h.ctrl.stats), applies=h.applies,
                        state=h.ctrl.state.to_json(), store=_read(h.store.path),
                        journal=_read(h.journal.path) if os.path.exists(h.journal.path)
                        else b"")
        seen = _both(run, tmp_path)
        port, ref = seen["port"], seen["jax"]
        assert repr(port["transcript"]) == repr(ref["transcript"])
        for key in ("stats", "applies", "state", "store", "journal"):
            assert port[key] == ref[key], key


# ------------------------------------------------------- crash consistency
def _fleet_rollout(ns, store, fleet, die_on=None):
    def _apply(old, new):
        store.save(new)  # store lands first (the atomic truth)
        if die_on and die_on[0]:
            die_on[0] = False
            raise KeyboardInterrupt  # the controller process dies here
        fleet["state"] = new
    return ns.pilot.FunctionRollout(_apply, lambda n: {"m": 1.0})


class TestCrashRecovery:
    def test_dead_controller_mid_rollout_recovers_consistent(self, tmp_path):
        def run(ns, d):
            P = ns.pilot
            store = P.PilotStateStore(str(d / "state.json"))
            old = P.PilotState().with_knobs(n_pages=8)
            store.save(old)
            journal = P.DecisionJournal(str(d / "decisions.jsonl"), now=lambda: 3.0)
            fleet = {"state": old}
            actions = {"tune_pool": lambda s, e: P.ActionResult(knobs={"n_pages": s.n_pages + 2})}
            ctrl = P.Controller(store, journal, actions,
                                _fleet_rollout(ns, store, fleet, die_on=[True]),
                                config=P.ControllerConfig(cooldown_s=0.0, canary_window=1))
            with pytest.raises(KeyboardInterrupt):
                ctrl.ingest_finding({"code": "SNT009"})
            assert [r.verdict for r in journal.read()] == ["pending"]
            torn = (store.load().n_pages, fleet["state"].n_pages)
            assert torn == (10, 8)
            ctrl2 = P.Controller(store, journal, actions, _fleet_rollout(ns, store, fleet))
            done = ctrl2.recover()
            assert [r.verdict for r in done] == ["rolled_back"]
            assert ctrl2.stats["recovered"] == 1
            assert store.load().to_json() == old.to_json() == fleet["state"].to_json()
            assert ctrl2.state == old and ctrl2.recover() == []
            return _read(journal.path), _read(store.path)
        seen = _both(run, tmp_path)
        assert seen["port"] == seen["jax"]

    def test_port_recovers_a_jax_journal(self, tmp_path):
        """JAX's controller dies mid-rollout; the port's recovers its
        journal and store."""
        store = jpilot.PilotStateStore(str(tmp_path / "state.json"))
        old = jpilot.PilotState().with_knobs(n_pages=8)
        store.save(old)
        journal = jpilot.DecisionJournal(str(tmp_path / "decisions.jsonl"))
        fleet = {"state": old}
        ctrl = jpilot.Controller(
            store, journal,
            {"tune_pool": lambda s, e: jpilot.ActionResult(knobs={"n_pages": s.n_pages + 2})},
            _fleet_rollout(NS["jax"], store, fleet, die_on=[True]),
            config=jpilot.ControllerConfig(cooldown_s=0.0, canary_window=1))
        with pytest.raises(KeyboardInterrupt):
            ctrl.ingest_finding({"code": "SNT009"})
        tstore = tpilot.PilotStateStore(store.path)
        tjournal_ = tpilot.DecisionJournal(journal.path)
        ctrl2 = tpilot.Controller(tstore, tjournal_, {},
                                  _fleet_rollout(NS["port"], tstore, fleet))
        assert [r.verdict for r in ctrl2.recover()] == ["rolled_back"]
        assert tstore.load().to_json() == old.to_json() == fleet["state"].to_json()
        assert [r.verdict for r in jpilot.read_decisions(journal.path)] == \
            ["pending", "rolled_back"]

    def test_recover_noop_on_clean_journal(self, tmp_path):
        store = tpilot.PilotStateStore(str(tmp_path / "state.json"))
        store.save(tpilot.PilotState())
        journal = tpilot.DecisionJournal(str(tmp_path / "decisions.jsonl"))
        applies = []
        ctrl = tpilot.Controller(store, journal, {},
                                 tpilot.FunctionRollout(lambda o, n: applies.append(1),
                                                        lambda n: {}))
        assert ctrl.recover() == [] and applies == []


# ------------------------------------------------------------ knob actions
_UNMEASURED = {"chosen": {"name": "overlap_all"}, "measured": False,
               "session_stable": False, "results_ms_per_step": {}}
_MEASURED = {"measured": True, "session_stable": True,
             "results_ms_per_step": {"base": 3.0, "lhs_on": 2.5}}
_UNSTABLE = dict(_MEASURED, session_stable=False)
_LOW = {"acceptance_by_temperature": {"0.0": 0.1, "0.7": 0.8}}
_HIGH = {"acceptance_by_temperature": {"0.0": 0.95, "0.7": 0.93}}
_BAND = {"acceptance_by_temperature": {"0.0": 0.5}}

# id -> (action, flags doc or None, state knobs, evidence, context kwargs)
ACTION_CASES = {
    "xla_unmeasured_is_candidate": ("tune_xla_flags", _UNMEASURED, {}, {}, {}),
    "xla_no_doc": ("tune_xla_flags", None, {}, {}, {}),
    "xla_measured_picks_best": ("tune_xla_flags", _MEASURED, {}, {}, {}),
    "xla_measured_best_deployed": ("tune_xla_flags", _MEASURED,
                                   {"xla_flag_set": "lhs_on"}, {}, {}),
    "xla_unstable_stays_candidate": ("tune_xla_flags", _UNSTABLE,
                                     {"xla_flag_set": "base"}, {}, {}),
    "pool_grows": ("tune_pool", None, {"n_pages": 8}, {}, {"max_pages": 64}),
    "pool_unknown": ("tune_pool", None, {}, {}, {"max_pages": 64}),
    "pool_at_bound": ("tune_pool", None, {"n_pages": 64}, {}, {"max_pages": 64}),
    "spec_k_low": ("tune_spec_k", None, {}, _LOW, {}),
    "spec_k_high": ("tune_spec_k", None, {}, _HIGH, {}),
    "spec_k_band": ("tune_spec_k", None, {}, _BAND, {}),
    "spec_k_no_buckets": ("tune_spec_k", None, {}, {}, {}),
    "spec_k_floor": ("tune_spec_k", None, {"spec_k": 1}, _LOW, {}),
    "spec_k_ceiling": ("tune_spec_k", None, {"spec_k": 8}, _HIGH, {}),
    "ttft_halves_chunk": ("tune_serve_latency", None, {"prefill_chunk": 64},
                          {"code": "SNT007"}, {}),
    "ttft_clamps_chunk": ("tune_serve_latency", None, {"prefill_chunk": 5},
                          {"code": "SNT007"}, {}),
    "ttft_chunk_minimal": ("tune_serve_latency", None, {"prefill_chunk": 4},
                           {"code": "SNT007"}, {}),
    "itl_sheds_k": ("tune_serve_latency", None, {}, {"code": "SNT008"}, {}),
    "itl_k_floor": ("tune_serve_latency", None, {"spec_k": 1}, {"code": "SNT008"}, {}),
}


class TestActions:
    @pytest.mark.parametrize("case", sorted(ACTION_CASES))
    def test_action_equals_jax(self, case, tmp_path):
        action, doc, knobs, evidence, ctx_kw = ACTION_CASES[case]
        flags = tmp_path / "xla_flags.json"
        if doc is not None:
            flags.write_text(json.dumps(doc), encoding="utf-8")

        def run(ns, d):
            ctx = ns.pilot.PilotContext(pilot_dir=str(d / "pilot"), xla_flags_path=str(flags),
                                        **ctx_kw)
            state = ns.pilot.PilotState().with_knobs(**knobs) if knobs else ns.pilot.PilotState()
            return dataclasses.asdict(getattr(ns.actions, action)(ctx, state, evidence))
        seen = _both(run, tmp_path)
        assert seen["port"] == seen["jax"]
        if case == "xla_unmeasured_is_candidate":
            assert seen["port"]["knobs"] == {"xla_flag_set": "vmem128m"}
            assert seen["port"]["expected"]["candidate_of"] == list(tactions.FALLBACK_FLAG_SETS)
        assert tactions.FALLBACK_FLAG_SETS == jactions.FALLBACK_FLAG_SETS


# ----------------------------------------------------- refit gates (belts)
def _seed_calibration(ns, d):
    spec = _spec(ns)
    records = _linear_records(ns)
    calib_dir = str(d / "calib")
    ns.cal.calibrate_from_records(records, spec, device_kind="cpu", directory=calib_dir)
    key = ns.cal.topology_key(spec, "cpu")
    return spec, records, calib_dir, os.path.join(calib_dir, f"calibration-{key}.json")


def _close(a, b, what=""):
    """Dicts of numbers (and strings) equal, floats to 1e-9 relative."""
    assert sorted(a) == sorted(b), what
    for k in a:
        if isinstance(a[k], float):
            assert a[k] == pytest.approx(b[k], rel=1e-9, abs=0), (what, k)
        else:
            assert a[k] == b[k], (what, k)


class TestRefitGates:
    def test_trusted_set_gate_rejects_poisoned_window(self, tmp_path):
        def run(ns, d):
            spec, records, calib_dir, path = _seed_calibration(ns, d)
            before = _read(path)
            poisoned = [dataclasses.replace(r, measured_s=r.measured_s * 1000.0,
                                            name=f"live{i}")
                        for i, r in enumerate(records[:4])]
            ctx = ns.pilot.PilotContext(resource_spec=spec, device_kind="cpu",
                                        calibration_dir=calib_dir, pilot_dir=str(d / "pilot"),
                                        live_records=lambda: poisoned)
            res = ns.actions.refit_replan(ctx, ns.pilot.PilotState(), {})
            assert res.is_rejected and "poisoned_calibration" in res.rejected
            assert res.expected["err_trusted_after"] > res.expected["err_trusted_before"]
            assert _read(path) == before
            assert not os.path.isdir(str(d / "pilot" / "plans"))
            return res, before
        seen = _both(run, tmp_path)
        (t, tfile), (j, jfile) = seen["port"], seen["jax"]
        assert t.rejected == j.rejected and t.knobs == j.knobs == {}
        _close(t.expected, j.expected)
        _close(json.loads(tfile)["coefficients"], json.loads(jfile)["coefficients"])

    def test_refit_rejects_empty_live_window(self, tmp_path):
        def run(ns, d):
            spec, _, calib_dir, _ = _seed_calibration(ns, d)
            ctx = ns.pilot.PilotContext(resource_spec=spec, device_kind="cpu",
                                        calibration_dir=calib_dir, live_records=lambda: [])
            return dataclasses.asdict(ns.actions.refit_replan(ctx, ns.pilot.PilotState(), {}))
        seen = _both(run, tmp_path)
        assert seen["port"] == seen["jax"] and "no live" in seen["port"]["rejected"]

    def test_keep_best_holds_against_regressing_fit(self, tmp_path):
        def run(ns, d):
            spec, records, calib_dir, path = _seed_calibration(ns, d)
            prior = ns.cal.TopologyCalibration.load(path)
            n_before = len(ns.cal.load_records(path))
            poisoned = [dataclasses.replace(records[3], measured_s=records[3].measured_s
                                            * 1000.0, name="poison")]
            kept = ns.cal.calibrate_from_records(poisoned, spec, device_kind="cpu",
                                                 directory=calib_dir)
            assert kept.coefficients == prior.coefficients and kept.base_s == prior.base_s
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
            assert len(doc["rejected_fits"]) == 1
            assert doc["rejected_fits"][0]["error_after"] > doc["rejected_fits"][0]["error_best"]
            assert len(ns.cal.load_records(path)) == n_before + 1
            return doc
        seen = _both(run, tmp_path)
        t, j = seen["port"], seen["jax"]
        assert len(t["records"]) == len(j["records"])
        _close(t["rejected_fits"][0]["coefficients"], j["rejected_fits"][0]["coefficients"])
        for k in ("error_after", "error_best", "base_s"):
            assert t["rejected_fits"][0][k] == pytest.approx(j["rejected_fits"][0][k],
                                                             rel=1e-9, abs=1e-15), k

    def test_keep_best_accepts_a_better_fit(self, tmp_path):
        def run(ns, d):
            spec, _, calib_dir, path = _seed_calibration(ns, d)
            calib = ns.cal.calibrate_from_records(_linear_records(ns, n=12, seed=29), spec,
                                                  device_kind="cpu", directory=calib_dir)
            assert np.isfinite(calib.error_after) and calib.error_after < 0.05
            with open(path, encoding="utf-8") as f:
                assert json.load(f)["rejected_fits"] == []
            return calib
        seen = _both(run, tmp_path)
        t, j = seen["port"], seen["jax"]
        assert t.error_after == pytest.approx(j.error_after, rel=1e-9)
        assert t.base_s == pytest.approx(j.base_s, rel=1e-9, abs=1e-15)
        for k, v in j.coefficients.items():
            assert t.coefficients[k] == pytest.approx(v, rel=1e-9, abs=1e-15), k


# ------------------------------------------- replans on the zoo mlp, priced
@pytest.fixture
def pinned(monkeypatch):
    """Both searches seeded from ``ta.slates()`` and every Strategy id
    pinned (ids carry a timestamp and the pid), so a plan's content id
    depends on its content alone."""
    jsearch = importlib.import_module("autodist_tpu.plan.search")
    tsearch = importlib.import_module("autodist_tpu_torch.plan.search")
    monkeypatch.setattr(jsearch, "candidate_slate", lambda *a, **kw: ta.slates()[0])
    monkeypatch.setattr(tsearch, "candidate_slate", lambda *a, **kw: ta.slates()[1])
    for ir in (jir, tir):
        monkeypatch.setattr(ir.Strategy, "new_id", classmethod(lambda cls, fp="": "pinned"))


def _card_id(strategy_json: dict) -> str:
    """The content id of a JAX Strategy's JSON with the card's device
    names: the id the same strategy has in the port."""
    text = json.dumps(strategy_json).replace(":TPU:", ":GPU:")
    raw = json.dumps(json.loads(text), indent=2, sort_keys=True).encode("utf-8")
    return hashlib.sha256(raw).hexdigest()[:12]


def _mlp_ctx(ns, d, live):
    jitem, titem = ta.items("mlp")
    jspec, tspec = ta.specs("1x8")
    item, spec = (jitem, jspec) if ns.name == "jax" else (titem, tspec)
    calib_dir = str(d / "calib")
    ns.cal.calibrate_from_records(_linear_records(ns), spec, device_kind="cpu",
                                  directory=calib_dir)
    pdir = str(d / "pilot")
    current = [None]
    ctx = ns.pilot.PilotContext(
        model_item=item, resource_spec=spec, device_kind="cpu", calibration_dir=calib_dir,
        pilot_dir=pdir, live_records=lambda: live(ns), current_strategy=lambda: current[0])
    strategy_mod = importlib.import_module(("autodist_tpu" if ns.name == "jax" else "autodist_tpu_torch")
                                 + ".strategy")
    current[0] = strategy_mod.AllReduce().build(item, spec)
    return ctx


class TestReplanEqualsJax:
    def test_plan_artifact_ids_equal_jax(self, tmp_path):
        doc = tir.Strategy(
            node_config=[tir.NodeConfig(var_name="w", synchronizer=tir.AllReduceSynchronizer(
                group=1, shard_update=True)), tir.NodeConfig(
                var_name="b", synchronizer=tir.PSSynchronizer(
                    reduction_destination="localhost:CPU:0"), partitioner="2,1")],
            id="s1").to_json()
        doc["graph_config"] = {"replicas": ["localhost:GPU:0", "localhost:GPU:1"],
                               "bucket_bytes": 1 << 20}
        assert jir.Strategy.from_json(doc).to_json() == doc
        tid = tpilot.save_plan_artifact(str(tmp_path / "t"), tir.Strategy.from_json(doc))
        jid = jpilot.save_plan_artifact(str(tmp_path / "j"), jir.Strategy.from_json(doc))
        assert tid == jid
        assert _read(tactions.plan_artifact_path(str(tmp_path / "t"), tid)) == \
            _read(jactions.plan_artifact_path(str(tmp_path / "j"), jid))
        # each package deploys the other's artifact
        assert tpilot.load_plan_artifact(str(tmp_path / "j"), jid).to_json() == \
            tir.Strategy.from_json(doc).to_json()
        assert jpilot.load_plan_artifact(str(tmp_path / "t"), tid).to_json() == \
            jir.Strategy.from_json(doc).to_json()

    def test_accepted_refit_replan_equals_jax(self, tmp_path, pinned):
        def run(ns, d):
            ctx = _mlp_ctx(ns, d, lambda ns: _linear_records(ns, n=12, seed=29))
            res = ns.actions.refit_replan(ctx, ns.pilot.PilotState(), {})
            assert not res.is_rejected, res.rejected
            winner = ns.pilot.load_plan_artifact(ctx.pilot_dir, res.knobs["plan_id"])
            return res, winner.to_json(), _read(os.path.join(
                ctx.calibration_dir, f"calibration-{ns.cal.topology_key(ctx.resource_spec, 'cpu')}"
                                     ".json"))
        seen = _both(run, tmp_path)
        (t, twin, tfile), (j, jwin, jfile) = seen["port"], seen["jax"]
        assert t.knobs["plan_id"] == _card_id(jwin)
        assert twin == json.loads(json.dumps(jwin).replace(":TPU:", ":GPU:"))
        assert t.knobs["bucket_bytes"] == j.knobs["bucket_bytes"]
        assert sorted(t.expected) == sorted(j.expected)
        for k in ("calibration_error_after", "priced_new_ms", "priced_stale_ms"):
            assert t.expected[k] == pytest.approx(j.expected[k], rel=1e-9), k
        assert t.expected["plan_id"] == t.knobs["plan_id"]
        tdoc, jdoc = json.loads(tfile), json.loads(jfile)
        assert len(tdoc["records"]) == len(jdoc["records"]) == 22
        _close(tdoc["coefficients"], jdoc["coefficients"])

    def test_tune_bucket_bytes_equals_jax(self, tmp_path, pinned):
        def run(ns, d):
            ctx = _mlp_ctx(ns, d, lambda ns: [])
            return ns.actions.tune_bucket_bytes(ctx, ns.pilot.PilotState(), {})
        seen = _both(run, tmp_path)
        t, j = seen["port"], seen["jax"]
        assert not t.is_rejected and t.knobs == j.knobs
        _close(t.expected, j.expected)


# -------------------------------------------------------- doctor stitching
class TestDoctorStitch:
    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_decisions_land_in_the_doctor_timeline(self, tmp_path, writer):
        from autodist_tpu.obs.doctor import diagnose as jdiagnose
        from autodist_tpu_torch.obs.doctor import diagnose

        P = NS[writer].pilot
        j = P.DecisionJournal(P.decisions_path(str(tmp_path)), now=lambda: 5.0)
        j.append(P.DecisionRecord(decision_id="d9-1", trigger="wire_drift", code="wire_drift",
                                  action="refit_replan", verdict="committed"))
        j.append(P.DecisionRecord(decision_id="d9-2", trigger="slo_burn", code="SNT009",
                                  action="tune_pool", verdict="rejected", note="at bound"))
        diag = diagnose(str(tmp_path))
        assert diag.stats["pilot_decisions"] == 2
        pilot = [e for e in diag.timeline if e.get("source") == "pilot"]
        assert pilot[0]["action"] == "refit_replan" and pilot[0]["verdict"] == "committed"
        ref = [e for e in jdiagnose(str(tmp_path)).timeline if e.get("source") == "pilot"]
        assert pilot == ref


# -------------------------------------------------------------------- CLI
def test_selftest_cli_cpu():
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "autodist_tpu_torch.pilot", "--selftest",
                          "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["ok"] is True and line["device"] == "cpu"
    assert line["proofs"] == {"drift_refit_commit": True, "poisoned_refit_rejected": True,
                              "canary_rollback_bit_exact": True,
                              "serve_rollout_zero_drops": True}
    assert line["serve_zero_drops"] is True and line["serve_requests"] > 0
    assert line["poisoned_refit_rejected"] and line["canary_rollback_bit_exact"]
    assert line["journal_verdicts"] == ["pending", "committed", "rejected", "pending",
                                        "rolled_back", "pending", "committed"]
    assert line["improvement_frac"] > 0 and line["drift"] > 0.25
    assert len(line["restart_s"]) == 2


def test_selftest_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from autodist_tpu_torch.pilot.__main__ import selftest

    with pytest.raises(RuntimeError, match="CUDA"):
        selftest()
    out = subprocess.run([sys.executable, "-m", "autodist_tpu_torch.pilot", "--selftest"],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and "CUDA" in out.stderr
    assert '"selftest"' not in out.stdout
