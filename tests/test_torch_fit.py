"""Port parity: the training loop (``DistributedTrainStep.fit``, its
windowed form, ``compile_metrics`` and the eval hook).

The JAX package's ``fit`` (on ``tests/conftest.py``'s 8-device CPU mesh)
and the port's (one CPU process) run on the same weights (JAX ``init``
carried over with ``params_from_jax``) and the same batches, made from a
seed with numpy. Tolerances are those of the port's step-parity tests
(``tests/test_torch_train.py``): 1e-5 on losses, 1e-5 absolute + 1e-4
relative on parameters (the two packages sum in different orders). The
port's windowed history is held to its own per-step history bitwise: a
window runs the same steps on slices of the stacked batches. The contracts
of ``tests/test_lowering.py::TestFit`` and
``test_fit_windowed_consumes_exactly_ran`` are checked in the port:
``steps`` cuts a shared iterator with ``islice``, eval and ``steps``
boundaries land between windows, a ragged batch ends its window and runs
in the next, and the batches consumed are those run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu import api as japi
from autodist_tpu import metrics as jmetrics
from autodist_tpu import strategy as jstrat
from autodist_tpu.data import DataLoader as JDataLoader
from autodist_tpu.data import files as jfiles
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu_torch import api as tapi
from autodist_tpu_torch import metrics as tmetrics
from autodist_tpu_torch import strategy as tstrat
from autodist_tpu_torch.data import DataLoader
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.models.convert import flatten_params, params_from_jax

from helpers.torch_threads import one_torch_thread  # noqa: F401

LOSS_TOL, PARAM_ATOL, PARAM_RTOL = 1e-5, 1e-5, 1e-4
MLP = dict(in_dim=8, hidden=(16,), num_classes=4)
LM = dict(vocab_size=101, num_layers=2, d_model=64, num_heads=1, d_ff=128, max_seq_len=16,
          attention_impl="dot")
BATCH = 16


@pytest.fixture(autouse=True)
def _fresh_autodist():
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()
    yield
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()


def _mlp_batches(n, seed=7, rows=BATCH):
    rng = np.random.default_rng(seed)
    return [{"x": rng.standard_normal((rows, MLP["in_dim"])).astype(np.float32),
             "y": rng.integers(0, MLP["num_classes"], rows).astype(np.int32)}
            for _ in range(n)]


def _lm_batches(n, seed=7, rows=BATCH):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(0, LM["vocab_size"], (rows, LM["max_seq_len"]))
             .astype(np.int32)} for _ in range(n)]


def _steps(model, overrides, batch, builder="AllReduce"):
    """(JAX step, JAX params, port step, port params, JAX spec, port spec)
    on carried-over weights, both built through their ``AutoDist``."""
    jspec = jax_get_model(model, **({"dtype": jnp.float32} if model != "mlp" else {}),
                          **overrides)
    tspec = get_model_spec(model, **({"dtype": "float32"} if model != "mlp" else {}),
                           **overrides)
    jparams = jspec.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    jad = japi.AutoDist(strategy_builder=jstrat.from_name(builder))
    jstep = jad.build(jspec.loss_fn, jparams, batch)
    tad = tapi.AutoDist(strategy_builder=tstrat.from_name(builder), device="cpu")
    tstep = tad.build(tspec.loss_fn, tparams, {k: torch.from_numpy(v) for k, v in batch.items()})
    return jstep, jparams, tstep, tparams, jspec, tspec


def _params_close(tstep, tstate, jstep, jstate):
    got = {k: v.numpy() for k, v in flatten_params(tstep.logical_params(tstate)).items()}
    want = {k: np.asarray(v) for k, v in
            flatten_params(jax.tree.map(np.asarray, jstep.logical_params(jstate))).items()}
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=PARAM_ATOL, rtol=PARAM_RTOL,
                                   err_msg=name)


def _bitwise(tstep, a, b):
    pa, pb = flatten_params(tstep.logical_params(a)), flatten_params(tstep.logical_params(b))
    for name in pa:
        assert torch.equal(pa[name], pb[name]), name


@pytest.mark.parametrize("model", ["mlp", "transformer"])
def test_fit_per_step_and_windowed_match_jax(model):
    overrides, make = (MLP, _mlp_batches) if model == "mlp" else (LM, _lm_batches)
    batches = make(12)
    eval_batch = make(1, seed=11)[0]
    jstep, jparams, tstep, tparams, _, _ = _steps(model, overrides, batches[0])
    kw = dict(eval_batch=eval_batch, eval_every=5)
    jstate, jhist = jstep.fit(jstep.init(jparams), iter(batches), **kw)
    for window in (0, 4):
        tstate, thist = tstep.fit(tstep.init(tparams), iter(batches), window=window, **kw)
        assert len(thist["loss"]) == 12 and tstate.step == 12
        np.testing.assert_allclose(thist["loss"], jhist["loss"], atol=LOSS_TOL, rtol=LOSS_TOL)
        assert len(thist["eval_loss"]) == len(jhist["eval_loss"]) == 2
        np.testing.assert_allclose(thist["eval_loss"], jhist["eval_loss"], atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        _params_close(tstep, tstate, jstep, jstate)
        if window == 0:
            per_step = (tstate, thist)
    # The windowed history and parameters equal the port's per-step ones bitwise.
    assert thist == per_step[1]
    _bitwise(tstep, tstate, per_step[0])


def test_fit_windowed_runs_one_program_per_window():
    batches = _mlp_batches(12)
    _, _, tstep, tparams, _, _ = _steps("mlp", MLP, batches[0])
    calls = []
    run = tstep.run
    tstep.run = lambda *a, **k: calls.append(a[2]) or run(*a, **k)
    state, hist = tstep.fit(tstep.init(tparams), iter(batches), window=4)
    assert calls == [4, 4, 4] and len(hist["loss"]) == 12 and state.step == 12


def test_fit_steps_cap_consumes_only_what_ran_and_eval_lands_between_windows():
    batches = _mlp_batches(50)
    eval_batch = _mlp_batches(1, seed=3)[0]
    jstep, jparams, tstep, tparams, _, _ = _steps("mlp", MLP, batches[0])
    jit = iter(batches)
    jstate, jhist = jstep.fit(jstep.init(jparams), jit, steps=10, eval_batch=eval_batch,
                              eval_every=5)
    for window in (0, 4):
        it = iter(batches)
        calls = []
        run = tstep.run
        tstep.run = lambda *a, **k: calls.append(a[2]) or run(*a, **k)
        try:
            tstate, thist = tstep.fit(tstep.init(tparams), it, steps=10, window=window,
                                      eval_batch=eval_batch, eval_every=5)
        finally:
            tstep.run = run
        assert len(list(it)) == 40          # exactly 10 consumed, not 11
        assert len(thist["loss"]) == 10 and len(thist["eval_loss"]) == 2
        # window=4 with eval_every=5: windows of 4, 1, 4, 1 (one step alone
        # is a plain call).
        assert calls == ([4, 4] if window else [])
        np.testing.assert_allclose(thist["loss"], jhist["loss"], atol=LOSS_TOL, rtol=LOSS_TOL)
        np.testing.assert_allclose(thist["eval_loss"], jhist["eval_loss"], atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
    assert len(list(jit)) == 40


@pytest.mark.parametrize("steps,ragged_at", [(5, 4), (7, 4), (6, 0), (9, 8), (None, 5)])
def test_fit_windowed_consumes_exactly_ran(steps, ragged_at):
    """The ragged look-ahead is carried into the next window as
    ``pending``, never discarded (``tests/test_lowering.py``'s
    ``test_fit_windowed_consumes_exactly_ran``); a ragged batch runs alone
    and the history equals the per-step one."""
    rng = np.random.default_rng(0)
    data = []
    for i in range(12):
        n = 3 if i == ragged_at else 8
        data.append({"x": rng.standard_normal((n, MLP["in_dim"])).astype(np.float32),
                     "y": rng.integers(0, MLP["num_classes"], n).astype(np.int32)})
    _, _, tstep, tparams, _, _ = _steps("mlp", MLP, data[0])
    histories = []
    for window in (4, 0):
        pulled = []

        def batches():
            for i, b in enumerate(data):
                pulled.append(i)
                yield b

        _, hist = tstep.fit(tstep.init(tparams), batches(), steps=steps, window=window)
        ran = 12 if steps is None else steps
        assert len(hist["loss"]) == ran
        assert len(pulled) == ran, f"steps={steps} ragged_at={ragged_at}: pulled {len(pulled)}"
        histories.append(hist)
    assert histories[0] == histories[1]


def test_fit_from_dataloader_matches_jax_loader_fit():
    """A DataLoader bound to the plan (global batches on the device) feeds
    per-step and windowed fit; both equal JAX's fit over its loader of the
    same rows."""
    rng = np.random.default_rng(3)
    data = {"x": rng.standard_normal((64, MLP["in_dim"])).astype(np.float32),
            "y": rng.integers(0, MLP["num_classes"], 64).astype(np.int32)}
    first = {k: v[:BATCH] for k, v in data.items()}
    jstep, jparams, tstep, tparams, _, _ = _steps("mlp", MLP, first)
    kw = dict(batch_size=BATCH, shuffle=True, seed=5, epochs=2)
    jstate, jhist = jstep.fit(jstep.init(jparams),
                              JDataLoader(data, plan=jstep.plan, engine="python", **kw))
    out = {}
    for window in (0, 4):
        loader = DataLoader(data, plan=tstep.plan, engine="native", **kw)
        assert loader.engine == "native"
        batch = next(iter(loader))
        assert isinstance(batch["x"], torch.Tensor) and batch["x"].device.type == "cpu"
        tstate, thist = tstep.fit(tstep.init(tparams), loader, window=window)
        np.testing.assert_allclose(thist["loss"], jhist["loss"], atol=LOSS_TOL, rtol=LOSS_TOL)
        _params_close(tstep, tstate, jstep, jstate)
        out[window] = (tstate, thist)
    assert out[0][1] == out[4][1]
    _bitwise(tstep, out[0][0], out[4][0])


def test_fit_eval_metrics_series_match_jax():
    """``eval_<name>`` series from ``eval_metrics_fn`` at the eval points,
    per step and windowed (JAX's ``test_fit_records_eval_metrics_series``)."""
    batches = _mlp_batches(6)
    eval_batch = _mlp_batches(1, seed=9, rows=32)[0]
    jstep, jparams, tstep, tparams, jspec, tspec = _steps("mlp", MLP, batches[0])
    jm = jmetrics.classification_metrics(jspec.apply, input_key="x", label_key="y",
                                         top_k=(1, 2))
    tm = tmetrics.classification_metrics(tspec.apply, input_key="x", label_key="y",
                                         top_k=(1, 2))
    _, jhist = jstep.fit(jstep.init(jparams), iter(batches), eval_batch=eval_batch,
                         eval_every=2, eval_metrics_fn=jm)
    for window in (0, 2):
        _, thist = tstep.fit(tstep.init(tparams), iter(batches), eval_batch=eval_batch,
                             eval_every=2, window=window, eval_metrics_fn=tm)
        assert sorted(thist) == sorted(jhist) == ["eval_loss", "eval_top1", "eval_top2", "loss"]
        for name in ("eval_top1", "eval_top2"):
            assert len(thist[name]) == 3
            np.testing.assert_allclose(thist[name], jhist[name], atol=1e-6)


def test_fit_hook_strips_weights_and_renames_loss():
    batches = _mlp_batches(4)
    _, _, tstep, tparams, _, _ = _steps("mlp", MLP, batches[0])

    def mfn(p, batch):
        return {"loss": torch.tensor(7.0), "acc": torch.tensor(0.5),
                "acc__weight": torch.tensor(100.0)}

    _, hist = tstep.fit(tstep.init(tparams), iter(batches), eval_batch=batches[0],
                        eval_every=2, eval_metrics_fn=mfn)
    assert hist["eval_metrics_loss"] == [7.0, 7.0]
    assert hist["eval_acc"] == [0.5, 0.5]
    assert "eval_acc__weight" not in hist and len(hist["eval_loss"]) == 2


def test_compile_metrics_on_offloaded_plan_equals_jax():
    """Offloaded leaves stream in for the metrics (the path ``evaluate``
    takes); the result equals JAX's on the same params (JAX's own gate
    turns offload off on the CPU, which changes nothing in its numbers)."""
    batch = _mlp_batches(1)[0]
    full = _mlp_batches(1, seed=4, rows=32)[0]
    jstep, jparams, _, tparams, jspec, tspec = _steps("mlp", MLP, batch, builder="PS")
    tapi.AutoDist.reset_default()
    tad = tapi.AutoDist(strategy_builder=tstrat.PS(), device="cpu")
    tstep = tad.build(tspec.loss_fn, tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                      host_offload=True)
    assert tad.plan.has_offload and tstep.offloaded
    jm = jmetrics.classification_metrics(jspec.apply, input_key="x", label_key="y", top_k=(1, 3))
    tm = tmetrics.classification_metrics(tspec.apply, input_key="x", label_key="y", top_k=(1, 3))
    want = jmetrics.evaluate_dataset(jstep, jstep.init(jparams), [full], metrics_fn=jm)
    tstate = tstep.init(tparams)
    got = tmetrics.evaluate_dataset(tstep, tstate, [full], metrics_fn=tm)
    assert sorted(got) == sorted(want) == ["examples", "loss", "top1", "top3"]
    for k in ("top1", "top3"):
        assert got[k] == pytest.approx(want[k], abs=1e-6)
    assert got["loss"] == pytest.approx(want["loss"], abs=LOSS_TOL, rel=LOSS_TOL)
    # The runner takes the stored (host) params and computes on the device view.
    direct = tstep.compile_metrics(tm, tstate)(tstate.params, full)
    assert float(direct["top1"]) == got["top1"]


# -------------------------------------------------------------- four ranks
def _jax_data_fit(builder, jspec, jparams, directory, local_batch, seed, eval_batch):
    """JAX's 4-device step fitted on the rank-ordered concatenation of four
    JAX loaders over ``slice_rows`` of the directory (what the port's ranks
    read with ``process_slice=True``), and its ``evaluate_dataset``."""
    from autodist_tpu import model_item as jmi
    from helpers.torch_dist import JGraphTransformer, JResourceSpec, JStep, jbuild_mesh

    ds = jfiles.load_dataset(directory)
    rows = sum(s.shape[0] for s in ds["x"]) // 4
    loaders = [JDataLoader(jfiles.slice_rows(ds, r * rows, (r + 1) * rows),
                           batch_size=local_batch, seed=seed, engine="python")
               for r in range(4)]
    batches = [{k: np.concatenate([b[k] for b in group]) for k in group[0]}
               for group in zip(*loaders)]
    rs = JResourceSpec(resource_dict={"nodes": [
        {"address": "localhost", "chips": 4, "chief": True}]})
    opt = jmi.OptimizerSpec("sgd", {"learning_rate": 0.05})
    item = jmi.ModelItem.from_params(jparams, optimizer_spec=opt, loss_fn=jspec.loss_fn,
                                     example_batch=batches[0])
    strategy = jstrat.StrategyCompiler(item).compile(jstrat.from_name(builder).build(item, rs))
    plan = JGraphTransformer(strategy, item, jbuild_mesh(rs, devices=jax.devices()[:4])
                             ).transform()
    step = JStep(plan, jspec.loss_fn, opt.make())
    state, hist = step.fit(step.init(jparams), iter(batches))
    mfn = jmetrics.classification_metrics(jspec.apply, input_key="x", label_key="y",
                                          top_k=(1, 2))
    evaluated = jmetrics.evaluate_dataset(step, state, [eval_batch], metrics_fn=mfn)
    return hist["loss"], jax.tree.map(np.asarray, step.logical_params(state)), evaluated


def test_four_ranks_process_slice_windowed_fit_equals_jax_4_device_step(tmp_path):
    """4 gloo ranks: ``DataLoader.from_files(process_slice=True)`` and
    ``fit(window=2)`` against JAX's 4-device step fed the rank-ordered
    concatenation of four JAX loaders over ``slice_rows``; the trained
    state's ``evaluate_dataset`` (``compile_metrics``), also on a padded
    plan (UnevenPartitionedPS pads the 13-wide layer over 4 ranks, JAX's
    ``test_metrics_on_padded_plan_uses_logical_params``); and
    ``fit(window>1)`` over a generic iterator raises at world size 4. The
    e2e tolerances of ``tests/helpers/torch_dist.py``."""
    from helpers import torch_dist as td

    cases, inputs, jax_side = [], {}, {}
    for cid, builder, dims in (("fit", "AllReduce", MLP),
                               ("padded", "UnevenPartitionedPS",
                                dict(in_dim=7, hidden=(13,), num_classes=4))):
        jspec = jax_get_model("mlp", **dims)
        jparams = jspec.init(jax.random.PRNGKey(1))
        np_params = jax.tree.map(np.asarray, jparams)
        rng = np.random.default_rng(len(cid))
        data = {"x": rng.standard_normal((96, dims["in_dim"])).astype(np.float32),
                "y": rng.integers(0, dims["num_classes"], 96).astype(np.int32)}
        directory = str(tmp_path / cid)
        jfiles.write_dataset(directory, data, shard_rows=20)
        eval_batch = {k: v[:32] for k, v in data.items()}
        inputs[cid] = (td.to_torch(np_params), td.to_torch({k: v[:16] for k, v in data.items()}))
        cases.append(dict(id=cid, model=cid, builder=builder, overrides=dims, opt="sgd",
                          opt_kwargs={"learning_rate": 0.05},
                          data_fit=dict(dir=directory, local_batch=4, seed=5, window=2,
                                        eval_batch=eval_batch)))
        jax_side[cid] = _jax_data_fit(builder, jspec, jparams, directory, 4, 5, eval_batch)
    results = td.run_ranks(tmp_path, inputs, cases)
    for c in cases:
        got = results[0][c["id"]]
        jlosses, jparams, jeval = jax_side[c["id"]]
        for rank, res in enumerate(results[1:], 1):
            assert res[c["id"]]["losses"] == got["losses"], rank
        assert got["engine"] == "native" and got["steps"] == len(jlosses) == 6
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
        td.assert_params_close(got["params"], td.flat_np(jparams), what=c["id"])
        assert sorted(got["evaluated"]) == sorted(jeval)
        for k in ("top1", "top2"):
            assert got["evaluated"][k] == pytest.approx(jeval[k], abs=1e-6)
        assert got["evaluated"]["loss"] == pytest.approx(jeval["loss"], rel=1e-5)
        assert "needs a DataLoader" in got["window_error"]
    assert results[0]["padded"]["padded"] and not results[0]["fit"]["padded"]
