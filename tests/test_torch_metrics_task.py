"""Port parity: the task metrics of ``autodist_tpu_torch/metrics.py`` and
the API's ``scope``, ``is_chief`` and ``function``.

The same logits, params and batches (made from a seed with numpy; model
weights carried over from JAX's ``init``) go through the JAX package's
metrics and the port's. Pure metrics of the same logits are equal exactly
(they count; ``top_k_accuracy`` reproduces ``lax.top_k``'s tie order by
rank). Metrics of a model's forward compare the two packages' logits, which
differ in summation order only: 1e-6 on accuracies (a count over the batch,
equal unless an argmax is within rounding of a tie, which these seeds
avoid) and the step-parity tests' 1e-5 on losses
(``tests/test_torch_train.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import autodist_tpu as jad
from autodist_tpu import api as japi
from autodist_tpu import metrics as jm
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu_torch import api as tapi
from autodist_tpu_torch import metrics as tm
from autodist_tpu_torch import strategy as tstrat
from autodist_tpu_torch.data import DataLoader
from autodist_tpu_torch.models import get_model_spec
from autodist_tpu_torch.models.convert import params_from_jax

from helpers.torch_threads import one_torch_thread  # noqa: F401

LOSS_TOL, ACC_TOL = 1e-5, 1e-6
MLP = dict(in_dim=8, hidden=(16,), num_classes=4)
LM = dict(vocab_size=53, num_layers=2, d_model=32, num_heads=2, d_ff=64, max_seq_len=16,
          attention_impl="dot")
NCF = dict(num_users=32, num_items=64, mf_dim=8, mlp_dims=(16, 8))


@pytest.fixture(autouse=True)
def _fresh_autodist():
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()
    yield
    japi.AutoDist.reset_default()
    tapi.AutoDist.reset_default()


def _t(x):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()} if isinstance(x, dict) \
        else torch.from_numpy(np.asarray(x))


def _pair(model, overrides):
    kw = {} if model in ("mlp", "ncf") else {"dtype": jnp.float32}
    jspec = jax_get_model(model, **kw, **overrides)
    tspec = get_model_spec(model, **({} if model in ("mlp", "ncf") else {"dtype": "float32"}),
                           **overrides)
    jparams = jspec.init(jax.random.PRNGKey(0))
    return jspec, jparams, tspec, params_from_jax(jax.tree.map(np.asarray, jparams),
                                                  device="cpu")


# ------------------------------------------------------------- pure metrics
def test_accuracy_and_top_k_hand_computed():
    logits = np.array([[5.0, 1.0, 0.0], [0.0, 3.0, 1.0], [1.0, 0.0, 2.0], [9.0, 8.0, 7.0]],
                      np.float32)
    labels = np.array([0, 1, 0, 2], np.int32)
    assert float(tm.accuracy(_t(logits), _t(labels))) == pytest.approx(0.5)
    assert float(tm.top_k_accuracy(_t(logits), _t(labels), 2)) == pytest.approx(0.75)
    assert tm.perplexity(np.log(7.0)) == pytest.approx(7.0)
    assert tm.perplexity(torch.tensor(np.log(7.0), dtype=torch.float32)) == \
        jm.perplexity(jnp.float32(np.log(7.0)))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_accuracy_and_top_k_with_ties_equal_jax(seed, k):
    """Integer logits in a small range tie often, at the k-th place too;
    ``lax.top_k`` takes the lower index first, and so does the port's
    rank count."""
    rng = np.random.default_rng(seed)
    logits = rng.integers(0, 4, (64, 7)).astype(np.float32)
    labels = rng.integers(0, 7, 64).astype(np.int32)
    # Rows whose label ties at the k-th place, so tie order decides them.
    own = logits[np.arange(64), labels]
    ahead = (logits > own[:, None]).sum(1)
    equal = (logits == own[:, None]).sum(1) - 1
    assert np.any((ahead < k) & (ahead + equal >= k))
    got = float(tm.top_k_accuracy(_t(logits), _t(labels), k))
    assert got == float(jm.top_k_accuracy(jnp.asarray(logits), jnp.asarray(labels), k))
    assert float(tm.accuracy(_t(logits), _t(labels))) == \
        float(jm.accuracy(jnp.asarray(logits), jnp.asarray(labels)))


def test_lm_metrics_shift_and_mask_hand_computed():
    tokens = np.array([[1, 2, 3], [1, 0, 0]], np.int32)

    def apply_fn(params, toks):
        pred = torch.where(torch.arange(toks.shape[0])[:, None] == 0,
                           torch.roll(toks, -1, dims=1), torch.tensor(3, dtype=toks.dtype))
        return torch.nn.functional.one_hot(pred.long(), 4).float() * 10.0

    assert float(tm.lm_metrics(apply_fn)(None, {"tokens": _t(tokens)})["token_accuracy"]) == 0.5
    out = tm.lm_metrics(apply_fn, pad_id=0)(None, {"tokens": _t(tokens)})
    assert float(out["token_accuracy"]) == 1.0 and float(out["token_accuracy__weight"]) == 2.0


@pytest.mark.parametrize("pad_id", [None, 0])
@pytest.mark.parametrize("shift", [True, False])
def test_lm_metrics_over_the_transformer_equal_jax(pad_id, shift):
    jspec, jparams, tspec, tparams = _pair("transformer", dict(LM, causal=True))
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, LM["vocab_size"], (8, LM["max_seq_len"])).astype(np.int32)
    tokens[:, 10:] = 0                                    # padding to mask
    tokens[0, 3] = 0
    want = jm.lm_metrics(jspec.apply, shift=shift, pad_id=pad_id)(jparams,
                                                                  {"tokens": tokens})
    got = tm.lm_metrics(tspec.apply, shift=shift, pad_id=pad_id)(tparams,
                                                                 {"tokens": _t(tokens)})
    assert sorted(got) == sorted(want)
    assert float(got["token_accuracy"]) == pytest.approx(float(want["token_accuracy"]),
                                                         abs=ACC_TOL)
    if pad_id is not None:
        assert float(got["token_accuracy__weight"]) == float(want["token_accuracy__weight"])


def test_ranking_metrics_hand_computed():
    table = torch.tensor([[0.9, 0.1, 0.2, 0.3], [0.5, 0.8, 0.2, 0.1], [0.1, 0.5, 0.6, 0.7]])
    batch = {"users": torch.arange(3), "candidates": torch.arange(4).repeat(3, 1)}
    out = tm.ranking_metrics(lambda p, u, i: table[u, i], k=2)(None, batch)
    assert float(out["hr@2"]) == pytest.approx(2 / 3)
    assert float(out["ndcg@2"]) == pytest.approx((1.0 + 1.0 / np.log2(3.0)) / 3.0, rel=1e-6)
    # A tie with the positive goes to the positive.
    tied = torch.tensor([[0.5, 0.5, 0.5, 0.9]])
    out = tm.ranking_metrics(lambda p, u, i: tied[u, i], k=2)(
        None, {"users": torch.zeros(1, dtype=torch.int64), "candidates": torch.arange(4)[None]})
    assert float(out["hr@2"]) == 1.0


def test_ranking_metrics_over_ncf_equal_jax():
    """The port scores the flattened [B*C] users and items in one call;
    JAX maps over the rows. Over the zoo NCF the metrics agree."""
    jspec, jparams, tspec, tparams = _pair("ncf", NCF)
    rng = np.random.default_rng(0)
    batch = {"users": np.arange(8, dtype=np.int32), "items": np.zeros(8, np.int32),
             "labels": np.ones(8, np.float32),
             "candidates": rng.integers(0, NCF["num_items"], (8, 10)).astype(np.int32)}
    jad_ = japi.AutoDist(strategy_builder=jad.strategy.PSLoadBalancing())
    jstep = jad_.build(jspec.loss_fn, jparams, jspec.example_batch(8),
                       sparse_names=jspec.sparse_names)
    tad = tapi.AutoDist(strategy_builder=tstrat.PSLoadBalancing(), device="cpu")
    tstep = tad.build(tspec.loss_fn, tparams, tspec.example_batch(8, device="cpu"),
                      sparse_names=tspec.sparse_names)
    for k in (1, 5):
        want = jm.evaluate_dataset(jstep, jstep.init(jparams), [batch], metrics_fn=jm.ranking_metrics(
            lambda p, u, i: jspec.apply(p, {"users": u, "items": i}), k=k))
        got = tm.evaluate_dataset(tstep, tstep.init(tparams), [batch], metrics_fn=tm.ranking_metrics(
            lambda p, u, i: tspec.apply(p, {"users": u, "items": i}), k=k))
        assert got["examples"] == want["examples"] == 8
        for name in (f"hr@{k}", f"ndcg@{k}"):
            assert got[name] == pytest.approx(want[name], abs=ACC_TOL), name
        assert got["loss"] == pytest.approx(want["loss"], abs=LOSS_TOL, rel=LOSS_TOL)


# ----------------------------------------------------------- aggregation
def _mlp_steps():
    jspec, jparams, tspec, tparams = _pair("mlp", MLP)
    jstep = japi.AutoDist(strategy_builder=jad.strategy.AllReduce()).build(
        jspec.loss_fn, jparams, jspec.example_batch(8))
    tstep = tapi.AutoDist(strategy_builder=tstrat.AllReduce(), device="cpu").build(
        tspec.loss_fn, tparams, tspec.example_batch(8, device="cpu"))
    return jspec, jstep, jstep.init(jparams), tspec, tstep, tstep.init(tparams)


def test_evaluate_dataset_weighted_average_equals_jax():
    jspec, jstep, jstate, tspec, tstep, tstate = _mlp_steps()
    rng = np.random.default_rng(5)
    full = {"x": rng.standard_normal((24, MLP["in_dim"])).astype(np.float32),
            "y": rng.integers(0, MLP["num_classes"], 24).astype(np.int32)}
    batches = [{k: v[:16] for k, v in full.items()}, {k: v[16:] for k, v in full.items()}]
    want = jm.evaluate_dataset(jstep, jstate, batches, metrics_fn=jm.classification_metrics(
        jspec.apply, input_key="x", label_key="y", top_k=(1, 2)))
    got = tm.evaluate_dataset(tstep, tstate, batches, metrics_fn=tm.classification_metrics(
        tspec.apply, input_key="x", label_key="y", top_k=(1, 2)))
    assert sorted(got) == sorted(want) and got["examples"] == 24
    for k in ("top1", "top2"):
        assert got[k] == pytest.approx(want[k], abs=ACC_TOL)
    assert got["loss"] == pytest.approx(want["loss"], abs=LOSS_TOL, rel=LOSS_TOL)
    # Weighted by rows: the whole set's loss.
    whole = float(tspec.loss_fn(tstep.logical_params(tstate), _t(full)))
    assert got["loss"] == pytest.approx(whole, rel=1e-5)
    # max_batches, and a DataLoader as the source (numpy batches).
    one = tm.evaluate_dataset(tstep, tstate, batches, max_batches=1)
    assert one["examples"] == 16 and sorted(one) == ["examples", "loss"]
    loader = DataLoader(full, batch_size=8, shuffle=False)
    assert tm.evaluate_dataset(tstep, tstate, loader)["loss"] == pytest.approx(got["loss"],
                                                                                 rel=1e-5)


def test_evaluate_dataset_lm_weights_by_valid_tokens_equal_jax():
    jspec, jparams, tspec, tparams = _pair("transformer", dict(LM, causal=True))
    rng = np.random.default_rng(3)
    batches = []
    for rows, valid in ((8, 12), (4, 5)):
        tokens = rng.integers(1, LM["vocab_size"], (rows, LM["max_seq_len"])).astype(np.int32)
        tokens[:, valid:] = 0
        batches.append({"tokens": tokens})
    jstep = japi.AutoDist(strategy_builder=jad.strategy.AllReduce()).build(
        jspec.loss_fn, jparams, batches[0])
    tstep = tapi.AutoDist(strategy_builder=tstrat.AllReduce(), device="cpu").build(
        tspec.loss_fn, tparams, _t(batches[0]))
    # JAX's step on its 8-device mesh evaluates a 4-row batch whole.
    want = jm.evaluate_dataset(jstep, jstep.init(jparams), batches,
                               metrics_fn=jm.lm_metrics(jspec.apply, pad_id=0))
    got = tm.evaluate_dataset(tstep, tstep.init(tparams), batches,
                              metrics_fn=tm.lm_metrics(tspec.apply, pad_id=0))
    assert got["examples"] == want["examples"] == 12
    assert got["token_accuracy"] == pytest.approx(want["token_accuracy"], abs=ACC_TOL)
    assert got["loss"] == pytest.approx(want["loss"], abs=LOSS_TOL, rel=LOSS_TOL)


def test_evaluate_dataset_empty_max_batches_and_weights():
    class FakeStep:
        def evaluate(self, state, batch):
            return {"loss": torch.tensor(2.0)}

    assert tm.evaluate_dataset(FakeStep(), None, []) == {"examples": 0}
    assert tm.evaluate_dataset(FakeStep(), None, [{"a": np.float32(1.0)}]) == {"examples": 0}
    got = tm.evaluate_dataset(FakeStep(), None, [{"x": np.zeros((4, 2))}] * 5, max_batches=2)
    assert got["examples"] == 8 and got["loss"] == pytest.approx(2.0)

    def mfn(params, batch):
        return {"token_accuracy": batch["acc"][0], "token_accuracy__weight": batch["n"][0]}

    batches = [{"acc": torch.tensor([1.0, 1.0]), "n": torch.tensor([2.0, 2.0])},
               {"acc": torch.tensor([0.5, 0.5]), "n": torch.tensor([8.0, 8.0])}]
    got = tm.evaluate_dataset(FakeStep(), None, batches, metrics_fn=mfn)
    assert got["token_accuracy"] == pytest.approx(0.6)
    assert tm._batch_size({"alpha": torch.tensor(0.5), "x": np.zeros((7, 3))}) == 7


# -------------------------------------------------------------------- API
def test_scope_is_chief_and_function():
    a = tapi.AutoDist(strategy_builder=tstrat.AllReduce(), device="cpu")
    with a.scope() as s:
        assert s is a
    assert a.is_chief

    @a.function
    def eval_step(x):
        return (x * 2).sum()

    with pytest.raises(RuntimeError, match="before .function"):
        eval_step(torch.ones((16, 2)))

    def loss_fn(params, batch):
        return ((batch["x"] @ params["w"]) ** 2).mean()

    a.build(loss_fn, {"w": torch.zeros((2, 1))}, {"x": torch.ones((16, 2))})
    out = eval_step(torch.ones((16, 2)))
    assert float(out) == 64.0 and out.device == a.plan.device
    assert float(a.function(lambda d: d["x"].sum() + d["y"][0])(
        {"x": np.ones((4, 2), np.float32), "y": (torch.tensor(1.0),)})) == 9.0


def test_is_chief_follows_the_worker_flag(monkeypatch):
    monkeypatch.setenv("AUTODIST_WORKER", "1")
    a = tapi.AutoDist(device="cpu")
    assert not a.is_chief
    b_chief = japi.AutoDist.is_chief.fget(None)
    assert b_chief is False
