"""Port parity of the synchronizer's options at 4 gloo ranks (one process
each, on the CPU) against JAX's step on a 4-device mesh from the same
state: the gradient compressors under AllReduce and bounded staleness under
PartitionedPS, on the zoo ``mlp`` (32-64-64-10: its 64x64 kernel reaches
TopK's ``min_size`` of 4096) and a small bert_base (fp32, 2 layers,
d_model 64, seq 16, global batch 8; TopK sparsifies its 64x128 kernels).

JAX's compressor state (PowerSGD's ``q``, EF's residuals) is carried to
every rank (``convert.comp_state_from_jax``). Held, each case:

- the 4 ranks' parameters bitwise equal, and each step's wire equal to the
  plan's prediction (PowerSGD two all-reduces a matrix, TopK two
  all-gathers a sparsified tensor);
- PowerSGD and TopK (two SGD steps) and PartitionedPS with ``staleness=2``
  (four, so that delayed gradients land) against JAX within rtol 1e-4 /
  atol 1e-6 (fp32 summation order), the new compressor state and each
  rank's delay buffers (cut to its block by
  ``convert.stale_state_from_jax``) within the same;
- the bf16 wire of Horovod (one step) and EF (one step from the initial
  state and one from JAX's state after that step) element by element
  within ``lr x BF16_SUM_STEPS x 2^-8 x sum_r |c_r| / 4`` of JAX, ``c_r``
  being rank r's bf16 payload (from JAX's local gradients). XLA's CPU
  all-reduce of bf16 sums in fp32 and rounds once; gloo rounds its partial
  sums to bf16 as it goes. Each rounding moves a sum by at most one bf16
  step (2^-8 relative) of the magnitudes summed, so 3 roundings on gloo's
  side and 1 on XLA's give 4: measured 2.90 over 100,000 sums of 4 normal
  payloads (``test_bf16_sum_bound``);
- each rank's EF residual within one bf16 step of its input
  (``2^-7 |inp_r|``) of JAX's row, and within 1e-6 in all but
  ``EF_FLIP_SHARE`` (1%) of a case's residual elements: an input that lies
  within the two sides' fp32 difference of a bf16 rounding boundary (their
  local gradients sum in other orders) rounds the other way on one side
  (161 of 268,288 of bert's, 0.06%, measured; the synced parameters came
  within 0.58 of their bound).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from autodist_tpu import model_item as jmi
from autodist_tpu import strategy as jstrat
from autodist_tpu.kernel import DistributedTrainStep as JStep
from autodist_tpu.kernel import GraphTransformer as JGraphTransformer
from autodist_tpu.kernel import build_mesh as jbuild_mesh
from autodist_tpu.models import get_model as jax_get_model
from autodist_tpu.resource_spec import ResourceSpec as JResourceSpec
from autodist_tpu.utils.compat import shard_map
from autodist_tpu_torch.models.convert import (params_from_jax, stale_state_from_jax,
                                                unflatten_params)
from helpers import torch_dist as td

RTOL, ATOL = 1e-4, 1e-6
BF16_STEP = 2.0 ** -8
BF16_SUM_STEPS = 4
EF_FLIP_SHARE = 1e-2
N = 4
LR = 0.05
BERT = dict(vocab_size=101, num_layers=2, d_model=64, num_heads=1, d_ff=128,
            max_seq_len=16, attention_impl="dot")
MODELS = {"mlp": ("mlp", {}, 16), "bert": ("bert_base", dict(BERT, dtype="float32"), 8)}


def _case(model, builder, kwargs, steps, tag, inputs=None):
    zoo, overrides, _ = MODELS[model]
    return dict(id=f"{model}/{builder}/{tag}", model=inputs or model, base=model, zoo=zoo,
                overrides=overrides, builder=builder, builder_kwargs=kwargs, opt="sgd",
                opt_kwargs={"learning_rate": LR}, clip_norm=None, steps=steps)


def _cases():
    out = []
    for m in MODELS:
        out += [_case(m, "AllReduce", {"compressor": "HorovodCompressor"}, 1, "Horovod"),
                _case(m, "AllReduce", {"compressor": "HorovodCompressorEF"}, 1, "EF"),
                _case(m, "AllReduce", {"compressor": "HorovodCompressorEF"}, 1, "EF-step2",
                      inputs=f"{m}@ef1"),
                _case(m, "AllReduce", {"compressor": "PowerSGDCompressor"}, 2, "PowerSGD"),
                _case(m, "AllReduce", {"compressor": "TopKCompressor"}, 2, "TopK"),
                _case(m, "PartitionedPS", {"staleness": 2}, 4, "staleness2")]
    return out


CASES = _cases()


def _filled(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return np.ones(leaf.shape, np.float32)
        if "bias" in name:
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        std = np.sqrt(2.0 / np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 0.1
        return (rng.standard_normal(leaf.shape) * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _jax_step(c, params, batch, loss_fn):
    rs = JResourceSpec(resource_dict={"nodes": [
        {"address": "localhost", "chips": N, "chief": True}]})
    opt = jmi.OptimizerSpec(c["opt"], dict(c["opt_kwargs"]))
    item = jmi.ModelItem.from_params(params, optimizer_spec=opt, loss_fn=loss_fn,
                                     example_batch=batch)
    strategy = jstrat.StrategyCompiler(item).compile(
        jstrat.from_name(c["builder"], **c["builder_kwargs"]).build(item, rs))
    plan = JGraphTransformer(strategy, item, jbuild_mesh(rs, devices=jax.devices()[:N])
                             ).transform()
    return JStep(plan, loss_fn, opt.make())


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _local_grads(loss_fn, params, batch):
    """Each rank's local-mean gradient (JAX), flat by name."""
    rows = len(jax.tree.leaves(batch)[0])
    out = []
    for r in range(N):
        block = jax.tree.map(lambda x: x[r * rows // N:(r + 1) * rows // N], batch)
        out.append(td.flat_np(_np(jax.grad(loss_fn)(params, block))))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    np_inputs, specs = {}, {}
    for key, (zoo, _, batch) in MODELS.items():
        spec = jax_get_model(zoo, **(dict(BERT, dtype=jnp.float32)
                                     if zoo == "bert_base" else {}))
        np_inputs[key] = (_filled(jax.eval_shape(spec.init, jax.random.PRNGKey(0)), 1),
                          _np(spec.example_batch(batch)))
        specs[key] = spec
    cases, ref = [], {}
    for c in CASES:
        if c["id"].endswith("EF-step2"):
            continue
        params, batch = np_inputs[c["base"]]
        step = _jax_step(c, params, batch, specs[c["base"]].loss_fn)
        state = step.init(params)
        comp0 = _np(state.comp_state)
        losses, trajectory, comps = [], [], []
        for _ in range(c["steps"] + (1 if c["id"].endswith("/EF") else 0)):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            trajectory.append(td.flat_np(_np(step.logical_params(state))))
            comps.append(_np(state.comp_state))
        cases.append(dict(c, comp_state=comp0 or None))
        ref[c["id"]] = dict(losses=losses[:c["steps"]], params=trajectory[c["steps"] - 1],
                            comp=comps[c["steps"] - 1], stale=_np(state.stale_state),
                            comp_before=comp0, params_before=params)
        if c["id"].endswith("/EF"):
            # The second EF step, from JAX's state after the first.
            nxt = next(x for x in CASES if x["id"] == c["id"] + "-step2")
            params1 = unflatten_params(trajectory[0])
            np_inputs[nxt["model"]] = (params1, batch)
            cases.append(dict(nxt, comp_state=comps[0]))
            ref[nxt["id"]] = dict(losses=losses[1:2], params=trajectory[1], comp=comps[1],
                                  stale={}, comp_before=comps[0], params_before=params1)
    torch_inputs = {k: (params_from_jax(p, device="cpu"), td.to_torch(b))
                    for k, (p, b) in np_inputs.items()}
    results = td.run_ranks(tmp_path_factory.mktemp("ranks"), torch_inputs, cases)
    return results, np_inputs, specs, ref


def _check_ranks_and_wire(c, results):
    got = results[0][c["id"]]
    for rank, res in enumerate(results[1:], 1):
        for name, value in got["params"].items():
            np.testing.assert_array_equal(res[c["id"]]["params"][name], value,
                                          err_msg=f"rank {rank} {name}")
    for counts in got["collectives"]:
        assert td.wire_counts(counts) == got["predicted"], (counts, got["predicted"])
        assert counts["metric"] == {"all_reduce": 1}
    return got


def _residual(comp_state, name, rank):
    """Rank ``rank``'s EF residual of ``name`` in JAX's state (0 without)."""
    res = comp_state.get(name, {}).get("local", {}).get("residual")
    return 0.0 if res is None else res[rank]


FP32_CASES = [c for c in CASES if not c["id"].split("/")[-1].startswith(("Horovod", "EF"))]
BF16_CASES = [c for c in CASES if c not in FP32_CASES]


@pytest.mark.parametrize("c", FP32_CASES, ids=[c["id"] for c in FP32_CASES])
def test_fp32_wire_options_match_jax(c, runs):
    results, _, _, ref = runs
    got = _check_ranks_and_wire(c, results)
    want = ref[c["id"]]
    td.assert_params_close(got["params"], want["params"], rtol=RTOL, atol=ATOL, what=c["id"])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert sorted(got["comp_state"]) == sorted(want["comp"])
    for rank, res in enumerate(results):
        for name, st in res[c["id"]]["comp_state"].items():
            for part in ("local", "shared"):
                for k, t in st[part].items():
                    w = want["comp"][name][part][k]
                    np.testing.assert_allclose(t, w[rank] if part == "local" else w,
                                               rtol=RTOL, atol=ATOL,
                                               err_msg=f"{name} rank {rank} {part} {k}")
        carried = stale_state_from_jax(want["stale"], res[c["id"]]["renderings"], N, rank,
                                       device="cpu")
        assert sorted(res[c["id"]]["stale_state"]) == sorted(carried)
        for name, buf in res[c["id"]]["stale_state"].items():
            np.testing.assert_allclose(buf, carried[name].numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} rank {rank}")
    if c["builder"] == "PartitionedPS":
        assert got["stale_state"] and got["losses"][0] == got["losses"][1]  # 2 steps of 0


@pytest.mark.parametrize("c", BF16_CASES, ids=[c["id"] for c in BF16_CASES])
def test_bf16_wire_within_rounding_bound_of_jax(c, runs):
    results, np_inputs, specs, ref = runs
    got = _check_ranks_and_wire(c, results)
    want = ref[c["id"]]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    grads = _local_grads(specs[c["base"]].loss_fn, want["params_before"],
                         np_inputs[c["base"]][1])
    inputs = [{n: g + _residual(want["comp_before"], n, r) for n, g in grads[r].items()}
              for r in range(N)]
    bf16 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).bfloat16().float().numpy()
    for name, w in want["params"].items():
        mag = sum(np.abs(bf16(inputs[r][name])) for r in range(N))
        bound = LR * BF16_SUM_STEPS * BF16_STEP * mag / N + 2.0 ** -22 * np.abs(w) + 1e-7
        err = np.abs(got["params"][name] - w)
        assert (err <= bound).all(), (name, float((err / bound).max()))
    flips = total = 0
    for rank, res in enumerate(results):
        for name, st in res[c["id"]]["comp_state"].items():
            for k, t in st["local"].items():
                diff = np.abs(t - want["comp"][name]["local"][k][rank])
                assert (diff <= 2.0 ** -7 * np.abs(inputs[rank][name]) + 1e-6).all(), name
                flips, total = flips + int((diff > 1e-6).sum()), total + diff.size
    assert flips <= EF_FLIP_SHARE * total, (flips, total)


def test_bf16_sum_bound():
    """XLA's CPU all-reduce of bf16 on 4 devices rounds the fp32 sum once;
    gloo's, summing the same payloads, lies within ``BF16_SUM_STEPS`` bf16
    steps of the magnitudes summed from it (2.90 measured at 100,000 sums
    of 4 normal payloads); here the same held against numpy's sequential
    bf16 sum, which rounds as gloo's ring does at each of its 3 additions."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((N, 20000)).astype(np.float32)).astype(jnp.bfloat16)
    P = jax.sharding.PartitionSpec
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:N]), ("data",))
    psum = jax.jit(shard_map(lambda a: jax.lax.psum(a, "data"), mesh=mesh, in_specs=P("data"),
                             out_specs=P(), axis_names={"data"}, check_vma=False))
    got = np.asarray(psum(x).astype(jnp.float32)).reshape(-1)
    xf = np.asarray(x.astype(jnp.float32))
    once = np.asarray(jnp.asarray(xf.sum(0, dtype=np.float64).astype(np.float32))
                      .astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got, once)        # XLA: fp32 sum, one rounding
    seq = xf[0]
    for r in range(1, N):
        seq = np.asarray(jnp.asarray(seq + xf[r]).astype(jnp.bfloat16).astype(jnp.float32))
    ratio = np.abs(seq - got) / (BF16_STEP * np.abs(xf).sum(0))
    assert ratio.max() <= BF16_SUM_STEPS and ratio.max() > 1.0
