"""Port parity of the multi-rank step: the ``tests/test_e2e_numeric.py``
matrix on 4 gloo ranks (one process each, on the CPU).

Every ported builder (``helpers/torch_dist.py``: PS with and without a
proxy, PSLoadBalancing, PartitionedPS, UnevenPartitionedPS, AllReduce with
and without buckets, PartitionedAR, RandomAxisPartitionAR, Parallax, Zero1
with and without buckets) x the dense and embedding models x SGD (one step)
and Adam and SGD with ``clip_norm`` (three steps), from the same numpy
params and global batch of 16:

- the 4 ranks' parameters are bitwise equal;
- they equal JAX's step on a 4-device mesh and the port's one-process step
  within rtol 2e-5 / atol 2e-6 (``test_e2e_numeric.py``'s), the losses
  within 1e-5;
- each step's gradient and parameter collectives, by kind, equal the
  plan's prediction (``ShardingPlan.collectives_per_step``), and the loss
  is one all-reduce; a ZeRO-1 variable issues a reduce-scatter and an
  all-gather and no all-reduce.

The ranks run once for the module (``run_ranks``: a group timeout and a
join timeout that fails the test); lamb and adafactor are in
``test_torch_dist_e2e_opt.py``.
"""
import pytest

from helpers import torch_dist as td

OPTS = ("sgd", "adam", "clip_norm")
CASES = [td.case(f"{bid}/{model}/{opt}", model, builder, kwargs, opt)
         for bid, builder, kwargs in td.BUILDERS for model in ("dense", "embed")
         for opt in OPTS]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    np_inputs = td.inputs()
    torch_inputs = {k: (td.to_torch(p), td.to_torch(b)) for k, (p, b) in np_inputs.items()}
    results = td.run_ranks(tmp_path_factory.mktemp("ranks"), torch_inputs, CASES)
    return results, np_inputs, torch_inputs


@pytest.mark.parametrize("c", CASES, ids=[c["id"] for c in CASES])
def test_four_ranks_match_jax_and_one_process(c, runs):
    td.check_case(c, *runs)


@pytest.mark.parametrize("bid", [b[0] for b in td.BUILDERS])
def test_zero1_wire_is_reduce_scatter_and_all_gather(bid, runs):
    """Per step: one all-reduce per replicated variable (or bucket of
    them), never one for a ZeRO-1 or sharded variable, which reduce-scatter
    their gradient and all-gather their values. A table split by rows in
    the GSPMD semantics (``sparse``) issues none of these: its touched rows
    move under the ``sparse`` purpose."""
    results = runs[0][0]
    for model in ("dense", "embed"):
        got = results[f"{bid}/{model}/adam"]
        kinds = [kind for kind, _ in got["renderings"].values() if kind != "sparse"]
        if len(kinds) < len(got["renderings"]):
            assert all(counts["sparse"] == {"all_gather": 2, "reduce_scatter": 1}
                       for counts in got["collectives"]), got["collectives"]
        replicated = kinds.count("replicated")
        want = {"all_gather": len(kinds) - replicated}
        if "buckets" not in bid:
            want.update(all_reduce=replicated, reduce_scatter=len(kinds) - replicated)
        assert {k: got["predicted"][k] for k in want} == want
        for counts in got["collectives"]:
            assert td.wire_counts(counts) == got["predicted"]
    if bid.startswith("Zero1"):
        # w (12, 5) shards its 12 rows over 4 ranks; b (5,) has no axis 4
        # divides and stays replicated (the "non_divisible" degradation).
        assert results[f"{bid}/dense/adam"]["renderings"] == {
            "b": ("replicated", None), "w": ("zero1", 0)}
