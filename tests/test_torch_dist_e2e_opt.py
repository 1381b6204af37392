"""Port parity of the multi-rank step under the optimizers that reduce over
whole tensors: lamb (trust ratio) and adafactor (factored statistics,
update clipping, parameter scale), three steps on 4 gloo ranks, every
ported builder x the dense and embedding models, against JAX's 4-device
step and the port's one-process step (``helpers/torch_dist.py``; the
matrix and tolerances of ``test_torch_dist_e2e.py``). Under a sharded
update the optimizer's sums over a whole tensor add their blocks' partial
sums over the group (``Optimizer.update``'s ``psum``)."""
import pytest

from helpers import torch_dist as td

OPTS = ("lamb", "adafactor")
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
