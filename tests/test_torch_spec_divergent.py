"""Port parity: the speculative engine (``serve/spec.py``) against the JAX
package's with the divergent draft (1 layer, its own seeded weights, real
rejections on most rounds): greedy streams equal plain greedy and JAX's
spec engine for k in {1, 2, 4, 8}, target invocations and accepted
proposals equal to JAX's, both pools balanced."""
import pytest
from helpers.torch_threads import one_torch_thread  # noqa: F401
from helpers.torch_spec import expected, port, prompts, rig  # noqa: F401
from helpers.torch_spec import check_greedy_streams


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_greedy_streams_equal_plain_and_jax_spec_divergent(rig, port, prompts,
                                                           expected, k):
    check_greedy_streams(rig, port, prompts, expected, k, same_draft=False)
