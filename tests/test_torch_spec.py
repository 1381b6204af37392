"""Port parity: the speculative engine (``serve/spec.py``) against the JAX
package's, with the same-weights draft: ``SpecDecodeEngine`` greedy
streams equal plain greedy and JAX's spec engine (``spec._SelftestRig``,
weights carried over) for k in {1, 2, 4, 8}, with target invocations and
accepted proposals equal to JAX's on the same workload and both pools
balanced. The divergent 1-layer draft: ``tests/test_torch_spec_divergent.py``;
the verify forward, stochastic spec, the draft pool's accounting and prefix
sharing: ``tests/test_torch_spec_rounds.py``.
"""
import pytest
from helpers.torch_threads import one_torch_thread  # noqa: F401
from helpers.torch_spec import expected, port, prompts, rig  # noqa: F401
from helpers.torch_spec import check_greedy_streams


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_greedy_streams_equal_plain_and_jax_spec(rig, port, prompts, expected, k):
    check_greedy_streams(rig, port, prompts, expected, k, same_draft=True)
