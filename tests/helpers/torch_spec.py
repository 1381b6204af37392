"""Shared pieces of the speculative-decode parity tests
(``tests/test_torch_spec.py``, ``tests/test_torch_spec_rounds.py``): the JAX
package's spec selftest rig, its prompts and greedy streams, and the port's
engines over the rig's weights. The fixtures are module-scoped in each
importing test module."""
import jax
import numpy as np
import pytest

from autodist_tpu.serve.spec import _SelftestRig
from autodist_tpu_torch.models import get_model
from autodist_tpu_torch.models import transformer as tt
from autodist_tpu_torch.models.convert import params_from_jax
from autodist_tpu_torch.serve.engine import InferenceEngine
from autodist_tpu_torch.serve.spec import SpecDecodeEngine

MAX_NEW = 10


def tcfg(num_layers=2, **kw):
    """The port's config of the rig's models (the draft has 1 layer)."""
    return get_model("transformer", vocab_size=128, num_layers=num_layers, d_model=32,
                     num_heads=2, d_ff=64, max_seq_len=64, dtype="float32", **kw)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def rig():
    return _SelftestRig()


@pytest.fixture(scope="module")
def prompts():
    """Short, one page, a chunk boundary, multi-chunk and page-crossing."""
    rng = np.random.default_rng(3)
    return [np.array([5, 17, 3, 88, 2], np.int32)] + [
        rng.integers(1, 127, size=n).astype(np.int32) for n in (8, 16, 21, 11)]


@pytest.fixture(scope="module")
def port(rig):
    """``(plain engine, spec(k, same_draft, **kw) factory)`` of the port over
    the rig's target and draft weights."""
    target = params_from_jax(np_tree(rig.params), device="cpu")
    draft = params_from_jax(np_tree(rig.draft_params), device="cpu")
    kw = dict(n_slots=8, page_len=8, n_pages=rig.n_pages, prefill_chunk=8, device="cpu")

    def spec(k, same_draft, **extra):
        return SpecDecodeEngine(
            target, tt.decode_model(tcfg()), target if same_draft else draft,
            tt.decode_model(tcfg(2 if same_draft else 1)), spec_k=k,
            draft_n_pages=extra.pop("draft_n_pages", rig.draft_n_pages),
            **dict(kw, **extra))

    return InferenceEngine(target, tt.decode_model(tcfg()), **kw), spec


@pytest.fixture(scope="module")
def expected(rig, prompts):
    """The JAX plain engine's greedy streams of ``prompts``."""
    return [rig.plain.generate(p, MAX_NEW) for p in prompts]


def check_greedy_streams(rig, port, prompts, expected, k, same_draft):
    """The port's spec streams equal plain greedy (the port's and JAX's)
    and JAX's spec engine's, with the same target invocations and accepted
    proposals; a same-weights draft accepts everything; pools balance."""
    from autodist_tpu_torch.serve.spec import pools_balanced

    plain, spec_engine = port
    assert [plain.generate(p, MAX_NEW) for p in prompts] == expected
    spec = spec_engine(k, same_draft)
    jspec = rig.spec_engine(k, same_draft=same_draft)
    assert [spec.generate(p, MAX_NEW) for p in prompts] == expected
    assert [jspec.generate(p, MAX_NEW) for p in prompts] == expected
    assert spec.target_invocations == jspec.target_invocations
    assert spec.spec_stats()["accepted"] == jspec.spec_stats()["accepted"]
    assert spec.verify_invocations == spec.spec_rounds
    if same_draft:
        assert spec.acceptance_rate == 1.0
    assert pools_balanced(spec)
