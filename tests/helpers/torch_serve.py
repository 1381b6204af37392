"""Shared pieces of the serving-resilience parity tests
(``tests/test_torch_{drain,serve_flight,replica}.py``): the JAX package's
tiny serving engine (``serve/server.py::_tiny_engine``: fp32, vocab 128, 2
layers, d 32, page_len 8) and the port's engine over the same weights on
the CPU, and helpers to read both packages' flight records."""
import jax
import numpy as np

from autodist_tpu.serve.server import _N_PAGES, _PAGE_LEN, _tiny_engine
from autodist_tpu_torch.models import get_model
from autodist_tpu_torch.models.convert import params_from_jax
from autodist_tpu_torch.models.transformer import decode_model
from autodist_tpu_torch.serve.engine import InferenceEngine

TINY = dict(vocab_size=128, num_layers=2, d_model=32, num_heads=2, d_ff=64,
            max_seq_len=64, dtype="float32")


def port_engine(jparams, n_slots=32, n_pages=_N_PAGES):
    """The port's engine over the JAX tiny engine's weights (``device="cpu"``)."""
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return InferenceEngine(params, decode_model(get_model("transformer", **TINY)),
                           n_slots=n_slots, page_len=_PAGE_LEN, n_pages=n_pages,
                           prefill_chunk=_PAGE_LEN, device="cpu")


def engine_pair(n_slots=32, n_pages=_N_PAGES):
    """``(JAX engine, port engine)`` over the same weights and geometry (the
    JAX engine rounds its rows up to the test mesh's 8 devices; the port's
    takes that count)."""
    jeng, jparams, _ = _tiny_engine(n_slots=n_slots, n_pages=n_pages)
    return jeng, port_engine(jparams, n_slots=jeng.n_slots, n_pages=n_pages)


def prompts(n, seed=0, lo=3, hi=20):
    """``n`` seeded prompts of ``lo``..``hi - 1`` tokens in ``[1, 127)``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 127, size=int(rng.integers(lo, hi))).astype(np.int32)
            for _ in range(n)]


#: Fields every flight record carries from its recorder, not its call site.
RECORDER_FIELDS = {"t", "r"}


def record_shapes(records):
    """``{(kind, event): sorted call-site field names}`` of a record stream
    (the recorder's own stamp fields left out)."""
    out = {}
    for r in records:
        key = (r.get("kind"), r.get("event"))
        out.setdefault(key, set()).update(set(r) - RECORDER_FIELDS)
    return {k: sorted(v) for k, v in out.items()}
