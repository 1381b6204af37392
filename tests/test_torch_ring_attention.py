"""Port parity of ring and Ulysses attention (``parallel/ring_attention.py``)
on 4 gloo ranks, one process each, against the JAX package's
``ring_attention`` / ``ulysses_attention`` on a mesh of the first 4 CPU
devices, from the same numpy inputs:

- forward and gradients of ``sum(out * g)`` with respect to q, k and v,
  causal and full, at seq 4 and at data 2 x seq 2, within JAX's own
  tolerances (``tests/test_parallel.py``: 2e-5 forward, 5e-5 gradients);
  every rank holds the whole output and the whole gradients;
- a mesh without a seq axis: both fall back to flash attention (here its
  plain path), equal to JAX's fallback;
- the two ``ValueError``s: heads not divisible by the seq axis (Ulysses)
  and a sequence not divisible by it;
- without a mesh or an AutoDist the call raises, as JAX's does.

The ranks are ``helpers/torch_parallel_worker.py`` started once for all
cases (``helpers/torch_dist.py``'s ``run_ranks``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from autodist_tpu.parallel import ring_attention as jring, ulysses_attention as julysses
from autodist_tpu_torch import api
from autodist_tpu_torch.parallel import ring_attention
from helpers import torch_dist as td

WORKER = td.WORKER.with_name("torch_parallel_worker.py")
FWD_TOL, GRAD_TOL = 2e-5, 5e-5
JAX_IMPLS = {"ring": jring, "ulysses": julysses}
SEQ4, DATA_SEQ = {"data": 1, "seq": 4}, {"data": 2, "seq": 2}
JAX_MESHES = {"seq4": ((1, 4), ("data", "seq")), "data2seq2": ((2, 2), ("data", "seq")),
              "data4": ((4,), ("data",))}


def qkv_inputs(b=2, s=32, h=4, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(4))


INPUTS = {"main": qkv_inputs(), "odd_seq": qkv_inputs(s=34), "three_heads": qkv_inputs(h=3)}
CASES = (
    [dict(id=f"{impl}/{'causal' if causal else 'full'}/{mname}", kind="attn", impl=impl,
          causal=causal, mesh=mesh, jmesh=mname, inputs="main")
     for impl in ("ring", "ulysses") for causal in (False, True)
     for mname, mesh in (("seq4", SEQ4), ("data2seq2", DATA_SEQ))]
    + [dict(id=f"{impl}/fallback", kind="attn", impl=impl, causal=True, mesh={"data": 4},
            jmesh="data4", inputs="main") for impl in ("ring", "ulysses")]
    + [dict(id="ulysses/indivisible_heads", kind="attn_error", impl="ulysses", mesh=SEQ4,
            inputs="three_heads"),
       dict(id="ring/indivisible_seq", kind="attn_error", impl="ring", mesh=SEQ4,
            inputs="odd_seq")])


def jax_mesh(name):
    shape, names = JAX_MESHES[name]
    return Mesh(np.array(jax.devices()[:4]).reshape(shape), names)


def jax_attention(c):
    q, k, v, g = (jnp.asarray(a) for a in INPUTS[c["inputs"]])
    fn = JAX_IMPLS[c["impl"]]
    mesh = jax_mesh(c["jmesh"])

    def loss(q_, k_, v_):
        return jnp.sum(fn(q_, k_, v_, causal=c["causal"], mesh=mesh) * g)

    out = jax.jit(lambda a, b, cc: fn(a, b, cc, causal=c["causal"], mesh=mesh))(q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(x) for x in grads]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return td.run_ranks(tmp_path_factory.mktemp("ranks"), INPUTS, CASES, worker=WORKER)


@pytest.mark.parametrize("c", [c for c in CASES if c["kind"] == "attn"], ids=lambda c: c["id"])
def test_matches_jax(c, ranks):
    want_out, want_grads = jax_attention(c)
    for rank, res in enumerate(ranks):
        got = res[c["id"]]
        np.testing.assert_allclose(got["out"], want_out, rtol=FWD_TOL, atol=FWD_TOL,
                                   err_msg=f"rank {rank} out")
        for name, want in zip(("dq", "dk", "dv"), want_grads):
            np.testing.assert_allclose(got[name], want, rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=f"rank {rank} {name}")


def test_errors(ranks):
    for res in ranks:
        assert "divisible" in res["ulysses/indivisible_heads"]["error"]
        assert "not divisible" in res["ring/indivisible_seq"]["error"]
    q, k, v, _ = (jnp.asarray(a) for a in INPUTS["three_heads"])
    with pytest.raises(ValueError, match="divisible"):
        jax.jit(lambda a, b, c: julysses(a, b, c, mesh=jax_mesh("seq4")))(q, k, v)
    q, k, v, _ = (jnp.asarray(a) for a in INPUTS["odd_seq"])
    with pytest.raises(ValueError, match="not divisible"):
        jring(q, k, v, mesh=jax_mesh("seq4"))


def test_needs_a_mesh():
    api.AutoDist.reset_default()
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="needs a mesh"):
        ring_attention(q, q, q)
