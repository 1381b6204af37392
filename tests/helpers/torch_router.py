"""Shared pieces of the router parity tests (``tests/test_torch_router.py``,
``tests/test_torch_router_slo.py``): the JAX package's test-fleet weights
(``serve/router.py::build_test_fleet``: its tiny fp32 transformer, vocab
128, 1 layer, d 32, seeds ``PRNGKey(0)`` for the target and ``PRNGKey(9)``
for the speculative draft) carried into the port's ``build_test_fleet`` on
the CPU, and the stub engines both packages' routing tests use."""
import functools
import os
import tempfile
from types import SimpleNamespace

import jax
import numpy as np

from autodist_tpu import metrics as JM
from autodist_tpu.ft.heartbeat import MemoryTransport as JTransport
from autodist_tpu.serve.engine import AdmissionDenied as JDenied
from autodist_tpu.serve.replica import Replica as JReplica
from autodist_tpu.serve.router import Router as JRouter
from autodist_tpu.serve.router import RouterConfig as JConfig
from autodist_tpu.serve.router import _tiny_router_cfg
from autodist_tpu_torch import metrics as M
from autodist_tpu_torch.ft.heartbeat import MemoryTransport
from autodist_tpu_torch.models.convert import params_from_jax
from autodist_tpu_torch.serve.engine import AdmissionDenied
from autodist_tpu_torch.serve.replica import Replica
from autodist_tpu_torch.serve.router import Router, RouterConfig, build_test_fleet

#: The routing tests' cadences (``tests/test_router.py::FAST``).
FAST = dict(heartbeat_interval_s=0.02, health_interval_s=0.01,
            suspect_after_misses=2, dead_after_misses=4, dispatch_interval_s=0.002)


@functools.lru_cache(maxsize=None)
def jax_fleet_params(seed: int = 0):
    """The JAX test fleet's weights (``init_params(PRNGKey(seed), cfg)``)
    as a nested dict of numpy arrays."""
    from autodist_tpu.models.transformer import init_params

    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(seed),
                                                _tiny_router_cfg()))


def port_fleet(**kw):
    """The port's ``build_test_fleet`` on the CPU over the JAX fleet's
    weights (and its draft's with ``spec_decode=True``)."""
    kw.setdefault("device", "cpu")
    kw.setdefault("params", params_from_jax(jax_fleet_params(0), device="cpu"))
    if kw.get("spec_decode"):
        kw.setdefault("draft_params", params_from_jax(jax_fleet_params(9), device="cpu"))
    return build_test_fleet(**kw)


def stub_engine(denied):
    """Enough engine for admission and queueing, no device work: admission
    always defers, so dispatched work parks in the replica queue where a
    test sees WHERE the router sent it (``tests/test_router.py:44``)."""

    class Stub:
        decode_model = SimpleNamespace(eos_id=None)
        n_slots, max_len, chaos_host = 4, 64, 0
        page_utilization = page_fragmentation = 0.0
        active_slots = prefilling_slots = decoding_slots = 0
        prefix_cache, kv_quant = None, False
        pool = SimpleNamespace(free_pages=0, used_pages=0, utilization=0.0)

        @staticmethod
        def check_admissible(prompt_len, max_new_tokens):
            if prompt_len + max_new_tokens > 64:
                return denied("over stub ceiling", retryable=False)
            return None

        @staticmethod
        def admit(prompt, max_new_tokens, request_id="", sampling=None):
            return denied("no free row (stub)", retryable=True)

        @staticmethod
        def prefill_pending():
            return []

        @staticmethod
        def release(slot):
            pass

    return Stub


def stub_routers(n=3, replica_queue=64, **cfg):
    """``(port router, JAX router)`` over stub replicas with the same
    ``RouterConfig`` (``FAST`` updated by ``cfg``)."""
    conf = dict(FAST, **cfg)
    workdir = tempfile.mkdtemp(prefix="router-stub-")
    out = []
    for pkg, rep_cls, tr_cls, reg_cls, r_cls, c_cls, denied in (
            ("port", Replica, MemoryTransport, M.MetricsRegistry, Router, RouterConfig,
             AdmissionDenied),
            ("jax", JReplica, JTransport, JM.MetricsRegistry, JRouter, JConfig, JDenied)):
        config = c_cls(**conf)
        transport = tr_cls()
        replicas = {
            rid: rep_cls(rid, stub_engine(denied), transport,
                         persist_path=os.path.join(workdir, f"{pkg}-r{rid}.json"),
                         max_queue=replica_queue,
                         heartbeat_interval_s=config.heartbeat_interval_s,
                         registry=reg_cls())
            for rid in range(n)}
        out.append(r_cls(replicas, transport, config=config, registry=reg_cls()))
    return tuple(out)
