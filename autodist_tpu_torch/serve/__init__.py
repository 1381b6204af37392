"""Paged-KV serving of the port: page pool, engine (with the one-shot
``infer`` and the bucketed baseline engine), continuous batcher and HTTP
front end (``python -m autodist_tpu_torch.serve``; ``--selftest`` the
single-engine proof), with counter-based stochastic sampling
(``sampling.py``), speculative decode (``spec.py``), copy-on-write prefix
sharing (``prefix.py``), one supervised replica (``replica.py``) and the
fleet's router (``router.py``) with its front end
(``server.RouterFrontend``)."""
from autodist_tpu_torch.serve.engine import BucketedInferenceEngine, BucketSlot
from autodist_tpu_torch.serve.replica import Replica, ReplicaState
from autodist_tpu_torch.serve.router import Router, RouterConfig, build_test_fleet, selftest_router
from autodist_tpu_torch.serve.server import RouterFrontend, ServeFrontend

__all__ = [
    "BucketSlot",
    "BucketedInferenceEngine",
    "Replica",
    "ReplicaState",
    "Router",
    "RouterConfig",
    "RouterFrontend",
    "ServeFrontend",
    "build_test_fleet",
    "selftest_router",
]
