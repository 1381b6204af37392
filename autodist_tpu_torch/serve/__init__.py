"""Paged-KV serving of the port: page pool, engine, continuous batcher and
HTTP front end (``python -m autodist_tpu_torch.serve``), with counter-based
stochastic sampling (``sampling.py``), speculative decode (``spec.py``),
copy-on-write prefix sharing (``prefix.py``), one supervised replica
(``replica.py``) and the fleet's router (``router.py``) with its front end
(``server.RouterFrontend``)."""
from autodist_tpu_torch.serve.replica import Replica, ReplicaState
from autodist_tpu_torch.serve.router import Router, RouterConfig, build_test_fleet, selftest_router
from autodist_tpu_torch.serve.server import RouterFrontend, ServeFrontend

__all__ = [
    "Replica",
    "ReplicaState",
    "Router",
    "RouterConfig",
    "RouterFrontend",
    "ServeFrontend",
    "build_test_fleet",
    "selftest_router",
]
