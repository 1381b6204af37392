"""Runtime layer of the port: the ``torch.distributed`` process group
(``process_group``), the host-driven asynchronous PS (``async_ps``), and
the fleet: the per-GPU process table (``cluster``), the launch and watch of
the other nodes (``coordinator``) and the supervised launcher
(``launcher``, ``python -m autodist_tpu_torch.runtime.launcher``)."""
from autodist_tpu_torch.runtime.cluster import Cluster
from autodist_tpu_torch.runtime.coordinator import Coordinator

__all__ = ["Cluster", "Coordinator", "launch", "main"]


def __getattr__(name):
    # The launcher loads on first use, so ``python -m
    # autodist_tpu_torch.runtime.launcher`` finds it not yet imported.
    if name in ("launch", "main"):
        from autodist_tpu_torch.runtime import launcher

        return getattr(launcher, name)
    raise AttributeError(name)
