"""Constants and environment-variable contract (PyTorch port).

The port's copy of the JAX package's ``const.py``: working directories, mesh
axis names and the typed ``ENV`` contract whose ``AUTODIST_WORKER`` /
``AUTODIST_STRATEGY_ID`` pair keeps the "chief builds the strategy, workers
load it by id" model. The working directory sits under the process's
temporary directory (``TMPDIR``), so nothing is written outside it.
"""
import os
import tempfile

DEFAULT_WORKING_DIR = os.path.join(tempfile.gettempdir(), "autodist-torch")
DEFAULT_STRATEGY_DIR = os.path.join(DEFAULT_WORKING_DIR, "strategies")
DEFAULT_CHECKPOINT_DIR = os.path.join(DEFAULT_WORKING_DIR, "checkpoints")

# The checkpoint writer's barriers on the group's store: a slow or dead
# rank must fail the save (surfaced by Saver.wait), not hang it.
ASYNC_SAVE_BARRIER_TIMEOUT_MS = 10 * 60 * 1000

# Logical mesh axis names: "data" carries the batch, "model" variable
# partitioning, "expert" MoE experts (the last two not ported yet).
MESH_AXIS_DATA = "data"
MESH_AXIS_MODEL = "model"
MESH_AXIS_EXPERT = "expert"


class _EnvVar:
    """One typed environment variable with a default. The variable name is
    taken from the attribute it is assigned to (``__set_name__``)."""

    __slots__ = ("name", "default")

    def __init__(self, default):
        self.name = None
        self.default = default

    def __set_name__(self, owner, name):
        self.name = name

    @property
    def val(self):
        """The typed value of this variable (default applied)."""
        raw = os.environ.get(self.name)
        if raw is None:
            return self.default
        if isinstance(self.default, bool):
            return raw == "True"
        if isinstance(self.default, int):
            return int(raw)
        return raw

    def __repr__(self):  # pragma: no cover
        return f"ENV.{self.name}(={self.val!r})"


class ENV:
    """Environment-variable contract (the JAX package's ``const.ENV``, the
    variables this slice reads)."""

    AUTODIST_WORKER = _EnvVar("")
    AUTODIST_STRATEGY_ID = _EnvVar("")
    AUTODIST_RESOURCE_SPEC = _EnvVar("")
    #: Set by test suites: builders then partition with one reduction
    #: device too (PartitionedPS), as the JAX package's tests do.
    AUTODIST_IS_TESTING = _EnvVar(False)


def is_worker() -> bool:
    """True when this process was launched as a non-chief worker."""
    return bool(ENV.AUTODIST_WORKER.val)


def is_chief_process() -> bool:
    """True when this process is the chief (strategy-building) process."""
    return not is_worker()
