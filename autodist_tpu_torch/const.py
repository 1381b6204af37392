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
# Fault-tolerance state (heartbeats, snapshot ring); overridable per fleet
# through AUTODIST_FT_DIR, which the launcher exports so every process of
# one fleet shares a base.
DEFAULT_FT_DIR = os.path.join(DEFAULT_WORKING_DIR, "ft")

# The rendezvous port range (the JAX package's coordinator range): a
# cluster's MASTER_PORT is drawn from it by the spec's fingerprint.
DEFAULT_PORT_RANGE = range(15000, 16000)
DEFAULT_COORDINATOR_PORT = 15000

# The checkpoint writer's barriers on the group's store: a slow or dead
# rank must fail the save (surfaced by Saver.wait), not hang it.
ASYNC_SAVE_BARRIER_TIMEOUT_MS = 10 * 60 * 1000

# Logical mesh axis names: "data" carries the batch, "model" variable
# partitioning, "seq" sequence parallelism (ring / Ulysses attention),
# "expert" MoE experts, "pipe" pipeline stages.
MESH_AXIS_DATA = "data"
MESH_AXIS_MODEL = "model"
MESH_AXIS_SEQ = "seq"
MESH_AXIS_EXPERT = "expert"
MESH_AXIS_PIPE = "pipe"


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
    variables the port reads or exports). A launch sets both this contract
    and the ``torchrun`` variables (``MASTER_ADDR``, ``MASTER_PORT``,
    ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) that
    ``runtime/process_group.py`` joins from; ``AUTODIST_PROCESS_ID`` is the
    rank and ``AUTODIST_NUM_PROCESSES`` the world size."""

    AUTODIST_WORKER = _EnvVar("")
    AUTODIST_STRATEGY_ID = _EnvVar("")
    AUTODIST_MIN_LOG_LEVEL = _EnvVar("INFO")
    #: Print the SSH command of a remote launch instead of running it.
    AUTODIST_DEBUG_REMOTE = _EnvVar(False)
    AUTODIST_RESOURCE_SPEC = _EnvVar("")
    #: ``host:port`` of the rendezvous (rank 0's ``MASTER_ADDR:MASTER_PORT``).
    AUTODIST_COORDINATOR = _EnvVar("")
    AUTODIST_NUM_PROCESSES = _EnvVar(1)
    AUTODIST_PROCESS_ID = _EnvVar(0)
    #: Base dir of ft/ state (heartbeats, snapshots), shared by a fleet.
    AUTODIST_FT_DIR = _EnvVar("")
    #: One trace id for every process of a launch, and the shared dir each
    #: process flushes its span part-file into (``obs/spans.py``).
    AUTODIST_TRACE_ID = _EnvVar("")
    AUTODIST_TRACE_OUT = _EnvVar("")
    #: The flight recorder's dir; empty = ``<AUTODIST_FT_DIR>/flight`` when
    #: an ft base is exported, off otherwise (``obs/recorder.py``).
    AUTODIST_FLIGHT_DIR = _EnvVar("")
    #: Exported beside AUTODIST_FT_DIR (``<ft base>/pilot``) for the JAX
    #: package's autopilot; the port reads nothing from it.
    AUTODIST_PILOT_DIR = _EnvVar("")
    #: Set by test suites: builders then partition with one reduction
    #: device too (PartitionedPS), as the JAX package's tests do.
    AUTODIST_IS_TESTING = _EnvVar(False)


def is_worker() -> bool:
    """True when this process was launched as a non-chief worker."""
    return bool(ENV.AUTODIST_WORKER.val)


def is_chief_process() -> bool:
    """True when this process is the chief (strategy-building) process."""
    return not is_worker()
