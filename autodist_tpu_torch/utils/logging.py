"""Logging for autodist_tpu_torch.

A copy of the JAX package's ``utils/logging.py``: a module-level logger that
writes PID-tagged records to stderr and to a timestamped file, with verbosity
taken from ``AUTODIST_MIN_LOG_LEVEL``. The two names that module takes from
its ``const.py`` are inlined here; the log directory sits under the process's
temporary directory (``TMPDIR``).
"""
import logging as _logging
import os
import sys
import tempfile
import time

#: Verbosity env var (DEBUG/INFO/WARNING/ERROR), shared with the JAX package.
LOG_LEVEL_ENV = "AUTODIST_MIN_LOG_LEVEL"
DEFAULT_LOG_DIR = os.path.join(tempfile.gettempdir(), "autodist-tpu", "logs")

_LOGGER_NAME = "autodist_tpu_torch"
_FMT = "%(asctime)s [pid %(process)d] %(levelname)s %(name)s: %(message)s"


def _build_logger() -> _logging.Logger:
    logger = _logging.getLogger(_LOGGER_NAME)
    if logger.handlers:
        return logger
    level = getattr(_logging, os.environ.get(LOG_LEVEL_ENV, "INFO").upper(),
                    _logging.INFO)
    logger.setLevel(level)
    formatter = _logging.Formatter(_FMT)

    stream = _logging.StreamHandler(sys.stderr)
    stream.setFormatter(formatter)
    logger.addHandler(stream)

    try:
        os.makedirs(DEFAULT_LOG_DIR, exist_ok=True)
        fname = os.path.join(DEFAULT_LOG_DIR, f"log.{time.strftime('%Y%m%d-%H%M%S')}.{os.getpid()}")
        fileh = _logging.FileHandler(fname)
        fileh.setFormatter(formatter)
        logger.addHandler(fileh)
    except OSError:  # read-only fs etc. — stderr logging still works
        pass
    logger.propagate = False
    return logger


_logger = _build_logger()

debug = _logger.debug
info = _logger.info
warning = _logger.warning
error = _logger.error
critical = _logger.critical


def set_verbosity(level: str) -> None:
    """Set the log level by name (DEBUG/INFO/WARNING/ERROR)."""
    _logger.setLevel(getattr(_logging, level.upper()))


def get_logger() -> _logging.Logger:
    return _logger
