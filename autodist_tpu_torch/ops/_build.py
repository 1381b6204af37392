"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
for Hopper (``sm_90a``) into ``autodist_tpu_torch/_build/`` under a name that
carries a hash of the source, so an edited source rebuilds and an unchanged
one is loaded as built. A build failure raises: nothing falls back to the
plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: Seconds each library took to build in this process (0.0 when loaded as built).
build_seconds: Dict[str, float] = {}
#: nvcc's output (ptxas register / shared-memory report) per library.
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "port's CUDA kernels are built from source at first use")


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:16]}.so")


def _compile(name: str):
    """Start nvcc for ``csrc/<name>.cu``; returns (process, tmp, out, t0), or
    None when the library is already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out, time.perf_counter()


def build(names: Iterable[str]) -> None:
    """Build every named kernel library, all nvcc processes started together."""
    with _lock:
        pending = {n: _compile(n) for n in names if n not in _libs}
        for name, job in pending.items():
            if job is None:
                build_seconds.setdefault(name, 0.0)
                continue
            proc, tmp, out, t0 = job
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                                   f"(rc={proc.returncode}):\n{log}")
            os.replace(tmp, out)
            build_seconds[name] = time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(_lib_path(name))
    return lib
