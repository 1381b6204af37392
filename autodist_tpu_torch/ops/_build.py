"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
for Hopper (``sm_90a``) into ``autodist_tpu_torch/_build/`` under a name that
carries a hash of the source, so an edited source rebuilds and an unchanged
one is loaded as built. nvcc's output (the ``-Xptxas -v`` report) is kept
beside the library as ``lib<name>-<hash>.log``, so a library loaded as built
still reports its registers and spills. A build failure raises: nothing
falls back to the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: Seconds each library took to build in this process (0.0 when loaded as built).
build_seconds: Dict[str, float] = {}
#: nvcc's output (ptxas register / shared-memory report) per library, read
#: back from its log file when the library was loaded as built.
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


def _log_path(lib_path: str) -> str:
    return lib_path[:-len(".so")] + ".log"


def _compile(name: str):
    """Start nvcc for ``csrc/<name>.cu``; returns (process, tmp, out, t0), or
    None when the library and its log are already built."""
    out = _lib_path(name)
    if os.path.exists(out) and os.path.exists(_log_path(out)):
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
                with open(_log_path(_lib_path(name))) as f:
                    build_logs[name] = f.read()
                continue
            proc, tmp, out, t0 = job
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                                   f"(rc={proc.returncode}):\n{log}")
            with open(f"{tmp}.log", "w") as f:
                f.write(log)
            os.replace(f"{tmp}.log", _log_path(out))
            os.replace(tmp, out)
            build_seconds[name] = time.perf_counter() - t0


def ptxas_report(name: str) -> Dict[str, dict]:
    """Per kernel of a library that :func:`build` built or loaded in this
    process: registers and spill bytes from nvcc's ``-Xptxas -v`` output
    (empty for a library it has not seen). Keys are the mangled kernel names
    ptxas prints."""
    report: Dict[str, dict] = {}
    current = None
    for line in build_logs.get(name, "").splitlines():
        m = (re.search(r"Compiling entry function '([^']+)'", line)
             or re.search(r"Function properties for (\S+)", line))
        if m:
            current = report.setdefault(m.group(1), {})
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_stores"], current["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
    return report


def sass_counts(name: str, opcode: str) -> Optional[Dict[str, int]]:
    """Count ``opcode`` instructions (e.g. ``HMMA``) per kernel in the built
    library's SASS (``cuobjdump --dump-sass``); None when cuobjdump is not
    found."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "--dump-sass", _lib_path(name)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts: Dict[str, int] = {}
    current = None
    pattern = re.compile(rf"\b{opcode}\b")
    for line in sass.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            counts[current] = 0
        elif current is not None and pattern.search(line):
            counts[current] += 1
    return counts


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
