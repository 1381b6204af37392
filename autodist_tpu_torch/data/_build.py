"""The native data loader's library: ``csrc/dataloader.cc`` built by
``ops/_build.py`` with the host C++ compiler, and its ctypes signatures.

The C ABI is the JAX package's (``ad_loader_*``). Unlike the JAX package's
build, which warns and returns ``None`` when the compiler fails, a build
that fails raises here; only the absence of any C++ compiler
(:func:`native_available` false) lets ``DataLoader(engine="auto")`` choose
the python engine.
"""
from __future__ import annotations

import ctypes

from autodist_tpu_torch.ops import _build

NAME = "dataloader"


def native_available() -> bool:
    """True when a host C++ compiler is found (``ops/_build.host_compiler``)."""
    return _build.host_compiler() is not None


def load_library() -> ctypes.CDLL:
    """The built (or cached) library with its signatures declared; raises
    when it cannot be built or loaded."""
    lib = _build.load(NAME)
    if getattr(lib, "_ad_signatures", False):
        return lib
    u64, i64, i32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_int
    ptr = ctypes.c_void_p
    lib.ad_loader_create.restype = ptr
    lib.ad_loader_create.argtypes = [i32, u64, u64, i32, i32, i32, u64, i32, i64]
    lib.ad_loader_set_source.restype = None
    # c_void_p, NOT c_char_p: char_p elements auto-convert to NUL-terminated
    # bytes and would corrupt binary rows.
    lib.ad_loader_set_source.argtypes = [ptr, i32, ctypes.c_void_p, u64]
    lib.ad_loader_set_source_shards.restype = i32
    lib.ad_loader_set_source_shards.argtypes = [
        ptr, i32, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(u64), i32, u64]
    lib.ad_loader_start.restype = i32
    lib.ad_loader_start.argtypes = [ptr]
    lib.ad_loader_next.restype = i64
    lib.ad_loader_next.argtypes = [ptr, ctypes.POINTER(ctypes.c_void_p),
                                   ctypes.POINTER(u64)]
    lib.ad_loader_release.restype = None
    lib.ad_loader_release.argtypes = [ptr, i32]
    lib.ad_loader_batches_per_epoch.restype = i64
    lib.ad_loader_batches_per_epoch.argtypes = [ptr]
    lib.ad_loader_destroy.restype = None
    lib.ad_loader_destroy.argtypes = [ptr]
    lib._ad_signatures = True
    return lib
