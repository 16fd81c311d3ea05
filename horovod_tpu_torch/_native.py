"""ctypes binding of the native negotiation engine (port of
``horovod_tpu/_native.py``).

The engine is the framework-free C++ of ``native/`` (``engine.cc``,
``timeline.cc``; the C API of ``native/hvd_core.h``), which the port builds
and never edits: one ``g++`` call, at first use, into the port's
``horovod_tpu_torch/_build/`` (listed in ``.gitignore``) under a name keyed
by a hash of the sources, the headers and the flags, so an edited engine is
rebuilt and an unchanged one is reused. There is no fallback: a failed
build raises :class:`NativeBuildError` with the compiler's message.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("engine.cc", "timeline.cc")
HEADERS = ("hvd_core.h", "message.h", "wire.h", "timeline.h")
# The engine carries its own libstdc++ (linked statically, its symbols kept
# local): inside a process that has loaded torch, an engine that g++ 13.3
# (Ubuntu 24.04) linked to the shared libstdc++ crashed joining the
# timeline's writer thread.
FLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-shared",
         "-static-libstdc++", "-static-libgcc", "-Wl,--exclude-libs,ALL")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    """The engine sources could not be compiled (no g++, compile error)."""


def lib_path() -> Path:
    h = hashlib.sha256()
    for f in SOURCES + HEADERS:
        h.update((NATIVE_DIR / f).read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"libhvd_core-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the engine unless it is built; returns the library's path."""
    try:
        out = lib_path()
    except OSError as e:
        raise NativeBuildError(f"engine sources not found: {e}") from e
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = os.environ.get("CXX", "g++")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *FLAGS, *(str(NATIVE_DIR / s) for s in SOURCES),
           "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"failed to run {cxx}: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(
            f"native engine compile failed (rc={proc.returncode}):\n"
            f"{proc.stdout[-4000:]}")
    os.replace(tmp, out)  # atomic: concurrent builds agree
    return out


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    c = ctypes
    lib.hvd_engine_create.restype = c.c_void_p
    lib.hvd_engine_create.argtypes = [c.c_int32, c.c_int32, c.c_int64,
                                      c.c_int32, c.c_double, c.c_double]
    lib.hvd_engine_destroy.argtypes = [c.c_void_p]
    lib.hvd_engine_enqueue.restype = c.c_int32
    lib.hvd_engine_enqueue.argtypes = [
        c.c_void_p, c.c_char_p, c.c_int32, c.c_int32, c.c_int32,
        c.POINTER(c.c_int64), c.c_int32, c.c_int32, c.c_int32,
        c.POINTER(c.c_int32), c.c_int32, c.c_int32, c.c_double, c.c_double,
        c.c_int32]
    for name in ("hvd_engine_pop_requests", "hvd_engine_compute_responses",
                 "hvd_engine_cache_bits", "hvd_engine_stall_report"):
        fn = getattr(lib, name)
        fn.restype = c.c_int32
        fn.argtypes = [c.c_void_p, c.POINTER(u8p), c.POINTER(c.c_size_t)]
    lib.hvd_engine_ingest.restype = c.c_int32
    lib.hvd_engine_ingest.argtypes = [c.c_void_p, c.c_int32, u8p,
                                      c.c_size_t]
    lib.hvd_engine_commit_cache_bits.restype = c.c_int32
    lib.hvd_engine_commit_cache_bits.argtypes = [c.c_void_p, u8p,
                                                 c.c_size_t]
    lib.hvd_engine_register_group.argtypes = [c.c_void_p, c.c_int32,
                                              c.c_int32]
    lib.hvd_engine_abandon.restype = c.c_int32
    lib.hvd_engine_abandon.argtypes = [c.c_void_p, c.c_char_p]
    for name in ("hvd_engine_pending_count", "hvd_engine_cache_size",
                 "hvd_engine_join_pending"):
        getattr(lib, name).restype = c.c_int32
        getattr(lib, name).argtypes = [c.c_void_p]
    lib.hvd_engine_cache_has.restype = c.c_int32
    lib.hvd_engine_cache_has.argtypes = [c.c_void_p, c.c_char_p]
    lib.hvd_core_version.restype = c.c_char_p
    # the Chrome-trace writer of native/timeline.cc (hvd_core.h:142-150)
    lib.hvd_timeline_start.restype = c.c_int32
    lib.hvd_timeline_start.argtypes = [c.c_void_p, c.c_char_p]
    lib.hvd_timeline_stop.restype = None
    lib.hvd_timeline_stop.argtypes = [c.c_void_p]
    lib.hvd_timeline_record.restype = None
    lib.hvd_timeline_record.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p,
                                        c.c_int32, c.c_int64]


def load() -> ctypes.CDLL:
    """The engine library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def version() -> str:
    return load().hvd_core_version().decode()
