"""Build and load the native library of the process plane (counterpart of
``ray_tpu/_native/build.py``): ``ctypes`` over a C ABI, no pybind11.

``object_store.cc`` and ``task_queue.cc`` compile with ``g++`` into one
shared library, ``libray_tpu_torch_native-<hash>.so``, keyed by a hash of
the sources and the flags. It goes under ``build/ray_tpu_torch/native/``
at the repository root, beside the CUDA kernels that ``ops/_build.py``
builds, so an unchanged source loads from disk and an edited one
rebuilds; delete that directory to force a rebuild. Each process loads
it with ``RTLD_LOCAL``, so the reference's library in the same process
clashes with no symbol of it.

Unlike the reference, a failed build does not degrade anything in
silence: ``load_native`` raises ``NativeBuildError`` with the compiler's
stderr, and ``init(worker_mode="process")`` lets it propagate.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

SOURCES = ("object_store.cc", "task_queue.cc")
SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch" \
    / "native"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-pthread", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The native library did not build (or load); the message carries
    the compiler's stderr."""


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libray_tpu_torch_native-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError(
            "g++ not found: the process plane (worker_mode='process') "
            "needs it to build ray_tpu_torch/_native")
    out.parent.mkdir(parents=True, exist_ok=True)
    # A name of this process's own: concurrent builders never share a
    # half-written file, and the rename is atomic.
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, *(str(SRC_DIR / s) for s in SOURCES),
           "-o", str(tmp), "-lrt"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except subprocess.TimeoutExpired as exc:
        raise NativeBuildError(f"g++ timed out: {' '.join(cmd)}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"g++ failed (exit {proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u64, u32, i64, i32 = (ctypes.c_uint64, ctypes.c_uint32,
                          ctypes.c_int64, ctypes.c_int32)
    p = ctypes.c_void_p
    u8p = ctypes.POINTER(ctypes.c_uint8)
    sigs = {
        "rtn_store_create": (p, [ctypes.c_char_p, u64, u32]),
        "rtn_store_open": (p, [ctypes.c_char_p]),
        "rtn_store_close": (None, [p]),
        "rtn_store_capacity": (u64, [p]),
        "rtn_store_used": (u64, [p]),
        "rtn_store_num_objects": (u64, [p]),
        "rtn_put": (i32, [p, u64, ctypes.c_char_p, u64]),
        "rtn_get": (i32, [p, u64, ctypes.POINTER(u8p),
                          ctypes.POINTER(u64)]),
        "rtn_contains": (i32, [p, u64]),
        "rtn_delete": (i32, [p, u64]),
        "rtn_mo_create": (i32, [p, u64, u64, u32]),
        "rtn_mo_write": (i32, [p, u64, ctypes.c_char_p, u64, i64]),
        "rtn_mo_read": (i32, [p, u64, u64, ctypes.c_char_p, u64,
                              ctypes.POINTER(u64), ctypes.POINTER(u64),
                              i64]),
        "rtn_mo_close": (i32, [p, u64]),
        "rtn_mo_destroy": (i32, [p, u64]),
        "rtn_tq_create": (p, [u32, u32]),
        "rtn_tq_destroy": (None, [p]),
        "rtn_tq_add_task": (i32, [p, u32]),
        "rtn_tq_add_edge": (i32, [p, u32, u32]),
        "rtn_tq_seal": (i32, [p]),
        "rtn_tq_complete": (i32, [p, ctypes.POINTER(u32), u32]),
        "rtn_tq_pop_wave": (i32, [p, ctypes.POINTER(u32), u32, i64]),
        "rtn_tq_num_done": (u32, [p]),
        "rtn_tq_num_tasks": (u32, [p]),
        "rtn_dq_create": (p, [u32, u32]),
        "rtn_dq_destroy": (None, [p]),
        "rtn_dq_alloc": (u64, [p]),
        "rtn_dq_add_dep": (i32, [p, u64, u64]),
        "rtn_dq_commit": (i32, [p, u64]),
        "rtn_dq_complete": (i32, [p, u64]),
        "rtn_dq_abort": (i32, [p, u64]),
        "rtn_dq_pop": (i32, [p, ctypes.POINTER(u64), u32, i64]),
        "rtn_dq_wake": (None, [p]),
        "rtn_dq_num_pending": (u64, [p]),
        "rtn_dq_num_done": (u64, [p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load_native() -> ctypes.CDLL:
    """The bound library, built at first use; raises NativeBuildError
    when it cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            path = _build()
            try:
                lib = ctypes.CDLL(str(path), mode=os.RTLD_LOCAL)
            except OSError as exc:
                raise NativeBuildError(
                    f"cannot load {path}: {exc}") from exc
            _lib = _bind(lib)
        return _lib


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load_native()
    except NativeBuildError:
        return False
    return True
