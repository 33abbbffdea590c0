"""Builds the port's CUDA kernels from ``ops/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into a shared library that ``ctypes`` loads (no PyTorch
headers, so a build takes seconds). Libraries go under ``build/ray_tpu_torch/``
at the repository root, keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one loads from disk. Delete that directory to force a rebuild.
``build_all`` starts one ``nvcc`` per source, all at once.
``SPLIT_COMPILE`` names two libraries that no rule of shapes reaches (the
earlier CUDA-core kernels up to head_dim 256, kept as baselines): their
many template instances made them the build's critical path, so their
``nvcc`` runs its optimisation on parallel threads (``--split-compile``);
the libraries the port launches build on one thread each, their code
unchanged.

The Triton kernel of ``ops/fused.py`` is not built here: Triton compiles
it at its first launch, into Triton's own cache.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# The seven libraries built together on an 8-core H100 host took 56.9 s,
# 25.5 s with these two on --split-compile=0 (all the host's threads).
SPLIT_COMPILE = ("flash_attention_fwd", "flash_attention_bwd")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> (seconds spent in nvcc, 0.0 when loaded from disk; ptxas report)
build_info: Dict[str, tuple] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of ray_tpu_torch "
                       "build only on a machine with the CUDA toolkit")


def nvcc_flags(name: str) -> List[str]:
    """The flags that build library ``name``."""
    return NVCC_FLAGS + (["--split-compile=0"] if name in SPLIT_COMPILE
                         else [])


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str]) -> List[Path]:
    """Compile each ``csrc/<name>.cu`` whose hashed library is missing,
    one ``nvcc`` process per source, all started together."""
    names = list(names)
    outs = [library_path(n) for n in names]
    running = []
    for name, out in zip(names, outs):
        if out.exists():
            build_info.setdefault(name, (0.0, ""))
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *nvcc_flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((name, out, tmp, proc, time.perf_counter()))
    # Each process's output is read, and its time taken, on a thread of its
    # own, so that a build's seconds are its own, not the slowest before it.
    done = {}

    def finish(name, proc, t0):
        stdout, stderr = proc.communicate()
        done[name] = (stdout, stderr, time.perf_counter() - t0)

    readers = [threading.Thread(target=finish, args=(name, proc, t0))
               for name, _, _, proc, t0 in running]
    for t in readers:
        t.start()
    for t in readers:
        t.join()
    failures = []
    for name, out, tmp, proc, _ in running:
        stdout, stderr, seconds = done[name]
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name} ({proc.returncode}):"
                            f"\n{stdout}\n{stderr}")
            continue
        os.replace(tmp, out)
        build_info[name] = (seconds, stderr)
    if failures:
        raise RuntimeError("\n".join(failures))
    return outs


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists."""
    return build_all([name])[0]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
