"""The process plane's native (C++) layer, loaded through ``ctypes``
(counterpart of ``ray_tpu/_native``).

``build.py`` compiles ``object_store.cc`` and ``task_queue.cc`` with
``g++`` at first use into ``build/ray_tpu_torch/native/``;
``store.py`` wraps the shared-memory object store, its mutable-object
channels and the dependency queues. A failed build raises
(``NativeBuildError``); nothing falls back in silence.
"""

from ray_tpu_torch._native.build import (
    NativeBuildError,
    load_native,
    native_available,
)
from ray_tpu_torch._native.store import (
    NativeDynQueue,
    NativeError,
    NativeMutableChannel,
    NativeObjectStore,
    NativeTaskQueue,
)

__all__ = [
    "NativeBuildError",
    "NativeDynQueue",
    "NativeError",
    "NativeMutableChannel",
    "NativeObjectStore",
    "NativeTaskQueue",
    "load_native",
    "native_available",
]
