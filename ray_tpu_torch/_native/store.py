"""Python wrappers over the native library: the shared-memory object
store, its mutable-object channels, and the two dependency queues
(counterpart of ``ray_tpu/_native/store.py``).

A store's segment is named ``/ray_tpu_torch_store_<pid>_<n>`` (``n``
counts the stores this process created), apart from the reference's
``/ray_tpu_store_...``, so both live in one process. ``create`` owns the
segment and unlinks it at ``close``; ``open`` attaches from another
process.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import shutil
from typing import List, Optional

import numpy as np

from ray_tpu_torch._native.build import load_native
from ray_tpu_torch.exceptions import ChannelError, ChannelTimeoutError

_ERRS = {
    -1: "exists", -2: "not found", -3: "full", -4: "timeout",
    -5: "closed", -6: "bad state", -7: "system error",
}


class NativeError(RuntimeError):
    def __init__(self, code: int, op: str):
        super().__init__(f"native {op} failed: {_ERRS.get(code, code)}")
        self.code = code
        self.op = op

    def __reduce__(self):
        # Default exception reduce would call __init__(message) and crash
        # when the error crosses a process boundary.
        return (NativeError, (self.code, self.op))


_STORE_COUNTER = itertools.count()


def _shm_free() -> int:
    """Free bytes of /dev/shm (-1 where it cannot be read)."""
    try:
        return shutil.disk_usage("/dev/shm").free
    except OSError:
        return -1


def _check(code: int, op: str):
    if code == -4:
        raise ChannelTimeoutError(f"native {op} timed out")
    if code == -5:
        raise ChannelError(f"native {op}: channel closed")
    if code != 0:
        raise NativeError(code, op)


class NativeObjectStore:
    """Shared-memory object store (plasma-parity surface: put/get/contains/
    delete + mutable objects). ``create`` owns the segment; ``open``
    attaches from another process."""

    def __init__(self, handle, lib, owner: bool):
        self._h = handle
        self._lib = lib
        self._owner = owner

    @staticmethod
    def create(name: Optional[str] = None, capacity: int = 64 << 20,
               max_objects: int = 4096) -> "NativeObjectStore":
        lib = load_native()
        name = name or (f"/ray_tpu_torch_store_{os.getpid()}_"
                        f"{next(_STORE_COUNTER)}")
        h = lib.rtn_store_create(name.encode(), capacity, max_objects)
        if not h:
            raise RuntimeError(
                f"failed to create shm store {name} of {capacity} bytes "
                f"(/dev/shm has {_shm_free()} bytes free)")
        store = NativeObjectStore(h, lib, owner=True)
        store.name = name
        return store

    @staticmethod
    def open(name: str) -> "NativeObjectStore":
        lib = load_native()
        h = lib.rtn_store_open(name.encode())
        if not h:
            raise RuntimeError(f"failed to open shm store {name}")
        store = NativeObjectStore(h, lib, owner=False)
        store.name = name
        return store

    def close(self):
        if self._h:
            self._lib.rtn_store_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass

    # ------------------------------------------------------------- objects
    def put(self, object_id: int, data: bytes):
        _check(self._lib.rtn_put(self._h, object_id, data, len(data)),
               "put")

    def get(self, object_id: int) -> bytes:
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        ln = ctypes.c_uint64()
        _check(self._lib.rtn_get(self._h, object_id, ctypes.byref(ptr),
                                 ctypes.byref(ln)), "get")
        return ctypes.string_at(ptr, ln.value)

    def get_view(self, object_id: int) -> memoryview:
        """Zero-copy view into the shm segment (valid until delete)."""
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        ln = ctypes.c_uint64()
        _check(self._lib.rtn_get(self._h, object_id, ctypes.byref(ptr),
                                 ctypes.byref(ln)), "get")
        arr = np.ctypeslib.as_array(ptr, shape=(ln.value,))
        return memoryview(arr)

    def contains(self, object_id: int) -> bool:
        return bool(self._lib.rtn_contains(self._h, object_id))

    def delete(self, object_id: int):
        _check(self._lib.rtn_delete(self._h, object_id), "delete")

    def stats(self) -> dict:
        return {
            "capacity": self._lib.rtn_store_capacity(self._h),
            "used": self._lib.rtn_store_used(self._h),
            "num_objects": self._lib.rtn_store_num_objects(self._h),
        }

    # ----------------------------------------------------- mutable objects
    def mo_create(self, object_id: int, max_size: int,
                  num_readers: int = 1):
        _check(self._lib.rtn_mo_create(self._h, object_id, max_size,
                                       num_readers), "mo_create")

    def mo_write(self, object_id: int, data: bytes,
                 timeout_s: float = 60.0):
        _check(self._lib.rtn_mo_write(self._h, object_id, data, len(data),
                                      int(timeout_s * 1000)), "mo_write")

    def mo_read(self, object_id: int, last_seen: int, max_size: int,
                timeout_s: float = 60.0) -> (bytes, int):
        buf = ctypes.create_string_buffer(max_size)
        ln = ctypes.c_uint64()
        ver = ctypes.c_uint64()
        _check(self._lib.rtn_mo_read(
            self._h, object_id, last_seen, buf, max_size,
            ctypes.byref(ln), ctypes.byref(ver),
            int(timeout_s * 1000)), "mo_read")
        return buf.raw[:ln.value], ver.value

    def mo_close(self, object_id: int):
        _check(self._lib.rtn_mo_close(self._h, object_id), "mo_close")

    def mo_destroy(self, object_id: int):
        """Close + reclaim the payload arena (owner teardown path)."""
        _check(self._lib.rtn_mo_destroy(self._h, object_id), "mo_destroy")


class NativeMutableChannel:
    """Channel API over a native mutable object — the cross-process
    SharedMemoryChannel (channels/channel.py Channel protocol)."""

    _COUNTER = [0]

    def __init__(self, store: NativeObjectStore, object_id: Optional[int]
                 = None, max_size: int = 1 << 20, num_readers: int = 1,
                 create: bool = True):
        self._store = store
        if object_id is None:
            NativeMutableChannel._COUNTER[0] += 1
            object_id = (os.getpid() << 20) | NativeMutableChannel._COUNTER[0]
        self.object_id = object_id
        self.max_size = max_size
        if create:
            store.mo_create(object_id, max_size, num_readers)
        self._last_seen = [0] * num_readers

    def write(self, value, timeout: Optional[float] = None):
        import pickle

        data = pickle.dumps(value, protocol=5)
        try:
            self._store.mo_write(self.object_id, data,
                                 timeout_s=timeout if timeout else 60.0)
        except NativeError as e:
            if e.code == -2:  # destroyed channel == closed to peers
                raise ChannelError("channel destroyed") from None
            raise

    def read(self, reader_id: int = 0, timeout: Optional[float] = None):
        import pickle

        try:
            data, ver = self._store.mo_read(
                self.object_id, self._last_seen[reader_id], self.max_size,
                timeout_s=timeout if timeout else 60.0)
        except NativeError as e:
            if e.code == -2:  # destroyed channel == closed to peers
                raise ChannelError("channel destroyed") from None
            raise
        self._last_seen[reader_id] = ver
        return pickle.loads(data)

    def close(self):
        """Signal EOF; committed data stays readable (drain semantics)."""
        try:
            self._store.mo_close(self.object_id)
        except NativeError:
            pass

    def destroy(self):
        """Close + reclaim the payload arena — only when no peer can still
        drain (e.g. the worker process on the other end is dead)."""
        try:
            self._store.mo_destroy(self.object_id)
        except NativeError:
            pass


class NativeTaskQueue:
    """Dependency-tracking ready queue (the C++ scheduler hot loop)."""

    def __init__(self, max_tasks: int, max_edges: int):
        self._lib = load_native()
        self._q = self._lib.rtn_tq_create(max_tasks, max_edges)
        self._sealed = False

    def add_task(self, task_id: int):
        if self._lib.rtn_tq_add_task(self._q, task_id) != 0:
            raise ValueError(f"bad task id {task_id} (or sealed)")

    def add_edge(self, src: int, dst: int):
        if self._lib.rtn_tq_add_edge(self._q, src, dst) != 0:
            raise ValueError(f"bad edge {src}->{dst} (or sealed/full)")

    def seal(self):
        if self._lib.rtn_tq_seal(self._q) != 0:
            raise RuntimeError("already sealed")
        self._sealed = True

    def complete(self, task_ids: List[int]):
        arr = (ctypes.c_uint32 * len(task_ids))(*task_ids)
        self._lib.rtn_tq_complete(self._q, arr, len(task_ids))

    def pop_wave(self, max_tasks: int = 1024,
                 timeout_s: float = 1.0) -> List[int]:
        out = (ctypes.c_uint32 * max_tasks)()
        n = self._lib.rtn_tq_pop_wave(self._q, out, max_tasks,
                                      int(timeout_s * 1000))
        return list(out[:n])

    @property
    def num_done(self) -> int:
        return self._lib.rtn_tq_num_done(self._q)

    @property
    def num_tasks(self) -> int:
        return self._lib.rtn_tq_num_tasks(self._q)

    def __del__(self):
        try:
            if getattr(self, "_q", None):
                self._lib.rtn_tq_destroy(self._q)
                self._q = None
        except Exception:  # noqa: BLE001
            pass


class NativeDynQueue:
    """Incremental dependency queue (the live scheduler's native hot loop).

    Handles are opaque uint64s with an embedded generation so completed
    slots recycle safely; ``add_dep`` against an already-completed producer
    is a no-op (the dependency is satisfied).
    """

    def __init__(self, max_tasks: int = 1 << 16, max_edges: int = 1 << 18):
        self._lib = load_native()
        self._q = self._lib.rtn_dq_create(max_tasks, max_edges)

    def alloc(self) -> int:
        h = self._lib.rtn_dq_alloc(self._q)
        if h == 0:
            raise MemoryError("dynamic task queue is full")
        return h

    def add_dep(self, task: int, dep: int):
        rc = self._lib.rtn_dq_add_dep(self._q, task, dep)
        if rc == -3:
            raise MemoryError("dynamic task queue edge table is full")
        if rc != 0:
            raise ValueError(f"bad task handle {task:#x}")

    def commit(self, task: int):
        if self._lib.rtn_dq_commit(self._q, task) != 0:
            raise ValueError(f"bad task handle {task:#x}")

    def complete(self, task: int):
        if self._lib.rtn_dq_complete(self._q, task) != 0:
            raise ValueError(f"bad/uncommitted task handle {task:#x}")

    def abort(self, task: int):
        """Abandon a task that never ran (registration unwind); its slot is
        recycled and edges into it go stale via the generation tag."""
        if self._lib.rtn_dq_abort(self._q, task) != 0:
            raise ValueError(f"bad task handle {task:#x}")

    def pop(self, max_tasks: int = 1024, timeout_s: float = 0.2) -> List[int]:
        out = (ctypes.c_uint64 * max_tasks)()
        n = self._lib.rtn_dq_pop(self._q, out, max_tasks,
                                 int(timeout_s * 1000))
        return list(out[:n])

    def wake(self):
        self._lib.rtn_dq_wake(self._q)

    @property
    def num_pending(self) -> int:
        return self._lib.rtn_dq_num_pending(self._q)

    @property
    def num_done(self) -> int:
        return self._lib.rtn_dq_num_done(self._q)

    def __del__(self):
        try:
            if getattr(self, "_q", None):
                self._lib.rtn_dq_destroy(self._q)
                self._q = None
        except Exception:  # noqa: BLE001
            pass
