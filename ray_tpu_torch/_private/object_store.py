"""In-process object store with reference counts and eviction
(counterpart of ``ray_tpu/_private/object_store.py``, trimmed).

Objects are stored as ``SerializedObject`` payloads (or errors); futures
resolve through a condition variable; an entry is evicted when its last
local reference and its last pin by a submitted task are gone. The
reference's spilling to disk and the process plane's evict callbacks
are not ported: everything lives in this process's memory (device tensors
on their device). ``close`` (at ``shutdown``) fails every waiter, so no
thread stays blocked in ``get`` past the runtime's end.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.serialization import SerializedObject
from ray_tpu_torch.exceptions import (
    GetTimeoutError,
    ObjectLostError,
    RayTpuError,
    TaskCancelledError,
)


class _Entry:
    __slots__ = ("serialized", "error", "ready", "size", "local_refs",
                 "submitted_refs", "callbacks", "dropped")

    def __init__(self):
        self.serialized: Optional[SerializedObject] = None
        self.error: Optional[BaseException] = None
        self.ready = False
        self.size = 0
        self.local_refs = 0
        self.submitted_refs = 0
        self.callbacks: List[Callable[[], None]] = []
        # Every reference went before the value came (a task's output
        # nobody kept): evict the value as soon as it lands.
        self.dropped = False


class ObjectStore:
    """Owner-local object table: futures, payloads, refcounts."""

    def __init__(self):
        self._entries: Dict[ObjectID, _Entry] = {}
        self._cv = threading.Condition()
        self._memory_used = 0
        self._closed = False

    # ------------------------------------------------------------------ puts
    def put(self, object_id: ObjectID, serialized: SerializedObject):
        with self._cv:
            entry = self._entries.setdefault(object_id, _Entry())
            if entry.ready:
                return  # idempotent (e.g. retry produced the same object)
            entry.serialized = serialized
            entry.size = serialized.total_bytes()
            entry.ready = True
            self._memory_used += entry.size
            callbacks, entry.callbacks = entry.callbacks, []
            self._cv.notify_all()
        for cb in callbacks:
            cb()
        self._evict_if_dropped(object_id)

    def put_error(self, object_id: ObjectID, error: BaseException):
        with self._cv:
            entry = self._entries.setdefault(object_id, _Entry())
            if entry.ready:
                return
            entry.error = error
            entry.ready = True
            callbacks, entry.callbacks = entry.callbacks, []
            self._cv.notify_all()
        for cb in callbacks:
            cb()
        self._evict_if_dropped(object_id)

    # ------------------------------------------------------------------ gets
    def get(self, object_id: ObjectID, timeout: Optional[float] = None
            ) -> SerializedObject:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            entry = self._entries.setdefault(object_id, _Entry())
            while not entry.ready:
                if self._closed:
                    raise RayTpuError(
                        f"the runtime shut down while waiting for "
                        f"{object_id}")
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise GetTimeoutError(
                            f"get() timed out waiting for {object_id}"
                        )
                self._cv.wait(remaining)
            if entry.error is not None:
                err = entry.error
                if hasattr(err, "as_instanceof_cause"):
                    raise err.as_instanceof_cause()
                raise err
            if entry.serialized is None:
                raise ObjectLostError(object_id)
            return entry.serialized

    def peek_error(self, object_id: ObjectID) -> Optional[BaseException]:
        with self._cv:
            e = self._entries.get(object_id)
            return e.error if e is not None and e.ready else None

    def is_ready(self, object_id: ObjectID) -> bool:
        with self._cv:
            e = self._entries.get(object_id)
            return e is not None and e.ready

    def wait(self, object_ids: List[ObjectID], num_returns: int,
             timeout: Optional[float]):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                ready = [
                    oid for oid in object_ids
                    if (e := self._entries.get(oid)) is not None and e.ready
                ]
                if len(ready) >= num_returns or self._closed:
                    break
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                self._cv.wait(remaining)
            ready_set = set(ready[:num_returns])
            ready_list = [oid for oid in object_ids if oid in ready_set]
            not_ready = [oid for oid in object_ids if oid not in ready_set]
            return ready_list, not_ready

    def on_ready(self, object_id: ObjectID, callback: Callable[[], None]):
        """Invoke callback when object resolves (immediately if resolved)."""
        with self._cv:
            entry = self._entries.setdefault(object_id, _Entry())
            if not entry.ready:
                entry.callbacks.append(callback)
                return
        callback()

    def cancel(self, object_id: ObjectID, task_id=None):
        self.put_error(object_id, TaskCancelledError(task_id))

    # ------------------------------------------------------------- refcounts
    def add_local_ref(self, object_id: ObjectID):
        with self._cv:
            self._entries.setdefault(object_id, _Entry()).local_refs += 1

    def remove_local_ref(self, object_id: ObjectID):
        with self._cv:
            entry = self._entries.get(object_id)
            if entry is None:
                return
            entry.local_refs -= 1
            self._maybe_evict_locked(object_id, entry)

    def add_submitted_ref(self, object_id: ObjectID):
        with self._cv:
            self._entries.setdefault(object_id, _Entry()).submitted_refs += 1

    def remove_submitted_ref(self, object_id: ObjectID):
        with self._cv:
            entry = self._entries.get(object_id)
            if entry is None:
                return
            entry.submitted_refs -= 1
            self._maybe_evict_locked(object_id, entry)

    def _maybe_evict_locked(self, object_id: ObjectID, entry: _Entry):
        if entry.local_refs > 0 or entry.submitted_refs > 0:
            return
        if not entry.ready:
            entry.dropped = True
            return
        if entry.serialized is not None:
            self._memory_used -= entry.size
        del self._entries[object_id]

    def _evict_if_dropped(self, object_id: ObjectID):
        with self._cv:
            entry = self._entries.get(object_id)
            if entry is not None and entry.dropped:
                self._maybe_evict_locked(object_id, entry)

    def discard_pending(self, object_id: ObjectID):
        """Forget an entry that no producer will fill (a streaming
        generator's next index past its end) once nothing waits on it."""
        with self._cv:
            entry = self._entries.get(object_id)
            if entry is not None and not entry.ready and \
                    not entry.callbacks:
                del self._entries[object_id]

    def free(self, object_ids: List[ObjectID]):
        """Explicitly drop payloads (ray.internal.free parity): an entry
        nothing references goes; a referenced one keeps an error, so a
        later get of it raises."""
        with self._cv:
            for oid in object_ids:
                entry = self._entries.get(oid)
                if entry is None or not entry.ready:
                    continue
                if entry.serialized is not None:
                    self._memory_used -= entry.size
                    entry.serialized = None
                if entry.local_refs <= 0 and entry.submitted_refs <= 0:
                    del self._entries[oid]
                else:
                    entry.error = ObjectLostError(
                        oid, f"object {oid} was freed")

    def close(self):
        """Runtime shutdown: wake every waiter (``get`` then raises)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    # ----------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        with self._cv:
            return {
                "num_objects": len(self._entries),
                "memory_used_bytes": self._memory_used,
            }
