"""In-process object store with reference counts, eviction and
spilling (counterpart of ``ray_tpu/_private/object_store.py``).

Objects are stored as ``SerializedObject`` payloads (or errors); futures
resolve through a condition variable; an entry is evicted when its last
local reference and its last pin by a submitted task are gone, and each
eviction calls the registered evict callbacks (the process plane drops
the object's copy in the shm store there). When the host bytes held pass
``object_store_memory_bytes``, sealed host payloads spill to disk,
largest and oldest first, and ``get`` restores them transparently. Only
host payloads spill: an entry that holds device tensors (or a value held
by reference) is no spill candidate, and its device bytes do not count
against the host cap. ``close`` (at ``shutdown``) fails every waiter, so
no thread stays blocked in ``get`` past the runtime's end.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.serialization import SerializedObject
from ray_tpu_torch.exceptions import (
    GetTimeoutError,
    ObjectLostError,
    RayTpuError,
    TaskCancelledError,
)


class _Entry:
    __slots__ = ("serialized", "error", "ready", "size", "host_size",
                 "spilled_path", "create_time", "local_refs",
                 "submitted_refs", "callbacks", "dropped", "local_producer",
                 "lost")

    def __init__(self):
        self.serialized: Optional[SerializedObject] = None
        self.error: Optional[BaseException] = None
        self.ready = False
        self.size = 0
        self.host_size = 0          # the part of size in host memory
        self.spilled_path: Optional[str] = None
        self.create_time = time.monotonic()
        self.local_refs = 0
        self.submitted_refs = 0
        self.callbacks: List[Callable[[], None]] = []
        # Every reference went before the value came (a task's output
        # nobody kept): evict the value as soon as it lands.
        self.dropped = False
        # A task or actor call of this process will produce the value: a
        # head-attached driver never pulls it from another driver.
        self.local_producer = False
        # Its node died on the simulated cluster (cluster_utils): pending
        # again, for lineage to rebuild.
        self.lost = False


class ObjectStore:
    """Owner-local object table: futures, payloads, refcounts."""

    def __init__(self, spill_dir: Optional[str] = None):
        self._entries: Dict[ObjectID, _Entry] = {}
        self._cv = threading.Condition()
        self._memory_used = 0       # host bytes of resident payloads
        self._closed = False
        self._spill_dir = spill_dir
        self._spilled_bytes = 0
        self._restored_bytes = 0
        self._evict_callbacks: List[Callable[[ObjectID], None]] = []

    # ------------------------------------------------------------------ puts
    def put(self, object_id: ObjectID, serialized: SerializedObject):
        with self._cv:
            entry = self._entries.setdefault(object_id, _Entry())
            if entry.ready:
                return  # idempotent (e.g. retry produced the same object)
            entry.serialized = serialized
            entry.size = serialized.total_bytes()
            entry.host_size = serialized.host_bytes()
            entry.ready = True
            entry.lost = False
            self._memory_used += entry.host_size
            callbacks, entry.callbacks = entry.callbacks, []
            self._cv.notify_all()
            self._maybe_spill_locked()
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
                return self._restore_locked(object_id, entry)
            return entry.serialized

    def peek_error(self, object_id: ObjectID) -> Optional[BaseException]:
        with self._cv:
            e = self._entries.get(object_id)
            return e.error if e is not None and e.ready else None

    def is_ready(self, object_id: ObjectID) -> bool:
        with self._cv:
            e = self._entries.get(object_id)
            return e is not None and e.ready

    def size_of(self, object_id: ObjectID) -> int:
        """Serialized size of a ready value (0 for errors and unknown
        ids): the node plane's locality scoring reads it."""
        with self._cv:
            e = self._entries.get(object_id)
            return e.size if e is not None and e.ready else 0

    def holds_in_memory(self, object_id: ObjectID) -> bool:
        """Ready with its payload resident (not spilled, not an error):
        the gate for inlining a result into its completion report."""
        with self._cv:
            e = self._entries.get(object_id)
            return e is not None and e.ready and e.serialized is not None

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

    def contains(self, object_id: ObjectID) -> bool:
        with self._cv:
            return object_id in self._entries

    def mark_local_producer(self, object_id: ObjectID):
        with self._cv:
            self._entries.setdefault(object_id, _Entry()).local_producer = \
                True

    def mark_lost(self, object_id: ObjectID):
        """Simulated node loss (``cluster_utils``): drop the payload (and
        its spill file); the entry reverts to pending with the lost
        flag, so its owner rebuilds it from lineage."""
        with self._cv:
            e = self._entries.get(object_id)
            if e is None or not e.ready:
                return
            if e.serialized is not None:
                self._memory_used -= e.host_size
            self._unlink_spilled(e)
            e.serialized = None
            e.error = None
            e.ready = False
            e.lost = True

    def is_lost(self, object_id: ObjectID) -> bool:
        with self._cv:
            e = self._entries.get(object_id)
            return e is not None and e.lost and not e.ready

    def clear_lost(self, object_id: ObjectID):
        with self._cv:
            e = self._entries.get(object_id)
            if e is not None:
                e.lost = False

    def has_local_producer(self, object_id: ObjectID) -> bool:
        with self._cv:
            e = self._entries.get(object_id)
            return e is not None and e.local_producer

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
            self._sanitize_refcounts(object_id, entry)
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
            self._sanitize_refcounts(object_id, entry)
            self._maybe_evict_locked(object_id, entry)

    @staticmethod
    def _sanitize_refcounts(object_id, entry):
        """Debug-mode underflow check (RAY_TPU_SANITIZE=1): a negative
        refcount is a double-release race."""
        from ray_tpu_torch.util import sanitizer  # late: store imports early

        if sanitizer.enabled():
            sanitizer.check_refcount(
                object_id, entry.local_refs, entry.submitted_refs)

    def _maybe_evict_locked(self, object_id: ObjectID, entry: _Entry):
        if entry.local_refs > 0 or entry.submitted_refs > 0:
            return
        if not entry.ready:
            entry.dropped = True
            return
        if entry.serialized is not None:
            self._memory_used -= entry.host_size
        self._unlink_spilled(entry)
        del self._entries[object_id]
        for cb in self._evict_callbacks:
            try:
                cb(object_id)
            except Exception:  # noqa: BLE001 — eviction must not fail
                pass

    def set_evict_callback(self, callback: Callable[[ObjectID], None]):
        """Register a callback invoked with each ObjectID as its entry is
        evicted, under the store's lock (it must be cheap and take no lock
        that nests around the store's); the process plane releases the
        object's shm copy there."""
        with self._cv:
            self._evict_callbacks.append(callback)

    def remove_evict_callback(self, callback):
        with self._cv:
            try:
                self._evict_callbacks.remove(callback)
            except ValueError:
                pass

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
                    self._memory_used -= entry.host_size
                    entry.serialized = None
                self._unlink_spilled(entry)
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

    # -------------------------------------------------------------- spilling
    def _maybe_spill_locked(self):
        cap = GlobalConfig.object_store_memory_bytes
        if self._memory_used <= cap or self._spill_dir is None:
            return
        # Largest and oldest sealed host payloads first, until under the
        # cap; device tensors and held values stay where they are.
        candidates = sorted(
            ((oid, e) for oid, e in self._entries.items()
             if e.ready and e.serialized is not None
             and e.serialized.on_host() and e.host_size > 4096),
            key=lambda kv: (-kv[1].host_size, kv[1].create_time))
        os.makedirs(self._spill_dir, exist_ok=True)
        for oid, entry in candidates:
            if self._memory_used <= cap:
                break
            path = os.path.join(self._spill_dir, oid.hex())
            with open(path, "wb") as f:
                f.write(entry.serialized.to_bytes())
            entry.spilled_path = path
            self._memory_used -= entry.host_size
            self._spilled_bytes += entry.host_size
            entry.serialized = None

    def _restore_locked(self, object_id: ObjectID, entry: _Entry
                        ) -> SerializedObject:
        if entry.spilled_path is None:
            raise ObjectLostError(object_id)
        with open(entry.spilled_path, "rb") as f:
            serialized = SerializedObject.from_bytes(f.read())
        self._unlink_spilled(entry)
        entry.serialized = serialized
        self._memory_used += entry.host_size
        self._restored_bytes += entry.host_size
        return serialized

    @staticmethod
    def _unlink_spilled(entry: _Entry):
        if entry.spilled_path:
            try:
                os.unlink(entry.spilled_path)
            except OSError:
                pass
            entry.spilled_path = None

    # ----------------------------------------------------------------- stats
    def entries_snapshot(self):
        """(object_id, ready, size, local_refs, submitted_refs, spilled)
        rows for the state API."""
        with self._cv:
            return [
                (oid, e.ready, e.size, e.local_refs, e.submitted_refs,
                 e.spilled_path is not None)
                for oid, e in self._entries.items()
            ]

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            return {
                "num_objects": len(self._entries),
                "memory_used_bytes": self._memory_used,
                "spilled_bytes": self._spilled_bytes,
                "restored_bytes": self._restored_bytes,
            }
