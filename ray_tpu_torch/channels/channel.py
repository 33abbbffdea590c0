"""Channel implementations (copy of ``ray_tpu/channels/channel.py``).

Semantics mirror the reference's mutable-object channels: a write blocks
until all readers of the previous version have consumed it (single
outstanding version), each reader sees each version exactly once, and
close() unblocks everyone with ChannelError. ``ShmBufferedChannel``
crosses processes over the native shm store's mutable objects (values in
stdlib pickle there, so host values); the others live in this process and
pass values by reference.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional

from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch.exceptions import ChannelError, ChannelTimeoutError
from ray_tpu_torch.util import sanitizer as _sanitizer


class Channel:
    """Abstract single-writer multi-reader channel."""

    def write(self, value: Any, timeout: Optional[float] = None):
        raise NotImplementedError

    def read(self, reader_id: int = 0, timeout: Optional[float] = None):
        raise NotImplementedError

    def close(self):
        raise NotImplementedError


class IntraProcessChannel(Channel):
    """Versioned single-slot channel: the mutable-object fast path.

    One buffer, a version counter, and per-reader consumed versions — the
    protocol of the reference's mutable objects, over a condition
    variable.
    """

    def __init__(self, num_readers: int = 1):
        if num_readers < 1:
            raise ValueError("num_readers must be >= 1")
        self._num_readers = num_readers
        self._cv = threading.Condition()
        self._value: Any = None
        self._version = 0
        self._reads_left = 0  # readers yet to consume current version
        self._read_version = [0] * num_readers
        self._closed = False

    def write(self, value: Any, timeout: Optional[float] = None):
        timeout = (GlobalConfig.channel_read_timeout_s
                   if timeout is None else timeout)
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._reads_left > 0 and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ChannelTimeoutError(
                        "write blocked: readers have not consumed the "
                        "previous version")
                self._cv.wait(remaining)
            if self._closed:
                raise ChannelError("channel is closed")
            self._value = value
            self._version += 1
            self._reads_left = self._num_readers
            self._cv.notify_all()

    def read(self, reader_id: int = 0, timeout: Optional[float] = None):
        timeout = (GlobalConfig.channel_read_timeout_s
                   if timeout is None else timeout)
        deadline = time.monotonic() + timeout
        with self._cv:
            while (self._read_version[reader_id] >= self._version
                   and not self._closed):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ChannelTimeoutError("read timed out")
                self._cv.wait(remaining)
            if self._closed and self._read_version[reader_id] >= self._version:
                raise ChannelError("channel is closed")
            if _sanitizer.enabled():
                # Version-succession invariant: readers must see each
                # version exactly once, in order (v+1, v+2, …). Keyed by
                # a stable token — id() reuse after GC would alias.
                if not hasattr(self, "_san_id"):
                    self._san_id = _sanitizer.new_channel_id()
                _sanitizer.channel_checker.observe(
                    self._san_id, reader_id, self._version)
            self._read_version[reader_id] = self._version
            value = self._value
            self._reads_left -= 1
            if self._reads_left == 0:
                self._cv.notify_all()
            return value

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()


class BufferedChannel(Channel):
    """Ring of K versioned slots so the writer can run K versions ahead
    (BufferedSharedMemoryChannel parity — max buffered executions)."""

    def __init__(self, num_readers: int = 1, buffer_count: int = 2):
        self._slots: List[IntraProcessChannel] = [
            IntraProcessChannel(num_readers) for _ in range(buffer_count)
        ]
        self._w = 0
        self._r = [0] * num_readers
        self._lock = threading.Lock()
        self._wlock = threading.Lock()

    def write(self, value: Any, timeout: Optional[float] = None):
        # The writer mutex spans slot selection AND the slot write: with
        # only the cursor under a lock, two concurrent writers could select
        # the same slot and both advance _w, leaving a never-written slot
        # that readers block on forever. The lock acquire itself is bounded
        # by the same deadline so a second writer's timeout is honored even
        # while the first holds the lock blocked on stalled readers. The
        # cursor still advances only after the slot op succeeds, so a
        # ChannelTimeoutError leaves the ring consistent and the caller can
        # simply retry (compiled_dag relies on this).
        timeout = (GlobalConfig.channel_read_timeout_s
                   if timeout is None else timeout)
        deadline = time.monotonic() + timeout
        if not self._wlock.acquire(timeout=timeout):
            raise ChannelTimeoutError(
                "write blocked: another writer holds the channel")
        try:
            slot = self._slots[self._w % len(self._slots)]
            slot.write(value, max(0.0, deadline - time.monotonic()))
            self._w += 1
        finally:
            self._wlock.release()

    def read(self, reader_id: int = 0, timeout: Optional[float] = None):
        with self._lock:
            slot = self._slots[self._r[reader_id] % len(self._slots)]
        value = slot.read(reader_id, timeout)
        with self._lock:
            self._r[reader_id] += 1
        return value

    def close(self):
        for s in self._slots:
            s.close()


class ShmBufferedChannel(Channel):
    """Cross-process buffered channel: a ring of native shared-memory
    mutable objects (the reference's BufferedSharedMemoryChannel role,
    which keeps the driver out of the data path between worker-process
    stages).

    Every participating process builds its own instance over the SAME
    slot ids (``create=True`` only in the allocating driver); cursors are
    per process, which is sound as each edge has one writer process and
    each reader id lives in one process. A timed-out read or write leaves
    the cursors where they were, so a retry resumes cleanly."""

    def __init__(self, store, slot_ids: List[int], max_size: int,
                 num_readers: int = 1, create: bool = True):
        from ray_tpu_torch._native.store import NativeMutableChannel

        self.slot_ids = list(slot_ids)
        self.max_size = max_size
        self.num_readers = num_readers
        self._slots = [
            NativeMutableChannel(store, sid, max_size=max_size,
                                 num_readers=num_readers, create=create)
            for sid in slot_ids
        ]
        self._w = 0
        self._r = [0] * num_readers

    def spec(self) -> tuple:
        """The wire description a peer process rebuilds the channel from."""
        return (tuple(self.slot_ids), self.max_size, self.num_readers)

    @classmethod
    def attach(cls, store, spec: tuple) -> "ShmBufferedChannel":
        slot_ids, max_size, num_readers = spec
        return cls(store, list(slot_ids), max_size, num_readers,
                   create=False)

    def write(self, value: Any, timeout: Optional[float] = None):
        from ray_tpu_torch._native.store import NativeError

        slot = self._slots[self._w % len(self._slots)]
        try:
            slot.write(value, timeout)
        except NativeError as e:
            if e.code == -3:   # the payload exceeds a slot's capacity
                raise ChannelError(
                    f"payload exceeds the shm channel capacity "
                    f"({self.max_size} bytes)") from None
            raise
        self._w += 1   # advanced only after success (retry-safe)

    def read(self, reader_id: int = 0, timeout: Optional[float] = None):
        slot = self._slots[self._r[reader_id] % len(self._slots)]
        value = slot.read(reader_id, timeout)
        self._r[reader_id] += 1
        return value

    def close(self):
        for s in self._slots:
            s.close()

    def destroy(self):
        for s in self._slots:
            s.destroy()


class CompositeChannel(Channel):
    """Fans one writer out to several underlying channels (the reference
    uses this to split local vs remote readers)."""

    def __init__(self, channels: List[Channel]):
        self._channels = channels

    def write(self, value: Any, timeout: Optional[float] = None):
        for ch in self._channels:
            ch.write(value, timeout)

    def read(self, reader_id: int = 0, timeout: Optional[float] = None):
        raise TypeError(
            "read from the component channel, not the composite")

    def close(self):
        for ch in self._channels:
            ch.close()
