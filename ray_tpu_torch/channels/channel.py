"""Channel implementations (copy of ``ray_tpu/channels/channel.py``,
without the shared-memory channel of process-backed actors).

Semantics mirror the reference's mutable-object channels: a write blocks
until all readers of the previous version have consumed it (single
outstanding version), each reader sees each version exactly once, and
close() unblocks everyone with ChannelError.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional

from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch.exceptions import ChannelError, ChannelTimeoutError


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
