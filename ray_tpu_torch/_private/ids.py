"""Binary ID types with embedded metadata and derivation (copy of
``ray_tpu/_private/ids.py``).

Object IDs are derived from the producing task's ID plus a return index,
so a task's outputs (and a streaming generator's items) are known from
the task ID alone.

Layout (hex-printable):
  TaskID   = 24 random/derived bytes
  ObjectID = TaskID (24 bytes) + 4-byte little-endian return index
  ActorID  = 12 bytes (job-scoped)
  NodeID   = 28 random bytes
"""

from __future__ import annotations

import os
import struct
import threading

_TASK_ID_SIZE = 24
_OBJECT_ID_SIZE = 28
_ACTOR_ID_SIZE = 12
_NODE_ID_SIZE = 28
_JOB_ID_SIZE = 4

# Reserved return index for a streaming generator's END MARKER object
# (commits the total yield count, or the task error). The highest value
# the 31-bit non-put index space allows — item indices stay below it.
STREAM_END_INDEX = 0x7FFF_FFFF


class BaseID:
    """Immutable binary identifier."""

    _SIZE = 0
    __slots__ = ("_bytes", "_hash")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self._SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self._SIZE} bytes, "
                f"got {len(id_bytes)}"
            )
        self._bytes = bytes(id_bytes)
        self._hash = hash((type(self).__name__, self._bytes))

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls._SIZE))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls._SIZE)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self._SIZE

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other):
        return self._bytes < other._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self.hex()[:16]}…)"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    _SIZE = _JOB_ID_SIZE
    __slots__ = ()

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(struct.pack("<I", value))


class NodeID(BaseID):
    _SIZE = _NODE_ID_SIZE
    __slots__ = ()


class WorkerID(BaseID):
    _SIZE = _NODE_ID_SIZE
    __slots__ = ()


class ActorID(BaseID):
    _SIZE = _ACTOR_ID_SIZE
    __slots__ = ()

    @classmethod
    def of(cls, job_id: JobID, parent_task_id: "TaskID", actor_index: int):
        import hashlib

        h = hashlib.sha256()
        h.update(job_id.binary())
        h.update(parent_task_id.binary())
        h.update(struct.pack("<I", actor_index))
        return cls(h.digest()[:cls._SIZE])


class TaskID(BaseID):
    _SIZE = _TASK_ID_SIZE
    __slots__ = ()

    @classmethod
    def for_job(cls, job_id: JobID) -> "TaskID":
        return cls(job_id.binary() + b"\x00" * (cls._SIZE - _JOB_ID_SIZE))

    @classmethod
    def of(cls, parent: "TaskID", submission_index: int) -> "TaskID":
        """Deterministic child-task ID: hash(parent || index)."""
        import hashlib

        h = hashlib.sha256()
        h.update(parent.binary())
        h.update(struct.pack("<Q", submission_index))
        return cls(h.digest()[: cls._SIZE])

    @classmethod
    def for_actor_task(
        cls, actor_id: ActorID, sequence_number: int
    ) -> "TaskID":
        import hashlib

        h = hashlib.sha256()
        h.update(actor_id.binary())
        h.update(struct.pack("<Q", sequence_number))
        return cls(h.digest()[: cls._SIZE])


class ObjectID(BaseID):
    """Derived from producing TaskID + return index (lineage-recoverable)."""

    _SIZE = _OBJECT_ID_SIZE
    __slots__ = ()

    @classmethod
    def for_task_return(cls, task_id: TaskID, return_index: int) -> "ObjectID":
        return cls(task_id.binary() + struct.pack("<I", return_index))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        # Put objects use the high bit of the index to avoid collision with
        # task returns.
        return cls(task_id.binary() + struct.pack("<I", put_index | 0x8000_0000))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[:_TASK_ID_SIZE])

    def return_index(self) -> int:
        return struct.unpack("<I", self._bytes[_TASK_ID_SIZE:])[0] & 0x7FFF_FFFF

    def is_put(self) -> bool:
        return bool(
            struct.unpack("<I", self._bytes[_TASK_ID_SIZE:])[0] & 0x8000_0000
        )


class _Counter:
    """Thread-safe monotonically increasing counter."""

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value
