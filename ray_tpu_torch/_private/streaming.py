"""Streaming-generator plane: per-task stream state + registry (copy of
``ray_tpu/_private/streaming.py``).

A ``num_returns="streaming"`` task commits one object per yield,
``ObjectID.for_task_return(task_id, i)``: item refs derived from the task
id exactly like static returns. One ``StreamState`` per task holds both
roles in one process (across nodes, the producing node's commit
listeners report each yield and the consumer's consume listeners ack
it back): the producer counts committed yields and
pauses its yield loop while committed-but-unconsumed items reach the
backpressure budget (``RAY_TPU_GENERATOR_BACKPRESSURE_ITEMS``); the
consumer (the ``ObjectRefGenerator``) advances the consumed watermark at
``next()``, which wakes the paused producer.

End-of-stream is itself an object, the STREAM END MARKER
(``ObjectID.for_task_return(task_id, STREAM_END_INDEX)``): it commits
the total item count when the generator finishes, or the task's error,
so the completion machinery (submitted-ref release, typed errors,
``wait``) applies to streaming tasks unchanged.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from ray_tpu_torch._private.ids import STREAM_END_INDEX, ObjectID, TaskID

__all__ = ["STREAM_END_INDEX", "StreamState", "StreamRegistry",
           "stream_item_id", "stream_end_id"]


def stream_item_id(task_id: TaskID, index: int) -> ObjectID:
    """The dynamically-created return ref of one yield."""
    if index >= STREAM_END_INDEX:
        raise ValueError(
            f"streaming generator yielded more than {STREAM_END_INDEX} "
            f"items (index space exhausted)")
    return ObjectID.for_task_return(task_id, index)


def stream_end_id(task_id: TaskID) -> ObjectID:
    return ObjectID.for_task_return(task_id, STREAM_END_INDEX)


class StreamState:
    """Producer/consumer bookkeeping for one streaming-generator task."""

    __slots__ = ("task_id", "_cv", "committed", "consumed", "finished",
                 "error", "cancelled", "peak_unconsumed", "paused_events",
                 "_commit_cbs", "_consume_cbs", "known_remote_sizes")

    def __init__(self, task_id: TaskID):
        self.task_id = task_id
        self._cv = threading.Condition()
        self.committed = 0          # contiguous commit count (producer side)
        self.consumed = 0           # consumer watermark (next() returns)
        self.finished: Optional[int] = None  # total items once producer ends
        self.error: Optional[BaseException] = None
        self.cancelled = False
        # The most committed-but-unconsumed items this producer reached,
        # and how often it paused at its budget.
        self.peak_unconsumed = 0
        self.paused_events = 0
        # Commit listeners: a node daemon reports each yield to the
        # consuming driver (item_done).
        self._commit_cbs: List[Callable[[int, ObjectID], None]] = []
        # Consumption listeners: the process plane forwards each new
        # watermark to the producing worker process, the node plane to
        # the producing node.
        self._consume_cbs: List[Callable[[int], None]] = []
        # Consumer side: item index -> byte size of items whose bytes
        # stayed on the producing node (pulled at next()).
        self.known_remote_sizes: Dict[int, int] = {}

    # ------------------------------------------------------------- producer
    def commit(self, index: int):
        """One yield's object is in the store (in index order)."""
        with self._cv:
            if index + 1 > self.committed:
                self.committed = index + 1
            gap = self.committed - self.consumed
            if gap > self.peak_unconsumed:
                self.peak_unconsumed = gap
            cbs = list(self._commit_cbs)
            self._cv.notify_all()
        oid = stream_item_id(self.task_id, index)
        for cb in cbs:  # outside the lock: listeners take their own locks
            cb(index, oid)

    def wait_capacity(self, budget: int,
                      cancel_event: Optional[threading.Event] = None,
                      poll_s: float = 0.1) -> bool:
        """Producer pause point: block while committed-but-unconsumed items
        have reached ``budget`` (0 = unlimited). Returns False when the
        stream was cancelled (the yield loop should stop)."""
        if budget <= 0:
            return not self.cancelled
        first = True
        with self._cv:
            while (self.committed - self.consumed >= budget
                   and not self.cancelled):
                if cancel_event is not None and cancel_event.is_set():
                    return False
                if first:
                    self.paused_events += 1
                    first = False
                # The cv wakes on advance_consumed/cancel; the bounded
                # wait only covers an external cancel_event flip.
                self._cv.wait(poll_s)
            return not self.cancelled

    def finish(self, total: int):
        with self._cv:
            self.finished = total
            self._cv.notify_all()

    def set_error(self, exc: BaseException):
        with self._cv:
            if self.error is None:
                self.error = exc
            self._cv.notify_all()

    def cancel(self):
        with self._cv:
            self.cancelled = True
            self._cv.notify_all()

    # ------------------------------------------------------------- consumer
    def advance_consumed(self, n: int):
        """Consumption watermark moved to ``n`` (monotonic): wakes the
        paused yield loop and fires the consumption listeners (outside
        the lock)."""
        with self._cv:
            if n <= self.consumed:
                return
            self.consumed = n
            cbs = list(self._consume_cbs)
            self._cv.notify_all()
        for cb in cbs:
            cb(n)

    def add_commit_listener(self, cb: Callable[[int, ObjectID], None]):
        with self._cv:
            self._commit_cbs.append(cb)

    def add_consume_listener(self, cb: Callable[[int], None]):
        with self._cv:
            self._consume_cbs.append(cb)


class StreamRegistry:
    """task_id -> StreamState table of the runtime."""

    def __init__(self):
        self._streams: Dict[TaskID, StreamState] = {}
        self._lock = threading.Lock()

    def get_or_create(self, task_id: TaskID) -> StreamState:
        with self._lock:
            st = self._streams.get(task_id)
            if st is None:
                st = self._streams[task_id] = StreamState(task_id)
            return st

    def get(self, task_id: TaskID) -> Optional[StreamState]:
        with self._lock:
            return self._streams.get(task_id)

    def pop(self, task_id: TaskID) -> Optional[StreamState]:
        with self._lock:
            return self._streams.pop(task_id, None)

    def __len__(self):
        with self._lock:
            return len(self._streams)
