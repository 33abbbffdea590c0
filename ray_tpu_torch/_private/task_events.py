"""Task state-event ring buffer powering the state API and the timeline
(copy of ``ray_tpu/_private/task_events.py``).

Every task and actor call records its state transitions with timestamps
into a bounded ring; ``util.state`` lists and summarises them and
``ray_tpu_torch.timeline()`` renders them as Chrome-tracing JSON. When
tracing is armed, every recorded transition also bridges into
``_private/tracing.py`` spans (time spent per state). Node daemons
ship their rings home piggybacked on their completion reports
(``drain_since`` on the node, ``ingest`` on the driver), so a driver's
``util.state.list_tasks()`` sees cluster tasks with no new head RPC.
"""

from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from ray_tpu_torch._private import tracing

_TERMINAL = ("FINISHED", "FAILED")


@dataclass
class TaskEvent:
    task_id: object
    state: str
    timestamp: float
    name: str = ""
    duration: Optional[float] = None
    extra: dict = field(default_factory=dict)


class TaskEventBuffer:
    def __init__(self, capacity: int = 100_000):
        self._events = collections.deque(maxlen=capacity)
        self._latest_state: Dict[object, TaskEvent] = {}
        # Deterministic terminal-state eviction: task ids whose latest
        # state is terminal, oldest first. Bounded at the ring capacity,
        # so the index holds at most (live tasks + capacity) entries —
        # the old threshold-scan path could retain stale terminal
        # states unboundedly ahead of the ring under churn.
        self._terminal_order: "collections.deque" = collections.deque()
        self._seq = 0  # monotonic event counter (node->driver shipping)
        self._lock = threading.Lock()

    def record(self, task_id, state: str, name: str = "",
               duration: Optional[float] = None, **extra):
        ev = TaskEvent(task_id, state, time.time(), name, duration, extra)
        traced = tracing._TRACER is not None
        with self._lock:
            self._append_locked(ev)
            prev = self._latest_state.get(task_id) if traced else None
            self._latest_state[task_id] = ev
            if state in _TERMINAL:
                self._terminal_order.append(task_id)
                self._evict_terminal_locked()
        if traced:
            tracing.on_task_event(task_id, state, name, prev)

    def _append_locked(self, ev: TaskEvent):
        self._events.append(ev)
        self._seq += 1
        ev.extra.setdefault("_seq", self._seq)

    def _evict_terminal_locked(self):
        # Evict on terminal RECORD, oldest terminal first. A task that
        # re-ran after finishing (lineage replay) re-enters
        # _terminal_order on its next terminal record, so dropping a
        # stale marker whose task is live again is safe.
        while len(self._terminal_order) > self._events.maxlen:
            tid = self._terminal_order.popleft()
            latest = self._latest_state.get(tid)
            if latest is not None and latest.state in _TERMINAL:
                del self._latest_state[tid]

    def ingest(self, events: Iterable[Tuple]) -> int:
        """Merge events shipped from another process (a node daemon's
        ring riding its completion-report batches): tuples of
        ``(task_id, state, timestamp, name, duration, node)``. Original
        timestamps are preserved; the source node lands in ``extra``."""
        count = 0
        with self._lock:
            for task_id, state, ts, name, duration, node in events:
                ev = TaskEvent(task_id, state, float(ts), name, duration,
                               {"node": node})
                self._append_locked(ev)
                prev = self._latest_state.get(task_id)
                # Last-writer-wins by ORIGINAL timestamp within a state
                # class, but terminal beats non-terminal outright: the
                # shipping node's clock may trail this process's (NTP
                # skew), and a FINISHED stamped "earlier" than the local
                # PENDING record must still land — and a stale replayed
                # RUNNING must never regress a terminal state.
                prev_terminal = (prev is not None
                                 and prev.state in _TERMINAL)
                new_terminal = state in _TERMINAL
                if prev is None or (new_terminal and not prev_terminal):
                    take = True
                elif prev_terminal and not new_terminal:
                    take = False
                else:
                    take = prev.timestamp <= ev.timestamp
                if take:
                    self._latest_state[task_id] = ev
                    if new_terminal and not prev_terminal:
                        self._terminal_order.append(task_id)
                        self._evict_terminal_locked()
                count += 1
        # No tracing bridge here: the recording process already emitted
        # spans for these transitions into ITS ring — re-bridging would
        # duplicate every span in the assembled trace.
        return count

    def drain_since(self, cursor: int, limit: int = 4096
                    ) -> Tuple[int, List[TaskEvent]]:
        """Events recorded after ``cursor`` (a sequence number from a
        previous call), newest-bounded: the node daemon's reporter
        piggybacks these onto its coalesced completion batches. Returns
        ``(new_cursor, events)``; O(new events), not O(ring)."""
        with self._lock:
            if self._seq <= cursor:
                return self._seq, []
            fresh: List[TaskEvent] = []
            for ev in reversed(self._events):
                if ev.extra.get("_seq", 0) <= cursor:
                    break
                fresh.append(ev)
            fresh.reverse()
            if len(fresh) > limit:
                # Truncate from the FRONT but advance the cursor only
                # to the last shipped event, so the rest ship next
                # flush instead of being silently skipped.
                fresh = fresh[:limit]
            new_cursor = fresh[-1].extra["_seq"] if fresh else self._seq
            return new_cursor, fresh

    def index_size(self) -> int:
        with self._lock:
            return len(self._latest_state)

    def latest_seq(self) -> int:
        with self._lock:
            return self._seq

    def list_events(self, limit: int = 10_000) -> List[TaskEvent]:
        with self._lock:
            return list(self._events)[-limit:]

    def list_tasks(self, state: Optional[str] = None,
                   limit: int = 10_000) -> List[TaskEvent]:
        with self._lock:
            out = [
                ev for ev in self._latest_state.values()
                if state is None or ev.state == state
            ]
        return out[:limit]

    def summary(self) -> Dict[str, int]:
        with self._lock:
            counts: Dict[str, int] = {}
            for ev in self._latest_state.values():
                counts[ev.state] = counts.get(ev.state, 0) + 1
            return counts

    def to_chrome_trace(self) -> List[dict]:
        """Chrome-tracing JSON events (`ray timeline` parity)."""
        events = self.list_events()
        trace = []
        starts: Dict[object, TaskEvent] = {}
        for ev in events:
            if ev.state == "RUNNING":
                starts[ev.task_id] = ev
            elif ev.state in _TERMINAL:
                st = starts.pop(ev.task_id, None)
                if st is not None:
                    trace.append({
                        "name": ev.name or "task",
                        "cat": "task",
                        "ph": "X",
                        "ts": st.timestamp * 1e6,
                        "dur": max((ev.timestamp - st.timestamp) * 1e6, 1),
                        "pid": 0,
                        "tid": 0,
                        "args": {"state": ev.state,
                                 "node": ev.extra.get("node", "")},
                    })
        return trace
