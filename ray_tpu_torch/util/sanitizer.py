"""Host-plane runtime sanitizers (copy of ``ray_tpu/util/sanitizer.py``).

The device plane needs no race detection here: a kernel's threads write
disjoint tiles by construction. The host plane's correctness rests on a
handful of protocol invariants, and this module checks them live when
``RAY_TPU_SANITIZE=1`` (or ``enable()``):

- **Refcount sanity** (object store): ``local_refs``/``submitted_refs``
  must never go negative — an underflow is a double-release race that
  silently frees objects still in use.
- **Channel protocol** (compiled-DAG channels): each reader must
  observe versions in strict +1 succession — a skip is a lost payload
  (torn write / double-bump race), a repeat is a double-read.
- **Stall watchdog**: tasks stuck in the scheduler beyond a threshold
  with idle capacity — the observable shape of a host-side deadlock —
  are reported. ``init()`` starts it when the sanitizer is enabled and
  ``shutdown()`` stops and joins it.
- **Lock-order watcher**: ``tracked_lock``/``tracked_rlock`` wrappers
  record, per thread, which locks are held when another is acquired,
  building a global lock-order graph. The first acquisition that would
  close a cycle raises ``SanitizerError`` *before blocking* — surfacing
  the A→B / B→A deadlock on the lucky interleaving instead of hanging on
  the unlucky one. Tracked locks also feed the flight recorder's lock
  plane when it is armed.

Violations raise ``SanitizerError`` by default (tests), or log when
``RAY_TPU_SANITIZE_MODE=warn`` (long-lived processes).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private import flight as _flight
from ray_tpu_torch._private.log import get_logger

log = get_logger("sanitizer")


class SanitizerError(AssertionError):
    """A host-plane invariant the sanitizer watches was violated."""


_enabled: Optional[bool] = None
_violations: List[str] = []
_lock = threading.Lock()

# Stall-watchdog fires observed by THIS process (summed with the
# flight recorder's watchdog fires into the framework metrics gauge —
# this counter covers the flight-disarmed case).
watchdog_fires = 0


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get("RAY_TPU_SANITIZE", "0") == "1"
    return _enabled


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def violations() -> List[str]:
    with _lock:
        return list(_violations)


def clear() -> None:
    with _lock:
        _violations.clear()
    with channel_checker._lock:
        channel_checker._last.clear()
    lock_order_watcher.reset()


def report(kind: str, message: str, force_warn: bool = False) -> None:
    full = f"{kind}: {message}"
    with _lock:
        _violations.append(f"[ray_tpu sanitizer] {full}")
    if force_warn or os.environ.get(
            "RAY_TPU_SANITIZE_MODE", "raise") == "warn":
        # RAY_TPU_LOG_LEVEL governs this: a violation an operator chose
        # not to raise on is still an ERROR-level condition, never a
        # bare print.
        log.error("%s", full)
    else:
        raise SanitizerError(f"[ray_tpu sanitizer] {full}")


_channel_ids = threading.Lock()
_channel_counter = [0]


def new_channel_id() -> int:
    """Stable unique channel token — id() reuse after GC would alias
    a fresh channel onto a dead one's sequence state."""
    with _channel_ids:
        _channel_counter[0] += 1
        return _channel_counter[0]


# ---------------------------------------------------------------- refcounts
def check_refcount(object_id, local_refs: int, submitted_refs: int) -> None:
    """Called by the object store after every decrement (when enabled):
    a negative count is a double-release — the race that frees objects
    still referenced."""
    if local_refs < 0 or submitted_refs < 0:
        report(
            "refcount-underflow",
            f"object {object_id.hex()[:16]}… local_refs={local_refs} "
            f"submitted_refs={submitted_refs} (double release)")


# ----------------------------------------------------------------- channels
class ChannelSequenceChecker:
    """Per-(channel, reader) version-succession invariant: versions must
    arrive as v+1, v+2, … — a gap is a lost payload, a repeat is a
    double-read."""

    def __init__(self):
        self._last: Dict[tuple, int] = {}
        self._lock = threading.Lock()

    def observe(self, channel_id: int, reader_id: int,
                version: int) -> None:
        key = (channel_id, reader_id)
        with self._lock:
            last = self._last.get(key, 0)
            self._last[key] = version
        if version == last:
            report("channel-double-read",
                   f"channel {channel_id:#x} reader {reader_id} observed "
                   f"version {version} twice")
        elif version != last + 1:
            report("channel-version-gap",
                   f"channel {channel_id:#x} reader {reader_id} jumped "
                   f"{last} -> {version} (lost payload)")


channel_checker = ChannelSequenceChecker()


# --------------------------------------------------------- lock-order watcher
class LockOrderWatcher:
    """Runtime lock-order cycle detection over ``tracked_lock`` locks.

    Each thread keeps its held-lock stack (thread-local); acquiring B
    while holding A records the directed edge A→B in a process-global
    graph. Before an acquisition that adds edges, the watcher searches
    for a path from the new lock back to any currently-held one — such
    a path plus the new edge is a cycle, i.e. two code paths take these
    locks in opposite orders and the right interleaving deadlocks them.
    The report fires on the FIRST order inversion, deterministically,
    without needing the deadlock to actually happen."""

    def __init__(self):
        self._edges: Dict[str, set] = {}
        self._graph_lock = threading.Lock()
        self._tls = threading.local()
        self._stacks: List[list] = []  # every thread's stack, for reset

    def _stack(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
            with self._graph_lock:
                self._stacks.append(stack)
        return stack

    def reset(self) -> None:
        """Test-boundary cleanup: drop the edge graph AND every
        thread's held-stack (a stack entry surviving an enable()
        toggle would otherwise poison later runs with false edges)."""
        with self._graph_lock:
            self._edges.clear()
            for stack in self._stacks:
                stack.clear()

    def edges(self) -> Dict[str, set]:
        with self._graph_lock:
            return {k: set(v) for k, v in self._edges.items()}

    def _path_to_any(self, start: str, targets: set) -> Optional[list]:
        """DFS path start →* (any target) over the edge graph; caller
        holds _graph_lock."""
        seen = {start}
        path = [start]

        def dfs(node: str) -> bool:
            for nxt in sorted(self._edges.get(node, ())):
                if nxt in targets:
                    path.append(nxt)
                    return True
                if nxt not in seen:
                    seen.add(nxt)
                    path.append(nxt)
                    if dfs(nxt):
                        return True
                    path.pop()
            return False

        return path if dfs(start) else None

    def on_acquire(self, name: str) -> None:
        """Called BEFORE blocking on the underlying lock."""
        stack = self._stack()
        if stack:
            held = set(stack)
            with self._graph_lock:
                for h in stack:
                    if h != name:
                        self._edges.setdefault(h, set()).add(name)
                cycle = self._path_to_any(name, held) \
                    if name not in held else [name, name]
            if cycle is not None:
                report(
                    "lock-order-cycle",
                    f"acquiring {name!r} while holding "
                    f"{stack!r} closes the cycle "
                    f"{' -> '.join(cycle)} -> {name!r} seen in the "
                    f"opposite order elsewhere — two threads taking "
                    f"these locks concurrently deadlock")
        stack.append(name)

    def on_acquired_failed(self, name: str) -> None:
        """Non-blocking acquire that returned False: undo the stack
        entry optimistically pushed by on_acquire."""
        stack = self._stack()
        if name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]

    def on_release(self, name: str) -> None:
        stack = self._stack()
        if name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]


lock_order_watcher = LockOrderWatcher()


class TrackedLock:
    """``threading.Lock``-compatible wrapper feeding the lock-order
    watcher. When the sanitizer is disabled the overhead is one
    ``enabled()`` check per acquire — cheap enough to wire into
    control-plane locks permanently."""

    _factory = staticmethod(threading.Lock)

    def __init__(self, name: str):
        self.name = name
        self._lock = self._factory()
        self._tracked = threading.local()  # was THIS hold recorded?

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if enabled():
            lock_order_watcher.on_acquire(self.name)
            ok = self._lock.acquire(blocking, timeout)
            if not ok:
                lock_order_watcher.on_acquired_failed(self.name)
            else:
                self._tracked.held = True
        else:
            ok = self._lock.acquire(blocking, timeout)
        # Flight-recorder hold timing (independent of the sanitizer
        # arming): hold durations feed the lock.hold outlier events
        # and the lock-hold watchdog's held-too-long scan. Off = one
        # module-global load + `is None` branch.
        if ok and _flight._FLIGHT is not None:
            _flight.note_lock_acquired(self.name)
        return ok

    def release(self) -> None:
        self._lock.release()
        # Pop keyed on whether the ACQUIRE was tracked, not on the
        # current enabled() state: toggling the sanitizer off while a
        # lock is held must not strand its stack entry (false edges —
        # and false cycles — forever after).
        if getattr(self._tracked, "held", False):
            self._tracked.held = False
            lock_order_watcher.on_release(self.name)
        if _flight._FLIGHT is not None:
            _flight.note_lock_released(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TrackedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<TrackedLock {self.name!r} {self._lock!r}>"


class TrackedRLock(TrackedLock):
    """Re-entrant variant: repeated acquisition by the owner is legal
    and is not an order edge — only the 0→1 transition records order,
    only the 1→0 transition pops the held stack (per-thread depth)."""

    _factory = staticmethod(threading.RLock)

    def __init__(self, name: str):
        super().__init__(name)
        self._depth = threading.local()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # Depth is tracked whenever either checker could care (the
        # flight recorder times 0→1 … 1→0 holds even with the
        # sanitizer off); `watched` remembers whether the 0→1
        # transition notified the lock-order watcher, so a mid-hold
        # enable/disable toggle can neither strand nor double-pop a
        # stack entry.
        d = getattr(self._depth, "n", 0)
        if d == 0:
            watched = enabled()
            if watched:
                lock_order_watcher.on_acquire(self.name)
            ok = self._lock.acquire(blocking, timeout)
            if not ok:
                if watched:
                    lock_order_watcher.on_acquired_failed(self.name)
                return ok
            self._depth.watched = watched
            if _flight._FLIGHT is not None:
                _flight.note_lock_acquired(self.name)
        else:
            ok = self._lock.acquire(blocking, timeout)
            if not ok:
                return ok
        self._depth.n = d + 1
        return ok

    def release(self) -> None:
        self._lock.release()
        d = getattr(self._depth, "n", 0)
        if d > 0:
            self._depth.n = d - 1
            if d == 1:
                if getattr(self._depth, "watched", False):
                    self._depth.watched = False
                    lock_order_watcher.on_release(self.name)
                if _flight._FLIGHT is not None:
                    _flight.note_lock_released(self.name)

    def locked(self) -> bool:
        # threading.RLock grows .locked() only in 3.14; emulate it:
        # owned-by-me counts as locked, else a non-blocking probe
        # (which for an UNHELD rlock succeeds and is undone).
        is_owned = getattr(self._lock, "_is_owned", None)
        if is_owned is not None and is_owned():
            return True
        if self._lock.acquire(blocking=False):
            self._lock.release()
            return False
        return True


def tracked_lock(name: str) -> TrackedLock:
    """A Lock whose acquires feed the lock-order watcher under
    ``RAY_TPU_SANITIZE=1`` (plain Lock semantics otherwise)."""
    return TrackedLock(name)


def tracked_rlock(name: str) -> TrackedRLock:
    return TrackedRLock(name)


# ------------------------------------------------------------ stall watchdog
class StallWatchdog:
    """Background detector for the observable shape of a host deadlock:
    the scheduler holds queued tasks beyond `threshold_s` while worker
    capacity sits idle (nothing running). Reports task names."""

    def __init__(self, scheduler, resource_pool,
                 threshold_s: float = 30.0, period_s: float = 5.0):
        self._scheduler = scheduler
        self._pool = resource_pool
        self.threshold_s = threshold_s
        self._period = period_s
        self._stalled_since: Optional[float] = None
        self._finished_mark = -1
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ray_tpu_sanitizer_watch")
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self._period):
            try:
                self._check()
            except Exception as exc:  # watcher must not die
                log.warning("stall watchdog check failed: %r", exc)

    def _check(self):
        s = self._scheduler
        backlog = s.backlog_size()
        running = getattr(s, "num_running", lambda: 0)()
        finished = getattr(s, "num_finished", lambda: 0)()
        queued = backlog - running
        avail = self._pool.available()
        idle = avail.get("CPU", 0.0) >= 1.0
        # The deadlock shape: tasks QUEUED (not merely long-running),
        # nothing executing, capacity idle, and zero completions across
        # the window. A long-running task (running > 0) or any progress
        # resets the clock.
        if queued > 0 and running == 0 and idle:
            now = time.monotonic()
            if self._stalled_since is None \
                    or finished != self._finished_mark:
                self._stalled_since = now
                self._finished_mark = finished
            elif now - self._stalled_since > self.threshold_s:
                self._stalled_since = None
                msg = (f"{queued} task(s) queued > {self.threshold_s}s "
                       f"with nothing running and idle capacity {avail} "
                       f"— possible host deadlock (dependency cycle or "
                       f"lost completion)")
                # Escalate through the flight recorder when armed: the
                # stall captures an automatic local dump (all-thread
                # stacks + event ring + scheduler depths) instead of
                # only logging what was stuck. Exactly ONE counter
                # takes the fire — the recorder's when armed, this
                # module's otherwise — because the metrics gauge sums
                # the two.
                if _flight._FLIGHT is not None:
                    _flight.note_watchdog_fire("scheduler-stall", msg)
                else:
                    global watchdog_fires
                    with _lock:
                        watchdog_fires += 1
                # force_warn: raising in our own daemon thread would
                # only kill the watchdog, not surface the error.
                report("scheduler-stall", msg, force_warn=True)
        else:
            self._stalled_since = None

    def stop(self, timeout: float = 5.0):
        """Stop the loop and join its thread (bounded)."""
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)
