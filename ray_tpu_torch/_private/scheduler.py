"""Local task scheduler: dependency resolution, resource-aware dispatch,
retries, cancellation and streaming outputs (counterpart of
``ray_tpu/_private/scheduler.py``, trimmed to the thread plane; without
lineage, as nothing here reconstructs a lost object).

A submitted task waits for its top-level ``ObjectRef`` arguments, then
queues by resource shape; the dispatcher thread hands every task whose
resources fit to a pool of executor threads, and an executor that
finishes a task pulls the next fitting one itself. Not ported: the
native ready-ring, the process plane (worker processes over the shm
store) and spillback to other nodes. The executor threads are daemons
that ``shutdown`` stops and joins (bounded), so no drive hangs at
interpreter exit.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.log import get_logger
from ray_tpu_torch.exceptions import RayTaskError, TaskCancelledError

log = get_logger(__name__)

# Bound on each join at shutdown: a task stuck in user code must not
# hang the caller of shutdown().
_JOIN_TIMEOUT_S = 2.0


@dataclass
class TaskSpec:
    """Immutable description of a submitted task (TaskSpecification parity)."""

    task_id: TaskID
    function: Callable
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    num_returns: int
    return_ids: List[ObjectID]
    name: str = ""
    resources: Dict[str, float] = field(default_factory=dict)
    max_retries: int = 0
    retry_exceptions: bool = False
    scheduling_strategy: Any = None
    # Streaming generator (num_returns="streaming"): return_ids holds only
    # the END MARKER; item objects commit dynamically per yield, with the
    # producer pausing at `backpressure` committed-but-unconsumed items.
    streaming: bool = False
    backpressure: int = 0
    # Filled by the scheduler:
    attempt: int = 0


class ResourcePool:
    """Node-local resource bookkeeping (CPU/GPU/custom, fractional allowed)."""

    def __init__(self, total: Dict[str, float]):
        self._total = dict(total)
        self._available = dict(total)
        self._cv = threading.Condition()
        self._release_listeners: List[Callable[[], None]] = []

    def add_release_listener(self, cb: Callable[[], None]):
        """Wakeup hook: ``cb`` fires after every release, OUTSIDE the
        pool lock (listeners take their own locks)."""
        with self._cv:
            self._release_listeners.append(cb)

    @property
    def total(self) -> Dict[str, float]:
        return dict(self._total)

    def available(self) -> Dict[str, float]:
        with self._cv:
            return dict(self._available)

    def try_acquire(self, demand: Dict[str, float]) -> bool:
        with self._cv:
            if all(self._available.get(k, 0.0) >= v - 1e-9
                   for k, v in demand.items()):
                for k, v in demand.items():
                    self._available[k] = self._available.get(k, 0.0) - v
                return True
            return False

    def release(self, demand: Dict[str, float]):
        with self._cv:
            for k, v in demand.items():
                self._available[k] = self._available.get(k, 0.0) + v
            self._cv.notify_all()
            listeners = list(self._release_listeners)
        for cb in listeners:
            cb()



class _ExecutorThreads:
    """Daemon executor threads over one queue, started on demand up to
    ``max_threads`` (a new thread only when none is idle, as
    ``concurrent.futures.ThreadPoolExecutor`` does), and joined by
    ``shutdown``."""

    def __init__(self, max_threads: int, name: str):
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self._max = max(int(max_threads), 1)
        self._name = name
        self._idle = threading.Semaphore(0)
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._closed = False

    def submit(self, fn: Callable, *args) -> None:
        self._queue.put((fn, args))
        if self._idle.acquire(timeout=0):
            return
        with self._lock:
            if self._closed or len(self._threads) >= self._max:
                return
            t = threading.Thread(target=self._run, daemon=True,
                                 name=f"{self._name}_{len(self._threads)}")
            self._threads.append(t)
        t.start()

    def _run(self):
        while True:
            item = self._queue.get()
            if item is None:
                return
            fn, args = item
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 — keep the thread serving
                log.exception("executor thread caught an error")
            del item, fn, args
            self._idle.release()

    def shutdown(self, timeout: float = _JOIN_TIMEOUT_S) -> None:
        with self._lock:
            self._closed = True
            threads = list(self._threads)
        for _ in threads:
            self._queue.put(None)
        deadline = time.monotonic() + timeout
        for t in threads:
            if t is not threading.current_thread():
                t.join(max(0.0, deadline - time.monotonic()))


class LocalScheduler:
    """Dependency-resolving, resource-aware FIFO dispatcher over a pool of
    executor threads, with retry + cancellation support."""

    def __init__(self, store, resource_pool: ResourcePool, num_workers: int):
        self._store = store
        self._resources = resource_pool
        self._lock = threading.Lock()
        # Runnable tasks bucketed by resource shape: dispatch picks the
        # lowest-sequence head whose shape fits *now*, trying each
        # distinct shape at most once per drain.
        self._runnable: Dict[tuple, Any] = {}  # shape -> deque[(seq, spec)]
        self._runnable_count = 0
        self._runnable_seq = 0
        self._pending_deps: Dict[TaskID, int] = {}
        self._cancelled: set = set()
        self._running: Dict[TaskID, threading.Event] = {}
        self._shutdown = False
        self._dispatch_cv = threading.Condition(self._lock)
        self._pool = _ExecutorThreads(num_workers, "ray_tpu_torch_worker")
        # Event-driven dispatch: a resource release signals the dispatch
        # condition.
        resource_pool.add_release_listener(self._on_resources_released)
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="ray_tpu_torch_dispatcher",
        )
        self._dispatcher.start()

    # ------------------------------------------------------------ submission
    def submit(self, spec: TaskSpec):
        """Owner-side submit: wait for deps, then queue."""
        dep_refs = _collect_refs(spec.args, spec.kwargs)
        with self._lock:
            if not dep_refs:
                self._make_runnable_locked(spec)
                return
            self._pending_deps[spec.task_id] = len(dep_refs)

        def _on_dep_ready():
            with self._lock:
                remaining = self._pending_deps.get(spec.task_id)
                if remaining is None:
                    return
                remaining -= 1
                if remaining == 0:
                    del self._pending_deps[spec.task_id]
                    self._make_runnable_locked(spec)
                else:
                    self._pending_deps[spec.task_id] = remaining

        for ref in dep_refs:
            self._store.on_ready(ref.object_id, _on_dep_ready)

    def _make_runnable_locked(self, spec: TaskSpec):
        self._runnable_seq += 1
        key = _shape_key(spec.resources)
        dq = self._runnable.get(key)
        if dq is None:
            dq = self._runnable[key] = deque()
        dq.append((self._runnable_seq, spec))
        self._runnable_count += 1
        self._dispatch_cv.notify_all()

    # -------------------------------------------------------------- dispatch
    def _drain_dispatchable_locked(self, limit: int = 0) -> List[TaskSpec]:
        """Pop every runnable task whose resources fit right now (up to
        ``limit`` when nonzero), FIFO across shape buckets. A shape that
        fails try_acquire is skipped for the rest of the drain."""
        batch: List[TaskSpec] = []
        blocked: Optional[set] = None
        while self._runnable_count:
            best_key = None
            best_seq = 0
            for key, dq in self._runnable.items():
                if blocked is not None and key in blocked:
                    continue
                seq = dq[0][0]
                if best_key is None or seq < best_seq:
                    best_key, best_seq = key, seq
            if best_key is None:
                break
            dq = self._runnable[best_key]
            spec = dq[0][1]
            if self._resources.try_acquire(spec.resources):
                dq.popleft()
                if not dq:
                    del self._runnable[best_key]
                self._runnable_count -= 1
                batch.append(spec)
                if limit and len(batch) >= limit:
                    break
            else:
                if blocked is None:
                    blocked = set()
                blocked.add(best_key)
        return batch

    def _on_resources_released(self):
        with self._lock:
            if self._runnable_count and not self._shutdown:
                self._dispatch_cv.notify_all()

    def _dispatch_loop(self):
        while True:
            with self._lock:
                while True:
                    if self._shutdown:
                        return
                    batch = self._drain_dispatchable_locked()
                    if batch:
                        break
                    self._dispatch_cv.wait()
            for spec in batch:
                self._pool.submit(self._execute, spec)

    # ------------------------------------------------------------- execution
    def _pick_next_inline(self) -> Optional[TaskSpec]:
        """Work-continuation: the executor that just finished a task pulls
        the next fitting one itself, skipping a dispatcher round trip."""
        with self._lock:
            if self._shutdown:
                return None
            batch = self._drain_dispatchable_locked(limit=1)
        return batch[0] if batch else None

    def _execute(self, spec: TaskSpec):
        nxt: Optional[TaskSpec] = spec
        while nxt is not None:
            nxt = self._execute_one(nxt)

    def _execute_one(self, spec: TaskSpec) -> Optional[TaskSpec]:
        from ray_tpu_torch._private import worker as worker_mod

        cancelled_event = threading.Event()
        with self._lock:
            cancelled_now = (spec.task_id in self._cancelled
                             or self._shutdown)
            if not cancelled_now:
                self._running[spec.task_id] = cancelled_event
        if cancelled_now:
            self._resources.release(spec.resources)
            self._finish_cancelled(spec)
            return self._pick_next_inline()

        retry_spec = None
        try:
            args, kwargs = _resolve_args(self._store, spec.args, spec.kwargs)
            ctx = worker_mod._task_context
            ctx.current_task_id = spec.task_id
            ctx.task_name = spec.name
            try:
                result = spec.function(*args, **kwargs)
                if spec.streaming:
                    self._stream_outputs(spec, result, cancelled_event)
            finally:
                ctx.current_task_id = None
                ctx.task_name = None
            if not spec.streaming:
                self._store_outputs(spec, result)
        except Exception as exc:  # noqa: BLE001 — task error boundary
            retry_spec = self._handle_failure(spec, exc)
        finally:
            with self._lock:
                self._running.pop(spec.task_id, None)
            self._resources.release(spec.resources)
            # Enqueue the retry only after this attempt's bookkeeping is
            # gone, so the retry's _running entry can't be popped by us.
            if retry_spec is not None:
                with self._lock:
                    self._make_runnable_locked(retry_spec)
        return self._pick_next_inline()

    def _stream_outputs(self, spec: TaskSpec, result: Any, cancelled_event):
        """Yield loop: each yield commits one dynamically created return
        object IMMEDIATELY (the consumer's next() unblocks on it), then
        the producer pauses while committed-but-unconsumed items have
        reached the backpressure budget. Cancellation (a closed generator
        or an explicit cancel) stops the loop between yields. A retry
        replays from yield 0; committed indices re-put idempotently."""
        from ray_tpu_torch._private.streaming import (
            stream_end_id,
            stream_item_id,
        )
        from ray_tpu_torch._private.worker import global_worker

        if not hasattr(result, "__iter__") and \
                not hasattr(result, "__next__"):
            raise TypeError(
                f"task {spec.name!r} declared num_returns='streaming' but "
                f"returned non-iterable {type(result).__name__}")
        worker = global_worker()
        ctx = worker.serialization_context
        stream = worker.streams.get_or_create(spec.task_id)
        it = iter(result)
        idx = 0
        try:
            for item in it:
                if cancelled_event.is_set() or stream.cancelled:
                    raise TaskCancelledError(spec.task_id)
                self._store.put(stream_item_id(spec.task_id, idx),
                                ctx.serialize(item))
                stream.commit(idx)
                idx += 1
                if not stream.wait_capacity(spec.backpressure,
                                            cancelled_event):
                    raise TaskCancelledError(spec.task_id)
        except BaseException:
            close = getattr(it, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 — generator cleanup
                    pass
            raise
        self._store.put(stream_end_id(spec.task_id), ctx.serialize(idx))
        stream.finish(idx)

    def _store_outputs(self, spec: TaskSpec, result: Any):
        from ray_tpu_torch._private.worker import global_worker

        ctx = global_worker().serialization_context
        if spec.num_returns <= 1:
            outputs = [result]
        else:
            outputs = list(result)
            if len(outputs) != spec.num_returns:
                raise ValueError(
                    f"task {spec.name!r} declared num_returns="
                    f"{spec.num_returns} but returned {len(outputs)} values"
                )
        for oid, value in zip(spec.return_ids, outputs):
            self._store.put(oid, ctx.serialize(value))

    def _handle_failure(self, spec: TaskSpec, exc: Exception):
        is_app_error = not isinstance(exc, (SystemError, MemoryError))
        retriable = spec.attempt < spec.max_retries and (
            spec.retry_exceptions or not is_app_error
        )
        if retriable and not isinstance(exc, TaskCancelledError):
            return dataclasses.replace(spec, attempt=spec.attempt + 1)
        if isinstance(exc, (TaskCancelledError, RayTaskError)):
            error = exc  # typed dependency/cancel failures stay unwrapped
        else:
            error = RayTaskError.from_exception(spec.name, exc)
        for oid in spec.return_ids:
            self._store.put_error(oid, error)
        if spec.streaming:
            self._fail_stream(spec, error)
        return None

    def _fail_stream(self, spec: TaskSpec, error: BaseException):
        """Terminal streaming failure: record it on the stream state so a
        paused producer/consumer wakes."""
        from ray_tpu_torch._private.worker import _try_global_worker

        w = _try_global_worker()
        if w is None:
            return
        stream = w.streams.get(spec.task_id)
        if stream is not None:
            stream.set_error(error)

    def _finish_cancelled(self, spec: TaskSpec):
        err = TaskCancelledError(spec.task_id)
        for oid in spec.return_ids:
            self._store.put_error(oid, err)

    # ----------------------------------------------------------- cancel/misc
    def cancel(self, task_id: TaskID, force: bool = False) -> bool:
        """Cancel a task. A queued (runnable) task is removed and its
        outputs fail with ``TaskCancelledError`` at once (returns True);
        a running one gets its cooperative cancel event (a streaming
        task stops between yields); a task still waiting for its
        arguments is dropped when they resolve. A thread cannot be
        killed, so ``force`` adds nothing here."""
        with self._lock:
            self._cancelled.add(task_id)
            found = None
            for key, dq in self._runnable.items():
                for i, (_, spec) in enumerate(dq):
                    if spec.task_id == task_id:
                        found = (key, i, spec)
                        break
                if found:
                    break
            if found is None:
                ev = self._running.get(task_id)
                if ev is not None:
                    ev.set()
                return False
            key, i, spec = found
            dq = self._runnable[key]
            del dq[i]
            if not dq:
                del self._runnable[key]
            self._runnable_count -= 1
        self._finish_cancelled(spec)
        return True

    def shutdown(self):
        """Stop dispatching, signal every running task's cancel event,
        and join the dispatcher and the executor threads (bounded)."""
        with self._lock:
            self._shutdown = True
            running = list(self._running.values())
            self._dispatch_cv.notify_all()
        for ev in running:
            ev.set()
        self._dispatcher.join(timeout=_JOIN_TIMEOUT_S)
        self._pool.shutdown()


def _shape_key(resources: Dict[str, float]) -> tuple:
    """Hashable resource-demand shape (dispatch bucket key)."""
    return tuple(sorted(resources.items()))


def _collect_refs(args, kwargs) -> list:
    """Top-level ObjectRef args are awaited + inlined (reference semantics:
    nested refs inside structures are NOT resolved)."""
    from ray_tpu_torch._private.worker import ObjectRef

    refs = [a for a in args if isinstance(a, ObjectRef)]
    refs += [v for v in kwargs.values() if isinstance(v, ObjectRef)]
    return refs


def _resolve_args(store, args, kwargs):
    from ray_tpu_torch._private.worker import ObjectRef, global_worker

    ctx = global_worker().serialization_context

    def _resolve(v):
        if isinstance(v, ObjectRef):
            serialized = store.get(v.object_id)
            value = ctx.deserialize(serialized)
            if isinstance(value, RayTaskError):
                raise value.as_instanceof_cause()
            return value
        return v

    return (
        tuple(_resolve(a) for a in args),
        {k: _resolve(v) for k, v in kwargs.items()},
    )
