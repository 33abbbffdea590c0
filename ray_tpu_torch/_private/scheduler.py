"""Local task scheduler: dependency resolution, resource-aware dispatch,
retries, cancellation and streaming outputs, on the thread plane or the
process plane (counterpart of ``ray_tpu/_private/scheduler.py``; without
lineage, as nothing here reconstructs a lost object).

A submitted task waits for its top-level ``ObjectRef`` arguments, then
queues by resource shape; the dispatcher thread hands every task whose
resources fit to a pool of executor threads, and an executor that
finishes a task pulls the next fitting one itself. Each task records its
state transitions into the worker's task-event ring (PENDING_ARGS_AVAIL,
PENDING_NODE_ASSIGNMENT, RUNNING, FINISHED, FAILED, as the reference's
scheduler does) and marks its execution for the flight recorder's
task-stuck watchdog.

On the process plane (``worker_mode="process"``) an executor thread
leases a worker process and ships the task to it over the native shm
store: functions by ``cloudpickle``, values in the wire form, so a CUDA
tensor argument arrives on the CPU. A task's outputs stay resident in
the shm store, so a downstream process task reads them in place (its ref
argument passes as a shm key); the store's evict callback releases them.
A dead worker fails only its task (``WorkerCrashedError``, retriable),
``cancel(force=True)`` kills the worker running the task, and the memory
monitor's kill surfaces as ``OutOfMemoryError``. Dependencies between
pending tasks are tracked in Python on both planes: the reference's
native ready-ring (``_submit_native``) is left out, as no reading showed
it faster than this path, and ``NativeDynQueue`` stays a library of
``_native``. Spillback to other nodes is the router's
(``_private/remote_router.py``, ahead of this scheduler). The executor
threads are daemons that ``shutdown`` stops and joins (bounded), so no
drive hangs at interpreter exit.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch._private import flight as _flight
from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.log import get_logger
from ray_tpu_torch.exceptions import (
    OutOfMemoryError,
    RayTaskError,
    RuntimeEnvSetupError,
    TaskCancelledError,
    WorkerCrashedError,
    WorkerPoolExhaustedError,
)

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
    # A RuntimeEnv (runtime_env.py) or None: applied around the call on
    # the thread plane, shipped to the worker on the process plane.
    runtime_env: Any = None
    # Streaming generator (num_returns="streaming"): return_ids holds only
    # the END MARKER; item objects commit dynamically per yield, with the
    # producer pausing at `backpressure` committed-but-unconsumed items.
    streaming: bool = False
    backpressure: int = 0
    # Trace context wire form ((trace_id, span_id) or None): captured
    # from the submitting thread's ambient context when tracing is armed.
    trace: Any = None
    # Filled by the scheduler:
    attempt: int = 0


def _env_fields(spec: TaskSpec):
    """The task's runtime env as a plain dict for the worker's message
    (None without one)."""
    return dict(spec.runtime_env) if spec.runtime_env is not None else None


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

    def fits(self, demand: Dict[str, float]) -> bool:
        """Whether ``demand`` fits the pool's total (held or not)."""
        return all(self._total.get(k, 0.0) >= v for k, v in demand.items())

    def utilization(self) -> float:
        """The most-used resource's held fraction (the cluster's
        placement policies read it)."""
        with self._cv:
            fracs = [1.0 - self._available.get(k, 0.0) / v
                     for k, v in self._total.items() if v > 0]
            return max(fracs) if fracs else 0.0

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

    def __init__(self, store, resource_pool: ResourcePool, num_workers: int,
                 task_events=None, worker_pool=None, shm_store=None,
                 lineage: Optional[dict] = None):
        self._store = store
        self._resources = resource_pool
        self._events = task_events
        # Submitted specs by task id, when a lineage table is given (the
        # simulated cluster's, for reconstruction after a node's loss).
        self._lineage = lineage
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
        self._num_finished = 0
        self._shutdown = False
        self._dispatch_cv = threading.Condition(self._lock)
        self._pool = _ExecutorThreads(num_workers, "ray_tpu_torch_worker")
        # The process plane (WorkerPool over the shm store): tasks run in
        # worker processes when it is present.
        self._worker_pool = worker_pool
        self._shm_store = shm_store
        self._proc_running: Dict[TaskID, Any] = {}   # task -> WorkerProcess
        # Successful outputs STAY in the shm store: a consumer's ref
        # argument passes as a shm key the worker reads directly. Entries
        # release when the driver's store evicts the object. Touched with
        # GIL-atomic dict operations only, never under self._lock: the
        # evict callback runs under the store's lock, so the two locks
        # never nest.
        self._shm_resident: Dict[Any, int] = {}   # ObjectID -> shm key
        self._shm_key_pins: Dict[int, int] = {}   # key -> in-flight reads
        self._deferred_deletes: set = set()   # pinned keys awaiting delete
        self._pin_lock = threading.Lock()   # a leaf lock: nothing nests
        self._pin_cv = threading.Condition(self._pin_lock)
        # Tasks whose workers the memory monitor killed: their crash
        # reports as OutOfMemoryError.
        self._oom_killed: set = set()
        if shm_store is not None:
            store.set_evict_callback(self._release_shm_resident)
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
        """Owner-side submit: record lineage (if kept), wait for deps,
        then queue."""
        if self._events:
            self._events.record(spec.task_id, "PENDING_ARGS_AVAIL",
                                name=spec.name)
        if self._lineage is not None:
            self._lineage[spec.return_ids[0].task_id()] = spec
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
        if self._events:
            self._events.record(spec.task_id, "PENDING_NODE_ASSIGNMENT",
                                name=spec.name)
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

        if self._events:
            self._events.record(spec.task_id, "RUNNING", name=spec.name)
        start = time.monotonic()
        retry_spec = None
        try:
            if self._worker_pool is not None:
                pinned: list = []
                try:
                    args, kwargs = self._resolve_args_proc(
                        spec.args, spec.kwargs, pinned)
                    if spec.streaming:
                        self._execute_in_process_stream(
                            spec, args, kwargs, cancelled_event)
                    else:
                        self._execute_in_process(spec, args, kwargs,
                                                 cancelled_event)
                finally:
                    self._unpin_shm_keys(pinned)
            else:
                self._execute_in_thread(spec, cancelled_event)
            if self._events:
                self._events.record(
                    spec.task_id, "FINISHED", name=spec.name,
                    duration=time.monotonic() - start)
            # A memory-monitor kill that raced this completion must not
            # leave a marker to mislabel a later failure.
            self._oom_killed.discard(spec.task_id)
        except Exception as exc:  # noqa: BLE001 — task error boundary
            retry_spec = self._handle_failure(spec, exc)
        finally:
            with self._lock:
                self._running.pop(spec.task_id, None)
                self._num_finished += 1
            self._resources.release(spec.resources)
            # Enqueue the retry only after this attempt's bookkeeping is
            # gone, so the retry's _running entry can't be popped by us.
            if retry_spec is not None:
                with self._lock:
                    self._make_runnable_locked(retry_spec)
        return self._pick_next_inline()

    def _execute_in_thread(self, spec: TaskSpec, cancelled_event):
        from ray_tpu_torch._private import worker as worker_mod

        args, kwargs = _resolve_args(self._store, spec.args, spec.kwargs)
        ctx = worker_mod._task_context
        ctx.current_task_id = spec.task_id
        ctx.task_name = spec.name
        # The flight recorder's task-stuck watchdog feed.
        if _flight._FLIGHT is not None:
            _flight.note_task_started(spec.name)
        try:
            renv = spec.runtime_env
            if renv is not None and (renv.get("pip") or renv.get("uv")):
                # Thread-plane tasks share this interpreter; a
                # venv-backed env cannot apply here.
                raise RuntimeEnvSetupError(
                    "pip/uv runtime envs need process workers "
                    "(worker_mode='process')")

            def _invoke():
                result = spec.function(*args, **kwargs)
                if spec.streaming:
                    # The yield loop runs inside the env, so the
                    # generator's body sees it.
                    self._stream_outputs(spec, result, cancelled_event)
                return result

            if renv is not None:
                with renv.stage().applied():
                    result = _invoke()
            else:
                result = _invoke()
        finally:
            ctx.current_task_id = None
            ctx.task_name = None
            if _flight._FLIGHT is not None:
                _flight.note_task_finished()
        if not spec.streaming:
            self._store_outputs(spec, result)

    # --------------------------------------------------------- process plane
    def _resolve_args_proc(self, args, kwargs, pinned: list):
        """Argument resolution for the process plane: a ref whose value
        is resident in the shm store passes AS A SHM KEY, which the
        worker reads directly; any other resolves to its value as on the
        thread plane (raising an upstream task's error). The keys used
        are appended to ``pinned`` (even when resolution raises midway)
        and the caller unpins them after the dispatch."""
        from ray_tpu_torch._private.worker import ObjectRef, global_worker
        from ray_tpu_torch._private.worker_main import _ShmRef

        ctx = global_worker().serialization_context

        def _resolve(v):
            if not isinstance(v, ObjectRef):
                return v
            key = self._shm_resident.get(v.object_id)
            if key is not None:
                with self._pin_lock:
                    # Pin before the existence check: the flush valve
                    # skips pinned keys, so a pinned key that is present
                    # stays valid until the dispatch ends.
                    self._shm_key_pins[key] = (
                        self._shm_key_pins.get(key, 0) + 1)
                pinned.append(key)
                if self._shm_store.contains(key):
                    return _ShmRef(key)
            value = ctx.deserialize(self._store.get(v.object_id))
            if isinstance(value, RayTaskError):
                raise value.as_instanceof_cause()
            return value

        return (tuple(_resolve(a) for a in args),
                {k: _resolve(v) for k, v in kwargs.items()})

    def _unpin_shm_keys(self, pinned: list):
        with self._pin_lock:
            self._pin_cv.notify_all()
            for key in pinned:
                n = self._shm_key_pins.get(key, 0) - 1
                if n > 0:
                    self._shm_key_pins[key] = n
                    continue
                self._shm_key_pins.pop(key, None)
                if key in self._deferred_deletes:
                    # Deferred while it was read; deleted under the pin
                    # lock, so no reader can pin it between the check
                    # and the delete.
                    self._deferred_deletes.discard(key)
                    self._delete_shm_keys([key])

    def _clear_ret_keys(self, keys, wait_for_reuse_s: float = 0.0):
        """Delete stale return keys without breaking the pin invariant: a
        key a consumer reads right now is deferred (deleted at its unpin)
        rather than pulled mid-read. ``wait_for_reuse_s`` waits that long
        for readers, so a slot the worker must write again is free."""
        deadline = time.monotonic() + wait_for_reuse_s
        remaining = list(keys)
        while True:
            still = []
            for key in remaining:
                with self._pin_lock:
                    if key in self._shm_key_pins:
                        self._deferred_deletes.add(key)
                        still.append(key)
                        continue
                    self._deferred_deletes.discard(key)
                    self._delete_shm_keys([key])
            remaining = still
            left = deadline - time.monotonic()
            if not remaining or left <= 0:
                return
            # An unpin notifies; the timeout bounds a reader that never
            # unpins within the wait.
            with self._pin_cv:
                self._pin_cv.wait(min(left, 0.1))

    @staticmethod
    def _ret_key(oid, attempt: int) -> int:
        """The shm slot of one return of one attempt. Salted by the
        attempt, so a retry writes fresh slots while a consumer still
        pinned to the previous attempt's output finishes its read."""
        from ray_tpu_torch._private.worker_pool import oid_key

        base = oid_key(oid)
        if attempt:
            base ^= attempt * 0x9E37_79B9_7F4A_7C15
        return base & 0x0FFF_FFFF_FFFF_FFFF

    def _maybe_flush_residents(self):
        """Pressure valve: residency is a read-through cache (the driver's
        store keeps the authoritative copy), so past 60% of the shm store
        the older unpinned half is dropped rather than starving new
        results. Pinned keys are never flushed."""
        try:
            stats = self._shm_store.stats()
        except Exception:  # noqa: BLE001 — store torn down
            return
        if stats["used"] <= stats["capacity"] * 0.6:
            return
        items = list(self._shm_resident.items())   # GIL-atomic snapshot
        for oid, key in items[:len(items) // 2]:
            with self._pin_lock:
                if key in self._shm_key_pins:
                    continue
                self._shm_resident.pop(oid, None)
                self._delete_shm_keys([key])

    def _release_shm_resident(self, object_id):
        """Evict callback of the driver's store; it runs UNDER the store's
        lock, so only GIL-atomic dict operations and the leaf pin lock."""
        key = self._shm_resident.pop(object_id, None)
        if key is None or self._shm_store is None:
            return
        with self._pin_lock:
            if key in self._shm_key_pins:
                # An argument in flight: its bytes stay until the
                # dispatch unpins them.
                self._deferred_deletes.add(key)
                return
        self._delete_shm_keys([key])

    def _delete_shm_keys(self, keys):
        for key in keys:
            try:
                self._shm_store.delete(key)
            except Exception:  # noqa: BLE001 — already reclaimed
                pass

    def _stage_task(self, w, spec: TaskSpec, args, kwargs):
        """(digest, fn field, payload field, staged keys) of a task bound
        for worker ``w``: oversized fields ride the store, not the
        channel."""
        from ray_tpu_torch._private.worker_pool import (
            maybe_stage,
            pack_args,
            pack_function,
        )

        digest, fn_bytes = pack_function(spec.function)
        payload, staged = pack_args(self._shm_store, args, kwargs)
        limit = max(w.max_msg // 4, 64 * 1024)
        fn_field, st = maybe_stage(self._shm_store, fn_bytes, limit)
        staged += st
        payload, st = maybe_stage(self._shm_store, payload, limit)
        staged += st
        return digest, fn_field, payload, staged

    def _execute_in_process(self, spec: TaskSpec, args, kwargs,
                            cancelled_event):
        """Ship the task to a leased worker process; its outputs come back
        through the shm store and stay resident there."""
        from ray_tpu_torch._private.serialization import SerializedObject

        w = self._worker_pool.lease(runtime_env=spec.runtime_env)
        staged: list = []
        ret_keys = [self._ret_key(oid, spec.attempt)
                    for oid in spec.return_ids]
        try:
            digest, fn_field, payload, staged = self._stage_task(
                w, spec, args, kwargs)
            # An earlier attempt may have died after storing outputs but
            # before replying: clear this attempt's and the previous
            # attempt's slots (pins respected).
            for oid in spec.return_ids:
                self._shm_resident.pop(oid, None)
            self._clear_ret_keys(ret_keys, wait_for_reuse_s=1.0)
            if spec.attempt > 0:
                self._clear_ret_keys(
                    [self._ret_key(oid, spec.attempt - 1)
                     for oid in spec.return_ids])
            with self._lock:
                self._proc_running[spec.task_id] = w
            try:
                msg = ("task", digest, fn_field, payload, ret_keys,
                       spec.num_returns, spec.task_id.binary(), spec.name,
                       _env_fields(spec))
                if spec.trace is not None:
                    # Traced: the worker records its exec span under
                    # the submitter's context (off = no extra field).
                    msg = msg + (tuple(spec.trace),)
                w.request(msg, cancel_event=cancelled_event)
            finally:
                with self._lock:
                    self._proc_running.pop(spec.task_id, None)
            for oid, key in zip(spec.return_ids, ret_keys):
                raw = bytes(self._shm_store.get(key))
                self._shm_resident[oid] = key
                self._store.put(oid, SerializedObject.from_bytes(raw))
                if not self._store.contains(oid):
                    # Nothing referenced the output: evicted as it landed.
                    self._release_shm_resident(oid)
            self._maybe_flush_residents()
        except BaseException:
            # A crashed worker may have left some return keys behind.
            self._clear_ret_keys(ret_keys)
            raise
        finally:
            self._delete_shm_keys(staged)
            self._worker_pool.release(w)

    def _execute_in_process_stream(self, spec: TaskSpec, args, kwargs,
                                   cancelled_event):
        """A streaming task on the process plane: a ``task_stream``
        request to a leased worker, then its reply channel pumped: each
        ``item`` frame commits one object as the worker yields, and
        consumption acks go back on the worker's ack channel. A kill -9
        mid-stream surfaces as WorkerCrashedError (retriable: the retry
        replays the generator from yield 0)."""
        from ray_tpu_torch._private.worker import global_worker

        worker = global_worker()
        stream = worker.streams.get_or_create(spec.task_id)
        w = self._worker_pool.lease(runtime_env=spec.runtime_env)
        staged: list = []
        try:
            digest, fn_field, payload, staged = self._stage_task(
                w, spec, args, kwargs)
            with self._lock:
                self._proc_running[spec.task_id] = w
            try:
                w._req.write(("task_stream", digest, fn_field, payload,
                              spec.task_id.binary(), spec.name,
                              _env_fields(spec), int(spec.backpressure)),
                             timeout=60.0)
                pump_stream_replies(w, spec.task_id, spec.name, stream,
                                    self._store, self._shm_store,
                                    worker.serialization_context,
                                    cancelled_event)
            finally:
                with self._lock:
                    self._proc_running.pop(spec.task_id, None)
        finally:
            self._delete_shm_keys(staged)
            self._worker_pool.release(w)

    # ------------------------------------------------------------- streaming
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
        # A worker process's death is a system failure: retriable by
        # default, as the reference's WorkerCrashedError is.
        if spec.task_id in self._oom_killed:
            self._oom_killed.discard(spec.task_id)
            exc = OutOfMemoryError(
                f"task {spec.name!r} was killed by the memory monitor "
                f"(system memory pressure; youngest-task-first policy)")
        is_app_error = not isinstance(
            exc, (SystemError, MemoryError, OutOfMemoryError,
                  WorkerCrashedError, WorkerPoolExhaustedError))
        retriable = spec.attempt < spec.max_retries and (
            spec.retry_exceptions or not is_app_error
        )
        if self._events:
            self._events.record(spec.task_id, "FAILED", name=spec.name)
        if retriable and not isinstance(exc, TaskCancelledError):
            return dataclasses.replace(spec, attempt=spec.attempt + 1)
        if isinstance(exc, (TaskCancelledError, RayTaskError,
                            OutOfMemoryError)):
            error = exc  # typed system/dependency failures stay unwrapped
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
        arguments is dropped when they resolve. ``force`` on the
        process plane kills the worker running the task (the pool
        replaces it), which then reports TaskCancelledError; a thread
        cannot be killed, so on the thread plane it adds nothing."""
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
                proc = self._proc_running.get(task_id)
                if ev is not None:
                    ev.set()
                    if force and proc is not None:
                        proc.kill()
                        return True
                return False
            key, i, spec = found
            dq = self._runnable[key]
            del dq[i]
            if not dq:
                del self._runnable[key]
            self._runnable_count -= 1
        self._finish_cancelled(spec)
        return True

    def queued_specs(self) -> List[TaskSpec]:
        """Runnable tasks not dispatched yet, in FIFO order."""
        with self._lock:
            items = [item for dq in self._runnable.values() for item in dq]
        items.sort(key=lambda it: it[0])
        return [spec for _, spec in items]

    def running_task_ids(self) -> List[TaskID]:
        with self._lock:
            return list(self._running)

    def backlog_size(self) -> int:
        """Tasks waiting for arguments, queued, or running."""
        with self._lock:
            return (len(self._pending_deps) + self._runnable_count
                    + len(self._running))

    def num_running(self) -> int:
        with self._lock:
            return len(self._running)

    def num_finished(self) -> int:
        """Executions ended (finished, failed or retried)."""
        with self._lock:
            return self._num_finished

    def shutdown(self):
        """Stop dispatching, signal every running task's cancel event,
        and join the dispatcher and the executor threads (bounded)."""
        self.stop()
        self.join()

    def stop(self):
        """Stop dispatching and signal every running task's cancel event,
        without waiting for them (a simulated node's death: its tasks are
        resubmitted elsewhere before the join)."""
        if self._shm_store is not None:
            self._store.remove_evict_callback(self._release_shm_resident)
        with self._lock:
            self._shutdown = True
            running = list(self._running.values())
            self._dispatch_cv.notify_all()
        for ev in running:
            ev.set()

    def join(self):
        self._dispatcher.join(timeout=_JOIN_TIMEOUT_S)
        self._pool.shutdown()


def pump_stream_replies(w, task_id, name: str, stream, store, shm_store,
                        ctx, cancelled_event=None):
    """Driver-side pump of one process-plane stream (the task scheduler's
    and the sync process actor's): read ``item`` frames off the worker's
    reply channel into the store, forward consumption acks on the ack
    channel (only the latest watermark matters), and turn the worker's
    death into WorkerCrashedError. Returns the item count."""
    import pickle

    from ray_tpu_torch._private.serialization import SerializedObject
    from ray_tpu_torch._private.streaming import stream_end_id, stream_item_id
    from ray_tpu_torch.exceptions import ChannelTimeoutError

    tid_bin = task_id.binary()
    last_acked = [0]
    done = threading.Event()

    def _send_ack(n: int) -> bool:
        if done.is_set():
            return False
        try:
            w._ack.write(("stream_ack", tid_bin, n), timeout=0.05)
            if n > last_acked[0]:
                last_acked[0] = n
            return True
        except Exception:  # noqa: BLE001 — the pump retries the latest
            return False

    # An ack from the consumer's thread at once keeps resume latency off
    # the pump's read slices; the loop below is the retry path.
    stream.add_consume_listener(_send_ack)
    cancel_sent = False

    def _drain_after_error():
        """A driver-side failure while the worker is alive mid-stream:
        its reply channel still carries frames, and releasing the worker
        now would desync the next lease. Cancel and drain to the terminal
        frame; a worker that does not settle is condemned, so the pool
        replaces it."""
        _send_ack(-1)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            try:
                m = w._rep.read(timeout=0.25)
            except ChannelTimeoutError:
                if w.proc.poll() is not None:
                    w._dead = True
                    return
                _send_ack(-1)
                continue
            except Exception:  # noqa: BLE001 — channel torn down
                break
            if m and m[0] in ("ok", "cancelled", "err"):
                return
        w._dead = True

    try:
        while True:
            cancelled_now = ((cancelled_event is not None
                              and cancelled_event.is_set())
                             or stream.cancelled)
            if cancelled_now and not cancel_sent:
                cancel_sent = _send_ack(-1)   # -1: cooperative cancel
            if stream.consumed > last_acked[0]:
                _send_ack(stream.consumed)
            try:
                msg = w._rep.read(timeout=0.05)
            except ChannelTimeoutError:
                if w.proc.poll() is not None:
                    w._dead = True
                    if cancelled_now:
                        raise TaskCancelledError(task_id)
                    raise WorkerCrashedError(
                        f"worker {w.pid} died mid-stream of task "
                        f"{name!r} (exit code {w.proc.returncode})")
                continue
            kind = msg[0]
            if kind == "item":
                try:
                    _, idx, field = msg
                    if isinstance(field, tuple) and field and \
                            field[0] == "shm":
                        raw = bytes(shm_store.get(field[1]))
                        try:
                            shm_store.delete(field[1])
                        except Exception:  # noqa: BLE001 — raced away
                            pass
                    else:
                        raw = bytes(field)
                    store.put(stream_item_id(task_id, idx),
                              SerializedObject.from_bytes(raw))
                    stream.commit(idx)
                except BaseException:
                    _drain_after_error()
                    raise
            elif kind == "ok":
                total = int(msg[1])
                store.put(stream_end_id(task_id), ctx.serialize(total))
                stream.finish(total)
                return total
            elif kind == "cancelled":
                raise TaskCancelledError(task_id)
            elif kind == "err":
                raise pickle.loads(msg[1])
            # Anything else (a stale frame of a crashed predecessor) is
            # dropped; the liveness check above bounds the stall.
    finally:
        done.set()


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
