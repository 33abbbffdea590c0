"""Global worker: init/shutdown, ObjectRef, get/put/wait/cancel
(counterpart of ``ray_tpu/_private/worker.py``, trimmed to one process).

One process-global ``Worker`` owns the serialization context, the object
store, the streaming registry, the local scheduler and the actor
registry; ``init()`` boots it and ``shutdown()`` tears it down, joining
every thread it started. ObjectRefs count local references on
construction and destruction (owner-side refcounting).

Not ported: the head client and its failover, pulls from other processes, the
flight recorder and tracing, the worker-process pool and client mode.
The reference's device probe (JAX's TPUs) becomes a ``"GPU"`` resource
of ``torch.cuda.device_count()`` cards, counted without creating a CUDA
context; ``num_gpus=`` overrides it.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Union

from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch._private.ids import (
    JobID,
    NodeID,
    ObjectID,
    TaskID,
    WorkerID,
    _Counter,
)
from ray_tpu_torch._private.object_store import ObjectStore
from ray_tpu_torch._private.scheduler import (
    LocalScheduler,
    ResourcePool,
    TaskSpec,
    _collect_refs,
)
from ray_tpu_torch._private.serialization import SerializationContext
from ray_tpu_torch._private.streaming import (
    StreamRegistry,
    stream_end_id,
    stream_item_id,
)
from ray_tpu_torch.exceptions import RayTaskError, RayTpuError


class _TaskContext:
    """Per-execution task context, backed by contextvars so async actor
    calls (many coroutines on one event-loop thread) each see their own
    task id across await points; for plain threads it behaves as
    threading.local."""

    __slots__ = ("_tid", "_name")

    def __init__(self):
        import contextvars

        object.__setattr__(self, "_tid", contextvars.ContextVar(
            "ray_tpu_torch_task_id", default=None))
        object.__setattr__(self, "_name", contextvars.ContextVar(
            "ray_tpu_torch_task_name", default=None))

    @property
    def current_task_id(self):
        return self._tid.get()

    @current_task_id.setter
    def current_task_id(self, value):
        self._tid.set(value)

    @property
    def task_name(self):
        return self._name.get()

    @task_name.setter
    def task_name(self, value):
        self._name.set(value)


_task_context = _TaskContext()


class ObjectRef:
    """Future handle to a task output or put object. Pickling an
    ObjectRef (a ref nested inside a value) keeps its object alive."""

    __slots__ = ("object_id", "_owner", "__weakref__")

    def __init__(self, object_id: ObjectID, _add_ref: bool = True):
        self.object_id = object_id
        self._owner = _try_global_worker()
        if _add_ref and self._owner is not None:
            self._owner.store.add_local_ref(object_id)

    def hex(self) -> str:
        return self.object_id.hex()

    def task_id(self) -> TaskID:
        return self.object_id.task_id()

    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        import concurrent.futures

        fut: concurrent.futures.Future = concurrent.futures.Future()
        worker = global_worker()

        def _done():
            try:
                fut.set_result(worker.get_object(self))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        worker.store.on_ready(self.object_id, _done)
        return fut

    def __await__(self):
        import asyncio

        loop = asyncio.get_event_loop()
        afut = loop.create_future()
        worker = global_worker()

        def _done():
            def _set():
                if afut.cancelled():
                    return
                try:
                    afut.set_result(worker.get_object(self))
                except BaseException as e:  # noqa: BLE001
                    afut.set_exception(e)

            loop.call_soon_threadsafe(_set)

        worker.store.on_ready(self.object_id, _done)
        return afut.__await__()

    def __reduce__(self):
        w = _try_global_worker()
        if w is not None:
            # Borrowed: keep alive for the borrower's lifetime (simplified,
            # as in the reference).
            w.store.add_local_ref(self.object_id)
        return (_deserialize_ref, (self.object_id,))

    def __del__(self):
        w = self._owner
        if w is not None and w.is_alive:
            try:
                w.store.remove_local_ref(self.object_id)
            except Exception:  # noqa: BLE001 — interpreter teardown
                pass

    def __hash__(self):
        return hash(self.object_id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.object_id == self.object_id

    def __repr__(self):
        return f"ObjectRef({self.object_id.hex()[:16]}…)"


def _deserialize_ref(object_id: ObjectID) -> ObjectRef:
    return ObjectRef(object_id, _add_ref=False)


class ObjectRefGenerator:
    """Iterator over the item ObjectRefs of a ``num_returns="streaming"``
    task (reference parity: ``ObjectRefGenerator``). Each ``next()``
    blocks only until the NEXT yield's object commits, not until the
    whole task finishes; returning a ref counts as CONSUMPTION for the
    producer's backpressure budget. ``close()`` (or dropping the
    generator) cancels the in-flight task and releases
    committed-but-unconsumed items."""

    def __init__(self, task_id: TaskID, worker: "Worker"):
        self._task_id = task_id
        self._worker = worker
        self._stream = worker.streams.get_or_create(task_id)
        self._index = 0
        self._end_oid = stream_end_id(task_id)
        self._end_ref = ObjectRef(self._end_oid)
        self._pending_ref: Optional[ObjectRef] = None
        self._total: Optional[int] = None
        self._closed = False

    # ------------------------------------------------------------ iteration
    def __iter__(self):
        return self

    def __next__(self) -> ObjectRef:
        ref = self._next(block=True)
        assert ref is not None
        return ref

    def try_next(self) -> Optional[ObjectRef]:
        """Non-blocking ``next()``: the next item's ref if it is already
        committed, else None. Raises StopIteration / the task's typed
        error exactly like ``next()``."""
        return self._next(block=False)

    def completed(self) -> ObjectRef:
        """The stream's END MARKER ref: ready when the whole generator
        task finished (value = total yield count; errors raise)."""
        return self._end_ref

    def wait_refs(self) -> List[ObjectRef]:
        """Refs to pass to ``wait`` for "the next ``next()`` would make
        progress": the next item's ref and the end marker, so a scheduler
        can multiplex many streams without blocking on one."""
        return [self._item_ref(), self._end_ref]

    @property
    def task_id(self) -> TaskID:
        return self._task_id

    def _item_ref(self) -> ObjectRef:
        if self._pending_ref is None:
            self._pending_ref = ObjectRef(
                stream_item_id(self._task_id, self._index))
        return self._pending_ref

    def _read_total(self) -> int:
        serialized = self._worker.store.get(self._end_oid, timeout=5.0)
        value = self._worker.serialization_context.deserialize(serialized)
        if isinstance(value, RayTaskError):
            raise value.as_instanceof_cause()
        return int(value)

    def _free_unconsumed(self):
        upper = self._stream.committed
        if self._total is not None:
            upper = max(upper, self._total)
        drop = [stream_item_id(self._task_id, i)
                for i in range(self._index, upper)]
        if drop:
            self._worker.store.free(drop)

    def _fail_closed(self):
        """Error-path teardown: release committed-but-unconsumed items and
        the registry entry; close()/__del__ become no-ops."""
        self._closed = True
        try:
            if self._worker.is_alive:
                self._free_unconsumed()
        except Exception:  # noqa: BLE001 — cleanup must not mask the error
            pass
        finally:
            self._release_stream()

    def _next(self, block: bool) -> Optional[ObjectRef]:
        if self._closed:
            raise StopIteration
        store = self._worker.store
        end_grace: Optional[float] = None
        while True:
            item = self._item_ref()
            oid = item.object_id
            if store.is_ready(oid):
                err = store.peek_error(oid)
                if err is not None:
                    self._fail_closed()
                    if hasattr(err, "as_instanceof_cause"):
                        raise err.as_instanceof_cause()
                    raise err
                self._pending_ref = None
                self._index += 1
                self._stream.advance_consumed(self._index)
                return item
            if self._total is None and store.is_ready(self._end_oid):
                try:
                    self._total = self._read_total()
                except BaseException:
                    self._fail_closed()
                    raise
            if self._total is not None and self._index >= self._total:
                self._closed = True
                self._release_stream()
                raise StopIteration
            if not block:
                return None
            if self._total is not None:
                # Task done but item i < total is not in the store (freed):
                # bound the wait so a lost item cannot hang us.
                if end_grace is None:
                    end_grace = time.monotonic() + 5.0
                elif time.monotonic() > end_grace:
                    from ray_tpu_torch.exceptions import ObjectLostError

                    self._fail_closed()
                    raise ObjectLostError(
                        f"streaming item {self._index} of task "
                        f"{self._task_id.hex()[:16]}… completed but its "
                        f"bytes are no longer retrievable")
            if not self._worker.is_alive:
                self._fail_closed()
                raise RayTpuError("the runtime shut down mid-stream")
            store.wait([oid, self._end_oid], 1, 0.2)

    # ------------------------------------------------------------ lifecycle
    def close(self):
        """Cancel the in-flight generator task and release
        committed-but-unconsumed items. Idempotent; also runs when the
        generator is garbage-collected before exhaustion."""
        if self._closed:
            return
        self._closed = True
        w = self._worker
        if not w.is_alive:
            return
        try:
            if not w.store.is_ready(self._end_oid):
                self._stream.cancel()
                w.scheduler.cancel(self._task_id)
                # Materialize the typed cancellation end so any other
                # waiter (wait on completed()) unblocks.
                w.store.cancel(self._end_oid, self._task_id)
            self._free_unconsumed()
        finally:
            self._release_stream()

    def _release_stream(self):
        self._worker.streams.pop(self._task_id)
        pending, self._pending_ref = self._pending_ref, None
        if pending is not None:
            del pending
            self._worker.store.discard_pending(
                stream_item_id(self._task_id, self._index))

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def __repr__(self):
        return (f"ObjectRefGenerator({self._task_id.hex()[:16]}…, "
                f"next={self._index})")


def _count_gpus() -> int:
    """Visible CUDA cards, without creating a CUDA context."""
    import torch

    try:
        return int(torch.cuda.device_count())
    except Exception:  # noqa: BLE001 — no CUDA runtime: no card
        return 0


class Worker:
    def __init__(self, num_cpus: Optional[int] = None,
                 num_gpus: Optional[int] = None,
                 resources: Optional[Dict[str, float]] = None):
        self.is_alive = True
        self.job_id = JobID.from_int(os.getpid() & 0xFFFFFFFF)
        self.worker_id = WorkerID.from_random()
        self.node_id = NodeID.from_random()
        self.job_task_id = TaskID.for_job(self.job_id)
        self.serialization_context = SerializationContext()
        self.store = ObjectStore()
        # Streaming-generator plane: per-task stream state (yield commit
        # counters, backpressure watermarks) for num_returns="streaming".
        self.streams = StreamRegistry()
        if num_cpus is None:
            num_cpus = os.cpu_count() or 1
        total = {"CPU": float(num_cpus)}
        if num_gpus is None:
            num_gpus = _count_gpus()
        if num_gpus:
            total["GPU"] = float(num_gpus)
        total.update(resources or {})
        self.resource_pool = ResourcePool(total)
        pool_size = GlobalConfig.worker_pool_size or max(int(num_cpus), 4)
        self.scheduler = LocalScheduler(self.store, self.resource_pool,
                                        pool_size)
        self.submission_counter = _Counter()
        self.put_counter = _Counter()
        self.actor_counter = _Counter()
        self.actors: Dict[Any, Any] = {}  # ActorID -> _ActorRuntime
        self.named_actors: Dict[tuple, Any] = {}  # (namespace, name) -> handle
        self.namespace = "default"
        # Internal KV (the reference's GCS-KV, here local to the process):
        # the rendezvous of the actor-plane collective groups.
        self._kv: Dict[bytes, bytes] = {}
        self._kv_lock = threading.Lock()

    # ------------------------------------------------------------------- api
    def current_task_id(self) -> TaskID:
        tid = getattr(_task_context, "current_task_id", None)
        return tid if tid is not None else self.job_task_id

    def next_task_id(self) -> TaskID:
        return TaskID.of(self.current_task_id(),
                         self.submission_counter.next())

    def put_object(self, value: Any) -> ObjectRef:
        if isinstance(value, ObjectRef):
            raise TypeError(
                "Calling put() on an ObjectRef is not allowed; pass the ref "
                "directly instead.")
        oid = ObjectID.for_put(self.current_task_id(),
                               self.put_counter.next())
        serialized = self.serialization_context.serialize(value)
        self.store.put(oid, serialized)
        return ObjectRef(oid)

    def get_object(self, ref: ObjectRef, timeout: Optional[float] = None):
        serialized = self.store.get(ref.object_id, timeout=timeout)
        value = self.serialization_context.deserialize(serialized)
        if isinstance(value, RayTaskError):
            raise value.as_instanceof_cause()
        return value

    def submit_task(self, spec: TaskSpec) -> List[ObjectRef]:
        # Pin args that are refs for the duration of the task
        # (submitted refs in the reference's refcount protocol).
        dep_refs = _collect_refs(spec.args, spec.kwargs)
        for ref in dep_refs:
            self.store.add_submitted_ref(ref.object_id)
        refs = [ObjectRef(oid) for oid in spec.return_ids]
        if dep_refs:
            def _release(_refs=dep_refs):
                for r in _refs:
                    self.store.remove_submitted_ref(r.object_id)
            self.store.on_ready(spec.return_ids[0], _release)
        self.scheduler.submit(spec)
        return refs

    def wait(self, object_ids: List[ObjectID], num_returns: int,
             timeout: Optional[float]):
        return self.store.wait(object_ids, num_returns, timeout)

    # -------------------------------------------------------- internal KV ---
    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True) -> bool:
        with self._kv_lock:
            if not overwrite and key in self._kv:
                return False
            self._kv[key] = value
            return True

    def kv_get(self, key: bytes) -> Optional[bytes]:
        with self._kv_lock:
            return self._kv.get(key)

    def kv_del(self, key: bytes) -> bool:
        with self._kv_lock:
            return self._kv.pop(key, None) is not None

    def kv_keys(self, prefix: bytes = b"") -> List[bytes]:
        with self._kv_lock:
            return [k for k in self._kv if k.startswith(prefix)]

    def shutdown(self):
        """Stop every actor loop and the scheduler, fail every waiter,
        and join the threads (each join bounded)."""
        self.is_alive = False
        actors = list(self.actors.values())
        for actor in actors:
            try:
                actor.terminate(no_restart=True)
            except Exception:  # noqa: BLE001
                pass
        self.scheduler.shutdown()
        self.store.close()
        for actor in actors:
            try:
                actor.join(timeout=2)
            except Exception:  # noqa: BLE001
                pass
        self.actors.clear()
        self.named_actors.clear()


_global_worker: Optional[Worker] = None
_init_lock = threading.Lock()
_atexit_registered = False


def _try_global_worker() -> Optional[Worker]:
    return _global_worker


def try_live_worker() -> Optional[Worker]:
    """The global worker if one is up and alive, else None; never starts a
    runtime (the check of the KV-backed ``memory://`` filesystem)."""
    w = _global_worker
    return w if w is not None and w.is_alive else None


def global_worker() -> Worker:
    if _global_worker is None:
        raise RayTpuError(
            "ray_tpu_torch has not been initialized; call "
            "ray_tpu_torch.init() first (or use auto-init by calling a "
            "remote function).")
    return _global_worker


def is_initialized() -> bool:
    return _global_worker is not None


def init(num_cpus: Optional[int] = None, num_gpus: Optional[int] = None,
         resources: Optional[Dict[str, float]] = None,
         _system_config: Optional[Dict[str, Any]] = None,
         ignore_reinit_error: bool = False, namespace: str = "default",
         **_ignored) -> "Worker":
    """Start the one-process runtime: the scheduler's dispatcher and
    executor threads. Resources: ``num_cpus`` (default: the host's
    cores), ``num_gpus`` (default: the visible CUDA cards) and custom
    ``resources``."""
    global _global_worker, _atexit_registered
    with _init_lock:
        if _global_worker is not None:
            if ignore_reinit_error:
                return _global_worker
            raise RayTpuError(
                "ray_tpu_torch.init() called twice; pass "
                "ignore_reinit_error=True to allow.")
        if _system_config:
            GlobalConfig.apply_system_config(_system_config)
        _global_worker = Worker(num_cpus=num_cpus, num_gpus=num_gpus,
                                resources=resources)
        _global_worker.namespace = namespace
        if not _atexit_registered:
            atexit.register(shutdown)
            _atexit_registered = True
        return _global_worker


def shutdown():
    """Tear the runtime down: Serve (controller loops, replicas, the HTTP
    proxy) first, then actors, the scheduler and the store. Every drive
    ends with it."""
    global _global_worker
    from ray_tpu_torch.serve import controller as _controller
    from ray_tpu_torch.serve import http as _http

    _http.stop_proxy()
    _controller.shutdown_controller()
    # Compiled DAGs' exec loops occupy their actors' loop threads until
    # teardown: end them first, so the actors' joins below can finish.
    compiled_dag = sys.modules.get("ray_tpu_torch.dag.compiled_dag")
    if compiled_dag is not None:
        compiled_dag._teardown_all()
    with _init_lock:
        if _global_worker is None:
            return
        _global_worker.shutdown()
        _global_worker = None


def auto_init() -> Worker:
    if _global_worker is None:
        init(ignore_reinit_error=True)
    return _global_worker


# ------------------------------------------------------------ public verbs --
def put(value: Any) -> ObjectRef:
    return auto_init().put_object(value)


def get(refs: Union[ObjectRef, List[ObjectRef]],
        *, timeout: Optional[float] = None):
    worker = auto_init()
    if isinstance(refs, ObjectRef):
        return worker.get_object(refs, timeout=timeout)
    if not isinstance(refs, list):
        raise TypeError(
            f"get() expects an ObjectRef or list of ObjectRefs, got "
            f"{type(refs)}")
    # One overall deadline across the whole list, not per ref.
    deadline = None if timeout is None else time.monotonic() + timeout
    out = []
    for r in refs:
        remaining = None
        if deadline is not None:
            remaining = max(deadline - time.monotonic(), 0.0)
        out.append(worker.get_object(r, timeout=remaining))
    return out


def wait(refs: List[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None, fetch_local: bool = True):
    worker = auto_init()
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    if len(set(refs)) != len(refs):
        raise ValueError("wait() expects a list of unique ObjectRefs")
    if num_returns > len(refs):
        raise ValueError(
            f"num_returns ({num_returns}) exceeds number of refs "
            f"({len(refs)})")
    ready_ids, not_ready_ids = worker.wait(
        [r.object_id for r in refs], num_returns, timeout)
    by_id = {r.object_id: r for r in refs}
    return ([by_id[i] for i in ready_ids], [by_id[i] for i in not_ready_ids])


def cancel(ref: ObjectRef, *, force: bool = False, recursive: bool = True):
    worker = global_worker()
    task_id = ref.object_id.task_id()
    removed = worker.scheduler.cancel(task_id, force=force)
    if removed or force:
        worker.store.cancel(ref.object_id, task_id)
