"""Global worker: init/shutdown, ObjectRef, get/put/wait/cancel
(counterpart of ``ray_tpu/_private/worker.py``, for one node).

One process-global ``Worker`` owns the serialization context, the object
store (spilling to the session's ``spill`` directory), the streaming
registry, the local scheduler and the actor registry; ``init()`` boots it
and ``shutdown()`` tears it down, joining every thread it started.
ObjectRefs count local references on construction and destruction
(owner-side refcounting). ``init()`` creates a session directory
(``<tmp>/ray_tpu_torch/session_<hex>``, linked as ``session_latest``)
with the workers' ``logs``.

``worker_mode`` picks the execution plane. ``"thread"``, the port's
default, runs tasks and actors on threads of this process, where they
reach the card. ``"process"`` (``init(worker_mode="process")`` or
``RAY_TPU_WORKER_MODE=process``, the reference's default) creates, in the
reference's order, the native shm store, the worker pool, the log
monitor and the memory monitor: tasks and actors then run in worker
processes that never see the card (README, the process plane). In a
worker process the global worker is a ``ClientWorker`` that forwards the
API to the driver. A failed native build raises; nothing falls back to
the thread plane in silence.

The worker owns the task-event ring (``task_events``), and ``init()``
arms the tracing plane (``RAY_TPU_TRACE``) and the flight recorder
(``RAY_TPU_FLIGHT`` / ``RAY_TPU_PROFILE``), with the ``runtime`` section
(``worker_mode`` among it) in every flight bundle; ``shutdown()``
uninstalls both and joins their threads. Spawned worker processes spill
their spans and flight bundles into the session's ``traces`` and
``flight`` directories (``RAY_TPU_TRACE_DIR``, ``RAY_TPU_FLIGHT_DIR``),
which ``timeline``, ``trace_dump`` and ``debug_dump`` merge.

``init(address="host:port")`` (``"auto"`` and ``"local"`` mean
``127.0.0.1:6380``; a comma-separated list adds standby heads) attaches
this driver to a head service (``_private/head_service.py``) through a
``HeadClient``: the KV becomes cluster-global (Data's ``memory://``,
Tune's reports and the workflow journal share it), named actors
register with the head and resolve across drivers, ``announce_object``
publishes an object that other drivers then pull (``_pull_wait``), and
the tracer and flight recorder take the client id as their node. A head
that cannot be reached raises: the driver never goes on with a local KV.
With a head the worker also builds the node plane's two halves: a
``RemoteRouter`` (``_private/remote_router.py``), which routes tasks and
places actors onto node daemons and owns the refs they return, and an
``OwnerResolver`` (``_private/ownership.py``), which resolves a borrowed
ref through its owner (a pickled ref carries its owner's id and
address). ``address="ray://host:port"`` is the thin client: this
process keeps no capacity of its own (``num_cpus=0``, no GPU, the
thread plane unless asked), every ``.remote()`` routes onto the
daemons, and a task no daemon can take raises ``RayTpuError``. The reference's device probe
(JAX's TPUs) becomes a ``"GPU"`` resource of ``torch.cuda.device_count()``
cards, counted without creating a CUDA context; ``num_gpus=`` overrides
it.
"""

from __future__ import annotations

import atexit
import os
import sys
import tempfile
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Union

from ray_tpu_torch._private import flight, tracing
from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch._private.log import get_logger
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
from ray_tpu_torch._private.task_events import TaskEventBuffer
from ray_tpu_torch.exceptions import RayTaskError, RayTpuError

log = get_logger(__name__)


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
        owner_info = None
        if w is not None:
            # Borrowed: keep alive for the borrower's lifetime (simplified,
            # as in the reference).
            w.store.add_local_ref(self.object_id)
            # Ownership: a pickled ref carries its owner's id and direct
            # address, so a foreign runtime resolves it owner-direct; a
            # ref this runtime borrowed carries the original owner. (A
            # worker process's stub has no head client: its refs stay
            # owner-less.)
            hc = getattr(w, "head_client", None)
            if hc is not None:
                owner_info = w.borrowed_owner(self.object_id.binary()) \
                    or (hc.client_id, list(hc._object_server.address))
        return (_deserialize_ref, (self.object_id, owner_info))

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


def _deserialize_ref(object_id: ObjectID, owner_info=None) -> ObjectRef:
    w = _try_global_worker()
    if owner_info is not None and w is not None \
            and getattr(w, "head_client", None) is not None \
            and owner_info[0] != w.head_client.client_id:
        w.record_borrowed_owner(object_id.binary(), owner_info)
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
            # A remote stream's large item stayed on the producing node:
            # drive its pull.
            router = getattr(self._worker, "remote_router", None)
            if router is not None and router.handles(oid) and \
                    self._index in self._stream.known_remote_sizes:
                router.prefetch(oid)
            if self._total is not None:
                # Task done but item i < total is not local: still in
                # flight (a pull), or freed. Bound the wait so a lost item
                # cannot hang us.
                if end_grace is None:
                    end_grace = time.monotonic() + (
                        30.0 if router is not None else 5.0)
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
                router = getattr(w, "remote_router", None)
                if router is not None and router.handles(self._end_oid):
                    router.cancel_stream(self._task_id)
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
                 resources: Optional[Dict[str, float]] = None,
                 worker_mode: Optional[str] = None,
                 session_dir: Optional[str] = None,
                 head_address: Optional[str] = None):
        self.is_alive = True
        self.client_mode = False     # a ray:// thin client (init sets it)
        self.worker_mode = worker_mode or GlobalConfig.worker_mode
        if self.worker_mode not in ("thread", "process"):
            raise ValueError(
                f"worker_mode must be 'thread' or 'process', got "
                f"{self.worker_mode!r}")
        # Control plane: with an address, this driver joins the head
        # service; a head that cannot be reached raises here.
        self.head_client = None
        self.remote_router = None    # with a head: routes onto node daemons
        self.owner_resolver = None   # with a head: resolves borrowed refs
        # The simulated cluster (cluster_utils.Cluster) routes this
        # runtime's tasks while it is connected.
        self.cluster = None
        if head_address:
            from ray_tpu_torch._private.head_client import HeadClient

            self.head_client = HeadClient(head_address)
        try:
            self._start_runtime(num_cpus, num_gpus, resources, session_dir)
        except BaseException:
            # No connected client outlives a failed start: the head
            # would count this driver as live until the process exits.
            if self.head_client is not None:
                self.head_client.close()
            raise

    def _start_runtime(self, num_cpus, num_gpus, resources, session_dir):
        self.job_id = JobID.from_int(os.getpid() & 0xFFFFFFFF)
        self.worker_id = WorkerID.from_random()
        self.node_id = NodeID.from_random()
        self.job_task_id = TaskID.for_job(self.job_id)
        self.session_dir = session_dir or _new_session_dir()
        self._point_spill_dirs()
        self.serialization_context = SerializationContext()
        self.store = ObjectStore(os.path.join(self.session_dir, "spill"))
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
        # Task state events (state API, timeline, the tracing bridge).
        self.task_events = TaskEventBuffer(
            GlobalConfig.task_events_max_buffer)
        pool_size = GlobalConfig.worker_pool_size or max(int(num_cpus), 4)
        # The process plane, in the reference's order: the shm store,
        # the worker pool, the log monitor; the memory monitor after the
        # scheduler. A partial build is undone before the error goes up.
        self.shm_store = None
        self.worker_pool = None
        self.log_monitor = None
        self.memory_monitor = None
        self._channel_store = None   # SharedMemoryChannel's own segment
        if self.worker_mode == "process":
            try:
                self._start_process_plane(num_cpus)
            except BaseException:
                self._stop_process_plane()
                raise
        self.scheduler = LocalScheduler(self.store, self.resource_pool,
                                        pool_size,
                                        task_events=self.task_events,
                                        worker_pool=self.worker_pool,
                                        shm_store=self.shm_store)
        if (self.worker_pool is not None
                and GlobalConfig.memory_monitor_threshold > 0):
            from ray_tpu_torch._private.memory_monitor import MemoryMonitor

            self.memory_monitor = MemoryMonitor(
                self.scheduler,
                threshold_fraction=GlobalConfig.memory_monitor_threshold)
        # Debug-mode host-plane sanitizer (RAY_TPU_SANITIZE=1): refcount
        # underflow and channel protocol checks hook in at their sites;
        # the stall watchdog needs the runtime handles.
        self.sanitizer_watchdog = None
        from ray_tpu_torch.util import sanitizer as _sanitizer

        if _sanitizer.enabled():
            self.sanitizer_watchdog = _sanitizer.StallWatchdog(
                self.scheduler, self.resource_pool)
        self.submission_counter = _Counter()
        self.put_counter = _Counter()
        self.actor_counter = _Counter()
        self.actors: Dict[Any, Any] = {}  # ActorID -> _ActorRuntime
        # Placement groups of util/placement_group.py, by id.
        self.placement_groups: Dict[str, Any] = {}
        self.named_actors: Dict[tuple, Any] = {}  # (namespace, name) -> handle
        self.namespace = "default"
        # Internal KV (the reference's GCS-KV, here local to the process):
        # the rendezvous of the actor-plane collective groups.
        self._kv: Dict[bytes, bytes] = {}
        self._kv_lock = threading.Lock()
        flight.add_section("runtime", self._flight_section)
        # Ownership plane: owners of refs borrowed from other runtimes
        # (recorded when a pickled ref carrying its owner arrives).
        self.borrowed_owners: Dict[bytes, tuple] = {}
        self._borrowed_lock = threading.Lock()
        if self.head_client is not None:
            from ray_tpu_torch._private.ownership import OwnerResolver
            from ray_tpu_torch._private.remote_router import RemoteRouter

            self.remote_router = RemoteRouter(self)
            self.owner_resolver = OwnerResolver(self)
            # A promoted head replayed the shared log: re-registering
            # this driver's live named actors and cluster-actor
            # placements reconciles what its torn tail lost.
            self.head_client.failover_callbacks.append(
                self._on_head_failover)

    def _point_spill_dirs(self):
        """Point spawned worker processes (the environment inherits) at
        this session's ``traces`` and ``flight`` directories, where they
        spill their spans and flight bundles for this runtime's
        ``timeline`` and ``debug_dump`` to merge; with a head, qualify
        this process's spans and bundles by its client id. An
        operator-set ``RAY_TPU_FLIGHT_DIR`` stays; one a runtime set
        (``RAY_TPU_FLIGHT_DIR_AUTO``) is re-pointed."""
        if os.environ.get(tracing.ENV_VAR):
            os.environ[tracing.ENV_DIR] = os.path.join(
                self.session_dir, "traces")
        if (os.environ.get(flight.ENV_VAR)
                or os.environ.get(flight.ENV_PROFILE)):
            if (not os.environ.get(flight.ENV_DIR)
                    or os.environ.get(flight.ENV_DIR_AUTO)):
                os.environ[flight.ENV_DIR] = os.path.join(
                    self.session_dir, "flight")
                os.environ[flight.ENV_DIR_AUTO] = "1"
        rec = flight.recorder()
        if rec is not None:
            rec.dump_dir = os.environ.get(flight.ENV_DIR, rec.dump_dir)
        if self.head_client is None:
            return
        node = self.head_client.client_id
        tracer = tracing.tracer()
        if tracer is not None:
            tracer.set_identity(node=node)
            os.environ[tracing.ENV_NODE] = node
        if rec is not None:
            rec.set_identity(node=node)
            os.environ[flight.ENV_NODE] = node

    def _on_head_failover(self, old_epoch: int, new_epoch: int) -> None:
        """Re-register this driver's live named actors with a promoted
        head (a re-registration by the same owner reconciles)."""
        hc = self.head_client
        if hc is None or not self.is_alive:
            return
        for (ns, name), handle in list(self.named_actors.items()):
            runtime = handle._runtime
            if runtime.dead:
                continue
            try:
                hc.actor_register(ns, name, runtime.actor_id.binary(),
                                  runtime.class_name)
            except Exception as exc:  # noqa: BLE001 — replayed entry
                log.warning("named-actor re-register of %r after head "
                            "failover failed (the replayed directory "
                            "entry still serves): %r", name, exc)
        from ray_tpu_torch._private.remote_actor import RemoteActorRuntime

        for runtime in list(self.actors.values()):
            if not isinstance(runtime, RemoteActorRuntime) \
                    or runtime.dead or runtime.borrower:
                continue
            try:
                hc.actor_place(runtime.actor_id.binary(), {
                    "node": runtime.node_client,
                    "driver": hc.client_id,
                    "cls": runtime._cls_bytes,
                    "class_name": runtime.class_name,
                    "detached": runtime.opts.get("lifetime") == "detached",
                })
            except Exception as exc:  # noqa: BLE001 — same fallback
                log.warning("cluster-actor re-place after head failover "
                            "failed (the replayed placement still "
                            "serves): %r", exc)

    def _start_process_plane(self, num_cpus):
        from ray_tpu_torch._native.store import NativeObjectStore
        from ray_tpu_torch._private.log_monitor import LogMonitor
        from ray_tpu_torch._private.serialization import require_cloudpickle
        from ray_tpu_torch._private.worker_pool import WorkerPool

        require_cloudpickle()
        self.shm_store = NativeObjectStore.create(
            capacity=GlobalConfig.shm_store_bytes,
            max_objects=GlobalConfig.shm_store_slots)
        log_dir = os.path.join(self.session_dir, "logs")
        self.worker_pool = WorkerPool(
            self.shm_store, num_workers=max(int(num_cpus), 1),
            max_msg=GlobalConfig.worker_channel_bytes, log_dir=log_dir)
        # Worker prints stream back to this process's stderr.
        self.log_monitor = LogMonitor(log_dir)

    def _stop_workers(self):
        """Stop the memory monitor and every worker process of the pool
        (a task blocked on one wakes); each runs once."""
        if self.memory_monitor is not None:
            self.memory_monitor.stop()
            self.memory_monitor = None
        if self.worker_pool is not None:
            self.worker_pool.shutdown()
            self.worker_pool = None

    def _stop_process_plane(self):
        """Stop the process plane in the reverse of its start (the pool,
        the log monitor, then the store) and unlink the shm segments."""
        self._stop_workers()
        if self.log_monitor is not None:
            self.log_monitor.stop()
            self.log_monitor = None
        for attr in ("_channel_store", "shm_store"):
            store = getattr(self, attr)
            if store is not None:
                store.close()
                setattr(self, attr, None)

    def _flight_section(self) -> dict:
        """Runtime depths for this process's flight bundle: the queue and
        backlog numbers a postmortem reads first."""
        s = self.scheduler
        out = {
            "worker_mode": self.worker_mode,
            "backlog": s.backlog_size(),
            "running": s.num_running(),
            "finished": s.num_finished(),
            "store_objects": len(self.store._entries),
            "resources_available": self.resource_pool.available(),
            "actors": len(self.actors),
        }
        r = self.remote_router
        if r is not None:
            out["router"] = {"direct_pushes": r.direct_pushes,
                             "relayed_pushes": r.relayed_pushes}
        return out

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

    def announce_object(self, ref: ObjectRef):
        """Publish this object's location to the head's object directory
        so other drivers can pull it."""
        if self.head_client is None:
            raise RayTpuError(
                "announce_object needs a head service "
                "(ray_tpu_torch.init(address=...))")
        if not self.store.is_ready(ref.object_id):
            raise RayTpuError(
                "announce_object: the object is not materialized locally "
                "yet; ray_tpu_torch.wait() on the ref first")
        self.head_client.object_announce(ref.object_id.binary())

    def _is_local(self, object_id: ObjectID) -> bool:
        return (self.store.is_ready(object_id)
                or self.store.has_local_producer(object_id))

    def _maybe_pull_from_head(self, object_id: ObjectID) -> None:
        """Pull an object of another driver once: its wire bytes, direct
        from the owner's object server or relayed by the head. Objects
        this driver produces never pull."""
        if self.head_client is None or self._is_local(object_id):
            return
        raw = self.head_client.object_pull(object_id.binary())
        if raw is not None:
            from ray_tpu_torch._private.serialization import (
                SerializedObject,
            )

            self.store.put(object_id, SerializedObject.from_bytes(raw))

    def record_borrowed_owner(self, oid_bin: bytes, owner_info):
        with self._borrowed_lock:
            if len(self.borrowed_owners) > 131072:
                # A hint table (resolution falls back to the head):
                # recency-bounded through dict insertion order.
                self.borrowed_owners.pop(next(iter(self.borrowed_owners)))
            self.borrowed_owners[oid_bin] = (
                owner_info[0], tuple(owner_info[1]))

    def borrowed_owner(self, oid_bin: bytes):
        with self._borrowed_lock:
            return self.borrowed_owners.get(oid_bin)

    def _pull_wait(self, object_id: ObjectID, timeout: Optional[float]):
        """Resolve an object of another runtime, up to ``timeout``
        (``dep_wait_s`` when None; a ``GetTimeoutError`` past it). A ref
        whose owner is known resolves owner-direct (``OwnerResolver``);
        an owner-less one subscribes to the head's ``obj|<hex>`` topic
        first, then pulls, and pulls again on each announce."""
        import queue as _queue

        from ray_tpu_torch.exceptions import GetTimeoutError

        if self._is_local(object_id):
            return
        bound = (float(GlobalConfig.dep_wait_s) if timeout is None
                 else float(timeout))
        deadline = time.monotonic() + bound
        owner = self.borrowed_owner(object_id.binary())
        if owner is not None and self.owner_resolver is not None:
            self.owner_resolver.resolve(
                object_id.binary(), owner[1], owner[0], deadline=deadline)
            return
        sub = self.head_client.subscribe("obj|" + object_id.binary().hex())
        try:
            while True:
                self._maybe_pull_from_head(object_id)
                if self._is_local(object_id):
                    return
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise GetTimeoutError(
                        f"foreign object {object_id.hex()[:16]}… was "
                        f"never announced within {bound:.0f}s "
                        f"(RAY_TPU_DEP_WAIT_S)")
                try:
                    sub.get(timeout=min(remaining, 5.0))
                except _queue.Empty:
                    pass  # deadline re-check; no announce yet
        finally:
            sub.close()

    def get_object(self, ref: ObjectRef, timeout: Optional[float] = None):
        router = self.remote_router
        if router is not None and not self.store.is_ready(ref.object_id) \
                and router.handles(ref.object_id):
            router.ensure_local(ref.object_id, timeout=timeout)
        elif self.head_client is not None:
            self._pull_wait(ref.object_id, timeout)
        if self.store.is_lost(ref.object_id):
            # Its node died on the simulated cluster: rebuild it from
            # lineage (the producer runs again).
            if (self.cluster is not None
                    and self.cluster.recover_object(ref.object_id)):
                self.store.clear_lost(ref.object_id)
            else:
                from ray_tpu_torch.exceptions import ObjectLostError

                raise ObjectLostError(
                    ref.object_id,
                    f"object {ref.object_id.hex()[:16]}… lost and no "
                    f"lineage is available to reconstruct it")
        serialized = self.store.get(ref.object_id, timeout=timeout)
        value = self.serialization_context.deserialize(serialized)
        if isinstance(value, RayTaskError):
            raise value.as_instanceof_cause()
        return value

    def submit_task(self, spec: TaskSpec) -> List[ObjectRef]:
        if tracing._TRACER is not None and spec.trace is None:
            # The submitting thread's ambient context: the task's spans
            # bridge off its task events under it.
            spec.trace = tracing.inject()
            if spec.trace is not None:
                tracing.register_task(spec.task_id.binary(), spec.trace)
        # Pin args that are refs for the duration of the task
        # (submitted refs in the reference's refcount protocol).
        dep_refs = _collect_refs(spec.args, spec.kwargs)
        for ref in dep_refs:
            self.store.add_submitted_ref(ref.object_id)
        routed = (self.cluster is None and self.remote_router is not None
                  and self.remote_router.maybe_route(spec))
        if not routed and self.client_mode:
            # A thin client never runs a task itself: an unroutable one
            # fails loudly instead of queueing on capacity that will
            # never exist here.
            for ref in dep_refs:
                self.store.remove_submitted_ref(ref.object_id)
            raise RayTpuError(
                "client-mode driver (ray://) has no local execution "
                "capacity and no feasible cluster node accepted the task "
                "— start node daemons with `python -m "
                "ray_tpu_torch._private.node_daemon --address=`")
        refs = [ObjectRef(oid) for oid in spec.return_ids]
        if self.head_client is not None and not routed:
            # A routed task's results arrive from its node (the router
            # tracks them); a producer mark would stop their pull.
            for oid in spec.return_ids:
                self.store.mark_local_producer(oid)
        if dep_refs:
            def _release(_refs=dep_refs):
                for r in _refs:
                    self.store.remove_submitted_ref(r.object_id)
            self.store.on_ready(spec.return_ids[0], _release)
        if routed:
            return refs  # the router owns dispatch and completion
        if self.worker_pool is not None and spec.resources.get("GPU"):
            from ray_tpu_torch._private.worker_pool import warn_no_card

            warn_no_card("task", spec.name, spec.resources["GPU"])
        if self.cluster is not None:
            self.cluster.submit(spec)
        else:
            self.scheduler.submit(spec)
        return refs

    def wait(self, object_ids: List[ObjectID], num_returns: int,
             timeout: Optional[float]):
        router = self.remote_router
        for oid in object_ids:
            if self.store.is_ready(oid):
                continue
            if router is not None and router.handles(oid):
                # A completed remote result counts as ready once local:
                # fetch it in the background so wait() sees it promptly.
                router.prefetch(oid)
                continue
            owner = self.borrowed_owner(oid.binary())
            if owner is not None and self.owner_resolver is not None:
                # Borrowed: resolve through its owner in the background.
                self.owner_resolver.prefetch(oid.binary(), owner)
            else:
                self._maybe_pull_from_head(oid)
        return self.store.wait(object_ids, num_returns, timeout)

    # -------------------------------------------------------- internal KV ---
    # With a head attached the KV is cluster-global; standalone it is
    # local to this process.
    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True) -> bool:
        if self.head_client is not None:
            return self.head_client.kv_put(key, value, overwrite)
        with self._kv_lock:
            if not overwrite and key in self._kv:
                return False
            self._kv[key] = value
            return True

    def kv_get(self, key: bytes) -> Optional[bytes]:
        if self.head_client is not None:
            return self.head_client.kv_get(key)
        with self._kv_lock:
            return self._kv.get(key)

    def kv_del(self, key: bytes) -> bool:
        if self.head_client is not None:
            return self.head_client.kv_del(key)
        with self._kv_lock:
            return self._kv.pop(key, None) is not None

    def kv_keys(self, prefix: bytes = b"") -> List[bytes]:
        if self.head_client is not None:
            return self.head_client.kv_keys(prefix)
        with self._kv_lock:
            return [k for k in self._kv if k.startswith(prefix)]

    def shutdown(self):
        """Stop every actor loop and the scheduler, fail every waiter,
        and join the threads (each join bounded). On the process plane
        the worker processes go first (a task blocked on one wakes), and
        the shm store is unmapped and unlinked last, after the actors'
        loops, which tear their channels down, have been joined."""
        self.is_alive = False
        if self.sanitizer_watchdog is not None:
            self.sanitizer_watchdog.stop()
            self.sanitizer_watchdog = None
        actors = list(self.actors.values())
        for actor in actors:
            if getattr(actor, "borrower", False):
                continue  # not ours to kill: the owning driver decides
            try:
                actor.terminate(no_restart=True)
            except Exception:  # noqa: BLE001
                pass
        self._stop_workers()
        self.scheduler.shutdown()
        self.store.close()
        for actor in actors:
            try:
                actor.join(timeout=2)
            except Exception:  # noqa: BLE001
                pass
        self.actors.clear()
        self.named_actors.clear()
        # The router hands its owner table to the head; the head client
        # goes after the actors (their kills deregister their names) and
        # before the shm store.
        if self.remote_router is not None:
            self.remote_router.shutdown()
            self.remote_router = None
        if self.head_client is not None:
            self.head_client.close()
            self.head_client = None
        self._stop_process_plane()


_global_worker: Optional[Worker] = None
_init_lock = threading.Lock()
_atexit_registered = False


def _new_session_dir() -> str:
    """A fresh session directory with its ``logs`` (and the
    ``session_latest`` link beside it)."""
    base = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    path = os.path.join(base, f"session_{uuid.uuid4().hex[:12]}")
    os.makedirs(os.path.join(path, "logs"), exist_ok=True)
    link = os.path.join(base, "session_latest")
    try:
        if os.path.islink(link):
            os.unlink(link)
        os.symlink(path, link)
    except OSError:
        pass
    return path


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
         worker_mode: Optional[str] = None,
         address: Optional[str] = None,
         **_ignored) -> "Worker":
    """Start the runtime: the scheduler's dispatcher and executor threads,
    and with ``worker_mode="process"`` (default: the ``worker_mode`` flag,
    ``"thread"``) the shm store, the worker pool and the monitors.
    Resources: ``num_cpus`` (default: the host's cores), ``num_gpus``
    (default: the visible CUDA cards) and custom ``resources``.
    ``address`` attaches this driver to a head service (module
    docstring); ``"ray://host:port"`` attaches a thin client."""
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
        if address in ("auto", "local"):
            from ray_tpu_torch._private.head_service import DEFAULT_PORT

            address = f"127.0.0.1:{DEFAULT_PORT}"
        client_mode = bool(address) and address.startswith("ray://")
        if client_mode:
            # The thin client keeps no execution capacity: every
            # .remote() routes onto the cluster's node daemons, and
            # results pull back on demand.
            address = address[len("ray://"):]
            num_cpus = 0
            num_gpus = 0
            resources = {}
            worker_mode = worker_mode or "thread"
        # Tracing (RAY_TPU_TRACE) and the flight recorder
        # (RAY_TPU_FLIGHT / RAY_TPU_PROFILE) arm before the worker, so its
        # runtime section registers; one `is None` branch each when off.
        tracing.install_from_env(component="driver")
        flight.install_from_env(component="driver")
        try:
            _global_worker = Worker(num_cpus=num_cpus, num_gpus=num_gpus,
                                    resources=resources,
                                    worker_mode=worker_mode,
                                    head_address=address)
        except BaseException:
            tracing.uninstall()
            flight.uninstall()
            raise
        _global_worker.client_mode = client_mode
        _global_worker.namespace = namespace
        if not _atexit_registered:
            atexit.register(shutdown)
            _atexit_registered = True
        return _global_worker


def shutdown():
    """Tear the runtime down: Serve (controller loops, replicas, the HTTP
    and gRPC proxies) first, then actors, the scheduler and the store; then the
    tracer and the flight recorder (its threads joined). Every drive ends
    with it."""
    global _global_worker
    # Serve's pieces stop only where Serve was loaded (a worker process
    # or a task-only drive never imports it).
    http = sys.modules.get("ray_tpu_torch.serve.http")
    if http is not None:
        http.stop_proxy()
    grpc = sys.modules.get("ray_tpu_torch.serve.grpc")
    if grpc is not None:
        grpc.stop_grpc_proxy()
    controller = sys.modules.get("ray_tpu_torch.serve.controller")
    if controller is not None:
        controller.shutdown_controller()
    # Compiled DAGs' exec loops occupy their actors' loop threads until
    # teardown: end them first, so the actors' joins below can finish.
    compiled_dag = sys.modules.get("ray_tpu_torch.dag.compiled_dag")
    if compiled_dag is not None:
        compiled_dag._teardown_all()
    with _init_lock:
        if _global_worker is not None:
            _global_worker.shutdown()
            _global_worker = None
        tracing.uninstall()
        flight.uninstall()


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
    # Pipelined prefetch: start the pulls of every remote ref up front,
    # so the loop below finds most bytes local.
    router = getattr(worker, "remote_router", None)
    if router is not None:
        for r in refs:
            if worker.store.is_ready(r.object_id):
                continue
            if router.handles(r.object_id):
                router.prefetch(r.object_id)
            else:
                owner = worker.borrowed_owner(r.object_id.binary())
                if owner is not None and worker.owner_resolver is not None:
                    worker.owner_resolver.prefetch(
                        r.object_id.binary(), owner)
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
