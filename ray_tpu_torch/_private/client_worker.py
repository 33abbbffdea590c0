"""The ``ray_tpu_torch`` API inside a worker process (counterpart of
``ray_tpu/_private/client_worker.py``).

When ``worker_main`` boots it installs a ``ClientWorker`` as the
process-global worker, so task code calling ``ray_tpu_torch.get``,
``put``, ``wait``, ``.remote()`` (of a function, of an actor method on a
handle passed in, of an actor class) or ``get_runtime_context`` forwards
over the worker's API channel pair to the driver's ``driver_service``
instead of booting a second runtime in the worker.

One request at a time (a lock serializes them), so replies need no
correlation ids. Values cross in the wire form
(``serialization.wire_dumps``); one bigger than the inline limit rides
the shm object store.
"""

from __future__ import annotations

import pickle
import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    TaskID,
    WorkerID,
    _Counter,
)
from ray_tpu_torch._private.serialization import (
    WireSerializationContext,
    wire_dumps,
    wire_loads,
)
from ray_tpu_torch.exceptions import RayTaskError, RayTpuError

_INLINE_LIMIT = 256 * 1024   # headroom under the channel's capacity


class _NullRefTable:
    """ObjectRef refcount shim: the driver's service pins the objects a
    worker makes for the worker's lifetime, so counting here is a
    no-op."""

    def add_local_ref(self, oid):
        pass

    def remove_local_ref(self, oid):
        pass

    def on_ready(self, oid, callback):
        raise RayTpuError(
            "ObjectRef.future()/await is not supported inside worker "
            "processes; use ray_tpu_torch.get()")


class ClientWorker:
    """Thin worker-process runtime that proxies the API to the driver."""

    def __init__(self, shm_store, api_req, api_rep, worker_id: int):
        self.is_alive = True
        self._shm = shm_store
        self._req = api_req
        self._rep = api_rep
        self._lock = threading.Lock()
        self._client_worker_id = worker_id
        self.store = _NullRefTable()
        self.serialization_context = WireSerializationContext()
        self.submission_counter = _Counter()
        self.put_counter = _Counter()
        self._stage_counter = _Counter()
        self.worker_id = WorkerID.from_random()
        # Fetched lazily: the driver may still be booting when this
        # process starts.
        self._ctx: Optional[dict] = None

    def _driver_ctx(self) -> dict:
        if self._ctx is None:
            self._ctx = self._request(("api_ctx",))
        return self._ctx

    @property
    def job_id(self) -> JobID:
        return JobID(self._driver_ctx()["job_id"])

    @property
    def node_id(self) -> NodeID:
        return NodeID(self._driver_ctx()["node_id"])

    @property
    def namespace(self) -> str:
        return self._driver_ctx()["namespace"]

    @property
    def job_task_id(self) -> TaskID:
        return TaskID.for_job(self.job_id)

    # ------------------------------------------------------------ transport
    def _request(self, msg: tuple, timeout: float = 300.0):
        raw = pickle.dumps(msg, protocol=5)
        if len(raw) > _INLINE_LIMIT:
            # An oversized request (a big kv value, a task payload): the
            # whole pickled message goes through the store.
            key = self._stage_key()
            self._shm.put(key, raw)
            msg = ("api_blob", key)
        with self._lock:
            self._req.write(msg, timeout=30.0)
            status, value = self._rep.read(timeout=timeout)
        if status == "okshm_reply":   # an oversized reply, staged whole
            raw = bytes(self._shm.get(value))
            self._shm.delete(value)
            status, value = pickle.loads(raw)
        if status == "err":
            raise pickle.loads(value)
        return value

    def _stage_key(self) -> int:
        # Disjoint fields: prefix bits 52-63, worker id bits 32-51,
        # counter bits 0-31.
        return ((0xA4B << 52)
                | (self._client_worker_id & 0xF_FFFF) << 32
                | (self._stage_counter.next() & 0xFFFF_FFFF))

    # ------------------------------------------------------------ task ctx
    def current_task_id(self) -> TaskID:
        from ray_tpu_torch._private.worker import _task_context

        tid = _task_context.current_task_id
        return tid if tid is not None else self.job_task_id

    def next_task_id(self) -> TaskID:
        return TaskID.of(self.current_task_id(),
                         self.submission_counter.next())

    # ------------------------------------------------------------------ api
    def put_object(self, value: Any):
        from ray_tpu_torch._private.worker import ObjectRef

        if isinstance(value, ObjectRef):
            raise TypeError(
                "Calling put() on an ObjectRef is not allowed; pass the ref "
                "directly instead.")
        oid = ObjectID.for_put(self.current_task_id(),
                               self.put_counter.next())
        data = wire_dumps(value)
        if len(data) > _INLINE_LIMIT:
            key = self._stage_key()
            self._shm.put(key, data)
            self._request(("api_put", oid.binary(), key, True))
        else:
            self._request(("api_put", oid.binary(), data, False))
        return ObjectRef(oid)

    def get_object(self, ref, timeout: Optional[float] = None):
        data = self._request(
            ("api_get", ref.object_id.binary(), timeout),
            timeout=(timeout + 30.0) if timeout is not None else 3600.0)
        value = wire_loads(data)
        if isinstance(value, RayTaskError):
            raise value.as_instanceof_cause()
        return value

    def wait(self, object_ids: List[ObjectID], num_returns: int,
             timeout: Optional[float]):
        ready, not_ready = self._request(
            ("api_wait", [o.binary() for o in object_ids], num_returns,
             timeout),
            timeout=(timeout + 30.0) if timeout is not None else 3600.0)
        return ([ObjectID(b) for b in ready],
                [ObjectID(b) for b in not_ready])

    def submit_task(self, spec) -> List[Any]:
        from ray_tpu_torch._private.worker import ObjectRef

        self._request(("api_submit", wire_dumps(spec)))
        return [ObjectRef(oid) for oid in spec.return_ids]

    def actor_submit(self, actor_id: ActorID, method_name: str, args,
                     kwargs, num_returns: int, name: str) -> List[Any]:
        from ray_tpu_torch._private.worker import ObjectRef

        oid_bins = self._request(
            ("api_actor_submit", actor_id.binary(), method_name,
             wire_dumps((args, kwargs)), num_returns, name))
        return [ObjectRef(ObjectID(b)) for b in oid_bins]

    def actor_create(self, cls: type, args, kwargs,
                     opts: Dict[str, Any]) -> ActorID:
        actor_bin = self._request(
            ("api_actor_create", wire_dumps(cls), wire_dumps((args, kwargs)),
             dict(opts or {})))
        return ActorID(actor_bin)

    def actor_named(self, name: str, namespace: Optional[str]) -> ActorID:
        return ActorID(self._request(("api_actor_named", name, namespace)))

    @property
    def resource_pool(self):
        """Shim so the resource introspection APIs work inside workers."""
        client = self

        class _Pool:
            def available(self):
                return client._request(("api_resources", "available"))

            @property
            def total(self):
                return client._request(("api_resources", "total"))

        return _Pool()

    # ------------------------------------------------------------------- kv
    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True):
        op = "put" if overwrite else "put_once"
        return self._request(("api_kv", op, key, value))

    def kv_get(self, key: bytes):
        return self._request(("api_kv", "get", key, None))

    def kv_del(self, key: bytes):
        return self._request(("api_kv", "del", key, None))

    def kv_keys(self, prefix: bytes = b""):
        return self._request(("api_kv", "keys", prefix, None))

    def shutdown(self):
        self.is_alive = False


class ClientActorHandle:
    """An actor handle inside a worker process: method calls go to the
    driver, which routes them to the actor's runtime."""

    def __init__(self, actor_id: ActorID, class_name: str = "Actor"):
        self._actor_id = actor_id
        self._class_name = class_name

    @property
    def _ray_actor_id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, item: str):
        if item.startswith("_"):
            raise AttributeError(item)
        return _ClientActorMethod(self, item)

    def __reduce__(self):
        from ray_tpu_torch.actor import _rebuild_handle

        return (_rebuild_handle, (self._actor_id,))

    def __repr__(self):
        return (f"ClientActorHandle({self._class_name}, "
                f"{self._actor_id.hex()[:12]}…)")


class _ClientActorMethod:
    def __init__(self, handle: ClientActorHandle, method_name: str,
                 options: Optional[Dict[str, Any]] = None):
        self._handle = handle
        self._method_name = method_name
        self._options = dict(options or {})

    def options(self, **opts) -> "_ClientActorMethod":
        merged = dict(self._options)
        merged.update(opts)
        return _ClientActorMethod(self._handle, self._method_name, merged)

    def remote(self, *args, **kwargs):
        from ray_tpu_torch._private.worker import global_worker

        num_returns = self._options.get("num_returns", 1)
        name = self._options.get(
            "name", f"{self._handle._class_name}.{self._method_name}")
        refs = global_worker().actor_submit(
            self._handle._actor_id, self._method_name, args, kwargs,
            num_returns, name)
        return refs[0] if num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._method_name!r} cannot be called directly; "
            f"use .remote().")
