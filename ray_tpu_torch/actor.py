"""Actors: stateful workers with ordered method execution (counterpart of
``ray_tpu/actor.py``, trimmed to the in-process loops).

``remote`` on a class yields an ``ActorClass``; ``.remote()`` creates an
actor backed by its own execution loop in this process: one thread for
a sync actor, a pool of threads for ``max_concurrency > 1``, an asyncio
event loop for an actor with ``async`` methods. Method calls are queued
in order and return ObjectRefs; generator methods
(``num_returns="streaming"``) stream on the same plane as generator
tasks. ``max_restarts`` restarts a killed actor with fresh state; named
actors resolve through ``get_actor``; ``kill`` ends an actor, after
which its calls fail with ``ActorDiedError``. Each call records
PENDING_ACTOR_TASK at submit and RUNNING, then FINISHED or FAILED, as it
executes into the worker's task-event ring (the reference records the
execution states on the sync loops; here the async loop records them
too), registers the caller's trace context when tracing is armed, and
marks its execution for the flight recorder.

On the process plane (``init(worker_mode="process")``) every actor
flavor lives in a worker process of its own (``_run_proc`` for a sync
actor, ``_run_proc_mux`` for async and threaded ones), so its crash or
``kill -9`` fails only its calls (``ActorDiedError``) and ``max_restarts``
restarts it with fresh state. Such an actor never reaches the card; one
created with ``runtime="driver"`` (an actor option) stays in the
driver's process, where it does. A handle passed into a worker process
forwards its calls to the driver (``ClientActorHandle``). A compiled
DAG's stages on a process-backed actor run inside its worker process
(``start_dag_loop``) over the native shm channels.

On a driver attached to a head (``init(address=...)``), a named actor
registers its name with the head before its runtime is built, and
releases it on ``kill`` and at shutdown; ``get_actor`` resolves a name
that another driver registered to a ``CrossDriverActorHandle``, whose
calls relay head -> owning driver and resolve to the owner's results,
pulled back by id. With node daemons in the cluster, the router may
place an actor on one (``RemoteRouter.place_actor``): its runtime is
then a ``RemoteActorRuntime`` (``_private/remote_actor.py``) whose calls
go direct to the hosting node, and ``get_actor`` and an unpickled handle
borrow such an actor through the head's placement directory.
"""

from __future__ import annotations

import asyncio
import inspect
import os
import queue
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch._private import flight, tracing
from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch._private.ids import ActorID, ObjectID, TaskID
from ray_tpu_torch._private.log import get_logger
from ray_tpu_torch._private.scheduler import _ExecutorThreads
from ray_tpu_torch._private.streaming import stream_end_id, stream_item_id
from ray_tpu_torch._private.worker import (
    ObjectRef,
    ObjectRefGenerator,
    auto_init,
    global_worker,
)
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    RayActorError,
    RayTaskError,
    TaskCancelledError,
    WorkerCrashedError,
)

log = get_logger(__name__)

_TERMINATE = object()


class _ClosureCall:
    """A raw closure run on the actor's execution loop with the
    instance: a compiled DAG hosts its long-running exec loop in the
    actor this way (serialised with normal method calls)."""

    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn


class _MethodCall:
    __slots__ = ("method_name", "args", "kwargs", "return_ids", "name",
                 "cancelled", "streaming", "backpressure")

    def __init__(self, method_name, args, kwargs, return_ids, name,
                 streaming: bool = False, backpressure: int = 0):
        self.method_name = method_name
        self.args = args
        self.kwargs = kwargs
        self.return_ids = return_ids
        self.name = name
        self.cancelled = False
        # Generator method (num_returns="streaming"): return_ids holds
        # only the stream END MARKER; items commit per yield.
        self.streaming = streaming
        self.backpressure = backpressure


class _ActorRuntime:
    """Execution loop + mailbox for one actor instance."""

    def __init__(self, actor_id: ActorID, cls: type, init_args, init_kwargs,
                 *, max_concurrency: Optional[int], max_restarts: int,
                 name: str, actor_name: Optional[str],
                 runtime_target: Optional[str] = None):
        self.actor_id = actor_id
        self.cls = cls
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.max_restarts = max_restarts
        self.restarts_used = 0
        self.class_name = name
        self.actor_name = actor_name
        # (namespace, name) registered with the head, released on kill.
        self._registered_name: Optional[tuple] = None
        self.dead = False
        self.death_cause: Optional[str] = None
        self._mailbox: "queue.Queue" = queue.Queue()
        self._seq_counter = 0
        self._lock = threading.Lock()
        self._threads = []
        self.is_async = any(
            inspect.iscoroutinefunction(m) or inspect.isasyncgenfunction(m)
            for _, m in inspect.getmembers(cls, inspect.isfunction)
        )
        # Default concurrency: async actors interleave up to 1000
        # coroutines (reference default); sync actors are single-threaded
        # unless asked.
        if max_concurrency is None:
            max_concurrency = 1000 if self.is_async else 1
        self.max_concurrency = max(int(max_concurrency), 1)
        # The process plane: every actor flavor lives in a worker process
        # of its own, so its crash or kill -9 never touches the driver.
        # A sync single-threaded actor uses the request/reply channel;
        # async and threaded actors the multiplexed submit/calldone
        # protocol. runtime="driver" keeps the actor in this process
        # (where it reaches the card).
        worker = global_worker()
        self.runtime_target = runtime_target
        self.use_process = (getattr(worker, "shm_store", None) is not None
                            and runtime_target != "driver")
        self.use_mux = self.use_process and (
            self.is_async or self.max_concurrency > 1)
        self._proc = None
        self._restart_pending = False
        self.pid: Optional[int] = None
        self._start_loop()

    # ---------------------------------------------------------------- loops
    def _start_loop(self):
        self._instance_ready = threading.Event()
        self._init_error: Optional[BaseException] = None
        if self.use_process:
            target = self._run_proc_mux if self.use_mux else self._run_proc
        else:
            target = self._run_async if self.is_async else self._run_sync
        thread = threading.Thread(
            target=target, args=(self._mailbox,),
            daemon=True, name=f"actor-{self.class_name}",
        )
        self._threads.append(thread)
        thread.start()

    def _construct(self):
        try:
            self.instance = self.cls(*self.init_args, **self.init_kwargs)
            self._init_error = None
        except BaseException as e:  # noqa: BLE001 — init error boundary
            self._init_error = e
            self.dead = True
            self.death_cause = f"__init__ failed: {e!r}"
        finally:
            self._instance_ready.set()

    def _run_sync(self, mailbox):
        self._construct()
        worker = global_worker()
        if self._init_error is not None:
            self._drain_with_error(mailbox)
            return
        if self.max_concurrency > 1:
            pool = _ExecutorThreads(self.max_concurrency,
                                    f"actor-{self.class_name}")
            try:
                while True:
                    call = mailbox.get()
                    if call is _TERMINATE:
                        return
                    if isinstance(call, _ClosureCall):
                        pool.submit(call.fn, self.instance)
                    else:
                        pool.submit(self._execute_call, worker, call)
            finally:
                pool.shutdown()
        while True:
            call = mailbox.get()
            if call is _TERMINATE:
                return
            if isinstance(call, _ClosureCall):
                call.fn(self.instance)
            else:
                self._execute_call(worker, call)

    def _run_async(self, mailbox):
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._construct()
        worker = global_worker()
        if self._init_error is not None:
            self._drain_with_error(mailbox)
            loop.close()
            return

        async def _main():
            sem = asyncio.Semaphore(self.max_concurrency)
            running = set()   # the loop holds tasks weakly
            while True:
                call = await loop.run_in_executor(None, mailbox.get)
                if call is _TERMINATE:
                    return
                if isinstance(call, _ClosureCall):
                    # A blocking exec loop runs off the event loop, so the
                    # actor's coroutines stay responsive.
                    loop.run_in_executor(None, call.fn, self.instance)
                    continue
                await sem.acquire()

                async def _run(call=call):
                    try:
                        await self._execute_call_async(worker, call)
                    finally:
                        sem.release()

                task = loop.create_task(_run())
                running.add(task)
                task.add_done_callback(running.discard)

        try:
            loop.run_until_complete(_main())
            loop.run_until_complete(loop.shutdown_default_executor())
        finally:
            loop.close()

    # ------------------------------------------------- process-backed actor
    def _spawn_proc(self):
        """Spawn the actor's own worker process and construct the
        instance in it (fresh state); raises when construction fails."""
        from ray_tpu_torch._private.serialization import require_cloudpickle
        from ray_tpu_torch._private.worker_pool import (
            WorkerProcess,
            maybe_stage,
            pack_args,
        )

        worker = global_worker()
        shm = worker.shm_store
        proc = WorkerProcess(shm, max_msg=GlobalConfig.worker_channel_bytes,
                             log_dir=os.path.join(worker.session_dir, "logs"))
        staged = []
        try:
            args, kwargs = _resolve_values(worker, self.init_args,
                                           self.init_kwargs)
            payload, staged = pack_args(shm, args, kwargs)
            limit = max(proc.max_msg // 4, 64 * 1024)
            cls_bytes, st = maybe_stage(
                shm, require_cloudpickle().dumps(self.cls), limit)
            staged += st
            payload, st = maybe_stage(shm, payload, limit)
            staged += st
            if self.use_mux:
                mode = "async" if self.is_async else "threaded"
                proc.request(("actor_new2", cls_bytes, payload, mode,
                              self.max_concurrency))
            else:
                proc.request(("actor_new", cls_bytes, payload))
        except BaseException:
            proc.shutdown(timeout=0.1)
            raise
        finally:
            _delete_keys(shm, staged)
        return proc

    def _proc_started(self, mailbox) -> bool:
        """Spawn the process; on failure mark the actor dead and fail its
        queued calls. Returns whether it started."""
        try:
            self._proc = self._spawn_proc()
            self.pid = self._proc.pid
            self._init_error = None
        except BaseException as e:  # noqa: BLE001 — init error boundary
            self._init_error = e
            self.dead = True
            self.death_cause = f"__init__ failed: {e!r}"
            self._instance_ready.set()
            self._drain_with_error(mailbox)
            return False
        # A compiled DAG's exec loop sees a proxy whose method calls go
        # into the worker process on this thread.
        self.instance = _ProcessActorProxy(self)
        return True

    def _run_closure(self, call: "_ClosureCall"):
        try:
            call.fn(self.instance)
        except Exception as exc:  # noqa: BLE001 — exec loop boundary
            log.warning("actor closure call failed; exec loop continues: "
                        "%r", exc)

    def _run_proc(self, mailbox):
        worker = global_worker()
        if not self._proc_started(mailbox):
            return
        self._instance_ready.set()
        while True:
            call = mailbox.get()
            if call is _TERMINATE:
                if self._proc is not None:
                    self._proc.shutdown(timeout=0.5)
                return
            if isinstance(call, _ClosureCall):
                self._run_closure(call)
                continue
            if self._restart_pending and not self.dead:
                try:
                    self._proc.shutdown(timeout=0.1)
                    self._proc = self._spawn_proc()
                    self.pid = self._proc.pid
                except BaseException as e:  # noqa: BLE001
                    self.dead = True
                    self.death_cause = f"restart failed: {e!r}"
                finally:
                    self._restart_pending = False
            if self.dead:
                self._fail_call(worker, call, ActorDiedError(
                    self.actor_id, self.death_cause or "actor is dead"))
                continue
            self._execute_call_proc(worker, call)

    def _run_proc_mux(self, mailbox):
        """Mailbox loop of an async or threaded actor in a worker
        process: calls are fire-and-forget 'actor_submit' writes and a
        pump thread matches the out-of-order ('calldone', call_id, ...)
        completions, so up to max_concurrency calls overlap inside the
        worker while this loop keeps dispatching."""
        worker = global_worker()
        if not self._proc_started(mailbox):
            return
        self._mux_pending: Dict[int, dict] = {}
        self._mux_lock = threading.Lock()
        self._mux_call_counter = 0
        self._start_pump(worker)
        self._instance_ready.set()
        while True:
            call = mailbox.get()
            if call is _TERMINATE:
                if self._proc is not None:
                    self._proc.shutdown(timeout=0.5)
                return
            if isinstance(call, _ClosureCall):
                self._run_closure(call)
                continue
            if (self._restart_pending or not self._proc.alive()) \
                    and not self.dead:
                self._mux_respawn(worker)
            if self.dead:
                self._fail_call(worker, call, ActorDiedError(
                    self.actor_id, self.death_cause or "actor is dead"))
                continue
            self._mux_dispatch(worker, call)

    def _mux_fail_pending(self, worker):
        """Fail every call in flight against the current process (and
        wake proxy waiters): their process is gone."""
        with self._mux_lock:
            pending, self._mux_pending = dict(self._mux_pending), {}
        err = ActorDiedError(
            self.actor_id, self.death_cause or "actor worker process died")
        for entry in pending.values():
            if "waiter" in entry:
                entry["status"] = "died"
                entry["waiter"].set()
                continue
            self._fail_call(worker, entry["call"], err)
            _delete_keys(worker.shm_store, entry["staged"])

    def _mux_respawn(self, worker):
        """Replace a dead or killed worker process by a fresh one (fresh
        actor state), consuming restart budget unless terminate() counted
        it already."""
        if self._restart_pending:
            consume = False
        elif self.restarts_used < self.max_restarts:
            consume = True
        else:
            self.dead = True
            self.death_cause = (self.death_cause
                                or "actor worker process died")
            return
        self._restart_pending = False
        if consume:
            self.restarts_used += 1
        # Calls in flight against the dead process fail first: its pump
        # may exit on its process-identity check without failing them.
        self._mux_fail_pending(worker)
        try:
            self._proc.shutdown(timeout=0.1)
            self._proc = self._spawn_proc()
            self.pid = self._proc.pid
            self._start_pump(worker)
        except BaseException as e:  # noqa: BLE001
            self.dead = True
            self.death_cause = f"restart failed: {e!r}"

    def _mux_dispatch(self, worker, call: _MethodCall):
        from ray_tpu_torch._private.worker_pool import (
            maybe_stage,
            oid_key,
            pack_args,
        )

        if call.cancelled:
            self._fail_call(worker, call, TaskCancelledError())
            return
        shm = worker.shm_store
        task_id = call.return_ids[0].task_id()
        worker.task_events.record(task_id, "RUNNING", name=call.name)
        staged: list = []
        ret_keys = [oid_key(oid) for oid in call.return_ids]
        call_id = None
        try:
            args, kwargs = _resolve_actor_args(worker, call)
            payload, staged = pack_args(shm, args, kwargs)
            payload, st = maybe_stage(
                shm, payload, max(self._proc.max_msg // 4, 64 * 1024))
            staged += st
            _delete_keys(shm, ret_keys)
            entry = {"call": call, "staged": staged, "ret_keys": ret_keys}
            stream_budget = None
            if call.streaming:
                # Items come back as ("calldone", call_id, "item", ...);
                # consumption acks go out as stream_ack requests, which
                # the worker's main loop drains continuously.
                stream_budget = int(call.backpressure)
                stream = worker.streams.get_or_create(task_id)
                entry["stream"] = stream
                entry["cancel_sent"] = False
                proc = self._proc
                tid_bin = task_id.binary()

                def _wire_ack(n, _p=proc, _t=tid_bin, _e=entry):
                    try:
                        _p._req.write(("stream_ack", _t, int(n)),
                                      timeout=5.0)
                        if n > _e.get("acked", 0):
                            _e["acked"] = n
                    except Exception:  # noqa: BLE001 — the pump re-sends
                        pass
                stream.add_consume_listener(_wire_ack)
            with self._mux_lock:
                self._mux_call_counter += 1
                call_id = self._mux_call_counter
                self._mux_pending[call_id] = entry
            self._proc._req.write(
                ("actor_submit", call_id, call.method_name, payload,
                 ret_keys, len(call.return_ids), task_id.binary(),
                 call.name, stream_budget), timeout=60.0)
        except BaseException as exc:  # noqa: BLE001 — dispatch boundary
            with self._mux_lock:
                if call_id is not None:
                    self._mux_pending.pop(call_id, None)
            _delete_keys(shm, staged)
            self._fail_call(worker, call, exc if isinstance(
                exc, RayTaskError) else RayTaskError.from_exception(
                    call.name, exc))
            worker.task_events.record(task_id, "FAILED", name=call.name)

    def _start_pump(self, worker):
        thread = threading.Thread(
            target=self._pump_loop, args=(worker, self._proc), daemon=True,
            name=f"actor-pump-{self.class_name}")
        self._threads.append(thread)
        thread.start()

    def _pump_loop(self, worker, proc):
        """Read the out-of-order completions off the reply channel; when
        the worker dies, fail every call in flight with ActorDiedError
        (an interrupted call is NOT retried, as in the reference)."""
        import pickle

        from ray_tpu_torch._private.serialization import SerializedObject
        from ray_tpu_torch.exceptions import ChannelTimeoutError

        shm = worker.shm_store
        while True:
            try:
                msg = proc._rep.read(timeout=0.2)
            except ChannelTimeoutError:
                if not proc.alive() or proc is not self._proc:
                    break
                self._mux_propagate_cancels(proc)
                self._mux_resend_watermarks(proc)
                continue
            except Exception as exc:  # noqa: BLE001 — channel torn down
                log.debug("mux reply channel torn down; pump exiting: "
                          "%r", exc)
                break
            if not msg or msg[0] != "calldone":
                continue
            _, call_id, status, value = msg
            if status == "item":
                # A yield mid-stream: commit it, keep the entry.
                with self._mux_lock:
                    entry = self._mux_pending.get(call_id)
                stream = (entry or {}).get("stream")
                if stream is None:
                    continue   # a stale frame of a replaced worker
                try:
                    idx, field = value
                    if isinstance(field, (tuple, list)) and field and \
                            field[0] == "shm":
                        raw = bytes(shm.get(field[1]))
                        _delete_keys(shm, [field[1]])
                    else:
                        raw = bytes(field)
                    tid = entry["call"].return_ids[0].task_id()
                    worker.store.put(stream_item_id(tid, int(idx)),
                                     SerializedObject.from_bytes(raw))
                    stream.commit(int(idx))
                except Exception as exc:  # noqa: BLE001 — the terminal
                    # frame settles the call
                    log.warning("dropping corrupt stream item frame: "
                                "%r", exc)
                self._mux_propagate_cancels(proc)
                continue
            with self._mux_lock:
                entry = self._mux_pending.pop(call_id, None)
            if entry is None:
                continue
            if "waiter" in entry:   # a proxy apply: hand over, notify
                entry["status"], entry["value"] = status, value
                entry["waiter"].set()
                continue
            call = entry["call"]
            tid = call.return_ids[0].task_id()
            try:
                if status == "ok":
                    for oid, key in zip(call.return_ids,
                                        entry["ret_keys"]):
                        raw = bytes(shm.get(key))
                        worker.store.put(
                            oid, SerializedObject.from_bytes(raw))
                        _delete_keys(shm, [key])
                    worker.task_events.record(tid, "FINISHED",
                                              name=call.name)
                elif status == "ok_stream":
                    total = int(value)
                    worker.store.put(
                        stream_end_id(tid),
                        worker.serialization_context.serialize(total))
                    entry["stream"].finish(total)
                    worker.task_events.record(tid, "FINISHED",
                                              name=call.name)
                elif status == "cancelled":
                    self._fail_call(worker, call, TaskCancelledError(tid))
                elif status == "err":
                    self._fail_call(worker, call, pickle.loads(value))
                    worker.task_events.record(tid, "FAILED",
                                              name=call.name)
                else:
                    self._fail_call(worker, call, RayActorError(
                        self.actor_id, f"unexpected status {status!r}"))
            except Exception as exc:  # noqa: BLE001 — completion boundary
                self._fail_call(
                    worker, call,
                    RayTaskError.from_exception(call.name, exc))
            finally:
                _delete_keys(shm, entry["staged"])
        # The worker died (or was replaced): fail what is still in
        # flight against THIS process.
        if proc is self._proc:
            self._mux_fail_pending(worker)

    def _mux_propagate_cancels(self, proc):
        """A consumer dropped its generator mid-stream: tell the worker
        (once per call), so its yield loop stops between yields."""
        with self._mux_lock:
            entries = [e for e in self._mux_pending.values()
                       if e.get("stream") is not None
                       and e["stream"].cancelled
                       and not e.get("cancel_sent")]
            for e in entries:
                e["cancel_sent"] = True
        for e in entries:
            try:
                proc._req.write(
                    ("stream_ack",
                     e["call"].return_ids[0].task_id().binary(), -1),
                    timeout=1.0)
            except Exception:  # noqa: BLE001 — the worker died
                pass

    def _mux_resend_watermarks(self, proc):
        """Ack-loss recovery: an ack write that timed out would park a
        stream at its budget for good, so the pump's idle slices re-send
        any watermark ahead of the last one delivered."""
        with self._mux_lock:
            stale = [(e, e["stream"].consumed)
                     for e in self._mux_pending.values()
                     if e.get("stream") is not None
                     and not e["stream"].cancelled
                     and e["stream"].consumed > e.get("acked", 0)]
        for e, n in stale:
            try:
                proc._req.write(
                    ("stream_ack",
                     e["call"].return_ids[0].task_id().binary(), int(n)),
                    timeout=1.0)
                if n > e.get("acked", 0):
                    e["acked"] = n
            except Exception:  # noqa: BLE001 — retried next idle slice
                pass

    def _execute_call_proc(self, worker, call: _MethodCall):
        from ray_tpu_torch._private.scheduler import pump_stream_replies
        from ray_tpu_torch._private.serialization import SerializedObject
        from ray_tpu_torch._private.worker_pool import (
            maybe_stage,
            oid_key,
            pack_args,
        )

        if call.cancelled:
            self._fail_call(worker, call, TaskCancelledError())
            return
        shm = worker.shm_store
        task_id = call.return_ids[0].task_id()
        worker.task_events.record(task_id, "RUNNING", name=call.name)
        staged: list = []
        ret_keys = [oid_key(oid) for oid in call.return_ids]
        try:
            args, kwargs = _resolve_actor_args(worker, call)
            payload, staged = pack_args(shm, args, kwargs)
            payload, st = maybe_stage(
                shm, payload, max(self._proc.max_msg // 4, 64 * 1024))
            staged += st
            if call.streaming:
                # A generator method: the streaming task's item-frame
                # pump (the pause protocol is in worker_main, the acks
                # on the ack channel).
                stream = worker.streams.get_or_create(task_id)
                self._proc._req.write(
                    ("actor_stream", call.method_name, payload,
                     task_id.binary(), call.name, int(call.backpressure)),
                    timeout=60.0)
                pump_stream_replies(
                    self._proc, task_id, call.name, stream, worker.store,
                    shm, worker.serialization_context)
            else:
                _delete_keys(shm, ret_keys)   # a crashed attempt's keys
                self._proc.request(
                    ("actor_call", call.method_name, payload, ret_keys,
                     len(call.return_ids), task_id.binary(), call.name))
                for oid, key in zip(call.return_ids, ret_keys):
                    raw = bytes(shm.get(key))
                    worker.store.put(oid, SerializedObject.from_bytes(raw))
                    _delete_keys(shm, [key])
            worker.task_events.record(task_id, "FINISHED", name=call.name)
        except WorkerCrashedError as e:
            self._on_proc_crash(worker, call, e)
            worker.task_events.record(task_id, "FAILED", name=call.name)
        except BaseException as exc:  # noqa: BLE001 — method error boundary
            if isinstance(exc, (RayTaskError, TaskCancelledError)):
                self._fail_call(worker, call, exc)
            else:
                self._fail_call(
                    worker, call, RayTaskError.from_exception(call.name, exc))
            worker.task_events.record(task_id, "FAILED", name=call.name)
        finally:
            _delete_keys(shm, staged)

    def _proxy_apply(self, method_name: str, args, kwargs):
        """A synchronous method call for _ProcessActorProxy (on the actor
        loop thread; the result rides the reply channel)."""
        from ray_tpu_torch._private.serialization import wire_loads
        from ray_tpu_torch._private.worker_pool import maybe_stage, pack_args

        worker = global_worker()
        if self.dead or self._proc is None or not self._proc.alive():
            raise ActorDiedError(self.actor_id,
                                 self.death_cause or "actor is dead")
        if self.use_mux:
            return self._proxy_apply_mux(worker, method_name, args, kwargs)
        shm = worker.shm_store
        payload, staged = pack_args(shm, args, kwargs)
        payload, st = maybe_stage(
            shm, payload, max(self._proc.max_msg // 4, 64 * 1024))
        staged += st
        try:
            raw = self._proc.request(
                ("actor_call", method_name, payload, [], 1, b"",
                 method_name))
            return wire_loads(raw)
        except RayTaskError as e:
            # The original exception's type: the caller wraps it once,
            # as on the in-driver path.
            raise e.as_instanceof_cause() from None
        except WorkerCrashedError as e:
            self.dead = True
            self.death_cause = f"actor worker process died: {e}"
            raise ActorDiedError(self.actor_id, self.death_cause) from e
        finally:
            _delete_keys(shm, staged)

    def _proxy_apply_mux(self, worker, method_name: str, args, kwargs):
        """A proxy call over the multiplexed channel: a waiter the pump
        resolves (the pump owns the reply channel)."""
        import pickle

        from ray_tpu_torch._private.serialization import wire_loads
        from ray_tpu_torch._private.worker_pool import maybe_stage, pack_args

        shm = worker.shm_store
        payload, staged = pack_args(shm, args, kwargs)
        payload, st = maybe_stage(
            shm, payload, max(self._proc.max_msg // 4, 64 * 1024))
        staged += st
        entry = {"waiter": threading.Event(), "status": None, "value": None}
        proc = self._proc   # liveness follows the process dispatched to
        try:
            with self._mux_lock:
                self._mux_call_counter += 1
                call_id = self._mux_call_counter
                self._mux_pending[call_id] = entry
            proc._req.write(
                ("actor_submit", call_id, method_name, payload, [], 1,
                 b"", method_name, None), timeout=60.0)
            while not entry["waiter"].wait(timeout=0.5):
                if not proc.alive():
                    with self._mux_lock:
                        self._mux_pending.pop(call_id, None)
                    if entry["status"] is None:
                        entry["status"] = "died"
                    break
            status, value = entry["status"], entry["value"]
            if status == "okv":
                return wire_loads(value)
            if status == "okshm":
                raw = bytes(shm.get(value))
                _delete_keys(shm, [value])
                return wire_loads(raw)
            if status == "err":
                raise pickle.loads(value).as_instanceof_cause() from None
            # The worker died mid-call. The actor is not marked dead here:
            # _mux_respawn may have restarted it within its budget.
            raise ActorDiedError(
                self.actor_id,
                self.death_cause or "actor worker process died mid-call")
        finally:
            _delete_keys(shm, staged)

    def _on_proc_crash(self, worker, call: _MethodCall, exc: BaseException):
        """The actor's worker died mid-call: fail that call, then restart
        with fresh state if the policy allows (the interrupted call is
        NOT retried, as in the reference)."""
        self._fail_call(worker, call, ActorDiedError(
            self.actor_id, f"actor worker process died: {exc}"))
        if self._restart_pending:
            consume = False   # terminate(no_restart=False) counted it
        elif not self.dead and self.restarts_used < self.max_restarts:
            consume = True
        else:
            self.dead = True
            self.death_cause = (self.death_cause
                                or f"actor worker process died: {exc}")
            return
        self._restart_pending = False
        if consume:
            self.restarts_used += 1
        try:
            self._proc.shutdown(timeout=0.1)
            self._proc = self._spawn_proc()
            self.pid = self._proc.pid
        except BaseException as e:  # noqa: BLE001
            self.dead = True
            self.death_cause = f"restart failed: {e!r}"

    # ------------------------------------------------------------ execution
    def _execute_call(self, worker, call: _MethodCall):
        if call.cancelled:
            self._fail_call(worker, call, TaskCancelledError())
            return
        task_id = call.return_ids[0].task_id()
        worker.task_events.record(task_id, "RUNNING", name=call.name)
        if flight._FLIGHT is not None:
            flight.note_task_started(call.name)
        try:
            method = getattr(self.instance, call.method_name)
            args, kwargs = _resolve_actor_args(worker, call)
            result = method(*args, **kwargs)
            if call.streaming:
                self._stream_call_outputs(worker, call, result)
            else:
                self._store_outputs(worker, call, result)
            worker.task_events.record(task_id, "FINISHED", name=call.name)
        except Exception as exc:  # noqa: BLE001 — method error boundary
            self._fail_call(
                worker, call, RayTaskError.from_exception(call.name, exc))
            worker.task_events.record(task_id, "FAILED", name=call.name)
        finally:
            if flight._FLIGHT is not None:
                flight.note_task_finished()

    def _stream_call_outputs(self, worker, call: _MethodCall, result):
        """Generator method: commit one object per yield (the consumer's
        next() unblocks at once), pausing at the backpressure budget; a
        closed consumer generator cancels the loop between yields."""
        task_id = call.return_ids[0].task_id()
        stream = worker.streams.get_or_create(task_id)
        ctx = worker.serialization_context
        idx = 0
        it = iter(result)
        try:
            for item in it:
                if call.cancelled or stream.cancelled:
                    raise TaskCancelledError(task_id)
                worker.store.put(stream_item_id(task_id, idx),
                                 ctx.serialize(item))
                stream.commit(idx)
                idx += 1
                if not stream.wait_capacity(call.backpressure):
                    raise TaskCancelledError(task_id)
        except BaseException as exc:
            close = getattr(it, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 — generator cleanup
                    pass
            stream.set_error(exc)
            raise
        worker.store.put(stream_end_id(task_id), ctx.serialize(idx))
        stream.finish(idx)

    async def _execute_call_async(self, worker, call: _MethodCall):
        if call.cancelled:
            self._fail_call(worker, call, TaskCancelledError())
            return
        # Many coroutines share this thread, so no task-stuck mark here.
        task_id = call.return_ids[0].task_id()
        worker.task_events.record(task_id, "RUNNING", name=call.name)
        try:
            method = getattr(self.instance, call.method_name)
            args, kwargs = _resolve_actor_args(worker, call)
            result = method(*args, **kwargs)
            if inspect.iscoroutine(result):
                result = await result
            if call.streaming:
                if hasattr(result, "__anext__"):
                    await self._stream_call_outputs_async(
                        worker, call, result)
                else:
                    # Sync generator from an async actor: iterate on the
                    # loop's executor so coroutines stay responsive.
                    loop = asyncio.get_running_loop()
                    await loop.run_in_executor(
                        None, self._stream_call_outputs, worker, call,
                        result)
            else:
                self._store_outputs(worker, call, result)
            worker.task_events.record(task_id, "FINISHED", name=call.name)
        except Exception as exc:  # noqa: BLE001 — method error boundary
            self._fail_call(
                worker, call, RayTaskError.from_exception(call.name, exc))
            worker.task_events.record(task_id, "FAILED", name=call.name)

    async def _stream_call_outputs_async(self, worker, call: _MethodCall,
                                         agen):
        """Async-generator flavor: pause points poll the stream state
        without blocking the actor's event loop."""
        task_id = call.return_ids[0].task_id()
        stream = worker.streams.get_or_create(task_id)
        ctx = worker.serialization_context
        idx = 0
        try:
            async for item in agen:
                if call.cancelled or stream.cancelled:
                    raise TaskCancelledError(task_id)
                worker.store.put(stream_item_id(task_id, idx),
                                 ctx.serialize(item))
                stream.commit(idx)
                idx += 1
                while call.backpressure and not stream.cancelled and \
                        stream.committed - stream.consumed >= \
                        call.backpressure:
                    await asyncio.sleep(0.01)
        except BaseException as exc:
            stream.set_error(exc)
            raise
        worker.store.put(stream_end_id(task_id), ctx.serialize(idx))
        stream.finish(idx)

    def _store_outputs(self, worker, call: _MethodCall, result):
        ctx = worker.serialization_context
        if len(call.return_ids) == 1:
            outputs = [result]
        else:
            outputs = list(result)
            if len(outputs) != len(call.return_ids):
                raise ValueError(
                    f"method {call.name!r} declared num_returns="
                    f"{len(call.return_ids)} but returned {len(outputs)} "
                    f"values")
        for oid, value in zip(call.return_ids, outputs):
            worker.store.put(oid, ctx.serialize(value))

    def _fail_call(self, worker, call: _MethodCall, error: BaseException):
        for oid in call.return_ids:
            worker.store.put_error(oid, error)

    def _drain_with_error(self, mailbox):
        worker = global_worker()
        err = ActorDiedError(self.actor_id, self.death_cause or "actor died")
        while True:
            try:
                call = mailbox.get(timeout=0.5)
            except queue.Empty:
                if self.dead:
                    return
                continue
            if call is _TERMINATE:
                return
            if isinstance(call, _ClosureCall):
                continue  # a compiled-DAG loop: its compile-time check reports
            self._fail_call(worker, call, err)

    # ------------------------------------------------------------ submission
    def _next_task_id(self) -> TaskID:
        with self._lock:
            self._seq_counter += 1
            return TaskID.for_actor_task(self.actor_id, self._seq_counter)

    def submit(self, method_name: str, args, kwargs, num_returns: int,
               name: str):
        task_id = self._next_task_id()
        return_ids = [
            ObjectID.for_task_return(task_id, i)
            for i in range(max(num_returns, 1))
        ]
        worker = global_worker()
        refs = [ObjectRef(oid) for oid in return_ids]
        if worker.head_client is not None:
            for oid in return_ids:
                worker.store.mark_local_producer(oid)
        self._enqueue(worker, _MethodCall(method_name, args, kwargs,
                                          return_ids, name))
        return refs

    def submit_prepared(self, method_name: str, args, kwargs, return_ids,
                        name: str):
        """Submit with return ids the caller minted (the node plane's
        actor host: the remote driver allocated them)."""
        worker = global_worker()
        for oid in return_ids:
            worker.store.mark_local_producer(oid)
        refs = [ObjectRef(oid) for oid in return_ids]
        self._enqueue(worker, _MethodCall(method_name, args, kwargs,
                                          return_ids, name))
        return refs

    def submit_stream(self, method_name: str, args, kwargs, name: str):
        """Submit a generator method (num_returns="streaming"): returns an
        ObjectRefGenerator whose item refs materialize per yield."""
        worker = global_worker()
        task_id = self._next_task_id()
        end_id = stream_end_id(task_id)
        if worker.head_client is not None:
            worker.store.mark_local_producer(end_id)
        gen = ObjectRefGenerator(task_id, worker)
        self._enqueue(worker, _MethodCall(
            method_name, args, kwargs, [end_id], name,
            streaming=True,
            backpressure=GlobalConfig.generator_backpressure_items))
        return gen

    def submit_exec_loop(self, fn):
        """Enqueue a long-running closure (a compiled DAG's exec loop):
        it runs on the actor's loop thread with the instance and occupies
        the actor until it returns (at teardown)."""
        with self._lock:
            self._mailbox.put(_ClosureCall(fn))

    def start_dag_loop(self, desc_bytes: bytes, teardown_event):
        """Ship a compiled DAG's stage schedule into this actor's worker
        process (the worker's ``dag_exec``): its stages run there over
        the native shm channels and the driver never touches the
        payloads between them. The closure holds the actor's mailbox
        until the DAG tears down, as on the channel plane."""
        from ray_tpu_torch._private.worker_pool import maybe_stage

        worker = global_worker()

        def run(_instance):
            staged: list = []
            try:
                limit = max(self._proc.max_msg // 4, 64 * 1024)
                field, staged = maybe_stage(
                    worker.shm_store, desc_bytes, limit)
                # Blocks until the worker's loop exits (its channels
                # closed at teardown).
                self._proc.request(("dag_exec", field))
            except Exception as exc:  # noqa: BLE001 — crash boundary
                # The worker never ran its stages: the DAG's next read
                # times out, and this names the cause.
                self._dag_loop_error = exc
                if not teardown_event.is_set():
                    log.error("compiled-DAG loop of actor %r failed to "
                              "start: %r", self.class_name, exc)
            finally:
                for key in staged:
                    try:
                        worker.shm_store.delete(key)
                    except Exception:  # noqa: BLE001
                        pass

        self.submit_exec_loop(run)

    def _enqueue(self, worker, call: _MethodCall):
        task_id = call.return_ids[0].task_id()
        with self._lock:
            if not self.dead:
                if tracing._TRACER is not None:
                    # The caller's ambient context -> this call's queue
                    # and exec spans, through the task-event bridge.
                    tracing.register_task(task_id.binary(),
                                          tracing.inject())
                worker.task_events.record(task_id, "PENDING_ACTOR_TASK",
                                          name=call.name)
                self._mailbox.put(call)
                return
        err = ActorDiedError(self.actor_id,
                             self.death_cause or "actor is dead")
        self._fail_call(worker, call, err)

    # ------------------------------------------------------------- lifecycle
    def terminate(self, no_restart: bool = True):
        if self.dead and no_restart:
            # A process-backed loop outlives its actor's death (it fails
            # later calls): end it too.
            self._mailbox.put(_TERMINATE)
            return
        with self._lock:
            if not no_restart and self.restarts_used < self.max_restarts:
                self.restarts_used += 1
                if self.use_process:
                    # Kill the worker (interrupting a call in flight); the
                    # loop spawns a fresh process before the next call.
                    self._restart_pending = True
                    if self._proc is not None:
                        self._proc.kill()
                    return
                # Fresh mailbox for the restarted loop; the old loop drains
                # its own mailbox and exits on the _TERMINATE sentinel.
                old_mailbox = self._mailbox
                self._mailbox = queue.Queue()
                old_mailbox.put(_TERMINATE)
                self._start_loop()  # fresh state
                return
            self.dead = True
            self.death_cause = "killed via ray_tpu_torch.kill()"
            if self.use_process and self._proc is not None:
                self._proc.kill()
            self._mailbox.put(_TERMINATE)
        # Release the cluster-wide name so it can be reused while this
        # driver lives.
        reg = self._registered_name
        if reg is not None:
            from ray_tpu_torch._private.worker import _try_global_worker

            w = _try_global_worker()
            if w is not None and w.head_client is not None:
                try:
                    w.head_client.actor_deregister(*reg)
                except Exception:  # noqa: BLE001 — head gone at teardown
                    pass

    def join(self, timeout=None):
        for t in list(self._threads):
            if t is not threading.current_thread():
                t.join(timeout)


class _ProcessActorProxy:
    """``runtime.instance`` of a process-backed actor: a method access
    gives a callable that calls into the actor's worker process
    synchronously (a compiled DAG's exec loop runs in the driver and
    calls its stages this way)."""

    __slots__ = ("_rt",)

    def __init__(self, runtime: "_ActorRuntime"):
        self._rt = runtime

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        rt = self._rt

        def _call(*args, **kwargs):
            return rt._proxy_apply(name, args, kwargs)

        _call.__name__ = name
        return _call


def _delete_keys(shm, keys):
    for key in keys:
        try:
            shm.delete(key)
        except Exception:  # noqa: BLE001 — already reclaimed
            pass


def _resolve_values(worker, args, kwargs):
    """Top-level ObjectRefs resolved to values (an actor's init
    arguments)."""

    def _resolve(v):
        if isinstance(v, ObjectRef):
            return worker.get_object(v)
        return v

    return (tuple(_resolve(a) for a in args),
            {k: _resolve(v) for k, v in kwargs.items()})


def _resolve_actor_args(worker, call: _MethodCall):
    def _resolve(v):
        if isinstance(v, ObjectRef):
            return worker.get_object(v)
        return v

    return (
        tuple(_resolve(a) for a in call.args),
        {k: _resolve(v) for k, v in call.kwargs.items()},
    )


class ActorMethod:
    def __init__(self, runtime: _ActorRuntime, method_name: str,
                 options: Dict[str, Any]):
        self._runtime = runtime
        self._method_name = method_name
        self._options = options

    def options(self, **opts) -> "ActorMethod":
        merged = dict(self._options)
        merged.update(opts)
        return ActorMethod(self._runtime, self._method_name, merged)

    def remote(self, *args, **kwargs):
        num_returns = self._options.get("num_returns", 1)
        name = self._options.get(
            "name",
            f"{self._runtime.class_name}.{self._method_name}")
        if num_returns == "streaming":
            return self._runtime.submit_stream(
                self._method_name, args, kwargs, name)
        refs = self._runtime.submit(
            self._method_name, args, kwargs, num_returns, name)
        if num_returns == 0:
            return None
        return refs[0] if num_returns == 1 else refs

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag.dag_node import ClassMethodNode

        return ClassMethodNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._method_name!r} cannot be called directly; "
            f"use .remote().")


class ActorHandle:
    def __init__(self, runtime: _ActorRuntime):
        self._runtime = runtime
        self._actor_id = runtime.actor_id

    @property
    def _ray_actor_id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, item: str):
        if item.startswith("_"):
            raise AttributeError(item)
        cls = self._runtime.cls
        if cls is None:
            # A borrowed cluster actor whose class does not unpickle here:
            # the hosting node validates the method.
            return ActorMethod(self._runtime, item, {})
        fn = getattr(cls, item, None)
        if fn is None:
            raise AttributeError(
                f"actor {self._runtime.class_name!r} has no method {item!r}")
        method_opts = getattr(fn, "__ray_tpu_method_options__", {})
        return ActorMethod(self._runtime, item, dict(method_opts))

    def __reduce__(self):
        return (_rebuild_handle, (self._actor_id,))

    def __repr__(self):
        return (f"ActorHandle({self._runtime.class_name}, "
                f"{self._actor_id.hex()[:12]}…)")


def _client_worker(worker):
    """``worker`` if it is a worker process's ClientWorker, else None."""
    from ray_tpu_torch._private.client_worker import ClientWorker

    return worker if isinstance(worker, ClientWorker) else None


def _rebuild_handle(actor_id: ActorID) -> ActorHandle:
    worker = global_worker()
    if _client_worker(worker) is not None:
        # The handle crossed into a worker process: its calls go back
        # through the driver's API service.
        from ray_tpu_torch._private.client_worker import ClientActorHandle

        return ClientActorHandle(actor_id)
    # A handle to a cluster-placed actor may have crossed onto this
    # runtime (pickled into a task pushed to another node): borrow it,
    # and its calls go direct to the hosting node.
    from ray_tpu_torch._private.remote_actor import resolve_or_borrow

    runtime = resolve_or_borrow(worker, actor_id)
    if runtime is None:
        raise RayActorError(actor_id, "actor not found in this runtime")
    return ActorHandle(runtime)


class ActorClass:
    def __init__(self, cls: type, options: Dict[str, Any]):
        self._cls = cls
        self._options = options

    def options(self, **opts) -> "ActorClass":
        merged = dict(self._options)
        merged.update(opts)
        return ActorClass(self._cls, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        """Create the actor. On a driver attached to a head, the router
        places it (``RemoteRouter.place_actor``): on a node daemon for a
        demand this process cannot meet, a ``NodeAffinitySchedulingStrategy``
        or ``"SPREAD"``, and always on a ``ray://`` thin client; its
        calls then go direct to that node. Otherwise it lives here, and
        its resource options reserve nothing, as actors in the
        reference's process do not. ``runtime="driver"`` keeps a local
        actor in the driver's process on the process plane."""
        worker = auto_init()
        if _client_worker(worker) is not None:
            # Inside a worker process: the driver owns every actor.
            from ray_tpu_torch._private.client_worker import (
                ClientActorHandle,
            )

            actor_id = worker.actor_create(self._cls, args, kwargs,
                                           self._options)
            return ClientActorHandle(actor_id, self._cls.__name__)
        opts = self._options
        actor_name = opts.get("name")
        namespace = opts.get("namespace", worker.namespace)
        if actor_name:
            existing = worker.named_actors.get((namespace, actor_name))
            if existing is not None and not existing._runtime.dead:
                if opts.get("get_if_exists"):
                    return existing
                raise ValueError(
                    f"actor name {actor_name!r} already taken in namespace "
                    f"{namespace!r}")
        actor_id = ActorID.of(
            worker.job_id, worker.current_task_id(),
            worker.actor_counter.next())
        if actor_name and worker.head_client is not None:
            # Reserve the cluster-wide name before building the runtime:
            # a refusal must not leave a live actor holding it locally.
            worker.head_client.actor_register(
                namespace, actor_name, actor_id.binary(),
                self._cls.__name__)
        max_restarts = opts.get("max_restarts")
        if max_restarts is None:
            max_restarts = GlobalConfig.actor_max_restarts
        try:
            # Cluster placement: the router decides whether this actor
            # lives here or on a node daemon.
            node = None
            if worker.remote_router is not None:
                node = worker.remote_router.place_actor(opts)
            if node is not None:
                from ray_tpu_torch._private.remote_actor import (
                    RemoteActorRuntime,
                )

                runtime = RemoteActorRuntime(
                    worker, actor_id, self._cls, args, kwargs,
                    node=node,
                    max_restarts=max_restarts,
                    max_concurrency=opts.get("max_concurrency"),
                    actor_name=actor_name,
                    opts=opts,
                    registered_name=(
                        (namespace, actor_name) if actor_name else None),
                )
            else:
                if (getattr(worker, "shm_store", None) is not None
                        and opts.get("num_gpus")
                        and opts.get("runtime") != "driver"):
                    from ray_tpu_torch._private.worker_pool import (
                        warn_no_card,
                    )

                    warn_no_card("actor", self._cls.__name__,
                                 opts["num_gpus"])
                runtime = _ActorRuntime(
                    actor_id, self._cls, args, kwargs,
                    max_concurrency=opts.get("max_concurrency"),
                    max_restarts=max_restarts,
                    name=self._cls.__name__,
                    actor_name=actor_name,
                    runtime_target=opts.get("runtime"),
                )
        except BaseException:
            if actor_name and worker.head_client is not None:
                # Release the reserved name, or retries fail "already
                # taken" for as long as this driver lives.
                try:
                    worker.head_client.actor_deregister(
                        namespace, actor_name)
                except Exception:  # noqa: BLE001
                    pass
            raise
        worker.actors[actor_id] = runtime
        handle = ActorHandle(runtime)
        if actor_name:
            worker.named_actors[(namespace, actor_name)] = handle
            runtime._registered_name = (namespace, actor_name)
        return handle

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag.dag_node import ClassNode

        return ClassNode(self, args, kwargs)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__!r} cannot be instantiated "
            f"directly; use {self._cls.__name__}.remote().")


def get_actor(name: str, namespace: Optional[str] = None) -> ActorHandle:
    worker = global_worker()
    if _client_worker(worker) is not None:
        from ray_tpu_torch._private.client_worker import ClientActorHandle

        return ClientActorHandle(worker.actor_named(name, namespace), name)
    ns = namespace or worker.namespace
    handle = worker.named_actors.get((ns, name))
    if handle is not None and not handle._runtime.dead:
        return handle
    if worker.head_client is not None:
        entry = worker.head_client.actor_lookup(ns, name)
        if entry is not None:
            owner_id, actor_bin, class_name = entry
            if owner_id != worker.head_client.client_id:
                # A cluster-placed actor is callable direct to its node
                # from any driver: prefer the placement directory to the
                # owner-driver relay.
                from ray_tpu_torch._private.remote_actor import (
                    resolve_or_borrow,
                )

                runtime = resolve_or_borrow(
                    worker, ActorID(bytes(actor_bin)))
                if runtime is not None:
                    return ActorHandle(runtime)
                return CrossDriverActorHandle(
                    owner_id, bytes(actor_bin), class_name)
    raise ValueError(
        f"no live actor named {name!r} in namespace {ns!r}")


class CrossDriverActorHandle:
    """Handle to a named actor owned by another driver attached to the
    same head. A method call relays through the head to the owning
    driver, which runs it on its runtime and announces the result; the
    result's wire bytes are then pulled back by id (peer to peer, or
    relayed by the head), so large results never ride the relay.
    Arguments cross in the wire form; an ObjectRef argument must be
    announced by its owner (the owning driver pulls it)."""

    def __init__(self, owner_id: str, actor_bin: bytes, class_name: str):
        self._owner_id = owner_id
        self._actor_bin = actor_bin
        self._class_name = class_name

    def __getattr__(self, item: str):
        if item.startswith("_"):
            raise AttributeError(item)
        return _CrossDriverMethod(self, item)

    def __repr__(self):
        return (f"CrossDriverActorHandle({self._class_name}, "
                f"owner={self._owner_id})")


class _CrossDriverMethod:
    def __init__(self, handle: CrossDriverActorHandle, method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs):
        worker = global_worker()
        h = self._handle
        oid = ObjectID.for_put(worker.current_task_id(),
                               worker.put_counter.next())
        ref = ObjectRef(oid)
        # The relay thread below produces it: never pulled from the head.
        worker.store.mark_local_producer(oid)

        def _run():
            try:
                oid_bins = worker.head_client.actor_call(
                    h._owner_id, h._actor_bin, self._method, args, kwargs,
                    1)
                raw = worker.head_client.object_pull(oid_bins[0])
                if raw is None:
                    raise ActorDiedError(
                        None, "cross-driver call result vanished before "
                        "it could be pulled (owner died?)")
                from ray_tpu_torch._private.serialization import (
                    SerializedObject,
                )

                worker.store.put(oid, SerializedObject.from_bytes(raw))
            except BaseException as exc:  # noqa: BLE001 — relay boundary
                worker.store.put_error(oid, exc)

        threading.Thread(target=_run, daemon=True,
                         name="ray_tpu_cross_driver_call").start()
        return ref


def kill(actor: ActorHandle, *, no_restart: bool = True):
    if not isinstance(actor, ActorHandle):
        raise TypeError(f"kill() expects an ActorHandle, got {type(actor)}")
    actor._runtime.terminate(no_restart=no_restart)
