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
which its calls fail with ``ActorDiedError``. Not ported: the process
plane (an actor in its own worker process) and handles to actors of
other processes.
"""

from __future__ import annotations

import asyncio
import inspect
import queue
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch._private.ids import ActorID, ObjectID, TaskID
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
)

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
                 name: str, actor_name: Optional[str]):
        self.actor_id = actor_id
        self.cls = cls
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.max_restarts = max_restarts
        self.restarts_used = 0
        self.class_name = name
        self.actor_name = actor_name
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
        self._start_loop()

    # ---------------------------------------------------------------- loops
    def _start_loop(self):
        self._instance_ready = threading.Event()
        self._init_error: Optional[BaseException] = None
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

    def _execute_call(self, worker, call: _MethodCall):
        if call.cancelled:
            self._fail_call(worker, call, TaskCancelledError())
            return
        try:
            method = getattr(self.instance, call.method_name)
            args, kwargs = _resolve_actor_args(worker, call)
            result = method(*args, **kwargs)
            if call.streaming:
                self._stream_call_outputs(worker, call, result)
            else:
                self._store_outputs(worker, call, result)
        except Exception as exc:  # noqa: BLE001 — method error boundary
            self._fail_call(
                worker, call, RayTaskError.from_exception(call.name, exc))

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
                return
            self._store_outputs(worker, call, result)
        except Exception as exc:  # noqa: BLE001 — method error boundary
            self._fail_call(
                worker, call, RayTaskError.from_exception(call.name, exc))

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
        self._enqueue(worker, _MethodCall(method_name, args, kwargs,
                                          return_ids, name))
        return refs

    def submit_stream(self, method_name: str, args, kwargs, name: str):
        """Submit a generator method (num_returns="streaming"): returns an
        ObjectRefGenerator whose item refs materialize per yield."""
        worker = global_worker()
        task_id = self._next_task_id()
        gen = ObjectRefGenerator(task_id, worker)
        self._enqueue(worker, _MethodCall(
            method_name, args, kwargs, [stream_end_id(task_id)], name,
            streaming=True,
            backpressure=GlobalConfig.generator_backpressure_items))
        return gen

    def submit_exec_loop(self, fn):
        """Enqueue a long-running closure (a compiled DAG's exec loop):
        it runs on the actor's loop thread with the instance and occupies
        the actor until it returns (at teardown)."""
        with self._lock:
            self._mailbox.put(_ClosureCall(fn))

    def _enqueue(self, worker, call: _MethodCall):
        with self._lock:
            if not self.dead:
                self._mailbox.put(call)
                return
        err = ActorDiedError(self.actor_id,
                             self.death_cause or "actor is dead")
        self._fail_call(worker, call, err)

    # ------------------------------------------------------------- lifecycle
    def terminate(self, no_restart: bool = True):
        if self.dead and no_restart:
            return
        with self._lock:
            if not no_restart and self.restarts_used < self.max_restarts:
                self.restarts_used += 1
                # Fresh mailbox for the restarted loop; the old loop drains
                # its own mailbox and exits on the _TERMINATE sentinel.
                old_mailbox = self._mailbox
                self._mailbox = queue.Queue()
                old_mailbox.put(_TERMINATE)
                self._start_loop()  # fresh state
                return
            self.dead = True
            self.death_cause = "killed via ray_tpu_torch.kill()"
            self._mailbox.put(_TERMINATE)

    def join(self, timeout=None):
        for t in list(self._threads):
            if t is not threading.current_thread():
                t.join(timeout)


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
        fn = getattr(self._runtime.cls, item, None)
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


def _rebuild_handle(actor_id: ActorID) -> ActorHandle:
    runtime = global_worker().actors.get(actor_id)
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
        """Create the actor. Resource options (``num_cpus``,
        ``num_gpus``, ``resources``) and ``scheduling_strategy`` are
        accepted and reserve nothing, as actors in the reference's
        process do not; ``lifetime`` is accepted too."""
        worker = auto_init()
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
        max_restarts = opts.get("max_restarts")
        if max_restarts is None:
            max_restarts = GlobalConfig.actor_max_restarts
        runtime = _ActorRuntime(
            actor_id, self._cls, args, kwargs,
            max_concurrency=opts.get("max_concurrency"),
            max_restarts=max_restarts,
            name=self._cls.__name__,
            actor_name=actor_name,
        )
        worker.actors[actor_id] = runtime
        handle = ActorHandle(runtime)
        if actor_name:
            worker.named_actors[(namespace, actor_name)] = handle
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
    ns = namespace or worker.namespace
    handle = worker.named_actors.get((ns, name))
    if handle is not None and not handle._runtime.dead:
        return handle
    raise ValueError(
        f"no live actor named {name!r} in namespace {ns!r}")


def kill(actor: ActorHandle, *, no_restart: bool = True):
    if not isinstance(actor, ActorHandle):
        raise TypeError(f"kill() expects an ActorHandle, got {type(actor)}")
    actor._runtime.terminate(no_restart=no_restart)
