"""Worker process entrypoint: the leased worker's execution loop
(counterpart of ``ray_tpu/_private/worker_main.py``).

The driver's ``WorkerPool`` spawns this module per worker
(``python -m ray_tpu_torch._private.worker_main``: fork and exec, never a
fork of the driver, which may own a CUDA context). Requests arrive over
a shared-memory mutable-object channel, argument and result payloads
ride the native shm store in the wire form
(``serialization.wire_dumps``), and replies go back on a second channel.
A ``kill -9`` of this process is seen by the driver through process
liveness and surfaces as ``WorkerCrashedError``, never as a driver crash.

The worker never reaches the card: the pool spawns it with
``CUDA_VISIBLE_DEVICES=""``, so ``torch.cuda.is_available()`` is False in
every task and process-backed actor, whatever it requested, as the
reference forces ``JAX_PLATFORMS=cpu`` into its workers. Card work stays
in the driver or in an actor created with ``runtime="driver"``.

Branches: a task, a process-backed actor (sync; or async and threaded
ones on the multiplexed submit/calldone protocol), and streaming yields
for each; and the compiled DAG's ``dag_exec`` loop, which runs a
process-backed actor's stages over the native shm channels. Tracing and
the flight recorder arm from the inherited environment and, since
nothing can dial a worker, spill to the hosting runtime's
``RAY_TPU_TRACE_DIR`` and ``RAY_TPU_FLIGHT_DIR``. A task's runtime env
(``env_vars``, ``working_dir``, ``py_modules``) is staged once per
distinct env in this process and applied around each call; a pip/uv env
is this process's interpreter, chosen by the pool at spawn.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import threading
import traceback
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import tracing
from ray_tpu_torch._private.serialization import wire_dumps, wire_loads


class _ShmRef:
    """Marker for an argument stored in the shm object store."""

    __slots__ = ("key",)

    def __init__(self, key: int):
        self.key = key

    def __reduce__(self):
        return (_ShmRef, (self.key,))


def _fetch_blob(store, field):
    """Inverse of worker_pool.maybe_stage: ('shm', key) markers resolve
    through the store (the driver deletes the key after the reply)."""
    if isinstance(field, tuple) and len(field) == 2 and field[0] == "shm":
        return bytes(store.get(field[1]))
    return field


def _load_payload(store, payload: bytes):
    """(args, kwargs) from the wire, fetching _ShmRef args from the
    store."""
    args, kwargs = wire_loads(payload)

    def _fetch(v):
        if isinstance(v, _ShmRef):
            return wire_loads(store.get(v.key))
        return v

    return (tuple(_fetch(a) for a in args),
            {k: _fetch(v) for k, v in kwargs.items()})


def _store_outputs(store, return_keys: List[int], result: Any,
                   num_returns: int):
    if num_returns <= 1:
        outputs = [result]
    else:
        outputs = list(result)
        if len(outputs) != num_returns:
            raise ValueError(
                f"task declared num_returns={num_returns} but returned "
                f"{len(outputs)} values")
    for key, value in zip(return_keys, outputs):
        store.put(key, wire_dumps(value))


def _run_dag_stages(store, desc: dict, actor_instance) -> None:
    """A compiled DAG's stage schedule for this worker's actor, run over
    the shm channels until teardown closes them. Never raises: a failure
    is logged to stderr and ends the loop (the caller replies exactly
    once on the request channel)."""
    from ray_tpu_torch.channels.channel import ShmBufferedChannel
    from ray_tpu_torch.dag.compiled_dag import _Stage
    from ray_tpu_torch.exceptions import ChannelError, ChannelTimeoutError

    try:
        chans = {cid: ShmBufferedChannel.attach(store, spec)
                 for cid, spec in desc["channels"].items()}
        stages = []
        for sd in desc["stages"]:
            sources = []
            for kind, a, b in sd["arg_sources"]:
                if kind == "const":
                    sources.append(("const", pickle.loads(a), None))
                else:
                    sources.append(("chan", chans[a], b))
            stages.append(_Stage(
                node=None, fn=None, arg_sources=sources,
                out_channel=chans[sd["out_channel"]],
                method_name=sd["method_name"]))
        while True:
            try:
                for stage in stages:
                    stage.run_once(actor_instance)
            except ChannelTimeoutError:
                if _orphaned():
                    return  # the driver died without a teardown
                continue  # a producer or consumer is slow: retry
            except ChannelError:
                return  # teardown closed the channels
    except BaseException:  # noqa: BLE001 — log, never propagate
        print("ray_tpu_torch compiled-DAG worker loop failed:\n"
              + traceback.format_exc(), file=sys.stderr, flush=True)


def _run_stream_yields(gen, max_msg: int, stage_result, emit, wait_acks):
    """Producer yield loop shared by every stream flavor (task_stream,
    actor_stream, mux actor items): put each yield in the wire form,
    ``emit`` it (small items inline in the frame, big ones staged in the
    shm store), then run the pause protocol: ``wait_acks(count)`` blocks
    while committed-but-unconsumed items are at the budget and returns
    False when the consumer cancelled. Returns ``(total, cancelled)``."""
    limit = max(max_msg // 4, 64 * 1024)
    if not hasattr(gen, "__iter__") and not hasattr(gen, "__next__"):
        raise TypeError(
            f"streaming task returned non-iterable {type(gen).__name__}")
    it = iter(gen)
    idx = 0
    try:
        for item in it:
            raw = wire_dumps(item)
            field = ("shm", stage_result(raw)) if len(raw) > limit else raw
            emit(idx, field)
            idx += 1
            if not wait_acks(idx):
                return idx, True
    except BaseException:
        close = getattr(it, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001 — generator cleanup
                pass
        raise
    return idx, False


def worker_loop(store_name: str, req_id: int, rep_id: int,
                worker_id: int, max_msg: int,
                api_req_id: int = 0, api_rep_id: int = 0,
                ack_id: int = 0) -> None:
    import cloudpickle

    from ray_tpu_torch._native.store import (
        NativeMutableChannel,
        NativeObjectStore,
    )
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch._private.ids import TaskID
    from ray_tpu_torch.exceptions import (
        ChannelError,
        ChannelTimeoutError,
        RayTaskError,
    )

    store = NativeObjectStore.open(store_name)
    req = NativeMutableChannel(store, req_id, max_size=max_msg,
                               num_readers=1, create=False)
    rep = NativeMutableChannel(store, rep_id, max_size=max_msg,
                               num_readers=1, create=False)
    ack = None
    if ack_id:
        # Streaming backpressure acks (driver -> this worker); read only
        # at a stream's pause points, so it never interleaves with the
        # request protocol.
        ack = NativeMutableChannel(store, ack_id, max_size=8192,
                                   num_readers=1, create=False)

    # The client runtime: ray_tpu_torch.* calls made inside task or actor
    # code forward to the driver instead of booting a second runtime.
    if api_req_id and api_rep_id:
        from ray_tpu_torch._private.client_worker import ClientWorker

        api_req = NativeMutableChannel(store, api_req_id, max_size=max_msg,
                                       num_readers=1, create=False)
        api_rep = NativeMutableChannel(store, api_rep_id, max_size=max_msg,
                                       num_readers=1, create=False)
        worker_mod._global_worker = ClientWorker(
            store, api_req, api_rep, worker_id)

    fn_cache: Dict[bytes, Any] = {}
    actor_instance: Optional[Any] = None
    actor_state: Dict[str, Any] = {}   # the concurrency plane of actor_new2
    rep_lock = threading.Lock()
    stage_counter = [0]
    stage_lock = threading.Lock()   # concurrent actor calls stage too

    def _reply(msg):
        with rep_lock:
            rep.write(msg)

    def _stage_result(raw: bytes) -> int:
        with stage_lock:
            stage_counter[0] += 1
            n = stage_counter[0]
        key = (0xA4D0_0000_0000_0000
               | (os.getpid() & 0xFFFFFF) << 24
               | (n & 0xFF_FFFF))
        store.put(key, raw)
        return key

    def _set_task_ctx(task_id_bin, name):
        worker_mod._task_context.current_task_id = (
            TaskID(task_id_bin) if task_id_bin else None)
        worker_mod._task_context.task_name = name

    def _finish_actor_call(call_id, result, return_keys, num_returns):
        if return_keys:
            _store_outputs(store, return_keys, result, num_returns)
            _reply(("calldone", call_id, "ok", None))
        else:
            raw = wire_dumps(result)
            if len(raw) > max(max_msg // 4, 64 * 1024):
                _reply(("calldone", call_id, "okshm", _stage_result(raw)))
            else:
                _reply(("calldone", call_id, "okv", raw))

    def _error_bytes(name, exc) -> bytes:
        try:
            return pickle.dumps(RayTaskError.from_exception(str(name), exc))
        except Exception:  # noqa: BLE001 — unpicklable cause
            return pickle.dumps(RayTaskError(
                str(name), traceback.format_exc(), cause=None))

    def _fail_actor_call(call_id, name, exc):
        _reply(("calldone", call_id, "err", _error_bytes(name, exc)))

    # ------------------------------------------------- streaming producers
    # Mux actors get acks as ("stream_ack", tid_bin, n) REQUESTS on the
    # req channel (the main loop drains it continuously); the single-flight
    # planes (task_stream, actor_stream) read the dedicated ack channel at
    # their pause points.
    stream_acks: Dict[bytes, int] = {}
    stream_cancels: set = set()
    stream_ack_cv = threading.Condition()

    def _ack_chan_waiter(tid_bin: bytes, budget: int):
        """wait_acks over the dedicated ack channel: drain between
        yields, block at the budget. Stale acks of an earlier stream on
        this worker are read and ignored (tagged by task id)."""
        acked = [0]
        cancelled = [False]

        def _drain(timeout: float) -> bool:
            if ack is None:
                return False
            try:
                m = ack.read(timeout=timeout)
            except ChannelTimeoutError:
                return False
            except ChannelError:
                cancelled[0] = True   # the driver tore the channel down
                return False
            if m and m[0] == "stream_ack" and bytes(m[1]) == tid_bin:
                n = m[2]
                if n < 0:
                    cancelled[0] = True
                elif n > acked[0]:
                    acked[0] = n
            return True

        def wait_acks(count: int) -> bool:
            while _drain(0.001):
                pass
            while budget and count - acked[0] >= budget \
                    and not cancelled[0]:
                if not _drain(0.2) and _orphaned():
                    cancelled[0] = True
            return not cancelled[0]

        return wait_acks

    def _mux_ack_waiter(tid_bin: bytes, budget: int):
        """wait_acks over the ack table the main loop keeps (mux actors:
        many streams share one worker process)."""
        key = bytes(tid_bin)

        def wait_acks(count: int) -> bool:
            with stream_ack_cv:
                while True:
                    if key in stream_cancels:
                        return False
                    if not budget or \
                            count - stream_acks.get(key, 0) < budget:
                        return True
                    stream_ack_cv.wait(0.2)
                    if _orphaned():
                        return False

        return wait_acks

    def _mux_stream_done(tid_bin: bytes):
        key = bytes(tid_bin)
        with stream_ack_cv:
            stream_acks.pop(key, None)
            stream_cancels.discard(key)

    def _stream_actor_result(call_id, result, budget, wait_acks):
        """One actor call's generator result as mux item frames."""
        total, cancelled = _run_stream_yields(
            result, max_msg, _stage_result,
            lambda i, f: _reply(("calldone", call_id, "item", (i, f))),
            wait_acks)
        _reply(("calldone", call_id,
                "cancelled" if cancelled else "ok_stream", total))

    def _run_actor_call_sync(call_id, method_name, payload, return_keys,
                             num_returns, task_id_bin, name,
                             stream_budget=None):
        try:
            method = getattr(actor_instance, method_name)
            args, kwargs = _load_payload(store, _fetch_blob(store, payload))
            _set_task_ctx(task_id_bin, name)
            try:
                result = method(*args, **kwargs)
                if stream_budget is not None:
                    _stream_actor_result(
                        call_id, result, stream_budget,
                        _mux_ack_waiter(task_id_bin, stream_budget))
                    return
            finally:
                _set_task_ctx(None, None)
                if stream_budget is not None:
                    _mux_stream_done(task_id_bin)
            _finish_actor_call(call_id, result, return_keys, num_returns)
        except BaseException as exc:  # noqa: BLE001 — call error boundary
            _fail_actor_call(call_id, name, exc)

    async def _stream_actor_result_async(call_id, agen, task_id_bin,
                                         budget):
        """Async-generator flavor of the mux item stream: its pause
        points poll the ack table without blocking the event loop."""
        import asyncio

        limit = max(max_msg // 4, 64 * 1024)
        key = bytes(task_id_bin)
        idx = 0
        cancelled = False
        async for item in agen:
            raw = wire_dumps(item)
            field = ("shm", _stage_result(raw)) if len(raw) > limit \
                else raw
            _reply(("calldone", call_id, "item", (idx, field)))
            idx += 1
            while True:
                with stream_ack_cv:
                    if key in stream_cancels:
                        cancelled = True
                        break
                    if not budget or \
                            idx - stream_acks.get(key, 0) < budget:
                        break
                await asyncio.sleep(0.02)
            if cancelled:
                break
        _reply(("calldone", call_id,
                "cancelled" if cancelled else "ok_stream", idx))

    async def _run_actor_call_async(call_id, method_name, payload,
                                    return_keys, num_returns, task_id_bin,
                                    name, stream_budget=None):
        import asyncio
        import inspect

        try:
            method = getattr(actor_instance, method_name)
            args, kwargs = _load_payload(store, _fetch_blob(store, payload))
            _set_task_ctx(task_id_bin, name)
            try:
                result = method(*args, **kwargs)
                if inspect.iscoroutine(result):
                    result = await result
                if stream_budget is not None:
                    if hasattr(result, "__anext__"):
                        await _stream_actor_result_async(
                            call_id, result, task_id_bin, stream_budget)
                    else:
                        # A sync generator from an async actor: iterate on
                        # the executor so the event loop stays live.
                        await asyncio.get_running_loop().run_in_executor(
                            None, _stream_actor_result, call_id, result,
                            stream_budget,
                            _mux_ack_waiter(task_id_bin, stream_budget))
                    return
            finally:
                _set_task_ctx(None, None)
                if stream_budget is not None:
                    _mux_stream_done(task_id_bin)
            _finish_actor_call(call_id, result, return_keys, num_returns)
        except BaseException as exc:  # noqa: BLE001 — call error boundary
            _fail_actor_call(call_id, name, exc)

    def _load_fn(digest, fn_bytes):
        fn = fn_cache.get(digest)
        if fn is None:
            fn = cloudpickle.loads(_fetch_blob(store, fn_bytes))
            fn_cache[digest] = fn
        return fn

    def _new_actor(cls_bytes, payload):
        cls = cloudpickle.loads(_fetch_blob(store, cls_bytes))
        args, kwargs = _load_payload(store, _fetch_blob(store, payload))
        return cls(*args, **kwargs)

    while True:
        try:
            msg = req.read(timeout=5.0)
        except ChannelTimeoutError:
            if _orphaned():   # the driver died: exit
                return
            continue
        except ChannelError:
            return

        kind = msg[0]
        try:
            if kind == "exit":
                _reply(("ok", None))
                return
            elif kind == "ping":
                _reply(("ok", os.getpid()))
            elif kind == "task":
                (_, digest, fn_bytes, payload, return_keys, num_returns,
                 task_id_bin, name, env_fields) = msg[:9]
                trace_wire = msg[9] if len(msg) > 9 else None
                fn = _load_fn(digest, fn_bytes)
                args, kwargs = _load_payload(store,
                                             _fetch_blob(store, payload))
                _set_task_ctx(task_id_bin, name)
                span = tracing.begin(
                    "worker.exec", parent=tracing.extract(trace_wire),
                    task=name) if trace_wire is not None else None
                try:
                    if env_fields:
                        with _cached_runtime_env(env_fields).applied():
                            result = fn(*args, **kwargs)
                    else:
                        result = fn(*args, **kwargs)
                except BaseException:
                    tracing.finish(span, status="error")
                    span = None
                    raise
                finally:
                    tracing.finish(span)
                    _set_task_ctx(None, None)
                _store_outputs(store, return_keys, result, num_returns)
                _reply(("ok", None))
            elif kind == "actor_new":
                _, cls_bytes, payload = msg
                actor_instance = _new_actor(cls_bytes, payload)
                _reply(("ok", None))
            elif kind == "dag_exec":
                # The compiled DAG's shm plane: run this actor's stages
                # here until teardown; the one reply releases the
                # driver's closure, whatever happened.
                try:
                    desc = pickle.loads(_fetch_blob(store, msg[1]))
                    _run_dag_stages(store, desc, actor_instance)
                except BaseException:  # noqa: BLE001 — the outer boundary
                    # would send a second reply and desync the channel.
                    print("ray_tpu_torch dag_exec setup failed:\n"
                          + traceback.format_exc(), file=sys.stderr,
                          flush=True)
                finally:
                    _reply(("ok", None))
            elif kind == "actor_new2":
                # Concurrent actor plane: an async actor gets an asyncio
                # loop thread, a threaded one a pool; calls arrive as
                # fire-and-forget "actor_submit" and complete out of order
                # as ("calldone", call_id, ...) on the reply channel.
                _, cls_bytes, payload, mode, max_concurrency = msg
                actor_instance = _new_actor(cls_bytes, payload)
                actor_state["mode"] = mode
                if mode == "async":
                    import asyncio

                    loop = asyncio.new_event_loop()

                    def _loop_main():
                        asyncio.set_event_loop(loop)
                        loop.run_forever()

                    threading.Thread(target=_loop_main, daemon=True,
                                     name="actor-async-loop").start()
                    actor_state["loop"] = loop
                    actor_state["sem"] = asyncio.Semaphore(
                        max(int(max_concurrency), 1))
                else:
                    from concurrent.futures import ThreadPoolExecutor

                    actor_state["pool"] = ThreadPoolExecutor(
                        max_workers=max(int(max_concurrency), 1),
                        thread_name_prefix="actor-call")
                _reply(("ok", None))
            elif kind == "actor_submit":
                (_, call_id, method_name, payload, return_keys,
                 num_returns, task_id_bin, name, stream_budget) = msg
                if actor_instance is None:
                    _fail_actor_call(call_id, name, RuntimeError(
                        "actor_submit before actor_new2"))
                elif actor_state.get("mode") == "async":
                    import asyncio

                    sem = actor_state["sem"]

                    async def _gated(call_id=call_id,
                                     method_name=method_name,
                                     payload=payload,
                                     return_keys=return_keys,
                                     num_returns=num_returns,
                                     task_id_bin=task_id_bin, name=name,
                                     stream_budget=stream_budget):
                        async with sem:
                            await _run_actor_call_async(
                                call_id, method_name, payload, return_keys,
                                num_returns, task_id_bin, name,
                                stream_budget)

                    asyncio.run_coroutine_threadsafe(_gated(),
                                                     actor_state["loop"])
                else:
                    actor_state["pool"].submit(
                        _run_actor_call_sync, call_id, method_name,
                        payload, return_keys, num_returns, task_id_bin,
                        name, stream_budget)
            elif kind == "stream_ack":
                # Mux-actor backpressure: a consumption watermark (n >= 0)
                # or a cancel (n < 0) for one stream. No reply.
                _, tid_bin, n = msg
                key = bytes(tid_bin)
                with stream_ack_cv:
                    if n < 0:
                        stream_cancels.add(key)
                    elif n > stream_acks.get(key, 0):
                        stream_acks[key] = n
                    stream_ack_cv.notify_all()
            elif kind == "task_stream":
                (_, digest, fn_bytes, payload, task_id_bin, name,
                 env_fields, budget) = msg
                fn = _load_fn(digest, fn_bytes)
                args, kwargs = _load_payload(store,
                                             _fetch_blob(store, payload))
                _set_task_ctx(task_id_bin, name)
                try:
                    def _go():
                        total, was_cancelled = _run_stream_yields(
                            fn(*args, **kwargs), max_msg, _stage_result,
                            lambda i, f: _reply(("item", i, f)),
                            _ack_chan_waiter(bytes(task_id_bin), budget))
                        _reply(("cancelled",) if was_cancelled
                               else ("ok", total))

                    # The generator's body runs inside the env.
                    if env_fields:
                        with _cached_runtime_env(env_fields).applied():
                            _go()
                    else:
                        _go()
                finally:
                    _set_task_ctx(None, None)
            elif kind == "actor_stream":
                # A generator method of a sync process actor: the wire
                # shape of task_stream, the generator from the instance.
                (_, method_name, payload, task_id_bin, name, budget) = msg
                if actor_instance is None:
                    raise RuntimeError("actor_stream before actor_new")
                method = getattr(actor_instance, method_name)
                args, kwargs = _load_payload(store,
                                             _fetch_blob(store, payload))
                _set_task_ctx(task_id_bin, name)
                try:
                    total, was_cancelled = _run_stream_yields(
                        method(*args, **kwargs), max_msg, _stage_result,
                        lambda i, f: _reply(("item", i, f)),
                        _ack_chan_waiter(bytes(task_id_bin), budget))
                    _reply(("cancelled",) if was_cancelled
                           else ("ok", total))
                finally:
                    _set_task_ctx(None, None)
            elif kind == "actor_call":
                (_, method_name, payload, return_keys, num_returns,
                 task_id_bin, name) = msg
                if actor_instance is None:
                    raise RuntimeError("actor_call before actor_new")
                method = getattr(actor_instance, method_name)
                args, kwargs = _load_payload(store,
                                             _fetch_blob(store, payload))
                _set_task_ctx(task_id_bin, name)
                try:
                    result = method(*args, **kwargs)
                finally:
                    _set_task_ctx(None, None)
                if return_keys:
                    _store_outputs(store, return_keys, result, num_returns)
                    _reply(("ok", None))
                else:
                    # Proxy apply: the result rides the reply; a big one
                    # is staged through the store.
                    raw = wire_dumps(result)
                    if len(raw) > max(max_msg // 4, 64 * 1024):
                        _reply(("okshm", _stage_result(raw)))
                    else:
                        _reply(("ok", raw))
            else:
                raise ValueError(f"unknown request kind {kind!r}")
        except BaseException as exc:  # noqa: BLE001 — worker error boundary
            if kind in ("actor_call", "actor_stream"):
                name = msg[1]
            elif kind == "task_stream":
                name = msg[5]
            elif kind == "task":
                name = msg[7]
            else:
                name = "task"
            _reply(("err", _error_bytes(name, exc)))


_renv_cache: Dict[bytes, Any] = {}


def _cached_runtime_env(env_fields):
    """One staged RuntimeEnv per distinct env per worker process: staging
    copies working_dir into a tempdir, which must not repeat (or leak)
    per task. A pip/uv env's interpreter is this process's own (the pool
    spawned it under the venv), so only its other fields apply here."""
    from ray_tpu_torch.runtime_env import RuntimeEnv

    fields = {k: v for k, v in env_fields.items()
              if k in ("env_vars", "working_dir", "py_modules", "pip")}
    key = pickle.dumps(sorted(fields.items()))
    renv = _renv_cache.get(key)
    if renv is None:
        renv = RuntimeEnv(**fields).stage()
        _renv_cache[key] = renv
    return renv


def _orphaned() -> bool:
    """Whether the spawning driver is gone (this process was reparented)."""
    spawner = os.environ.get("RAY_TPU_TORCH_PARENT_PID")
    if spawner:
        return os.getppid() != int(spawner)
    return os.getppid() == 1


def _install_pdeathsig() -> None:
    """Orphan fence (Linux): a worker must never outlive the process that
    owns its shm store. The kernel delivers SIGKILL on the parent's death
    (PR_SET_PDEATHSIG), installed by the child itself so the spawn path
    needs no fork-unsafe preexec_fn. The race of a parent that died
    before the prctl landed is closed by comparing getppid() with the
    spawner's pid handed down in RAY_TPU_TORCH_PARENT_PID, never with pid
    1, which is the legitimate parent when the driver is a container's
    PID 1. A no-op off Linux."""
    if not sys.platform.startswith("linux"):
        return
    try:
        import ctypes
        import signal

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        pr_set_pdeathsig = 1
        libc.prctl(pr_set_pdeathsig, int(signal.SIGKILL), 0, 0, 0)
        spawner = os.environ.get("RAY_TPU_TORCH_PARENT_PID")
        if spawner and os.getppid() != int(spawner):
            # Reparented before the prctl landed: the spawner is gone
            # and the death signal will never fire.
            os.kill(os.getpid(), signal.SIGKILL)
    except Exception:  # noqa: BLE001 — the fence is best-effort hardening
        pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--store", required=True)
    ap.add_argument("--req-id", type=int, required=True)
    ap.add_argument("--rep-id", type=int, required=True)
    ap.add_argument("--api-req-id", type=int, default=0)
    ap.add_argument("--api-rep-id", type=int, default=0)
    ap.add_argument("--ack-id", type=int, default=0)
    ap.add_argument("--worker-id", type=int, default=0)
    ap.add_argument("--max-msg", type=int, default=1 << 20)
    args = ap.parse_args(argv)
    _install_pdeathsig()
    from ray_tpu_torch._private import flight

    tracing.install_from_env(component="worker", spill=True)
    flight.install_from_env(component="worker", spill=True)
    worker_loop(args.store, args.req_id, args.rep_id, args.worker_id,
                args.max_msg, args.api_req_id, args.api_rep_id,
                args.ack_id)
    return 0


if __name__ == "__main__":
    # Re-dispatch through the canonical import so _ShmRef has one class
    # identity (under -m this module is __main__, which would break
    # isinstance against markers the driver pickled).
    from ray_tpu_torch._private import worker_main as _canonical

    sys.exit(_canonical.main())
