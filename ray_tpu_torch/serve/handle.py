"""DeploymentHandle / DeploymentResponse (counterpart of
``ray_tpu/serve/handle.py``): composable handles whose responses chain,
and streaming responses over the streaming task plane.

With tracing armed, ``remote`` is one ``serve.request`` span (routing,
wake and submission) under the caller's ambient context, and an LLM
deployment's request dict carries that span's context as ``_trace``.
Where a replica's runtime has no streaming plane, a streaming response
falls back to polling the KV (``_KVStreamFallbackGenerator`` over the
replica's ``handle_stream``), with the cancel handshake that sweeps the
stream's keys. A handle pickled into another process (a task on a
node daemon, a replica's constructor) routes there over a snapshot of
the deployment's replica handles (``_DetachedRouter``), which resolve
as cluster actors through the placement directory.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import ray_tpu_torch
from ray_tpu_torch._private import tracing


class DeploymentResponse:
    """Future for one routed request; passing it as an argument to another
    handle call chains without blocking (resolved at dispatch)."""

    def __init__(self, ref, replica_set, replica_key, replica=None):
        self._ref = ref
        self._rs = replica_set
        self._key = replica_key
        # Strong ref for the life of the in-flight key: the router keys
        # counts by id(replica), so the object must not be GC'd (and its
        # id recycled) while this response is pending.
        self._replica = replica
        self._released = False
        self._lock = threading.Lock()

    def result(self, timeout: Optional[float] = None) -> Any:
        try:
            return ray_tpu_torch.get(self._ref, timeout=timeout)
        finally:
            self._release()

    def _release(self):
        with self._lock:
            if not self._released:
                self._released = True
                self._rs.release(self._key)
                self._replica = None

    def _to_object_ref(self):
        return self._ref

    def __del__(self):
        # Chained responses never see .result(); free the router slot so
        # queue-length telemetry (autoscaling) doesn't leak in-flight
        # counts.
        try:
            self._release()
        except Exception:  # noqa: BLE001 — interpreter-teardown safety
            pass


class DeploymentResponseGenerator:
    """Streaming response: iterate items as the replica's generator yields
    them (``handle.options(stream=True)``). The replica's
    ``handle_stream_gen`` runs with ``num_returns="streaming"`` and each
    yield commits an item ref that the ``ObjectRefGenerator`` hands out
    incrementally, so ``next()`` unblocks on the replica's NEXT yield.
    ``close()`` (or dropping the generator) cancels the replica's
    generator between yields."""

    def __init__(self, ref_gen, replica_set, replica_key, replica=None):
        self._gen = ref_gen  # ObjectRefGenerator
        self._rs = replica_set
        self._key = replica_key
        self._replica = replica  # strong ref; see DeploymentResponse
        self._released = False
        self._lock = threading.Lock()

    def __iter__(self):
        return self

    def __next__(self):
        try:
            ref = next(self._gen)
        except BaseException:  # noqa: BLE001 — incl. StopIteration
            self._release()
            raise
        try:
            return ray_tpu_torch.get(ref)
        except BaseException:  # noqa: BLE001 — lost item / typed error
            # A failed item ends the stream for this consumer: cancel the
            # replica's generator (it must stop holding engine KV blocks)
            # and release the router slot.
            try:
                self.close()
            except Exception:  # noqa: BLE001 — original error wins
                pass
            raise

    def close(self):
        """Stop consuming: cancels the replica's in-flight generator and
        releases committed-but-unconsumed items."""
        try:
            self._gen.close()
        finally:
            self._release()

    def _release(self):
        with self._lock:
            if not self._released:
                self._released = True
                self._rs.release(self._key)
                self._replica = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter-teardown safety
            pass


def _extract_prefix_tokens(args, kwargs):
    """Token prompt of an LLM-shaped request, for prefix-aware routing:
    the first positional arg (or ``request=``) as either a token list or
    a dict carrying ``"prompt"``. Anything else returns None."""
    req = args[0] if args else kwargs.get("request")
    if isinstance(req, dict):
        req = req.get("prompt")
    if (isinstance(req, (list, tuple)) and req
            and all(isinstance(t, int) for t in req)):
        return list(req)
    return None


class _KVStreamFallbackGenerator:
    """Fallback stream: items arrive through the runtime's KV under
    (stream_id, seq) keys, polled in order. Used only where the streaming
    actor plane is unavailable: a replica whose runtime has no
    generator methods (``handle_stream_gen`` raises). The primary path is
    ``DeploymentResponseGenerator`` over ``ObjectRefGenerator``; this
    poller trades latency (2 ms poll cadence, no backpressure) for
    working over nothing but the KV (cluster-global with a head)."""

    def __init__(self, ref, replica_set, replica_key, stream_id: str):
        self._inner = DeploymentResponse(ref, replica_set, replica_key)
        self._stream_id = stream_id
        self._seq = 0
        self._done = False

    def __iter__(self):
        return self

    def close(self):
        """Stop consuming: best-effort cancel of the producing replica
        task, release the router's in-flight slot NOW — an abandoned
        fallback stream must stop counting as an ongoing request (the
        autoscaler reads those counts) — and clean the stream's KV keys.
        Sweep protocol: if the producer already committed ``|end`` it has
        exited, so this side sweeps everything; otherwise a ``|cancel``
        marker is written and the still-running producer sweeps its own
        writes (covering items committed after this sweep)."""
        if self._done:
            return
        self._done = True
        try:
            ray_tpu_torch.cancel(self._inner._to_object_ref())
        except Exception:  # noqa: BLE001 — cancel is advisory here
            pass
        try:
            from ray_tpu_torch._private.worker import global_worker

            w = global_worker()
            base = f"serve|stream|{self._stream_id}"

            def sweep_items(seq):
                while w.kv_del(f"{base}|{seq}".encode()):
                    seq += 1
                return seq

            seq = sweep_items(self._seq)
            w.kv_del(f"{base}|err".encode())
            if w.kv_del(f"{base}|end".encode()):
                # Producer exited: re-sweep items it committed between
                # our first pass and |end landing (TOCTOU window).
                sweep_items(seq)
                w.kv_del(f"{base}|err".encode())
            else:
                # Producer still running: hand it the sweep baton — and
                # re-check |end, which closes the handshake against a
                # producer that committed |end before seeing the marker
                # (it re-checks |cancel after |end; we re-check |end
                # after |cancel, so one side always observes the other).
                w.kv_put(f"{base}|cancel".encode(), b"1")
                if w.kv_del(f"{base}|end".encode()):
                    sweep_items(seq)
                    w.kv_del(f"{base}|err".encode())
                    w.kv_del(f"{base}|cancel".encode())
        except Exception:  # noqa: BLE001 — KV cleanup is best-effort
            pass
        self._inner._release()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter-teardown safety
            pass

    def __next__(self):
        import pickle
        import time

        from ray_tpu_torch._private.worker import global_worker

        if self._done:
            raise StopIteration
        w = global_worker()
        base = f"serve|stream|{self._stream_id}"
        deadline = time.monotonic() + 60.0
        oref = None
        try:
            oref = self._inner._to_object_ref()
        except Exception:  # noqa: BLE001 — no ref (test stub): poll only
            pass
        while True:
            raw = w.kv_get(f"{base}|{self._seq}".encode())
            if raw is not None:
                w.kv_del(f"{base}|{self._seq}".encode())
                self._seq += 1
                return pickle.loads(raw)
            err = w.kv_get(f"{base}|err".encode())
            if err is not None:
                w.kv_del(f"{base}|err".encode())
                self.close()  # sweep unconsumed items + markers
                raise pickle.loads(err)
            end = w.kv_get(f"{base}|end".encode())
            if end is not None and self._seq >= int(end):
                self.close()
                raise StopIteration
            if oref is not None:
                # Dead-producer fast path: a killed replica's in-flight
                # call materializes a typed error into the result ref
                # (ActorDiedError via the node-death watcher) — surface
                # it NOW so the client retries in seconds, instead of
                # burning the full stall bound per stream (a mid-kill
                # episode otherwise serializes every open stream behind
                # a 60 s poll timeout).
                call_err = w.store.peek_error(oref.object_id)
                if call_err is not None:
                    self.close()
                    raise call_err
            if time.monotonic() > deadline:
                self.close()
                raise TimeoutError("stream stalled for 60s")
            time.sleep(0.002)


class _DetachedRouter:
    """The controller's stand-in for a handle that crossed a process
    boundary: it routes over a snapshot of the deployment's replica
    actor handles (which pickle). Scaling after the snapshot is not
    seen, and the admission bound applies per holding process."""

    def __init__(self, replicas, admission=None):
        from ray_tpu_torch.serve.router import ReplicaSet

        self._rs = ReplicaSet()
        self._rs.update(list(replicas))
        if admission:
            self._rs.configure_admission(admission.get("max_ongoing"),
                                         admission.get("fractions"))

    def _replica_set(self, name):
        return self._rs

    def _record_request(self, name):
        pass


def _rebuild_deployment_handle(name, method, stream, replicas,
                               priority=0, admission=None):
    handle = DeploymentHandle.__new__(DeploymentHandle)
    handle._name = name
    handle._controller = _DetachedRouter(replicas, admission=admission)
    handle._method = method
    handle._stream = stream
    handle._priority = priority
    return handle


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller,
                 method_name: str = "__call__", stream: bool = False,
                 priority: int = 0):
        self._name = deployment_name
        self._controller = controller
        self._method = method_name
        self._stream = stream
        self._priority = priority

    def __reduce__(self):
        rs = self._controller._replica_set(self._name)
        admission = {"max_ongoing": rs._max_ongoing,
                     "fractions": list(rs._class_fractions)}
        return (_rebuild_deployment_handle,
                (self._name, self._method, self._stream,
                 list(rs._replicas), self._priority, admission))

    def options(self, method_name: Optional[str] = None, *,
                stream: Optional[bool] = None,
                priority: Optional[int] = None) -> "DeploymentHandle":
        return DeploymentHandle(
            self._name, self._controller,
            method_name if method_name is not None else self._method,
            stream=self._stream if stream is None else stream,
            priority=self._priority if priority is None else int(priority))

    def remote(self, *args, **kwargs):
        span = None
        if tracing._TRACER is not None:
            # Serve entry point: inherit the caller's ambient context (or
            # root a fresh trace); the span covers routing, wake and
            # submission, and replica and engine spans parent to it.
            span = tracing.begin("serve.request", deployment=self._name,
                                 method=self._method,
                                 priority=self._priority)
            # Only deployments that consume LLM request dicts get the
            # context injected into their request; other deployments'
            # arguments are never reshaped by tracing.
            if self._targets_llm():
                if args and isinstance(args[0], dict) \
                        and "prompt" in args[0]:
                    args = ({**args[0],
                             "_trace": tracing.inject(span.ctx)},) \
                        + args[1:]
                elif isinstance(kwargs.get("request"), dict) \
                        and "prompt" in kwargs["request"]:
                    kwargs = dict(kwargs)
                    kwargs["request"] = {**kwargs["request"],
                                         "_trace":
                                         tracing.inject(span.ctx)}
        try:
            result = self._remote_inner(args, kwargs)
        except BaseException as exc:
            tracing.finish(span, status="error",
                           error=type(exc).__name__)
            raise
        tracing.finish(span)
        return result

    def _targets_llm(self) -> bool:
        """Whether this deployment consumes LLM request dicts; a
        detached handle has no deployment registry and injects none."""
        consumes = getattr(self._controller, "consumes_llm_requests", None)
        return consumes is not None and consumes(self._name)

    def _remote_inner(self, args, kwargs):
        rs = self._controller._replica_set(self._name)
        # Prefix-aware tier: when any replica has reported a prefix
        # digest (LLM deployments), score replicas by cached-prefix
        # overlap with the request's prompt.
        prefix_tokens = None
        if rs.has_prefix_digests():
            prefix_tokens = _extract_prefix_tokens(args, kwargs)
        # Priority admission: past the deployment's class threshold this
        # raises a typed RequestSheddedError before any replica is
        # touched.
        try:
            key, replica = rs.choose(prefix_tokens=prefix_tokens,
                                     priority=self._priority)
        except RuntimeError:
            # Zero replicas: a scaled-to-zero deployment WAKES (the
            # request queues while the controller scales back up,
            # bounded) instead of failing; the woken replica may die
            # before the re-choose, so the wake is retried (bounded). A
            # detached router has no controller and keeps the raise.
            wake = getattr(self._controller, "wake_and_wait", None)
            if wake is None:
                raise
            for attempt in range(3):
                wake(self._name)
                rs = self._controller._replica_set(self._name)
                try:
                    key, replica = rs.choose(
                        prefix_tokens=prefix_tokens,
                        priority=self._priority)
                    break
                except RuntimeError:
                    if attempt == 2:
                        raise
        # Chain: unwrap DeploymentResponses into ObjectRefs so downstream
        # deployments receive resolved values without blocking here.
        args = tuple(
            a._to_object_ref() if isinstance(a, DeploymentResponse) else a
            for a in args)
        kwargs = {
            k: (v._to_object_ref() if isinstance(v, DeploymentResponse)
                else v)
            for k, v in kwargs.items()
        }
        self._controller._record_request(self._name)
        if self._stream:
            try:
                # Primary: the streaming task plane; the replica's
                # generator yields straight into item refs consumed here
                # incrementally (with backpressure).
                ref_gen = replica.handle_stream_gen.options(
                    num_returns="streaming").remote(
                        self._method, args, kwargs)
                return DeploymentResponseGenerator(
                    ref_gen, rs, key, replica=replica)
            except (ValueError, AttributeError, TypeError):
                # The replica's runtime has no streaming plane: fall back
                # to (stream_id, seq) KV polling.
                pass
            import uuid

            stream_id = uuid.uuid4().hex
            ref = replica.handle_stream.remote(
                self._method, args, kwargs, stream_id)
            return _KVStreamFallbackGenerator(ref, rs, key, stream_id)
        ref = replica.handle_request.remote(self._method, args, kwargs)
        return DeploymentResponse(ref, rs, key, replica=replica)

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return _MethodCaller(self, item)


class _MethodCaller:
    def __init__(self, handle: DeploymentHandle, method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs):
        return self._handle.options(self._method).remote(*args, **kwargs)
