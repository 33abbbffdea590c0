"""DeploymentHandle / DeploymentResponse (counterpart of
``ray_tpu/serve/handle.py``): composable handles whose responses chain,
and streaming responses over the streaming task plane.

Not ported: the KV-polling stream fallback and the detached router,
which serve handles that crossed a process boundary (they wait with the
process plane), and the tracing hooks.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import ray_tpu_torch


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


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller,
                 method_name: str = "__call__", stream: bool = False,
                 priority: int = 0):
        self._name = deployment_name
        self._controller = controller
        self._method = method_name
        self._stream = stream
        self._priority = priority

    def options(self, method_name: Optional[str] = None, *,
                stream: Optional[bool] = None,
                priority: Optional[int] = None) -> "DeploymentHandle":
        return DeploymentHandle(
            self._name, self._controller,
            method_name if method_name is not None else self._method,
            stream=self._stream if stream is None else stream,
            priority=self._priority if priority is None else int(priority))

    def remote(self, *args, **kwargs):
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
            # before the re-choose, so the wake is retried (bounded).
            for attempt in range(3):
                self._controller.wake_and_wait(self._name)
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
            ref_gen = replica.handle_stream_gen.options(
                num_returns="streaming").remote(self._method, args, kwargs)
            return DeploymentResponseGenerator(
                ref_gen, rs, key, replica=replica)
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
