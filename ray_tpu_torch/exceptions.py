"""Typed error surface of the port (own copies of the reference's
``ray_tpu/exceptions.py``, and of ``ray_tpu.llm.kv_cache.KVCacheOOM``).
``ActorUnavailableError``, ``ObjectReconstructionFailedError`` and
``PendingCallsLimitExceededError`` are defined for API parity: the
reference raises none of them, and neither does the port.

A task's error surfaces at ``get`` as a ``RayTaskError`` that is also an
instance of the original exception's type, so user ``except`` clauses
still match; object loss, actor death, cancellation and timeouts are
types of their own.
"""

from __future__ import annotations

import traceback
from typing import Optional


class RayTpuError(Exception):
    """Base class for the port's framework errors."""


class RayTaskError(RayTpuError):
    """A task raised an exception; re-raised at ``get``.

    Holds the function name, the formatted traceback and the original
    exception (``cause``); ``as_instanceof_cause`` re-raises it as a
    subclass of the original type where possible.
    """

    def __init__(self, function_name: str, traceback_str: str,
                 cause: Optional[BaseException] = None):
        self.function_name = function_name
        self.traceback_str = traceback_str
        self.cause = cause
        super().__init__(
            f"task {function_name!r} failed:\n{traceback_str}"
        )

    @classmethod
    def from_exception(cls, function_name: str, exc: BaseException):
        tb = "".join(
            traceback.format_exception(type(exc), exc, exc.__traceback__)
        )
        return cls(function_name, tb, cause=exc)

    def __reduce__(self):
        # Keep the cause when it pickles, drop it otherwise: the default
        # Exception reduction would call __init__ with the message only.
        import pickle as _pickle

        cause = self.cause
        if cause is not None:
            try:
                _pickle.dumps(cause)
            except Exception:  # noqa: BLE001 — unpicklable cause
                cause = None
        return (RayTaskError,
                (self.function_name, self.traceback_str, cause))

    def as_instanceof_cause(self) -> BaseException:
        """Return an exception that is ``isinstance`` of the original type."""
        if self.cause is None:
            return self
        cause_cls = type(self.cause)
        if isinstance(self.cause, RayTaskError):
            # Double wrap (a stage re-wrapped an already-typed error):
            # surface the innermost original type.
            return self.cause.as_instanceof_cause()
        if issubclass(cause_cls, RequestSheddedError):
            # Shed-by-policy stays matchable with its priority and retry
            # hint: overload is policy, not a task failure.
            return self.cause
        if issubclass(cause_cls, RayTpuError):
            return self
        try:
            derived = type(
                "RayTaskError(" + cause_cls.__name__ + ")",
                (RayTaskError, cause_cls),
                {"__init__": lambda s: None},
            )()
            derived.function_name = self.function_name
            derived.traceback_str = self.traceback_str
            derived.cause = self.cause
            derived.args = (str(self),)
            return derived
        except TypeError:
            return self


class RayActorError(RayTpuError):
    """The actor died before or while executing the task."""

    def __init__(self, actor_id=None, message: str = ""):
        self.actor_id = actor_id
        super().__init__(message or f"actor {actor_id} is dead")


class ActorDiedError(RayActorError):
    pass


class ActorUnavailableError(RayActorError):
    """Actor is temporarily unreachable (restarting)."""


class TaskCancelledError(RayTpuError):
    def __init__(self, task_id=None):
        self.task_id = task_id
        super().__init__(f"task {task_id} was cancelled")


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class ObjectLostError(RayTpuError):
    def __init__(self, object_ref=None, message: str = ""):
        self.object_ref = object_ref
        super().__init__(message or f"object {object_ref} was lost")


class ObjectReconstructionFailedError(ObjectLostError):
    pass


class OwnerDiedError(ObjectLostError):
    """The owner of a borrowed object died and neither its location nor
    a copy reached the head's fallback directory."""


class ChannelError(RayTpuError):
    """Compiled-graph channel failure (closed, timeout, version skew)."""


class ChannelTimeoutError(ChannelError, TimeoutError):
    pass


class WorkerCrashedError(RayTpuError):
    pass


class WorkerPoolExhaustedError(RayTpuError):
    """No worker process became idle within the lease deadline. System
    condition (pool pressure), not a task failure — treated as retriable."""


class OutOfMemoryError(RayTpuError):
    pass


class RequestSheddedError(RayTpuError):
    """The request was refused (or evicted pre-admission) by the load-
    shedding policy under overload, not a failure of the request itself.
    Retryable after ``retry_after_s``; the HTTP proxy maps it to 503 and
    Retry-After. ``priority`` is the shed request's class (0 = most
    important; higher classes shed first)."""

    def __init__(self, message: str = "", priority: int = 0,
                 retry_after_s: float = 1.0):
        self.priority = priority
        self.retry_after_s = retry_after_s
        super().__init__(
            message or f"request (priority class {priority}) shed by "
                       f"load-shedding policy; retry after "
                       f"{retry_after_s:.1f}s")


class HeadFailedOverError(RayTpuError, ConnectionError):
    """The head failed over (or fenced itself after losing a promotion
    race) while this call was in flight. Surfaced only for calls that
    cannot be replayed: idempotent head RPCs replay against the promoted
    head, but a relayed actor call whose reply was lost may or may not
    have run. Also the typed refusal a fenced old primary answers every
    request with. Subclasses ConnectionError, so reconnect-on-
    ConnectionError paths keep working."""

    def __init__(self, message: str = "", epoch: int = 0):
        self.epoch = epoch
        super().__init__(
            message or "the head failed over while this call was in "
                       "flight; the call may or may not have executed")


class PlacementInfeasibleError(RayTpuError, ValueError):
    """No local capacity and no feasible cluster node for an actor's
    resource demand. Subclasses ValueError, as the reference's does."""


class NodeDrainingError(RayTpuError):
    """A task push landed on a node that is draining: the node refused
    it, and the router reroutes the task."""

    def __init__(self, node_client: str = ""):
        self.node_client = node_client
        super().__init__(
            f"node {node_client!r} is draining for reap and refuses "
            f"new work (rerouted)")


class PendingCallsLimitExceededError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    """A task's ``runtime_env`` could not be set up: a pip/uv venv build
    failed, or the env needs a worker process the plane cannot give."""


class NodeLaunchFailedError(RayTpuError):
    """The autoscaler's provider could not bring a node up within its
    bounded, jittered retry budget — a typed infrastructure failure,
    not silent membership absence. ``attempts`` is how many launches
    were tried; ``node_type`` names the shape that failed."""

    def __init__(self, node_type: str = "", attempts: int = 0,
                 message: str = ""):
        self.node_type = node_type
        self.attempts = attempts
        super().__init__(
            message or f"node type {node_type!r} failed to launch after "
                       f"{attempts} attempt(s)")


class KVCacheOOM(RuntimeError):
    """No free blocks for a required allocation (after eviction)."""
