"""Typed error surface of the port (own copies of the reference's
``ray_tpu/exceptions.py``, trimmed to what the one-process runtime and
Serve raise, and of ``ray_tpu.llm.kv_cache.KVCacheOOM``).

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


class ChannelError(RayTpuError):
    """Compiled-graph channel failure (closed, timeout, version skew)."""


class ChannelTimeoutError(ChannelError, TimeoutError):
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


class KVCacheOOM(RuntimeError):
    """No free blocks for a required allocation (after eviction)."""
