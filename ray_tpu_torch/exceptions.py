"""Typed errors of the port's serving path (own copies of the reference's
``ray_tpu.exceptions.RequestSheddedError`` and
``ray_tpu.llm.kv_cache.KVCacheOOM``)."""

from __future__ import annotations


class RayTpuError(Exception):
    """Base class for the port's framework errors."""


class RequestSheddedError(RayTpuError):
    """The request was refused (or evicted pre-admission) by the load-
    shedding policy under overload, not a failure of the request itself.
    Retryable after ``retry_after_s``. ``priority`` is the shed request's
    class (0 = most important; higher classes shed first)."""

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
