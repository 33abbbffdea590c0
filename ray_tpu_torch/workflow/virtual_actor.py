"""Durable virtual actors (counterpart of
``ray_tpu/workflow/virtual_actor.py``).

A virtual actor is a named stateful object kept in storage: its state
snapshots take the commit protocol of workflow steps, so the actor
outlives its driver, and ``get_or_create`` in a fresh process loads the
last committed snapshot. A method call runs in the calling process and
commits a new snapshot before it returns; a crash mid-call loses at
most that call, never earlier state.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Union

from ray_tpu_torch.workflow.storage import WorkflowStorage


class VirtualActorClass:
    """The ``@workflow.virtual_actor`` wrapper around a plain class."""

    def __init__(self, cls: type):
        if not isinstance(cls, type):
            raise TypeError(
                f"@workflow.virtual_actor target must be a class: {cls}")
        self._cls = cls

    def get_or_create(self, actor_id: str, *args,
                      storage: Optional[Union[str, WorkflowStorage]] = None,
                      **kwargs) -> "VirtualActorHandle":
        """Rehydrate the actor from its last committed snapshot, or
        construct it fresh (committing snapshot #0) when none exists."""
        from ray_tpu_torch.workflow.api import _ensure_storage

        store = _ensure_storage(storage)
        loaded = store.load_actor_state(actor_id)
        obj = self._cls.__new__(self._cls)
        if loaded is not None:
            state, seq = loaded
            _set_state(obj, state)
        else:
            obj.__init__(*args, **kwargs)
            seq = 0
            if not store.save_actor_state(actor_id, _get_state(obj), seq):
                # A concurrent creator committed snapshot #0 first:
                # adopt its state instead of forking history.
                state, seq = store.load_actor_state(actor_id)
                obj = self._cls.__new__(self._cls)
                _set_state(obj, state)
        return VirtualActorHandle(actor_id, obj, seq, store)


def _get_state(obj) -> Any:
    if hasattr(obj, "__getstate__"):
        try:
            return obj.__getstate__()
        except TypeError:
            pass
    return dict(obj.__dict__)


def _set_state(obj, state) -> None:
    if hasattr(obj, "__setstate__"):
        obj.__setstate__(state)
    else:
        obj.__dict__.update(state)


class VirtualActorHandle:
    """Live handle to a virtual actor in THIS process. Method access
    returns a ``.run()``-able wrapper; each run commits a snapshot."""

    def __init__(self, actor_id: str, obj: Any, seq: int,
                 storage: WorkflowStorage):
        self._actor_id = actor_id
        self._obj = obj
        self._seq = seq
        self._storage = storage
        self._lock = threading.Lock()

    @property
    def actor_id(self) -> str:
        return self._actor_id

    def get_state(self) -> Dict[str, Any]:
        return _get_state(self._obj)

    def __getattr__(self, item: str):
        if item.startswith("_"):
            raise AttributeError(item)
        if not callable(getattr(type(self._obj), item, None)):
            raise AttributeError(
                f"virtual actor {type(self._obj).__name__!r} has no "
                f"method {item!r}")
        return _VirtualActorMethod(self, item)

    def __repr__(self):
        return (f"VirtualActorHandle({type(self._obj).__name__}, "
                f"id={self._actor_id!r}, seq={self._seq})")


class _VirtualActorMethod:
    def __init__(self, handle: VirtualActorHandle, method: str):
        self._handle = handle
        self._method = method

    def run(self, *args, **kwargs):
        h = self._handle
        with h._lock:
            result = getattr(h._obj, self._method)(*args, **kwargs)
            # Commit AFTER the method: a crash before this line replays
            # the call against the previous snapshot on the next
            # get_or_create — at-least-once for the in-flight call,
            # exactly-once for everything already committed. The commit
            # is a per-seq compare-and-set: losing it means ANOTHER
            # process advanced this actor — surface loudly instead of
            # silently dropping either writer's update.
            if not h._storage.save_actor_state(
                    h._actor_id, _get_state(h._obj), h._seq + 1):
                raise RuntimeError(
                    f"virtual actor {h._actor_id!r}: a concurrent "
                    f"writer committed seq {h._seq + 1} first — this "
                    f"handle is stale; get_or_create a fresh one and "
                    f"retry the call")
            h._seq += 1
            return result

    # Reference-parity aliases.
    def run_async(self, *args, **kwargs):
        import concurrent.futures

        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        fut = pool.submit(self.run, *args, **kwargs)
        pool.shutdown(wait=False)
        return fut


def virtual_actor(cls: type) -> VirtualActorClass:
    """``@workflow.virtual_actor`` class decorator."""
    return VirtualActorClass(cls)
