"""General topic pub/sub (counterpart of ``ray_tpu/util/pubsub.py``).

Head-attached drivers publish and subscribe cluster-wide through the
head's event channels (``HeadClient.subscribe`` / ``publish``); a driver
with no head attachment gets the same API over an in-process registry,
so libraries can publish unconditionally.
"""

from __future__ import annotations

import queue as _queue
import threading
from typing import Any, Callable, Dict, List, Optional

NODE_EVENTS_TOPIC = "ray_tpu:node_events"

_local_lock = threading.Lock()
_local_subs: Dict[str, List[Callable[[Any], None]]] = {}


class LocalSubscription:
    def __init__(self, topic: str):
        self.topic = topic
        self._queue: "_queue.Queue" = _queue.Queue()

    def get(self, timeout: Optional[float] = None):
        return self._queue.get(timeout=timeout)

    def close(self):
        with _local_lock:
            handlers = _local_subs.get(self.topic, [])
            if self._queue.put in handlers:
                handlers.remove(self._queue.put)


def _head_client():
    """The live runtime's head attachment, or None."""
    from ray_tpu_torch._private.worker import try_live_worker

    w = try_live_worker()
    return getattr(w, "head_client", None) if w is not None else None


def subscribe(topic: str, callback: Optional[Callable[[Any], None]] = None):
    """Subscribe to a topic; returns a subscription whose ``.get(timeout)``
    yields payloads (when no callback is given) and ``.close()`` stops it."""
    hc = _head_client()
    if hc is not None:
        return hc.subscribe(topic, callback)
    sub = LocalSubscription(topic)
    with _local_lock:
        _local_subs.setdefault(topic, []).append(
            callback if callback is not None else sub._queue.put)
    return sub


def publish(topic: str, payload: Any) -> int:
    """Publish to every subscriber; returns the number of clients the
    head pushed to (attached) or of local handlers (not attached)."""
    hc = _head_client()
    if hc is not None:
        return hc.publish(topic, payload)
    with _local_lock:
        handlers = list(_local_subs.get(topic, ()))
    for h in handlers:
        try:
            h(payload)
        except Exception:  # noqa: BLE001 — subscriber callback bug
            pass
    return len(handlers)
