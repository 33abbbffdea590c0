"""The driver's API service for worker processes (counterpart of
``ray_tpu/_private/driver_service.py``).

Worker processes are thin executors: every ``ray_tpu_torch.*`` call made
inside a task or a process-backed actor (a nested ``.remote()``, ``get``,
``put``, ``wait``, a method call on an actor handle passed in, an actor
created there, a named-actor lookup, the KV, the runtime context) comes
back over the worker's shared-memory channel pair to the driver, which
runs it against the real runtime and replies.

``WorkerProcess`` starts one service thread per worker. Requests are
serialized per worker (the client holds a lock), so the protocol needs no
correlation ids. A reply bigger than the inline limit rides the shm store
whole.
"""

from __future__ import annotations

import pickle
import threading
from typing import Any, List

from ray_tpu_torch._private.log import get_logger

log = get_logger(__name__)

# Driver-side stage keys of oversized replies (apart from the 0xA4A0...
# task-argument range and the 0xA4B... client range).
_reply_counter = [0]
_reply_lock = threading.Lock()


def _next_reply_key() -> int:
    with _reply_lock:
        _reply_counter[0] += 1
        return 0xA4C0_0000_0000_0000 | (_reply_counter[0] & 0xFFFF_FFFF_FFFF)


class _ServiceState:
    """Per-worker pinned refs: the objects a worker made or was promised
    stay alive at least as long as the worker process (the reference's
    simplified borrower protocol)."""

    def __init__(self):
        self.pinned: dict = {}   # oid -> ObjectRef

    def pin(self, refs: List[Any]):
        for r in refs:
            self.pinned[r.object_id] = r

    def clear(self):
        self.pinned.clear()


def handle_request(worker, shm_store, state: _ServiceState, msg: tuple):
    """Run one API request of a worker process and return the reply
    tuple; the caller ships an exception back."""
    from ray_tpu_torch._private.ids import ActorID, ObjectID
    from ray_tpu_torch._private.serialization import (
        SerializedObject,
        wire_loads,
    )
    from ray_tpu_torch._private.worker import ObjectRef

    kind = msg[0]
    if kind == "api_ping":
        return ("ok", None)
    if kind == "api_put":
        # (oid_bin, data | shm_key, is_shm): the client chose the oid.
        _, oid_bin, payload, is_shm = msg
        if is_shm:
            data = bytes(shm_store.get(payload))
            shm_store.delete(payload)
        else:
            data = payload
        oid = ObjectID(oid_bin)
        worker.store.put(oid, SerializedObject.from_bytes(data))
        state.pin([ObjectRef(oid)])
        return ("ok", None)
    if kind == "api_get":
        _, oid_bin, timeout = msg
        serialized = worker.store.get(ObjectID(oid_bin), timeout=timeout)
        return ("ok", serialized.to_bytes())
    if kind == "api_wait":
        _, oid_bins, num_returns, timeout = msg
        ready, not_ready = worker.store.wait(
            [ObjectID(b) for b in oid_bins], num_returns, timeout)
        return ("ok", ([o.binary() for o in ready],
                       [o.binary() for o in not_ready]))
    if kind == "api_submit":
        # The whole TaskSpec, function included; ObjectRef arguments
        # come back as driver-side refs as it unpickles.
        spec = wire_loads(msg[1])
        state.pin(worker.submit_task(spec))
        return ("ok", None)
    if kind == "api_actor_submit":
        _, actor_bin, method_name, args_bytes, num_returns, name = msg
        runtime = worker.actors.get(ActorID(actor_bin))
        if runtime is None:
            raise ValueError("actor not found on the driver")
        args, kwargs = wire_loads(args_bytes)
        refs = runtime.submit(method_name, args, kwargs, num_returns,
                              name or method_name)
        state.pin(refs)
        return ("ok", [r.object_id.binary() for r in refs])
    if kind == "api_actor_create":
        from ray_tpu_torch.actor import ActorClass

        _, cls_bytes, args_bytes, opts = msg
        args, kwargs = wire_loads(args_bytes)
        handle = ActorClass(wire_loads(cls_bytes),
                            dict(opts or {})).remote(*args, **kwargs)
        return ("ok", handle._actor_id.binary())
    if kind == "api_actor_named":
        from ray_tpu_torch.actor import get_actor

        _, name, namespace = msg
        return ("ok", get_actor(name, namespace)._actor_id.binary())
    if kind == "api_kv":
        _, op, key, value = msg
        if op == "put":
            return ("ok", worker.kv_put(key, value))
        if op == "put_once":
            return ("ok", worker.kv_put(key, value, overwrite=False))
        if op == "get":
            value = worker.kv_get(key)
            if isinstance(value, SerializedObject):
                # A driver-side post (a collective's value): the worker
                # reads it in the wire form.
                value = value.to_bytes()
            return ("ok", value)
        if op == "del":
            return ("ok", worker.kv_del(key))
        if op == "keys":
            return ("ok", worker.kv_keys(key or b""))
        raise ValueError(f"unknown kv op {op!r}")
    if kind == "api_resources":
        pool = worker.resource_pool
        return ("ok", pool.available() if msg[1] == "available"
                else pool.total)
    if kind == "api_ctx":
        return ("ok", {
            "job_id": worker.job_id.binary(),
            "node_id": worker.node_id.binary(),
            "namespace": getattr(worker, "namespace", "default"),
        })
    raise ValueError(f"unknown api request {msg[0]!r}")


def service_loop(proc) -> None:
    """Thread body: serve one worker's API channel until the worker dies
    or the driver closes the channel."""
    from ray_tpu_torch._private import worker as worker_mod
    from ray_tpu_torch.exceptions import ChannelTimeoutError

    state = _ServiceState()
    # Headroom for pickle's overhead under the channel's capacity; a
    # bigger reply rides the store whole.
    inline_limit = max(proc.max_msg // 4, 64 * 1024)
    while not proc._svc_stop:
        try:
            msg = proc._api_req.read(timeout=0.25)
        except ChannelTimeoutError:
            if not proc.alive():
                break
            continue
        except Exception as exc:  # noqa: BLE001 — channel torn down
            log.debug("driver api channel torn down; service loop "
                      "exiting: %r", exc)
            break
        worker = worker_mod._try_global_worker()
        try:
            if msg[0] == "api_blob":   # an oversized request, staged
                raw = bytes(proc._store.get(msg[1]))
                proc._store.delete(msg[1])
                msg = pickle.loads(raw)
            if worker is None or not worker.is_alive:
                raise RuntimeError("driver runtime is shut down")
            reply = handle_request(worker, proc._store, state, msg)
        except BaseException as exc:  # noqa: BLE001 — error boundary
            try:
                reply = ("err", pickle.dumps(exc))
            except Exception:  # noqa: BLE001 — unpicklable exception
                reply = ("err", pickle.dumps(
                    RuntimeError(f"{type(exc).__name__}: {exc}")))
        try:
            raw = pickle.dumps(reply, protocol=5)
            if len(raw) > inline_limit:
                key = _next_reply_key()
                proc._store.put(key, raw)
                reply = ("okshm_reply", key)
        except Exception as exc:  # noqa: BLE001 — stays inline
            log.debug("reply staging failed; sending inline: %r", exc)
        try:
            proc._api_rep.write(reply, timeout=10.0)
        except Exception as exc:  # noqa: BLE001 — worker died mid-reply
            log.debug("api reply write failed (worker %s): %r",
                      "dead" if not proc.alive() else "alive", exc)
            if not proc.alive():
                break
    state.clear()
