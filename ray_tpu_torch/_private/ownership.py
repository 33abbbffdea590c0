"""Ownership-based object directory (counterpart of
``ray_tpu/_private/ownership.py``): the driver that submits a task owns
its returned refs, keeps their locations and answers location queries
for them; the head keeps only what must outlive an owner.

Two halves, one wire protocol over the p2p object plane:

- **OwnerDirectory** (owner side, built by the driver's
  ``RemoteRouter``): serves ``owner_locate`` on the driver's object
  server. The location table is the router's completion-stream state
  (``task_done``/``item_done`` reports flow node -> driver direct), so
  the head sees no steady-state object traffic. A locate for an object
  whose producer is still in flight subscribes the asker; the owner
  pushes ``owner_notify`` when the completion report lands.
- **OwnerResolver** (consumer side, one per head-attached runtime):
  resolves a ref through its owner (locate, then a peer-to-peer pull
  from the node the owner names), with the head's directory only as
  the fallback. An unreachable owner that the head's membership calls
  dead materializes a typed ``OwnerDiedError``.

Exceptions cross as pickled payloads of the locate reply
(``_pickle_exc``/``_unpickle_exc``); the framed transport itself never
unpickles (its error maps come from a module whitelist).
``RemoteRouter.shutdown`` hands the owner's table to the head in one
``object_transfer`` flight (the lease handoff), so borrowed refs of a
driver that exited cleanly keep resolving, while a SIGKILLed owner's
objects fail typed.
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import Dict, Optional, Set, Tuple

from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.log import get_logger
from ray_tpu_torch._private.object_server import PeerUnreachableError
from ray_tpu_torch.exceptions import (
    GetTimeoutError,
    OwnerDiedError,
    RayTaskError,
)

log = get_logger(__name__)


def locate_reply(status: str, addr=None, size: int = 0,
                 err: Optional[bytes] = None,
                 holder: Optional[str] = None) -> dict:
    """One ``owner_locate`` reply (msgpack-safe). ``status``:

    - ``ready``   — ``addr`` serves the bytes (object-server meta/chunk);
      ``holder`` names the serving client for the head-relayed
      ``object_pull_from`` fallback (NAT'd pullers)
    - ``error``   — the producer failed; ``err`` is the pickled exception
    - ``pending`` — the producer is still in flight; the asker is
      subscribed and will receive ``owner_notify`` on completion
    - ``unknown`` — this owner does not track the object
    """
    out = {"status": status}
    if addr is not None:
        out["addr"] = [str(addr[0]), int(addr[1])]
    if size:
        out["size"] = int(size)
    if err is not None:
        out["err"] = err
    if holder is not None:
        out["holder"] = holder
    return out


class OwnerDirectory:
    """Owner-side half: location answers + completion subscriptions.

    Constructed by (and reading the tables of) the owning driver's
    ``RemoteRouter``; registered on the driver's object server as the
    ``owner_locate`` handler. ``publish`` is called from the router's
    completion/failure paths and pushes ``owner_notify`` to subscribers
    off the completion thread (router prefetch pool)."""

    def __init__(self, router):
        self.router = router
        self.worker = router.worker
        self.head = router.head
        self._lock = threading.Lock()
        self._subs: Dict[bytes, Set[Tuple[str, int]]] = {}
        # Oids whose store ready-callback already routes to publish()
        # (local-scheduler producers complete outside the router's
        # completion stream).
        self._ready_wired: set = set()
        # Bench/observability counters (the flatness proof surface).
        self.locates_served = 0
        self.notifies_sent = 0
        self.head._object_server.handlers["owner_locate"] = \
            self._on_owner_locate

    # ---------------------------------------------------------------- serve
    def _on_owner_locate(self, msg: tuple) -> dict:
        oid_bin = bytes(msg[1])
        sub_addr = msg[2] if len(msg) > 2 else None
        with self._lock:
            self.locates_served += 1
        reply = self.lookup(oid_bin)
        if reply["status"] == "pending" and sub_addr:
            with self._lock:
                self._subs.setdefault(oid_bin, set()).add(
                    (str(sub_addr[0]), int(sub_addr[1])))
                wire_ready = oid_bin not in self._ready_wired
                if wire_ready:
                    self._ready_wired.add(oid_bin)
            if wire_ready:
                # Producers outside the router's completion stream
                # (owner-LOCAL scheduler tasks, direct puts) notify via
                # the store's ready edge — once per oid.
                self.worker.store.on_ready(
                    ObjectID(oid_bin),
                    lambda _ob=oid_bin: self.publish(_ob))
            # Completion may have raced the subscription registration:
            # re-check so a task_done that landed in between still
            # resolves this asker (publish pops no-longer-pending subs).
            recheck = self.lookup(oid_bin)
            if recheck["status"] != "pending":
                self.publish(oid_bin)
        return reply

    def lookup(self, oid_bin: bytes) -> dict:
        """Resolve one object id against the owner's tables: local
        store first (inlined/small results and driver puts live here),
        then the completion-stream location table, then in-flight
        producers (pending)."""
        router = self.router
        oid = ObjectID(oid_bin)
        store = self.worker.store
        if store.is_ready(oid):
            err = store.peek_error(oid)
            if err is not None:
                return locate_reply("error", err=_pickle_exc(err))
            return locate_reply("ready", self.head._object_server.address,
                                store.size_of(oid),
                                holder=self.head.client_id)
        tid = oid.task_id()
        with router._lock:
            holder = router._oid_owner.get(oid_bin)
            size = router._oid_sizes.get(oid_bin, 0)
            exc = router._failed.get(tid)
            ev = router._done.get(tid)
            done = ev is not None and ev.is_set()
            tracked = tid in router.lineage or tid in router.external
        if exc is not None:
            return locate_reply("error", err=_pickle_exc(exc))
        if holder is not None:
            addr = router._holder_addr(holder)
            if addr is not None:
                return locate_reply("ready", addr, size, holder=holder)
        if tracked and not done:
            return locate_reply("pending")
        # Streaming item refs: the stream is live but this index has
        # not committed yet — pending, resolved by its item_done.
        if self.worker.streams.get(tid) is not None:
            return locate_reply("pending")
        # In-flight on the owner's LOCAL scheduler (not router-tracked):
        # the store's producer mark is the tracking signal — pending,
        # so the asker subscribes instead of head-poll looping.
        if store.has_local_producer(oid):
            return locate_reply("pending")
        return locate_reply("unknown")

    # --------------------------------------------------------------- notify
    def publish(self, oid_bin: bytes):
        """Resolution state changed (completion report landed / producer
        failed): push the fresh lookup to every subscriber, off-thread."""
        with self._lock:
            subs = self._subs.pop(oid_bin, None)
            if subs:
                self._ready_wired.discard(oid_bin)
        if not subs:
            return
        reply = self.lookup(oid_bin)
        if reply["status"] == "pending":
            # Not actually resolvable yet (e.g. a sibling oid of the
            # same task landed first): re-register everyone.
            with self._lock:
                self._subs.setdefault(oid_bin, set()).update(subs)
            return
        payload = pickle.dumps({"oid": oid_bin, "reply": reply},
                               protocol=5)
        for addr in subs:
            self.router._prefetch_pool.submit(
                self._push_notify, addr, payload)

    def publish_many(self, oid_bins):
        """Batch edge of ``publish`` for completion reports carrying
        many result ids: only ids somebody subscribed to do any work."""
        with self._lock:
            if not self._subs:
                return
            hot = [ob for ob in oid_bins if ob in self._subs]
        for ob in hot:
            self.publish(ob)

    def _push_notify(self, addr: Tuple[str, int], payload: bytes):
        try:
            self.head._peers.call(addr, ("owner_notify", payload))
            with self._lock:
                self.notifies_sent += 1
        except Exception as exc:  # noqa: BLE001 — subscriber gone: its
            log.debug("owner_notify to %s failed (subscriber re-polls "
                      "at its deadline): %r", addr, exc)

    def snapshot_locations(self):
        """(oid_bin, holder_client) pairs for the lease handoff: every
        object whose bytes live on a cluster node (driver-local bytes
        die with the driver — nothing to transfer)."""
        with self.router._lock:
            return list(self.router._oid_owner.items())


def _pickle_exc(exc: BaseException) -> bytes:
    try:
        return pickle.dumps(exc, protocol=5)
    except Exception:  # noqa: BLE001 — unpicklable error
        return pickle.dumps(
            RayTaskError("task", repr(exc)), protocol=5)


class OwnerResolver:
    """Consumer-side half: materialize a ref's bytes (or its typed
    error) into the local store by asking its OWNER, event-driven.

    One per head-attached runtime (drivers and node daemons alike);
    registers the ``owner_notify`` handler on the local object server.
    The head directory is strictly the fallback plane — reached only
    when the owner is unreachable, does not track the object, or its
    named holder stopped serving the bytes."""

    def __init__(self, worker):
        self.worker = worker
        self.head = worker.head_client
        self._lock = threading.Lock()
        # oid_bin -> [threading.Event, latest notice reply or None, refs]
        self._waits: Dict[bytes, list] = {}
        self._prefetching: set = set()
        self.owner_locates = 0
        self.owner_direct_pulls = 0
        self.owner_notifies = 0
        self.head_fallback_pulls = 0
        self.owner_died_errors = 0
        self.head._object_server.handlers["owner_notify"] = self._on_notify

    # ---------------------------------------------------------------- wire
    def _on_notify(self, msg: tuple):
        payload = pickle.loads(bytes(msg[1]))
        oid_bin = bytes(payload["oid"])
        with self._lock:
            self.owner_notifies += 1
            rec = self._waits.get(oid_bin)
            if rec is None:
                return None  # waiter already resolved/gave up
            rec[1] = payload["reply"]
        rec[0].set()
        return None

    def _register_wait(self, oid_bin: bytes) -> list:
        with self._lock:
            rec = self._waits.get(oid_bin)
            if rec is None:
                rec = self._waits[oid_bin] = [threading.Event(), None, 0]
            rec[2] += 1
            return rec

    def _unregister_wait(self, oid_bin: bytes, rec: list):
        with self._lock:
            rec[2] -= 1
            if rec[2] <= 0 and self._waits.get(oid_bin) is rec:
                del self._waits[oid_bin]

    # -------------------------------------------------------------- resolve
    def resolve(self, oid_bin: bytes, owner_addr: Optional[Tuple[str, int]],
                owner_id: Optional[str] = None,
                deadline: Optional[float] = None,
                stop: Optional[threading.Event] = None,
                _from_prefetch: bool = False) -> None:
        """Block until the object's bytes OR typed error are in the
        local store. Raises ``GetTimeoutError`` at the deadline
        (``RAY_TPU_DEP_WAIT_S`` by default) and materializes
        ``OwnerDiedError`` when the owner is gone and the head's
        fallback directory cannot serve the object either."""
        from ray_tpu_torch._private.serialization import SerializedObject

        store = self.worker.store
        if store.is_ready(ObjectID(oid_bin)):
            return
        if deadline is None:
            deadline = time.monotonic() + GlobalConfig.dep_wait_s
        oid = ObjectID(oid_bin)
        self_addr = list(self.head._object_server.address)
        rec = self._register_wait(oid_bin)
        # Local-production edge: when the producer runs (or lands) on
        # THIS runtime — colocated chains, inlined results — the store's
        # ready callback wakes the same event the owner's notify does.
        store.on_ready(oid, rec[0].set)
        try:
            backoff = 0.05
            while True:
                if store.is_ready(oid):
                    return
                if store.has_local_producer(oid):
                    # A local task will produce it: never pullable from
                    # anywhere — pure event-driven wait on the store.
                    if not self._wait_slice(rec[0], deadline, 1.0, stop):
                        self._check_deadline(oid_bin, deadline)
                    continue
                if not _from_prefetch:
                    with self._lock:
                        prefetching = oid_bin in self._prefetching
                    if prefetching:
                        # A background prefetch is already transferring
                        # this object: wait for it instead of starting a
                        # duplicate full-byte pull (get() kicks off
                        # prefetches right before its foreground loop).
                        if not self._wait_slice(rec[0], deadline, 0.25,
                                                stop):
                            self._check_deadline(oid_bin, deadline)
                        continue
                owner_reachable = owner_addr is not None
                with self._lock:
                    reply, rec[1] = rec[1], None
                    if reply is None:
                        # Clear only OUR spurious wake: when a notify
                        # just landed, the event stays set so sibling
                        # waiters of the same oid don't lose it.
                        rec[0].clear()
                if reply is None and owner_addr is not None:
                    try:
                        reply = self.head._peers.call(
                            tuple(owner_addr),
                            ("owner_locate", oid_bin, self_addr))
                        with self._lock:
                            self.owner_locates += 1
                    except PeerUnreachableError:
                        owner_reachable = False
                    except Exception as exc:  # noqa: BLE001 — owner bug
                        log.debug("owner_locate failed; falling back to "
                                  "the head directory: %r", exc)
                        owner_reachable = False
                status = (reply or {}).get("status")
                if status == "error":
                    store.put_error(oid, _unpickle_exc(reply.get("err")))
                    return
                if status == "ready":
                    raw = self.head._peers.pull_retrying(
                        tuple(reply["addr"]), oid_bin)
                    if raw is not None:
                        store.put(oid, SerializedObject.from_bytes(raw))
                        with self._lock:
                            self.owner_direct_pulls += 1
                        return
                    holder = reply.get("holder")
                    if holder:
                        # Holder not directly reachable (NAT, reset
                        # lanes): head-relayed bytes from the holder the
                        # OWNER named — no head directory involved.
                        try:
                            raw = self.head.object_pull_from(
                                holder, oid_bin)
                        except RayTaskError as task_exc:
                            store.put_error(oid, task_exc)
                            return
                        except Exception as exc:  # noqa: BLE001
                            log.debug("relay-from-holder failed: %r", exc)
                        if raw is not None:
                            store.put(oid,
                                      SerializedObject.from_bytes(raw))
                            with self._lock:
                                self.head_fallback_pulls += 1
                            return
                    # Named holder stopped serving (evicted / died just
                    # now): head fallback below, then re-locate.
                elif status == "pending":
                    # Subscribed: the owner pushes owner_notify on the
                    # completion report — wait event-driven (the bounded
                    # slice only covers a lost notify / owner death).
                    if self._wait_slice(rec[0], deadline, 1.0, stop):
                        continue
                    self._check_deadline(oid_bin, deadline)
                    continue
                # unknown owner answer / unreachable owner / dead holder:
                # the head's fallback directory (lease-transferred
                # entries, relay-path announces).
                raw = None
                try:
                    raw = self.head.object_pull(oid_bin)
                except RayTaskError as task_exc:
                    store.put_error(oid, task_exc)
                    return
                except Exception as exc:  # noqa: BLE001 — head hiccup
                    log.debug("fallback object_pull failed; retrying: %r",
                              exc)
                if raw is not None:
                    store.put(oid, SerializedObject.from_bytes(raw))
                    with self._lock:
                        self.head_fallback_pulls += 1
                    return
                if not owner_reachable and owner_id is not None \
                        and not self._owner_alive(owner_id):
                    with self._lock:
                        self.owner_died_errors += 1
                    store.put_error(oid, OwnerDiedError(
                        message=f"owner {owner_id!r} of object "
                                f"{oid.hex()[:16]}… died; its location "
                                f"was never lease-transferred to the "
                                f"head and no fallback copy exists"))
                    return
                self._check_deadline(oid_bin, deadline)
                self._wait_slice(rec[0], deadline, backoff, stop)
                backoff = min(backoff * 2, 1.0)
        finally:
            self._unregister_wait(oid_bin, rec)

    @staticmethod
    def _wait_slice(event: threading.Event, deadline: float,
                    cap: float, stop: Optional[threading.Event]) -> bool:
        slice_s = max(0.0, min(cap, deadline - time.monotonic()))
        if stop is not None and stop.is_set():
            raise GetTimeoutError("runtime shutting down mid-resolve")
        return event.wait(slice_s)

    @staticmethod
    def _check_deadline(oid_bin: bytes, deadline: float):
        if time.monotonic() > deadline:
            raise GetTimeoutError(
                f"object {ObjectID(oid_bin).hex()[:16]}… was not "
                f"produced/resolvable within the dependency wait bound "
                f"({GlobalConfig.dep_wait_s:.0f}s, RAY_TPU_DEP_WAIT_S)")

    def prefetch(self, oid_bin: bytes, owner) -> None:
        """Background ``resolve`` with in-flight dedup — ``wait()``
        polls may kick this repeatedly without stacking resolvers.
        Runs on the router's bounded prefetch pool (one borrowed-ref
        list must not spawn a thread per object)."""
        with self._lock:
            if oid_bin in self._prefetching:
                return
            self._prefetching.add(oid_bin)

        def _run():
            try:
                self.resolve(oid_bin, tuple(owner[1]), owner[0],
                             _from_prefetch=True)
            except Exception:  # noqa: BLE001 — best-effort prefetch
                pass
            finally:
                with self._lock:
                    self._prefetching.discard(oid_bin)

        router = self.worker.remote_router
        if router is not None:
            router._prefetch_pool.submit(_run)
        else:  # headless resolver (tests): degrade to a thread
            threading.Thread(target=_run, daemon=True,
                             name="ray_tpu_owner_prefetch").start()

    def _owner_alive(self, owner_id: str) -> bool:
        try:
            return owner_id in self.head.cluster_info()["clients"]
        except Exception:  # noqa: BLE001 — head unreachable: assume
            return True    # alive (never fail typed on a head hiccup)

    def counters(self) -> dict:
        with self._lock:
            return {
                "owner_locates": self.owner_locates,
                "owner_direct_pulls": self.owner_direct_pulls,
                "owner_notifies": self.owner_notifies,
                "head_fallback_pulls": self.head_fallback_pulls,
                "owner_died_errors": self.owner_died_errors,
            }


def _unpickle_exc(raw) -> BaseException:
    try:
        exc = pickle.loads(bytes(raw))
        if isinstance(exc, BaseException):
            return exc
    except Exception:  # noqa: BLE001 — error didn't survive the wire
        pass
    from ray_tpu_torch.exceptions import WorkerCrashedError

    return WorkerCrashedError(
        "remote producer failed and its error was not transferable")
