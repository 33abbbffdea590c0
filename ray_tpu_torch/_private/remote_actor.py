"""Cluster-wide actors hosted on node daemons (counterpart of
``ray_tpu/_private/remote_actor.py``).

- **Placement** is the driver's decision (``RemoteRouter.place_actor``),
  made from the head's membership: resources, NodeAffinity, SPREAD and
  thin clients, the task router's policy family.
- **Creation and method calls go direct to the node** (an ``actor_op``
  request on its object server), with a head-relayed ``actor_push`` when
  the node cannot be dialled. The head is never in the call path.
- **Results stay on the node** (pinned against collection); the host
  reports ``task_done`` to the calling driver direct, small results and
  errors inline, and the driver pulls larger ones peer to peer.
- **Node death**: the owning driver's router watcher fails calls in
  flight with ``ActorDiedError`` and, within ``max_restarts``, creates
  the actor again with fresh state on a surviving feasible node, and
  updates the head's placement directory so named lookups and borrowed
  handles re-resolve.
- **Owner death**: the host kills the actors of a driver the head
  declared dead, unless ``lifetime="detached"``.

On a thread-plane daemon (``--worker-mode thread``) a hosted actor runs
in the daemon's own process, so it can own the daemon's card; on a
process-plane daemon it lives in a worker process, which never sees the
card.
"""

from __future__ import annotations

import pickle
import queue
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from ray_tpu_torch._private.ids import ActorID, ObjectID, TaskID
from ray_tpu_torch._private.log import get_logger
from ray_tpu_torch._private.object_server import PeerUnreachableError
from ray_tpu_torch._private import tracing
from ray_tpu_torch._private.serialization import SerializedObject
from ray_tpu_torch.exceptions import ActorDiedError, RayTaskError

log = get_logger(__name__)

_STOP = object()


# --------------------------------------------------------------- arg wiring
def wire_arg(router, v):
    """Driver-side wire form of one argument: plain values inline
    (serialized), refs whose bytes live on a node travel as pull-refs
    the host resolves node-side (the driver stays out of the data
    path). Waits for ref deps to be produced first."""
    from ray_tpu_torch._private.worker import ObjectRef

    ctx = router.worker.serialization_context
    if not isinstance(v, ObjectRef):
        return ("v", ctx.serialize(v).to_bytes())
    router._await_dep(v.object_id)
    ob = v.object_id.binary()
    with router._lock:
        owner = router._oid_owner.get(ob)
    if owner is not None and router._client_alive(owner):
        return ("r", ob)
    value = router.worker.get_object(v)
    return ("v", ctx.serialize(value).to_bytes())


def unwire_arg(worker, head, wired, owner=None):
    """Host-side inverse: deserialize an inline value, or resolve a
    ref's bytes through its OWNER (the calling driver — its router
    tracks the holder; ``owner`` = (owner_id, addr) from the actor-op
    payload), with the head's fallback directory behind it."""
    kind, data = wired
    if kind == "v":
        return worker.serialization_context.deserialize(
            SerializedObject.from_bytes(bytes(data)))
    oid = ObjectID(bytes(data))
    if not worker.store.is_ready(oid):
        resolver = getattr(worker, "owner_resolver", None)
        if resolver is not None:
            # Owner tuples are (owner_id, addr) project-wide.
            owner_id = owner[0] if owner else None
            owner_addr = tuple(owner[1]) if owner and owner[1] else None
            resolver.resolve(oid.binary(), owner_addr, owner_id)
        else:  # no resolver (bare runtime): legacy head-directory pull
            raw = head.object_pull(oid.binary())
            if raw is None:
                raise ValueError(
                    f"pull-ref {oid.hex()[:16]}… has no live owner")
            worker.store.put(oid, SerializedObject.from_bytes(raw))
    return worker.serialization_context.deserialize(worker.store.get(oid))


def _node_addr(node: dict) -> Optional[tuple]:
    addr = (node.get("status") or {}).get("_peer_addr")
    return (str(addr[0]), int(addr[1])) if addr else None


# ------------------------------------------------------- driver-side runtime
class RemoteActorRuntime:
    """Driver-side stand-in for an actor hosted on a node daemon.

    Duck-types the ``_ActorRuntime`` surface ``ActorHandle`` needs
    (``submit``/``dead``/``cls``/``terminate``/``join``), so the public
    handle type is one and the same for local and cluster actors.
    """

    is_remote = True

    def __init__(self, worker, actor_id: ActorID, cls, init_args,
                 init_kwargs, *, node: Optional[dict],
                 max_restarts: int = 0, max_concurrency=None,
                 actor_name: Optional[str] = None,
                 opts: Optional[dict] = None,
                 borrower: bool = False,
                 node_record: Optional[dict] = None,
                 registered_name: Optional[tuple] = None):
        import cloudpickle

        self.worker = worker
        self.head = worker.head_client
        self.router = worker.remote_router
        self.actor_id = actor_id
        self.cls = cls
        self.class_name = getattr(cls, "__name__", None) or (
            (node_record or {}).get("class_name") or "Actor")
        self.actor_name = actor_name
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.opts = dict(opts or {})
        self.max_restarts = int(max_restarts or 0)
        self.max_concurrency = max_concurrency
        self.restarts_used = 0
        self.dead = False
        self.death_cause: Optional[str] = None
        self.borrower = borrower
        self.incarnation = 0
        self.pid: Optional[int] = None
        self._lock = threading.Lock()
        self._seq = 0
        # Task ids must be caller-unique: the owner and every borrower
        # mint ids for the same actor, so derive from a per-runtime
        # random base instead of (actor_id, seq).
        self._task_base = TaskID.from_random()
        self._inflight: Dict[TaskID, List[ObjectID]] = {}
        self._relocate_misses = 0
        if registered_name is not None:
            # Known BEFORE the async create dispatches, so a creation
            # failure can release the cluster-wide name (no race with
            # the caller assigning it after construction).
            self._registered_name = registered_name
        if borrower:
            self._cls_bytes = (node_record or {}).get("cls") or b""
            self.node_client = node_record["node"]
            self.node_addr = tuple(node_record["addr"]) \
                if node_record.get("addr") else None
        else:
            self._cls_bytes = cloudpickle.dumps(cls)
            self.node_client = node["client_id"]
            self.node_addr = _node_addr(node)
        # One dispatch thread: creation and every method call ship in
        # submission order; ref-arg waits never block the caller.
        self._dispatch = ThreadPoolExecutor(
            max_workers=1,
            thread_name_prefix=f"remote-actor-{self.class_name}")
        if not borrower:
            self._dispatch.submit(self._do_create)
        self.router.watch_remote_actor(self)

    # ------------------------------------------------------------- transport
    def _node_call(self, payload: bytes):
        if self.node_addr is not None:
            try:
                return self.head.node_call(
                    self.node_addr, ("actor_op", payload))
            except PeerUnreachableError:
                pass  # fall back to the head-relayed control path
        return self.head.actor_push(self.node_client, payload)

    # -------------------------------------------------------------- creation
    def _do_create(self):
        try:
            wired_args = [wire_arg(self.router, a) for a in self.init_args]
            wired_kwargs = {k: wire_arg(self.router, v)
                            for k, v in self.init_kwargs.items()}
            payload = pickle.dumps({
                "op": "create",
                "actor_id": self.actor_id.binary(),
                "cls": self._cls_bytes,
                "args": wired_args,
                "kwargs": wired_kwargs,
                "max_concurrency": self.max_concurrency,
                "max_restarts": self.max_restarts,
                "runtime_target": self.opts.get("runtime"),
                "driver_id": self.head.client_id,
                "driver_addr": list(self.head._object_server.address),
                "name": self.class_name,
                "detached": self.opts.get("lifetime") == "detached",
            }, protocol=5)
            reply = self._node_call(payload)
            if isinstance(reply, dict):
                self.pid = reply.get("pid")
            self.head.actor_place(self.actor_id.binary(), {
                "node": self.node_client,
                "driver": self.head.client_id,
                "cls": self._cls_bytes,
                "class_name": self.class_name,
                "detached": self.opts.get("lifetime") == "detached",
            })
        except BaseException as exc:  # noqa: BLE001 — creation boundary
            # _die (not a bare flag): the cluster-wide name and any
            # placement record must release, or retries fail "name
            # already taken" for the life of this driver.
            self._die(f"remote actor creation failed: {exc!r}")

    # ------------------------------------------------------------ submission
    def submit(self, method_name: str, args, kwargs, num_returns: int,
               name: str):
        from ray_tpu_torch._private.worker import ObjectRef

        with self._lock:
            self._seq += 1
            task_id = TaskID.of(self._task_base, self._seq)
        return_ids = [ObjectID.for_task_return(task_id, i)
                      for i in range(num_returns)]
        refs = [ObjectRef(oid) for oid in return_ids]
        if self.dead:
            err = ActorDiedError(self.actor_id,
                                 self.death_cause or "actor is dead")
            for oid in return_ids:
                self.worker.store.put_error(oid, err)
            return refs
        self.router.register_external(task_id, self.node_client)
        with self._lock:
            self._inflight[task_id] = list(return_ids)
        trace_wire = tracing.inject()  # caller thread's ambient context
        if trace_wire is not None:
            tracing.register_task(task_id.binary(), trace_wire)
        self.worker.task_events.record(task_id, "PENDING_ACTOR_TASK",
                                       name=name)
        self._dispatch.submit(self._do_submit, task_id, method_name,
                              args, kwargs, return_ids, name, trace_wire)
        return refs

    def _do_submit(self, task_id: TaskID, method_name: str, args, kwargs,
                   return_ids, name: str, trace_wire=None):
        if self.dead:
            self._fail(return_ids, ActorDiedError(
                self.actor_id, self.death_cause or "actor is dead"))
            return
        try:
            wired_args = [wire_arg(self.router, a) for a in args]
            wired_kwargs = {k: wire_arg(self.router, v)
                            for k, v in kwargs.items()}
            fields = {
                "op": "submit",
                "actor_id": self.actor_id.binary(),
                "incarnation": self.incarnation,
                "method": method_name,
                "args": wired_args,
                "kwargs": wired_kwargs,
                "return_ids": [o.binary() for o in return_ids],
                "task_id": task_id.binary(),
                "name": name,
                "driver_id": self.head.client_id,
                # Owner identity: the host resolves arg locations and
                # pushes completion reports owner-direct with this.
                "driver_addr": list(self.head._object_server.address),
            }
            if trace_wire is not None:
                # actor_op hop carries the caller's trace context: the
                # hosting node's task-event bridge emits its spans.
                fields["trace"] = trace_wire
            payload = pickle.dumps(fields, protocol=5)
            self._node_call(payload)
        except BaseException as exc:  # noqa: BLE001 — dispatch boundary
            if isinstance(exc, (ActorDiedError, RayTaskError)):
                self._fail(return_ids, exc)
            else:
                self._fail(return_ids, ActorDiedError(
                    self.actor_id,
                    f"could not reach actor's node: {exc}"))

    def _fail(self, return_ids, err: BaseException):
        for oid in return_ids:
            if not self.worker.store.is_ready(oid):
                self.worker.store.put_error(oid, err)

    # --------------------------------------------------------- node watching
    def check_node(self, alive: set):
        """Called from the router's watch loop with the alive node set."""
        if self.dead:
            return
        self._prune_inflight()
        if self.node_client in alive:
            self._relocate_misses = 0
            return
        self._on_node_dead()

    def _prune_inflight(self):
        with self._lock:
            tids = list(self._inflight)
        for tid in tids:
            ev = self.router._done.get(tid)
            if ev is not None and ev.is_set():
                with self._lock:
                    self._inflight.pop(tid, None)

    def _on_node_dead(self):
        err = ActorDiedError(
            self.actor_id,
            f"node {self.node_client!r} hosting this actor died")
        with self._lock:
            inflight, self._inflight = dict(self._inflight), {}
        for oids in inflight.values():
            self._fail(oids, err)
        if self.borrower:
            # The owner may be re-placing the actor: re-resolve through
            # the placement directory for a while before declaring it
            # dead.
            try:
                rec = self.head.actor_locate(self.actor_id.binary())
            except Exception:  # noqa: BLE001 — head hiccup: retry later
                rec = None
            if rec is not None and rec.get("alive") \
                    and rec.get("node") != self.node_client:
                self.node_client = rec["node"]
                self.node_addr = tuple(rec["addr"]) if rec.get("addr") \
                    else None
                self._relocate_misses = 0
                return
            self._relocate_misses += 1
            if self._relocate_misses > 20:  # ~10 s of watcher ticks
                self.dead = True
                self.death_cause = str(err)
            return
        if self.restarts_used >= self.max_restarts:
            self._die(str(err))
            return
        node = self._choose_restart_node()
        if node is None:
            self._die(f"{err} and no surviving feasible node to restart "
                      f"on")
            return
        self.restarts_used += 1
        self.incarnation += 1
        self.node_client = node["client_id"]
        self.node_addr = _node_addr(node)
        # Fresh state on the new node (reference restart semantics).
        self._dispatch.submit(self._do_create)

    def _choose_restart_node(self) -> Optional[dict]:
        demand = self.router.actor_demand(self.opts)
        nodes = [n for n in self.router.nodes(refresh=True)
                 if n.get("alive") and n["client_id"] != self.node_client]
        feasible = [n for n in nodes if self.router._fits(n, demand)]
        if not feasible:
            return None
        return min(feasible, key=self.router._actor_load)

    def _die(self, cause: str):
        self.dead = True
        self.death_cause = cause
        try:
            self.head.actor_unplace(self.actor_id.binary())
        except Exception:  # noqa: BLE001 — head gone
            pass
        reg = getattr(self, "_registered_name", None)
        if reg is not None:
            try:
                self.head.actor_deregister(*reg)
            except Exception:  # noqa: BLE001
                pass

    # ------------------------------------------------------------- lifecycle
    def terminate(self, no_restart: bool = True):
        payload = pickle.dumps({
            "op": "kill",
            "actor_id": self.actor_id.binary(),
            "no_restart": bool(no_restart),
        }, protocol=5)
        if self.dead and no_restart:
            # Already marked dead DRIVER-side — but death marking is a
            # liveness inference (node briefly absent from membership),
            # not ground truth. Still push the node-side kill: a
            # false-positive death would otherwise orphan the hosted
            # actor on a live daemon forever (it counts as load, so an
            # autoscaler never reaps the node). Idempotent: a truly
            # dead node/actor ignores it.
            try:
                self._dispatch.submit(self._kill_quietly, payload)
            except RuntimeError:  # dispatch already shut down
                pass
            return
        if no_restart:
            err = ActorDiedError(self.actor_id, "killed via ray_tpu_torch.kill()")
            with self._lock:
                inflight, self._inflight = dict(self._inflight), {}
            self.dead = True
            self.death_cause = "killed via ray_tpu_torch.kill()"
            for oids in inflight.values():
                self._fail(oids, err)
            self._dispatch.submit(self._kill_quietly, payload)
            if not self.borrower:
                self._die(self.death_cause)
        else:
            # Node-local restart with fresh state: the host's runtime
            # respawns the worker process, consuming ITS restart budget —
            # mirrors the in-driver terminate(no_restart=False) path.
            self._dispatch.submit(self._kill_quietly, payload)

    def _kill_quietly(self, payload: bytes):
        try:
            self._node_call(payload)
        except Exception:  # noqa: BLE001 — node gone: nothing to kill
            pass

    def join(self, timeout=None):
        self._dispatch.shutdown(wait=False)


def resolve_or_borrow(worker, actor_id: ActorID):
    """One-stop runtime resolution: this driver's own runtime if it has
    one, else a borrower runtime from the placement directory (cached in
    ``worker.actors`` so repeated resolutions reuse one runtime)."""
    runtime = worker.actors.get(actor_id)
    if runtime is not None:
        return runtime
    if worker.head_client is None:
        return None
    runtime = borrow_placed_actor(worker, actor_id)
    if runtime is not None:
        worker.actors[actor_id] = runtime
    return runtime


def borrow_placed_actor(worker, actor_id: ActorID):
    """Resolve a cluster-placed actor into a borrower runtime (calls go
    direct to the hosting node; no lifetime ownership). None when the
    placement directory has no live record."""
    import cloudpickle

    head = worker.head_client
    if head is None or worker.remote_router is None:
        return None
    try:
        rec = head.actor_locate(actor_id.binary())
    except Exception:  # noqa: BLE001 — head unreachable
        return None
    if rec is None or not rec.get("alive"):
        return None
    cls = None
    if rec.get("cls"):
        try:
            cls = cloudpickle.loads(bytes(rec["cls"]))
        except Exception:  # noqa: BLE001 — class not importable here:
            cls = None  # the handle skips method validation
    return RemoteActorRuntime(
        worker, actor_id, cls, (), {},
        node=None, borrower=True, node_record=rec)


# --------------------------------------------------------- node-side hosting
class ActorHost:
    """Daemon-side end of the cluster actor plane: hosts actors in the
    node's local runtime (``_ActorRuntime`` — worker processes, node-
    local restarts) and serves create/submit/kill from remote drivers,
    direct or head-relayed."""

    def __init__(self, worker, head, on_owner_seen=None):
        self.worker = worker
        self.head = head
        # Hosting daemon's hook: actor ops carry the calling driver's
        # report address too, so actor-only nodes still learn where
        # their tail task events ship.
        self._on_owner_seen = on_owner_seen
        self._lock = threading.Lock()
        self._queues: Dict[bytes, "queue.Queue"] = {}
        self._owners: Dict[bytes, str] = {}     # actor_bin -> driver client
        self._detached: set = set()
        # Results pinned against store GC until the caller pulls them.
        # Lifecycle is time-based (callers pull promptly — ensure_local
        # fires on the task_done event), with a count cap as the memory
        # backstop; a FIFO-only cap could evict a not-yet-pulled result.
        from ray_tpu_torch._private.remote_router import EXTERNAL_PULL_TTL_S

        self._pinned: "OrderedDict[bytes, tuple]" = OrderedDict()
        # Coupled to the router's bounded pull-retry window: pins must
        # outlive the retries or gets fail before the bytes expire.
        self._pin_ttl_s = EXTERNAL_PULL_TTL_S
        self._pin_cap = 16384
        head._object_server.handlers["actor_op"] = self._on_direct
        head.handlers["actor_push"] = self._on_push
        self._sub = head.subscribe("ray_tpu_torch:node_events",
                                   self._on_node_event)

    # --------------------------------------------------------------- ingress
    def _on_direct(self, msg: tuple):
        return self.handle(pickle.loads(bytes(msg[1])))

    def _on_push(self, event: tuple):
        return self.handle(pickle.loads(bytes(event[1])))

    def handle(self, p: dict):
        if self._on_owner_seen is not None and p.get("driver_addr"):
            self._on_owner_seen(tuple(p["driver_addr"]),
                                p.get("driver_id"))
        op = p["op"]
        if op == "create":
            return self._create(p)
        if op == "submit":
            return self._enqueue_submit(p)
        if op == "kill":
            return self._kill(p)
        raise ValueError(f"unknown actor op {op!r}")

    # ---------------------------------------------------------------- create
    def _create(self, p: dict):
        import cloudpickle

        from ray_tpu_torch.actor import _ActorRuntime

        aid = ActorID(bytes(p["actor_id"]))
        cls = cloudpickle.loads(bytes(p["cls"]))
        owner = (p.get("driver_id"), p.get("driver_addr"))
        args = tuple(unwire_arg(self.worker, self.head, a, owner)
                     for a in p["args"])
        kwargs = {k: unwire_arg(self.worker, self.head, v, owner)
                  for k, v in p["kwargs"].items()}
        runtime = _ActorRuntime(
            aid, cls, args, kwargs,
            max_concurrency=p.get("max_concurrency"),
            max_restarts=int(p.get("max_restarts") or 0),
            name=p.get("name") or cls.__name__,
            actor_name=None,
            runtime_target=p.get("runtime_target"),
        )
        abin = aid.binary()
        with self._lock:
            old_q = self._queues.pop(abin, None)
            self.worker.actors[aid] = runtime
            self._owners[abin] = p["driver_id"]
            if p.get("detached"):
                self._detached.add(abin)
            q: "queue.Queue" = queue.Queue()
            self._queues[abin] = q
        if old_q is not None:
            old_q.put(_STOP)
        threading.Thread(
            target=self._dispatch_loop, args=(abin, q), daemon=True,
            name=f"actor-host-{p.get('name')}").start()
        return {"pid": runtime.pid}

    # ---------------------------------------------------------------- submit
    def _enqueue_submit(self, p: dict):
        abin = bytes(p["actor_id"])
        with self._lock:
            q = self._queues.get(abin)
        if q is None:
            raise ActorDiedError(
                ActorID(abin), "no such actor on this node")
        q.put(p)
        return "accepted"

    def _dispatch_loop(self, abin: bytes, q: "queue.Queue"):
        """Per-actor dispatcher: resolves args (which may pull bytes from
        other nodes) and submits to the runtime IN ARRIVAL ORDER, without
        blocking the connection thread."""
        while True:
            p = q.get()
            if p is _STOP:
                return
            try:
                self._dispatch_submit(p)
            except Exception as exc:  # errors already materialized
                log.debug("actor submit dispatch failed (error already "
                          "materialized to its refs): %r", exc)

    def _dispatch_submit(self, p: dict):
        aid = ActorID(bytes(p["actor_id"]))
        return_ids = [ObjectID(bytes(b)) for b in p["return_ids"]]
        driver_id = p["driver_id"]
        runtime = self.worker.actors.get(aid)
        try:
            if runtime is None or runtime.dead:
                raise ActorDiedError(
                    aid, getattr(runtime, "death_cause", None)
                    or "actor is not alive on this node")
            owner = (p.get("driver_id"), p.get("driver_addr"))
            args = tuple(unwire_arg(self.worker, self.head, a, owner)
                         for a in p["args"])
            kwargs = {k: unwire_arg(self.worker, self.head, v, owner)
                      for k, v in p["kwargs"].items()}
            if tracing._TRACER is not None and p.get("trace") is not None:
                # The caller's context rode the actor_op payload: this
                # node's task-event bridge emits the call's spans.
                tracing.register_task(bytes(p["task_id"]), p["trace"])
            refs = runtime.submit_prepared(
                p["method"], args, kwargs, return_ids, p["name"])
            self._pin(refs)
        except BaseException as exc:  # noqa: BLE001 — materialize + report
            err = exc if isinstance(exc, (ActorDiedError, RayTaskError)) \
                else RayTaskError.from_exception(p["name"], exc)
            for oid in return_ids:
                if not self.worker.store.is_ready(oid):
                    self.worker.store.put_error(oid, err)
        threading.Thread(
            target=self._report,
            args=(driver_id, p.get("driver_addr"), bytes(p["task_id"]),
                  return_ids),
            daemon=True, name="actor-host-report").start()

    def _pin(self, refs):
        import time as _time

        now = _time.monotonic()
        with self._lock:
            for r in refs:
                self._pinned[r.object_id.binary()] = (r, now)
            # Reap expired pins first; the cap only guards runaway load.
            while self._pinned:
                _, (_, ts) = next(iter(self._pinned.items()))
                if now - ts > self._pin_ttl_s \
                        or len(self._pinned) > self._pin_cap:
                    self._pinned.popitem(last=False)
                else:
                    break

    def _report(self, driver_id: str, driver_addr, task_bin: bytes,
                return_ids):
        """Send the completion event to the OWNING driver — direct to
        its object server first (the report carries the locations; the
        owner's directory serves later peer queries, the head stays
        untouched), head relay as the fallback (which records the
        locations server-side for the relayed consumer's pulls). Like
        the task plane's reports, small results ride INLINE and errors
        cross as pickled exceptions (no pullable bytes exist for them);
        big results stay pinned here and the driver pulls p2p on
        demand."""
        from ray_tpu_torch._private.node_daemon import completion_fields
        from ray_tpu_torch._private.object_server import PeerUnreachableError

        store = self.worker.store
        store.wait(return_ids, len(return_ids), timeout=None)
        sizes, errs, inline = completion_fields(
            store, return_ids, "actor task")
        oid_bins = [o.binary() for o in return_ids]
        done = pickle.dumps({
            "task_id": task_bin,
            "oid_bins": oid_bins,
            "node_client": self.head.client_id,
            "sizes": sizes,
            "errs": errs,
            "inline": inline,
        }, protocol=5)
        if driver_addr:
            try:
                self.head._peers.call(tuple(driver_addr),
                                      ("task_done", done))
                return
            except Exception as exc:  # noqa: BLE001 — NAT'd driver OR a
                # driver-side handler error: either way the relay below
                # must still record locations + deliver the completion.
                log.debug("direct actor task_done push failed; taking "
                          "the head relay: %r", exc)
        try:
            # Relay fallback: errored oids announce too, so a remote
            # consumer's pull raises the typed error instead of
            # retrying to a timeout.
            self.head.object_announce_many(oid_bins)
            self.head.task_done(driver_id, oid_bins, done)
        except Exception:  # noqa: BLE001 — driver/head gone: results stay
            pass

    # ------------------------------------------------------------------ kill
    def _kill(self, p: dict):
        aid = ActorID(bytes(p["actor_id"]))
        abin = aid.binary()
        no_restart = bool(p.get("no_restart", True))
        runtime = self.worker.actors.get(aid)
        if runtime is None:
            return None
        runtime.terminate(no_restart=no_restart)
        if no_restart:
            with self._lock:
                q = self._queues.pop(abin, None)
                self._owners.pop(abin, None)
                self._detached.discard(abin)
            self.worker.actors.pop(aid, None)
            if q is not None:
                q.put(_STOP)
        return None

    # ------------------------------------------------------- owner-death GC
    def _on_node_event(self, payload):
        """Kill hosted actors whose owning driver died (the head's
        monitor publishes every dead client here), unless detached."""
        if not isinstance(payload, dict) \
                or payload.get("event") != "node_dead":
            return
        dead_client = payload.get("client_id")
        with self._lock:
            doomed = [abin for abin, owner in self._owners.items()
                      if owner == dead_client
                      and abin not in self._detached]
        for abin in doomed:
            try:
                self._kill({"actor_id": abin, "no_restart": True})
            except Exception:  # noqa: BLE001 — already gone
                pass

    def shutdown(self):
        with self._lock:
            queues, self._queues = dict(self._queues), {}
        for q in queues.values():
            q.put(_STOP)
