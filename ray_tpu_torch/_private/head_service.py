"""Standalone control-plane service, the head process (counterpart of
``ray_tpu/_private/head_service.py``).

A separate OS process speaking the framed-msgpack transport
(``_private/transport.py``): HMAC-authenticated with a per-cluster random
token, no pickle in the envelope. Services:

- **KV**: cluster-global key/value.
- **Actor directory**: named actors registered by one driver are callable
  from another; calls relay head -> owning driver over that driver's
  multiplexed event channel.
- **Object directory**: owners announce object ids; remote drivers pull
  the serialized bytes peer to peer, or through the head in bounded
  chunks.
- **Node membership**: the ``node_register`` RPC, ``node_list`` and the
  ``ray_tpu:node_events`` topic, which node daemons
  (``_private/node_daemon.py``) join through.
- **Failure detection**: clients heartbeat; a monitor thread expires
  silent clients and collects their directory entries.
- **Fault tolerance**: the KV, the directories and the node registry
  persist to an append-log (``--state``) with compaction, a write fence
  (``flock``) and an epoch per incarnation; on restart the head replays
  it and surviving clients reconnect and resume. ``--standby-of`` runs a
  warm standby that promotes over the shared log.

- **Cluster metrics**: ``--metrics-port`` (``serve_cluster_metrics``)
  serves one Prometheus ``/metrics`` for the cluster: the head's own
  registry and every live node daemon's (pulled from its direct server,
  the event-channel relay as the fallback), each series tagged
  ``node``/``component``. A driver pulls the same with
  ``util.state.cluster_metrics()``.

Run ``python -m ray_tpu_torch._private.head_service --port 0 [--state
PATH]``: the first line of its output is ``ray_tpu_torch head listening
on HOST:PORT``; with ``--metrics-port`` the second is ``ray_tpu_torch head
metrics on HOST:PORT``. Drivers attach with ``ray_tpu_torch.init(address=
"HOST:PORT")``. The head process imports neither torch nor JAX.
"""

from __future__ import annotations

import argparse
import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

from ray_tpu_torch._private.log import get_logger
from ray_tpu_torch._private.transport import (
    FramedConnection,
    TokenListener,
    exc_to_wire,
    generate_token,
    pack,
    unpack,
    write_token,
)

log = get_logger(__name__)

try:
    import fcntl
except ImportError:  # pragma: no cover — non-POSIX: fence unavailable
    fcntl = None

DEFAULT_PORT = 6380

_HEARTBEAT_PERIOD_S = 0.5
# A warm standby probes the primary this often and promotes itself
# after this many consecutive failed probes.
_STANDBY_PROBE_PERIOD_S = 1.0
_STANDBY_MISSES_TO_PROMOTE = 3

# Estimated batchrep payloads above this ship as one small header frame
# plus one frame PER REPLY, so a batch of large replies (multi-MiB
# kv_get values etc.) can never assemble a single frame past MAX_FRAME.
_BATCHREP_SPLIT_BYTES = 128 << 20


def _reply_bytes_estimate(replies: list) -> int:
    """Top-level bytes fields dominate reply weight (values, chunks)."""
    return sum(
        64 + (len(r[1]) if isinstance(r, tuple) and len(r) > 1
              and isinstance(r[1], (bytes, bytearray, memoryview)) else 0)
        for r in replies)


def _client_timeout_s() -> float:
    from ray_tpu_torch._private.config import GlobalConfig

    return float(GlobalConfig.head_client_timeout_s)


class _EventChannel:
    """Head-side end of one client's event connection, multiplexed: many
    in-flight relayed requests tagged with request ids, replies matched by
    a reader thread. Replaces the one-in-flight-relay-per-owner lock."""

    def __init__(self, conn: FramedConnection):
        self.conn = conn
        self.alive = True
        self._rid = 0
        self._lock = threading.Lock()
        self._pending: Dict[int, list] = {}  # rid -> [Event, status, value]
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True, name="head-event-reader")
        self._reader.start()

    def _read_loop(self):
        try:
            while True:
                msg = self.conn.recv()
                if msg[0] != "rep":
                    continue
                _, rid, status, value = msg
                with self._lock:
                    slot = self._pending.pop(rid, None)
                if slot is not None:
                    slot[1], slot[2] = status, value
                    slot[0].set()
        except Exception as exc:  # channel gone
            self.fail_all(f"event channel closed: {exc!r}")

    def fail_all(self, why: str):
        self.alive = False
        with self._lock:
            pending, self._pending = dict(self._pending), {}
        for slot in pending.values():
            slot[1] = "err"
            slot[2] = {"type": "ConnectionError", "module": "builtins",
                       "message": why}
            slot[0].set()

    def notify(self, event: tuple) -> bool:
        """One-way push (pub/sub delivery): no request id, no reply."""
        if not self.alive:
            return False
        try:
            self.conn.send(("evt",) + event)
            return True
        except Exception as exc:  # noqa: BLE001
            self.fail_all(str(exc))
            return False

    def call(self, event: tuple, timeout: Optional[float] = None):
        if not self.alive:
            return ("err", {"type": "ConnectionError", "module": "builtins",
                            "message": "owner event channel is down"})
        slot = [threading.Event(), None, None]
        with self._lock:
            self._rid += 1
            rid = self._rid
            self._pending[rid] = slot
        try:
            self.conn.send(("req", rid) + event)
        except Exception as exc:  # noqa: BLE001
            with self._lock:
                self._pending.pop(rid, None)
            self.fail_all(str(exc))
            return ("err", exc_to_wire(ConnectionError(
                f"owner died mid-call: {exc}")))
        if not slot[0].wait(timeout):
            with self._lock:
                self._pending.pop(rid, None)
            return ("err", {"type": "TimeoutError", "module": "builtins",
                            "message": "relay timed out"})
        return (slot[1], slot[2])


class _Client:
    def __init__(self, client_id: str):
        self.client_id = client_id
        self.last_seen = time.monotonic()
        self.events: Optional[_EventChannel] = None
        self.alive = True
        self.is_node = False
        self.node_id: Optional[str] = None
        self.resources: Dict[str, float] = {}
        self.status: Dict[str, Any] = {}  # last heartbeat load report
        self.subs: set = set()  # pub/sub topics (re-asserted by heartbeat)
        self.peer_addr = None   # direct object-server (host, port)


class _StateLog:
    """Append-log persistence for the head's directories (GCS-FT role).

    Records are length-prefixed msgpack tuples. Replay stops at the first
    torn record (crash mid-write), which is safe: the log is replayed
    before serving, so the lost tail is at most the final in-flight op.

    Unbounded growth is handled by snapshot compaction: past a record
    threshold the head serializes its full state as one ``snapshot``
    record into a fresh file and atomically renames it over the log
    (``rewrite``), so a long-lived cluster's log stays proportional to
    its live state, not its history.

    Single-writer fence: opening the log takes an exclusive ``flock``
    on a sidecar ``<path>.lock`` (the sidecar, because compaction
    replaces the log's inode — a lock on the log fd itself would not
    cover the rewritten file). A standby promoting over the SHARED log
    therefore blocks here until the old primary's lock releases —
    which the kernel does only when that process actually exits — so a
    stalled-but-alive primary can never interleave appends with the
    promoted standby's (the split-brain fence). The lock
    is acquired BEFORE replay, so replay never races a dying writer's
    tail either.
    """

    _LEN = struct.Struct(">I")

    def __init__(self, path: str, lock_timeout: Optional[float] = None):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lockf = open(path + ".lock", "ab")
        self._acquire_fence(lock_timeout)
        self._f = open(path, "ab")
        self._lock = threading.Lock()
        self.appended = 0  # records since open/compaction
        # Lifetime append count (never reset by compaction): the
        # observable the ownership flatness gate watches — steady-state
        # object traffic must not grow this with object count.
        self.total_appended = 0

    def _acquire_fence(self, timeout: Optional[float]) -> None:
        """Exclusive writer lock; ``timeout=None`` waits for the prior
        writer to die (the standby-promotion semantics)."""
        if fcntl is None:
            return
        import errno

        deadline = None if timeout is None else time.monotonic() + timeout
        warned = False
        while True:
            try:
                fcntl.flock(self._lockf.fileno(),
                            fcntl.LOCK_EX | fcntl.LOCK_NB)
                return
            except OSError as exc:
                if exc.errno not in (errno.EWOULDBLOCK, errno.EAGAIN,
                                     errno.EACCES):
                    # Not "held by another writer" — e.g. ENOLCK on an
                    # NFS mount without lockd. Spinning forever would
                    # mask the real failure; surface it.
                    self._lockf.close()
                    raise
                if deadline is not None and time.monotonic() >= deadline:
                    self._lockf.close()
                    raise RuntimeError(
                        f"state log {self.path!r} is held by another "
                        f"live head process — refusing to serve over a "
                        f"fenced log") from None
                if not warned:
                    warned = True
                    print(f"ray_tpu_torch head waiting for state-log lock "
                          f"{self.path}.lock (prior writer still "
                          f"alive)", flush=True)
                time.sleep(0.2)

    def append(self, record: tuple):
        data = pack(record)
        with self._lock:
            self._f.write(self._LEN.pack(len(data)) + data)
            self._f.flush()
            self.appended += 1
            self.total_appended += 1

    def rewrite(self, snapshot: tuple):
        """Replace the log with a single snapshot record (compaction).
        Crash-safe: the snapshot is written to a temp file and renamed
        over the log only once fully flushed."""
        data = pack(snapshot)
        tmp = self.path + ".compact"
        with self._lock:
            with open(tmp, "wb") as f:
                f.write(self._LEN.pack(len(data)) + data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._f.close()
            self._f = open(self.path, "ab")
            self.appended = 0

    @staticmethod
    def replay(path: str):
        try:
            f = open(path, "rb")
        except OSError:
            return
        with f:
            while True:
                head = f.read(4)
                if len(head) < 4:
                    return
                (length,) = _StateLog._LEN.unpack(head)
                data = f.read(length)
                if len(data) < length:
                    return  # torn tail
                try:
                    yield unpack(data)
                except Exception as exc:  # corrupt record ends log
                    log.warning("corrupt state-log record ends replay "
                                "early: %r", exc)
                    return

    def close(self):
        with self._lock:
            self._f.close()
            try:
                self._lockf.close()  # releases the writer fence
            except OSError:
                pass


class HeadService:
    """The head process body: serve request connections, relay events."""

    def __init__(self, host: str = "127.0.0.1", port: int = DEFAULT_PORT,
                 token: Optional[str] = None,
                 state_path: Optional[str] = None):
        self._listener = TokenListener(host, port, None, site="head")
        self.host, self.port = self._listener.address
        # Token resolution order: explicit > env > this port's existing
        # token file (a restarted head MUST keep its token or surviving
        # clients cannot re-authenticate — GCS-FT requirement) > fresh.
        from ray_tpu_torch._private.transport import read_token_file

        token = (token or os.environ.get("RAY_TPU_CLUSTER_TOKEN")
                 or read_token_file(self.port) or generate_token())
        self._listener.set_token(token)
        self.token = token
        self.token_file = write_token(self.port, token)
        self._lock = threading.Lock()
        self._kv: Dict[bytes, bytes] = {}
        self._clients: Dict[str, _Client] = {}
        # name -> (client_id, actor_id_bin, class_name)
        self._actors: Dict[Tuple[str, str], Tuple[str, bytes, str]] = {}
        self._objects: Dict[bytes, str] = {}  # oid_bin -> owner client
        # Cluster actor placement (GcsActorManager role): actor_id ->
        # {"node": hosting client, "driver": owning client, "cls": bytes,
        #  "class_name": str, "detached": bool}.
        self._places: Dict[bytes, dict] = {}
        from ray_tpu_torch._private.config import GlobalConfig

        self._compact_threshold = int(
            GlobalConfig.head_log_compact_records)
        self._compact_pending = False
        self._log: Optional[_StateLog] = None
        # Head epoch (wire fence, the flock's twin): every boot over a
        # state log is a new incarnation — replay the highest epoch
        # seen, serve as epoch+1, and persist it. Promotion IS a boot
        # over the shared log, so the promoted standby's epoch strictly
        # exceeds the dead primary's; clients reject regressions, and a
        # fenced incarnation refuses every request (see _dispatch).
        self._replayed_epoch = 0
        self._fenced = False
        self.fenced_refusals = 0
        if state_path:
            # Fence FIRST (blocks until any prior writer is truly
            # dead), then replay: the log cannot grow a tail under us
            # between replay and serving.
            self._log = _StateLog(state_path)
            self._restore(state_path)
        self.epoch = self._replayed_epoch + 1
        if self._log is not None:
            self._persist("epoch", self.epoch)
        # Promotion/restart over existing state is an incident-worthy
        # lifecycle event: it lands in the flight ring when armed.
        if self._replayed_epoch > 0:
            log.warning("head serving epoch %d over replayed state "
                        "(promotion or restart)", self.epoch)
        # Batched control RPCs: a client's coalescer ships N requests in
        # one frame; sub-requests dispatch CONCURRENTLY here so a batch
        # of relays (task_push / task_done / chunk reads) overlaps their
        # round trips instead of serializing them.
        self._rpc_pool = ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="head-rpc")
        self._metrics_peers = None
        self._metrics_server = None
        self.batches_received = 0
        # Per-kind RPC counters (the ownership flatness observable:
        # steady-state object-plane kinds must stay O(membership), not
        # O(objects) — served over ``head_stats`` / ``/api/head``).
        self.rpc_counts: Dict[str, int] = {}
        # Live count of ``obj|`` directory subscriptions across clients
        # (kept in step with every c.subs mutation under self._lock):
        # the common zero-subscriber case makes announce-path object
        # events O(1) instead of an O(clients) scan.
        self._obj_sub_count = 0
        # Distributed tracing (RAY_TPU_TRACE in the env): the head
        # records its half of traced control hops (node joins) and
        # answers trace_dump; off = the usual one-branch inertness.
        from ray_tpu_torch._private import tracing as _tracing

        _tracing.install_from_env(component="head")
        # Flight recorder (RAY_TPU_FLIGHT / RAY_TPU_PROFILE): the head
        # answers debug_dump for itself and relays node_debug_dump /
        # node_flight_ctl for nodes a puller cannot dial directly.
        from ray_tpu_torch._private import flight as _flight

        rec = _flight.install_from_env(component="head")
        if rec is not None:
            rec.add_section("head", self._flight_head_section)
            if self._replayed_epoch > 0:
                # Failover/restart incident marker: the promoted head's
                # first bundle shows WHEN it took over and from which
                # incarnation.
                rec.record("head.promoted", {
                    "epoch": self.epoch,
                    "replayed_epoch": self._replayed_epoch})
        # Live request connections (shutdown closes them: a stopped
        # head must drop its clients so they fail over — an in-process
        # test promotion behaves like the SIGKILL it stands in for).
        self._conns: set = set()
        self._stop = threading.Event()
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True, name="head-monitor")
        self._monitor.start()

    def _flight_head_section(self) -> dict:
        """Head-plane state for the flight bundle: membership and the
        per-kind RPC profile (the O(membership) flatness observable)."""
        with self._lock:
            return {
                "epoch": self.epoch,
                "fenced": self._fenced,
                "rpc_counts": dict(self.rpc_counts),
                "batches_received": self.batches_received,
                "num_objects": len(self._objects),
                "clients_alive": sum(
                    1 for cl in self._clients.values() if cl.alive),
                "nodes_alive": sum(
                    1 for cl in self._clients.values()
                    if cl.is_node and cl.alive),
            }

    # -------------------------------------------------------------- FT/state
    def _restore(self, state_path: str):
        """Replay the append-log. Clients recorded in the log are revived
        optimistically (alive, fresh last_seen): survivors reconnect and
        heartbeat within the timeout window; truly-dead ones expire
        through the normal monitor path and their entries GC."""
        for rec in _StateLog.replay(state_path):
            op = rec[0]
            if op == "epoch":
                self._replayed_epoch = max(self._replayed_epoch,
                                           int(rec[1]))
                continue
            if op == "snapshot":
                # Full-state record from compaction: replaces everything
                # replayed so far (it IS the log's prefix after rewrite).
                # Arity-tolerant: pre-epoch snapshots carry 5 sections.
                kv, actors, objects, nodes, places = rec[1:6]
                if len(rec) > 6:
                    self._replayed_epoch = max(self._replayed_epoch,
                                               int(rec[6]))
                self._kv = {bytes(k): bytes(v) for k, v in kv}
                self._actors = {
                    (ns, name): (cid, bytes(abin), cls)
                    for ns, name, cid, abin, cls in actors}
                self._objects = {bytes(o): cid for o, cid in objects}
                self._places = {bytes(a): dict(r) for a, r in places}
                for cid in set(self._objects.values()) | {
                        v[0] for v in self._actors.values()}:
                    self._clients.setdefault(cid, _Client(cid))
                for cid, node_id, resources in nodes:
                    c = self._clients.setdefault(cid, _Client(cid))
                    c.is_node, c.node_id = True, node_id
                    c.resources = dict(resources)
                continue
            if op == "actor_place":
                self._places[bytes(rec[1])] = dict(rec[2])
                continue
            if op == "actor_unplace":
                self._places.pop(bytes(rec[1]), None)
                continue
            if op == "kv_put":
                self._kv[rec[1]] = rec[2]
            elif op == "kv_del":
                self._kv.pop(rec[1], None)
            elif op == "actor_register":
                _, ns, name, cid, abin, cls = rec
                self._actors[(ns, name)] = (cid, abin, cls)
                self._clients.setdefault(cid, _Client(cid))
            elif op == "actor_deregister":
                self._actors.pop((rec[1], rec[2]), None)
            elif op == "object_transfer_batch":
                for ob, holder in rec[1]:
                    self._objects[bytes(ob)] = holder
                    self._clients.setdefault(holder, _Client(holder))
            elif op == "object_announce":
                self._objects[rec[1]] = rec[2]
                self._clients.setdefault(rec[2], _Client(rec[2]))
            elif op == "object_forget":
                self._objects.pop(rec[1], None)
            elif op == "node_register":
                _, cid, node_id, resources = rec
                c = self._clients.setdefault(cid, _Client(cid))
                c.is_node, c.node_id = True, node_id
                c.resources = dict(resources)

    def _persist(self, *record):
        if self._log is not None:
            try:
                self._log.append(record)
                if self._log.appended >= self._compact_threshold:
                    # Compaction runs on the MONITOR thread, never inline:
                    # some persist sites hold self._lock, and _compact
                    # needs it (non-reentrant) for a consistent snapshot.
                    self._compact_pending = True
            except Exception:  # noqa: BLE001 — disk full: serve from memory
                pass

    def _compact(self):
        """Rewrite the append-log as one snapshot of current state.

        Snapshot build AND rewrite happen under self._lock: every state
        mutation also holds it, so any record a handler appends after we
        release is for a mutation the snapshot already contains — replay
        of snapshot + duplicate record is idempotent, and no mutation
        can fall between the snapshot and the rewrite."""
        with self._lock:
            snapshot = (
                "snapshot",
                [(k, v) for k, v in self._kv.items()],
                [(ns, name, cid, abin, cls)
                 for (ns, name), (cid, abin, cls) in self._actors.items()],
                [(o, cid) for o, cid in self._objects.items()],
                [(c.client_id, c.node_id, c.resources)
                 for c in self._clients.values() if c.is_node],
                [(a, r) for a, r in self._places.items()],
                self.epoch,
            )
            self._log.rewrite(snapshot)

    # ------------------------------------------------------------- serving
    def serve_forever(self):
        # Handshakes run in the per-connection threads: a peer that stalls
        # (or fails) its 5s handshake must not block new accepts.
        while not self._stop.is_set():
            try:
                conn = self._listener.accept_raw()
            except OSError:
                break
            threading.Thread(
                target=self._serve_conn, args=(conn,),
                daemon=True).start()

    def _serve_conn(self, conn: FramedConnection):
        try:
            self._listener.server_handshake(conn)
        except Exception:  # noqa: BLE001 — unauthenticated peer
            conn.close()
            return
        handed_off = False  # event channels belong to their reader
        try:
            hello = conn.recv()  # ("hello", client_id, role)
            _, client_id, role = hello
            with self._lock:
                c = self._clients.setdefault(client_id, _Client(client_id))
                c.last_seen = time.monotonic()
                c.alive = True
            if role == "event":
                # Head -> client push channel (multiplexed): the client
                # serves relayed actor calls / object reads / task pushes.
                old = c.events
                c.events = _EventChannel(conn)
                if old is not None:
                    old.fail_all("event channel replaced by reconnect")
                conn.send(("ok", {"epoch": self.epoch,
                                  "fenced": self._fenced}))
                handed_off = True
                return  # reader thread owns the connection now
            # Hello reply advertises this incarnation's epoch (and
            # whether it is already fenced): a client that saw a NEWER
            # head — or any client offered a fenced one — refuses the
            # connection (the wire half of the split-brain fence).
            conn.send(("ok", {"epoch": self.epoch,
                              "fenced": self._fenced}))
            with self._lock:
                self._conns.add(conn)
            while not self._stop.is_set():
                msg = conn.recv()
                if msg and msg[0] == "batch":
                    replies = self._dispatch_batch(client_id, msg[1])
                    if _reply_bytes_estimate(replies) > \
                            _BATCHREP_SPLIT_BYTES:
                        conn.send(("batchrep_split", len(replies)))
                        for r in replies:
                            conn.send(r)
                    else:
                        conn.send(("batchrep", replies))
                    continue
                reply = self._dispatch(client_id, msg)
                conn.send(reply)
        except (EOFError, OSError, ValueError):
            pass
        except Exception:  # noqa: BLE001 — connection error boundary
            pass
        finally:
            if not handed_off:
                with self._lock:
                    self._conns.discard(conn)
                conn.close()

    # ------------------------------------------------------------ dispatch
    def _dispatch_batch(self, client_id: str, msgs) -> list:
        """One coalesced frame of N requests: replies come back in
        request order, but sub-dispatch runs CONCURRENTLY (RPC pool /
        dedicated threads), so requests inside a batch may EXECUTE in
        any order. The invariant callers rely on: blocking `_request`
        users have at most one request in flight, and `_request_async`
        is reserved for order-independent requests (today: windowed
        object_chunk reads). Do not route order-sensitive request pairs
        through `_request_async`."""
        self.batches_received += 1
        msgs = list(msgs)
        if len(msgs) <= 1:
            return [self._dispatch(client_id, m) for m in msgs]

        def _spawn_unbounded(m):
            # actor_call relays wait for full method completion with NO
            # timeout — on the shared pool a few slow methods would
            # starve every client's bounded control traffic, so they
            # get dedicated threads (mirroring the client event loop).
            from concurrent.futures import Future

            f: Future = Future()

            def _run():
                try:
                    f.set_result(self._dispatch(client_id, m))
                except BaseException as exc:  # noqa: BLE001
                    f.set_exception(exc)

            threading.Thread(target=_run, daemon=True,
                             name="head-actor-relay").start()
            return f

        futures = [
            _spawn_unbounded(m) if (m and m[0] == "actor_call")
            else self._rpc_pool.submit(self._dispatch, client_id, m)
            for m in msgs]
        return [f.result() for f in futures]

    def _dispatch(self, client_id: str, msg: tuple):
        kind = msg[0]
        try:
            with self._lock:
                # Any traffic revives a marked-dead (or even pruned)
                # client — its directory entries may already be GC'd, but
                # KV/lookup service resumes, and a reconnecting event
                # channel re-enables relays.
                c = self._clients.setdefault(client_id, _Client(client_id))
                c.last_seen = time.monotonic()
                c.alive = True
                self.rpc_counts[kind] = self.rpc_counts.get(kind, 0) + 1
            if self._fenced and kind != "heartbeat":
                # Fenced incarnation: a newer head is serving. Refuse
                # EVERYTHING (reads too — our directories are stale) so
                # clients fail over; heartbeats still answer, carrying
                # the regressed epoch that triggers their re-dial.
                from ray_tpu_torch.exceptions import HeadFailedOverError

                self.fenced_refusals += 1
                return ("err", exc_to_wire(HeadFailedOverError(
                    f"head epoch {self.epoch} is fenced (a promoted "
                    f"head superseded it) — re-dial the address list",
                    epoch=self.epoch)))
            if kind == "heartbeat":
                if len(msg) > 1 and isinstance(msg[1], dict):
                    with self._lock:
                        c.status = msg[1]
                        # Subscriptions piggyback on heartbeats so they
                        # survive a head restart (the state log does not
                        # persist them; the owner re-asserts).
                        subs = msg[1].get("_subs")
                        if subs is not None:
                            new = set(subs)
                            self._obj_sub_count += \
                                self._count_obj_subs(new) - \
                                self._count_obj_subs(c.subs)
                            c.subs = new
                        addr = msg[1].get("_peer_addr")
                        if addr is not None:
                            c.peer_addr = (str(addr[0]), int(addr[1]))
                    # Epoch gossip: a client reporting a NEWER head has
                    # seen our successor — we lost a promotion race (or
                    # un-wedged after one). Fence this incarnation: all
                    # further requests refuse typed so stale
                    # connections fail over instead of writing here.
                    seen = msg[1].get("_epoch")
                    if isinstance(seen, int) and seen > self.epoch \
                            and not self._fenced:
                        self._fenced = True
                        log.warning(
                            "head epoch %d fenced: client %s reports a "
                            "promoted head at epoch %d — refusing all "
                            "further requests", self.epoch, client_id,
                            seen)
                        from ray_tpu_torch._private import flight as _flight

                        rec2 = _flight.recorder()
                        if rec2 is not None:
                            rec2.record("head.fenced", {
                                "epoch": self.epoch,
                                "superseded_by": seen})
                # The heartbeat reply carries the serving epoch even
                # when fenced: the client sees the regression and
                # re-dials instead of trusting a healthy-looking
                # connection to a dead incarnation.
                return ("ok", {"epoch": self.epoch,
                               "fenced": self._fenced})
            if kind == "subscribe":
                with self._lock:
                    if msg[1] not in c.subs:
                        c.subs.add(msg[1])
                        if msg[1].startswith("obj|"):
                            self._obj_sub_count += 1
                return ("ok", None)
            if kind == "unsubscribe":
                with self._lock:
                    if msg[1] in c.subs:
                        c.subs.discard(msg[1])
                        if msg[1].startswith("obj|"):
                            self._obj_sub_count -= 1
                return ("ok", None)
            if kind == "publish":
                _, topic, payload = msg
                return ("ok", self._publish(topic, payload))
            if kind == "kv_put":
                _, key, value, overwrite = msg
                with self._lock:
                    if not overwrite and key in self._kv:
                        return ("ok", False)
                    self._kv[key] = value
                self._persist("kv_put", key, value)
                return ("ok", True)
            if kind == "kv_get":
                with self._lock:
                    return ("ok", self._kv.get(msg[1]))
            if kind == "kv_del":
                with self._lock:
                    existed = self._kv.pop(msg[1], None) is not None
                if existed:
                    self._persist("kv_del", msg[1])
                return ("ok", existed)
            if kind == "kv_keys":
                with self._lock:
                    return ("ok", [k for k in self._kv
                                   if k.startswith(msg[1])])
            if kind == "actor_register":
                _, namespace, name, actor_bin, class_name = msg
                with self._lock:
                    existing = self._actors.get((namespace, name))
                    # Re-registration by the SAME owner is a reconcile
                    # (failover re-join, not a name conflict): the
                    # owner's live truth overwrites the replayed entry.
                    if existing is not None \
                            and existing[0] != client_id \
                            and self._is_alive(existing[0]):
                        return ("err", exc_to_wire(ValueError(
                            f"actor name {name!r} already taken in "
                            f"namespace {namespace!r}")))
                    self._actors[(namespace, name)] = (
                        client_id, actor_bin, class_name)
                self._persist("actor_register", namespace, name, client_id,
                              actor_bin, class_name)
                return ("ok", None)
            if kind == "actor_deregister":
                _, namespace, name = msg
                with self._lock:
                    entry = self._actors.get((namespace, name))
                    removed = entry is not None and entry[0] == client_id
                    if removed:
                        del self._actors[(namespace, name)]
                if removed:  # persist OUTSIDE the lock (compaction path)
                    self._persist("actor_deregister", namespace, name)
                return ("ok", None)
            if kind == "actor_lookup":
                _, namespace, name = msg
                with self._lock:
                    entry = self._actors.get((namespace, name))
                    if entry is None or not self._is_alive(entry[0]):
                        return ("ok", None)
                    return ("ok", entry)
            if kind == "actor_call":
                # Relay to the owning driver's event channel and wait.
                _, owner_id, actor_bin, method, args_bytes, num_returns = msg
                return self._relay(owner_id, (
                    "actor_call", actor_bin, method, args_bytes,
                    num_returns))
            if kind == "actor_place":
                # Record where a cluster actor lives (GcsActorManager
                # placement directory). The placing driver owns the
                # record; the hosting node serves the calls.
                _, actor_bin, record = msg
                with self._lock:
                    self._places[actor_bin] = dict(record)
                self._persist("actor_place", actor_bin, dict(record))
                return ("ok", None)
            if kind == "actor_unplace":
                with self._lock:
                    existed = self._places.pop(msg[1], None) is not None
                if existed:
                    self._persist("actor_unplace", msg[1])
                return ("ok", existed)
            if kind == "actor_locate":
                _, actor_bin = msg
                with self._lock:
                    rec = self._places.get(actor_bin)
                    if rec is None:
                        return ("ok", None)
                    node = self._clients.get(rec.get("node"))
                    alive = node is not None and node.alive
                    addr = node.peer_addr if node is not None else None
                return ("ok", dict(rec, alive=alive,
                                   addr=list(addr) if addr else None))
            if kind == "actor_push":
                # Control-plane fallback for actor ops when the driver
                # cannot dial the node's direct server (NAT): relay over
                # the node's event channel like task_push.
                _, target_client, payload = msg
                return self._relay(target_client, ("actor_push", payload),
                                   timeout=60.0)
            if kind == "object_announce":
                with self._lock:
                    self._objects[msg[1]] = client_id
                self._persist("object_announce", msg[1], client_id)
                self._publish_object_event(msg[1])
                return ("ok", None)
            if kind == "object_transfer_batch":
                # Lease handoff (ownership model): an exiting OWNER
                # delegates its location table — each entry names the
                # HOLDER of the bytes, not the announcing client, so the
                # entry lives and GCs with the holding node. Bulk: one
                # frame and ONE log record per batch, not per entry (the
                # head's handoff cost is O(batches)).
                _, entries = msg
                accepted = []
                with self._lock:
                    for ob, holder in entries:
                        if holder in self._clients:
                            self._objects[ob] = holder
                            accepted.append((ob, holder))
                if accepted:
                    self._persist("object_transfer_batch", accepted)
                    for ob, _holder in accepted:
                        # O(1) no-subscriber gate inside — a waiter of a
                        # transferred entry wakes event-driven.
                        self._publish_object_event(ob)
                return ("ok", len(accepted))
            if kind == "head_stats":
                # Steady-state observability: per-kind RPC counts and
                # FT-log appends — the production surface behind the
                # "head stays O(membership)" flatness claim.
                with self._lock:
                    counts = dict(self.rpc_counts)
                    num_objects = len(self._objects)
                    clients_alive = sum(
                        1 for cl in self._clients.values() if cl.alive)
                    nodes_alive = sum(
                        1 for cl in self._clients.values()
                        if cl.is_node and cl.alive)
                state_log = self._log
                return ("ok", {
                    "epoch": self.epoch,
                    "fenced": self._fenced,
                    "fenced_refusals": self.fenced_refusals,
                    "rpc_counts": counts,
                    "rpc_total": sum(counts.values()),
                    "object_plane_rpcs": sum(
                        counts.get(k, 0) for k in (
                            "object_announce", "object_transfer_batch",
                            "object_locate", "object_pull",
                            "object_meta", "object_chunk",
                            "object_meta_from", "object_chunk_from")),
                    "log_appends": (state_log.total_appended
                                    if state_log is not None else 0),
                    "log_records_live": (state_log.appended
                                         if state_log is not None else 0),
                    "batches_received": self.batches_received,
                    "num_objects": num_objects,
                    "clients_alive": clients_alive,
                    "nodes_alive": nodes_alive,
                })
            # Object reads are bounded-latency relays: a wedged owner must
            # not hang the pulling client's request thread forever (actor
            # calls stay unbounded — long-running methods are legitimate).
            if kind == "object_pull":
                _, oid_bin = msg
                owner = self._object_owner(oid_bin)
                if owner is None:
                    return ("ok", None)
                return self._relay(owner, ("object_get", oid_bin),
                                   timeout=60.0)
            if kind == "object_locate":
                # Location service for the direct data plane: who owns
                # it, and where their object server listens. The bytes
                # then move peer-to-peer, not through this process.
                _, oid_bin = msg
                owner = self._object_owner(oid_bin)
                if owner is None:
                    return ("ok", None)
                with self._lock:
                    c2 = self._clients.get(owner)
                    addr = c2.peer_addr if c2 is not None else None
                return ("ok", {"owner": owner,
                               "addr": list(addr) if addr else None})
            if kind == "object_meta":
                _, oid_bin = msg
                owner = self._object_owner(oid_bin)
                if owner is None:
                    return ("ok", None)
                return self._relay(owner, ("object_meta", oid_bin),
                                   timeout=60.0)
            if kind == "object_meta_from":
                # Relay-from-named-holder family (ownership model): the
                # OWNER already resolved the location — the head only
                # moves the bytes for peers that cannot dial the holder
                # directly (NAT, poisoned lanes). No directory lookup.
                _, holder, oid_bin = msg
                if not self._is_alive(holder):
                    return ("ok", None)
                return self._relay(holder, ("object_meta", oid_bin),
                                   timeout=60.0)
            if kind == "object_chunk_from":
                _, holder, oid_bin, offset, length = msg
                if not self._is_alive(holder):
                    return ("ok", None)
                return self._relay(
                    holder, ("object_chunk", oid_bin, offset, length),
                    timeout=60.0)
            if kind == "object_chunk":
                _, oid_bin, offset, length = msg
                owner = self._object_owner(oid_bin)
                if owner is None:
                    return ("ok", None)
                return self._relay(
                    owner, ("object_chunk", oid_bin, offset, length),
                    timeout=60.0)
            if kind == "node_register":
                _, node_id, resources = msg[:3]
                with self._lock:
                    c.is_node = True
                    c.node_id = node_id
                    c.resources = dict(resources)
                self._persist("node_register", client_id, node_id,
                              dict(resources))
                if len(msg) > 3 and msg[3] is not None:
                    # Traced cold start: the launched node carried its
                    # trace context here — the head records the JOIN
                    # hop (launch → join → replica init → first token).
                    from ray_tpu_torch._private import tracing as _tracing

                    _tracing.event(
                        "node.join", ctx=_tracing.extract(msg[3]),
                        component="head", client=client_id,
                        node_id=node_id)
                self._publish("ray_tpu:node_events", {
                    "event": "node_added", "client_id": client_id,
                    "node_id": node_id, "resources": dict(resources)})
                return ("ok", None)
            if kind == "trace_dump":
                from ray_tpu_torch._private import tracing as _tracing

                t = _tracing.tracer()
                tid = msg[1] if len(msg) > 1 else ""
                if isinstance(tid, bytes):
                    tid = tid.decode()
                if len(msg) > 2 and msg[2]:
                    return ("ok", t.trace_index(include_dir=False)
                            if t is not None else {})
                return ("ok", t.dump(trace_id=tid or None,
                                     include_dir=False)
                        if t is not None else [])
            if kind == "node_trace_dump":
                target_client, tid = msg[1], msg[2]
                if not self._is_alive(target_client):
                    return ("ok", [])
                relayed = ("trace_dump", tid, True) \
                    if len(msg) > 3 and msg[3] else ("trace_dump", tid)
                return self._relay(target_client, relayed, timeout=15.0)
            if kind == "debug_dump":
                from ray_tpu_torch._private import flight as _flight
                from ray_tpu_torch.util.metrics import (
                    refresh_framework_metrics,
                )

                # worker=None: the head has no scheduler/store, but
                # its flight/trace gauges still refresh so the bundle
                # snapshot is current (the node handler's twin).
                refresh_framework_metrics(None)
                return ("ok", _flight.local_bundle() or {})
            if kind == "node_debug_dump":
                _, target_client = msg
                if not self._is_alive(target_client):
                    return ("ok", {})
                return self._relay(target_client, ("debug_dump",),
                                   timeout=30.0)
            if kind == "flight_ctl":
                # The head's OWN sampler (it is not a node — nothing
                # else can toggle it).
                from ray_tpu_torch._private import flight as _flight

                return ("ok", {"running": bool(
                    _flight.set_profiling(bool(msg[2])))})
            if kind == "node_flight_ctl":
                _, target_client, on = msg
                if not self._is_alive(target_client):
                    return ("ok", {})
                return self._relay(
                    target_client, ("flight_ctl", "profile", bool(on)),
                    timeout=15.0)
            if kind == "node_metrics_dump":
                _, target_client = msg
                if not self._is_alive(target_client):
                    return ("ok", "")
                return self._relay(target_client, ("metrics_dump",),
                                   timeout=15.0)
            if kind == "node_list":
                # peer_addr is the node's direct request/object server —
                # drivers dial it once and push task batches peer-to-peer
                # (direct dispatch), with task_push relay as the fallback.
                with self._lock:
                    return ("ok", [
                        {"client_id": cl.client_id, "node_id": cl.node_id,
                         "resources": cl.resources, "alive": cl.alive,
                         "status": cl.status,
                         "peer_addr": (list(cl.peer_addr)
                                       if cl.peer_addr else None)}
                        for cl in self._clients.values() if cl.is_node])
            if kind == "task_push":
                _, target_client, payload = msg
                return self._relay(target_client, ("task_push", payload),
                                   timeout=60.0)
            if kind == "node_drain":
                # Drain-before-reap (autoscaler -> node): the target
                # cordons itself, finishes in-flight work, and
                # lease-transfers held bytes before its reaper
                # terminates the process. Bounded: a wedged node must
                # not pin the autoscaler's monitor.
                _, target_client, timeout_s = msg
                return self._relay(
                    target_client, ("node_drain", float(timeout_s)),
                    timeout=float(timeout_s) + 10.0)
            if kind == "task_done":
                # Node -> head -> submitting driver (the RELAY fallback
                # — steady-state completions go node->driver direct and
                # never touch this). Record result object locations
                # first so the driver's pull finds an owner even if it
                # races the relay.
                _, driver_id, oid_bins, payload = msg
                with self._lock:
                    for ob in oid_bins:
                        self._objects[ob] = client_id
                for ob in oid_bins:
                    self._persist("object_announce", ob, client_id)
                    self._publish_object_event(ob)
                return self._relay(driver_id, ("task_done", payload),
                                   timeout=30.0)
            if kind == "demand_report":
                # Autoscaler's view: every live client's heartbeat status
                # (backlog, unmet resource shapes) + node resources.
                with self._lock:
                    return ("ok", [
                        {"client_id": cl.client_id, "is_node": cl.is_node,
                         "node_id": cl.node_id, "alive": cl.alive,
                         "resources": cl.resources, "status": cl.status}
                        for cl in self._clients.values() if cl.alive])
            if kind == "cluster_info":
                with self._lock:
                    return ("ok", {
                        "clients": sorted(
                            cid for cid, cl in self._clients.items()
                            if cl.alive),
                        "nodes": sorted(
                            cl.node_id for cl in self._clients.values()
                            if cl.is_node and cl.alive),
                        "named_actors": sorted(
                            n for (_, n) in self._actors),
                        "num_objects": len(self._objects),
                    })
            return ("err", exc_to_wire(ValueError(
                f"unknown request {kind!r}")))
        except Exception as exc:  # noqa: BLE001 — dispatch boundary
            return ("err", exc_to_wire(exc))

    @staticmethod
    def _count_obj_subs(subs) -> int:
        return sum(1 for t in subs if t.startswith("obj|"))

    def _publish_object_event(self, oid_bin: bytes) -> None:
        """Wake directory subscribers of one object (``obj|<hex>``
        topic): the event-driven edge of the fallback directory — a
        client waiting out a foreign ref re-pulls on announce/transfer
        instead of polling the head. No subscriber anywhere, no work
        (one counter read — the announce hot path of the rollback mode
        must not pay an O(clients) scan per object)."""
        if self._obj_sub_count <= 0:
            return
        try:
            self._publish("obj|" + bytes(oid_bin).hex(), True)
        except Exception:  # noqa: BLE001 — wakeups are best-effort;
            pass           # waiters re-check at their deadline anyway

    def _publish(self, topic: str, payload) -> int:
        """Fan a message out to every live subscriber of `topic`
        (general pub/sub — the GCS publisher role). Delivery is
        at-most-once over the event channels; returns the count pushed."""
        with self._lock:
            targets = [c.events for c in self._clients.values()
                       if c.alive and topic in c.subs
                       and c.events is not None and c.events.alive]
        return sum(1 for ev in targets if ev.notify((topic, payload)))

    def _object_owner(self, oid_bin: bytes) -> Optional[str]:
        with self._lock:
            owner = self._objects.get(oid_bin)
        if owner is None or not self._is_alive(owner):
            return None
        return owner

    def _is_alive(self, client_id: str) -> bool:
        c = self._clients.get(client_id)
        return c is not None and c.alive

    def _relay(self, owner_id: str, event: tuple,
               timeout: Optional[float] = None):
        with self._lock:
            c = self._clients.get(owner_id)
            events = c.events if c is not None else None
        if c is None or not c.alive or events is None or not events.alive:
            return ("err", exc_to_wire(ConnectionError(
                f"owner {owner_id!r} is not reachable")))
        return events.call(event, timeout=timeout)

    # ------------------------------------------------------------- monitor
    def _monitor_loop(self):
        timeout_s = _client_timeout_s()
        while not self._stop.wait(_HEARTBEAT_PERIOD_S):
            if self._compact_pending and self._log is not None:
                self._compact_pending = False
                try:
                    self._compact()
                except Exception as exc:  # disk trouble: keep the log
                    log.warning("state-log compaction failed; appending "
                                "to the uncompacted log: %r", exc)
            now = time.monotonic()
            newly_dead = []
            with self._lock:
                for c in self._clients.values():
                    if c.alive and now - c.last_seen > timeout_s:
                        c.alive = False  # failure detection
                        newly_dead.append((c.client_id, c.node_id))
                # GC directory entries owned by dead clients.
                dead = {cid for cid, c in self._clients.items()
                        if not c.alive}
                dropped_actors = [k for k, v in self._actors.items()
                                  if v[0] in dead]
                for key in dropped_actors:
                    del self._actors[key]
                dropped_objects = [o for o, owner in self._objects.items()
                                   if owner in dead]
                for oid in dropped_objects:
                    del self._objects[oid]
                # Placement records die with their hosting node (the
                # owning driver re-places survivors) or with their owning
                # driver (unless detached).
                dropped_places = [
                    a for a, r in self._places.items()
                    if r.get("node") in dead
                    or (r.get("driver") in dead and not r.get("detached"))]
                for a in dropped_places:
                    del self._places[a]
                # Prune long-dead clients entirely (a long-lived head
                # serving churning drivers must not grow without bound).
                for cid in [cid for cid, c in self._clients.items()
                            if not c.alive
                            and now - c.last_seen > 6 * timeout_s]:
                    c = self._clients.pop(cid)
                    self._obj_sub_count -= self._count_obj_subs(c.subs)
                    if c.events is not None:
                        c.events.fail_all("client pruned")
                        try:
                            c.events.conn.close()
                        except OSError:
                            pass
            for ns, name in dropped_actors:
                self._persist("actor_deregister", ns, name)
            for a in dropped_places:
                self._persist("actor_unplace", a)
            for oid in dropped_objects:
                self._persist("object_forget", oid)
            for cid, node_id in newly_dead:
                self._publish("ray_tpu:node_events", {
                    "event": "node_dead", "client_id": cid,
                    "node_id": node_id})

    def shutdown(self):
        self._stop.set()
        self._listener.close()
        # Drop every live client connection (request AND event planes):
        # surviving clients must observe the death and fail over, not
        # keep talking to a stopped head's lingering sockets.
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
            events = [c.events for c in self._clients.values()
                      if c.events is not None]
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        for ev in events:
            ev.fail_all("head shut down")
            try:
                ev.conn.close()
            except OSError:
                pass
        self._rpc_pool.shutdown(wait=False, cancel_futures=True)
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server.server_close()
        if self._metrics_peers is not None:
            self._metrics_peers.close()
        if self._log is not None:
            self._log.close()

    # ------------------------------------------------------ cluster metrics
    def serve_cluster_metrics(self, host: str = "127.0.0.1",
                              port: int = 0):
        """One Prometheus surface for the whole cluster: GET /metrics
        scrapes this head's registry plus every live node's (direct
        object-server pull, event-channel relay fallback), each series
        relabeled with ``node``/``component`` tags. Returns the (host,
        port) bound."""
        import http.server

        from ray_tpu_torch._private.object_server import PeerPool
        from ray_tpu_torch.util.metrics import Gauge

        # Made here, once: the handler runs on a thread per request, and
        # made there lazily it would race (duplicate gauge families, a
        # second PeerPool's sockets).
        self._m_rpc_total = Gauge(
            "ray_tpu_head_rpc_total",
            "Total control RPCs this head has served")
        self._m_nodes_alive = Gauge(
            "ray_tpu_head_nodes_alive", "Live node daemons")
        self._metrics_peers = PeerPool(self.token)
        svc = self

        class _MetricsHandler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path != "/metrics":
                    self.send_response(404)
                    self.end_headers()
                    return
                body = svc._cluster_metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._metrics_server = http.server.ThreadingHTTPServer(
            (host, port), _MetricsHandler)
        threading.Thread(
            target=self._metrics_server.serve_forever, daemon=True,
            name="ray_tpu_torch_head_metrics").start()
        return self._metrics_server.server_address[:2]

    def _cluster_metrics_text(self) -> str:
        from ray_tpu_torch.util.metrics import (
            export_prometheus,
            merge_prometheus,
            relabel_prometheus,
        )

        with self._lock:
            self._m_rpc_total.set(float(sum(self.rpc_counts.values())))
            nodes = [(c.client_id, c.peer_addr)
                     for c in self._clients.values()
                     if c.is_node and c.alive]
        self._m_nodes_alive.set(float(len(nodes)))
        parts = [relabel_prometheus(
            export_prometheus(), {"node": "head", "component": "head"})]

        def scrape_one(item):
            cid, addr = item
            if addr is not None:
                try:
                    return self._metrics_peers.call(
                        tuple(addr), ("metrics_dump",))
                except Exception as exc:  # noqa: BLE001 — dead dial
                    log.debug("direct metrics scrape of %s failed; "
                              "trying the relay: %r", cid, exc)
            try:
                status, text = self._relay(
                    cid, ("metrics_dump",), timeout=5.0)
                return text if status == "ok" else None
            except Exception as exc:  # noqa: BLE001 — node mid-death
                log.debug("relayed metrics scrape of %s failed; "
                          "node skipped this scrape: %r", cid, exc)
                return None

        if nodes:
            # Concurrent: unreachable nodes cost one dial and relay
            # window together, not one each.
            with ThreadPoolExecutor(
                    max_workers=min(8, len(nodes)),
                    thread_name_prefix="head-metrics-scrape") as pool:
                texts = list(pool.map(scrape_one, nodes))
            for (cid, _addr), text in zip(nodes, texts):
                if text:
                    parts.append(relabel_prometheus(
                        str(text), {"node": cid, "component": "node"}))
        return merge_prometheus(parts)


def run_standby(primary: str, token: str,
                probe_period_s: Optional[float] = None,
                misses_to_promote: Optional[int] = None) -> None:
    """Warm-standby loop (GCS-FT replicated-head role): probe the
    primary's request channel; after `misses_to_promote` consecutive
    failures, return so the caller promotes this process to a serving
    head over the SHARED state log. Clients configured with
    ``address="primary,standby"`` fail over on their next dial. The
    probe cadence defaults to _STANDBY_PROBE_PERIOD_S and
    _STANDBY_MISSES_TO_PROMOTE — the blackout bound is roughly probes x
    period + promotion replay."""
    import uuid

    from ray_tpu_torch._private.transport import connect as _connect

    if probe_period_s is None:
        probe_period_s = _STANDBY_PROBE_PERIOD_S
    if misses_to_promote is None:
        misses_to_promote = _STANDBY_MISSES_TO_PROMOTE
    host, _, port = primary.rpartition(":")
    misses = 0
    probe_id = f"standby-{uuid.uuid4().hex[:8]}"
    while misses < misses_to_promote:
        time.sleep(probe_period_s)
        try:
            conn = _connect(host or "127.0.0.1", int(port), token,
                            timeout=2.0)
            conn.send(("hello", probe_id, "request"))
            conn.recv()
            conn.close()
            misses = 0
        except ConnectionError as exc:
            if "token mismatch" in str(exc):
                # The primary is ALIVE and rejected our token: promoting
                # would split-brain the shared log with two writers.
                raise SystemExit(
                    "standby token does not match the primary's cluster "
                    "token — refusing to promote") from exc
            misses += 1
        except Exception as exc:  # primary unreachable
            log.debug("standby probe missed the primary (%d): %r",
                      misses + 1, exc)
            misses += 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=DEFAULT_PORT)
    ap.add_argument("--state", default=None,
                    help="append-log path for head fault tolerance")
    ap.add_argument("--token", default=None)
    ap.add_argument("--standby-of", default=None, metavar="HOST:PORT",
                    help="run as a warm standby: serve only after this "
                         "primary (sharing --state) stops answering")
    ap.add_argument("--metrics-port", type=int, default=-1,
                    help="cluster Prometheus scrape endpoint: the head "
                         "pulls every live node's registry and serves "
                         "the merged, node-tagged series on /metrics "
                         "(0 = any free port, -1 = disabled)")
    args = ap.parse_args(argv)
    if args.standby_of:
        token = (args.token or os.environ.get("RAY_TPU_CLUSTER_TOKEN"))
        if not token or not args.state:
            raise SystemExit(
                "--standby-of needs --state (the shared log) and an "
                "explicit token (--token / RAY_TPU_CLUSTER_TOKEN)")
        print(f"ray_tpu_torch head standing by for {args.standby_of}",
              flush=True)
        run_standby(args.standby_of, token)
        print("ray_tpu_torch standby promoting: primary unreachable",
              flush=True)
    svc = HeadService(args.host, args.port, token=args.token,
                      state_path=args.state)
    # Port on stdout so launchers with --port 0 can discover it (FIRST
    # line — existing launchers readline() exactly once for it).
    print(f"ray_tpu_torch head listening on {svc.host}:{svc.port}",
          flush=True)
    if args.metrics_port >= 0:
        mhost, mport = svc.serve_cluster_metrics(
            args.host, args.metrics_port)
        print(f"ray_tpu_torch head metrics on {mhost}:{mport}", flush=True)
    svc.serve_forever()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
