"""Driver-side connection to the head service (counterpart of
``ray_tpu/_private/head_client.py``, the GCS client's role).

Each attached process keeps three authenticated framed-msgpack connections
to the head: a request channel for its own RPCs (KV, directories, relayed
calls), a heartbeat channel (liveness must not starve behind a long
relayed RPC), and a multiplexed event channel the head pushes work
through — relayed actor calls from other drivers, chunked object reads,
task pushes (node role) and task completions (driver role) — served by a
small thread pool against the local runtime.

The request channel is **coalesced**: callers enqueue, and a single
flusher thread ships everything that accumulated during the previous
round trip as one ``("batch", msgs)`` frame (flush-on-idle, flush at
256). The head answers ``("batchrep", replies)`` in request order and
runs batch members concurrently, so N task pushes / task-done reports /
object announces cost ~1 round trip, not N — while every caller still
gets exactly its own reply (per-message semantics preserved). The
heartbeat channel stays dedicated and unbatched: liveness must not
queue behind bulk traffic.

All three channels **reconnect-and-resume**: if the head restarts (it
persists its directories — GCS FT), the heartbeat loop re-dials until the
head answers, requests retry over fresh connections, and the event
channel re-issues its hello so relays resume. Directory entries this
client owns survive in the head's append-log; re-registration is not
required for a plain restart.

**Failover** (replicated head): the dial list covers the standby heads
(``address="primary,standby"`` plus ``RAY_TPU_HEAD_ADDRESSES``
inherited at spawn). Every head advertises its **epoch** (bumped per
incarnation over the shared state log) in hello and heartbeat replies;
this client tracks the highest seen, refuses regressions (a fenced old
primary on a stale-but-healthy connection), and gossips its view back
on heartbeats so a superseded head fences itself. In-flight idempotent
RPCs replay against the promoted head for up to
``_FAILOVER_WAIT_S`` (the blackout); non-replayable relays
(``actor_call``/``actor_push``) surface a typed
``HeadFailedOverError``. An observed epoch increase fires the
``failover_callbacks`` re-registration hooks and records the measured
blackout (``last_blackout_s``).

Values cross in the process plane's wire form
(``serialization.wire_dumps``: cloudpickle, tensors as host bytes): a
relayed call's arguments, and every pulled object. The ``node_*`` and
``task_*`` RPCs serve the node plane: node daemons register and take
relayed pushes through them, and drivers push task batches to a
daemon's own server (``task_push_direct``).
"""

from __future__ import annotations

import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch._private.log import get_logger
from ray_tpu_torch._private.transport import (
    FramedConnection,
    connect,
    exc_to_wire,
    resolve_token,
    wire_to_exc,
)

log = get_logger(__name__)

_PULL_CHUNK = 4 * 1024 * 1024  # object pulls ride 4 MiB frames
_DIAL_TIMEOUT_S = 5.0  # per-address TCP dial bound on (re)connect
# How long in-flight idempotent RPCs replay across a head blackout.
_FAILOVER_WAIT_S = 20.0
# How long a relayed actor call's result stays pinned for the caller.
_EXTERNAL_PULL_TTL_S = 600.0
_PULL_WINDOW = 16   # outstanding relayed chunk requests per pull
_REQ_BATCH_MAX = 256  # request-coalescer flush-at-N bound
# Reply-heavy requests (each answer can be MBs — chunk reads, whole-
# object relays) are capped per batch so a batchrep frame stays far
# below MAX_FRAME: 24 x 4 MiB chunks ≈ 96 MiB worst case.
_REQ_BATCH_HEAVY_MAX = 24
_HEAVY_KINDS = frozenset({"object_chunk", "object_chunk_from",
                          "object_pull"})
# Aggregate request-byte budget per batch (estimated from top-level
# bytes fields): big inlined payloads flush in small batches instead of
# being packed into a near-cap frame only to be split and re-packed.
_REQ_BATCH_BYTES = 64 << 20
# Relays that execute remote side effects exactly once: NEVER blindly
# resent after a post-write connection failure (the head may have
# executed them before the reply was lost).
_NON_IDEMPOTENT_KINDS = frozenset({"actor_call", "actor_push"})


def _msg_bytes_estimate(msg: tuple) -> int:
    """Cheap size estimate: top-level bytes-like fields carry virtually
    all of a control message's weight (payloads, values, pickled args)."""
    return 64 + sum(len(v) for v in msg
                    if isinstance(v, (bytes, bytearray, memoryview)))


class _ReqSlot:
    """One in-flight coalesced request: the caller waits on ``event``;
    the flusher fills ``reply`` (a raw wire reply) or ``exc``."""

    __slots__ = ("event", "reply", "exc")

    def __init__(self):
        self.event = threading.Event()
        self.reply = None
        self.exc: Optional[BaseException] = None


class Subscription:
    """Handle to one topic subscription: .get() pulls the next payload,
    .close() unsubscribes."""

    def __init__(self, client, topic: str):
        import queue as _queue

        self._client = client
        self.topic = topic
        self._queue: "_queue.Queue" = _queue.Queue()
        self._handler = None  # set by subscribe()

    def get(self, timeout: Optional[float] = None):
        return self._queue.get(timeout=timeout)

    def close(self):
        self._client.unsubscribe(self.topic, self._handler)


def parse_address(address: str) -> Tuple[str, int]:
    host, _, port = address.rpartition(":")
    return host or "127.0.0.1", int(port)


def parse_addresses(address: str) -> list:
    """Comma-separated head addresses: primary first, then standbys
    (GCS-FT failover list — the client dials them in order)."""
    return [parse_address(a.strip())
            for a in address.split(",") if a.strip()]


class HeadClient:
    def __init__(self, address: str, client_id: Optional[str] = None,
                 token: Optional[str] = None):
        self.addresses = parse_addresses(address)
        # Standby list (RAY_TPU_HEAD_ADDRESSES, inherited by spawned
        # daemons): merged behind the explicit address, so a process
        # whose launcher only knew the primary still learns where to
        # fail over.
        from ray_tpu_torch._private.config import GlobalConfig

        env_addresses = GlobalConfig.head_addresses
        if env_addresses:
            for addr in parse_addresses(env_addresses):
                if addr not in self.addresses:
                    self.addresses.append(addr)
        self.address = self.addresses[0]
        self.token = None
        last: Optional[Exception] = None
        for _, port in self.addresses:
            try:
                self.token = resolve_token(port, token)
                break
            except ConnectionError as exc:
                last = exc
        if self.token is None:
            raise last or ConnectionError("no cluster token resolvable")
        self.client_id = client_id or f"driver-{uuid.uuid4().hex[:8]}"
        # Extension points: the node daemon serves task pushes; the
        # driver's remote router consumes task completions.
        self.handlers: Dict[str, Callable[[tuple], Any]] = {}
        self.status_fn: Optional[Callable[[], dict]] = None
        # Tracked locks feed the sanitizer's lock-order watcher under
        # RAY_TPU_SANITIZE=1 (plain-Lock cost otherwise): this class
        # holds the most locks in the tree, so an accidental nesting
        # inversion here is the likeliest host-plane deadlock.
        from ray_tpu_torch.util import sanitizer

        self._hb_lock = sanitizer.tracked_lock("head_client.hb")
        self._subs_lock = sanitizer.tracked_lock("head_client.subs")
        self._subs: Dict[str, list] = {}  # topic -> delivery callbacks
        self._reconnect_lock = sanitizer.tracked_lock(
            "head_client.reconnect")
        # Failover plane: the highest head epoch this client has seen.
        # A dial (or heartbeat) answered with a LOWER epoch is a fenced
        # old incarnation — rejected, never trusted. An INCREASE after
        # first contact is a failover: callbacks fire (re-registration
        # hooks) and the blackout (first refused RPC -> first reply
        # from the promoted head) is measured for the SLO gate.
        self._epoch_lock = sanitizer.tracked_lock("head_client.epoch")
        self.head_epoch = 0
        self.failovers = 0              # observed epoch increases
        self.last_blackout_s: Optional[float] = None
        self.blackouts: list = []       # every measured failover blackout
        self._down_since: Optional[float] = None
        self._down_epoch = 0
        # Called as cb(old_epoch, new_epoch) on a dedicated thread after
        # a failover is observed (node re-join, named-actor reconcile).
        self.failover_callbacks: list = []
        self._stop = threading.Event()
        self._req = self._dial("request")
        self._hb = self._dial("request")
        self._event = self._dial("event")
        # Request coalescer: callers enqueue; a single flusher thread
        # drains whatever accumulated while the previous round trip was
        # in flight into ONE batch frame (flush-on-idle / flush-at-N),
        # so a 10k fan-out of task pushes costs hundreds of round trips
        # instead of tens of thousands. Per-message reply semantics are
        # preserved: each caller waits on its own slot.
        from collections import deque as _deque

        self._req_queue: "_deque" = _deque()
        self._req_cv = threading.Condition()
        self.req_msgs_sent = 0
        self.req_batches_sent = 0
        self._flusher = threading.Thread(
            target=self._request_flush_loop, daemon=True,
            name="ray_tpu_head_reqflush")
        self._flusher.start()
        self._pool = ThreadPoolExecutor(
            max_workers=4, thread_name_prefix="ray_tpu_head_event")
        # Chunked-read serialization cache: byte-capped LRU so one GB-
        # scale pull doesn't re-serialize per 4MiB chunk, while many
        # small pulls can't grow the owner's memory without bound.
        from collections import OrderedDict as _OD

        self._serialized_cache: "_OD[bytes, bytes]" = _OD()
        self._serialized_cache_bytes = 0
        self._serialized_cache_cap = 256 << 20
        self._serialized_cache_lock = sanitizer.tracked_lock(
            "head_client.serialized_cache")
        # Relayed-call results pinned until pulled (bounded FIFO).
        # Guarded by its own lock: relayed actor_call events each run on
        # a dedicated thread (plus the pool), and unlocked concurrent
        # insert/popitem can corrupt the OrderedDict and drop pins.
        from collections import OrderedDict

        self._pinned_results: "OrderedDict[bytes, Any]" = OrderedDict()
        self._pinned_results_lock = sanitizer.tracked_lock(
            "head_client.pinned_results")
        # Direct data plane (ObjectManager role): serve local objects to
        # peers; pull remote objects peer-to-peer when the head knows the
        # owner's address, falling back to head-relayed chunks.
        from ray_tpu_torch._private.object_server import (
            ObjectServer,
            PeerPool,
            local_ip_toward,
        )

        self._object_server = ObjectServer(
            self._serialized_bytes, self.token,
            advertise_host=local_ip_toward(self._req._sock))
        self._peers = PeerPool(self.token)
        self.direct_pulls = 0
        self.relayed_pulls = 0
        self._event_thread = threading.Thread(
            target=self._event_loop, daemon=True,
            name="ray_tpu_head_events")
        self._event_thread.start()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name="ray_tpu_head_heartbeat")
        self._hb_thread.start()

    # ------------------------------------------------------------ plumbing
    def _dial(self, role: str) -> FramedConnection:
        """Dial the active head; on failure try the other configured
        addresses (standby failover) — whichever answers becomes the
        active address for subsequent dials. A head whose hello reply
        advertises an epoch BELOW the highest this client has seen is a
        fenced old incarnation: its connection is dropped and the walk
        continues (the wire half of the split-brain fence)."""
        dial_timeout = _DIAL_TIMEOUT_S
        ordered = [self.address] + [a for a in self.addresses
                                    if a != self.address]
        last: Optional[Exception] = None
        for addr in ordered:
            try:
                conn = connect(*addr, self.token, timeout=dial_timeout,
                               site="head")
                conn.send(("hello", self.client_id, role))
                hello = self._check(conn.recv())
                epoch = hello.get("epoch") \
                    if isinstance(hello, dict) else None
                if isinstance(hello, dict) and hello.get("fenced"):
                    conn.close()
                    last = ConnectionError(
                        f"head at {addr[0]}:{addr[1]} is fenced "
                        f"(superseded incarnation), trying the next "
                        f"address")
                    continue
                if epoch is not None and \
                        not self._observe_epoch(int(epoch)):
                    conn.close()
                    last = ConnectionError(
                        f"head at {addr[0]}:{addr[1]} advertises "
                        f"epoch {epoch} < {self.head_epoch} seen — "
                        f"fenced old incarnation, trying the next "
                        f"address")
                    continue
                self.address = addr
                return conn
            except Exception as exc:  # noqa: BLE001 — try next head
                last = exc
        raise last if last is not None else ConnectionError("no head")

    # ------------------------------------------------------- failover plane
    def _observe_epoch(self, epoch: int) -> bool:
        """Fold one head-advertised epoch into this client's view.
        Returns False when ``epoch`` regressed below the highest seen
        (caller must reject the connection); fires the failover
        callbacks on the first observation of each INCREASE past the
        initial attach."""
        fire = None
        with self._epoch_lock:
            if epoch < self.head_epoch:
                return False
            if epoch > self.head_epoch:
                old, self.head_epoch = self.head_epoch, epoch
                if old != 0:
                    self.failovers += 1
                    fire = (old, epoch)
                    # The bump itself is outage evidence: a channel may
                    # observe the promoted head on its re-dial BEFORE
                    # any RPC failure was noted (event-loop EOF path) —
                    # without this, _down_epoch would equal the NEW
                    # epoch and the blackout would never record.
                    if self._down_since is None:
                        self._down_since = time.monotonic()
                        self._down_epoch = old
                    else:
                        self._down_epoch = min(self._down_epoch, old)
        if fire is not None:
            log.warning("head failover observed: epoch %d -> %d — "
                        "re-registering with the promoted head",
                        *fire)
            from ray_tpu_torch._private import flight as _flight

            rec = _flight.recorder()
            if rec is not None:
                rec.record("head.failover", {
                    "old_epoch": fire[0], "new_epoch": fire[1],
                    "client": self.client_id})
            callbacks = list(self.failover_callbacks)
            if callbacks:
                def _run(cbs=callbacks, args=fire):
                    for cb in cbs:
                        try:
                            cb(*args)
                        except Exception as exc:  # noqa: BLE001
                            log.warning("failover re-registration "
                                        "callback failed: %r", exc)

                threading.Thread(target=_run, daemon=True,
                                 name="ray_tpu_head_failover").start()
        return True

    def _note_head_down(self) -> None:
        """First refused head RPC of an outage: blackout clock starts."""
        with self._epoch_lock:
            if self._down_since is None:
                self._down_since = time.monotonic()
                self._down_epoch = self.head_epoch

    def _note_head_up(self) -> None:
        """A head RPC round trip completed: if the outage (first
        refused RPC, or the failover observation itself when no RPC
        failed first) spanned an epoch bump, the gap was a FAILOVER
        blackout — record it."""
        with self._epoch_lock:
            if self._down_since is None:
                return
            down_since, self._down_since = self._down_since, None
            if self.head_epoch <= self._down_epoch:
                return  # same incarnation hiccup, not a failover
            blackout = time.monotonic() - down_since
            self.last_blackout_s = blackout
            self.blackouts.append(blackout)
        log.warning("head failover blackout: %.3fs from first refused "
                    "RPC to first reply from the promoted head",
                    blackout)

    @staticmethod
    def _check(reply):
        status, value = reply
        if status == "err":
            raise wire_to_exc(value) if isinstance(value, dict) else \
                RuntimeError(str(value))
        return value

    def _request_async(self, msg: tuple) -> _ReqSlot:
        """Enqueue one RPC for the coalescer; returns the slot to redeem
        with ``_request_result``. Lets callers keep many requests in
        flight (windowed chunk pulls) — they ride shared batch frames."""
        slot = _ReqSlot()
        with self._req_cv:
            if self._stop.is_set():
                slot.exc = ConnectionError("head client is closed")
                slot.event.set()
                return slot
            self._req_queue.append((msg, slot))
            self._req_cv.notify()
        return slot

    def _request_result(self, slot: _ReqSlot):
        slot.event.wait()
        if slot.exc is not None:
            raise slot.exc
        return self._check(slot.reply)

    def _request(self, msg: tuple):
        return self._request_result(self._request_async(msg))

    def _request_flush_loop(self):
        while True:
            with self._req_cv:
                while not self._req_queue and not self._stop.is_set():
                    self._req_cv.wait()
                if not self._req_queue:
                    return  # closed and drained
                batch = []
                heavy = 0
                nbytes = 0
                while self._req_queue and len(batch) < _REQ_BATCH_MAX:
                    msg = self._req_queue[0][0]
                    if msg and msg[0] in _HEAVY_KINDS:
                        if heavy >= _REQ_BATCH_HEAVY_MAX:
                            break  # next batch: bound the reply frame
                        heavy += 1
                    nbytes += _msg_bytes_estimate(msg)
                    if batch and nbytes > _REQ_BATCH_BYTES:
                        break  # next batch: bound the request frame
                    batch.append(self._req_queue.popleft())
            self._flush_batch(batch)

    class _FrameTooLarge(Exception):
        """Batch frame exceeds MAX_FRAME — raised BEFORE any write, so
        splitting the batch and resending is safe."""

    def _roundtrip_batch(self, payload: bytes, n_msgs: int) -> list:
        """Wire phase only — ``payload`` is the pre-packed frame."""
        from ray_tpu_torch._private.transport import MAX_FRAME

        if len(payload) > MAX_FRAME:
            raise self._FrameTooLarge(len(payload))
        self.req_msgs_sent += n_msgs
        if n_msgs > 1:
            self.req_batches_sent += 1
        self._req._send_frame(payload)
        rep = self._req.recv()
        if n_msgs == 1:
            return [rep]
        if rep and rep[0] == "batchrep_split":
            # Oversized reply set: the head ships one frame per reply
            # so no single frame can breach MAX_FRAME.
            if rep[1] != n_msgs:
                raise ConnectionError("batch reply count mismatch")
            return [self._req.recv() for _ in range(n_msgs)]
        if not rep or rep[0] != "batchrep" or len(rep[1]) != n_msgs:
            raise ConnectionError(
                "head answered a batch frame with a non-batch reply")
        return list(rep[1])

    def _flush_batch(self, batch: list):
        from ray_tpu_torch._private.transport import pack

        msgs = [m for m, _ in batch]
        # Pack BEFORE touching the socket: an unencodable value must be
        # isolated to its own caller without desyncing the reply stream
        # (retrying one-by-one is only legal when nothing was written).
        try:
            if len(msgs) == 1:
                payload = pack(msgs[0])
            else:
                payload = pack(("batch", tuple(msgs)))
        except Exception as exc:  # noqa: BLE001 — unencodable value
            if len(batch) > 1:
                for item in batch:
                    self._flush_batch([item])
            else:
                self._fail_batch(batch, exc)
            return
        try:
            replies = self._roundtrip_batch(payload, len(msgs))
        except self._FrameTooLarge as exc:
            # Nothing was written: split and resend — messages that fit
            # individually (each capped at MAX_FRAME pre-PR) still
            # succeed; only a single over-cap message fails its caller.
            if len(batch) > 1:
                mid = len(batch) // 2
                self._flush_batch(batch[:mid])
                self._flush_batch(batch[mid:])
            else:
                self._fail_batch(batch, ValueError(
                    f"request frame too large: {exc}"))
            return
        except Exception as exc:  # noqa: BLE001 — any post-write failure
            # Bytes may be on the wire and the reply stream is suspect:
            # the ONLY safe recovery is a fresh connection, and only for
            # idempotent members. Retried ops are put-style (last-write-
            # wins) and REPLAY across a head failover: the re-dial walks
            # the standby list for up to _FAILOVER_WAIT_S, so a
            # SIGKILLed head mid-batch costs its callers the blackout,
            # not an error. actor_call/actor_push relays may have
            # EXECUTED before the reply was lost, so resending would
            # double a remote side effect — their callers get a typed
            # HeadFailedOverError instead.
            if self._stop.is_set():
                self._fail_batch(batch, exc)
                return
            self._note_head_down()
            unsafe = [it for it in batch
                      if it[0] and it[0][0] in _NON_IDEMPOTENT_KINDS]
            if unsafe:
                from ray_tpu_torch.exceptions import HeadFailedOverError

                self._fail_batch(unsafe, HeadFailedOverError(
                    f"head connection died mid-call; the relay may or "
                    f"may not have executed ({exc})"))
                batch = [it for it in batch
                         if not (it[0] and it[0][0]
                                 in _NON_IDEMPOTENT_KINDS)]
                if not batch:
                    return
            res = self._replay_batch(batch, exc)
            if res is None:
                return  # _replay_batch failed every caller already
            batch, replies = res
        # A FENCED head refuses requests without executing them (typed
        # HeadFailedOverError replies): replaying those members against
        # the promoted head is safe for every kind, relays included —
        # the refusal is proof nothing ran. (_replay_batch itself
        # re-applies the non-idempotent rule if its OWN resend dies
        # post-write, so a relay can still never execute twice.)
        fenced_idx = [i for i, rep in enumerate(replies)
                      if self._is_fenced_reply(rep)]
        if fenced_idx and not self._stop.is_set():
            self._note_head_down()
            sub = [batch[i] for i in fenced_idx]
            res = self._replay_batch(sub, ConnectionError(
                "head refused the batch as fenced"))
            replayed = {}
            if res is not None:
                sub2, sub_replies = res
                replayed = {id(slot): rep
                            for (_, slot), rep in zip(sub2, sub_replies)}
            for (_, slot), rep in zip(batch, replies):
                if self._is_fenced_reply(rep):
                    rep = replayed.get(id(slot))
                    if rep is None:
                        continue  # failed (slot already answered)
                slot.reply = rep
                slot.event.set()
            self._note_head_up()
            return
        self._note_head_up()
        for (_, slot), rep in zip(batch, replies):
            slot.reply = rep
            slot.event.set()

    @staticmethod
    def _is_fenced_reply(rep) -> bool:
        return isinstance(rep, (tuple, list)) and len(rep) == 2 \
            and rep[0] == "err" and isinstance(rep[1], dict) \
            and rep[1].get("type") == "HeadFailedOverError"

    def _replay_batch(self, batch: list, first_exc: BaseException):
        """Replay one batch of idempotent-or-refused requests over
        fresh dials until a head answers or the failover window
        closes. Returns ``(batch, replies)`` — the surviving subset
        and its aligned replies — or None after failing every caller
        (bounded: a cluster with no surviving head must not park
        callers forever). Non-idempotent relays are only ever SENT
        once here: if a resend dies post-write (the reply-lost
        ambiguity), they fail typed and are dropped from further
        retries, so a relayed side effect can never double."""
        from ray_tpu_torch._private.transport import pack

        deadline = time.monotonic() + _FAILOVER_WAIT_S
        last: BaseException = first_exc
        while True:
            if self._stop.is_set() or time.monotonic() >= deadline \
                    or not batch:
                self._fail_batch(batch, last)
                return None
            msgs = [m for m, _ in batch]
            try:
                try:
                    self._req.close()
                except Exception as exc:  # noqa: BLE001 — already dead
                    log.debug("closing dead request conn: %r", exc)
                self._req = self._dial("request")
                if len(msgs) == 1:
                    payload = pack(msgs[0])
                else:
                    payload = pack(("batch", tuple(msgs)))
            except Exception as exc:  # noqa: BLE001 — nothing written:
                last = exc            # retrying everything stays safe
                log.debug("head re-dial failed; retrying until the "
                          "failover window closes: %r", exc)
                # Promotion takes probes x period + log replay: pace
                # the walk instead of hammering refused connections.
                self._stop.wait(0.25)
                continue
            try:
                return batch, self._roundtrip_batch(payload, len(msgs))
            except Exception as exc:  # noqa: BLE001 — post-WRITE death:
                last = exc
                # the reply is lost and relays may have executed — the
                # same ambiguity rule as the first failure applies.
                unsafe = [it for it in batch
                          if it[0] and it[0][0] in _NON_IDEMPOTENT_KINDS]
                if unsafe:
                    from ray_tpu_torch.exceptions import HeadFailedOverError

                    self._fail_batch(unsafe, HeadFailedOverError(
                        f"head connection died mid-replay; the relay "
                        f"may or may not have executed ({exc})"))
                    batch = [it for it in batch
                             if not (it[0] and it[0][0]
                                     in _NON_IDEMPOTENT_KINDS)]
                log.debug("head batch replay failed; retrying until "
                          "the failover window closes: %r", exc)
                self._stop.wait(0.25)

    @staticmethod
    def _fail_batch(batch: list, exc: BaseException):
        for _, slot in batch:
            slot.exc = exc
            slot.event.set()

    # ------------------------------------------------------------------ kv
    def kv_put(self, key: bytes, value: bytes, overwrite: bool = True):
        return self._request(("kv_put", key, value, overwrite))

    def kv_get(self, key: bytes):
        return self._request(("kv_get", key))

    def kv_del(self, key: bytes):
        return self._request(("kv_del", key))

    def kv_keys(self, prefix: bytes = b""):
        return list(self._request(("kv_keys", prefix)))

    # -------------------------------------------------------------- actors
    def actor_register(self, namespace: str, name: str, actor_bin: bytes,
                       class_name: str):
        return self._request(
            ("actor_register", namespace, name, actor_bin, class_name))

    def actor_lookup(self, namespace: str, name: str):
        return self._request(("actor_lookup", namespace, name))

    def actor_deregister(self, namespace: str, name: str):
        return self._request(("actor_deregister", namespace, name))

    def actor_call(self, owner_id: str, actor_bin: bytes, method: str,
                   args, kwargs, num_returns: int):
        """Relay an actor method call to its owning driver. Returns the
        result OBJECT IDS (announced by the owner) — the caller pulls the
        bytes peer-to-peer, so large results never ride the relay."""
        from ray_tpu_torch._private.serialization import wire_dumps

        oid_bins = self._request((
            "actor_call", owner_id, actor_bin, method,
            wire_dumps((args, kwargs)), num_returns))
        return [bytes(b) for b in oid_bins]

    # ----------------------------------------------- cluster actor placement
    def actor_place(self, actor_bin: bytes, record: dict):
        return self._request(("actor_place", actor_bin, dict(record)))

    def actor_unplace(self, actor_bin: bytes):
        return self._request(("actor_unplace", actor_bin))

    def actor_locate(self, actor_bin: bytes):
        rec = self._request(("actor_locate", actor_bin))
        return dict(rec) if rec is not None else None

    def actor_push(self, target_client: str, payload: bytes):
        """Head-relayed actor op (create/submit/kill) for nodes whose
        direct server this driver cannot dial."""
        return self._request(("actor_push", target_client, payload))

    def node_call(self, addr, msg: tuple):
        """Direct request against a node's server (actor plane). Raises
        on transport failure so callers can fall back to actor_push."""
        return self._peers.call(tuple(addr), msg)

    # ------------------------------------------------------------- objects
    def object_announce(self, oid_bin: bytes):
        return self._request(("object_announce", oid_bin))

    def object_announce_many(self, oid_bins) -> None:
        """Announce N objects in one coalesced flight (the slots share
        batch frames — ~1 round trip, not N)."""
        slots = [self._request_async(("object_announce", ob))
                 for ob in oid_bins]
        for slot in slots:
            self._request_result(slot)

    def object_transfer_many(self, entries) -> None:
        """Lease handoff: delegate this owner's location table to the
        head's fallback directory. ``entries`` = [(oid_bin,
        holder_client_id), ...] — the HOLDER of the bytes is recorded,
        so entries live and GC with the holding node, not with the
        exiting owner. Shipped in bulk batches (one frame and ONE head
        log record per batch), so a long-lived owner's handoff costs
        O(batches), not O(objects-ever-completed)."""
        entries = list(entries)
        slots = [self._request_async(
            ("object_transfer_batch", tuple(entries[i:i + 4096])))
            for i in range(0, len(entries), 4096)]
        for slot in slots:
            try:
                self._request_result(slot)
            except Exception as exc:  # noqa: BLE001 — head gone
                log.warning("lease-handoff batch lost (head "
                            "unreachable); borrowers of its entries "
                            "will fail typed: %r", exc)

    def head_stats(self) -> dict:
        """The head's steady-state observability surface: per-kind RPC
        counts, FT-log appends, directory/membership sizes."""
        return dict(self._request(("head_stats",)))

    def object_pull(self, oid_bin: bytes) -> Optional[bytes]:
        """Pull a remote object's serialized bytes: direct peer-to-peer
        from the owner's object server when the head knows its address
        (the ObjectManager data plane — head out of the data path),
        head-relayed bounded chunks otherwise."""
        located = self._request(("object_locate", oid_bin))
        if located and located.get("addr"):
            raw = self._peers.pull_retrying(tuple(located["addr"]), oid_bin)
            if raw is not None:
                self.direct_pulls += 1
                return raw
        return self._object_pull_relayed(oid_bin)

    def object_pull_from(self, holder: str, oid_bin: bytes
                         ) -> Optional[bytes]:
        """Head-relayed chunked pull from a NAMED holder: under the
        ownership directory the OWNER resolved the location — the head
        only relays the bytes for a puller that cannot reach the holder
        peer-to-peer (NAT, reset lanes). Never consults the head's
        directory."""
        return self._object_pull_relayed(oid_bin, holder=holder)

    def _object_pull_relayed(self, oid_bin: bytes,
                             holder: Optional[str] = None
                             ) -> Optional[bytes]:
        """Head-relayed chunked pull with a request window: up to
        _PULL_WINDOW chunk RPCs stay in flight (they coalesce into batch
        frames and the head relays them concurrently), so transfer
        overlaps round-trip latency instead of serializing behind it.
        With ``holder`` the relay targets that client directly
        (ownership: location already resolved); without it the head's
        fallback directory resolves the owner."""
        if holder is None:
            size = self._request(("object_meta", oid_bin))
        else:
            size = self._request(("object_meta_from", holder, oid_bin))
        if size is None:
            return None
        offsets = list(range(0, size, _PULL_CHUNK))
        parts = []
        slots: list = []
        issued = 0
        while len(parts) < len(offsets):
            while issued < len(offsets) and issued - len(parts) < \
                    _PULL_WINDOW:
                offset = offsets[issued]
                length = min(_PULL_CHUNK, size - offset)
                slots.append(self._request_async(
                    ("object_chunk", oid_bin, offset, length)
                    if holder is None else
                    ("object_chunk_from", holder, oid_bin, offset,
                     length)))
                issued += 1
            chunk = self._request_result(slots[len(parts)])
            if not chunk:
                # None: owner died mid-pull. b'': owner re-announced with
                # shorter bytes than the cached meta — either way this
                # pull is void; the caller re-resolves from scratch.
                return None
            parts.append(chunk)
        data = b"".join(parts)
        if len(data) != size:
            return None  # owner re-announced shorter bytes mid-pull
        self.relayed_pulls += 1
        return data

    # --------------------------------------------------------------- nodes
    def node_register(self, node_id: str, resources: Dict[str, float],
                      trace=None):
        """``trace`` (a ``tracing.inject`` tuple, only ever non-None
        when tracing is armed) lets the head record the JOIN half of a
        traced cold start; absent = zero extra wire bytes."""
        msg = ("node_register", node_id, dict(resources))
        if trace is not None:
            msg = msg + (tuple(trace),)
        return self._request(msg)

    def trace_dump(self, trace_id: str = "") -> list:
        """The head process's span ring (trace assembly input)."""
        return list(self._request(("trace_dump", trace_id)) or [])

    def trace_index(self) -> dict:
        """The head process's per-trace aggregates (the index input:
        O(traces) on the wire, no span materialization)."""
        return dict(self._request(("trace_dump", "", True)) or {})

    def node_trace_dump(self, target_client: str,
                        trace_id: str = "") -> list:
        """Head-relayed trace_dump from one node (fallback for nodes
        whose direct server this process cannot dial)."""
        return list(self._request(
            ("node_trace_dump", target_client, trace_id)) or [])

    def node_trace_index(self, target_client: str) -> dict:
        """Head-relayed trace_index from one node (same fallback)."""
        return dict(self._request(
            ("node_trace_dump", target_client, "", True)) or {})

    def node_metrics_dump(self, target_client: str) -> str:
        """Head-relayed metrics scrape from one node."""
        return self._request(
            ("node_metrics_dump", target_client)) or ""

    def debug_dump(self) -> dict:
        """The head process's flight bundle (incident assembly input;
        {} when the head's recorder is disarmed)."""
        return dict(self._request(("debug_dump",)) or {})

    def node_debug_dump(self, target_client: str) -> dict:
        """Head-relayed debug_dump from one node (fallback for nodes
        whose direct server this process cannot dial)."""
        return dict(self._request(
            ("node_debug_dump", target_client)) or {})

    def flight_ctl_head(self, on: bool) -> dict:
        """Pause/resume the HEAD process's stack sampler."""
        return dict(self._request(
            ("flight_ctl", "profile", bool(on))) or {})

    def node_flight_ctl(self, target_client: str, on: bool) -> dict:
        """Head-relayed flight_ctl: pause/resume one node's stack
        sampler live. Returns the node's {"running": bool} answer
        ({} when it could not be reached)."""
        return dict(self._request(
            ("node_flight_ctl", target_client, bool(on))) or {})

    def node_list(self):
        return [dict(n) for n in self._request(("node_list",))]

    def node_drain(self, target_client: str,
                   timeout: float = 15.0) -> dict:
        """Drain-before-reap handshake (autoscaler -> head -> node):
        the node cordons itself (new pushes refuse typed and reroute),
        finishes in-flight tasks, and lease-transfers node-held result
        bytes to their owners. Returns the node's drain report
        ({"transferred": n, "untransferred": n, "refused": n})."""
        return dict(self._request(
            ("node_drain", target_client, float(timeout))) or {})

    def task_push(self, target_client: str, payload: bytes):
        return self._request(("task_push", target_client, payload))

    def task_push_many(self, target_client: str, payloads: list) -> list:
        """Head-relayed task pushes, all in flight at once: the slots
        ride shared coalescer batch frames, so N pushes cost ~1 round
        trip. Per-payload results; a failed slot yields its exception
        OBJECT instead of voiding its batch-mates."""
        slots = [self._request_async(("task_push", target_client, p))
                 for p in payloads]
        out = []
        for slot in slots:
            try:
                out.append(self._request_result(slot))
            except Exception as exc:  # noqa: BLE001 — per-payload failure
                out.append(exc)
        return out

    def task_push_direct(self, addr, payloads: list) -> list:
        """Direct batched task pushes to a node daemon's object/request
        server — the head stays out of steady-state dispatch. One
        vectored write carries every payload; raises
        ``PeerUnreachableError`` so callers fall back to the relay."""
        return self._peers.call_many(
            tuple(addr), [("task_push", p) for p in payloads])

    def task_done(self, driver_id: str, oid_bins, payload: bytes):
        return self._request(
            ("task_done", driver_id, tuple(oid_bins), payload))

    def task_done_many(self, driver_id: str, entries) -> None:
        """N relayed completion reports in one coalesced flight
        (``entries`` = [(oid_bins, payload), ...]); per-entry failures
        are swallowed — a gone driver forfeits its completions, the
        results stay local either way."""
        slots = [self._request_async(
            ("task_done", driver_id, tuple(oid_bins), payload))
            for oid_bins, payload in entries]
        for slot in slots:
            try:
                self._request_result(slot)
            except Exception:  # noqa: BLE001 — driver/head gone
                pass

    def cluster_info(self) -> dict:
        return dict(self._request(("cluster_info",)))

    def demand_report(self):
        """Every live client's heartbeat status (autoscaler input)."""
        return [dict(c) for c in self._request(("demand_report",))]

    # -------------------------------------------------------------- events
    def _event_loop(self):
        """Serve relayed work from the head (the per-node agent role).
        Multiplexed: requests carry ids and are answered out of order from
        a thread pool, so a slow actor call cannot block object reads. A
        dropped event channel reconnects with a fresh hello (head pruned
        us / head restarted), so relays resume after revival."""
        while not self._stop.is_set():
            try:
                msg = self._event.recv()
            except (EOFError, OSError, ValueError):
                if self._stop.is_set():
                    return
                if not self._reconnect_event():
                    return
                continue
            if msg[0] == "evt":
                topic, payload = msg[1], msg[2]
                self._pool.submit(self._deliver_evt, topic, payload)
                continue
            if msg[0] != "req":
                continue
            rid, event = msg[1], msg[2:]
            if event and event[0] in ("actor_call", "node_drain"):
                # Relayed actor calls wait unbounded for method completion
                # (long-running methods are legitimate) — they get their
                # OWN thread so they can never starve the 4-thread pool
                # that serves object reads / task pushes / pubsub. Node
                # drains (bounded but long: in-flight wait + lease
                # transfer) ride the same dedicated-thread path.
                threading.Thread(
                    target=self._serve_event, args=(rid, event),
                    daemon=True, name="ray_tpu_head_actor_call").start()
                continue
            self._pool.submit(self._serve_event, rid, event)

    def _reconnect_event(self) -> bool:
        """Re-dial until the head answers or this client shuts down — no
        deadline: the heartbeat loop also retries forever, and a client the
        head lists as alive MUST be able to serve relays, or its directory
        entries poison every lookup (reconnect-and-resume contract)."""
        import time as _time

        while not self._stop.is_set():
            try:
                self._event = self._dial("event")
                return True
            except Exception as exc:  # head not back yet
                log.debug("event channel re-dial failed; retrying: %r",
                          exc)
                _time.sleep(0.5)
        return False

    def _serve_event(self, rid: int, event: tuple):
        try:
            reply = ("rep", rid, "ok", self._handle_event(event))
        except Exception as exc:  # noqa: BLE001 — event boundary
            reply = ("rep", rid, "err", exc_to_wire(exc))
        from ray_tpu_torch._private.transport import pack

        try:
            # Pack exactly once, separately from the socket write, so ANY
            # encode failure (TypeError, OverflowError on ints >= 2**64,
            # RecursionError...) downgrades to a wire error instead of
            # being mistaken for a dead socket and silently dropped.
            data = pack(reply)
        except Exception:  # noqa: BLE001 — unencodable value
            data = pack(("rep", rid, "err", exc_to_wire(TypeError(
                f"event reply for {event[0]!r} is not wire-encodable"))))
        try:
            self._event._send_frame(data)
        except Exception:  # noqa: BLE001 — socket died: the head fails
            # every pending relay on this channel (EventChannel.fail_all),
            # so the caller is NOT left hanging; our event loop re-dials.
            pass

    def _pin_result(self, ref):
        """Keep a relayed-call result alive until the caller pulls it.
        Time-based release (callers pull promptly after the reply) with
        a count cap as the memory backstop — a FIFO-only cap could drop
        a result a slow caller has not fetched yet."""
        import time as _time

        ttl = _EXTERNAL_PULL_TTL_S  # keep pin life == retry bound
        now = _time.monotonic()
        with self._pinned_results_lock:
            self._pinned_results[ref.object_id.binary()] = (ref, now)
            while self._pinned_results:
                _, (_, ts) = next(iter(self._pinned_results.items()))
                if now - ts > ttl or len(self._pinned_results) > 4096:
                    self._pinned_results.popitem(last=False)
                else:
                    break

    def _serialized_bytes(self, oid_bin: bytes) -> bytes:
        """Serialized form of a locally-owned object, cached briefly so a
        chunked pull doesn't re-serialize per chunk."""
        with self._serialized_cache_lock:  # pool threads share the LRU
            cached = self._serialized_cache.get(oid_bin)
            if cached is not None:
                self._serialized_cache.move_to_end(oid_bin)
                return cached
        from ray_tpu_torch._private import worker as worker_mod
        from ray_tpu_torch._private.ids import ObjectID

        w = worker_mod._try_global_worker()
        if w is None or not w.is_alive:
            raise RuntimeError("driver runtime is down")
        serialized = w.store.get(ObjectID(oid_bin), timeout=30.0)
        raw = serialized.to_bytes()
        with self._serialized_cache_lock:
            old = self._serialized_cache.get(oid_bin)
            if old is not None:  # concurrent miss raced us: replace
                self._serialized_cache_bytes -= len(old)
            self._serialized_cache[oid_bin] = raw
            self._serialized_cache_bytes += len(raw)
            while (self._serialized_cache_bytes
                   > self._serialized_cache_cap
                   and len(self._serialized_cache) > 1):
                _, evicted = self._serialized_cache.popitem(last=False)
                self._serialized_cache_bytes -= len(evicted)
        return raw

    def _handle_event(self, event: tuple):
        kind = event[0]
        handler = self.handlers.get(kind)
        if handler is not None:
            return handler(event)
        from ray_tpu_torch._private import worker as worker_mod

        if kind == "actor_call":
            w = worker_mod._try_global_worker()
            if w is None or not w.is_alive:
                raise RuntimeError("driver runtime is down")
            _, actor_bin, method, args_bytes, num_returns = event
            from ray_tpu_torch._private.ids import ActorID

            runtime = w.actors.get(ActorID(actor_bin))
            if runtime is None:
                raise ValueError("actor no longer exists on its owner")
            from ray_tpu_torch._private.serialization import wire_loads

            args, kwargs = wire_loads(args_bytes)
            refs = runtime.submit(method, args, kwargs, num_returns,
                                  method)
            # Results stay OFF the relay: wait for completion (unbounded —
            # long-running methods are legitimate), announce the ids, and
            # reply with the ids; the caller pulls the bytes p2p from our
            # object server. Pin the refs so the store keeps the bytes
            # until the caller has fetched them.
            w.store.wait([r.object_id for r in refs], len(refs),
                         timeout=None)
            for r in refs:
                self.object_announce(r.object_id.binary())
                self._pin_result(r)
            return [r.object_id.binary() for r in refs]
        if kind == "object_get":
            return self._serialized_bytes(event[1])
        if kind == "object_meta":
            return len(self._serialized_bytes(event[1]))
        if kind == "object_chunk":
            _, oid_bin, offset, length = event
            raw = self._serialized_bytes(oid_bin)
            return memoryview(raw)[offset:offset + length]
        raise ValueError(f"unknown event {kind!r}")

    # -------------------------------------------------------------- pubsub
    def subscribe(self, topic: str, callback=None):
        """Subscribe this client to a topic. Returns a Subscription whose
        .get(timeout) yields payloads (when no callback is given).
        Re-asserted on every heartbeat so a head restart keeps it."""
        sub = Subscription(self, topic)
        handler = callback if callback is not None else sub._queue.put
        sub._handler = handler
        with self._subs_lock:
            self._subs.setdefault(topic, []).append(handler)
        self._request(("subscribe", topic))
        return sub

    def unsubscribe(self, topic: str, handler=None):
        """Drop one handler (or all, when handler is None); the head-side
        subscription ends only when the topic has no handlers left."""
        with self._subs_lock:
            if handler is None:
                self._subs.pop(topic, None)
            else:
                handlers = self._subs.get(topic, [])
                if handler in handlers:
                    handlers.remove(handler)
                if handlers:
                    return  # siblings still listening — keep head sub
                self._subs.pop(topic, None)
        try:
            self._request(("unsubscribe", topic))
        except Exception:  # noqa: BLE001 — head may be down; local is off
            pass

    def publish(self, topic: str, payload) -> int:
        """Publish to all subscribers cluster-wide; returns the number of
        clients the head pushed to."""
        return self._request(("publish", topic, payload))

    def _deliver_evt(self, topic: str, payload):
        with self._subs_lock:
            handlers = list(self._subs.get(topic, ()))
        for h in handlers:
            try:
                h(payload)
            except Exception:  # noqa: BLE001 — subscriber callback bug
                pass

    def _heartbeat_loop(self):
        # _hb_lock guards only the self._hb REFERENCE (swap on re-dial,
        # close on shutdown); the send/recv round trip and the re-dial
        # run on a local ref outside it. Holding the lock across the
        # wire (as this loop once did) meant close() — and anything
        # else serialized on the lock — stalled behind a heartbeat
        # round trip or a multi-address 5s-per-standby re-dial.
        while not self._stop.wait(0.5):
            status = None
            if self.status_fn is not None:
                try:
                    status = self.status_fn()
                except Exception as exc:  # status is best-effort
                    log.debug("status_fn failed; sending bare "
                              "heartbeat: %r", exc)
                    status = None
            with self._subs_lock:
                topics = list(self._subs)
            status = dict(status or {})
            if topics:
                status["_subs"] = topics
            status["_peer_addr"] = list(self._object_server.address)
            # Epoch gossip: the head compares this against its own —
            # a fenced old primary learns it was superseded from the
            # first surviving client that heartbeats it.
            status["_epoch"] = self.head_epoch
            msg = ("heartbeat", status)
            with self._hb_lock:
                hb = self._hb
            try:
                hb.send(msg)
                val = self._check(hb.recv())
                # Failover blind-spot fix: the reply carries the serving
                # head's epoch. A REGRESSION means this stale connection
                # reaches a fenced old incarnation that merely looks
                # healthy — treat it as a failed heartbeat and re-dial
                # (the dial walk rejects the fenced head by epoch too).
                if isinstance(val, dict) and "epoch" in val:
                    if not self._observe_epoch(int(val["epoch"])):
                        raise ConnectionError(
                            f"heartbeat answered by a fenced head "
                            f"(epoch {val['epoch']} < "
                            f"{self.head_epoch} seen)")
                self._note_head_up()
                # Feed the flight recorder's heartbeat-gap watchdog: a
                # wedged daemon stops completing round trips, and the
                # watchdog auto-dumps what every thread was doing.
                from ray_tpu_torch._private import flight as _flight

                if _flight._FLIGHT is not None:
                    _flight.beat("head_link")
            except Exception as exc:  # re-dial until the head returns
                if not self._stop.is_set():
                    self._note_head_down()
                log.debug("heartbeat failed; re-dialing head: %r", exc)
                try:
                    hb.close()
                except Exception as exc2:
                    log.debug("closing dead heartbeat conn: %r", exc2)
                try:
                    fresh = self._dial("request")
                except Exception as exc2:  # still down — next tick retries
                    log.debug("head still down: %r", exc2)
                    continue
                stale = None
                with self._hb_lock:
                    if self._stop.is_set():
                        # close() already swept self._hb — a conn
                        # published now would leak its socket for good
                        stale = fresh
                    else:
                        self._hb = fresh
                if stale is not None:
                    try:
                        stale.close()
                    except Exception as exc2:
                        log.debug("closing post-shutdown re-dial: %r",
                                  exc2)

    def close(self):
        self._stop.set()
        # Retire the flight heartbeat feed FIRST: stopping the beat
        # loop on purpose must not read as a stall ~gap seconds later.
        from ray_tpu_torch._private import flight as _flight

        if _flight._FLIGHT is not None:
            _flight.clear_beat("head_link")
        # Wake the flusher and fail anything still queued — callers must
        # not hang on slots nobody will ever serve.
        with self._req_cv:
            pending = list(self._req_queue)
            self._req_queue.clear()
            self._req_cv.notify_all()
        self._fail_batch(pending, ConnectionError("head client is closed"))
        self._pool.shutdown(wait=False, cancel_futures=True)
        # The direct data plane must die with the client or its listener
        # port and peer sockets leak (one pair per init/shutdown cycle).
        try:
            self._object_server.shutdown()
        except Exception:  # noqa: BLE001 — already down
            pass
        try:
            self._peers.close()
        except Exception:  # noqa: BLE001
            pass
        # Sweep the heartbeat conn under its lock: the heartbeat loop
        # checks _stop before publishing a re-dialed conn, so after this
        # point no fresh conn can appear (a racing re-dial closes its
        # own result when it sees _stop set).
        with self._hb_lock:
            hb = self._hb
        for conn in (self._req, self._event, hb):
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass
