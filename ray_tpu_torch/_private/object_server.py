"""Direct peer-to-peer object data plane (counterpart of
``ray_tpu/_private/object_server.py``).

Every head-attached client runs one of these: a TokenListener (same
framed-msgpack + HMAC transport as the control plane, same per-cluster
token) serving ``meta``/``chunk`` reads from the local object provider.
Pullers resolve the owner's direct address through the head
(``object_locate``) and move the bytes peer-to-peer; the head-relayed
pull remains the fallback when a peer is unreachable (NAT, dead server),
so the control plane never sits in the data path unless it has to.

The bytes served are a value's wire form (``SerializedObject.to_bytes``
of ``_private/serialization.py``: cloudpickle, tensors as host bytes),
so a CUDA tensor pulled by another driver lands there on the CPU.
"""

from __future__ import annotations

import socket
import threading

from typing import Callable, Dict, Optional, Tuple

from ray_tpu_torch._private.log import get_logger

from ray_tpu_torch._private.transport import (
    FramedConnection,
    TokenListener,
    connect,
    exc_to_wire,
    wire_to_exc,
)
from ray_tpu_torch._private import tracing

log = get_logger(__name__)

PULL_CHUNK = 4 << 20
PULL_WINDOW = 8  # pipelined chunk requests in flight per direct pull
# A direct pull re-dials a peer that resets it up to PULL_ATTEMPTS
# times, PULL_BACKOFF_S apart (doubled per attempt, jittered x0.5-1.5).
PULL_ATTEMPTS = 3
PULL_BACKOFF_S = 0.05


class PeerUnreachableError(ConnectionError):
    """Transport-level failure dialing/talking to a peer server —
    distinct from an error the peer's handler raised, so callers know
    a head-relayed fallback is worth trying."""


class ObjectServer:
    """Serves this process's objects to authenticated peers.

    Also the node's direct request plane: arbitrary request kinds can be
    registered via ``handlers`` (the actor host uses this for
    create/submit/kill pushed straight from the calling driver — the
    GcsActorScheduler's lease-on-node analogue, with the head only
    resolving placement). Handlers run on the per-connection thread and
    reply ``("ok", result)`` or ``("err", wire_error)``; they should
    enqueue slow work and return fast."""

    def __init__(self, bytes_provider: Callable[[bytes], bytes],
                 token: str, advertise_host: str = "127.0.0.1"):
        self._provider = bytes_provider
        self.handlers: Dict[str, Callable[[tuple], object]] = {}
        self._listener = TokenListener("0.0.0.0", 0, token, site="object")
        self.address: Tuple[str, int] = (
            advertise_host, self._listener.address[1])
        self._stop = False
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="ray_tpu_object_server")
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn = self._listener.accept_raw()
            except OSError:
                return
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
                name="ray_tpu_object_peer").start()

    def _serve_conn(self, conn: FramedConnection):
        try:
            self._listener.server_handshake(conn)
        except Exception:  # noqa: BLE001 — unauthenticated peer
            conn.close()
            return
        try:
            while not self._stop:
                msg = conn.recv()
                kind = msg[0]
                if kind == "meta":
                    try:
                        raw = self._provider(bytes(msg[1]))
                        if len(msg) > 2 and tracing._TRACER is not None:
                            # Traced pull: the requesting side rode its
                            # context on the meta frame — record the
                            # serve hop (tracing off = 2-element frame,
                            # zero extra bytes, zero spans).
                            tracing.event(
                                "object.serve",
                                ctx=tracing.extract(msg[2]),
                                nbytes=len(raw))
                        conn.send(("ok", len(raw)))
                    except Exception as exc:  # not owned here
                        log.debug("meta miss (object not owned here): "
                                  "%r", exc)
                        conn.send(("ok", None))
                elif kind == "chunk":
                    _, oid, offset, length = msg
                    try:
                        raw = self._provider(bytes(oid))
                        # memoryview slice: the chunk reaches sendmsg
                        # without an intermediate bytes copy.
                        conn.send(("ok",
                                   memoryview(raw)[offset:offset + length]))
                    except Exception as exc:  # not owned / raced free
                        log.debug("chunk miss (object not owned here): "
                                  "%r", exc)
                        conn.send(("ok", None))
                elif kind in self.handlers:
                    try:
                        conn.send(("ok", self.handlers[kind](msg)))
                    except Exception as exc:  # noqa: BLE001 — handler error
                        conn.send(("err", exc_to_wire(exc)))
                else:
                    conn.send(("err", exc_to_wire(
                        ValueError(f"unknown request {kind!r}"))))
        except (EOFError, OSError, ValueError):
            pass
        finally:
            conn.close()

    def shutdown(self):
        self._stop = True
        self._listener.close()


class _PeerLane:
    """One socket to a peer. ``dead`` is set (while holding ``lock``)
    by the user whose operation poisoned the protocol stream; later
    acquirers check it before touching ``conn``, so a poisoned lane is
    never reused and never closed under a concurrent user."""

    __slots__ = ("conn", "lock", "dead")

    def __init__(self, conn: FramedConnection):
        self.conn = conn
        self.lock = threading.Lock()
        self.dead = False


class PeerPool:
    """Cached authenticated connections to peer object servers.
    Requests are serial per CONNECTION, but each peer keeps a small
    lane pool (up to _LANES sockets) so concurrent pulls from the
    prefetch threads parallelize instead of convoying on one socket."""

    _LANES = 3

    def __init__(self, token: str):
        self._token = token
        self._lanes: Dict[Tuple[str, int], list] = {}  # addr -> [_PeerLane]
        self._rr: Dict[Tuple[str, int], int] = {}  # busy-lane rotation
        self._lock = threading.Lock()
        # Bounded-reconnect accounting (chaos/observability): every
        # failed attempt that was retried, and every pull that exhausted
        # its attempt budget without bytes.
        self.pull_retries = 0
        self.pull_exhausted = 0

    def _get(self, addr: Tuple[str, int]) -> _PeerLane:
        """An idle lane when one exists; otherwise a fresh lane (up to
        _LANES) or, at the cap, a round-robin pick over the busy lanes
        so waiters spread instead of convoying on one socket."""
        with self._lock:
            lanes = self._lanes.setdefault(addr, [])
            for lane in lanes:
                if not lane.lock.locked():
                    return lane
            if lanes and len(lanes) >= self._LANES:
                self._rr[addr] = (self._rr.get(addr, 0) + 1) % len(lanes)
                return lanes[self._rr[addr]]
        lane = _PeerLane(connect(addr[0], addr[1], self._token,
                                 timeout=5.0, site="peer"))
        with self._lock:
            lanes = self._lanes.setdefault(addr, [])
            if len(lanes) < self._LANES:
                lanes.append(lane)
                return lane
            # Raced past the cap while dialing: prefer a cached lane.
            self._rr[addr] = (self._rr.get(addr, 0) + 1) % len(lanes)
            picked = lanes[self._rr[addr]]
        lane.conn.close()  # surplus socket, never cached
        return picked

    def _drop(self, addr: Tuple[str, int], lane: Optional[_PeerLane]):
        """Retire ONE dead lane. ``lane is None`` (the dial itself
        failed — nothing was ever cached) is a no-op. Safe to close
        without the lane lock: ``dead`` was set under the lock, and
        every user checks it immediately after acquiring, so nobody can
        be mid-operation on the socket."""
        if lane is None:
            return
        with self._lock:
            lanes = self._lanes.get(addr, [])
            if lane in lanes:
                lanes.remove(lane)
        lane.conn.close()

    def pull(self, addr: Tuple[str, int],
             oid_bin: bytes) -> Optional[bytes]:
        """Direct chunked pull with a pipelined request window: up to
        PULL_WINDOW chunk requests ride ahead of the replies (issued via
        one vectored ``send_many`` syscall per refill), so the transfer
        overlaps request latency instead of paying a round trip per
        chunk. None on any failure (caller falls back to the
        head-relayed path); a failure mid-window poisons the connection
        (unread replies), so it is dropped and redialed next use."""
        return self._pull_attempt(addr, oid_bin)[1]

    def _pull_attempt(self, addr: Tuple[str, int], oid_bin: bytes
                      ) -> Tuple[str, Optional[bytes]]:
        """One pull attempt, with the outcome distinguished so bounded
        reconnect only retries what retrying can fix: ``("data", bytes)``,
        ``("absent", None)`` — the peer answered and does NOT serve the
        object — or ``("error", None)`` — transport-level failure."""
        for _ in range(2):  # one fresh-lane retry after a dead pick
            lane = None
            try:
                lane = self._get(addr)
                with lane.lock:
                    if lane.dead:
                        self._drop(addr, lane)
                        continue  # its poisoner is retiring it
                    try:
                        raw = self._pull_on_lane(lane.conn, oid_bin)
                    except Exception:
                        lane.dead = True  # set UNDER the lock
                        raise
                    return ("data", raw) if raw is not None \
                        else ("absent", None)
            except Exception:  # noqa: BLE001 — peer gone / poisoned lane
                self._drop(addr, lane)
                return ("error", None)
        return ("error", None)

    @staticmethod
    def _pull_on_lane(conn: FramedConnection,
                      oid_bin: bytes) -> Optional[bytes]:
        """Windowed pull protocol on one locked lane. Raises on any
        condition that leaves the reply stream unusable (unread
        in-flight replies, short data) — the caller retires the lane."""
        trace_wire = tracing.inject()  # ambient ctx; None when off
        conn.send(("meta", oid_bin) if trace_wire is None
                  else ("meta", oid_bin, trace_wire))
        status, size = conn.recv()
        if status != "ok" or size is None:
            return None
        reqs = [("chunk", oid_bin, off, min(PULL_CHUNK, size - off))
                for off in range(0, size, PULL_CHUNK)]
        parts = []
        issued = 0
        while len(parts) < len(reqs):
            upto = min(len(reqs), len(parts) + PULL_WINDOW)
            if upto > issued:
                conn.send_many(reqs[issued:upto])
                issued = upto
            status, chunk = conn.recv()
            if status != "ok" or not chunk:
                raise ConnectionError("chunk missing mid-window")
            parts.append(chunk)
        data = b"".join(parts)
        if len(data) != size:
            raise ConnectionError("object re-announced mid-pull")
        return data

    def pull_retrying(self, addr: Tuple[str, int], oid_bin: bytes,
                      attempts: Optional[int] = None) -> Optional[bytes]:
        """``pull`` with a BOUNDED jittered-backoff reconnect loop: a
        peer resetting connections (chaos, restart-in-progress, flaky
        network) gets ``PULL_ATTEMPTS`` fresh dials with
        exponential backoff (x0.5–1.5 jitter so concurrent pullers
        don't stampede), then the puller gives up — callers fall back
        to the head relay and, when that also fails for an object
        nothing can rebuild, materialize a typed ``ObjectLostError``
        instead of retrying forever."""
        import random
        import time

        if attempts is None:
            attempts = PULL_ATTEMPTS
        base = PULL_BACKOFF_S
        for i in range(attempts):
            status, raw = self._pull_attempt(addr, oid_bin)
            if status == "data":
                return raw
            if status == "absent":
                return None  # authoritative answer: retrying can't help
            if i + 1 < attempts:
                self.pull_retries += 1
                time.sleep(base * (2 ** i) * (0.5 + random.random()))
        self.pull_exhausted += 1
        return None

    def call_many(self, addr: Tuple[str, int], msgs: list) -> list:
        """Batched request/response against a peer's registered handlers:
        all N requests go out in one vectored ``send_many`` write, then
        the N replies are read back in order (the peer serves a
        connection serially, so ordering holds). Transport failure
        anywhere raises ``PeerUnreachableError`` — the whole batch is
        void and the caller falls back to the head relay. Per-message
        handler errors come back as exception OBJECTS in the result
        list, so one bad payload cannot void its batch-mates."""
        if not msgs:
            return []
        for attempt in range(2):  # one fresh-lane retry after a dead pick
            lane = None
            try:
                lane = self._get(addr)
                with lane.lock:
                    if lane.dead:
                        self._drop(addr, lane)
                        if attempt == 0:
                            continue
                        raise ConnectionError("peer lanes are poisoned")
                    try:
                        lane.conn.send_many(list(msgs))
                        replies = [lane.conn.recv() for _ in msgs]
                    except Exception:
                        lane.dead = True  # set UNDER the lock
                        raise
                out = []
                for status, value in replies:
                    if status == "err":
                        out.append(wire_to_exc(value)
                                   if isinstance(value, dict)
                                   else RuntimeError(str(value)))
                    else:
                        out.append(value)
                return out
            except Exception as exc:
                self._drop(addr, lane)
                raise PeerUnreachableError(
                    f"peer {addr[0]}:{addr[1]} unreachable: {exc}") from exc
        raise PeerUnreachableError(f"peer {addr[0]}:{addr[1]} unreachable")

    def call(self, addr: Tuple[str, int], msg: tuple):
        """Direct request/response against a peer's registered handler.
        Raises on transport failure (caller falls back to the head relay)
        or re-raises the handler's wire error. One-message case of
        ``call_many`` — the lane-retry protocol lives there once."""
        out = self.call_many(addr, [msg])[0]
        if isinstance(out, BaseException):
            raise out
        return out

    def close(self):
        with self._lock:
            lanes, self._lanes = dict(self._lanes), {}
        for peer_lanes in lanes.values():
            for lane in peer_lanes:
                lane.conn.close()


def local_ip_toward(sock: socket.socket) -> str:
    """The local address this socket uses — the IP peers on the same
    network can dial back."""
    try:
        return sock.getsockname()[0]
    except OSError:
        return "127.0.0.1"
