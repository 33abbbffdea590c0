"""Cluster control-plane transport: framed msgpack over TCP with HMAC auth
(counterpart of ``ray_tpu/_private/transport.py``).

Design goals, as in the reference:

- **No pickle in the envelope.** Every frame is msgpack (ints, strs,
  bytes, lists, maps). Application payloads that *are* serialized Python
  (task args, actor call args) travel as opaque ``bytes`` fields and are
  only deserialized by application code after the connection has been
  admitted to the cluster — admission requires the cluster token.
- **Per-cluster secret.** The head generates a random token at startup
  (``secrets.token_hex``), writes it to a 0600 file keyed by port, and
  prints nothing secret. Joining processes present an HMAC-SHA256
  challenge response; both sides authenticate (client proves knowledge,
  server proves knowledge back), so a spoofed head cannot harvest
  payloads either. This is what makes a non-loopback bind legal.
- **Length-prefixed frames** (u32 BE) with a hard size cap; large objects
  move as explicit chunked pulls above this layer, not giant frames.
- **Zero-copy vectored IO.** ``_send_frame`` never concatenates header
  and payload: both go out in one ``socket.sendmsg`` scatter-gather
  call, and payloads may be any buffer (``bytes``/``bytearray``/
  ``memoryview``), so serialized numpy blocks and object chunks reach
  the NIC without an intermediate copy. ``send_many`` writes N frames
  in one syscall (the batch coalescer and windowed chunk pulls ride
  it). The read side fills a reused buffer via ``recv_into`` — one
  allocation per *growth*, not per frame.

Errors cross the wire as ``{"type", "module", "message"}`` maps and are
reconstructed from a module whitelist (``builtins`` and the port's
``exceptions``) — never unpickled.

Token files live under ``<tmp>/ray_tpu_torch/``, not the reference's
``<tmp>/ray_tpu/``: a port head and a reference head on one machine
never read each other's token.

Wire faults: every frame send consults one module slot, ``_CHAOS``
(``_private/chaos.py`` installs a ``ChaosInjector`` there; the
``RAY_TPU_CHAOS`` environment variable installs one at import). With
chaos off the send paths pay one global load and an ``is None`` branch.
Each connection's ``site`` label (``head``, ``peer``, ``object``,
``conn``) scopes the injection.
"""

from __future__ import annotations

import hmac
import hashlib
import os
import secrets
import socket
import struct
import tempfile
import threading
from typing import Any, Optional, Tuple

import msgpack

MAX_FRAME = 1 << 30  # 1 GiB: chunked pulls should keep frames far below this
_LEN = struct.Struct(">I")

# The installed ChaosInjector, or None (chaos off).
_CHAOS = None

# Scatter-gather writes are chunked to stay under the kernel's iovec
# limit (UIO_MAXIOV is 1024 on Linux; each frame is 2 buffers).
_IOV_FRAMES = 256
# The reused receive buffer grows to the largest frame seen but is
# re-shrunk past this bound so one giant pull doesn't pin memory.
_RBUF_KEEP = 8 << 20


# ------------------------------------------------------------------- token --
def token_dir() -> str:
    d = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return d


def token_path(port: int) -> str:
    return os.path.join(token_dir(), f"cluster_token_{port}")


def write_token(port: int, token: str) -> str:
    path = token_path(port)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        f.write(token)
    return path


def generate_token() -> str:
    return secrets.token_hex(16)


def resolve_token(port: int, token: Optional[str] = None) -> str:
    """Token lookup order: explicit arg > env > the head's token file
    (same-machine discovery). Raises if none is found — there is no
    insecure default."""
    if token:
        return token
    env = os.environ.get("RAY_TPU_CLUSTER_TOKEN")
    if env:
        return env
    path = token_path(port)
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        raise ConnectionError(
            f"no cluster token for port {port}: pass token=, set "
            f"RAY_TPU_CLUSTER_TOKEN, or run on the head machine "
            f"(token file {path})")


# ------------------------------------------------------------------- codec --
def pack(obj: Any) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def unpack(data: bytes) -> Any:
    # use_list=False: control tuples keep tuple identity round-trip.
    return msgpack.unpackb(data, raw=False, use_list=False,
                           strict_map_key=False)


_EXC_MODULES = ("builtins", "ray_tpu_torch.exceptions")
# Server-side bound on the HMAC challenge-response exchange: a
# connect-then-hang (or half-open) peer is cut off after this many
# seconds instead of pinning its handshake thread forever.
HANDSHAKE_TIMEOUT_S = 5.0


def exc_to_wire(exc: BaseException) -> dict:
    return {
        "type": type(exc).__name__,
        "module": type(exc).__module__,
        "message": str(exc),
    }


def wire_to_exc(d: dict) -> BaseException:
    mod, name, msg = d.get("module"), d.get("type", "RuntimeError"), \
        d.get("message", "")
    if mod in _EXC_MODULES:
        import importlib

        # Task errors re-raised via as_instanceof_cause carry a DYNAMIC
        # class name like "RayTaskError(ValueError)" that cannot be
        # imported; resolve the importable base so they still cross the
        # wire typed (pull-recovery paths match on RayTaskError).
        base = name.split("(", 1)[0]
        try:
            cls = getattr(importlib.import_module(mod), base)
            if isinstance(cls, type) and issubclass(cls, BaseException):
                try:
                    return cls(msg)
                except TypeError:
                    # Rich constructor (RayTaskError's (function_name,
                    # traceback_str) shape): rebuild a typed instance
                    # around the formatted message so cross-wire except
                    # clauses still match — a pulled error must arrive
                    # as its own type, not a RuntimeError.
                    if base == "RayTaskError":
                        return cls("remote task", msg)
        except Exception:  # noqa: BLE001 — fall through to generic
            pass
    return RuntimeError(f"{name}: {msg}")


# ------------------------------------------------------------ connection ----
class FramedConnection:
    """One framed, authenticated socket. ``send``/``recv`` are individually
    locked (one writer, one reader at a time); full-duplex use from
    separate threads is supported."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._sendlock = threading.Lock()
        self._recvlock = threading.Lock()
        self._closed = False
        self._hdr = bytearray(4)  # reused header recv buffer
        self._rbuf = bytearray(64 * 1024)  # reused payload recv buffer
        # Coarse plane label ("head", "peer", "object", ...) that scopes
        # chaos injection; owners overwrite it right after construction.
        self.site = "conn"
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    # raw framing -----------------------------------------------------------
    def _send_buffers_locked(self, buffers: list):
        """Vectored write of every buffer, handling partial sendmsg."""
        total = sum(len(b) for b in buffers)
        sent = self._sock.sendmsg(buffers)
        if sent == total:
            return
        # Partial write (signal, huge iovec): finish with sendall.
        for b in buffers:
            blen = len(b)
            if sent >= blen:
                sent -= blen
                continue
            self._sock.sendall(memoryview(b)[sent:])
            sent = 0

    def _send_frame(self, payload):
        """One frame; ``payload`` is any bytes-like (memoryviews pass
        through to the socket uncopied — header and payload go out in a
        single scatter-gather syscall)."""
        n = len(payload)
        if n > MAX_FRAME:
            raise ValueError(f"frame too large: {n}")
        if _CHAOS is not None:
            faulted = _CHAOS.on_send(self, payload)  # may sleep / raise
            if faulted is not None:
                with self._sendlock:
                    for p in faulted:
                        self._send_buffers_locked([_LEN.pack(len(p)), p])
                return
        with self._sendlock:
            self._send_buffers_locked([_LEN.pack(n), payload])

    def _send_frames(self, payloads: list):
        """N frames under one lock hold, ≤ _IOV_FRAMES frames per
        syscall — the wire bytes are identical to N _send_frame calls."""
        for p in payloads:
            if len(p) > MAX_FRAME:
                raise ValueError(f"frame too large: {len(p)}")
        if _CHAOS is not None:
            out = []
            for p in payloads:
                faulted = _CHAOS.on_send(self, p)  # may sleep / raise
                out.extend(faulted if faulted is not None else [p])
            payloads = out
        with self._sendlock:
            for i in range(0, len(payloads), _IOV_FRAMES):
                bufs = []
                for p in payloads[i:i + _IOV_FRAMES]:
                    bufs.append(_LEN.pack(len(p)))
                    bufs.append(p)
                self._send_buffers_locked(bufs)

    def _recv_exact_into(self, view: memoryview):
        got = 0
        n = len(view)
        while got < n:
            r = self._sock.recv_into(view[got:])
            if r == 0:
                raise EOFError("connection closed")
            got += r

    def _recv_frame_locked_view(self) -> memoryview:
        """Read one frame into the reused buffer; the returned view is
        valid only until the next recv — callers either unpack
        immediately or copy."""
        self._recv_exact_into(memoryview(self._hdr))
        (length,) = _LEN.unpack(self._hdr)
        if length > MAX_FRAME:
            raise ValueError(f"frame too large: {length}")
        if length > len(self._rbuf):
            self._rbuf = bytearray(length)
        view = memoryview(self._rbuf)[:length]
        self._recv_exact_into(view)
        if len(self._rbuf) > _RBUF_KEEP and length <= _RBUF_KEEP:
            # Copy out before shrinking the backing store.
            data = bytearray(view)
            self._rbuf = bytearray(64 * 1024)
            return memoryview(data)
        return view

    def _recv_frame(self) -> bytes:
        with self._recvlock:
            return bytes(self._recv_frame_locked_view())

    # typed API -------------------------------------------------------------
    def send(self, obj: Any):
        self._send_frame(pack(obj))

    def send_many(self, objs: list):
        """Write one frame per object in a single vectored syscall (per
        _IOV_FRAMES group). Receivers see ordinary back-to-back frames."""
        self._send_frames([pack(o) for o in objs])

    def recv(self) -> Any:
        with self._recvlock:
            # Unpacked in place from the reused buffer: msgpack copies
            # bin fields into fresh bytes during decode, so the view's
            # reuse on the next recv is safe.
            return unpack(self._recv_frame_locked_view())

    def close(self):
        if not self._closed:
            self._closed = True
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()

    def fileno(self) -> int:
        return self._sock.fileno()


def _hmac(token: str, tag: bytes, challenge: bytes) -> bytes:
    return hmac.new(token.encode(), tag + challenge, hashlib.sha256).digest()


def _server_handshake(conn: FramedConnection, token: str):
    challenge = secrets.token_bytes(32)
    conn._send_frame(challenge)
    reply = conn._recv_frame()
    if not hmac.compare_digest(reply, _hmac(token, b"client:", challenge)):
        raise ConnectionError("cluster token mismatch (client)")
    conn._send_frame(_hmac(token, b"server:", challenge))


def _client_handshake(conn: FramedConnection, token: str):
    challenge = conn._recv_frame()
    conn._send_frame(_hmac(token, b"client:", challenge))
    proof = conn._recv_frame()
    if not hmac.compare_digest(proof, _hmac(token, b"server:", challenge)):
        raise ConnectionError("cluster token mismatch (server)")


def read_token_file(port: int) -> Optional[str]:
    try:
        with open(token_path(port)) as f:
            return f.read().strip() or None
    except OSError:
        return None


class TokenListener:
    """Server side: accept() returns connections that passed the HMAC
    challenge-response handshake. Failed handshakes are dropped. The
    token may be (re)assigned after construction — the head binds first
    to learn its port, then resolves the cluster token for that port."""

    def __init__(self, host: str, port: int, token: Optional[str],
                 backlog: int = 64, site: str = "conn"):
        self._token = token
        self.site = site  # plane label for accepted conns
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(backlog)
        self.address: Tuple[str, int] = self._sock.getsockname()[:2]
        self._ready = None  # lazily-started accept() plumbing
        self._accept_thread = None
        self._accept_init_lock = threading.Lock()

    def set_token(self, token: str):
        self._token = token

    def accept_raw(self) -> FramedConnection:
        """Accept WITHOUT the handshake — run ``server_handshake`` in a
        per-connection thread, so one slow or unauthenticated peer cannot
        stall the accept loop for its handshake timeout."""
        sock, _ = self._sock.accept()
        conn = FramedConnection(sock)
        conn.site = self.site
        return conn

    def server_handshake(self, conn: FramedConnection):
        sock = conn._sock
        sock.settimeout(HANDSHAKE_TIMEOUT_S)
        _server_handshake(conn, self._token)
        sock.settimeout(None)

    def accept(self) -> FramedConnection:
        """One authenticated connection. Handshakes run on per-connection
        threads feeding an internal ready queue, so a connect-then-hang
        client can never wedge the accept loop: a later well-behaved peer
        is admitted while the stalled one is still inside its (bounded)
        handshake timeout. Raises OSError once the listener is closed."""
        import queue as _queue

        with self._accept_init_lock:
            if self._ready is None:
                self._ready = _queue.Queue()
                self._accept_thread = threading.Thread(
                    target=self._accept_pump, daemon=True,
                    name="ray_tpu_accept_pump")
                self._accept_thread.start()
        conn = self._ready.get()
        if conn is None:
            self._ready.put(None)  # wake any other accept() waiter too
            raise OSError("listener closed")
        return conn

    def _accept_pump(self):
        while True:
            try:
                conn = self.accept_raw()
            except OSError:
                self._ready.put(None)
                return

            def _handshake(conn=conn):
                try:
                    self.server_handshake(conn)
                except Exception:  # noqa: BLE001 — unauthenticated/stalled
                    conn.close()
                    return
                self._ready.put(conn)

            threading.Thread(target=_handshake, daemon=True,
                             name="ray_tpu_handshake").start()

    def close(self):
        host = port = None
        try:
            host, port = self._sock.getsockname()[:2]
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        # A thread blocked in accept() pins the listening socket open
        # past the fd close (the in-flight syscall holds the file
        # description), leaving the port accepting until the NEXT
        # connection arrives. Deliver that connection ourselves so the
        # accept returns now, its loop observes shutdown, and the port
        # actually frees — deterministic teardown instead of a lingering
        # zombie listener. Poke the BOUND address (loopback only for
        # wildcard binds).
        if port:
            if not host or host == "0.0.0.0":
                host = "127.0.0.1"
            try:
                socket.create_connection((host, port),
                                         timeout=0.2).close()
            except OSError:
                pass


def connect(host: str, port: int, token: str,
            timeout: float = 10.0, site: str = "conn") -> FramedConnection:
    sock = socket.create_connection((host, port), timeout=timeout)
    conn = FramedConnection(sock)
    conn.site = site
    try:
        _client_handshake(conn, token)
    except Exception:
        conn.close()
        raise
    sock.settimeout(None)
    return conn


# RAY_TPU_CHAOS in the environment arms wire faults for this process (and
# every daemon or worker it spawns, which inherit the variable).
if os.environ.get("RAY_TPU_CHAOS"):
    def _bootstrap_chaos():
        from ray_tpu_torch._private.chaos import install_from_env

        install_from_env()

    _bootstrap_chaos()
    del _bootstrap_chaos
