"""Twins of ``tests/test_transport_batch.py``: the control plane's
framing, ``send_many``, the request coalescer of ``HeadClient``, the
windowed peer chunk pull of ``object_server`` and the scheduler's
event-driven dispatch edge, the reference's modules
(``ray_tpu._private.transport`` and friends) beside the port's
(``ray_tpu_torch._private...``).

Each case is a function of a side (a namespace of that side's modules)
and runs once per side; the values and the error type names must be
equal. The reference's 5 ms bound on the release -> dispatch edge
(``test_dispatch_edge_is_event_driven_no_sleep_poll``) is a wall-clock
bound: its twin checks the order of the events instead (the follower
starts after the blocker returns, on the one CPU), and so is the 0.45 s
bound of ``test_argument_prefetch_overlaps_pulls``: its twin checks
that every pull starts before the first one ends. Both sides use
``msgpack``, the codec of the reference's frames.
"""

import importlib
import os
import socket
import struct
import threading
import time
import types

import numpy as np

import ray_tpu

TOKEN = "test-token"
T = 30.0  # bound on every wait of a case


def _side(pkg: str):
    return types.SimpleNamespace(
        name=pkg,
        rt=importlib.import_module(pkg),
        transport=importlib.import_module(f"{pkg}._private.transport"),
        object_server=importlib.import_module(
            f"{pkg}._private.object_server"),
        head_service=importlib.import_module(
            f"{pkg}._private.head_service"),
        head_client=importlib.import_module(f"{pkg}._private.head_client"),
    )


SIDES = ("ray_tpu", "ray_tpu_torch")


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the outcome
        return ("err", type(exc).__name__)


def twin(case):
    """``case(side)`` on each side; the outcomes must be equal."""
    out = {pkg: _outcome(lambda pkg=pkg: case(_side(pkg))) for pkg in SIDES}
    assert out["ray_tpu_torch"] == out["ray_tpu"], out
    return out["ray_tpu"]


def _raw_pair(side):
    """A connected FramedConnection pair without the HMAC handshake."""
    lis = side.transport.TokenListener("127.0.0.1", 0, TOKEN)
    cli = side.transport.FramedConnection(
        socket.create_connection(lis.address))
    srv = lis.accept_raw()
    lis.close()
    return cli, srv


# ------------------------------------------------------------ prefetch ----
def test_argument_prefetch_overlaps_pulls():
    """``node_daemon.prefetch_serialized``: the second argument pull
    starts before the first one ends (the pulls are pipelined)."""
    from concurrent.futures import ThreadPoolExecutor

    def case(side):
        daemon = importlib.import_module(f"{side.name}._private.node_daemon")
        spans, lock = {}, threading.Lock()

        def slow_pull(ob):
            t0 = time.perf_counter()
            time.sleep(0.2)
            with lock:
                spans[ob] = (t0, time.perf_counter())
            return b"raw-" + ob

        def failing_pull(ob):
            raise KeyError(ob)

        with ThreadPoolExecutor(max_workers=4) as pool:
            out = daemon.prefetch_serialized(slow_pull, [b"a", b"b", b"c"],
                                             pool)
            failed = daemon.prefetch_serialized(failing_pull, [b"x", b"x"],
                                                pool)
        first_end = min(e for _, e in spans.values())
        return (out, all(st < first_end for st, _ in spans.values()),
                {k: type(v).__name__ for k, v in failed.items()})

    assert twin(case) == ("ok", ({b"a": b"raw-a", b"b": b"raw-b",
                                  b"c": b"raw-c"}, True,
                                 {b"x": "KeyError"}))


# ------------------------------------------------------------- framing ----
def test_vectored_framing_roundtrip_memoryview():
    def case(side):
        cli, srv = _raw_pair(side)
        try:
            blob = np.arange(4096, dtype=np.float64).tobytes()
            cli.send(("put", memoryview(blob), {"k": memoryview(b"vv")}))
            kind, got, extra = srv.recv()
            srv._send_frame(memoryview(blob)[16:64])
            raw = cli._recv_frame()
            return (kind, got == blob, extra["k"], raw == blob[16:64],
                    type(got).__name__)
        finally:
            cli.close()
            srv.close()

    assert twin(case) == ("ok", ("put", True, b"vv", True, "bytes"))


def test_send_many_orders_and_matches():
    def case(side):
        cli, srv = _raw_pair(side)
        try:
            rng = np.random.default_rng(0)
            msgs = [("m", i, rng.bytes(17 * i)) for i in range(64)]
            cli.send_many(msgs)
            got = [srv.recv() for _ in range(64)]
            return [g == m for g, m in zip(got, msgs)]
        finally:
            cli.close()
            srv.close()

    assert twin(case) == ("ok", [True] * 64)


def test_frame_size_cap_enforced(monkeypatch):
    def case(side):
        cli, srv = _raw_pair(side)
        out = []
        try:
            monkeypatch.setattr(side.transport, "MAX_FRAME", 1024)
            out.append(_outcome(lambda: cli._send_frame(b"x" * 2048)))
            out.append(_outcome(
                lambda: cli._send_frames([b"ok", b"y" * 2048])))
            cli._sock.sendall(struct.pack(">I", 500_000))
            out.append(_outcome(srv._recv_frame))
            return out
        finally:
            cli.close()
            srv.close()

    assert twin(case) == ("ok", [("err", "ValueError")] * 3)


def test_large_frame_reuses_then_shrinks_buffer():
    def case(side):
        cli, srv = _raw_pair(side)
        try:
            big = np.random.default_rng(1).bytes((9 << 20) + 13)
            sender = threading.Thread(target=cli.send, args=(("big", big),))
            sender.start()
            kind, got = srv.recv()
            sender.join(timeout=T)
            cli.send(("small", b"s"))
            small = srv.recv()
            return (kind, got == big, small,
                    len(srv._rbuf) <= side.transport._RBUF_KEEP,
                    sender.is_alive())
        finally:
            cli.close()
            srv.close()

    assert twin(case) == ("ok", ("big", True, ("small", b"s"), True, False))


def test_codec_and_wire_errors():
    """Port-only addition: the port packs with the reference's codec
    (``msgpack``, bin type on, tuples back) byte for byte, and a wire
    error rebuilds as the port's own exception types."""
    from ray_tpu_torch._private import transport as pt
    from ray_tpu_torch.exceptions import HeadFailedOverError

    obj = ("batch", (("kv_put", b"k", b"v" * 3, True), ("x", 1.5, None)),
           {"s": "t", 3: [1, -2, 2 ** 40]})
    assert pt.pack(obj) == ray_tpu._private.transport.pack(obj)
    assert pt.unpack(pt.pack(obj)) == \
        ray_tpu._private.transport.unpack(pt.pack(obj))
    err = pt.wire_to_exc(pt.exc_to_wire(HeadFailedOverError("gone")))
    assert isinstance(err, HeadFailedOverError) and str(err) == "gone"
    # A module outside the whitelist never imports: a RuntimeError.
    foreign = pt.wire_to_exc(
        {"type": "ValueError", "module": "os", "message": "m"})
    assert type(foreign) is RuntimeError
    assert pt.token_dir().endswith(os.path.join("", "ray_tpu_torch"))


# ---------------------------------------------------------- coalescer ----
def _with_head(side, body):
    svc = side.head_service.HeadService("127.0.0.1", 0)
    t = threading.Thread(target=svc.serve_forever, daemon=True)
    t.start()
    client = side.head_client.HeadClient(f"127.0.0.1:{svc.port}")
    try:
        return body(svc, client)
    finally:
        client.close()
        svc.shutdown()


def test_coalescer_batches_inflight_requests():
    def case(side):
        def body(svc, client):
            slots = [client._request_async(
                ("kv_put", b"batch-%d" % i, b"v%d" % i, True))
                for i in range(40)]
            puts = [client._request_result(s) for s in slots]
            gets = [client.kv_get(b"batch-%d" % i) for i in range(40)]
            return (puts, gets, client.req_batches_sent >= 1,
                    svc.batches_received >= 1)

        return _with_head(side, body)

    assert twin(case) == ("ok", (
        [True] * 40, [b"v%d" % i for i in range(40)], True, True))


def test_coalescer_reply_matching_under_concurrent_callers():
    def case(side):
        def body(svc, client):
            results = {}
            lock = threading.Lock()

            def caller(i):
                mine = []
                for j in range(25):
                    key = b"k-%d-%d" % (i, j)
                    val = b"v-%d-%d" % (i, j)
                    mine.append(client.kv_put(key, val))
                    mine.append(client.kv_get(key) == val)
                    if j % 7 == 0:
                        mine.append(_outcome(
                            lambda: client._request(("no_such_rpc", j))))
                with lock:
                    results[i] = mine

            threads = [threading.Thread(target=caller, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            return ([results.get(i) for i in range(8)],
                    any(t.is_alive() for t in threads),
                    client.req_msgs_sent >= 8 * 50,
                    client.req_batches_sent >= 1)

        return _with_head(side, body)

    expect_one = []
    for j in range(25):
        expect_one += [True, True]
        if j % 7 == 0:
            expect_one.append(("err", "ValueError"))
    assert twin(case) == ("ok", ([expect_one] * 8, False, True, True))


# ------------------------------------------------------------ peer pull ----
def test_peer_pool_windowed_chunk_pull():
    def case(side):
        os_mod = side.object_server
        data = np.random.default_rng(2).bytes(2 * os_mod.PULL_CHUNK + 12345)
        served = {b"oid": data}
        srv = os_mod.ObjectServer(lambda ob: served[ob], TOKEN)
        pool = os_mod.PeerPool(TOKEN)
        try:
            return (pool.pull(srv.address, b"oid") == data,
                    pool.pull(srv.address, b"nope"),
                    pool.pull(srv.address, b"oid") == data,
                    os_mod.PULL_CHUNK, os_mod.PULL_WINDOW)
        finally:
            pool.close()
            srv.shutdown()

    assert twin(case) == ("ok", (True, None, True, 4 << 20, 8))


def test_peer_unreachable_and_handler_errors():
    """Twin of the reference's typed peer failures: a dead address
    raises ``PeerUnreachableError``; a handler's own error comes back
    typed and leaves the lane usable."""
    def case(side):
        os_mod = side.object_server
        srv = os_mod.ObjectServer(lambda ob: b"", TOKEN)

        def boom(msg):
            raise KeyError(msg[1])

        srv.handlers["boom"] = boom
        srv.handlers["echo"] = lambda msg: msg[1]
        pool = os_mod.PeerPool(TOKEN)
        try:
            out = [_outcome(lambda: pool.call(srv.address, ("boom", "k"))),
                   pool.call(srv.address, ("echo", 7)),
                   [type(v).__name__ for v in pool.call_many(
                       srv.address, [("echo", 1), ("boom", 2)])]]
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                dead = ("127.0.0.1", s.getsockname()[1])
            out.append(_outcome(lambda: pool.call(dead, ("echo", 1))))
            return out
        finally:
            pool.close()
            srv.shutdown()

    assert twin(case) == ("ok", [("err", "KeyError"), 7, ["int", "KeyError"],
                                 ("err", "PeerUnreachableError")])


# ---------------------------------------------------- event-driven edge ----
def test_dispatch_edge_is_event_driven_no_sleep_poll():
    """On one CPU the follower queues behind the blocker's hold and
    starts only after the blocker returns (the order of events; the
    reference's 5 ms bound on the gap is a wall-clock bound)."""
    def case(side):
        rt = side.rt
        for pkg in SIDES:
            importlib.import_module(pkg).shutdown()
        if side.name == "ray_tpu":
            rt.init(num_cpus=1, num_tpus=0, worker_mode="thread")
        else:
            rt.init(num_cpus=1, num_gpus=0, worker_mode="thread")
        try:
            orders = []
            for _ in range(5):
                gate = threading.Event()
                events = []

                @rt.remote
                def blocker():
                    gate.wait(10)
                    events.append("release")
                    return 1

                @rt.remote
                def follower():
                    events.append("start")
                    return 2

                a = blocker.remote()
                time.sleep(0.05)
                b = follower.remote()
                gate.set()
                vals = rt.get([a, b], timeout=T)
                orders.append((vals, list(events)))
            return orders
        finally:
            rt.shutdown()

    assert twin(case) == ("ok", [([1, 2], ["release", "start"])] * 5)
