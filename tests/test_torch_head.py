"""Twins of ``tests/test_head.py``: the head service, a separate process,
with drivers attached to it, the reference's
(``python -m ray_tpu._private.head_service``, ``ray_tpu.init(address=)``)
beside the port's (``python -m ray_tpu_torch._private.head_service``,
``ray_tpu_torch.init(address=)``).

Each case is a function of a side and runs once per side; the values and
the error type names must be equal. Each side has its own head process,
shared by the cases that neither kill nor restart it (module fixture
``heads``), and each case its own peer driver; the peer's keys carry the
case's prefix, so cases on a shared head never read each other's keys.
Every wait is bounded and every subprocess is killed in a ``finally``.
The three slow cases of the reference (a head restart over its state
log, log compaction and standby failover) are twinned and marked slow
as the reference's are. One case is the port's own: the head process
loads neither torch nor JAX nor the reference package.
"""

import importlib
import os
import socket
import subprocess
import sys
import threading
import time
import types

import pytest

SIDES = ("ray_tpu", "ray_tpu_torch")
T = 30.0  # bound on every wait of a case
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _spawn_head(pkg, port=0, state=None, env=None, importtime=False):
    cmd = [sys.executable]
    if importtime:
        cmd += ["-X", "importtime"]
    cmd += ["-m", f"{pkg}._private.head_service", "--port", str(port)]
    if state:
        cmd += ["--state", state]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, text=True, env=env or _env(),
        stderr=subprocess.PIPE if importtime else None)
    try:
        line = _read_line(proc)
    except BaseException:
        _stop(proc)
        raise
    return proc, line.strip().rsplit(" ", 1)[-1], line


def _read_line(proc):
    """The next line of ``proc``'s stdout, within ``T``."""
    import selectors

    with selectors.DefaultSelector() as sel:
        sel.register(proc.stdout, selectors.EVENT_READ)
        if not sel.select(timeout=T):
            raise TimeoutError(f"no line from pid {proc.pid} within {T} s")
    return proc.stdout.readline()


def _stop(proc):
    proc.kill()
    proc.wait(timeout=10)


@pytest.fixture(scope="module")
def heads():
    procs = {}
    try:
        for pkg in SIDES:
            procs[pkg] = _spawn_head(pkg)
        yield {pkg: p[1] for pkg, p in procs.items()}
    finally:
        for proc, _, _ in procs.values():
            _stop(proc)


@pytest.fixture(autouse=True)
def _no_runtime_left():
    for pkg in SIDES:
        importlib.import_module(pkg).shutdown()
    yield
    for pkg in SIDES:
        importlib.import_module(pkg).shutdown()


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the outcome
        return ("err", type(exc).__name__)


def twin(case, heads=None):
    """``case(side)`` on each side; the outcomes must be equal. ``side``
    has ``pkg``, ``rt`` (the package), ``addr`` (its shared head, if
    any) and ``hs``/``hc`` (its head_service and head_client
    modules)."""
    out = {}
    for pkg in SIDES:
        side = types.SimpleNamespace(
            pkg=pkg, rt=importlib.import_module(pkg),
            addr=heads[pkg] if heads else None,
            hs=importlib.import_module(f"{pkg}._private.head_service"),
            hc=importlib.import_module(f"{pkg}._private.head_client"))
        try:
            out[pkg] = _outcome(lambda: case(side))
        finally:
            side.rt.shutdown()
    assert out["ray_tpu_torch"] == out["ray_tpu"], out
    return out["ray_tpu"]


_PEER = r"""
import importlib, sys, time
rt = importlib.import_module(sys.argv[2])
address, p = sys.argv[1], sys.argv[3]
rt.init(num_cpus=1, worker_mode="thread", address=address)
w = rt._private.worker.global_worker()

@rt.remote
class Greeter:
    def __init__(self):
        self.n = 0
    def hello(self, who):
        self.n += 1
        return f"hello {who} #{self.n}"

g = Greeter.options(name=p + "greeter").remote()
ref = rt.put({"payload": list(range(5))})
rt.announce_object(ref)
w.kv_put((p + "oid").encode(), ref.object_id.hex().encode())
w.kv_put((p + "ready").encode(), b"1")
deadline = time.time() + 30
while time.time() < deadline:
    if w.kv_get((p + "done").encode()) is not None:
        break
    time.sleep(0.05)
rt.shutdown()
"""


class _Peer:
    """A peer driver of one side, attached to ``addr``; its keys start
    with ``prefix``."""

    def __init__(self, side, prefix, script=_PEER):
        self.prefix = prefix
        self.proc = subprocess.Popen(
            [sys.executable, "-c", script, side.addr, side.pkg, prefix],
            env=_env())

    def key(self, name):
        return (self.prefix + name).encode()

    def close(self, worker=None):
        if worker is not None:
            try:
                worker.kv_put(self.key("done"), b"1")
            except Exception:  # noqa: BLE001 — head already gone
                pass
        try:
            self.proc.wait(timeout=T)
        except subprocess.TimeoutExpired:
            pass
        _stop(self.proc)


def _attach(side, num_cpus=2):
    return side.rt.init(num_cpus=num_cpus, worker_mode="thread",
                        address=side.addr, ignore_reinit_error=True)


def _wait_kv(worker, key, timeout=T):
    deadline = time.time() + timeout
    while time.time() < deadline:
        v = worker.kv_get(key)
        if v is not None:
            return v
        time.sleep(0.05)
    raise AssertionError(f"kv key {key} never appeared")


def _with_peer(side, prefix, body):
    peer = _Peer(side, prefix)
    w = None
    try:
        w = _attach(side)
        _wait_kv(w, peer.key("ready"))
        return body(w, peer)
    finally:
        peer.close(w)


def test_kv_is_cluster_global(heads):
    def case(side):
        def body(w, peer):
            w.kv_put(b"driver_a/says", b"hi")
            return (w.kv_get(b"driver_a/says"), w.kv_get(peer.key("ready")),
                    w.kv_get(b"no/such/key"))

        return _with_peer(side, "kv_", body)

    assert twin(case, heads) == ("ok", (b"hi", b"1", None))


def test_named_actor_resolves_across_drivers(heads):
    def case(side):
        def body(w, peer):
            g = side.rt.get_actor(peer.prefix + "greeter")
            out = side.rt.get(g.hello.remote("driver_a"), timeout=T)
            out2 = side.rt.get(g.hello.remote("again"), timeout=T)
            return out, out2, type(g).__name__

        return _with_peer(side, "named_", body)

    assert twin(case, heads) == (
        "ok", ("hello driver_a #1", "hello again #2",
               "CrossDriverActorHandle"))


def test_local_actor_stream_completes_without_head(heads):
    """An attached driver's own actor stream: ``get(completed())`` made
    before the stream ends resolves from the local store, without
    waiting on the head's ``obj|<hex>`` topic (whose wait ticks are
    5 s), and ``wait`` finds the end marker ready."""
    def case(side):
        w = _attach(side)

        @side.rt.remote
        class Streamer:
            def gen(self, n):
                for i in range(n):
                    time.sleep(0.1)
                    yield i

        a = Streamer.remote()
        g = a.gen.options(num_returns="streaming").remote(3)
        t0 = time.monotonic()
        total = side.rt.get(g.completed(), timeout=T)
        elapsed = time.monotonic() - t0
        ready, _ = side.rt.wait([g.completed()], num_returns=1, timeout=T)
        items = [side.rt.get(r, timeout=T) for r in g]
        return (total, elapsed < 4.0, len(ready), items,
                w.head_client is not None)

    assert twin(case, heads) == ("ok", (3, True, 1, [0, 1, 2], True))


def test_object_pull_across_drivers(heads):
    def case(side):
        def body(w, peer):
            ids = importlib.import_module(f"{side.pkg}._private.ids")
            wmod = importlib.import_module(f"{side.pkg}._private.worker")
            oid_hex = w.kv_get(peer.key("oid")).decode()
            ref = wmod.ObjectRef(ids.ObjectID.from_hex(oid_hex))
            return side.rt.get(ref, timeout=T)

        return _with_peer(side, "pull_", body)

    assert twin(case, heads) == ("ok", {"payload": [0, 1, 2, 3, 4]})


def test_dead_driver_directory_cleanup(heads):
    def case(side):
        def body(w, peer):
            name = peer.prefix + "greeter"
            found = side.rt.get_actor(name) is not None
            peer.proc.kill()
            peer.proc.wait(timeout=10)
            deadline = time.time() + 15
            while time.time() < deadline:
                try:
                    side.rt.get_actor(name)
                except ValueError as exc:
                    return found, type(exc).__name__
                time.sleep(0.25)
            return found, "never expired"

        return _with_peer(side, "dead_", body)

    assert twin(case, heads) == ("ok", (True, "ValueError"))


def test_cluster_info(heads):
    def case(side):
        def body(w, peer):
            info = w.head_client.cluster_info()
            return (len(info["clients"]) >= 2,
                    peer.prefix + "greeter" in info["named_actors"],
                    sorted(info))

        return _with_peer(side, "info_", body)

    assert twin(case, heads) == ("ok", (True, True, [
        "clients", "named_actors", "nodes", "num_objects"]))


def test_named_actor_name_reusable_after_kill(heads):
    def case(side):
        _attach(side)
        rt = side.rt

        @rt.remote
        class A:
            def __init__(self, v):
                self.v = v

            def get(self):
                return self.v

        a1 = A.options(name="reusable").remote(1)
        first = rt.get(a1.get.remote(), timeout=T)
        rt.kill(a1)
        a2 = A.options(name="reusable").remote(2)
        return first, rt.get(a2.get.remote(), timeout=T)

    assert twin(case, heads) == ("ok", (1, 2))


def test_state_log_write_fence(tmp_path):
    def case(side):
        path = str(tmp_path / f"{side.pkg}.log")
        log_cls = side.hs._StateLog
        primary = log_cls(path)
        out = []
        primary.append(("kv_put", b"k", b"v"))
        out.append(_outcome(lambda: log_cls(path, lock_timeout=0.5)))
        primary.rewrite(("snapshot", [(b"k", b"v")], [], [], [], []))
        out.append(_outcome(lambda: log_cls(path, lock_timeout=0.5)))
        primary.close()
        successor = log_cls(path, lock_timeout=0.5)
        out.append([r[0] for r in log_cls.replay(path)])
        successor.close()
        return out

    assert twin(case) == ("ok", [("err", "RuntimeError"),
                                 ("err", "RuntimeError"), ["snapshot"]])


def test_head_epoch_bumps_per_incarnation(tmp_path):
    def case(side):
        state = str(tmp_path / f"{side.pkg}.log")
        h1 = side.hs.HeadService("127.0.0.1", 0, state_path=state)
        try:
            first = h1.epoch
            h1._persist("kv_put", b"e", b"1")
            h1._compact()
        finally:
            h1.shutdown()
        h2 = side.hs.HeadService("127.0.0.1", 0, state_path=state)
        try:
            threading.Thread(target=h2.serve_forever, daemon=True).start()
            c = side.hc.HeadClient(f"127.0.0.1:{h2.port}", token=h2.token)
            try:
                stats_epoch = c.head_stats()["epoch"]
                hello_epoch = c.head_epoch
                value = c.kv_get(b"e")  # the snapshot holds live state
            finally:
                c.close()
            second = h2.epoch
        finally:
            h2.shutdown()
        seen = [r[1] for r in side.hs._StateLog.replay(state)
                if r[0] == "epoch"]
        return first, second, stats_epoch, hello_epoch, value, max(seen)

    assert twin(case) == ("ok", (1, 2, 2, 2, None, 2))


def test_fenced_head_refuses_stale_writes():
    def case(side):
        transport = importlib.import_module(f"{side.pkg}._private.transport")
        h = side.hs.HeadService("127.0.0.1", 0)
        threading.Thread(target=h.serve_forever, daemon=True).start()
        out = []
        try:
            conn = transport.connect("127.0.0.1", h.port, h.token)
            conn.send(("hello", "stale-client", "request"))
            status, hello = conn.recv()
            out.append((status, hello["epoch"], hello["fenced"]))
            conn.send(("kv_put", b"w", b"1", True))
            out.append(conn.recv())
            conn.send(("heartbeat", {"_epoch": 2}))
            status, beat = conn.recv()
            out.append((status, beat["epoch"], beat["fenced"]))
            conn.send(("kv_put", b"w", b"2", True))
            status, err = conn.recv()
            out.append((status, err["type"],
                        err["module"] == f"{side.pkg}.exceptions"))
            conn.send(("kv_get", b"w"))
            out.append(conn.recv()[0])
            out.append(h.fenced_refusals >= 2)
            conn.send(("heartbeat", {}))
            status, beat = conn.recv()
            out.append((status, beat["fenced"]))
            conn.close()
            out.append(_outcome(lambda: side.hc.HeadClient(
                f"127.0.0.1:{h.port}", token=h.token)))
            return out
        finally:
            h.shutdown()

    assert twin(case) == ("ok", [
        ("ok", 1, False), ("ok", True), ("ok", 1, True),
        ("err", "HeadFailedOverError", True), "err", True, ("ok", True),
        ("err", "ConnectionError")])


def test_head_failover_replays_inflight_and_reregisters(tmp_path):
    def case(side):
        state = str(tmp_path / f"{side.pkg}.log")
        h1 = side.hs.HeadService("127.0.0.1", 0, state_path=state)
        threading.Thread(target=h1.serve_forever, daemon=True).start()
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            standby_port = s.getsockname()[1]
        client = side.hc.HeadClient(
            f"127.0.0.1:{h1.port},127.0.0.1:{standby_port}",
            token=h1.token)
        h2 = None
        try:
            client.kv_put(b"fo", b"v")
            client.node_register("nodeX", {"CPU": 2})
            fired = threading.Event()
            rejoined = []

            def on_failover(old, new):
                client.node_register("nodeX", {"CPU": 2})
                rejoined.append((old, new))
                fired.set()

            client.failover_callbacks.append(on_failover)
            h1.shutdown()
            h2 = side.hs.HeadService("127.0.0.1", standby_port,
                                     token=h1.token, state_path=state)
            threading.Thread(target=h2.serve_forever, daemon=True).start()
            value = client.kv_get(b"fo")
            return (value, client.head_epoch, fired.wait(10), rejoined,
                    client.failovers, client.last_blackout_s is not None,
                    "nodeX" in {n["node_id"] for n in client.node_list()})
        finally:
            client.close()
            if h2 is not None:
                h2.shutdown()

    assert twin(case) == ("ok", (b"v", 2, True, [(1, 2)], 1, True, True))


def test_head_client_close_frees_data_plane(heads):
    def case(side):
        client = side.hc.HeadClient(side.addr)
        port = client._object_server._listener.address[1]
        socket.create_connection(("127.0.0.1", port), timeout=5).close()
        client.close()
        time.sleep(0.2)
        return _outcome(lambda: socket.create_connection(
            ("127.0.0.1", port), timeout=1).close())

    assert twin(case, heads) == ("ok", ("err", "ConnectionRefusedError"))


_PUBSUB_PEER = r"""
import importlib, sys, time
rt = importlib.import_module(sys.argv[2])
pubsub = importlib.import_module(sys.argv[2] + ".util.pubsub")
address, p = sys.argv[1], sys.argv[3]
rt.init(num_cpus=1, worker_mode="thread", address=address)
w = rt._private.worker.global_worker()
sub = pubsub.subscribe(p + "topic")
w.kv_put((p + "ready").encode(), b"1")
msg = sub.get(timeout=30)
w.kv_put((p + "got").encode(), repr(msg).encode())
deadline = time.time() + 30
while time.time() < deadline:
    if w.kv_get((p + "done").encode()) is not None:
        break
    time.sleep(0.05)
rt.shutdown()
"""


def test_pubsub_cross_driver(heads):
    def case(side):
        pubsub = importlib.import_module(f"{side.pkg}.util.pubsub")
        peer = _Peer(side, "pubsub_", _PUBSUB_PEER)
        w = None
        try:
            w = _attach(side, num_cpus=1)
            _wait_kv(w, peer.key("ready"))
            n = pubsub.publish(peer.prefix + "topic", {"x": 41})
            return n, _wait_kv(w, peer.key("got"))
        finally:
            peer.close(w)

    assert twin(case, heads) == ("ok", (1, b"{'x': 41}"))


def test_pubsub_node_events(heads):
    def case(side):
        sub_client = side.hc.HeadClient(side.addr)
        pub_client = side.hc.HeadClient(side.addr)
        try:
            sub = sub_client.subscribe("ray_tpu:node_events")
            pub_client.node_register("nodeA", {"CPU": 2})
            evt = sub.get(timeout=10)
            return evt["event"], evt["node_id"], evt["resources"]
        finally:
            sub_client.close()
            pub_client.close()

    assert twin(case, heads) == ("ok", ("node_added", "nodeA", {"CPU": 2}))


def test_pubsub_local_fallback():
    def case(side):
        pubsub = importlib.import_module(f"{side.pkg}.util.pubsub")
        sub = pubsub.subscribe("local:topic")
        try:
            first = pubsub.publish("local:topic", 7)
            got = sub.get(timeout=5)
        finally:
            sub.close()
        return first, got, pubsub.publish("local:topic", 8)

    assert twin(case) == ("ok", (1, 7, 0))


def test_head_process_loads_no_torch_jax_or_reference(heads):
    """Port only: the head process serves KV, actor, pub/sub, node and
    debug RPCs, and its imports (``-X importtime``) hold no ``torch``,
    no ``jax`` and no ``ray_tpu`` (the reference package)."""
    proc, addr, line = _spawn_head("ray_tpu_torch", importtime=True)
    try:
        assert line.startswith("ray_tpu_torch head listening on ")
        from ray_tpu_torch._private.head_client import HeadClient

        c = HeadClient(addr)
        try:
            c.kv_put(b"k", b"v")
            c.actor_register("default", "a", b"\0" * 12, "A")
            c.node_register("n", {"CPU": 1})
            c.publish("t", 1)
            c.debug_dump()
            c.trace_dump()
            assert c.cluster_info()["named_actors"] == ("a",)
        finally:
            c.close()
    finally:
        _stop(proc)
    loaded = set()
    for ln in proc.stderr.read().splitlines():
        if ln.startswith("import time:") and "|" in ln:
            loaded.add(ln.rsplit("|", 1)[1].strip().split(".")[0])
    assert "ray_tpu_torch" in loaded
    assert not loaded & {"torch", "jax", "jaxlib", "ray_tpu"}, loaded


# ------------------------------------------------------------------ slow ---
_SURVIVOR_CALLER = r"""
import importlib, sys
rt = importlib.import_module(sys.argv[2])
rt.init(num_cpus=1, worker_mode="thread", address=sys.argv[1])
g = rt.get_actor("survivor")
print("CALL:" + rt.get(g.ping.remote(), timeout=30), flush=True)
rt.shutdown()
"""


def _poll_kv(worker, key, bound=20.0):
    deadline = time.time() + bound
    while time.time() < deadline:
        try:
            value = worker.kv_get(key)
            if value is not None:
                return value
        except Exception:  # noqa: BLE001 — head not back yet
            pass
        time.sleep(0.25)
    return None


@pytest.mark.slow
def test_head_restart_recovers(tmp_path):
    def case(side):
        state = str(tmp_path / f"{side.pkg}.log")
        env = _env(RAY_TPU_HEAD_CLIENT_TIMEOUT_S="3.0")
        head1, address, _ = _spawn_head(side.pkg, state=state, env=env)
        port = int(address.rsplit(":", 1)[1])
        head2 = None
        try:
            worker = side.rt.init(num_cpus=2, worker_mode="thread",
                                  address=address, ignore_reinit_error=True)

            @side.rt.remote
            class Survivor:
                def ping(self):
                    return "pong"

            Survivor.options(name="survivor").remote()
            worker.kv_put(b"ft/key", b"ft_value")
            _stop(head1)
            head2, _, _ = _spawn_head(side.pkg, port=port, state=state,
                                      env=env)
            value = _poll_kv(worker, b"ft/key")
            caller = subprocess.run(
                [sys.executable, "-c", _SURVIVOR_CALLER, address, side.pkg],
                capture_output=True, text=True, timeout=60, env=env)
            return value, "CALL:pong" in caller.stdout
        finally:
            side.rt.shutdown()
            _stop(head1)
            if head2 is not None:
                _stop(head2)

    assert twin(case) == ("ok", (b"ft_value", True))


@pytest.mark.slow
def test_head_log_compaction(tmp_path):
    def case(side):
        state = str(tmp_path / f"{side.pkg}.log")
        env = _env(RAY_TPU_HEAD_LOG_COMPACT_RECORDS="50")
        head1, address, _ = _spawn_head(side.pkg, state=state, env=env)
        port = int(address.rsplit(":", 1)[1])
        head2 = None
        try:
            worker = side.rt.init(num_cpus=1, worker_mode="thread",
                                  address=address, ignore_reinit_error=True)
            for i in range(600):
                worker.kv_put(f"c/{i % 20}".encode(), b"v" * 8)
            first = worker.kv_get(b"c/7")
            deadline = time.time() + 10
            while time.time() < deadline:
                if os.path.getsize(state) < 600 * 20 / 2:
                    break
                time.sleep(0.25)
            compacted = os.path.getsize(state) < 600 * 20 / 2
            _stop(head1)
            head2, _, _ = _spawn_head(side.pkg, port=port, state=state,
                                      env=env)
            return first, compacted, _poll_kv(worker, b"c/13")
        finally:
            side.rt.shutdown()
            _stop(head1)
            if head2 is not None:
                _stop(head2)

    assert twin(case) == ("ok", (b"v" * 8, True, b"v" * 8))


@pytest.mark.slow
def test_head_standby_failover(tmp_path, monkeypatch):
    token = "feedfacecafe0123"
    monkeypatch.setenv("RAY_TPU_CLUSTER_TOKEN", token)

    def case(side):
        state = str(tmp_path / f"{side.pkg}.log")
        env = _env(RAY_TPU_CLUSTER_TOKEN=token,
                   RAY_TPU_HEAD_CLIENT_TIMEOUT_S="3.0")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            standby_port = s.getsockname()[1]
        primary = subprocess.Popen(
            [sys.executable, "-m", f"{side.pkg}._private.head_service",
             "--port", "0", "--state", state, "--token", token],
            stdout=subprocess.PIPE, text=True, env=env)
        standby = None
        try:
            address = _read_line(primary).strip().rsplit(" ", 1)[-1]
            standby = subprocess.Popen(
                [sys.executable, "-m", f"{side.pkg}._private.head_service",
                 "--port", str(standby_port), "--state", state,
                 "--token", token, "--standby-of", address],
                stdout=subprocess.PIPE, text=True, env=env)
            standing = "standing by" in _read_line(standby)
            worker = side.rt.init(
                num_cpus=1, worker_mode="thread",
                address=f"{address},127.0.0.1:{standby_port}",
                ignore_reinit_error=True)
            worker.kv_put(b"fo/key", b"survives")
            _stop(primary)
            value = _poll_kv(worker, b"fo/key", bound=40.0)
            return (standing, value,
                    worker.head_client.address[1] == standby_port)
        finally:
            side.rt.shutdown()
            for p in (standby, primary):
                if p is not None:
                    _stop(p)

    assert twin(case) == ("ok", (True, b"survives", True))
