"""Twins of the wire-fault cells of ``tests/test_chaos_matrix.py`` and of
its head-kill cell: seeded frame faults injected through the transport's
frame hook (``transport._CHAOS``, ``ChaosInjector.on_send``), the
handshake bound, the bounded peer-pull retry, the typed loss of a result
no node serves, and a head SIGKILLed under a task fan-out across node
daemons (``chaos.head_kill_target``), the reference's modules beside the
port's.

Each case is a function of a side and runs once per side; the values and
the error type names must be equal. The reference sets its tuning values
through ``GlobalConfig``; the port keeps them as module constants
(``transport.HANDSHAKE_TIMEOUT_S``, ``object_server.PULL_ATTEMPTS`` and
``PULL_BACKOFF_S``, ``remote_router.EXTERNAL_PULL_TTL_S``), which its
side patches. The reference's upper wall-clock bounds are checked as
orders of events instead: the well-behaved peer is admitted before the
hanging one is cut off; the exhausted pull counts its retries; the
absent answer counts none; the lost object's error lands before
``ensure_local``'s own timeout. The head-kill cell starts a head pair
and two node daemons a side and is marked slow.

The autoscaler's cells (``tests/test_chaos_matrix.py``'s elasticity
rows): a node daemon SIGKILLed while the provider launches it (the
bounded retry absorbs it), and a node launched with seeded wire delays
(it still joins inside the launch grace, the reference's bound on its
join latency checked as no failed launch), each on its own head; and a
head SIGKILLed as the autoscaler's first launch spawns (the daemon lands
on the promoted standby), on a head pair, marked slow.
"""

import contextlib
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
TOKEN = "0123456789abcdef"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _side(pkg):
    return types.SimpleNamespace(
        pkg=pkg, rt=importlib.import_module(pkg),
        transport=importlib.import_module(f"{pkg}._private.transport"),
        chaos=importlib.import_module(f"{pkg}.util.chaos"),
        server=importlib.import_module(f"{pkg}._private.object_server"),
        config=importlib.import_module(f"{pkg}._private.config"),
        ids=importlib.import_module(f"{pkg}._private.ids"),
        store=importlib.import_module(f"{pkg}._private.object_store"),
        router=importlib.import_module(f"{pkg}._private.remote_router"),
        exc=importlib.import_module(f"{pkg}.exceptions"))


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the outcome
        return ("err", type(exc).__name__)


def twin(case):
    out = {}
    for pkg in SIDES:
        s = _side(pkg)
        s.chaos.uninstall()
        try:
            out[pkg] = _outcome(lambda: case(s))
        finally:
            s.chaos.uninstall()
            if pkg == "ray_tpu":
                s.config.GlobalConfig.reset()
    assert out["ray_tpu_torch"] == out["ray_tpu"], out
    return out["ray_tpu"]


@contextlib.contextmanager
def _tuned(s, ref_flag, port_mod, port_name, value):
    """Set one tuning value on the side: the reference's GlobalConfig
    flag, or the port's module constant."""
    if s.pkg == "ray_tpu":
        s.config.GlobalConfig.set(ref_flag, value)
        yield
        return
    old = getattr(port_mod, port_name)
    setattr(port_mod, port_name, value)
    try:
        yield
    finally:
        setattr(port_mod, port_name, old)


def _conn_pair(s, site_srv="srv", site_cli="cli"):
    lis = s.transport.TokenListener("127.0.0.1", 0, TOKEN, site=site_srv)
    out = {}

    def srv():
        out["conn"] = lis.accept()

    t = threading.Thread(target=srv, daemon=True)
    t.start()
    cli = s.transport.connect("127.0.0.1", lis.address[1], TOKEN,
                              site=site_cli)
    t.join(5)
    return lis, out["conn"], cli


def _drain(conn, timeout=0.5):
    conn._sock.settimeout(timeout)
    got = []
    try:
        while True:
            got.append(conn.recv())
    except Exception:  # noqa: BLE001 — timeout/EOF ends the drain
        pass
    return got


def _close(*things):
    for t in things:
        t.close()


def test_chaos_off_is_provably_inert():
    """Off: the slot is None, every frame arrives once, nothing counts."""
    def case(s):
        lis, srv, cli = _conn_pair(s)
        try:
            for i in range(50):
                cli.send(("m", i))
            cli.send_many([("b", i) for i in range(50)])
            got = _drain(srv)
            snap = s.chaos.snapshot()
            return (s.transport._CHAOS is None, s.chaos.active(), len(got),
                    s.chaos.wire_counters(), snap["active"],
                    snap["wire_totals"])
        finally:
            _close(cli, srv, lis)

    assert twin(case) == ("ok", (True, False, 100, {}, False, {}))


def test_frame_drop_counted_exactly_and_site_scoped():
    def case(s):
        lis, srv, cli = _conn_pair(s)
        inj = s.chaos.install(s.chaos.ChaosConfig(seed=3, drop=0.5,
                                                  sites=("cli",)))
        try:
            n = 40
            for i in range(n):
                cli.send(("m", i))
            srv.send(("server-side", 0))  # site "srv": never faulted
            got = _drain(srv)
            dropped = inj.counters["cli"]["drop"]
            return (dropped > 0, len(got) == n - dropped,
                    "srv" in inj.counters, _drain(cli), dropped)
        finally:
            _close(cli, srv, lis)

    out = twin(case)
    assert out[1][:4] == (True, True, False, [("server-side", 0)])


def test_frame_dup_and_delay_counted():
    """A dup delivers twice; a delay holds each frame ``delay_ms`` (the
    sends take at least 3 x 30 ms) and loses none."""
    def case(s):
        lis, srv, cli = _conn_pair(s)
        inj = s.chaos.install(s.chaos.ChaosConfig(seed=5, dup=1.0,
                                                  sites=("cli",)))
        try:
            cli.send(("m", 1))
            dup = (_drain(srv), inj.counters["cli"]["dup"])
            delayed = s.chaos.install(s.chaos.ChaosConfig(
                seed=5, delay=1.0, delay_ms=30, sites=("cli",)))
            t0 = time.perf_counter()
            for i in range(3):
                cli.send(("d", i))
            held = time.perf_counter() - t0 >= 0.09
            return (dup, held, len(_drain(srv)),
                    delayed.counters["cli"]["delay"])
        finally:
            _close(cli, srv, lis)

    assert twin(case) == ("ok", (([("m", 1), ("m", 1)], 1), True, 3, 3))


def test_frame_corrupt_fails_receiver_typed():
    """A corrupted frame fails the receiver's decode: an error, not a
    stall."""
    def case(s):
        lis, srv, cli = _conn_pair(s)
        inj = s.chaos.install(s.chaos.ChaosConfig(seed=2, corrupt=1.0,
                                                  sites=("cli",)))
        try:
            cli.send({"k": list(range(64))})
            srv._sock.settimeout(2.0)
            try:
                srv.recv()
                err = None
            except Exception as exc:  # noqa: BLE001 — the outcome
                err = isinstance(exc, socket.timeout)
            return err, inj.counters["cli"]["corrupt"]
        finally:
            _close(cli, srv, lis)

    assert twin(case) == ("ok", (False, 1))


def test_connection_reset_typed_at_sender():
    def case(s):
        lis, srv, cli = _conn_pair(s)
        inj = s.chaos.install(s.chaos.ChaosConfig(seed=2, reset=1.0,
                                                  sites=("cli",)))
        try:
            try:
                cli.send(("m", 1))
                sender = None
            except ConnectionResetError as exc:
                sender = type(exc).__name__
            srv._sock.settimeout(2.0)
            try:
                srv.recv()
                peer = None
            except (EOFError, OSError):
                peer = "eof"
            return sender, inj.counters["cli"]["reset"], peer
        finally:
            _close(cli, srv, lis)

    assert twin(case) == ("ok", ("ConnectionResetError", 1, "eof"))


def test_connect_then_hang_client_does_not_wedge_accept():
    """A peer that connects and never answers the challenge does not
    hold the accept loop: a well-behaved peer is admitted first, and the
    hanging one is cut off at the handshake bound."""
    def case(s):
        with _tuned(s, "transport_handshake_timeout_s", s.transport,
                    "HANDSHAKE_TIMEOUT_S", 0.5):
            lis = s.transport.TokenListener("127.0.0.1", 0, TOKEN,
                                            site="srv")
            accepted = []

            def server():
                try:
                    accepted.append((lis.accept(), time.monotonic()))
                except OSError:
                    pass

            t = threading.Thread(target=server, daemon=True)
            t.start()
            hang = socket.create_connection(("127.0.0.1", lis.address[1]),
                                            timeout=5)
            time.sleep(0.05)  # the hang reaches the accept pump first
            try:
                good = s.transport.connect("127.0.0.1", lis.address[1],
                                           TOKEN)
                t.join(5)
                good.send(("ping", 1))
                echoed = accepted[0][0].recv()
                hang.settimeout(5.0)
                challenge = hang.recv(64 * 1024) is not None
                eof = hang.recv(1024) == b""
                dropped_at = time.monotonic()
                order = accepted[0][1] <= dropped_at
                good.close()
                accepted[0][0].close()
                return bool(accepted), echoed, challenge, eof, order
            finally:
                hang.close()
                lis.close()

    assert twin(case) == ("ok", (True, ("ping", 1), True, True, True))


def test_peer_pull_bounded_retry_then_gives_up():
    """A peer that resets every connection exhausts the attempt budget
    instead of retrying forever; the counters record it."""
    def case(s):
        with _tuned(s, "peer_pull_attempts", s.server, "PULL_ATTEMPTS", 3), \
                _tuned(s, "peer_pull_backoff_s", s.server,
                       "PULL_BACKOFF_S", 0.02):
            lis = s.transport.TokenListener("127.0.0.1", 0, TOKEN,
                                            site="object")

            def evil_server():  # the handshake, then the door slams
                while True:
                    try:
                        conn = lis.accept()
                    except OSError:
                        return
                    conn.close()

            threading.Thread(target=evil_server, daemon=True).start()
            pool = s.server.PeerPool(TOKEN)
            try:
                got = pool.pull_retrying(("127.0.0.1", lis.address[1]),
                                         b"x" * 20)
                return got, pool.pull_retries, pool.pull_exhausted
            finally:
                pool.close()
                lis.close()

    assert twin(case) == ("ok", (None, 2, 1))


def test_peer_pull_absent_answer_does_not_retry():
    """An authoritative "not served here" is not a transport fault: no
    retry, no backoff."""
    def case(s):
        def provider(oid):
            raise KeyError(oid)

        server = s.server.ObjectServer(provider, TOKEN)
        pool = s.server.PeerPool(TOKEN)
        try:
            got = pool.pull_retrying(("127.0.0.1", server.address[1]),
                                     b"y" * 20)
            return got, pool.pull_retries, pool.pull_exhausted
        finally:
            pool.close()
            server.shutdown()

    assert twin(case) == ("ok", (None, 0, 0))


def test_ensure_local_materializes_object_lost_when_unrecoverable(tmp_path):
    """A completed object no node serves and no lineage can rebuild
    becomes a typed ObjectLostError at the pull bound, before
    ``ensure_local``'s own timeout."""
    def case(s):
        with _tuned(s, "external_pull_ttl_s", s.router,
                    "EXTERNAL_PULL_TTL_S", 0.4):
            class _Head:
                def object_pull(self, oid_bin):
                    return None  # nobody serves the bytes anymore

            router = object.__new__(s.router.RemoteRouter)
            router.worker = types.SimpleNamespace(
                store=s.store.ObjectStore(spill_dir=str(tmp_path / s.pkg)))
            router.head = _Head()
            router._lock = threading.Lock()
            router._done = {}
            router._failed = {}
            router._oid_owner = {}
            router._prefetching = set()
            router._stop = threading.Event()
            router.external = set()
            router.lineage = {}
            job = s.ids.JobID.from_int(7)
            tid = (s.ids.TaskID.for_driver(job) if s.pkg == "ray_tpu"
                   else s.ids.TaskID.for_job(job))
            oid = s.ids.ObjectID.for_task_return(tid, 0)
            ev = threading.Event()
            ev.set()  # the task completed; only its bytes are gone
            router._done[tid] = ev
            router.ensure_local(oid, timeout=10.0)  # GetTimeoutError past it
            err = router.worker.store.peek_error(oid)
            return type(err).__name__, isinstance(err, s.exc.ObjectLostError)

    assert twin(case) == ("ok", ("ObjectLostError", True))


# ------------------------------------------------------------ head kill
def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["RAY_TPU_HEAD_CLIENT_TIMEOUT_S"] = "2.0"
    env.update(extra)
    return env


def _read_line(proc, bound=60.0):
    import selectors

    with selectors.DefaultSelector() as sel:
        sel.register(proc.stdout, selectors.EVENT_READ)
        if not sel.select(timeout=bound):
            raise TimeoutError(f"no line from pid {proc.pid} within {bound} s")
    return proc.stdout.readline()


@pytest.mark.slow
def test_matrix_headkill_x_task_fanout_survives(tmp_path, monkeypatch):
    """Cell (head SIGKILL x fan-out across two node daemons): the head
    dies mid-flight, the standby promotes over the shared log, clients
    fail over by epoch, every task completes, and the killer records one
    head kill."""
    token = "feedface%08x" % (os.getpid() & 0xFFFFFFFF)
    monkeypatch.setenv("RAY_TPU_CLUSTER_TOKEN", token)
    monkeypatch.setenv("RAY_TPU_HEAD_CLIENT_TIMEOUT_S", "2.0")

    def case(s):
        env = _env(RAY_TPU_CLUSTER_TOKEN=token,
                   RAY_TPU_HEAD_STANDBY_PROBE_PERIOD_S="0.2",
                   RAY_TPU_HEAD_STANDBY_MISSES_TO_PROMOTE="2")
        state = str(tmp_path / f"{s.pkg}.shared_head_state.log")
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            standby_port = sk.getsockname()[1]
        procs = []
        try:
            primary = subprocess.Popen(
                [sys.executable, "-m", f"{s.pkg}._private.head_service",
                 "--port", "0", "--state", state, "--token", token],
                stdout=subprocess.PIPE, text=True, env=env)
            procs.append(primary)
            address = _read_line(primary).strip().rsplit(" ", 1)[-1]
            standby = subprocess.Popen(
                [sys.executable, "-m", f"{s.pkg}._private.head_service",
                 "--port", str(standby_port), "--state", state,
                 "--token", token, "--standby-of", address],
                stdout=subprocess.PIPE, text=True, env=env)
            procs.append(standby)
            standing = "standing by" in _read_line(standby)
            addresses = f"{address},127.0.0.1:{standby_port}"
            env["RAY_TPU_HEAD_ADDRESSES"] = addresses
            nodes = []
            for _ in range(2):
                p = subprocess.Popen(
                    [sys.executable, "-m", f"{s.pkg}._private.node_daemon",
                     "--address", addresses, "--num-cpus", "2",
                     "--worker-mode", "thread"],
                    stdout=subprocess.PIPE, text=True, env=env)
                procs.append(p)
                nodes.append(p)
            for p in nodes:
                assert "joined" in _read_line(p)
            gpu = {"num_tpus": 0} if s.pkg == "ray_tpu" else {"num_gpus": 0}
            w = s.rt.init(num_cpus=0, worker_mode="thread",
                          address=addresses, **gpu)

            @s.rt.remote
            def work(i):
                import time as _t

                _t.sleep(0.05)
                return i * 2

            warm = s.rt.get([work.remote(i) for i in range(4)], timeout=60)
            killer = s.chaos.NodeKiller(
                [s.chaos.head_kill_target(primary)],
                seed=15, interval_s=(0.05, 0.1), max_kills=1)
            refs = [work.remote(i) for i in range(40)]
            with killer:
                out = s.rt.get(refs, timeout=120)
            kills = [k for k in killer.kills if "error" not in k]
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and (
                    w.head_client.failovers < 1
                    or w.head_client.last_blackout_s is None):
                time.sleep(0.2)
            stats = w.head_client.head_stats()
            live = [n for n in w.head_client.node_list() if n["alive"]]
            deadline = time.monotonic() + 20
            probe = None
            while time.monotonic() < deadline and probe is None:
                try:
                    probe = s.rt.get(work.remote(100), timeout=30)
                except Exception:  # noqa: BLE001 — pre-reconcile routing
                    time.sleep(0.5)
            return (standing, warm, out == [i * 2 for i in range(40)],
                    len(kills), kills[0]["kind"] if kills else None,
                    primary.poll() is not None, w.head_client.failovers,
                    w.head_client.head_epoch,
                    w.head_client.last_blackout_s is not None,
                    stats["epoch"], stats["fenced"], len(live) >= 2, probe)
        finally:
            s.rt.shutdown()
            for p in reversed(procs):
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)

    assert twin(case) == ("ok", (True, [0, 2, 4, 6], True, 1, "head", True,
                                 1, 2, True, 2, False, True, 200))


# ------------------------------------------------------- autoscaler cells
def _head(s, tmp_path, env):
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{s.pkg}._private.head_service", "--port",
         "0", "--state", str(tmp_path / f"{s.pkg}.autoscale_state.log")],
        stdout=subprocess.PIPE, text=True, env=env)
    return proc, _read_line(proc).strip().rsplit(" ", 1)[-1]


def _stop(*procs):
    for p in procs:
        if p is not None and p.poll() is None:
            p.kill()
            p.wait(timeout=10)


def test_matrix_nodekill_during_launch_x_retry_path(tmp_path, monkeypatch):
    """Cell (NodeKiller x node launch): the seeded killer SIGKILLs a
    daemon while the provider launches it (before its joined line); the
    bounded retry's next attempt joins, and the counters record the
    murdered try."""
    monkeypatch.setenv("RAY_TPU_HEAD_CLIENT_TIMEOUT_S", "2.0")

    def case(s):
        au = importlib.import_module(f"{s.pkg}.autoscaler")
        cfg = s.config.GlobalConfig
        head, address = _head(s, tmp_path, _env())
        spawned = []
        try:
            cfg.set("autoscaler_launch_retries", 3)
            cfg.set("autoscaler_launch_backoff_s", 0.05)
            prov = au.LocalSubprocessProvider(address, worker_mode="thread",
                                              env=_env())
            real_spawn = prov._spawn
            fired = []

            def killing_spawn(node_type):
                proc = real_spawn(node_type)
                spawned.append(proc)
                if len(spawned) == 1:
                    killer = s.chaos.NodeKiller(
                        [s.chaos.pid_kill_target(
                            "launching-node", lambda: proc.pid,
                            kind="daemon", once=True)],
                        seed=5, interval_s=(0.0, 0.01), max_kills=1)
                    killer.start()
                    for _ in range(200):
                        if proc.poll() is not None:
                            break
                        time.sleep(0.05)
                    killer.stop()
                    fired.extend(k for k in killer.kills
                                 if "error" not in k)
                return proc

            prov._spawn = killing_spawn
            handle = prov.launch(au.NodeTypeConfig("base", {"CPU": 1}))
            out = (bool(fired), bool(handle["client_id"]),
                   prov.launch_attempts, prov.launch_failures,
                   spawned[0].poll() is not None, spawned[1].poll() is None)
            prov.terminate(handle)
            return out
        finally:
            cfg.reset()
            _stop(*spawned, head)

    assert twin(case) == ("ok", (True, True, 2, 1, True, True))


def test_matrix_wire_delay_x_scale_up_cold_start_bounded(tmp_path,
                                                          monkeypatch):
    """Cell (frame delay x scale-up): a node launched with seeded wire
    delays armed (inherited through RAY_TPU_CHAOS) still joins inside the
    launch grace, with no failed launch, and serves a task end to end."""
    import json

    monkeypatch.setenv("RAY_TPU_HEAD_CLIENT_TIMEOUT_S", "2.0")
    chaos_env = {"RAY_TPU_CHAOS": json.dumps({
        "seed": 6, "delay": 0.3, "delay_ms": 5, "sites": ["head"]})}

    def case(s):
        au = importlib.import_module(f"{s.pkg}.autoscaler")
        cfg = s.config.GlobalConfig
        head, address = _head(s, tmp_path, _env())
        scaler = None
        try:
            gpu = {"num_tpus": 0} if s.pkg == "ray_tpu" else {"num_gpus": 0}
            s.rt.init(num_cpus=0, worker_mode="thread", address=address,
                      **gpu)
            cfg.set("autoscaler_launch_grace_s", 30.0)
            scaler = au.ClusterAutoscaler(
                address,
                [au.NodeTypeConfig("base", {"CPU": 2}, min_workers=1,
                                   max_workers=1)],
                provider=au.LocalSubprocessProvider(
                    address, worker_mode="thread", env=_env(**chaos_env)),
                idle_timeout_s=3600.0, update_interval_s=0.5)
            summ = scaler.summary()
            events = [e for e in summ["scale_events"] if e.get("joined")]

            @s.rt.remote
            def probe(x):
                return x + 1

            return (summ["launch_failures"], len(events),
                    s.rt.get(probe.remote(1), timeout=60))
        finally:
            if scaler is not None:
                scaler.shutdown()
            s.rt.shutdown()
            cfg.reset()
            _stop(head)

    assert twin(case) == ("ok", (0, 1, 2))


@pytest.mark.slow
def test_matrix_headkill_x_scale_up_resumes(tmp_path, monkeypatch):
    """Cell (head SIGKILL x scale-up): the head dies as the autoscaler's
    first launch spawns; the provider's bounded retry and the inherited
    standby list (RAY_TPU_HEAD_ADDRESSES) land the node on the promoted
    head, parked demand is kept, and the episode completes."""
    token = "feedface%08x" % (os.getpid() & 0xFFFFFFFF)
    monkeypatch.setenv("RAY_TPU_CLUSTER_TOKEN", token)
    monkeypatch.setenv("RAY_TPU_HEAD_CLIENT_TIMEOUT_S", "2.0")

    def case(s):
        au = importlib.import_module(f"{s.pkg}.autoscaler")
        cfg = s.config.GlobalConfig
        env = _env(RAY_TPU_CLUSTER_TOKEN=token,
                   RAY_TPU_HEAD_STANDBY_PROBE_PERIOD_S="0.2",
                   RAY_TPU_HEAD_STANDBY_MISSES_TO_PROMOTE="2")
        state = str(tmp_path / f"{s.pkg}.shared_scale_state.log")
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            standby_port = sk.getsockname()[1]
        procs, scaler = [], None
        try:
            primary = subprocess.Popen(
                [sys.executable, "-m", f"{s.pkg}._private.head_service",
                 "--port", "0", "--state", state, "--token", token],
                stdout=subprocess.PIPE, text=True, env=env)
            procs.append(primary)
            address = _read_line(primary).strip().rsplit(" ", 1)[-1]
            standby = subprocess.Popen(
                [sys.executable, "-m", f"{s.pkg}._private.head_service",
                 "--port", str(standby_port), "--state", state,
                 "--token", token, "--standby-of", address],
                stdout=subprocess.PIPE, text=True, env=env)
            procs.append(standby)
            standing = "standing by" in _read_line(standby)
            addresses = f"{address},127.0.0.1:{standby_port}"
            env["RAY_TPU_HEAD_ADDRESSES"] = addresses
            gpu = {"num_tpus": 0} if s.pkg == "ray_tpu" else {"num_gpus": 0}
            w = s.rt.init(num_cpus=0, worker_mode="thread",
                          address=addresses, **gpu)
            cfg.set("autoscaler_launch_retries", 5)
            cfg.set("autoscaler_launch_backoff_s", 0.3)
            cfg.set("autoscaler_launch_grace_s", 30.0)
            prov = au.LocalSubprocessProvider(addresses, worker_mode="thread",
                                              env=env)
            real_spawn = prov._spawn
            fired = []

            def killing_spawn(node_type):
                if not procs[2:]:
                    killer = s.chaos.NodeKiller(
                        [s.chaos.head_kill_target(primary)],
                        seed=16, interval_s=(0.0, 0.01), max_kills=1)
                    killer.start()
                    time.sleep(0.3)
                    killer.stop()
                    fired.extend(k for k in killer.kills
                                 if "error" not in k)
                proc = real_spawn(node_type)
                procs.append(proc)
                return proc

            prov._spawn = killing_spawn
            scaler = au.ClusterAutoscaler(
                addresses,
                [au.NodeTypeConfig("base", {"CPU": 2}, min_workers=0,
                                   max_workers=1)],
                provider=prov, idle_timeout_s=3600.0,
                update_interval_s=0.3)

            @s.rt.remote
            def work(x):
                return x + 1

            done = s.rt.get([work.remote(i) for i in range(4)],
                            timeout=120)
            summ = scaler.summary()
            return (standing, bool(fired), done, w.head_client.head_epoch,
                    summ["managed_nodes"],
                    any(e.get("joined") for e in summ["scale_events"]))
        finally:
            if scaler is not None:
                scaler.shutdown()
            s.rt.shutdown()
            cfg.reset()
            _stop(*reversed(procs))

    assert twin(case) == ("ok", (True, True, [1, 2, 3, 4], 2, 1, True))
