"""Twins of ``tests/test_direct_dispatch.py``: the cross-node task plane,
the reference's (``ray_tpu/_private/remote_router.py`` and
``node_daemon.py``) beside the port's.

The fast units run on a bare router (and a bare daemon) as the
reference builds them, with no worker, thread or socket: locality
scoring, the event-driven dependency wait, the iterative failure
cascade, and the ``need_fn`` admission protocol. The cluster cases
start a head and two thread-plane node daemons a side, and are marked
slow as the reference's are: steady-state dispatch never relays through
the head, a dead direct dial falls back to the relay, a push to a node
killed before its batch went out reroutes, a consumer runs on the node
holding its argument, a dependent ships while its producer runs, and a
remote error arrives typed.

Each case is a function of a side and runs once per side; the values and
the error type names must be equal. ``test_await_dep_event_driven_and_typed_timeout``
checks its wall-clock bound (the wait returns within 1 s of a 0.05 s
production) as an order of events instead: the wait returns after the
value is produced and before its 5 s bound. Likewise
``test_remote_error_propagates_typed_and_fast``'s 5 s bound becomes: the
error arrives before the get's own 30 s timeout, with the router's
failure recorded from the completion report. Not twinned:
``test_check_bench_requires_cluster_metric`` (it reads ``bench.py``'s
gate).
"""

import hashlib
import importlib
import os
import pickle
import subprocess
import sys
import threading
import time
import types
from collections import OrderedDict, deque

import pytest

SIDES = ("ray_tpu", "ray_tpu_torch")
T = 60.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the outcome
        return ("err", type(exc).__name__)


def _mods(pkg):
    return types.SimpleNamespace(
        pkg=pkg, rt=importlib.import_module(pkg),
        ids=importlib.import_module(f"{pkg}._private.ids"),
        sched=importlib.import_module(f"{pkg}._private.scheduler"),
        router=importlib.import_module(f"{pkg}._private.remote_router"),
        daemon=importlib.import_module(f"{pkg}._private.node_daemon"),
        worker=importlib.import_module(f"{pkg}._private.worker"),
        exc=importlib.import_module(f"{pkg}.exceptions"))


def twin_units(case):
    out = {pkg: _outcome(lambda: case(_mods(pkg))) for pkg in SIDES}
    assert out["ray_tpu_torch"] == out["ray_tpu"], out
    return out["ray_tpu"]


# --------------------------------------------------------------- fast units
def _bare_router(m):
    """A RemoteRouter skeleton with the state _choose_node and
    _await_dep touch (the reference's ``_bare_router``)."""
    r = m.router.RemoteRouter.__new__(m.router.RemoteRouter)
    r._lock = threading.Lock()
    r._inflight = {}
    r._assigned = {}
    r._draining_nodes = {}
    r._oid_owner = {}
    r._oid_sizes = {}
    r._task_node = {}
    r._task_target = {}
    r._done = {}
    r._done_cbs = {}
    r._failed = {}
    r._completed = set()
    r._dep_children = {}
    r.lineage = {}
    r.external = {}

    class _NoopDirectory:
        @staticmethod
        def publish_many(oid_bins):
            pass

    r.owner_directory = _NoopDirectory()
    return r


def _spec(m, args=()):
    tid = m.ids.TaskID.from_random()
    return m.sched.TaskSpec(
        task_id=tid, function=lambda: None, args=tuple(args), kwargs={},
        num_returns=1,
        return_ids=[m.ids.ObjectID(tid.binary() + (0).to_bytes(4, "little"))],
        name="t", resources={"CPU": 1.0})


def _node(cid, backlog=0):
    return {"client_id": cid, "node_id": cid, "alive": True,
            "resources": {"CPU": 1.0}, "status": {"backlog": backlog},
            "peer_addr": None}


def _ref_owned_by(m, router, owner_cid, size):
    oid = m.ids.ObjectID.from_random()
    router._oid_owner[oid.binary()] = owner_cid
    router._oid_sizes[oid.binary()] = size
    return m.worker.ObjectRef(oid, _add_ref=False)


def _load_slack(m):
    if m.pkg == "ray_tpu":
        return m.router.GlobalConfig.locality_load_slack
    return m.router.LOCALITY_LOAD_SLACK


def test_locality_prefers_node_holding_arg_bytes():
    def case(m):
        r = _bare_router(m)
        nodes = [_node("a", backlog=2), _node("b", backlog=0)]
        r.nodes = lambda refresh=False: nodes
        ref = _ref_owned_by(m, r, "a", 10 << 20)
        return (r._choose_node(_spec(m, args=(ref,)))["client_id"],
                r._choose_node(_spec(m))["client_id"])

    assert twin_units(case) == ("ok", ("a", "b"))


def test_locality_yields_to_load_past_slack():
    def case(m):
        r = _bare_router(m)
        nodes = [_node("a", backlog=int(_load_slack(m)) + 5),
                 _node("b", backlog=0)]
        r.nodes = lambda refresh=False: nodes
        ref = _ref_owned_by(m, r, "a", 10 << 20)
        return r._choose_node(_spec(m, args=(ref,)))["client_id"]

    assert twin_units(case) == ("ok", "b")


def test_locality_pending_dep_colocates_chain():
    def case(m):
        r = _bare_router(m)
        nodes = [_node("a"), _node("b")]
        r.nodes = lambda refresh=False: nodes
        oid = m.ids.ObjectID.from_random()
        r._task_target[oid.task_id()] = "b"  # producer assigned, not done
        ref = m.worker.ObjectRef(oid, _add_ref=False)
        return r._choose_node(_spec(m, args=(ref,)))["client_id"]

    assert twin_units(case) == ("ok", "b")


class _FakeStore:
    def __init__(self):
        self._ready = {}
        self._cbs = {}

    def on_ready(self, oid, cb):
        if oid in self._ready:
            cb()
        else:
            self._cbs.setdefault(oid, []).append(cb)

    def put_value(self, oid):
        self._ready[oid] = True
        for cb in self._cbs.pop(oid, []):
            cb()

    def is_ready(self, oid):
        return oid in self._ready

    def peek_error(self, oid):
        return None


def test_await_dep_event_driven_and_typed_timeout():
    def case(m):
        r = _bare_router(m)
        r.worker = types.SimpleNamespace(store=_FakeStore())
        oid = m.ids.ObjectID.from_random()
        try:
            r._await_dep(oid, timeout=0.15)
            first = "returned"
        except m.exc.GetTimeoutError as exc:
            first = type(exc).__name__
        produced = []

        def _produce():
            produced.append(time.monotonic())
            r.worker.store.put_value(oid)

        t = threading.Timer(0.05, _produce)
        t.start()
        r._await_dep(oid, timeout=5.0)
        returned = time.monotonic()
        t.join()
        return first, bool(produced) and produced[0] <= returned

    assert twin_units(case) == ("ok", ("GetTimeoutError", True))


def test_await_dep_raises_producer_failure():
    def case(m):
        r = _bare_router(m)
        r.worker = types.SimpleNamespace(store=_FakeStore())
        oid = m.ids.ObjectID.from_random()
        tid = oid.task_id()
        r._failed[tid] = ValueError("producer failed")
        ev = threading.Event()
        ev.set()
        r._done[tid] = ev
        r.lineage[tid] = object()
        r._await_dep(oid, timeout=1.0)

    assert twin_units(case) == ("err", "ValueError")


def test_failure_cascade_is_iterative_not_recursive():
    def case(m):
        r = _bare_router(m)
        errs = {}

        class _Store:
            @staticmethod
            def put_error(oid, exc):
                errs[oid.binary()] = exc

        r.worker = types.SimpleNamespace(store=_Store())
        specs = [_spec(m) for _ in range(2000)]
        for s in specs:
            r.lineage[s.task_id] = s
        for up, down in zip(specs, specs[1:]):
            r._dep_children[up.task_id] = {down.task_id}
        r._fail(specs[0], ValueError("root failure"))
        return len(r._failed), len(errs)

    assert twin_units(case) == ("ok", (2000, 2000))


def _bare_daemon(m):
    d = m.daemon.NodeDaemon.__new__(m.daemon.NodeDaemon)
    d._draining = False
    d.drain_refusals = 0
    d._fn_cache = OrderedDict()
    d._fn_cache_bytes = 0
    d._fn_cache_cap = 64 << 20
    d._fn_lock = threading.Lock()
    d.fn_bytes_received = 0
    d._seen_tasks = set()
    d._seen_order = deque()
    d._seen_lock = threading.Lock()

    class _Intake:
        def __init__(self):
            self.submitted = []

        def submit(self, fn, *a):
            self.submitted.append(a)

    d.worker = types.SimpleNamespace(store=_FakeStore())
    d._intake = _Intake()
    d._gated = _Intake()
    return d


def test_need_fn_protocol_round_trip():
    import cloudpickle

    def case(m):
        d = _bare_daemon(m)
        fn_bytes = cloudpickle.dumps(lambda x: x + 1)
        digest = hashlib.sha256(fn_bytes).digest()

        def payload(tid, **kw):
            return pickle.dumps(dict(
                {"task_id": tid, "return_ids": [], "num_returns": 0,
                 "name": "t", "resources": {}, "max_retries": 0,
                 "retry_exceptions": False, "args": [], "kwargs": {},
                 "driver_id": "d"}, **kw))

        cold = payload(b"t" * 24, fn_digest=digest)
        out = [d._accept_payload(cold), len(d._intake.submitted)]
        warm = payload(b"u" * 24, fn_digest=digest, fn=fn_bytes)
        out += [d._accept_payload(warm),
                d.fn_bytes_received == len(fn_bytes)]
        out += [d._accept_payload(cold),
                d.fn_bytes_received == len(fn_bytes),
                len(d._intake.submitted)]
        out += [d._accept_payload(cold), len(d._intake.submitted),
                d._load_fn(digest)(41)]
        return out

    assert twin_units(case) == ("ok", ["need_fn", 0, "accepted", True,
                                       "accepted", True, 2, "accepted", 2,
                                       42])


# ------------------------------------------------------------ slow cluster
def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["RAY_TPU_HEAD_CLIENT_TIMEOUT_S"] = "2.0"
    env.update(extra)
    return env


def _read_line(proc, bound=T):
    import selectors

    with selectors.DefaultSelector() as sel:
        sel.register(proc.stdout, selectors.EVENT_READ)
        if not sel.select(timeout=bound):
            raise TimeoutError(f"no line from pid {proc.pid} within {bound} s")
    return proc.stdout.readline()


def _stop(*procs):
    for p in procs:
        if p is not None and p.poll() is None:
            p.kill()
            p.wait(timeout=10)




def _cluster_case(case):
    """``case(side)`` on a fresh head and two thread-plane daemons
    (``{n1: 1}``, ``{n2: 1}``) a side, this driver attached with no CPU
    once both daemons' direct addresses are in the directory."""
    out = {}
    for pkg in SIDES:
        m = _mods(pkg)
        procs = []
        try:
            head = subprocess.Popen(
                [sys.executable, "-m", f"{pkg}._private.head_service",
                 "--port", "0"], stdout=subprocess.PIPE, text=True,
                env=_env())
            procs.append(head)
            address = _read_line(head).strip().rsplit(" ", 1)[-1]
            nodes = []
            for res in ('{"n1": 1}', '{"n2": 1}'):
                p = subprocess.Popen(
                    [sys.executable, "-m", f"{pkg}._private.node_daemon",
                     "--address", address, "--num-cpus", "1",
                     "--resources", res, "--worker-mode", "thread"],
                    stdout=subprocess.PIPE, text=True, env=_env())
                procs.append(p)
                nodes.append(p)
            for p in nodes:
                assert "joined" in _read_line(p)
            gpu = {"num_tpus": 0} if pkg == "ray_tpu" else {"num_gpus": 0}
            w = m.rt.init(num_cpus=0, worker_mode="thread", address=address,
                          **gpu)
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                recs = w.head_client.node_list()
                if len(recs) >= 2 and all(x.get("peer_addr") for x in recs):
                    break
                time.sleep(0.1)
            m.w, m.node1, m.node2 = w, nodes[0], nodes[1]
            out[pkg] = _outcome(lambda: case(m))
        finally:
            m.rt.shutdown()
            _stop(*procs)
    assert out["ray_tpu_torch"] == out["ray_tpu"], out
    return out["ray_tpu"]


@pytest.fixture
def _client_timeout():
    os.environ["RAY_TPU_HEAD_CLIENT_TIMEOUT_S"] = "2.0"
    for pkg in SIDES:
        importlib.import_module(pkg).shutdown()
    yield
    os.environ.pop("RAY_TPU_HEAD_CLIENT_TIMEOUT_S", None)


@pytest.mark.slow
def test_steady_state_dispatch_never_relays(_client_timeout):
    def case(m):
        r = m.w.remote_router

        @m.rt.remote
        def noop(x):
            return x

        out = m.rt.get([noop.remote(i) for i in range(60)], timeout=T)
        return (out == list(range(60)), r.direct_pushes >= 60,
                r.relayed_pushes, r.direct_done_reports >= 60,
                r.relayed_done_reports, r.inline_results >= 60,
                r.fn_payloads_with_bytes <= 2,
                r.fn_payloads_digest_only >= 58)

    assert _cluster_case(case) == ("ok", (True, True, 0, True, 0, True,
                                          True, True))


@pytest.mark.slow
def test_direct_dial_failure_falls_back_to_relay(_client_timeout):
    def case(m):
        server = importlib.import_module(f"{m.pkg}._private.object_server")
        r = m.w.remote_router

        @m.rt.remote
        def noop(x):
            return x

        peers = m.w.head_client._peers

        def _dead(addr, msgs):
            raise server.PeerUnreachableError(f"poisoned {addr}")

        orig = peers.call_many
        peers.call_many = _dead
        try:
            out = m.rt.get([noop.remote(i) for i in range(10)], timeout=T)
            return out == list(range(10)), r.relayed_pushes >= 10
        finally:
            peers.call_many = orig

    assert _cluster_case(case) == ("ok", (True, True))


@pytest.mark.slow
def test_node_killed_between_accept_and_push_reroutes(_client_timeout):
    def case(m):
        r = m.w.remote_router
        node2 = next(n for n in m.w.head_client.node_list()
                     if "n2" in (n["resources"] or {}))
        strategies = importlib.import_module(
            f"{m.pkg}.util.scheduling_strategies")
        orig_push_group = r._push_group
        release = threading.Event()

        def _stalled(node, entries):
            if node["client_id"] == node2["client_id"]:
                release.wait(10.0)
            orig_push_group(node, entries)

        r._push_group = _stalled
        try:
            ref = m.rt.remote(lambda: "survived").options(
                scheduling_strategy=strategies.NodeAffinitySchedulingStrategy(
                    node2["node_id"], soft=True)).remote()
            m.node2.kill()
            m.node2.wait(timeout=10)
            release.set()
            return m.rt.get(ref, timeout=T)
        finally:
            r._push_group = orig_push_group
            release.set()

    assert _cluster_case(case) == ("ok", "survived")


@pytest.mark.slow
def test_locality_places_consumer_on_owning_node(_client_timeout):
    def case(m):
        w = m.w
        hc = w.head_client

        @m.rt.remote(resources={"n1": 0.1})
        def produce():
            return b"x" * (8 << 20)  # far above the inline cap

        pkg = m.pkg

        @m.rt.remote
        def consume(blob):
            import importlib as _il

            wmod = _il.import_module(f"{pkg}._private.worker")
            return (wmod.global_worker().node_id.hex(), len(blob))

        big = produce.remote()
        tid = big.object_id.task_id()
        deadline = time.monotonic() + T
        while time.monotonic() < deadline:
            ev = w.remote_router._done.get(tid)
            if ev is not None and ev.is_set():
                break
            time.sleep(0.05)
        pulled = []
        orig_pull = hc._peers.pull

        def _spy(addr, oid_bin):
            pulled.append(bytes(oid_bin))
            return orig_pull(addr, oid_bin)

        hc._peers.pull = _spy
        try:
            node_hex, nbytes = m.rt.get(consume.remote(big), timeout=T)
        finally:
            hc._peers.pull = orig_pull
        owner = next(n for n in hc.node_list()
                     if "n1" in (n["resources"] or {}))
        return (nbytes, node_hex == owner["node_id"],
                big.object_id.binary() in pulled,
                w.store.is_ready(big.object_id))

    assert _cluster_case(case) == ("ok", (8 << 20, True, False, False))


@pytest.mark.slow
def test_async_dependency_shipping_overlaps(_client_timeout):
    def case(m):
        r = m.w.remote_router

        @m.rt.remote(resources={"n1": 0.1})
        def slow_produce():
            import time as _t

            _t.sleep(1.5)
            return 7

        @m.rt.remote(resources={"n2": 0.1})
        def consume(x):
            return x * 6

        a = slow_produce.remote()
        b = consume.remote(a)
        b_tid, a_tid = b.object_id.task_id(), a.object_id.task_id()
        deadline = time.monotonic() + 1.2  # inside the producer's sleep
        shipped_early = False
        while time.monotonic() < deadline:
            with r._lock:
                shipped = b_tid in r._task_node
                a_done = r._done[a_tid].is_set() if a_tid in r._done \
                    else False
            if shipped and not a_done:
                shipped_early = True
                break
            time.sleep(0.02)
        return shipped_early, m.rt.get(b, timeout=T)

    assert _cluster_case(case) == ("ok", (True, 42))


@pytest.mark.slow
def test_remote_error_propagates_typed_and_fast(_client_timeout):
    def case(m):
        @m.rt.remote
        def boom():
            raise ValueError("remote kaboom")

        @m.rt.remote
        def after(x):
            return x

        ref = boom.remote()
        child = after.remote(ref)
        out = []
        for r in (ref, child):
            try:
                m.rt.get(r, timeout=30)
                out.append("no error")
            except ValueError as exc:
                out.append(("ValueError", "remote kaboom" in str(exc)))
        failed = ref.object_id.task_id() in m.w.remote_router._failed
        return out, failed

    assert _cluster_case(case) == ("ok", ([("ValueError", True)] * 2, True))
