"""Twins of ``tests/test_ownership.py``: the ownership-based object
directory, the reference's (``ray_tpu/_private/ownership.py``) beside the
port's (``ray_tpu_torch/_private/ownership.py``). A borrowed ref resolves
through its owner with no head directory entry; the locate, subscribe and
notify protocol; the lease handoff through ``object_transfer``; typed
errors for a dead owner and an unresolvable ref; the head's RPC counters
and ``ownership_summary``.

Each case is a function of a side and runs once per side; the values and
the error type names must be equal. Each side has one head and one peer
driver (a subprocess that puts the objects and writes their refs to the
KV) for the module; the case's driver attaches to them afresh. Every
wait is bounded and every subprocess is killed in a ``finally``.

``test_unresolvable_foreign_ref_times_out_typed``'s wall-clock bound (the
get returns within 10 s) is checked as an order of events instead: the
get raises ``GetTimeoutError`` at its own 2 s timeout.
``test_dashboard_api_head`` reads ``/api/head`` from each side's
dashboard.
"""

import importlib
import os
import pickle
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


# The reference's peer driver, for either package: it puts a value whose
# ref goes to the KV pickled (never announced), and announces a second
# value when asked; it holds its objects until the module ends.
_PEER = r"""
import importlib, sys, time
import cloudpickle
rt = importlib.import_module(sys.argv[2])
rt.init(num_cpus=1, worker_mode="thread", address=sys.argv[1])
w = rt._private.worker.global_worker()
ref = rt.put({"secret": list(range(1000))})
w.kv_put(b"own/ref", cloudpickle.dumps(ref))
w.kv_put(b"own/oid", ref.object_id.hex().encode())
w.kv_put(b"own/client", w.head_client.client_id.encode())
late = rt.put("late-bird")
w.kv_put(b"own/late_oid", late.object_id.hex().encode())
w.kv_put(b"own/ready", b"1")
deadline = time.time() + 600
while time.time() < deadline:
    if w.kv_get(b"own/want_late") is not None:
        time.sleep(1.0)  # the consumer is inside its wait by now
        rt.announce_object(late)
        w.kv_put(b"own/late_announced", b"1")
        w.kv_del(b"own/want_late")
    if w.kv_get(b"own/done") is not None:
        break
    time.sleep(0.05)
rt.shutdown()
"""


@pytest.fixture(scope="module")
def heads():
    procs, addrs = [], {}
    os.environ["RAY_TPU_HEAD_CLIENT_TIMEOUT_S"] = "2.0"
    try:
        for pkg in SIDES:
            head = subprocess.Popen(
                [sys.executable, "-m", f"{pkg}._private.head_service",
                 "--port", "0"], stdout=subprocess.PIPE, text=True,
                env=_env())
            procs.append(head)
            addrs[pkg] = _read_line(head).strip().rsplit(" ", 1)[-1]
        for pkg in SIDES:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _PEER, addrs[pkg], pkg], env=_env()))
        yield addrs
    finally:
        _stop(*procs)
        os.environ.pop("RAY_TPU_HEAD_CLIENT_TIMEOUT_S", None)


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


def twin(case, heads):
    """``case(side)`` on each side, this driver attached to the side's
    head (``num_cpus=2``, the thread plane); outcomes must be equal."""
    out = {}
    for pkg in SIDES:
        rt = importlib.import_module(pkg)
        side = types.SimpleNamespace(
            pkg=pkg, rt=rt,
            ids=importlib.import_module(f"{pkg}._private.ids"),
            exc=importlib.import_module(f"{pkg}.exceptions"),
            worker_mod=importlib.import_module(f"{pkg}._private.worker"))
        try:
            side.w = rt.init(num_cpus=2, worker_mode="thread",
                             address=heads[pkg])
            out[pkg] = _outcome(lambda: case(side))
        finally:
            rt.shutdown()
    assert out["ray_tpu_torch"] == out["ray_tpu"], out
    return out["ray_tpu"]


def _wait_kv(w, key, timeout=T):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = w.kv_get(key)
        if v is not None:
            return v
        time.sleep(0.05)
    raise AssertionError(f"kv key {key} never appeared")


def _return_oid(ids, tid):
    return ids.ObjectID.for_task_return(tid, 0)


def test_borrowed_ref_resolves_owner_direct(heads):
    """A pickled ref carries its owner; the borrower resolves through
    the owner's object server, and the head's directory never holds it."""
    def case(s):
        w = s.w
        _wait_kv(w, b"own/ready")
        ref = pickle.loads(_wait_kv(w, b"own/ref"))
        owner = w.borrowed_owner(ref.object_id.binary())
        client = _wait_kv(w, b"own/client").decode()
        before = w.head_client.head_stats()
        value = s.rt.get(ref, timeout=T)
        res = w.owner_resolver.counters()
        after = w.head_client.head_stats()
        return (owner is not None and owner[0] == client,
                value == {"secret": list(range(1000))},
                res["owner_locates"] >= 1, res["owner_direct_pulls"] >= 1,
                after["rpc_counts"].get("object_announce", 0)
                == before["rpc_counts"].get("object_announce", 0),
                after["num_objects"] == before["num_objects"])

    assert twin(case, heads) == ("ok", (True,) * 6)


def test_owner_locate_protocol_states(heads):
    """ready (a store-held object, its holder named), unknown, and
    pending, then a notify through a subscriber's object server."""
    def case(s):
        w = s.w
        _wait_kv(w, b"own/ready")
        server_mod = importlib.import_module(f"{s.pkg}._private.object_server")
        sched = importlib.import_module(f"{s.pkg}._private.scheduler")
        router = w.remote_router
        directory = router.owner_directory
        local = s.rt.put([1, 2, 3])
        reply = directory.lookup(local.object_id.binary())
        ready = (reply["status"],
                 tuple(reply["addr"]) == w.head_client._object_server.address,
                 reply["holder"] == w.head_client.client_id)
        unknown = directory.lookup(b"\x00" * 28)["status"]
        tid = s.ids.TaskID.from_random()
        spec = sched.TaskSpec(task_id=tid, function=lambda: None, args=(),
                              kwargs={}, num_returns=1,
                              return_ids=[_return_oid(s.ids, tid)],
                              name="t", resources={})
        with router._lock:
            router.lineage[tid] = spec
            router._done.setdefault(tid, threading.Event())
        ob = spec.return_ids[0].binary()
        notices, got = [], threading.Event()

        def _on_notify(msg):
            notices.append(pickle.loads(bytes(msg[1])))
            got.set()

        sub_srv = server_mod.ObjectServer(lambda _ob: b"",
                                          w.head_client.token)
        try:
            sub_srv.handlers["owner_notify"] = _on_notify
            pending = directory._on_owner_locate(
                ("owner_locate", ob, list(sub_srv.address)))["status"]
            done = pickle.dumps({
                "task_id": tid.binary(), "oid_bins": [ob],
                "node_client": w.head_client.client_id,
                "sizes": {}, "errs": {},
                "inline": {ob: w.serialization_context.serialize(
                    "produced").to_bytes()},
            }, protocol=5)
            router._on_task_done(("task_done", done))
            notified = got.wait(T)
        finally:
            sub_srv.shutdown()
        return (ready, unknown, pending, notified, notices[0]["oid"] == ob,
                notices[0]["reply"]["status"])

    assert twin(case, heads) == ("ok", (("ready", True, True), "unknown",
                                        "pending", True, True, "ready"))


def test_dead_owner_materializes_typed_error(heads):
    """An unreachable owner that membership does not know, with no head
    fallback entry: a typed OwnerDiedError, not an endless poll."""
    def case(s):
        oid = s.ids.ObjectID.for_task_return(s.ids.TaskID.from_random(), 0)
        resolver = s.w.owner_resolver
        resolver.resolve(oid.binary(), ("127.0.0.1", 1), "driver-deadbeef",
                         deadline=time.monotonic() + 20)
        err = s.w.store.peek_error(oid)
        return (type(err).__name__, isinstance(err, s.exc.OwnerDiedError),
                resolver.counters()["owner_died_errors"] >= 1)

    assert twin(case, heads) == ("ok", ("OwnerDiedError", True, True))


def test_unresolvable_foreign_ref_times_out_typed(heads):
    """An owner-less foreign ref nobody announces raises GetTimeoutError
    at the get's own timeout."""
    def case(s):
        ref = s.worker_mod.ObjectRef(s.ids.ObjectID.from_hex("ab" * 28),
                                     _add_ref=False)
        try:
            s.rt.get(ref, timeout=2.0)
        except s.exc.GetTimeoutError as exc:
            return type(exc).__name__
        return "no error"

    assert twin(case, heads) == ("ok", "GetTimeoutError")


def test_object_transfer_lease_handoff(heads):
    """``object_transfer`` records the holder in the head's fallback
    directory, so a ref with no owner still resolves; a transfer naming
    an unknown holder is refused."""
    def case(s):
        w = s.w
        _wait_kv(w, b"own/ready")
        oid_hex = _wait_kv(w, b"own/oid").decode()
        peer_client = _wait_kv(w, b"own/client").decode()
        ob = s.ids.ObjectID.from_hex(oid_hex).binary()
        w.head_client.object_transfer_many([(ob, peer_client)])
        ref = s.worker_mod.ObjectRef(s.ids.ObjectID.from_hex(oid_hex))
        value = s.rt.get(ref, timeout=T)
        ghost = os.urandom(24)
        w.head_client.object_transfer_many([(ghost, "driver-ghost")])
        located = w.head_client._request(("object_locate", ghost))
        return value == {"secret": list(range(1000))}, located

    assert twin(case, heads) == ("ok", (True, None))


def test_router_shutdown_transfers_owner_table(heads):
    """The lease handoff's wire path: the router's location table goes
    to the head in one flight, its entries naming live holders."""
    def case(s):
        w = s.w
        _wait_kv(w, b"own/ready")
        peer_client = _wait_kv(w, b"own/client").decode()
        router = w.remote_router
        fake_oid = os.urandom(24)
        with router._lock:
            router._oid_owner[fake_oid] = peer_client
        entries = router.owner_directory.snapshot_locations()
        w.head_client.object_transfer_many(entries)
        located = w.head_client._request(("object_locate", fake_oid))
        return ((fake_oid, peer_client) in entries,
                located is not None and located["owner"] == peer_client)

    assert twin(case, heads) == ("ok", (True, True))


def test_foreign_ref_announced_after_lookup_wakes_event_driven(heads):
    """An owner-less foreign ref announced after the get started wakes
    through the head's ``obj|`` subscription: a handful of head RPCs,
    not one a poll round."""
    def case(s):
        w = s.w
        _wait_kv(w, b"own/ready")
        late_hex = _wait_kv(w, b"own/late_oid").decode()
        ref = s.worker_mod.ObjectRef(s.ids.ObjectID.from_hex(late_hex))
        result, started = {}, threading.Event()

        def _get():
            started.set()
            result["value"] = s.rt.get(ref, timeout=T)

        t = threading.Thread(target=_get, daemon=True)
        t.start()
        started.wait(T)
        time.sleep(0.5)  # the getter is inside its subscribed wait
        before = w.head_client.head_stats()["object_plane_rpcs"]
        w.kv_put(b"own/want_late", b"1")
        _wait_kv(w, b"own/late_announced")
        t.join(timeout=20)
        after = w.head_client.head_stats()["object_plane_rpcs"]
        return (not t.is_alive(), result.get("value"),
                after - before <= 8)

    assert twin(case, heads) == ("ok", (True, "late-bird", True))


def test_head_stats_and_state_surface(heads):
    def case(s):
        stats = s.w.head_client.head_stats()
        state = importlib.import_module(f"{s.pkg}.util.state")
        summary = state.ownership_summary()
        return ("rpc_counts" in stats and stats["rpc_total"] > 0,
                "log_appends" in stats, stats["clients_alive"] >= 1,
                summary["ownership_directory"] is True,
                "owner" in summary and "resolver" in summary,
                summary["head"]["rpc_total"] >= stats["rpc_total"])

    assert twin(case, heads) == ("ok", (True,) * 6)


def test_dashboard_api_head(heads):
    """tests/test_ownership.py::test_dashboard_api_head: the dashboard's
    ``/api/head`` serves the ownership summary with the head's RPC
    counters."""
    import json
    import urllib.request

    def case(s):
        dashboard = importlib.import_module(f"{s.pkg}.dashboard")
        dash = dashboard.start_dashboard(port=0)
        try:
            with urllib.request.urlopen(dash.url + "/api/head",
                                        timeout=10) as r:
                payload = json.loads(r.read())
            return (payload["ownership_directory"] is True,
                    "rpc_counts" in payload["head"])
        finally:
            dashboard.stop_dashboard()

    assert twin(case, heads) == ("ok", (True, True))
