"""Twins of ``tests/test_elastic.py``: typed node-launch failures, the
bounded join read, drain-before-reap (a reaped node's borrowed bytes move
to their owner first), the idle-reap push race (refuse and reroute), the
drain's exactly-once claims, the provider brown-out and Serve's
scale-to-zero wake, the reference's (``ray_tpu.autoscaler``, its head
and node daemons) beside the port's (``ray_tpu_torch.autoscaler``).

Each case is a function of a side and runs once per side; the values and
the error type names must be equal. The cases that neither kill nor
restart a head share one head process per side for the module; each
case starts its own daemons (by hand or through the autoscaler), waits
until exactly the daemons it expects are live, and moves its driver's id
counters past earlier drivers' (``_fresh_ids``). Every wait is bounded
and every subprocess is killed in a ``finally``. Two reference bounds on
wall time are replaced by orders of events: the join read on a silent
daemon returns while that daemon still runs, and the waking request's
``GetTimeoutError`` arrives while the deployment still has no replica.
"""

import importlib
import itertools
import os
import subprocess
import sys
import threading
import time
import types

import pytest

SIDES = ("ray_tpu", "ray_tpu_torch")
T = 60.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["RAY_TPU_HEAD_CLIENT_TIMEOUT_S"] = "2.0"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
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


@pytest.fixture(scope="module")
def heads():
    procs, made = [], {}
    os.environ["RAY_TPU_HEAD_CLIENT_TIMEOUT_S"] = "2.0"
    try:
        for pkg in SIDES:
            p = subprocess.Popen(
                [sys.executable, "-m", f"{pkg}._private.head_service",
                 "--port", "0"], stdout=subprocess.PIPE, text=True,
                env=_spawn_env())
            procs.append(p)
            made[pkg] = _read_line(p).strip().rsplit(" ", 1)[-1]
        yield made
    finally:
        _stop(*procs)
        os.environ.pop("RAY_TPU_HEAD_CLIENT_TIMEOUT_S", None)


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the outcome
        return ("err", type(exc).__name__)


def _side(pkg, heads=None):
    return types.SimpleNamespace(
        pkg=pkg, rt=importlib.import_module(pkg),
        au=importlib.import_module(f"{pkg}.autoscaler"),
        cfg=importlib.import_module(f"{pkg}._private.config").GlobalConfig,
        exc=importlib.import_module(f"{pkg}.exceptions"),
        state=importlib.import_module(f"{pkg}.util.state"),
        strategies=importlib.import_module(
            f"{pkg}.util.scheduling_strategies"),
        addr=heads[pkg] if heads else None)


def twin(case, heads=None):
    """``case(side)`` on each side; the outcomes must be equal."""
    out = {}
    for pkg in SIDES:
        side = _side(pkg, heads)
        side.rt.shutdown()
        try:
            out[pkg] = _outcome(lambda: case(side))
        finally:
            side.rt.shutdown()
            side.cfg.reset()
    assert out["ray_tpu_torch"] == out["ray_tpu"], out
    return out["ray_tpu"]


_ATTACHES = itertools.count(1)


def _attach(side):
    """This driver on the side's shared head with no CPU and no
    accelerator, its id counters past every earlier driver's (a shared
    head outlives each one)."""
    gpu = {"num_tpus": 0} if side.pkg == "ray_tpu" else {"num_gpus": 0}
    w = side.rt.init(num_cpus=0, worker_mode="thread", address=side.addr,
                     **gpu)
    base = next(_ATTACHES) * 100_000
    for c in (w.submission_counter, w.put_counter, w.actor_counter):
        c._value = base
    return w


def _live(hc):
    return [x for x in hc.node_list() if x.get("alive") and x.get("peer_addr")]


def _wait_nodes(hc, n, timeout=20.0):
    """Exactly ``n`` live daemons (the daemons of earlier cases on the
    shared head have left the membership)."""
    deadline = time.monotonic() + timeout
    live = _live(hc)
    while time.monotonic() < deadline:
        live = _live(hc)
        if len(live) == n:
            return live
        time.sleep(0.1)
    raise AssertionError(f"cluster never reached {n} nodes: {live}")


def _daemon(side, n=1):
    """``n`` daemons of this side on the thread plane, each joined."""
    procs = []
    try:
        for _ in range(n):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", f"{side.pkg}._private.node_daemon",
                 "--address", side.addr, "--num-cpus", "2",
                 "--worker-mode", "thread"],
                stdout=subprocess.PIPE, text=True, env=_spawn_env()))
        ids = []
        for p in procs:
            line = _read_line(p)
            assert "joined" in line, line
            ids.append(line.strip().rsplit(" ", 1)[-1])
    except BaseException:
        _stop(*procs)
        raise
    return procs, ids


def _scaler(side, min_workers, max_workers, provider=None, interval=0.5):
    return side.au.ClusterAutoscaler(
        side.addr,
        [side.au.NodeTypeConfig("base", {"CPU": 2}, min_workers=min_workers,
                                max_workers=max_workers)],
        provider=provider or side.au.LocalSubprocessProvider(
            side.addr, worker_mode="thread", env=_spawn_env()),
        idle_timeout_s=3600.0, update_interval_s=interval)


def _await_owner(router, ref):
    """The node that holds ``ref``'s result, once its report arrives."""
    ob = ref.object_id.binary()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        with router._lock:
            holder = router._oid_owner.get(ob)
        if holder is not None:
            return holder
        time.sleep(0.05)
    return None


# ------------------------------------------------------------ launch typed
def test_launch_failure_is_typed_with_counters():
    def case(side):
        side.cfg.set("autoscaler_launch_retries", 2)
        side.cfg.set("autoscaler_launch_backoff_s", 0.02)
        side.cfg.set("autoscaler_launch_grace_s", 3.0)
        prov = side.au.LocalSubprocessProvider("127.0.0.1:1")
        try:
            prov.launch(side.au.NodeTypeConfig("base", {"CPU": 1}))
        except side.exc.NodeLaunchFailedError as exc:
            return (exc.node_type, exc.attempts, prov.launch_attempts,
                    prov.launch_failures)
        return "launched"

    assert twin(case) == ("ok", ("base", 2, 2, 2))


def test_read_join_line_bounds_slow_cold_start():
    """EOF returns at once; silence returns at the bound, while the
    silent process still runs (the reference bounds the wall time); a
    joined line returns the line."""

    def case(side):
        read = side.au.LocalSubprocessProvider._read_join_line
        quick_eof = subprocess.Popen(
            [sys.executable, "-c", "pass"], stdout=subprocess.PIPE,
            text=True)
        silent = subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(30)"],
            stdout=subprocess.PIPE, text=True)
        joins = subprocess.Popen(
            [sys.executable, "-c",
             "print('node x joined h:1 as client-abc', flush=True); "
             "import time; time.sleep(30)"],
            stdout=subprocess.PIPE, text=True)
        try:
            eof = read(quick_eof, 5.0)
            quiet = read(silent, 0.5)
            still_running = silent.poll() is None
            line = read(joins, 5.0)
            return (eof, quiet, still_running,
                    line is not None and line.strip().endswith("client-abc"))
        finally:
            _stop(quick_eof, silent, joins)

    assert twin(case) == ("ok", (None, None, True, True))


# -------------------------------------------------------- drain-before-reap
def test_reap_drains_borrowed_refs_before_terminate(heads):
    def case(side):
        w = _attach(side)
        scaler = _scaler(side, 2, 2)
        try:
            _wait_nodes(w.head_client, 2)

            @side.rt.remote
            def big(i):
                return bytes(200_000) + bytes([i])

            ref = big.remote(9)
            router = w.remote_router
            holder = _await_owner(router, ref)
            with scaler._lock:
                victim = next((m for m in scaler._managed
                               if m.client_id == holder), None)
            before = router.offloaded_objects
            scaler._terminate(victim, drain=True)
            summary = scaler.summary()
            ready = w.store.is_ready(ref.object_id)
            val = side.rt.get(ref, timeout=30)
            summ = side.state.autoscaler_summary()
            return (holder is not None, summary["drained_nodes"],
                    summary["drain_transferred_objects"] >= 1,
                    router.offloaded_objects > before, ready,
                    val[-1], len(val), summ["drained_nodes"] >= 1,
                    summ["drain_transferred_objects"] >= 1,
                    summ["launch_attempts"] >= 2,
                    summ["offloaded_objects"] >= 1)
        finally:
            scaler.shutdown()

    assert twin(case, heads) == (
        "ok", (True, 1, True, True, True, 9, 200_001, True, True, True,
               True))


def test_reap_race_push_refuses_and_reroutes(heads):
    def case(side):
        procs, node_ids = _daemon(side, 2)
        try:
            w = _attach(side)
            router = w.remote_router
            _wait_nodes(w.head_client, 2)
            # Drain node A: it cordons itself.
            report = w.head_client.node_drain(node_ids[0], timeout=5.0)
            refused0 = report["refused"]
            # The driver's router must not know: pin its membership to
            # the pre-drain view.
            nodes_now = [n for n in w.head_client.node_list()
                         if n.get("alive")]
            for n in nodes_now:
                n["status"] = dict(n.get("status") or {}, draining=False)
            router._nodes_cache = (time.monotonic() + 3600, nodes_now)
            before = router.drain_reroutes
            node_a = next(n for n in nodes_now
                          if n["client_id"] == node_ids[0])

            @side.rt.remote
            def work(x):
                return x + 1

            # Soft affinity: the draining node first, then the reroute.
            ref = work.options(
                scheduling_strategy=side.strategies.
                NodeAffinitySchedulingStrategy(node_a["node_id"],
                                               soft=True)).remote(41)
            router._nodes_cache = (0.0, [])   # un-pin for the reroute
            got = side.rt.get(ref, timeout=T)
            rerouted = router.drain_reroutes - before
            with router._lock:
                known = node_ids[0] in router._draining_nodes
            refused1 = w.head_client.node_drain(node_ids[0],
                                                timeout=5.0)["refused"]
            spread = side.rt.get([work.remote(i) for i in range(8)],
                                 timeout=T)
            return (refused0, got, rerouted, known, refused1,
                    spread == [i + 1 for i in range(8)],
                    router.drain_reroutes - before)
        finally:
            side.rt.shutdown()
            _stop(*procs)

    assert twin(case, heads) == ("ok", (0, 42, 1, True, 1, True, 1))


def test_drain_raced_by_second_reap(heads):
    def case(side):
        w = _attach(side)
        scaler = _scaler(side, 1, 1)
        try:
            _wait_nodes(w.head_client, 1)

            @side.rt.remote
            def big(i):
                return bytes(200_000) + bytes([i])

            ref = big.remote(7)
            router = w.remote_router
            _await_owner(router, ref)
            with scaler._lock:
                victim = scaler._managed[0]
            before = router.offloaded_objects
            outcomes = []

            def reap():
                outcomes.append(scaler._terminate(victim, drain=True))

            threads = [threading.Thread(target=reap) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            summary = scaler.summary()
            val = side.rt.get(ref, timeout=30)
            return (sorted(outcomes), summary["drained_nodes"],
                    summary["terminated"], summary["managed_nodes"],
                    router.offloaded_objects - before,
                    summary["drain_transferred_objects"], val[-1], len(val))
        finally:
            scaler.shutdown()

    assert twin(case, heads) == (
        "ok", ([False, True], 1, ["base"], 0, 1, 1, 7, 200_001))


def test_drain_rpc_itself_is_exactly_once(heads):
    def case(side):
        procs, _ = _daemon(side, 1)
        try:
            w = _attach(side)
            router = w.remote_router
            node_client = _wait_nodes(w.head_client, 1)[0]["client_id"]

            @side.rt.remote
            def big():
                return bytes(200_000)

            ref = big.remote()
            _await_owner(router, ref)
            before = router.offloaded_objects
            reports = []

            def drain():
                reports.append(dict(w.head_client.node_drain(
                    node_client, timeout=10.0)))

            threads = [threading.Thread(target=drain) for _ in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            flags = sorted(r.get("already_draining", False)
                           for r in reports)
            transferred = [r["transferred"] for r in reports
                           if not r.get("already_draining")]
            return (len(reports), flags, transferred,
                    router.offloaded_objects - before,
                    w.store.is_ready(ref.object_id),
                    len(side.rt.get(ref, timeout=30)))
        finally:
            side.rt.shutdown()
            _stop(*procs)

    assert twin(case, heads) == ("ok", (2, [False, True], [1], 1, True,
                                        200_000))


class _BrownoutProvider:
    """Provider decorator: every launch raises the side's
    NodeLaunchFailedError while the brown-out window is closed, then
    delegates once it lifts."""

    def __init__(self, inner, error):
        self.inner = inner
        self.error = error
        self.window_open = False
        self.browned_out_launches = 0

    def launch(self, node_type):
        if not self.window_open:
            self.browned_out_launches += 1
            raise self.error(node_type.name, 1,
                             "provider brown-out: no capacity in any zone")
        return self.inner.launch(node_type)

    def terminate(self, handle):
        return self.inner.terminate(handle)

    def poll_alive(self, handle):
        return self.inner.poll_alive(handle)

    @property
    def launch_attempts(self):
        return self.inner.launch_attempts + self.browned_out_launches

    @property
    def launch_failures(self):
        return self.inner.launch_failures + self.browned_out_launches


def test_provider_brownout_demand_preserved_until_window_lifts(heads):
    def case(side):
        w = _attach(side)
        _wait_nodes(w.head_client, 0)
        prov = _BrownoutProvider(side.au.LocalSubprocessProvider(
            side.addr, worker_mode="thread", env=_spawn_env()),
            side.exc.NodeLaunchFailedError)
        scaler = _scaler(side, 0, 2, provider=prov, interval=0.3)
        try:
            @side.rt.remote
            def work(x):
                return x + 1

            refs = [work.remote(i) for i in range(4)]
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and scaler.launch_errors < 2:
                time.sleep(0.1)
            errors_seen = scaler.launch_errors >= 2
            browned = prov.browned_out_launches >= 2
            managed = scaler.summary()["managed_nodes"]
            parked = _outcome(lambda: side.rt.get(refs[0], timeout=0.2))
            prov.window_open = True
            done = side.rt.get(refs, timeout=90)
            summary = scaler.summary()
            return (errors_seen, browned, managed, parked, done,
                    summary["managed_nodes"] >= 1,
                    summary["launch_failures"] >= 2,
                    any(e.get("joined") for e in summary["scale_events"]))
        finally:
            scaler.shutdown()

    assert twin(case, heads) == (
        "ok", (True, True, 0, ("err", "GetTimeoutError"), [1, 2, 3, 4],
               True, True, True))


# ------------------------------------------------------- scale-to-zero wake
def test_scale_to_zero_then_wake_queues_not_sheds():
    def case(side):
        rt = side.rt
        serve = importlib.import_module(f"{side.pkg}.serve")
        rt.init(num_cpus=2, worker_mode="thread", ignore_reinit_error=True)
        serve.start()

        @serve.deployment(name="z", num_replicas=1,
                          autoscaling_config={
                              "min_replicas": 0, "max_replicas": 2,
                              "target_ongoing_requests": 2.0,
                              "upscale_delay_s": 0.2,
                              "downscale_delay_s": 0.4},
                          max_ongoing_requests=8)
        class Echo:
            def __init__(self):
                time.sleep(0.3)   # a visible wake window

            def __call__(self, x):
                return x * 2

        try:
            handle = serve.run(Echo.bind())
            first = handle.remote(3).result(timeout=30)
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline:
                st = serve.status()["z"]
                if st["replicas"] == 0 and st["target_replicas"] == 0:
                    break
                time.sleep(0.1)
            idle_replicas = serve.status()["z"]["replicas"]
            results, errors = [], []

            def fire(x):
                try:
                    results.append(handle.remote(x).result(timeout=30))
                except BaseException as exc:  # noqa: BLE001
                    errors.append(type(exc).__name__)

            t1 = threading.Thread(target=fire, args=(5,))
            t1.start()
            time.sleep(0.05)   # the second request lands mid-wake
            t2 = threading.Thread(target=fire, args=(7,))
            t2.start()
            t1.join(40)
            t2.join(40)
            st = serve.status()["z"]
            reasons = {e["reason"] for e in st["scale_events"]}
            return (first, idle_replicas, errors, sorted(results),
                    st["wake_events"], {"idle", "wake"} <= reasons)
        finally:
            serve.shutdown()

    assert twin(case) == ("ok", (6, 0, [], [10, 14], 1, True))


def test_wake_timeout_surfaces_typed(heads):
    """A deployment that can never place a replica fails the waking
    request with GetTimeoutError at the wake bound, while it still has no
    replica (the reference bounds the wall time)."""

    def case(side):
        serve = importlib.import_module(f"{side.pkg}.serve")
        _attach(side)
        serve.start()
        side.cfg.set("serve_wake_timeout_s", 1.0)

        @serve.deployment(name="never", num_replicas=1,
                          ray_actor_options={"resources": {"nope": 1.0}})
        class Never:
            def __call__(self, x):
                return x

        try:
            handle = serve.run(Never.bind())
            err = _outcome(lambda: handle.remote(1))
            return err, serve.status()["never"]["replicas"]
        finally:
            serve.shutdown()

    assert twin(case, heads) == ("ok", (("err", "GetTimeoutError"), 0))


def test_no_ref_loss_error_types_in_drain_paths():
    def case(side):
        exc = side.exc.NodeDrainingError("node-1")
        launch = side.exc.NodeLaunchFailedError("t", 3)
        return ("node-1" in str(exc),
                isinstance(exc, (side.exc.ObjectLostError,
                                 side.exc.OwnerDiedError)),
                launch.attempts, launch.node_type, str(launch))

    assert twin(case) == ("ok", (True, False, 3, "t",
                                 "node type 't' failed to launch after 3 "
                                 "attempt(s)"))
