"""Twins of ``tests/test_multinode.py`` and ``tests/test_multinode_actors.py``:
a head process and node daemon processes with distinct resources, the
reference's (``python -m ray_tpu._private.node_daemon``) beside the
port's (``python -m ray_tpu_torch._private.node_daemon``), with a driver
that keeps no CPU of its own, so every task crosses onto a daemon.

Each case is a function of a side and runs once per side; the values and
the error type names must be equal. The cases that neither kill nor
restart a process share one cluster per side for the module (a head and
two thread-plane daemons, ``{CPU: 1, n1: 1}`` and ``{CPU: 1, n2: 1}``).
The process-plane parametrisation of the reference's cluster fixture and
the cases that kill a node get a cluster of their own and are marked
slow, as the reference's module is. Every wait is bounded and every
subprocess is killed in a ``finally``.
"""

import importlib
import itertools
import os
import subprocess
import sys
import textwrap
import time
import types

import pytest

SIDES = ("ray_tpu", "ray_tpu_torch")
T = 60.0  # bound on every wait of a case
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["RAY_TPU_HEAD_CLIENT_TIMEOUT_S"] = "2.0"
    env.update(extra)
    return env


def _read_line(proc, bound=T):
    """The next line of ``proc``'s stdout, within ``bound`` seconds."""
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


def _spawn_head(pkg):
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}._private.head_service", "--port", "0"],
        stdout=subprocess.PIPE, text=True, env=_env())
    try:
        line = _read_line(proc)
    except BaseException:
        _stop(proc)
        raise
    return proc, line.strip().rsplit(" ", 1)[-1]


def _spawn_nodes(pkg, address, specs, procs):
    """Start one daemon per ``(num_cpus, resources_json, mode)`` at once
    (appended to ``procs`` as they start), then read each one's
    ``joined`` line."""
    started = []
    for num_cpus, resources, mode in specs:
        p = subprocess.Popen(
            [sys.executable, "-m", f"{pkg}._private.node_daemon",
             "--address", address, "--num-cpus", str(num_cpus),
             "--resources", resources, "--worker-mode", mode],
            stdout=subprocess.PIPE, text=True, env=_env())
        procs.append(p)
        started.append(p)
    for p in started:
        line = _read_line(p)
        assert "joined" in line, line
    return started


def _cluster(pkg, mode="thread"):
    """(procs, address, node1, node2): a head and two daemons."""
    procs = []
    try:
        head, address = _spawn_head(pkg)
        procs.append(head)
        n1, n2 = _spawn_nodes(pkg, address, [(1, '{"n1": 1}', mode),
                                            (1, '{"n2": 1}', mode)], procs)
    except BaseException:
        _stop(*procs)
        raise
    return procs, address, n1, n2


_ATTACHES = itertools.count(1)


def _fresh_ids(w):
    """Start this driver's task, put and actor counters past every
    earlier attach's. Ids derive from the job (this process's pid) and
    the counters, and a shared cluster outlives each driver: a node's
    store still holds the results of an earlier driver's tasks of the
    same ids."""
    base = next(_ATTACHES) * 100_000
    for c in (w.submission_counter, w.put_counter, w.actor_counter):
        c._value = base
    return w


def _attach(rt, pkg, address, **kw):
    gpu = {"num_tpus": 0} if pkg == "ray_tpu" else {"num_gpus": 0}
    return _fresh_ids(rt.init(num_cpus=0, worker_mode="thread",
                              address=address, **gpu, **kw))


@pytest.fixture(scope="module")
def clusters():
    made, procs = {}, []
    os.environ["RAY_TPU_HEAD_CLIENT_TIMEOUT_S"] = "2.0"
    try:
        for pkg in SIDES:
            p, address, n1, n2 = _cluster(pkg)
            procs += p
            made[pkg] = types.SimpleNamespace(address=address, node1=n1,
                                              node2=n2)
        yield made
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


def _side(pkg, cluster=None):
    rt = importlib.import_module(pkg)
    return types.SimpleNamespace(
        pkg=pkg, rt=rt, w=lambda: rt._private.worker.global_worker(),
        strategies=importlib.import_module(
            f"{pkg}.util.scheduling_strategies"),
        exceptions=importlib.import_module(f"{pkg}.exceptions"),
        c=cluster)


def twin(case, clusters=None, attach=True):
    """``case(side)`` on each side, with this driver attached to the
    side's cluster (``attach``); the outcomes must be equal."""
    out = {}
    for pkg in SIDES:
        side = _side(pkg, clusters[pkg] if clusters else None)
        try:
            if attach:
                _attach(side.rt, pkg, side.c.address)
            out[pkg] = _outcome(lambda: case(side))
        finally:
            side.rt.shutdown()
    assert out["ray_tpu_torch"] == out["ray_tpu"], out
    return out["ray_tpu"]


def _counter(rt):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def add(self, k=1):
            self.n += k
            return self.n

        def total(self):
            return self.n

        def pid(self):
            import os as _os

            return _os.getpid()

    return Counter


def _node_rec(w, res):
    return next(n for n in w.head_client.node_list()
                if res in (n["resources"] or {}))


def _spy_pulls(w):
    """Record every object the driver pulls peer to peer; returns
    (pulled list, restore)."""
    pulled = []
    orig = w.head_client._peers.pull

    def _spy(addr, oid_bin):
        pulled.append(bytes(oid_bin))
        return orig(addr, oid_bin)

    w.head_client._peers.pull = _spy

    def restore():
        w.head_client._peers.pull = orig

    return pulled, restore


# ------------------------------------------------- tests/test_multinode.py
def test_membership_lists_both_nodes(clusters):
    def case(s):
        return len(s.w().head_client.cluster_info()["nodes"])

    assert twin(case, clusters) == ("ok", 2)


def test_remote_execution_and_object_pull(clusters):
    def case(s):
        rt = s.rt

        @rt.remote(resources={"n2": 0.1})
        def whoami(payload):
            import os as _os

            return (_os.getpid(), payload * 2)

        pid, doubled = rt.get(whoami.remote(21), timeout=T)
        return pid == s.c.node2.pid, pid != os.getpid(), doubled

    assert twin(case, clusters) == ("ok", (True, True, 42))


def test_spill_spreads_across_nodes(clusters):
    def case(s):
        rt = s.rt

        @rt.remote
        def slow_pid():
            import os as _os
            import time as _time

            _time.sleep(0.3)
            return _os.getpid()

        pids = set(rt.get([slow_pid.remote() for _ in range(6)], timeout=T))
        return len(pids) >= 2, pids <= {s.c.node1.pid, s.c.node2.pid}

    assert twin(case, clusters) == ("ok", (True, True))


def test_chained_remote_tasks_pull_node_to_node(clusters):
    """B on node 2 consumes A's output made on node 1: the driver never
    pulls A's bytes (they travel as a pull ref resolved on node 2)."""
    def case(s):
        rt = s.rt
        pulled, restore = _spy_pulls(s.w())

        @rt.remote(resources={"n1": 0.1})
        def produce():
            return list(range(100))

        @rt.remote(resources={"n2": 0.1})
        def consume(xs):
            return sum(xs)

        try:
            a = produce.remote()
            total = rt.get(consume.remote(a), timeout=T)
        finally:
            restore()
        return total, a.object_id.binary() in pulled

    assert twin(case, clusters) == ("ok", (sum(range(100)), False))


def test_large_object_chunked_pull(clusters):
    def case(s):
        rt = s.rt

        @rt.remote(resources={"n1": 0.1})
        def big():
            import numpy as _np

            return _np.arange(6_000_000, dtype=_np.uint8)  # > one chunk

        arr = rt.get(big.remote(), timeout=T)
        return (arr.shape, int(arr[-1]),
                bool((arr[:256] == __import__("numpy").arange(
                    256, dtype="uint8")).all()))

    assert twin(case, clusters) == ("ok", ((6_000_000,),
                                           (6_000_000 - 1) % 256, True))


def test_ray_client_mode_routes_to_cluster(clusters):
    """``init(address="ray://...")``: the process keeps no capacity and
    every task lands on a node daemon."""
    def case(s):
        rt = s.rt
        w = _fresh_ids(rt.init(address=f"ray://{s.c.address}"))

        @rt.remote
        def where():
            import os as _os

            return _os.getpid()

        pids = set(rt.get([where.remote() for _ in range(4)], timeout=T))
        return (w.client_mode, w.resource_pool.total.get("CPU", 0),
                os.getpid() in pids, pids <= {s.c.node1.pid, s.c.node2.pid})

    assert twin(case, clusters, attach=False) == ("ok",
                                                  (True, 0, False, True))


def test_ray_client_mode_without_nodes_errors():
    """A thin client's task with no cluster capacity fails loudly (the
    reference's RayTpuError naming client mode)."""
    procs = []
    try:
        addrs = {}
        for pkg in SIDES:
            head, addrs[pkg] = _spawn_head(pkg)
            procs.append(head)

        def case(s):
            rt = s.rt
            rt.init(address=f"ray://{addrs[s.pkg]}")

            @rt.remote
            def f():
                return 1

            try:
                f.remote()
            except s.exceptions.RayTpuError as exc:
                return "client-mode" in str(exc)
            return "no error"

        assert twin(case, attach=False) == ("ok", True)
    finally:
        _stop(*procs)


def test_remote_task_env_vars_runtime_env(clusters):
    """runtime_env crosses the push: env_vars apply in the node-side
    execution, and a task without one there does not see them."""

    def case(s):
        rt = s.rt

        @rt.remote(resources={"n1": 0.1},
                   runtime_env={"env_vars": {"RTE_PROBE": "crossed"}})
        def read_env():
            import os as _os

            return _os.environ.get("RTE_PROBE"), _os.getpid()

        @rt.remote(resources={"n1": 0.1})
        def read_plain():
            import os as _os

            return _os.environ.get("RTE_PROBE")

        value, pid = rt.get(read_env.remote(), timeout=T)
        return value, pid == s.c.node1.pid, rt.get(read_plain.remote(),
                                                   timeout=T)

    assert twin(case, clusters) == ("ok", ("crossed", True, None))


def test_direct_peer_object_pull(clusters):
    """The bytes move peer to peer from the holding node; the driver
    finds the holder in its own owner table."""
    def case(s):
        rt = s.rt

        @rt.remote(resources={"n1": 0.1})
        def make():
            return {"blob": list(range(50_000))}

        out = rt.get(make.remote(), timeout=T)
        w = s.w()
        p2p = w.remote_router.owner_table_pulls + w.head_client.direct_pulls
        return out["blob"][-1], p2p > 0

    assert twin(case, clusters) == ("ok", (49_999, True))


def test_peer_pull_falls_back_to_relay(clusters):
    """A peer that every direct attempt fails on degrades to the
    head-relayed chunked pull."""
    def case(s):
        rt = s.rt
        w = s.w()

        @rt.remote(resources={"n2": 0.1})
        def make():
            return "via-relay"

        ref = make.remote()
        orig = w.head_client._peers._pull_attempt
        w.head_client._peers._pull_attempt = \
            lambda addr, oid: ("error", None)
        try:
            before = w.head_client.relayed_pulls
            value = rt.get(ref, timeout=T)
            return value, w.head_client.relayed_pulls > before
        finally:
            w.head_client._peers._pull_attempt = orig

    assert twin(case, clusters) == ("ok", ("via-relay", True))


def _two_node_cluster_case(mode, case):
    """``case(side)`` on a fresh cluster per side (``mode`` daemons)."""
    out = {}
    for pkg in SIDES:
        procs = []
        side = _side(pkg)
        try:
            p, address, n1, n2 = _cluster(pkg, mode)
            procs += p
            side.c = types.SimpleNamespace(address=address, node1=n1,
                                           node2=n2)
            _attach(side.rt, pkg, address)
            out[pkg] = _outcome(lambda: case(side))
        finally:
            side.rt.shutdown()
            _stop(*procs)
    assert out["ray_tpu_torch"] == out["ray_tpu"], out
    return out["ray_tpu"]


@pytest.mark.slow
def test_remote_execution_on_process_plane_nodes():
    """The reference's ``two_node_cluster[process]``: daemons whose tasks
    run in worker processes execute across the machine boundary."""
    def case(s):
        rt = s.rt

        @rt.remote(resources={"n2": 0.1})
        def whoami(payload):
            import os as _os

            return (_os.getpid(), payload * 2)

        @rt.remote(resources={"n1": 0.1})
        def produce():
            return list(range(100))

        @rt.remote(resources={"n2": 0.1})
        def consume(xs):
            return sum(xs)

        pid, doubled = rt.get(whoami.remote(21), timeout=T)
        total = rt.get(consume.remote(produce.remote()), timeout=T)
        return (pid not in (os.getpid(), s.c.node1.pid, s.c.node2.pid),
                doubled, total)

    assert _two_node_cluster_case("process", case) == (
        "ok", (True, 42, sum(range(100))))


@pytest.mark.slow
def test_node_kill_lineage_reexecution(tmp_path):
    """SIGKILL the node holding a result nobody pulled yet: the get
    re-executes the task from lineage on the survivor."""
    def case(s):
        rt = s.rt
        w = s.w()
        node2 = _node_rec(w, "n2")
        marker = str(tmp_path / f"{s.pkg}.runs.log")

        @rt.remote(scheduling_strategy=s.strategies.
                   NodeAffinitySchedulingStrategy(node2["node_id"],
                                                  soft=True))
        def tracked():
            with open(marker, "a") as f:
                f.write("run\n")
            return "alive" * 50_000  # above the inline cap: stays there

        ref = tracked.remote()
        router = w.remote_router
        tid = ref.object_id.task_id()
        deadline = time.monotonic() + T
        while time.monotonic() < deadline:
            ev = router._done.get(tid)
            if ev is not None and ev.is_set():
                break
            time.sleep(0.05)
        local_before = w.store.is_ready(ref.object_id)
        s.c.node2.kill()
        s.c.node2.wait(timeout=10)
        value = rt.get(ref, timeout=T)
        with open(marker) as f:
            runs = f.read().count("run")
        return local_before, value == "alive" * 50_000, runs

    assert _two_node_cluster_case("thread", case) == ("ok", (False, True, 2))


@pytest.mark.slow
def test_inflight_tasks_reroute_off_dead_node():
    """A task in flight on a killed node reroutes to the survivor (the
    reference sleeps to place it; here the victim is pinned to node 2 by
    soft affinity, then node 2 is killed once it runs there)."""
    def case(s):
        rt = s.rt
        w = s.w()
        node2 = _node_rec(w, "n2")

        @rt.remote
        def eventually():
            import time as _time

            _time.sleep(1.0)
            return "done"

        pin = [eventually.remote() for _ in range(2)]
        victim = eventually.options(
            scheduling_strategy=s.strategies.NodeAffinitySchedulingStrategy(
                node2["node_id"], soft=True)).remote()
        router = w.remote_router
        tid = victim.object_id.task_id()
        deadline = time.monotonic() + T
        while time.monotonic() < deadline:
            with router._lock:
                if router._task_node.get(tid) == node2["client_id"]:
                    break
            time.sleep(0.02)
        s.c.node2.kill()
        s.c.node2.wait(timeout=10)
        return rt.get(pin + [victim], timeout=T)

    assert _two_node_cluster_case("thread", case) == ("ok", ["done"] * 3)


# ------------------------------------------ tests/test_multinode_actors.py
def test_actor_places_on_resource_node(clusters):
    def case(s):
        rt = s.rt
        a = _counter(rt).options(resources={"n2": 1}).remote(10)
        added = rt.get(a.add.remote(5), timeout=T)
        pid = rt.get(a.pid.remote(), timeout=T)
        w = s.w()
        rec = w.head_client.actor_locate(a._actor_id.binary())
        return (added, pid == s.c.node2.pid, pid != os.getpid(),
                rec is not None and rec["alive"],
                rec["node"] == _node_rec(w, "n2")["client_id"])

    assert twin(case, clusters) == ("ok", (15, True, True, True, True))


def test_actor_spread_lands_on_multiple_nodes(clusters):
    def case(s):
        rt = s.rt
        actors = [_counter(rt).options(scheduling_strategy="SPREAD").remote()
                  for _ in range(4)]
        pids = set(rt.get([a.pid.remote() for a in actors], timeout=T))
        return (bool(pids & {s.c.node1.pid, s.c.node2.pid}),
                len(pids) >= 2)

    assert twin(case, clusters) == ("ok", (True, True))


def test_actor_method_pull_ref_args(clusters):
    """A ref made on node 1 feeds a task on node 2 and a put feeds an
    actor on node 2; the driver never pulls the intermediate."""
    def case(s):
        rt = s.rt
        pulled, restore = _spy_pulls(s.w())

        @rt.remote(resources={"n1": 0.1})
        def produce():
            return list(range(1000))

        @rt.remote(resources={"n2": 0.1})
        def check(xs):
            return sum(xs)

        try:
            ref = produce.remote()
            a = _counter(rt).options(resources={"n2": 1}).remote()
            total = rt.get(check.remote(ref), timeout=T)
            out = rt.get(a.add.remote(rt.put(7)), timeout=T)
        finally:
            restore()
        return total, out, ref.object_id.binary() in pulled

    assert twin(case, clusters) == ("ok", (sum(range(1000)), 7, False))


def test_actor_ordering_and_state(clusters):
    def case(s):
        rt = s.rt
        a = _counter(rt).options(resources={"n1": 1}).remote()
        refs = [a.add.remote() for _ in range(20)]
        return rt.get(refs[-1], timeout=T), rt.get(a.total.remote(),
                                                    timeout=T)

    assert twin(case, clusters) == ("ok", (20, 20))


def test_named_actor_from_second_driver_direct(clusters):
    """Another driver resolves a placed named actor by name and calls it
    direct on the hosting node; both drivers hit one instance."""
    def case(s):
        rt = s.rt
        a = _counter(rt).options(name="shared-counter",
                                 resources={"n1": 1}).remote(100)
        first = rt.get(a.add.remote(1), timeout=T)
        gpu = "num_tpus=0" if s.pkg == "ray_tpu" else "num_gpus=0"
        script = textwrap.dedent(f"""
            import {s.pkg} as rt
            rt.init(num_cpus=0, {gpu}, worker_mode="thread",
                    address={s.c.address!r})
            h = rt.get_actor("shared-counter")
            print("RESULT", rt.get(h.add.remote(10), timeout=60))
            rt.shutdown()
        """)
        out = subprocess.run([sys.executable, "-c", script],
                             capture_output=True, text=True, env=_env(),
                             timeout=2 * T)
        return (first, "RESULT 111" in out.stdout,
                rt.get(a.total.remote(), timeout=T))

    assert twin(case, clusters) == ("ok", (101, True, 111))


def test_actor_handle_crosses_into_task(clusters):
    """A handle pickled into a task on another node resolves through the
    placement directory and calls direct."""
    def case(s):
        rt = s.rt
        a = _counter(rt).options(resources={"n2": 1}).remote()

        @rt.remote(resources={"n1": 0.1})
        def poke(handle, k):
            import importlib as _il

            _rt = _il.import_module(handle.__class__.__module__.split(".")[0])
            return _rt.get(handle.add.remote(k), timeout=60)

        return (rt.get(poke.remote(a, 4), timeout=2 * T),
                rt.get(a.total.remote(), timeout=T))

    assert twin(case, clusters) == ("ok", (4, 4))


def test_kill_remote_actor(clusters):
    def case(s):
        rt = s.rt
        a = _counter(rt).options(resources={"n1": 1}).remote()
        first = rt.get(a.add.remote(), timeout=T)
        rt.kill(a)
        try:
            rt.get(a.add.remote(), timeout=30)
            err = None
        except (s.exceptions.ActorDiedError,
                s.exceptions.RayActorError) as exc:
            err = type(exc).__name__
        return (first, err,
                s.w().head_client.actor_locate(a._actor_id.binary()))

    assert twin(case, clusters) == ("ok", (1, "ActorDiedError", None))


def test_serve_replicas_spread_across_nodes(clusters):
    """``serve.run`` with four replicas places them across both daemons;
    routed calls reach more than one machine."""
    def case(s):
        serve = importlib.import_module(f"{s.pkg}.serve")

        @serve.deployment(num_replicas=4)
        class Who:
            def __call__(self):
                import os as _os

                return _os.getpid()

        try:
            handle = serve.run(Who.bind())
            pids = {handle.remote().result(timeout=T) for _ in range(24)}
            return (bool(pids & {s.c.node1.pid, s.c.node2.pid}),
                    len(pids) >= 2)
        finally:
            serve.shutdown()

    assert twin(case, clusters) == ("ok", (True, True))


def test_trainer_workers_cross_node(clusters):
    """A 2-worker data-parallel run (the reference's ``JaxTrainer``, the
    port's ``DataParallelTrainer``) lands one worker on each daemon (the
    driver has no CPU), with the KV-rendezvous collective crossing the
    process boundary."""
    def case(s):
        import numpy as np

        train = importlib.import_module(f"{s.pkg}.train")
        collective = importlib.import_module(f"{s.pkg}.collective.collective")
        session = train.session

        def loop():
            ctx = session.get_context()
            pid_sum = collective.allreduce(
                np.array([os.getpid()], dtype=np.int64),
                group_name=ctx.collective_group)
            session.report({"rank": ctx.world_rank, "pid": os.getpid(),
                            "pid_sum": int(pid_sum[0])})

        trainer_cls = (train.JaxTrainer if s.pkg == "ray_tpu"
                       else train.DataParallelTrainer)
        result = trainer_cls(loop, scaling_config=train.ScalingConfig(
            num_workers=2, resources_per_worker={"CPU": 0.5})).fit()
        return result.metrics["pid_sum"] == s.c.node1.pid + s.c.node2.pid

    assert twin(case, clusters) == ("ok", True)


@pytest.mark.slow
def test_actor_node_kill_restarts_on_survivor():
    """SIGKILL the hosting node: the actor restarts with fresh state on
    the survivor (max_restarts), and the placement directory follows."""
    def case(s):
        rt = s.rt
        w = s.w()
        node2 = _node_rec(w, "n2")
        a = _counter(rt).options(
            scheduling_strategy=s.strategies.NodeAffinitySchedulingStrategy(
                node2["node_id"]),
            max_restarts=1).remote()
        first = rt.get(a.add.remote(5), timeout=T)
        pid_before = rt.get(a.pid.remote(), timeout=T)
        s.c.node2.kill()
        s.c.node2.wait(timeout=10)
        deadline = time.monotonic() + T
        value = None
        while time.monotonic() < deadline:
            try:
                value = rt.get(a.add.remote(1), timeout=10)
                break
            except Exception:  # noqa: BLE001 — the restart is under way
                time.sleep(0.5)
        pid_after = rt.get(a.pid.remote(), timeout=T)
        rec = w.head_client.actor_locate(a._actor_id.binary())
        return (first, pid_before == s.c.node2.pid, value,
                pid_after == s.c.node1.pid, rec is not None and rec["alive"])

    assert _two_node_cluster_case("thread", case) == (
        "ok", (5, True, 1, True, True))


@pytest.mark.slow
def test_actor_on_process_plane_node():
    """On a process-plane daemon the hosted actor lives in a worker
    process of its own; kill -9 of it restarts it on the same node."""
    def case(s):
        rt = s.rt
        a = _counter(rt).options(resources={"n1": 1}, max_restarts=1).remote()
        first = rt.get(a.add.remote(3), timeout=2 * T)
        pid = rt.get(a.pid.remote(), timeout=T)
        dedicated = pid not in (os.getpid(), s.c.node1.pid)
        os.kill(pid, 9)
        deadline = time.monotonic() + T
        value = None
        while time.monotonic() < deadline:
            try:
                value = rt.get(a.add.remote(1), timeout=10)
                break
            except Exception:  # noqa: BLE001 — the restart is under way
                time.sleep(0.5)
        pid2 = rt.get(a.pid.remote(), timeout=T)
        return first, dedicated, value, pid2 not in (pid, os.getpid(),
                                                     s.c.node1.pid)

    assert _two_node_cluster_case("process", case) == (
        "ok", (3, True, 1, True))
