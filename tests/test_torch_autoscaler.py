"""Twins of ``tests/test_autoscaler.py`` (``AutoscalingCluster`` over the
simulated cluster) and ``tests/test_autoscaler_real.py``
(``ClusterAutoscaler`` launching real node daemons against a head), the
reference's ``ray_tpu.autoscaler`` beside the port's
``ray_tpu_torch.autoscaler``.

Each case is a function of a side and runs once per side; the values and
the error type names must be equal. Each side runs in a runtime of its
own on the thread plane (and, for the real-node cases, its own head
process), shut down in a ``finally``. Every wait is bounded and every
subprocess is killed in a ``finally``. The real-node cases are marked
slow, as the reference's module is.
"""

import importlib
import os
import subprocess
import sys
import time
import types

import pytest

SIDES = ("ray_tpu", "ray_tpu_torch")
T = 60.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the outcome
        return ("err", type(exc).__name__)


def _side(pkg):
    return types.SimpleNamespace(
        pkg=pkg, rt=importlib.import_module(pkg),
        au=importlib.import_module(f"{pkg}.autoscaler"),
        pg=importlib.import_module(f"{pkg}.util.placement_group"))


def twin(case):
    """``case(side)`` on each side; the outcomes must be equal."""
    out = {}
    for pkg in SIDES:
        side = _side(pkg)
        side.rt.shutdown()
        try:
            out[pkg] = _outcome(lambda: case(side))
        finally:
            side.rt.shutdown()
    assert out["ray_tpu_torch"] == out["ray_tpu"], out
    return out["ray_tpu"]


def _wait_for(pred, timeout=10.0, msg=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {msg or pred}")


def _with_cluster(side, body):
    """tests/test_autoscaler.py's fixture: a runtime with 4 CPUs, then
    the autoscaling cluster (cpu2 x <= 4, big8 x <= 2, a 1-CPU head)."""
    side.rt.init(num_cpus=4, worker_mode="thread")
    c = side.au.AutoscalingCluster(
        node_types=[
            side.au.NodeTypeConfig("cpu2", {"CPU": 2.0}, min_workers=0,
                                   max_workers=4),
            side.au.NodeTypeConfig("big8", {"CPU": 8.0, "bigmem": 1.0},
                                   min_workers=0, max_workers=2),
        ],
        head_resources={"CPU": 1},
        idle_timeout_s=0.6,
        update_interval_s=0.05,
    )
    try:
        return body(c)
    finally:
        c.shutdown()


# ------------------------------------------------ tests/test_autoscaler.py
def test_scales_up_for_infeasible_task():
    def case(side):
        def body(c):
            @side.rt.remote(num_cpus=2)
            def two():
                return "ran"

            return side.rt.get(two.remote(), timeout=15), "cpu2" in c.launched

        return _with_cluster(side, body)

    assert twin(case) == ("ok", ("ran", True))


def test_scales_up_for_custom_resource():
    def case(side):
        def body(c):
            @side.rt.remote(resources={"bigmem": 1.0})
            def mem():
                return "big"

            return side.rt.get(mem.remote(), timeout=15), "big8" in c.launched

        return _with_cluster(side, body)

    assert twin(case) == ("ok", ("big", True))


def test_scales_down_when_idle():
    def case(side):
        def body(c):
            @side.rt.remote(num_cpus=2)
            def two():
                return 1

            got = side.rt.get(two.remote(), timeout=15)
            _wait_for(lambda: c.num_nodes_of_type("cpu2") >= 1,
                      msg="scale-up")
            _wait_for(lambda: c.num_nodes_of_type("cpu2") == 0,
                      timeout=10, msg="idle scale-down")
            return got, "cpu2" in c.terminated

        return _with_cluster(side, body)

    assert twin(case) == ("ok", (1, True))


def test_min_workers_maintained():
    def case(side):
        side.rt.init(num_cpus=1, worker_mode="thread")
        c = side.au.AutoscalingCluster(
            node_types=[side.au.NodeTypeConfig(
                "cpu2", {"CPU": 2.0}, min_workers=2, max_workers=4)],
            head_resources={"CPU": 1},
            idle_timeout_s=0.2,
            update_interval_s=0.05,
        )
        try:
            first = c.num_nodes_of_type("cpu2")
            time.sleep(1.0)   # idle well past the timeout
            return first, c.num_nodes_of_type("cpu2")
        finally:
            c.shutdown()

    assert twin(case) == ("ok", (2, 2))


def test_max_workers_respected():
    def case(side):
        def body(c):
            # 8 x CPU:2 asked, max_workers=4 for cpu2: overflow may go to
            # big8, but no type exceeds its cap.
            c.request_resources([{"CPU": 2.0}] * 8)
            _wait_for(lambda: c.num_nodes_of_type("cpu2") > 0,
                      msg="scale-up")
            time.sleep(0.5)
            return (c.num_nodes_of_type("cpu2") <= 4,
                    c.num_nodes_of_type("big8") <= 2)

        return _with_cluster(side, body)

    assert twin(case) == ("ok", (True, True))


def test_placement_group_triggers_scale_up():
    def case(side):
        def body(c):
            pg = side.pg.placement_group([{"CPU": 2.0}, {"CPU": 2.0}],
                                         strategy="STRICT_SPREAD")
            ready = pg.wait(timeout_seconds=15)
            return ready, (c.num_nodes_of_type("cpu2") >= 2
                           or c.num_nodes_of_type("big8") >= 1)

        return _with_cluster(side, body)

    assert twin(case) == ("ok", (True, True))


# ------------------------------------------- tests/test_autoscaler_real.py
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


def _real(side, tmp_path, body, types_, init_cpus=1, idle=2.0):
    """A head of this side, this driver attached, a ClusterAutoscaler of
    ``types_`` (launching daemons on the thread plane); ``body(side, w,
    head, scaler)``."""
    os.environ["RAY_TPU_HEAD_CLIENT_TIMEOUT_S"] = "2.0"
    head = subprocess.Popen(
        [sys.executable, "-m", f"{side.pkg}._private.head_service",
         "--port", "0", "--state", str(tmp_path / f"{side.pkg}.log")],
        stdout=subprocess.PIPE, text=True, env=_spawn_env())
    scaler = None
    try:
        address = _read_line(head).strip().rsplit(" ", 1)[-1]
        gpu = {"num_tpus": 0} if side.pkg == "ray_tpu" else {"num_gpus": 0}
        w = side.rt.init(num_cpus=init_cpus, worker_mode="thread",
                         address=address,
                         **(gpu if init_cpus == 0 else {}))
        scaler = side.au.ClusterAutoscaler(
            address, [side.au.NodeTypeConfig(*t) for t in types_],
            provider=side.au.LocalSubprocessProvider(
                address, worker_mode="thread", env=_spawn_env()),
            idle_timeout_s=idle, update_interval_s=0.25)
        return body(side, w, head, scaler)
    finally:
        if scaler is not None:
            scaler.shutdown()
        side.rt.shutdown()
        head.kill()
        head.wait(timeout=10)
        os.environ.pop("RAY_TPU_HEAD_CLIENT_TIMEOUT_S", None)


@pytest.mark.slow
def test_demand_spawns_real_node_then_idles_down(tmp_path):
    def body(side, w, head, scaler):
        rt = side.rt
        first = scaler.num_nodes_of_type("accel")

        @rt.remote(resources={"accel": 1})
        def probe():
            import os as _os

            return _os.getpid()

        pids = set(rt.get([probe.remote() for _ in range(3)], timeout=120))
        ran_remote = bool(pids) and os.getpid() not in pids
        launched = scaler.launched.count("accel") >= 1
        seen = any("accel" in (n["resources"] or {})
                   for n in w.head_client.node_list())
        deadline = time.monotonic() + 40
        while time.monotonic() < deadline \
                and scaler.num_nodes_of_type("accel") > 0:
            time.sleep(0.5)
        return (first, ran_remote, launched, seen,
                scaler.num_nodes_of_type("accel"),
                scaler.terminated.count("accel") >= 1)

    def case(side):
        return _real(side, tmp_path, body,
                     [("accel", {"CPU": 1, "accel": 1}, 0, 2)])

    assert twin(case) == ("ok", (0, True, True, True, 0, True))


@pytest.mark.slow
def test_backlog_pressure_scales_up(tmp_path):
    def body(side, w, head, scaler):
        rt = side.rt
        first = scaler.num_nodes_of_type("base")

        @rt.remote
        def slow():
            import time as _time

            _time.sleep(0.6)
            return 1

        refs = [slow.remote() for _ in range(10)]
        deadline = time.monotonic() + 40
        while time.monotonic() < deadline \
                and scaler.num_nodes_of_type("base") < 2:
            time.sleep(0.25)
        grew = scaler.num_nodes_of_type("base") >= 2
        return first, grew, sum(rt.get(refs, timeout=120))

    def case(side):
        return _real(side, tmp_path, body,
                     [("base", {"CPU": 1}, 1, 3)], init_cpus=0, idle=30.0)

    assert twin(case) == ("ok", (1, True, 10))


@pytest.mark.slow
def test_crashed_managed_node_replaced(tmp_path):
    def body(side, w, head, scaler):
        first = scaler.num_nodes_of_type("base")
        with scaler._lock:
            victim = scaler._managed[0]
        victim.handle["proc"].kill()
        victim.handle["proc"].wait(timeout=5)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with scaler._lock:
                alive = [m for m in scaler._managed if m is not victim]
            if alive and scaler.provider.poll_alive(alive[0].handle):
                break
            time.sleep(0.25)
        with scaler._lock:
            replaced = scaler._managed[0] is not victim
        return first, scaler.num_nodes_of_type("base"), replaced

    def case(side):
        return _real(side, tmp_path, body, [("base", {"CPU": 1}, 1, 2)],
                     idle=30.0)

    assert twin(case) == ("ok", (1, 1, True))


@pytest.mark.slow
def test_min_workers_floor_respected(tmp_path):
    def body(side, w, head, scaler):
        first = scaler.num_nodes_of_type("base")
        time.sleep(3.5)   # several idle periods
        return first, scaler.num_nodes_of_type("base")

    def case(side):
        return _real(side, tmp_path, body, [("base", {"CPU": 1}, 1, 2)],
                     idle=1.0)

    assert twin(case) == ("ok", (1, 1))


# ------------------------------------------------------------ the port's own
def test_provider_declared_gpu_meets_the_card_count(monkeypatch, tmp_path):
    """A type without ``GPU`` spawns its daemon with the card hidden; a
    type that declares ``GPU: n`` keeps the provider's visibility (and
    ``GPU`` never rides ``--resources``). A node of that type that joins
    advertising another count is killed: each such try counts as a
    failed attempt, and the launch raises ``NodeLaunchFailedError`` once
    the attempts run out."""
    import json

    from ray_tpu_torch import autoscaler as au
    from ray_tpu_torch._private.config import GlobalConfig
    from ray_tpu_torch._private.head_client import HeadClient
    from ray_tpu_torch.exceptions import NodeLaunchFailedError

    feed = au.NodeTypeConfig("feed", {"CPU": 2, "feed": 1})
    card = au.NodeTypeConfig("card", {"CPU": 2, "GPU": 1})
    spawned = []
    real_popen = subprocess.Popen

    def recording_popen(cmd, **kw):
        spawned.append((cmd, kw["env"]))
        return real_popen([sys.executable, "-c", "pass"],
                          stdout=subprocess.PIPE, text=True)

    monkeypatch.setattr(subprocess, "Popen", recording_popen)
    GlobalConfig.set("autoscaler_launch_retries", 1)
    try:
        prov = au.LocalSubprocessProvider(
            "127.0.0.1:1", env={"CUDA_VISIBLE_DEVICES": "0"})
        for t in (feed, card):
            with pytest.raises(NodeLaunchFailedError):
                prov.launch(t)
    finally:
        GlobalConfig.reset()
    monkeypatch.undo()
    (feed_cmd, feed_env), (card_cmd, card_env) = spawned

    def arg(cmd, flag):
        return cmd[cmd.index(flag) + 1] if flag in cmd else None

    assert feed_env["CUDA_VISIBLE_DEVICES"] == ""
    assert json.loads(arg(feed_cmd, "--resources")) == {"feed": 1}
    assert card_env["CUDA_VISIBLE_DEVICES"] == "0"
    assert json.loads(arg(card_cmd, "--resources")) == {}
    # A real daemon of the card type on a host whose card it cannot see.
    env = dict(_spawn_env(), CUDA_VISIBLE_DEVICES="")
    head = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch._private.head_service",
         "--port", "0", "--state", str(tmp_path / "head.log")],
        stdout=subprocess.PIPE, text=True, env=env)
    GlobalConfig.set("autoscaler_launch_retries", 2)
    GlobalConfig.set("autoscaler_launch_backoff_s", 0.05)
    hc = None
    try:
        address = _read_line(head).strip().rsplit(" ", 1)[-1]
        prov = au.LocalSubprocessProvider(address, worker_mode="thread",
                                          env=env)
        with pytest.raises(NodeLaunchFailedError) as err:
            prov.launch(card)
        assert err.value.attempts == 2
        assert "advertises GPU 0 where its type declares 1" in str(err.value)
        assert (prov.launch_attempts, prov.launch_failures) == (2, 2)
        hc = HeadClient(address)
        deadline = time.monotonic() + T
        while any(n.get("alive") for n in hc.node_list()):
            assert time.monotonic() < deadline, hc.node_list()
            time.sleep(0.2)
    finally:
        GlobalConfig.reset()
        if hc is not None:
            hc.close()
        head.kill()
        head.wait(timeout=10)
