"""Twins of ``tests/test_cluster.py`` (every case, on both execution
planes) and of ``tests/test_spill.py:84``: the simulated multi-node
cluster, the reference's (``ray_tpu.cluster_utils.Cluster``) beside the
port's (``ray_tpu_torch.cluster_utils.Cluster``), each in a runtime of
its own with ``num_cpus=4`` and a two-CPU head node.

Each case is a function of a side and runs once per side; the values and
the error type names must be equal. Where a reference case waits a fixed
time for a task to start on the node it then removes
(``test_node_failure_retries_on_other_node``: ``sleep(0.15)``), the twin
waits for the task's first start itself, and after ``get`` for the
retry's start (the order of events, bounded), so the removal always
meets a running attempt on either plane.
"""

import importlib
import os
import time
import types

import numpy as np
import pytest

SIDES = ("ray_tpu", "ray_tpu_torch")
PLANES = ("process", "thread")
T = 30.0


def _side(pkg):
    return types.SimpleNamespace(
        pkg=pkg, rt=importlib.import_module(pkg),
        cu=importlib.import_module(f"{pkg}.cluster_utils"),
        util=importlib.import_module(f"{pkg}.util"),
        ss=importlib.import_module(f"{pkg}.util.scheduling_strategies"))


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the outcome
        return ("err", type(exc).__name__)


def twin(plane, case):
    """``case(side, cluster)`` on each side's runtime on ``plane`` with a
    cluster of a two-CPU head node; the outcomes must be equal."""
    out = {}
    for pkg in SIDES:
        side = _side(pkg)
        for other in SIDES:
            importlib.import_module(other).shutdown()
        side.rt.init(num_cpus=4, worker_mode=plane)
        cluster = side.cu.Cluster(initialize_head=True,
                                  head_node_args={"num_cpus": 2})
        try:
            out[pkg] = _outcome(lambda: case(side, cluster))
        finally:
            cluster.shutdown()
            side.rt.shutdown()
    assert out["ray_tpu_torch"] == out["ray_tpu"], out
    return out["ray_tpu"]


@pytest.fixture(autouse=True)
def _no_runtime_left():
    for pkg in SIDES:
        importlib.import_module(pkg).shutdown()
    yield
    for pkg in SIDES:
        importlib.import_module(pkg).shutdown()


def _double(x):
    return x * 2


def _hold():
    time.sleep(0.3)
    return True


def _true():
    return True


def _ok():
    return "ok"


def _one():
    return 1


def _seven():
    return 7


@pytest.mark.parametrize("plane", PLANES)
def test_tasks_run_across_nodes(plane):
    def case(s, cluster):
        cluster.add_node(num_cpus=2)
        cluster.add_node(num_cpus=2)
        f = s.rt.remote(_double)
        out = s.rt.get([f.remote(i) for i in range(20)], timeout=T)
        return out, len({n for n in cluster._task_node.values()}) >= 1

    assert twin(plane, case) == ("ok", ([i * 2 for i in range(20)], True))


@pytest.mark.parametrize("plane", PLANES)
def test_hybrid_policy_packs_then_spreads(plane):
    def case(s, cluster):
        n2 = cluster.add_node(num_cpus=2)
        hold = s.rt.remote(num_cpus=1)(_hold)
        refs = [hold.remote() for _ in range(4)]
        # The placement is decided at submit (by load, queued demand
        # counted): the four tasks land on both nodes.
        nodes = {cluster._task_node[r.task_id()] for r in refs}
        return (len(nodes), n2 in nodes,
                all(s.rt.get(refs, timeout=T)))

    assert twin(plane, case) == ("ok", (2, True, True))


@pytest.mark.parametrize("plane", PLANES)
def test_node_affinity_strategy(plane):
    def case(s, cluster):
        target = cluster.add_node(num_cpus=1, resources={"special": 1.0})
        ref = s.rt.remote(_true).options(
            scheduling_strategy=s.ss.NodeAffinitySchedulingStrategy(
                node_id=target.hex())).remote()
        return (s.rt.get(ref, timeout=T),
                cluster._task_node[ref.task_id()] is target)

    assert twin(plane, case) == ("ok", (True, True))


@pytest.mark.parametrize("plane", PLANES)
def test_custom_resource_routes_to_owning_node(plane):
    def case(s, cluster):
        gpu_node = cluster.add_node(num_cpus=1, resources={"accel": 2.0})
        ref = s.rt.remote(resources={"accel": 1.0})(_ok).remote()
        return (s.rt.get(ref, timeout=T),
                cluster._task_node[ref.task_id()] is gpu_node)

    assert twin(plane, case) == ("ok", ("ok", True))


@pytest.mark.parametrize("plane", PLANES)
def test_infeasible_task_raises(plane):
    def case(s, cluster):
        f = s.rt.remote(resources={"nonexistent": 1.0})(_one)
        return _outcome(lambda: s.rt.get(f.remote(), timeout=5))

    assert twin(plane, case) == ("ok", ("err", "RuntimeError"))


@pytest.mark.parametrize("plane", PLANES)
def test_placement_group_strict_spread(plane):
    def case(s, cluster):
        cluster.add_node(num_cpus=2)
        cluster.add_node(num_cpus=2)
        pg = s.util.placement_group([{"CPU": 1}, {"CPU": 1}, {"CPU": 1}],
                                    strategy="STRICT_SPREAD")
        ready = pg.wait(5)
        ref = s.rt.remote(num_cpus=0)(_seven).options(
            scheduling_strategy=s.ss.PlacementGroupSchedulingStrategy(
                placement_group=pg, placement_group_bundle_index=1)).remote()
        out = (ready, len(set(pg.bundle_nodes)), s.rt.get(ref, timeout=T),
               cluster._task_node[ref.task_id()].hex() == pg.bundle_nodes[1])
        s.util.remove_placement_group(pg)
        return out

    assert twin(plane, case) == ("ok", (True, 3, 7, True))


@pytest.mark.parametrize("plane", PLANES)
def test_placement_group_strict_pack_one_node(plane):
    def case(s, cluster):
        cluster.add_node(num_cpus=4)
        pg = s.util.placement_group([{"CPU": 1}, {"CPU": 1}],
                                    strategy="STRICT_PACK")
        out = (pg.wait(5), len(set(pg.bundle_nodes)))
        s.util.remove_placement_group(pg)
        return out

    assert twin(plane, case) == ("ok", (True, 1))


def _slow2(marker):
    with open(marker, "a") as f:
        f.write("x")
    time.sleep(0.5)
    return "survived"


def _wait_file(path, bound=T):
    deadline = time.monotonic() + bound
    while time.monotonic() < deadline:
        if os.path.exists(path) and os.path.getsize(path) > 0:
            return True
        time.sleep(0.01)
    return False


@pytest.mark.parametrize("plane", PLANES)
def test_node_failure_retries_on_other_node(plane, tmp_path):
    def case(s, cluster):
        victim = cluster.add_node(num_cpus=4)
        marker = str(tmp_path / f"{s.pkg}-starts")
        f = s.rt.remote(max_retries=2, retry_exceptions=True)(_slow2)
        ref = f.options(
            scheduling_strategy=s.ss.NodeAffinitySchedulingStrategy(
                node_id=victim.hex(), soft=True)).remote(marker)
        started = _wait_file(marker)
        cluster.remove_node(victim, lose_objects=False)
        out = s.rt.get(ref, timeout=T)
        # The retry's start, however it orders against the first
        # attempt's end.
        deadline = time.monotonic() + T
        while time.monotonic() < deadline:
            with open(marker) as fh:
                if len(fh.read()) >= 2:
                    break
            time.sleep(0.02)
        with open(marker) as fh:
            return started, out, len(fh.read()) >= 2

    assert twin(plane, case) == ("ok", (True, "survived", True))


def _produce(marker):
    with open(marker, "a") as f:
        f.write("x")
    return 41


def _consume(x):
    return x + 1


@pytest.mark.parametrize("plane", PLANES)
def test_lineage_reconstruction_after_object_loss(plane, tmp_path):
    def case(s, cluster):
        node = cluster.add_node(num_cpus=2, resources={"mem_node": 2.0})
        marker = str(tmp_path / f"{s.pkg}-runs")
        produce = s.rt.remote(resources={"mem_node": 0.5})(_produce)
        consume = s.rt.remote(_consume)
        ref = produce.remote(marker)
        first = s.rt.get(consume.remote(ref), timeout=T)
        runs1 = len(open(marker).read())
        cluster.add_node(num_cpus=2, resources={"mem_node": 2.0})
        cluster.remove_node(node, lose_objects=True)
        second = s.rt.get(consume.remote(ref), timeout=T)
        return first, runs1, second, len(open(marker).read())

    assert twin(plane, case) == ("ok", (42, 1, 42, 2))


def _blob(i):
    return np.full(96 * 1024, i, dtype=np.uint8)


def test_lineage_rebuilds_lost_spilled_copy():
    """Twin of ``tests/test_spill.py:84`` (on the process plane, the
    reference's default there): a spilled result whose file is destroyed
    and whose entry is marked lost is rebuilt by lineage on ``get``."""
    out = {}
    for pkg in SIDES:
        side = _side(pkg)
        config = importlib.import_module(f"{pkg}._private.config")
        for other in SIDES:
            importlib.import_module(other).shutdown()
        config.GlobalConfig.set("object_store_memory_bytes", 256 * 1024)
        side.rt.init(num_cpus=2, worker_mode="process")
        cluster = side.cu.Cluster(initialize_head=True,
                                  head_node_args={"num_cpus": 2})
        try:
            def case():
                w = side.rt._private.worker.global_worker()
                blob = side.rt.remote(_blob)
                refs = [blob.remote(i) for i in range(6)]
                side.rt.wait(refs, num_returns=len(refs), timeout=T)
                snapshot = {oid: sp for oid, _, _, _, _, sp
                            in w.store.entries_snapshot()}
                victims = [r for r in refs if snapshot.get(r.object_id)]
                victim = victims[0]
                os.unlink(w.store._entries[victim.object_id].spilled_path)
                w.store.mark_lost(victim.object_id)
                value = side.rt.get(victim, timeout=T)
                return (bool(victims), value.shape,
                        int(value[0]) == refs.index(victim))

            out[pkg] = _outcome(case)
        finally:
            cluster.shutdown()
            side.rt.shutdown()
            config.GlobalConfig.reset()
    assert out["ray_tpu_torch"] == out["ray_tpu"], out
    assert out["ray_tpu"] == ("ok", (True, (96 * 1024,), True))
