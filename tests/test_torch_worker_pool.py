"""Twins of ``tests/test_worker_pool.py``: the process plane, the
reference's (``ray_tpu.init(worker_mode="process")``) beside the port's
(``ray_tpu_torch.init(worker_mode="process")``).

Each case is a function of a side (its runtime module and its ``Worker``)
and runs once per side, each side in a runtime of its own; the values
and the error type names must be equal. ``proc_runtime`` is the
reference's function-scoped fixture: it starts a side's runtime with two
CPUs and takes it down after the case, then waits (bounded) until every
worker process of it has exited and, for the port, its shm segment is
unlinked. Every wait is bounded and nothing asserts on wall time. The
cases skip only where ``g++`` is missing (no native layer).

The other ``test_torch_*`` files of the process plane import ``twin``
and ``proc_runtime`` from here.
"""

import contextlib
import os
import shutil
import signal
import time
import types

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None,
    reason="no g++: the native layer of the process plane cannot build")

T = 60.0   # bound on every get / wait of a case
SIDES = {"ref": ray_tpu, "port": ray_tpu_torch}


def _exited(pid: int) -> bool:
    """The process is gone or a zombie (exited, not yet reaped)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
    except (OSError, IndexError):
        return True
    return state in ("Z", "X")


def _wait_exited(pids, bound: float = 10.0) -> list:
    deadline = time.monotonic() + bound
    left = list(pids)
    while left and time.monotonic() < deadline:
        left = [p for p in left if not _exited(p)]
        if left:
            time.sleep(0.02)
    return left


@contextlib.contextmanager
def proc_runtime(rt, num_cpus: int = 2, **kw):
    """One side's process-plane runtime; after it, every worker process
    (pool and actors) has exited and the port's segment is unlinked."""
    for side in SIDES.values():
        side.shutdown()
    worker = rt.init(num_cpus=num_cpus, worker_mode="process",
                     ignore_reinit_error=True, **kw)
    assert worker.worker_pool is not None, "no process plane"
    children = set()

    def _note_children():
        children.update(worker.worker_pool.pids())
        for actor in list(worker.actors.values()):
            if getattr(actor, "pid", None):
                children.add(actor.pid)

    worker.note_children = _note_children
    segment = getattr(worker.shm_store, "name", None)
    try:
        yield worker
    finally:
        if worker.worker_pool is not None:
            _note_children()
        rt.shutdown()
        left = _wait_exited(children)
        assert not left, f"worker processes outlived shutdown: {left}"
        if rt is ray_tpu_torch:
            assert not os.path.exists("/dev/shm" + segment)


def _kind(exc):
    cause = getattr(exc, "cause", None)
    return (type(exc).__name__,
            type(cause).__name__ if cause is not None else None)


def twin(case, **init_kw):
    """The case's outcome on each side's process plane; they must be
    equal. ``case(side)`` gets ``side.rt`` (the runtime module) and
    ``side.w`` (its Worker)."""
    out = {}
    for name, rt in SIDES.items():
        with proc_runtime(rt, **init_kw) as w:
            side = types.SimpleNamespace(name=name, rt=rt, w=w)
            try:
                out[name] = ("ok", case(side))
            except Exception as exc:  # noqa: BLE001 — the outcome
                out[name] = ("err", _kind(exc))
            w.note_children()
    assert out["port"] == out["ref"]
    return out["ref"]


@pytest.fixture(autouse=True)
def _no_runtime_left():
    for rt in SIDES.values():
        rt.shutdown()
    yield
    for rt in SIDES.values():
        rt.shutdown()


def _exc(side, name):
    return getattr(side.rt.exceptions, name)


_MISSING = object()


@contextlib.contextmanager
def config_flag(name, value):
    """Both sides' flag ``name`` at ``value`` for the block, then exactly
    as it was. The value is set as an attribute of each registry, which
    wins over the registry's lookup: earlier tests in this process may
    have left such an attribute behind (``GlobalConfig.<name> = old``)."""
    from ray_tpu._private.config import GlobalConfig as JConfig
    from ray_tpu_torch._private.config import GlobalConfig as TConfig

    saved = [(cfg, cfg.__dict__.get(name, _MISSING))
             for cfg in (JConfig, TConfig)]
    for cfg, _ in saved:
        setattr(cfg, name, value)
    try:
        yield value
    finally:
        for cfg, old in saved:
            if old is _MISSING:
                cfg.__dict__.pop(name, None)
            else:
                setattr(cfg, name, old)


# ------------------------------------------------------------------ tasks
def test_task_runs_in_separate_pid():
    def case(s):
        @s.rt.remote
        def pid():
            return os.getpid()

        wpid = s.rt.get(pid.remote(), timeout=T)
        return wpid != os.getpid(), wpid in s.w.worker_pool.pids()

    assert twin(case) == ("ok", (True, True))


def test_kill9_fails_task_not_driver():
    def case(s):
        @s.rt.remote(max_retries=0)
        def die():
            os.kill(os.getpid(), signal.SIGKILL)

        @s.rt.remote
        def ok():
            return "alive"

        try:
            s.rt.get(die.remote(), timeout=T)
            err = None
        except _exc(s, "RayTaskError") as e:
            err = _kind(e)
        return err, s.rt.get(ok.remote(), timeout=T)

    assert twin(case) == ("ok", (("RayTaskError", "WorkerCrashedError"),
                                 "alive"))


def test_crashed_idle_worker_replaced():
    def case(s):
        pool = s.w.worker_pool

        @s.rt.remote
        def pid():
            return os.getpid()

        victim = s.rt.get(pid.remote(), timeout=T)
        before = victim in pool.pids()
        os.kill(victim, signal.SIGKILL)
        assert not _wait_exited([victim])
        pids = s.rt.get([pid.remote() for _ in range(4)], timeout=T)
        return before, victim in pids, pool.size >= 1

    assert twin(case) == ("ok", (True, False, True))


def test_oversized_args_ride_shm_store():
    """A 4 MB argument is staged in the shm store, and the staged key and
    the return keys are reclaimed run to run."""
    def case(s):
        big = np.arange(1_000_000, dtype=np.float32)

        @s.rt.remote
        def total(x):
            return float(x.sum())

        first = s.rt.get(total.remote(big), timeout=T)
        time.sleep(0.1)
        before = s.w.shm_store.stats()["used"]
        second = s.rt.get(total.remote(big), timeout=T)
        time.sleep(0.1)
        after = s.w.shm_store.stats()["used"]
        return first, second, after <= before + 64 * 1024

    want = float(np.arange(1_000_000, dtype=np.float32).sum())
    assert twin(case) == ("ok", (want, want, True))


def test_force_cancel_kills_worker():
    def case(s):
        @s.rt.remote
        def spin():
            while True:
                time.sleep(0.1)

        @s.rt.remote
        def ok():
            return 1

        ref = spin.remote()
        deadline = time.monotonic() + T
        while not s.w.scheduler._proc_running and \
                time.monotonic() < deadline:
            time.sleep(0.02)   # it landed on a worker
        s.rt.cancel(ref, force=True)
        try:
            s.rt.get(ref, timeout=T)
            err = None
        except (_exc(s, "TaskCancelledError"),
                _exc(s, "RayTaskError")) as e:
            err = type(e).__name__
        return err, s.rt.get(ok.remote(), timeout=T)

    assert twin(case) == ("ok", ("TaskCancelledError", 1))


def test_ref_args_pass_through_shm_without_driver_copy():
    """A chained task's ref argument rides the shm store: the producer's
    output stays resident and the consumer receives its key; the evict
    hook releases the shm copy."""
    def case(s):
        @s.rt.remote
        def produce():
            return np.arange(500_000, dtype=np.float32)

        @s.rt.remote
        def consume(x):
            return float(x.sum())

        sched = s.w.scheduler
        ref = produce.remote()
        s.rt.wait([ref], num_returns=1, timeout=T)
        resident = ref.object_id in sched._shm_resident
        total = s.rt.get(consume.remote(ref), timeout=T)
        key = sched._shm_resident.get(ref.object_id)
        present = s.w.shm_store.contains(key)
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            with sched._pin_lock:
                if key not in sched._shm_key_pins:
                    break
            time.sleep(0.02)
        sched._release_shm_resident(ref.object_id)
        return (resident, total, present,
                ref.object_id in sched._shm_resident,
                s.w.shm_store.contains(key))

    want = float(np.arange(500_000, dtype=np.float32).sum())
    assert twin(case) == ("ok", (True, want, True, False, False))


# ----------------------------------------------------------------- actors
def _col(rt):
    """The side's actor-plane collectives."""
    import importlib

    return importlib.import_module(
        "ray_tpu.collective" if rt is ray_tpu
        else "ray_tpu_torch.collective.collective")


def _counter(rt, **opts):
    col_mod = _col(rt).__name__

    @rt.remote(**opts)
    class Counter:
        def __init__(self, start=0):
            self.n = start
            self.rank = None

        def inc(self):
            self.n += 1
            return self.n

        def read(self):
            return self.n

        def pid(self):
            return os.getpid()

        def collective_join(self, world_size, rank, backend, group):
            import importlib

            self.rank = rank
            importlib.import_module(col_mod).init_collective_group(
                world_size, rank, backend, group)
            return rank

        def reduce(self, group, v):
            import importlib

            out = importlib.import_module(col_mod).allreduce(
                np.full((8,), float(v)), group_name=group)
            return float(np.asarray(out).sum())

        def reduce_big(self, group):
            import importlib

            out = importlib.import_module(col_mod).allreduce(
                np.full((300_000,), float(self.rank + 1)), group_name=group)
            return float(np.asarray(out).sum())

    return Counter


def test_actor_lives_in_own_process():
    def case(s):
        a = _counter(s.rt).remote()
        apid = s.rt.get(a.pid.remote(), timeout=T)
        return apid != os.getpid(), apid in s.w.worker_pool.pids()

    assert twin(case) == ("ok", (True, False))


def test_actor_kill9_isolated_and_dead():
    def case(s):
        a = _counter(s.rt).remote()

        @s.rt.remote
        def ok():
            return "alive"

        first = s.rt.get(a.inc.remote(), timeout=T)
        pid = s.rt.get(a.pid.remote(), timeout=T)
        os.kill(pid, signal.SIGKILL)
        assert not _wait_exited([pid])
        try:
            s.rt.get(a.inc.remote(), timeout=T)
            err = None
        except _exc(s, "ActorDiedError") as e:
            err = type(e).__name__
        return first, err, s.rt.get(ok.remote(), timeout=T)

    assert twin(case) == ("ok", (1, "ActorDiedError", "alive"))


def test_actor_kill9_restarts_with_fresh_state():
    def case(s):
        a = _counter(s.rt, max_restarts=1).remote()
        first = s.rt.get(a.inc.remote(), timeout=T)
        old = s.rt.get(a.pid.remote(), timeout=T)
        os.kill(old, signal.SIGKILL)
        assert not _wait_exited([old])
        # The first call after the crash consumes the restart (it may
        # fail as the crash's casualty); fresh state follows.
        try:
            s.rt.get(a.inc.remote(), timeout=T)
        except _exc(s, "ActorDiedError"):
            pass
        return (first, s.rt.get(a.inc.remote(), timeout=T),
                s.rt.get(a.pid.remote(), timeout=T) != old)

    assert twin(case) == ("ok", (1, 1, True))


# ------------------------------------------- the API service, in a worker
def test_nested_task_submission_inside_worker():
    def case(s):
        rt = s.rt

        @rt.remote
        def add(a, b):
            return a + b

        @rt.remote
        def outer():
            return rt.get(add.remote(20, 22))

        return rt.get(outer.remote(), timeout=T)

    assert twin(case) == ("ok", 42)


def test_actor_handle_passed_into_process_task():
    def case(s):
        rt = s.rt

        @rt.remote
        def use(counter):
            return rt.get(counter.inc.remote())

        c = _counter(rt).remote()
        return (rt.get(use.remote(c), timeout=T),
                rt.get(c.inc.remote(), timeout=T))

    assert twin(case) == ("ok", (1, 2))


def test_put_get_wait_inside_worker():
    def case(s):
        rt = s.rt

        @rt.remote
        def roundtrip():
            ref = rt.put({"k": [1, 2, 3]})
            ready, not_ready = rt.wait([ref], num_returns=1, timeout=10)
            assert not not_ready
            return rt.get(ready[0])

        return rt.get(roundtrip.remote(), timeout=T)

    assert twin(case) == ("ok", {"k": [1, 2, 3]})


def test_runtime_context_inside_worker():
    def case(s):
        rt = s.rt

        @rt.remote
        def ctx():
            rc = rt.get_runtime_context()
            return rc.get_task_id(), rc.get_node_id(), rc.get_job_id()

        task_id, node_id, job_id = rt.get(ctx.remote(), timeout=T)
        return (task_id is not None, node_id == s.w.node_id.hex(),
                job_id == s.w.job_id.hex())

    assert twin(case) == ("ok", (True, True, True))


def test_actor_created_from_inside_task():
    def case(s):
        rt = s.rt
        counter = _counter(rt)

        @rt.remote
        def make():
            c = counter.remote(start=7)
            return rt.get(c.read.remote())

        return rt.get(make.remote(), timeout=T)

    assert twin(case) == ("ok", 7)


def test_thread_mode_still_works():
    out = {}
    for name, rt in SIDES.items():
        rt.init(num_cpus=2, worker_mode="thread", ignore_reinit_error=True)
        try:
            @rt.remote
            def pid():
                return os.getpid()

            out[name] = rt.get(pid.remote(), timeout=T) == os.getpid()
        finally:
            rt.shutdown()
    assert out == {"ref": True, "port": True}


def test_large_payload_api_roundtrip():
    """Values over the channel's size ride the store both ways: a big
    put from inside the worker and a big get back into it."""
    def case(s):
        rt = s.rt
        big = np.random.default_rng(0).random(600_000)

        @rt.remote
        def roundtrip(x):
            ref = rt.put(x * 2)
            return float(rt.get(ref).sum())

        return rt.get(roundtrip.remote(big), timeout=T) == float(
            (big * 2).sum())

    assert twin(case) == ("ok", True)


def test_large_collective_between_process_actors():
    """A ~2.4 MB allreduce contribution between two process actors rides
    the KV through staged API blobs."""
    def case(s):
        rt = s.rt
        col = _col(rt)
        workers = [_counter(rt).remote() for _ in range(2)]
        col.create_collective_group(workers, world_size=2, ranks=[0, 1],
                                    group_name="gbig")
        try:
            return rt.get([w.reduce_big.remote("gbig") for w in workers],
                          timeout=T)
        finally:
            col.destroy_collective_group("gbig")

    assert twin(case) == ("ok", [300_000.0 * 3, 300_000.0 * 3])


def test_collective_group_recreate_resets_stale_rounds():
    """A process actor that joined group G lives on after G is destroyed;
    re-creating G under the same name with that actor must not desync
    the rounds."""
    def case(s):
        rt = s.rt
        cls = _counter(rt)
        col = _col(rt)
        a, b = cls.remote(), cls.remote()
        col.create_collective_group([a, b], world_size=2, ranks=[0, 1],
                                    group_name="gepoch")
        first = rt.get([a.reduce.remote("gepoch", 1),
                        b.reduce.remote("gepoch", 2)], timeout=T)
        col.destroy_collective_group("gepoch")
        c = cls.remote()
        col.create_collective_group([a, c], world_size=2, ranks=[0, 1],
                                    group_name="gepoch")
        second = rt.get([a.reduce.remote("gepoch", 5),
                         c.reduce.remote("gepoch", 7)], timeout=T)
        col.destroy_collective_group("gepoch")
        return first, second

    assert twin(case) == ("ok", ([24.0, 24.0], [96.0, 96.0]))
