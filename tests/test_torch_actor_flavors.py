"""Twins of ``tests/test_actor_flavors.py``: every actor flavor (sync,
asyncio, threaded) lives in a worker process on the process plane, with
kill -9 isolation and fresh-state restart alike across flavors, and
``runtime="driver"`` keeps an actor in the driver's process; the
reference beside the port (``twin`` of ``test_torch_worker_pool``).

The reference's overlap check bounds wall time; here the concurrent
calls meet at a barrier instead (four parties, a bounded wait), which
they pass only if they run at once.
"""

import os
import signal

import pytest

from test_torch_worker_pool import T, _exc, _wait_exited, twin

FLAVORS = ["sync", "async", "threaded"]


def _make_actor_class(rt, flavor, **opts):
    if flavor == "async":
        @rt.remote(**opts)
        class A:
            def __init__(self):
                self.n = 0
                self.barrier = None

            async def inc(self):
                self.n += 1
                return self.n

            async def pid(self):
                return os.getpid()

            async def meet(self, parties):
                import asyncio

                if self.barrier is None:
                    self.barrier = asyncio.Barrier(parties)
                await asyncio.wait_for(self.barrier.wait(), 30)
                return os.getpid()
        return A
    conc = {"max_concurrency": 4} if flavor == "threaded" else {}

    @rt.remote(**opts, **conc)
    class S:
        def __init__(self):
            import threading

            self.n = 0
            self.lock = threading.Lock()
            self.barrier = None

        def inc(self):
            self.n += 1
            return self.n

        def pid(self):
            return os.getpid()

        def meet(self, parties):
            import threading

            with self.lock:
                if self.barrier is None:
                    self.barrier = threading.Barrier(parties)
            self.barrier.wait(30)
            return os.getpid()
    return S


@pytest.mark.parametrize("flavor", FLAVORS)
def test_actor_runs_in_separate_process(flavor):
    def case(s):
        a = _make_actor_class(s.rt, flavor).remote()
        return (s.rt.get(a.pid.remote(), timeout=T) != os.getpid(),
                s.rt.get(a.inc.remote(), timeout=T))

    assert twin(case) == ("ok", (True, 1))


@pytest.mark.parametrize("flavor", FLAVORS)
def test_actor_kill9_isolated_and_dead(flavor):
    def case(s):
        a = _make_actor_class(s.rt, flavor).remote()
        first = s.rt.get(a.inc.remote(), timeout=T)
        pid = s.rt.get(a.pid.remote(), timeout=T)
        os.kill(pid, signal.SIGKILL)
        assert not _wait_exited([pid])
        try:
            s.rt.get(a.inc.remote(), timeout=T)
            err = None
        except _exc(s, "ActorDiedError") as e:
            err = type(e).__name__

        @s.rt.remote
        def ok():
            return "alive"

        return first, err, s.rt.get(ok.remote(), timeout=T)

    assert twin(case) == ("ok", (1, "ActorDiedError", "alive"))


@pytest.mark.parametrize("flavor", FLAVORS)
def test_actor_kill9_restarts_with_fresh_state(flavor):
    """The first call after the crash consumes the restart: a sync actor
    finds the death mid-request (that call fails), a mux actor before
    dispatch (the call runs on the fresh process). Either way the first
    call that succeeds sees fresh state."""
    def case(s):
        a = _make_actor_class(s.rt, flavor, max_restarts=1).remote()
        first = s.rt.get(a.inc.remote(), timeout=T)
        old = s.rt.get(a.pid.remote(), timeout=T)
        os.kill(old, signal.SIGKILL)
        assert not _wait_exited([old])
        try:
            again = s.rt.get(a.inc.remote(), timeout=T)
        except _exc(s, "ActorDiedError"):
            again = s.rt.get(a.inc.remote(), timeout=T)
        return first, again, s.rt.get(a.pid.remote(), timeout=T) != old

    assert twin(case) == ("ok", (1, 1, True))


@pytest.mark.parametrize("flavor", ["async", "threaded"])
def test_concurrent_calls_overlap_in_process(flavor):
    """max_concurrency calls interleave inside the worker process: four
    calls meet at a four-party barrier, which serialized calls never
    pass."""
    def case(s):
        a = _make_actor_class(s.rt, flavor).remote()
        s.rt.get(a.inc.remote(), timeout=T)   # construction done
        pids = set(s.rt.get([a.meet.remote(4) for _ in range(4)],
                            timeout=T))
        return len(pids), next(iter(pids)) != os.getpid()

    assert twin(case) == ("ok", (1, True))


def test_runtime_driver_opt_out():
    """runtime='driver' keeps the actor in the driver's process (where
    the port's actor reaches the card)."""
    def case(s):
        @s.rt.remote(runtime="driver")
        class InDriver:
            def pid(self):
                return os.getpid()

        a = InDriver.remote()
        return s.rt.get(a.pid.remote(), timeout=T) == os.getpid()

    assert twin(case) == ("ok", True)


def test_async_actor_error_propagates():
    def case(s):
        @s.rt.remote
        class Boom:
            async def go(self):
                raise ValueError("kapow")

        a = Boom.remote()
        try:
            s.rt.get(a.go.remote(), timeout=T)
            return None
        except ValueError as e:
            return "kapow" in str(e)

    assert twin(case) == ("ok", True)
