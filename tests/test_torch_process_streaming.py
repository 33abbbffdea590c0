"""Twins of the process-plane cases of ``tests/test_streaming_generator.py``
(``:158, :203, :257, :294, :315, :346, :372, :399``): streaming generator
tasks and actor generator methods in worker processes, their
backpressure, cancellation, and kill -9 mid-stream with and without
replay; the reference beside the port (``twin`` of
``test_torch_worker_pool``). Beside them the thread plane's pause
(``:183``), which counts the producer's pauses in the driver.
"""

import os
import signal
import time

import pytest

import ray_tpu
import ray_tpu_torch
from test_torch_worker_pool import SIDES, T, _exc, config_flag, twin


@pytest.fixture
def backpressure_4():
    with config_flag("generator_backpressure_items", 4) as budget:
        yield budget


def _stream_err(s, g, limit=1000):
    """Drive ``g`` until it raises; the error's type name and whether it
    says the worker died mid-stream."""
    try:
        for _ in range(limit):
            next(g)
        return None
    except _exc(s, "RayTaskError") as e:
        return type(e).__name__.split("(")[0], "died mid-stream" in str(e)


def test_backpressure_budget_never_exceeded(backpressure_4):
    """With a budget of 4 the producer's committed-but-unconsumed items
    never exceed it (the stream's peak_unconsumed) under a slow
    consumer."""
    def case(s):
        @s.rt.remote
        def fast_gen(n):
            for i in range(n):
                yield i

        g = fast_gen.options(num_returns="streaming").remote(40)
        stream = s.w.streams.get(g.task_id)
        vals = []
        for r in g:
            time.sleep(0.005)
            vals.append(s.rt.get(r, timeout=T))
        return vals, stream.peak_unconsumed <= 4

    assert twin(case) == ("ok", (list(range(40)), True))


def test_backpressure_pauses_producer_thread_plane(backpressure_4):
    """On the thread plane the yield loop itself pauses: with a stalled
    consumer the committed count parks at the budget and the stream
    counts the pause (``paused_events``)."""
    out = {}
    for name, rt in SIDES.items():
        rt.shutdown()
        w = rt.init(num_cpus=2, worker_mode="thread",
                    ignore_reinit_error=True)
        try:
            @rt.remote
            def fast_gen(n):
                for i in range(n):
                    yield i

            g = fast_gen.options(num_returns="streaming").remote(100)
            stream = w.streams.get(g.task_id)
            deadline = time.monotonic() + T
            while stream.paused_events < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            parked = (stream.committed, stream.paused_events >= 1)
            vals = [rt.get(r, timeout=T) for r in g]
            out[name] = (parked, vals, stream.peak_unconsumed <= 4)
        finally:
            rt.shutdown()
    assert out["port"] == out["ref"] == ((4, True), list(range(100)), True)


def test_close_cancels_inflight_producer(tmp_path):
    """Closing the generator cancels the producing task between yields:
    its yield counter stops advancing."""
    def case(s):
        marker = str(tmp_path / f"yields-{s.name}.log")

        @s.rt.remote
        def slow_gen():
            for i in range(1000):
                with open(marker, "a") as f:
                    f.write(f"{i}\n")
                time.sleep(0.01)
                yield i

        g = slow_gen.options(num_returns="streaming").remote()
        first = s.rt.get(next(g), timeout=T)
        g.close()
        time.sleep(0.5)   # an in-flight yield settles
        with open(marker) as f:
            after_close = len(f.readlines())
        time.sleep(0.5)
        with open(marker) as f:
            later = len(f.readlines())
        try:
            next(g)
            stopped = False
        except StopIteration:
            stopped = True
        return first, later == after_close, later < 1000, stopped

    assert twin(case) == ("ok", (0, True, True, True))


def test_generator_gc_cancels():
    """Dropping the generator behaves as close(): its stream state goes."""
    def case(s):
        @s.rt.remote
        def slow_gen():
            for i in range(1000):
                time.sleep(0.01)
                yield i

        g = slow_gen.options(num_returns="streaming").remote()
        tid = g.task_id
        first = s.rt.get(next(g), timeout=T)
        del g
        deadline = time.monotonic() + 10
        while s.w.streams.get(tid) is not None and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        return first, s.w.streams.get(tid) is None

    assert twin(case) == ("ok", (0, True))


def test_kill9_worker_midstream_typed_error():
    """kill -9 of the producing worker after 4 yields: the next next()
    gets a typed error (max_retries=0, no replay)."""
    def case(s):
        @s.rt.remote(max_retries=0)
        def gen():
            yield os.getpid()
            for i in range(1, 1000):
                time.sleep(0.01)
                yield i

        g = gen.options(num_returns="streaming").remote()
        pid = s.rt.get(next(g), timeout=T)
        consumed = [s.rt.get(next(g), timeout=T) for _ in range(3)]
        os.kill(pid, signal.SIGKILL)
        return consumed, _stream_err(s, g)

    assert twin(case) == ("ok", ([1, 2, 3], ("RayTaskError", True)))


def test_kill9_worker_midstream_replay_dedup(tmp_path):
    """kill -9 after 6 yields with a retry: the retry replays the
    generator from yield 0, and the consumer sees every index exactly
    once."""
    def case(s):
        marker = str(tmp_path / f"attempts-{s.name}.log")
        kill_file = str(tmp_path / f"kill-{s.name}")

        @s.rt.remote(max_retries=1)
        def gen(n):
            with open(marker, "a") as f:
                f.write(f"{os.getpid()}\n")
            for i in range(n):
                if i == 6 and not os.path.exists(kill_file):
                    open(kill_file, "w").close()
                    os.kill(os.getpid(), signal.SIGKILL)
                yield i
                time.sleep(0.005)

        g = gen.options(num_returns="streaming").remote(10)
        consumed = [s.rt.get(r, timeout=T) for r in g]
        with open(marker) as f:
            attempts = len(f.read().splitlines())
        return consumed, attempts

    assert twin(case) == ("ok", (list(range(10)), 2))


def test_retries_exhausted_typed_error_after_replay(tmp_path):
    """Every attempt dies: after max_retries replays the typed error
    lands at next()."""
    def case(s):
        marker = str(tmp_path / f"attempts-{s.name}.log")

        @s.rt.remote(max_retries=1)
        def gen():
            with open(marker, "a") as f:
                f.write("attempt\n")
            yield 0
            yield 1
            time.sleep(0.05)
            os.kill(os.getpid(), signal.SIGKILL)

        g = gen.options(num_returns="streaming").remote()
        first = [s.rt.get(next(g), timeout=T) for _ in range(2)]
        err = _stream_err(s, g)
        with open(marker) as f:
            attempts = len(f.read().splitlines())
        return first, err, attempts

    assert twin(case) == ("ok", ([0, 1], ("RayTaskError", True), 2))


def test_actor_generator_methods_all_flavors():
    def case(s):
        @s.rt.remote
        class SyncActor:
            def gen(self, n):
                for i in range(n):
                    yield i * 2

        @s.rt.remote(max_concurrency=4)
        class MuxActor:
            def gen(self, n):
                for i in range(n):
                    yield i * 3

            async def agen(self, n):
                for i in range(n):
                    yield i * 5

        a, m = SyncActor.remote(), MuxActor.remote()
        return ([s.rt.get(r, timeout=T) for r in
                 a.gen.options(num_returns="streaming").remote(4)],
                [s.rt.get(r, timeout=T) for r in
                 m.gen.options(num_returns="streaming").remote(4)],
                [s.rt.get(r, timeout=T) for r in
                 m.agen.options(num_returns="streaming").remote(3)])

    assert twin(case) == ("ok", ([0, 2, 4, 6], [0, 3, 6, 9], [0, 5, 10]))


def test_actor_generator_backpressure(backpressure_4):
    def case(s):
        @s.rt.remote
        class A:
            def gen(self, n):
                for i in range(n):
                    yield i

        a = A.remote()
        g = a.gen.options(num_returns="streaming").remote(30)
        stream = s.w.streams.get(g.task_id)
        vals = []
        for r in g:
            time.sleep(0.005)
            vals.append(s.rt.get(r, timeout=T))
        return vals, stream.peak_unconsumed <= 4

    assert twin(case) == ("ok", (list(range(30)), True))
