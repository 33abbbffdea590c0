"""Twins of the one-process runtime: the same small programs through the
reference (``ray_tpu.init(num_cpus=4, worker_mode="thread")``) and the
port (``ray_tpu_torch.init(num_cpus=4)``) give equal values and equal
error types.

The cases come from ``tests/test_basic.py``, ``tests/test_actor.py`` and
``tests/test_streaming_generator.py``. Each case is a function of the
runtime module, run once per runtime; an error is compared by its type's
name and its cause's. Every wait is bounded (a ``timeout=`` on ``get``
or ``wait``, an ``Event`` or a ``Barrier`` with a timeout) and nothing
asserts on wall-clock time.
"""

import asyncio
import threading

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch

T = 30.0   # bound on every get / wait / event of a case


@pytest.fixture
def runtimes():
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=4, worker_mode="thread", ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4)
    try:
        yield
    finally:
        ray_tpu.shutdown()
        ray_tpu_torch.shutdown()


def _kind(exc):
    cause = getattr(exc, "cause", None)
    return (type(exc).__name__,
            type(cause).__name__ if cause is not None else None)


def _outcome(case, rt):
    try:
        return ("ok", case(rt))
    except Exception as exc:  # noqa: BLE001 — the error is the outcome
        return ("err", _kind(exc))


def _twin(case):
    ref = _outcome(case, ray_tpu)
    port = _outcome(case, ray_tpu_torch)
    assert port == ref
    return ref


# ------------------------------------------------------------------ tasks
def _put_get(rt):
    value = {"a": [1, 2, 3], "b": "x", "arr": np.arange(6.0).reshape(2, 3)}
    out = rt.get(rt.put(value), timeout=T)
    return out["a"], out["b"], out["arr"].tolist()


def _task_chain(rt):
    @rt.remote
    def inc(x):
        return x + 1

    @rt.remote
    def double(x):
        return x * 2

    return rt.get(double.remote(inc.remote(inc.remote(3))), timeout=T)


def _fan_in(rt):
    @rt.remote
    def sq(x):
        return x * x

    @rt.remote
    def total(*xs):
        return sum(xs)

    return rt.get(total.remote(*[sq.remote(i) for i in range(10)]),
                  timeout=T)


def _multiple_returns(rt):
    @rt.remote(num_returns=3)
    def three():
        return 1, "two", [3]

    refs = three.remote()
    return len(refs), rt.get(refs, timeout=T)


def _nested(rt):
    @rt.remote
    def inner(x):
        return x * 10

    @rt.remote
    def outer(x):
        return rt.get(inner.remote(x), timeout=T) + 1

    return rt.get([outer.remote(i) for i in range(3)], timeout=T)


def _task_error(rt):
    @rt.remote
    def boom():
        raise ValueError("bad")

    try:
        rt.get(boom.remote(), timeout=T)
    except ValueError as exc:
        # Matches `except ValueError` and is the runtime's task error.
        return _kind(exc), isinstance(exc, rt.exceptions.RayTaskError)
    return "no error"


def _error_through_chain(rt):
    @rt.remote
    def boom():
        raise KeyError("missing")

    @rt.remote
    def consume(x):
        return x

    return rt.get(consume.remote(consume.remote(boom.remote())), timeout=T)


def _get_timeout(rt):
    release = threading.Event()

    @rt.remote
    def blocked():
        release.wait(T)
        return "done"

    ref = blocked.remote()
    try:
        rt.get(ref, timeout=0.2)
        timed_out = None
    except rt.exceptions.GetTimeoutError as exc:
        timed_out = _kind(exc)
    finally:
        release.set()
    return timed_out, rt.get(ref, timeout=T)


def _wait_split(rt):
    release = threading.Event()

    @rt.remote
    def fast(i):
        return i

    @rt.remote
    def blocked():
        release.wait(T)
        return "late"

    refs = [fast.remote(0), blocked.remote(), fast.remote(2),
            fast.remote(3)]
    try:
        ready, not_ready = rt.wait(refs, num_returns=3, timeout=T)
        split = ([refs.index(r) for r in ready],
                 [refs.index(r) for r in not_ready])
        with pytest.raises(ValueError):
            rt.wait(refs, num_returns=5)
    finally:
        release.set()
    return split, rt.get(refs, timeout=T)


def _cancel_queued(rt):
    release = threading.Event()

    @rt.remote(num_cpus=4)
    def hog():
        release.wait(T)
        return "hog"

    @rt.remote(num_cpus=4)
    def victim():
        return "ran"

    h = hog.remote()
    v = victim.remote()  # queued behind the hog (both need all 4 CPUs)
    rt.cancel(v, force=True)
    try:
        rt.get(v, timeout=T)
        got = "ran"
    except rt.exceptions.TaskCancelledError as exc:
        got = _kind(exc)
    finally:
        release.set()
    return got, rt.get(h, timeout=T)


def _object_ref_in_container(rt):
    @rt.remote
    def kind(xs):
        return [type(x).__name__ for x in xs]

    ref = rt.put(5)
    names = rt.get(kind.remote([ref]), timeout=T)
    return names, rt.get(ref, timeout=T)


# -------------------------------------------------------------- streaming
def _stream_items(rt):
    @rt.remote
    def gen(n):
        for i in range(n):
            yield i * 10

    g = gen.options(num_returns="streaming").remote(5)
    is_gen = isinstance(g, rt.ObjectRefGenerator)
    refs = list(g)
    kinds = {type(r).__name__ for r in refs}
    values = [rt.get(r, timeout=T) for r in refs]
    try:
        next(g)
        stopped = False
    except StopIteration:
        stopped = True
    return is_gen, kinds, values, stopped


def _stream_completed_count(rt):
    @rt.remote
    def gen():
        yield "a"
        yield "b"

    g = gen.options(num_returns="streaming").remote()
    total = rt.get(g.completed(), timeout=T)
    return total, [rt.get(r, timeout=T) for r in g]


def _stream_try_next(rt):
    release = threading.Event()

    @rt.remote
    def gen():
        release.wait(T)
        yield 1
        yield 2

    g = gen.options(num_returns="streaming").remote()
    before = g.try_next()   # nothing committed yet: None, no block
    release.set()
    rt.get(g.completed(), timeout=T)
    first = g.try_next()
    rest = [rt.get(r, timeout=T) for r in g]
    return before, rt.get(first, timeout=T), rest


def _stream_feeds_tasks(rt):
    @rt.remote
    def gen(n):
        for i in range(n):
            yield i

    @rt.remote
    def double(x):
        return 2 * x

    g = gen.options(num_returns="streaming").remote(4)
    return rt.get([double.remote(r) for r in g], timeout=T)


def _stream_error_midway(rt):
    @rt.remote(max_retries=0)
    def gen():
        yield 1
        raise RuntimeError("midway")

    g = gen.options(num_returns="streaming").remote()
    first = rt.get(next(g), timeout=T)
    try:
        next(g)
        err = None
    except RuntimeError as exc:
        err = _kind(exc)
    return first, err


def _stream_close(rt):
    step = threading.Event()

    @rt.remote
    def gen():
        for i in range(1000):
            yield i
            step.wait(T)

    g = gen.options(num_returns="streaming").remote()
    first = rt.get(next(g), timeout=T)
    g.close()
    step.set()   # let the producer reach its next yield and see the close
    try:
        rt.get(g.completed(), timeout=T)
        end = "completed"
    except rt.exceptions.TaskCancelledError as exc:
        end = _kind(exc)
    try:
        next(g)
        after = "item"
    except StopIteration:
        after = "StopIteration"
    return first, end, after


def _stream_non_generator(rt):
    @rt.remote(max_retries=0)
    def not_gen():
        return 5

    g = not_gen.options(num_returns="streaming").remote()
    return rt.get(g.completed(), timeout=T)


TASK_CASES = {
    "put_get": _put_get,
    "task_chain": _task_chain,
    "fan_in": _fan_in,
    "multiple_returns": _multiple_returns,
    "nested_tasks": _nested,
    "task_error": _task_error,
    "error_through_chain": _error_through_chain,
    "get_timeout": _get_timeout,
    "wait_split": _wait_split,
    "cancel_queued": _cancel_queued,
    "ref_in_container": _object_ref_in_container,
    "stream_items": _stream_items,
    "stream_completed_count": _stream_completed_count,
    "stream_try_next": _stream_try_next,
    "stream_feeds_tasks": _stream_feeds_tasks,
    "stream_error_midway": _stream_error_midway,
    "stream_close": _stream_close,
    "stream_non_generator": _stream_non_generator,
}


@pytest.mark.parametrize("name", sorted(TASK_CASES))
def test_task_twin(runtimes, name):
    _twin(TASK_CASES[name])


# ----------------------------------------------------------------- actors
def _actor_ordering(rt):
    @rt.remote
    class Log:
        def __init__(self, start):
            self.items = [start]

        def add(self, x):
            self.items.append(x)
            return len(self.items)

        def read(self):
            return self.items

    a = Log.remote("s")
    lens = rt.get([a.add.remote(i) for i in range(20)], timeout=T)
    return lens, rt.get(a.read.remote(), timeout=T)


def _actor_error_keeps_actor(rt):
    @rt.remote
    class A:
        def __init__(self):
            self.n = 0

        def bad(self):
            raise ZeroDivisionError("x")

        def inc(self):
            self.n += 1
            return self.n

    a = A.remote()
    try:
        rt.get(a.bad.remote(), timeout=T)
        err = None
    except ZeroDivisionError as exc:
        err = _kind(exc)
    return err, rt.get(a.inc.remote(), timeout=T)


def _actor_max_concurrency(rt):
    # Four calls meet at a four-party barrier: only concurrent execution
    # gets them all through (sequential execution breaks the barrier).
    barrier = threading.Barrier(4, timeout=T)

    @rt.remote(max_concurrency=4)
    class Concurrent:
        def meet(self, i):
            barrier.wait()
            return i

    a = Concurrent.remote()
    return sorted(rt.get([a.meet.remote(i) for i in range(4)], timeout=T))


def _actor_async(rt):
    @rt.remote
    class AsyncActor:
        def __init__(self):
            self.hits = 0

        async def work(self, delay):
            await asyncio.sleep(delay)
            self.hits += 1
            return self.hits

    a = AsyncActor.remote()
    return sorted(rt.get([a.work.remote(0.01) for _ in range(10)],
                         timeout=T))


def _actor_named(rt):
    @rt.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

    c = Counter.options(name="twin_counter").remote()
    rt.get(c.inc.remote(), timeout=T)
    same = rt.get_actor("twin_counter")
    n = rt.get(same.inc.remote(), timeout=T)
    try:
        rt.get_actor("no_such_actor")
        missing = None
    except ValueError as exc:
        missing = _kind(exc)
    return n, missing


def _actor_kill(rt):
    @rt.remote
    class A:
        def ping(self):
            return "pong"

    a = A.remote()
    first = rt.get(a.ping.remote(), timeout=T)
    rt.kill(a)
    try:
        rt.get(a.ping.remote(), timeout=T)
        after = "pong"
    except rt.exceptions.ActorDiedError as exc:
        after = _kind(exc)
    return first, after


def _actor_num_returns(rt):
    @rt.remote
    class Multi:
        @rt.method(num_returns=2)
        def pair(self):
            return "a", "b"

    m = Multi.remote()
    refs = m.pair.remote()
    return rt.get(list(refs), timeout=T)


def _actor_generator_method(rt):
    @rt.remote
    class Gen:
        def count(self, n):
            for i in range(n):
                yield i + 100

    g = Gen.remote().count.options(num_returns="streaming").remote(3)
    return [rt.get(r, timeout=T) for r in g]


def _actor_handle_to_task(rt):
    @rt.remote
    class Store:
        def __init__(self):
            self.v = 0

        def set(self, v):
            self.v = v
            return v

        def get(self):
            return self.v

    @rt.remote
    def writer(handle, v):
        return rt.get(handle.set.remote(v), timeout=T)

    s = Store.remote()
    rt.get(writer.remote(s, 7), timeout=T)
    return rt.get(s.get.remote(), timeout=T)


ACTOR_CASES = {
    "ordering": _actor_ordering,
    "error_keeps_actor": _actor_error_keeps_actor,
    "max_concurrency": _actor_max_concurrency,
    "async": _actor_async,
    "named": _actor_named,
    "kill": _actor_kill,
    "num_returns": _actor_num_returns,
    "generator_method": _actor_generator_method,
    "handle_to_task": _actor_handle_to_task,
}


@pytest.mark.parametrize("name", sorted(ACTOR_CASES))
def test_actor_twin(runtimes, name):
    _twin(ACTOR_CASES[name])


def test_twins_see_what_they_expect(runtimes):
    """The twins compare outcomes; this pins a few of them, so two
    runtimes that failed alike would not pass unseen."""
    assert _twin(_task_chain) == ("ok", 10)
    assert _twin(_task_error)[1][0] == ("RayTaskError(ValueError)",
                                        "ValueError")
    assert _twin(_error_through_chain) == (
        "err", ("RayTaskError(KeyError)", "KeyError"))
    assert _twin(_cancel_queued)[1][0] == ("TaskCancelledError", None)
    assert _twin(_stream_close) == (
        "ok", (0, ("TaskCancelledError", None), "StopIteration"))
    assert _twin(_actor_kill) == ("ok", ("pong", ("ActorDiedError", None)))
    assert _twin(_actor_max_concurrency) == ("ok", [0, 1, 2, 3])


def test_device_tensor_stays_on_its_device():
    """A tensor off the CPU never goes through host bytes: put, a task
    argument and a return value give a tensor on its device, of its
    dtype and shape, with its requires_grad and its Parameter type. On
    the CPU the meta device stands in for a card; the card's values are
    held in tests/test_torch_serve_card.py."""
    import torch

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        x = torch.empty(3, 5, dtype=torch.bfloat16, device="meta")
        p = torch.nn.Parameter(torch.empty(2, device="meta"))
        value = {"x": x, "p": p, "cpu": torch.arange(4.0)}
        back = ray_tpu_torch.get(ray_tpu_torch.put(value), timeout=T)
        assert back["x"].device.type == "meta"
        assert back["x"].shape == x.shape and back["x"].dtype == x.dtype
        assert isinstance(back["p"], torch.nn.Parameter)
        assert back["p"].requires_grad and back["p"].device.type == "meta"
        assert torch.equal(back["cpu"], value["cpu"])

        @ray_tpu_torch.remote
        def where(t):
            return t.device.type, t[:1]

        dev, head = ray_tpu_torch.get(
            where.remote(ray_tpu_torch.put(x)), timeout=T)
        assert dev == "meta" and head.device.type == "meta"
        assert head.shape == (1, 5)
    finally:
        ray_tpu_torch.shutdown()


def test_concurrent_clients_lose_nothing():
    """More client threads than cores drive tasks, actor calls and
    streams at once under a short switch interval: every result is
    right, the actor's counter loses no update, and once the refs are
    dropped the store holds no object of the drive."""
    import gc
    import sys

    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        rt = ray_tpu_torch

        @rt.remote
        def inc(x):
            return x + 1

        @rt.remote
        class Counter:
            def __init__(self):
                self.n = 0

            def add(self, k):
                self.n += k
                return self.n

        @rt.remote
        def gen(n):
            for i in range(n):
                yield i

        counter = Counter.remote()
        errors = []
        clients, rounds = 16, 10

        def client(c):
            try:
                for i in range(rounds):
                    assert rt.get(inc.remote(inc.remote(i)), timeout=T) \
                        == i + 2
                    rt.get(counter.add.remote(1), timeout=T)
                    g = gen.options(num_returns="streaming").remote(3)
                    assert [rt.get(r, timeout=T) for r in g] == [0, 1, 2]
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(exc)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        assert rt.get(counter.add.remote(0), timeout=T) == clients * rounds
        gc.collect()
        store = rt._private.worker.global_worker().store
        assert store.stats()["num_objects"] == 0
    finally:
        sys.setswitchinterval(old)
        ray_tpu_torch.shutdown()


def test_runtime_threads_end_at_shutdown():
    """init starts threads and shutdown joins them: after a drive with a
    task, an actor and a stream, no thread of the port is left."""
    ray_tpu_torch.shutdown()
    before = set(threading.enumerate())
    ray_tpu_torch.init(num_cpus=2)
    try:
        _task_chain(ray_tpu_torch)
        _actor_ordering(ray_tpu_torch)
        _actor_async(ray_tpu_torch)
        _stream_items(ray_tpu_torch)
        assert set(threading.enumerate()) - before
    finally:
        ray_tpu_torch.shutdown()
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()]
    assert left == []


def test_import_starts_no_thread():
    import os
    import subprocess
    import sys

    code = ("import threading, ray_tpu_torch\n"
            "print(threading.active_count())\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "1"
