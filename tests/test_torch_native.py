"""Twins of ``tests/test_native.py``: the native layer of the process
plane, the reference's (``ray_tpu._native``) beside the port's
(``ray_tpu_torch._native``), on the same operations.

Each case runs once per side on a store, queue or library of that side;
the values, the C entry points' return codes and the bytes read back
must be equal, and an error is compared by its type's name. Both
libraries load in this one process (``RTLD_LOCAL``), and both stores'
segments live side by side under their own names. Every wait is bounded
and nothing asserts on wall time. The cases skip only where ``g++`` is
missing, as the native layer cannot build there.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

import ray_tpu
import ray_tpu._native.store as jn
import ray_tpu_torch
import ray_tpu_torch._native as tn
import ray_tpu_torch._native.store as tstore

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None,
    reason="no g++: the native layer of the process plane cannot build")

ROOT = Path(__file__).resolve().parents[1]
SIDES = {"ref": jn, "port": tstore}


def _kind(exc):
    return type(exc).__name__


def _both(case):
    """The case's outcome through each side; they must be equal."""
    out = {}
    for name, mod in SIDES.items():
        try:
            out[name] = ("ok", case(mod))
        except Exception as exc:  # noqa: BLE001 — the error is the outcome
            out[name] = ("err", _kind(exc))
    assert out["port"] == out["ref"]
    return out["ref"]


class _Store:
    """A side's store of 4 MiB, closed (and its segment unlinked) at
    exit."""

    def __init__(self, mod, **kw):
        self._mod = mod
        self._kw = {"capacity": 4 << 20, "max_objects": 256, **kw}

    def __enter__(self):
        self.store = self._mod.NativeObjectStore.create(**self._kw)
        return self.store

    def __exit__(self, *exc):
        self.store.close()


def _store_case(fn):
    def case(mod):
        with _Store(mod) as s:
            return fn(mod, s)
    return _both(case)


# ------------------------------------------------------- the object store
def test_put_get_roundtrip():
    def fn(mod, store):
        store.put(1, b"hello world")
        stats = store.stats()
        return (store.get(1), store.contains(1), store.contains(99),
                stats["num_objects"], stats["used"] >= 11)

    assert _store_case(fn) == ("ok", (b"hello world", True, False, 1, True))


def test_put_duplicate_and_delete():
    def fn(mod, store):
        store.put(7, b"x")
        try:
            store.put(7, b"y")
            dup = "no error"
        except Exception as exc:  # noqa: BLE001
            dup = (_kind(exc), getattr(exc, "code", None))
        store.delete(7)
        gone = store.contains(7)
        store.put(7, b"z")   # the tombstone slot is reusable
        return dup, gone, store.get(7)

    assert _store_case(fn) == ("ok", (("NativeError", -1), False, b"z"))


def test_zero_copy_view():
    def fn(mod, store):
        store.put(3, bytes(range(10)))
        return bytes(store.get_view(3))

    assert _store_case(fn) == ("ok", bytes(range(10)))


def test_mutable_object_versioning():
    def fn(mod, store):
        store.mo_create(10, max_size=1024, num_readers=1)
        store.mo_write(10, b"v1")
        first = store.mo_read(10, last_seen=0, max_size=1024)
        try:   # the same reader blocks for a new version
            store.mo_read(10, last_seen=1, max_size=1024, timeout_s=0.05)
            blocked = "no error"
        except Exception as exc:  # noqa: BLE001
            blocked = _kind(exc)
        store.mo_write(10, b"v2")
        second = store.mo_read(10, last_seen=1, max_size=1024)
        return first, blocked, second

    assert _store_case(fn) == ("ok", ((b"v1", 1), "ChannelTimeoutError",
                                      (b"v2", 2)))


def test_mutable_write_blocks_until_consumed():
    """The second write waits until the reader consumed version 1: it is
    still pending when the read happens, and completes after it."""
    def fn(mod, store):
        store.mo_create(11, max_size=64, num_readers=1)
        store.mo_write(11, b"a")
        done = threading.Event()

        def writer():
            store.mo_write(11, b"b", timeout_s=10)
            done.set()

        t = threading.Thread(target=writer)
        t.start()
        pending_before_read = not done.wait(0.2)
        first = store.mo_read(11, last_seen=0, max_size=64)
        finished = done.wait(10)
        t.join(10)
        second = store.mo_read(11, last_seen=1, max_size=64)
        return pending_before_read, first, finished, second

    assert _store_case(fn) == ("ok", (True, (b"a", 1), True, (b"b", 2)))


def test_native_channel_protocol():
    def fn(mod, store):
        ch = mod.NativeMutableChannel(store, max_size=4096, num_readers=2)
        ch.write({"x": 1})
        got = [ch.read(0), ch.read(1)]
        ch.write([1, 2, 3])
        got.append(ch.read(0))
        ch.close()
        # Close drains: reader 1 still gets the committed v2, then errors.
        got.append(ch.read(1, timeout=1))
        try:
            ch.read(1, timeout=1)
            got.append("no error")
        except Exception as exc:  # noqa: BLE001
            got.append(_kind(exc))
        return got

    assert _store_case(fn) == ("ok", [{"x": 1}, {"x": 1}, [1, 2, 3],
                                      [1, 2, 3], "ChannelError"])


_CHILD = """
import sys
import {pkg}._native as nat
s = nat.NativeObjectStore.open(sys.argv[1])
try:
    got = s.get(42)
    data, ver = s.mo_read(50, last_seen=0, max_size=256, timeout_s=30)
    s.put(43, b"from child:" + data + b"|" + got)
finally:
    s.close()
"""


def test_cross_process_store_and_mutable():
    """A second process opens the segment by name, reads an object and a
    mutable object's version, and puts an object the parent reads."""
    def case(mod):
        pkg = mod.__name__.split(".")[0]
        with _Store(mod, capacity=1 << 20, max_objects=64) as s:
            s.put(42, b"from parent")
            s.mo_create(50, max_size=256, num_readers=1)
            child = subprocess.Popen(
                [sys.executable, "-c", _CHILD.format(pkg=pkg), s.name],
                cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)})
            try:
                s.mo_write(50, b"hello")
                rc = child.wait(timeout=60)
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait(10)
            return rc, s.get(43)

    assert _both(case) == ("ok", (0, b"from child:hello|from parent"))


def test_arena_reclaims_deleted_objects():
    """Delete returns arena space for reuse (free-list allocator), also
    through the split and coalesce paths of differently sized churn."""
    def fn(mod, store):
        baseline = store.stats()["used"]
        for i in range(50):
            store.put(0xBEEF_0000 + i, b"z" * 1_000_000)
            store.delete(0xBEEF_0000 + i)
        after_big = store.stats()["used"] - baseline
        for i in range(50):
            store.put(0xBEEF_1000 + i, b"z" * (10_000 + 7 * i))
        for i in range(50):
            store.delete(0xBEEF_1000 + i)
        return after_big <= 1024, store.stats()["used"] - baseline <= 1024

    assert _store_case(fn) == ("ok", (True, True))


def test_store_return_codes():
    """The C entry points' return codes on the same operations: put of a
    duplicate (-1), get and delete of a missing key (-2), a put past the
    capacity (-3), a mutable read that times out (-4) and one of a closed
    object (-5)."""
    def fn(mod, store):
        lib, h = store._lib, store._h
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        ln = ctypes.c_uint64()
        ver = ctypes.c_uint64()
        buf = ctypes.create_string_buffer(64)
        codes = [lib.rtn_put(h, 5, b"abc", 3), lib.rtn_put(h, 5, b"abc", 3),
                 lib.rtn_get(h, 6, ctypes.byref(ptr), ctypes.byref(ln)),
                 lib.rtn_delete(h, 6)]
        big = b"x" * (8 << 20)
        codes.append(lib.rtn_put(h, 7, big, len(big)))
        codes.append(lib.rtn_mo_create(h, 20, 64, 1))
        codes.append(lib.rtn_mo_read(h, 20, 0, buf, 64, ctypes.byref(ln),
                                     ctypes.byref(ver), 10))
        codes.append(lib.rtn_mo_close(h, 20))
        codes.append(lib.rtn_mo_read(h, 20, 0, buf, 64, ctypes.byref(ln),
                                     ctypes.byref(ver), 10))
        got = lib.rtn_get(h, 5, ctypes.byref(ptr), ctypes.byref(ln))
        return codes, got, ctypes.string_at(ptr, ln.value)

    assert _store_case(fn) == ("ok", ([0, -1, -2, -2, -3, 0, -4, 0, -5],
                                      0, b"abc"))


def test_segment_names_apart():
    """The port's segments are /ray_tpu_torch_store_<pid>_<n>, apart from
    the reference's, and both live in one process."""
    with _Store(jn) as ref, _Store(tstore) as port:
        assert port.name.startswith(f"/ray_tpu_torch_store_{os.getpid()}_")
        assert not ref.name.startswith("/ray_tpu_torch_")
        ref.put(1, b"ref")
        port.put(1, b"port")
        assert (ref.get(1), port.get(1)) == (b"ref", b"port")
        assert os.path.exists("/dev/shm" + port.name)
        name = port.name
    assert not os.path.exists("/dev/shm" + name)


def test_library_built_under_the_repo():
    """The port's library is libray_tpu_torch_native-<hash>.so under
    build/ray_tpu_torch/native/, keyed by its sources."""
    from ray_tpu_torch._native import build

    tn.load_native()
    path = build.library_path()
    assert path.parent == ROOT / "build" / "ray_tpu_torch" / "native"
    assert path.name.startswith("libray_tpu_torch_native-")
    assert path.exists()


def test_failed_build_raises_with_stderr(monkeypatch):
    """A build that fails raises NativeBuildError with the compiler's
    stderr, and init(worker_mode="process") lets it propagate: nothing
    falls back to the thread plane."""
    from ray_tpu_torch._native import build, store

    monkeypatch.setattr(build, "GXX_FLAGS",
                        build.GXX_FLAGS + ["-fno-such-flag-xyzzy"])
    with pytest.raises(build.NativeBuildError, match="no-such-flag-xyzzy"):
        build._build()

    def _fail():
        raise build.NativeBuildError("g++ failed: planted")

    monkeypatch.setattr(store, "load_native", _fail)
    ray_tpu_torch.shutdown()
    with pytest.raises(build.NativeBuildError, match="planted"):
        ray_tpu_torch.init(num_cpus=1, worker_mode="process")
    assert not ray_tpu_torch.is_initialized()


# ------------------------------------------------------------- the queues
def test_task_queue_topological_waves():
    def case(mod):
        # Diamond: 0 -> {1, 2} -> 3
        q = mod.NativeTaskQueue(max_tasks=4, max_edges=4)
        for t in range(4):
            q.add_task(t)
        for a, b in ((0, 1), (0, 2), (1, 3), (2, 3)):
            q.add_edge(a, b)
        q.seal()
        waves = []
        for _ in range(3):
            w = sorted(q.pop_wave())
            q.complete(w)
            waves.append(w)
        return waves, q.num_done, q.pop_wave(timeout_s=0.05)

    assert _both(case) == ("ok", ([[0], [1, 2], [3]], 4, []))


def test_task_queue_wide_graph():
    def case(mod):
        n = 5000
        q = mod.NativeTaskQueue(max_tasks=n, max_edges=n)
        for t in range(n):
            q.add_task(t)
        for t in range(1, n):
            q.add_edge(0, t)   # a star: one producer, n-1 consumers
        q.seal()
        first = q.pop_wave(max_tasks=10)
        q.complete([0])
        seen = []
        while len(seen) < n - 1:
            wave = q.pop_wave(max_tasks=4096, timeout_s=1.0)
            if not wave:
                break
            q.complete(wave)
            seen += wave
        return first, sorted(seen) == list(range(1, n)), q.num_done

    assert _both(case) == ("ok", ([0], True, 5000))


def test_dyn_queue_direct():
    """The ready-ring: alloc/commit/pop, dependency gating, completion,
    a dependency on a completed producer."""
    def case(mod):
        dq = mod.NativeDynQueue(max_tasks=64, max_edges=128)
        a, b = dq.alloc(), dq.alloc()
        dq.add_dep(b, a)   # b waits on a
        dq.commit(a)
        dq.commit(b)
        out = [dq.pop(16, timeout_s=1.0) == [a]]
        dq.complete(a)
        out.append(dq.pop(16, timeout_s=1.0) == [b])
        dq.complete(b)
        c = dq.alloc()
        dq.add_dep(c, a)
        dq.commit(c)
        out.append(dq.pop(16, timeout_s=1.0) == [c])
        dq.complete(c)
        return out, dq.num_pending, dq.num_done

    assert _both(case) == ("ok", ([True, True, True], 0, 3))


def test_dyn_queue_abort_recycles_slot():
    def case(mod):
        dq = mod.NativeDynQueue(max_tasks=4, max_edges=16)
        handles = [dq.alloc() for _ in range(4)]
        try:
            dq.alloc()
            full = "no error"
        except Exception as exc:  # noqa: BLE001
            full = _kind(exc)
        dq.abort(handles[0])
        h = dq.alloc()   # the aborted slot is reusable
        dq.add_dep(h, handles[0])   # a stale edge is satisfied
        dq.commit(h)
        popped = dq.pop(8, timeout_s=1.0) == [h]
        dq.complete(h)
        for stale in handles[1:]:
            dq.abort(stale)
        return full, popped

    assert _both(case) == ("ok", ("MemoryError", True))


def test_dyn_queue_edge_capacity_overflow():
    def case(mod):
        dq = mod.NativeDynQueue(max_tasks=32, max_edges=2)
        producers = [dq.alloc() for _ in range(3)]
        consumer = dq.alloc()
        dq.add_dep(consumer, producers[0])
        dq.add_dep(consumer, producers[1])
        dq.add_dep(consumer, producers[2])   # the edge table is full

    assert _both(case) == ("err", "MemoryError")


def _chain_through_tiny_ring(rt, scheduler_mod, make_sched, ring=None):
    """40 chained tasks on a scheduler of its own. With ``ring`` (the
    reference's: a ring of 8 slots) the full ring falls back to the Python
    dependency path; the port's scheduler tracks dependencies in Python
    alone. Either way the chain computes."""
    from importlib import import_module

    ids = import_module(f"{rt.__name__}._private.ids")
    worker_mod = import_module(f"{rt.__name__}._private.worker")
    w = worker_mod.global_worker()
    sched = make_sched(w)
    try:
        if ring is not None:
            sched._dq = ring
        prev, refs = None, []
        for i in range(40):
            task_id = w.next_task_id()
            rid = ids.ObjectID.for_task_return(task_id, 0)
            spec = scheduler_mod.TaskSpec(
                task_id=task_id, function=lambda x: x + 1,
                args=(prev,) if prev is not None else (0,), kwargs={},
                num_returns=1, return_ids=[rid], name=f"chain{i}",
                resources={"CPU": 1.0})
            prev = worker_mod.ObjectRef(rid)
            refs.append(prev)
            sched.submit(spec)
        value = w.store.get(refs[-1].object_id, timeout=30)
        return w.serialization_context.deserialize(value)
    finally:
        sched.shutdown()


def test_scheduler_native_queue_full_falls_back():
    import ray_tpu._native.store as jstore
    import ray_tpu._private.scheduler as jsched
    import ray_tpu_torch._private.scheduler as tsched

    out = {}
    try:
        ray_tpu.shutdown()
        ray_tpu.init(num_cpus=4, worker_mode="thread",
                     ignore_reinit_error=True)
        out["ref"] = _chain_through_tiny_ring(
            ray_tpu, jsched,
            lambda w: jsched.LocalScheduler(
                w.store, jsched.ResourcePool({"CPU": 2.0}), num_workers=2,
                lineage={}),
            ring=jstore.NativeDynQueue(max_tasks=8, max_edges=8))
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_cpus=4)
        out["port"] = _chain_through_tiny_ring(
            ray_tpu_torch, tsched,
            lambda w: tsched.LocalScheduler(
                w.store, tsched.ResourcePool({"CPU": 2.0}), num_workers=2))
    finally:
        ray_tpu.shutdown()
        ray_tpu_torch.shutdown()
    assert out == {"ref": 40, "port": 40}
