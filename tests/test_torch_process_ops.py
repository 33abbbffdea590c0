"""Twins of the process plane's operations: the log plane
(``tests/test_logs.py:32, :47``), the memory monitor
(``tests/test_memory_monitor.py``), spilling (``tests/test_spill.py:39,
:61``), chaos's ``worker_kill_target``, the shared-memory channels, and a
tensor's round trip through a worker; the reference beside the port
(``twin`` of ``test_torch_worker_pool``). Then the port alone: a spawned
worker imports nothing of JAX or the reference, the orphan fence
(PR_SET_PDEATHSIG) takes a dead driver's workers down with it, and a
task or actor that asks for ``num_gpus`` runs without the card, with a
warning.
"""

import io
import logging
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from test_torch_worker_pool import (
    SIDES,
    T,
    _exc,
    _exited,
    _wait_exited,
    config_flag,
    proc_runtime,
    twin,
)

ROOT = Path(__file__).resolve().parents[1]


def _private(rt, name):
    import importlib

    return importlib.import_module(f"{rt.__name__}._private.{name}")


def _session_log_text(w) -> str:
    log_dir = os.path.join(w.session_dir, "logs")
    text = ""
    for fname in sorted(os.listdir(log_dir)):
        with open(os.path.join(log_dir, fname), errors="replace") as f:
            text += f.read()
    return text


def _poll(cond, bound=10.0):
    deadline = time.monotonic() + bound
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.05)
    return cond()


# --------------------------------------------------------------- the logs
def test_task_print_reaches_session_logs():
    def case(s):
        @s.rt.remote
        def loud():
            print("HELLO-FROM-TASK-xyzzy", flush=True)
            return 1

        got = s.rt.get(loud.remote(), timeout=T)
        return got, _poll(lambda: "HELLO-FROM-TASK-xyzzy"
                          in _session_log_text(s.w))

    assert twin(case) == ("ok", (1, True))


def test_worker_print_streams_to_driver():
    """The log monitor re-emits worker lines with a (worker= pid=) tag,
    a task's and a process actor's alike."""
    def case(s):
        sink = io.StringIO()
        s.w.log_monitor._sink = sink

        @s.rt.remote
        def loud():
            print("STREAMED-LINE-plugh", flush=True)
            return 1

        @s.rt.remote
        class A:
            def speak(self):
                print("ACTOR-LINE-plover", flush=True)
                return 2

        got = (s.rt.get(loud.remote(), timeout=T),
               s.rt.get(A.remote().speak.remote(), timeout=T))
        seen = _poll(lambda: "STREAMED-LINE-plugh" in sink.getvalue()
                     and "ACTOR-LINE-plover" in sink.getvalue())
        return got, seen, "pid=" in sink.getvalue()

    assert twin(case) == ("ok", ((1, 2), True, True))


# ----------------------------------------------------- the memory monitor
def test_memory_readings_sane():
    out = {}
    for name, rt in SIDES.items():
        mm = _private(rt, "memory_monitor")
        frac = mm.system_memory_usage_fraction()
        out[name] = (0.0 < frac < 1.0,
                     mm.process_rss_bytes(os.getpid()) > 10 << 20)
    assert out == {"ref": (True, True), "port": (True, True)}


def test_monitor_enabled_by_default():
    def case(s):
        return (s.w.memory_monitor is not None,
                s.w.memory_monitor.threshold)

    assert twin(case) == ("ok", (True, 0.95))


def _manual_monitor(s):
    """A monitor with no loop of its own (kills happen by hand) at a zero
    threshold, in place of the runtime's."""
    s.w.memory_monitor.stop()
    mm = _private(s.rt, "memory_monitor")
    mon = mm.MemoryMonitor(s.w.scheduler, threshold_fraction=0.0,
                           min_worker_rss_bytes=0, poll_s=3600)
    mon._stop.set()
    return mon


def _wait_running(s):
    sched = s.w.scheduler
    return _poll(lambda: bool(sched._proc_running))


def test_oom_kill_youngest_reports_typed_error():
    """The youngest running process task dies with OutOfMemoryError (not
    a generic crash); the driver survives."""
    def case(s):
        mon = _manual_monitor(s)

        @s.rt.remote(max_retries=0)
        def spin():
            while True:
                time.sleep(0.05)

        @s.rt.remote
        def ok():
            return "alive"

        ref = spin.remote()
        assert _wait_running(s)
        mon._kill_one()
        try:
            s.rt.get(ref, timeout=T)
            err = None
        except _exc(s, "OutOfMemoryError") as e:
            err = type(e).__name__
        return mon.num_kills, err, s.rt.get(ok.remote(), timeout=T)

    assert twin(case) == ("ok", (1, "OutOfMemoryError", "alive"))


def test_oom_kill_is_retriable(tmp_path):
    """A task killed for memory retries (a system failure, not an
    application error)."""
    def case(s):
        mon = _manual_monitor(s)
        path = str(tmp_path / f"marks-{s.name}")

        @s.rt.remote(max_retries=2)
        def work(path):
            with open(path, "a") as f:
                f.write("x")
            time.sleep(1.0)
            return "done"

        ref = work.remote(path)
        assert _wait_running(s)
        mon._kill_one()
        out = s.rt.get(ref, timeout=T)
        with open(path) as f:
            return mon.num_kills, out, len(f.read()) >= 1

    assert twin(case) == ("ok", (1, "done", True))


# -------------------------------------------------------------- spilling
@pytest.fixture
def small_store_cap():
    """A tiny host cap, so a few 100 KiB objects overflow it."""
    with config_flag("object_store_memory_bytes", 256 * 1024):
        yield


def test_store_spills_past_cap_and_restores(tmp_path, small_store_cap):
    out = {}
    for name, rt in SIDES.items():
        store = _private(rt, "object_store").ObjectStore(
            spill_dir=str(tmp_path / name / "spill"))
        ctx = _private(rt, "serialization").SerializationContext()
        ids = _private(rt, "ids")
        blobs = {ids.ObjectID.from_random(): np.random.default_rng(i).bytes(
            200 * 1024) for i in range(4)}
        for oid, blob in blobs.items():
            store.put(oid, ctx.serialize(blob))
        st = store.stats()
        spilled = [oid for oid, *_, sp in store.entries_snapshot() if sp]
        on_disk = any(os.scandir(str(tmp_path / name / "spill")))
        back = all(ctx.deserialize(store.get(oid, timeout=5)) == blob
                   for oid, blob in blobs.items())
        out[name] = (st["spilled_bytes"] > 0, len(spilled), on_disk,
                     st["memory_used_bytes"] <= 256 * 1024 + 200 * 1024,
                     back, store.stats()["restored_bytes"] > 0)
    assert out["port"] == out["ref"]
    assert out["ref"][0] and out["ref"][4]


def test_worker_get_pulls_spilled_objects_back(small_store_cap):
    """Task results spill under a tiny cap, and get() brings every one
    back bit for bit."""
    def case(s):
        @s.rt.remote
        def blob(i):
            return np.full(64 * 1024, i, dtype=np.uint8)

        refs = [blob.remote(i) for i in range(8)]
        s.rt.wait(refs, num_returns=len(refs), timeout=T)
        spilled = s.w.store.stats()["spilled_bytes"] > 0
        outs = [s.rt.get(r, timeout=T) for r in refs]
        good = all(o.shape == (64 * 1024,) and int(o[0]) == i
                   for i, o in enumerate(outs))
        return spilled, good, s.w.store.stats()["restored_bytes"] > 0

    assert twin(case) == ("ok", (True, True, True))


def test_device_payloads_do_not_spill(tmp_path, small_store_cap):
    """Only host payloads spill: an entry that holds a device tensor (a
    value held by reference stands in for one on the CPU) stays resident
    and its bytes do not count against the host cap."""
    from ray_tpu_torch._private.ids import ObjectID
    from ray_tpu_torch._private.object_store import ObjectStore
    from ray_tpu_torch._private.serialization import SerializationContext

    store = ObjectStore(spill_dir=str(tmp_path / "spill"))
    ctx = SerializationContext()
    held = ObjectID.from_random()
    store.put(held, ctx.serialize(lambda: 1))   # held by reference
    big = [ObjectID.from_random() for _ in range(3)]
    for i, oid in enumerate(big):
        store.put(oid, ctx.serialize(np.full(200 * 1024, i, np.uint8)))
    spilled = {oid for oid, *_, sp in store.entries_snapshot() if sp}
    assert held not in spilled and spilled
    assert ctx.deserialize(store.get(held))() == 1
    assert [int(ctx.deserialize(store.get(o))[0]) for o in big] == [0, 1, 2]


# ------------------------------------------------------------------ chaos
def test_worker_kill_target():
    """A seeded NodeKiller over worker_kill_target SIGKILLs one worker of
    the pool; tasks with retries all finish."""
    def case(s):
        import importlib

        chaos = importlib.import_module(f"{s.rt.__name__}.util.chaos")

        @s.rt.remote(max_retries=3)
        def nap(i):
            time.sleep(0.2)
            return i

        warm = s.rt.get([nap.remote(i) for i in range(2)], timeout=T)
        pids = set(s.w.worker_pool.pids())
        target = chaos.worker_kill_target(seed=3)
        record = target.kill()
        refs = [nap.remote(i) for i in range(6)]
        out = s.rt.get(refs, timeout=T)
        return (warm, record["pid"] in pids, not _wait_exited(
            [record["pid"]]), out)

    assert twin(case) == ("ok", ([0, 1], True, True, list(range(6))))


# --------------------------------------------------------------- channels
def test_shm_channels():
    """ShmBufferedChannel: a ring of two slots, a peer attached through
    its spec reads each version once; SharedMemoryChannel on the
    runtime's store. (The reference's SharedMemoryChannel without a
    store names its own segment as the runtime's store is named, and so
    unlinks it: the twin passes the store; the port's own segment is
    checked alone below.)"""
    def case(s):
        import importlib

        chans = importlib.import_module(f"{s.rt.__name__}.channels")
        ch = chans.ShmBufferedChannel(
            s.w.shm_store, [0xB0B0_0001, 0xB0B0_0002], max_size=4096,
            num_readers=1)
        peer = chans.ShmBufferedChannel.attach(s.w.shm_store, ch.spec())
        got = []
        for v in ({"a": 1}, [2, 3], "four"):
            ch.write(v, timeout=5)
            got.append(peer.read(0, timeout=5))
        ch.close()
        ch.destroy()
        one = chans.SharedMemoryChannel(max_size=1024, store=s.w.shm_store)
        one.write(("x", 1))
        got.append(one.read(0, timeout=5))
        one.destroy()
        return got

    assert twin(case) == ("ok", [{"a": 1}, [2, 3], "four", ("x", 1)])


def test_shared_memory_channel_own_segment():
    """Without a store, the port's SharedMemoryChannel lives in a segment
    of the runtime's own, apart from the runtime's store, unlinked at
    shutdown."""
    from ray_tpu_torch.channels import SharedMemoryChannel

    ray_tpu_torch.shutdown()
    w = ray_tpu_torch.init(num_cpus=1)
    try:
        ch = SharedMemoryChannel(max_size=1024)
        ch.write({"k": 2})
        got = ch.read(0, timeout=5)
        name = w._channel_store.name
        assert os.path.exists("/dev/shm" + name)
    finally:
        ray_tpu_torch.shutdown()
    assert got == {"k": 2}
    assert not os.path.exists("/dev/shm" + name)


# ---------------------------------------------- tensors through a worker
def test_tensor_round_trip_through_process_task():
    """CPU tensors (f32, bf16, an nn.Parameter, a 0-d and an empty one)
    cross to a worker and back with their values, dtypes, shapes,
    requires_grad and Parameter type."""
    def case(s):
        @s.rt.remote
        def echo(*ts):
            return [(str(t.dtype), tuple(t.shape), t.requires_grad,
                     type(t).__name__, t.float().sum().item())
                    for t in ts], [t * 2 for t in ts]

        gen = torch.Generator().manual_seed(0)
        ts = (torch.randn(3, 5, generator=gen),
              torch.randn(4, generator=gen).to(torch.bfloat16),
              torch.nn.Parameter(torch.ones(2, 2)),
              torch.tensor(7.0), torch.zeros(0, 3))
        meta, doubled = s.rt.get(echo.remote(*ts), timeout=T)
        same = all(torch.equal(d.detach(), (t * 2).detach())
                   for d, t in zip(doubled, ts))
        return meta, same

    got = twin(case)
    assert got[0] == "ok" and got[1][1]
    assert [m[0] for m in got[1][0]] == [
        "torch.float32", "torch.bfloat16", "torch.float32",
        "torch.float32", "torch.float32"]
    assert got[1][0][2][2:4] == (True, "Parameter")


# ------------------------------------------------------------ port alone
_NO_JAX_PROBE = """
import sys
import ray_tpu_torch as rt
rt.init(num_cpus=1, worker_mode="process")
try:
    @rt.remote
    def probe():
        import sys
        import torch
        return (sorted({m.split(".")[0] for m in sys.modules}
                       & {"jax", "jaxlib", "ray_tpu"}),
                torch.cuda.is_available())
    print(rt.get(probe.remote(), timeout=60))
finally:
    rt.shutdown()
"""


def test_worker_imports_no_jax_and_no_reference():
    """A port worker process's sys.modules hold no jax and nothing of
    ray_tpu, and it sees no card."""
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "([], False)"


_OWNER = """
import sys, time
import ray_tpu_torch as rt
w = rt.init(num_cpus=2, worker_mode="process",
            _system_config={"shm_store_bytes": 16 << 20})

@rt.remote
def pid():
    import os, time
    time.sleep(0.3)
    return os.getpid()

pids = set(rt.get([pid.remote() for _ in range(2)], timeout=60))
print(" ".join(str(p) for p in sorted(pids)), flush=True)
time.sleep(600)
"""


def test_pdeathsig_takes_workers_down_with_their_driver():
    """SIGKILL a helper process that owns a port runtime: its worker
    processes (PR_SET_PDEATHSIG) are gone within a bound, and no
    shutdown ran."""
    helper = subprocess.Popen(
        [sys.executable, "-c", _OWNER], cwd=ROOT, stdout=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": str(ROOT)})
    try:
        line = helper.stdout.readline()
        pids = [int(p) for p in line.split()]
        assert pids and not any(_exited(p) for p in pids)
        os.kill(helper.pid, signal.SIGKILL)
        helper.wait(timeout=30)
        assert _wait_exited(pids, bound=15.0) == []
    finally:
        if helper.poll() is None:
            helper.kill()
            helper.wait(10)
        # No shutdown ran in the helper: its segment is left to unlink.
        for seg in Path("/dev/shm").glob(
                f"ray_tpu_torch_store_{helper.pid}_*"):
            seg.unlink(missing_ok=True)


def _gpu_probe():
    return os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES")


class _GpuAsker:
    def probe(self):
        return _gpu_probe()


class _CardHome:
    def probe(self):
        return _gpu_probe()


def test_gpu_request_runs_without_the_card_and_warns(monkeypatch):
    """Design decision (a), pinned: on the process plane a task or an
    actor that asks for ``num_gpus`` runs in a worker process that sees
    no card, and the runtime logs one warning per function or class; an
    actor with ``runtime="driver"`` stays in the driver, unwarned."""
    pool_mod = _private(ray_tpu_torch, "worker_pool")
    monkeypatch.setattr(pool_mod, "_warned_no_card", set())
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("ray_tpu_torch")
    logger.addHandler(handler)
    rt = ray_tpu_torch
    try:
        with proc_runtime(rt, num_gpus=1) as w:
            probe = rt.remote(num_gpus=1)(_gpu_probe)
            tasks = [rt.get(probe.remote(), timeout=T) for _ in range(2)]
            asker = rt.remote(num_gpus=1)(_GpuAsker).remote()
            actor = rt.get(asker.probe.remote(), timeout=T)
            home = rt.remote(num_gpus=1, runtime="driver")(
                _CardHome).remote()
            driver = rt.get(home.probe.remote(), timeout=T)
            w.note_children()
    finally:
        logger.removeHandler(handler)
    assert all(pid != os.getpid() and cvd == ""
               for pid, cvd in tasks + [actor])
    assert driver == (os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES"))
    said = [r.getMessage() for r in records
            if r.levelno == logging.WARNING and "num_gpus" in r.getMessage()]
    assert len(said) == 2
    assert "task '_gpu_probe'" in said[0] and "actor '_GpuAsker'" in said[1]
