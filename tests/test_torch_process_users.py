"""Twins of the process plane's users: the compiled DAG's shm plane
(``tests/test_dag.py:437``, ``:484``), the worker processes' trace and
flight spills (``tests/test_tracing.py:80``, ``tests/test_flight.py:339``,
``:356``, and a traced, armed process task whose worker's span and
bundle reach the driver's ``timeline`` and ``debug_dump``), ``memory://``
seen from worker processes (``tests/test_data_io.py:180``, over TFRecord,
which the port reads; its CSV reader waits for pandas) and the chaos
matrix's worker-kill cells (``tests/test_chaos_matrix.py:620`` and the
two slow sweeps, ``:1563`` and ``:1587``, slow here as there).

Each case runs on each side's process plane (``twin`` and
``proc_runtime`` of ``test_torch_worker_pool``); the values and the
error type names must be equal. The reference's default ``worker_mode``
is ``"process"``, so its cells that call ``init()`` bare run there; the
port's are asked for it. Every wait is bounded.
"""

import importlib
import json
import os
import time

import numpy as np
import pytest

from test_torch_worker_pool import SIDES, T, twin

_SPILL_ENV = ("RAY_TPU_TRACE_DIR", "RAY_TPU_TRACE_NODE", "RAY_TPU_FLIGHT_DIR",
              "RAY_TPU_FLIGHT_DIR_AUTO", "RAY_TPU_FLIGHT_NODE")


def _private(rt, name):
    return importlib.import_module(f"{rt.__name__}._private.{name}")


@pytest.fixture
def spill_env(monkeypatch):
    """The runtimes point the spill directories through os.environ:
    restore every such variable, and disarm both tracers and recorders,
    after the case."""
    saved = {k: os.environ.get(k) for k in _SPILL_ENV}
    yield monkeypatch
    for rt in SIDES.values():
        rt.shutdown()
        _private(rt, "tracing").uninstall()
        _private(rt, "flight").uninstall()
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


# ------------------------------------------------------ the DAG's shm plane
class _Scale:
    def __init__(self, k):
        self.k = k

    def apply(self, x):
        return {"data": x["data"] * self.k,
                "pids": x["pids"] + [os.getpid()]}


def test_actor_dag_shm_plane_keeps_driver_out_of_data_path():
    def case(s):
        dag_mod = importlib.import_module(f"{s.rt.__name__}.dag")
        chan_mod = importlib.import_module(f"{s.rt.__name__}.channels")
        scale = s.rt.remote(_Scale)
        a, b = scale.remote(2.0), scale.remote(3.0)
        with dag_mod.InputNode() as inp:
            dag = b.apply.bind(a.apply.bind(inp))
        compiled = dag.experimental_compile(backend="actor")
        try:
            arr = np.arange(1024, dtype=np.float32)
            outs = [compiled.execute({"data": arr * i, "pids": []}).get(
                timeout=T) for i in range(3)]
            pids = {p for o in outs for p in o["pids"]}
            return (compiled._shm_mode,
                    all(isinstance(ch, chan_mod.ShmBufferedChannel)
                        for ch in compiled._channels.values()),
                    [np.allclose(o["data"], arr * i * 6.0)
                     for i, o in enumerate(outs)],
                    len(pids), os.getpid() in pids,
                    {a._runtime.pid, b._runtime.pid} == pids)
        finally:
            compiled.teardown()

    assert twin(case, num_cpus=4) == (
        "ok", (True, True, [True] * 3, 2, False, True))


class _Plus:
    def apply(self, x):
        return x + 1


def test_actor_dag_transport_hints():
    def case(s):
        dag_mod = importlib.import_module(f"{s.rt.__name__}.dag")
        p = s.rt.remote(_Plus).remote()
        with dag_mod.InputNode() as inp:
            dag = p.apply.bind(inp).with_tensor_transport("driver")
        compiled = dag.experimental_compile(backend="actor")
        try:
            out = (compiled._shm_mode, compiled.execute(1).get(timeout=T))
        finally:
            compiled.teardown()
        d = s.rt.remote(runtime="driver")(_Plus).remote()
        with dag_mod.InputNode() as inp:
            dag2 = d.apply.bind(inp).with_tensor_transport("shm")
        try:
            dag2.experimental_compile(backend="actor")
            err = None
        except ValueError as exc:
            err = ("ValueError", "process-backed" in str(exc))
        return out, err

    assert twin(case, num_cpus=4) == ("ok", ((False, 2),
                                             ("ValueError", True)))


def test_actor_dag_shm_stage_error_and_capacity():
    """A stage's error crosses the shm plane typed, and a payload over
    ``channel_bytes`` fails its write with a ChannelError."""
    class Boom:
        def apply(self, x):
            if x < 0:
                raise ValueError("negative")
            return x * 2

    def case(s):
        dag_mod = importlib.import_module(f"{s.rt.__name__}.dag")
        exc_mod = importlib.import_module(f"{s.rt.__name__}.exceptions")
        a = s.rt.remote(Boom).remote()
        with dag_mod.InputNode() as inp:
            dag = a.apply.bind(inp)
        compiled = dag.experimental_compile(backend="actor",
                                            channel_bytes=4096)
        try:
            first = compiled.execute(3).get(timeout=T)
            try:
                compiled.execute(-1).get(timeout=T)
                err = None
            except ValueError as exc:
                err = ("ValueError", "negative" in str(exc))
            after = compiled.execute(4).get(timeout=T)
            try:
                compiled.execute(bytes(1 << 16))
                big = None
            except exc_mod.ChannelError as exc:
                big = type(exc).__name__
            return compiled._shm_mode, first, err, after, big
        finally:
            compiled.teardown()

    assert twin(case) == ("ok", (True, 6, ("ValueError", True), 8,
                                 "ChannelError"))


# ------------------------------------------------- the workers' spills
@pytest.mark.parametrize("rt", list(SIDES.values()), ids=list(SIDES))
def test_worker_spill_file_is_bounded(rt, tmp_path, spill_env):
    tracing = _private(rt, "tracing")
    spill_env.setenv(tracing.ENV_DIR, str(tmp_path))
    t = tracing.install(component="worker", capacity=32, spill=True)
    with tracing.start_span("root"):
        for i in range(200):
            tracing.event(f"e{i}")
    t._spill_file.flush()
    lines = sum(1 for _ in open(t._spill_path))
    assert 0 < lines <= 32
    spans = tracing._read_spill_dir(str(tmp_path), exclude_pid=None)
    assert spans and all(s["component"] == "worker" for s in spans)
    assert tracing._read_spill_dir(str(tmp_path), exclude_pid=os.getpid()) \
        == []


@pytest.mark.parametrize("rt", list(SIDES.values()), ids=list(SIDES))
def test_spill_rotates_at_capacity(rt, tmp_path, spill_env):
    flight = _private(rt, "flight")
    config = _private(rt, "config").GlobalConfig
    spill_env.setenv(flight.ENV_DIR, str(tmp_path))
    config.set("flight_spill_max_records", 3)
    try:
        rec = flight.install(component="worker", spill=True)
        rec._stop.set()  # drive spills by hand
        for _ in range(8):
            rec.spill_once()
        files = [f for f in os.listdir(tmp_path) if f.startswith("bundle-")]
        assert len(files) == 1
        lines = [ln for ln in
                 (tmp_path / files[0]).read_text().splitlines() if ln]
        assert 0 < len(lines) <= 3
        for ln in lines:
            assert json.loads(ln)["component"] == "worker"
    finally:
        config.reset()


@pytest.mark.parametrize("rt", list(SIDES.values()), ids=list(SIDES))
def test_spilled_bundle_merge_newest_and_stale_expiry(rt, tmp_path):
    flight = _private(rt, "flight")
    now = time.time()
    fresh = {"ts": now, "pid": 11, "component": "worker"}
    newest = {"ts": now + 1, "pid": 11, "component": "worker",
              "marker": "newest"}
    stale = {"ts": now - 9999, "pid": 22, "component": "worker"}
    (tmp_path / "bundle-11-aa.jsonl").write_text(
        json.dumps(fresh) + "\n" + json.dumps(newest) + "\n")
    (tmp_path / "bundle-22-bb.jsonl").write_text(json.dumps(stale) + "\n")
    (tmp_path / "not-a-bundle.txt").write_text("junk")
    got = flight.read_spilled_bundles(str(tmp_path), stale_s=120.0)
    assert [b.get("marker") for b in got] == ["newest"]
    assert flight.read_spilled_bundles(
        str(tmp_path), exclude_pid=11, stale_s=120.0) == []
    (tmp_path / "bundle-33-cc.jsonl").write_text(
        json.dumps({"ts": now, "pid": 33}) + "\n{\"torn")
    got = flight.read_spilled_bundles(str(tmp_path), stale_s=120.0)
    assert {b["pid"] for b in got} == {11}


def test_traced_armed_process_task_spills_to_driver(spill_env, tmp_path):
    """A traced task on the process plane: its worker's ``worker.exec``
    span, under the driver's span, reaches the driver's trace through
    the session's ``traces`` directory, and with the flight recorder
    armed ``debug_dump`` writes the worker processes' bundles beside the
    driver's."""
    spill_env.setenv("RAY_TPU_TRACE", "1")
    spill_env.setenv("RAY_TPU_FLIGHT", "1")
    for k in _SPILL_ENV:
        spill_env.delenv(k, raising=False)

    def case(s):
        tracing = _private(s.rt, "tracing")

        def work(x):
            return x + 1

        fn = s.rt.remote(work)
        with tracing.start_span("root") as root:
            value = s.rt.get(fn.remote(1), timeout=T)
        tid = root.ctx.trace_id
        deadline = time.monotonic() + T
        spans = []
        while time.monotonic() < deadline:
            spans = [x for x in tracing.tracer().dump(trace_id=tid)
                     if x["name"] == "worker.exec"]
            if spans:
                break
            time.sleep(0.05)
        incident = s.rt.debug_dump(str(tmp_path / s.rt.__name__))
        with open(os.path.join(incident, "manifest.json")) as f:
            manifest = json.load(f)
        driver = manifest["sources"]["driver"]
        worker_files = [n for n in driver["files"] if ".worker-" in n]
        comps = set()
        for n in worker_files:
            with open(os.path.join(incident, n)) as f:
                comps.add(json.load(f)["component"])
        return (value, len(spans) >= 1,
                all(x["pid"] != os.getpid() and x["component"] == "worker"
                    and x["parent_id"] == root.ctx.span_id for x in spans),
                driver["num_workers"] >= 1,
                len(worker_files) == driver["num_workers"], sorted(comps),
                manifest["num_processes"] == 1 + driver["num_workers"])

    assert twin(case) == ("ok", (2, True, True, True, True, ["worker"],
                                 True))


# --------------------------------------------------- memory:// from workers
def test_memory_fs_visible_from_worker_processes():
    def case(s):
        data = importlib.import_module(f"{s.rt.__name__}.data")
        fs = importlib.import_module(f"{s.rt.__name__}.data.filesystem")
        fs.MemoryFilesystem.clear()
        src = data.from_columns(
            {"x": np.arange(20, dtype=np.int64)}, parallelism=2)
        src.write_tfrecords("memory://procbucket/tfr")
        rows = data.read_tfrecords("memory://procbucket/tfr").take_all()

        def pid_of(batch):
            return {"pid": np.full(len(batch["x"]), os.getpid())}

        pids = data.read_tfrecords("memory://procbucket/tfr").map_batches(
            pid_of).take_all()
        return (sorted(int(np.asarray(r["x"]).reshape(-1)[0])
                       for r in rows),
                os.getpid() not in {int(r["pid"]) for r in pids})

    assert twin(case) == ("ok", (list(range(20)), True))


# ------------------------------------------------------- chaos: worker kills
def _chaos(rt):
    return importlib.import_module(f"{rt.__name__}.util.chaos")


def test_matrix_worker_kill_x_task_fanout_recovers():
    def case(s):
        chaos = _chaos(s.rt)

        def slow_square(i):
            time.sleep(0.15)
            return i * i

        fn = s.rt.remote(max_retries=10)(slow_square)
        killer = chaos.NodeKiller([chaos.worker_kill_target()], seed=13,
                                  interval_s=(0.1, 0.25), max_kills=3)
        with killer:
            refs = [fn.remote(i) for i in range(12)]
            out = s.rt.get(refs, timeout=120)
        return out, bool([k for k in killer.kills if "error" not in k])

    assert twin(case, num_cpus=4) == (
        "ok", ([i * i for i in range(12)], True))


@pytest.mark.slow
def test_sweep_worker_kill_x_data_shuffle():
    def case(s):
        chaos = _chaos(s.rt)
        data = importlib.import_module(f"{s.rt.__name__}.data")
        killer = chaos.NodeKiller([chaos.worker_kill_target()], seed=17,
                                  interval_s=(0.2, 0.4), max_kills=2)
        with killer:
            ds = data.range(400, parallelism=8).map_batches(
                lambda b: {"id": b["id"], "bucket": b["id"] % 4},
                batch_format="numpy")
            rows = ds.groupby("bucket").count().take_all()
        return {int(r["bucket"]): int(r["count()"]) for r in rows}

    assert twin(case, num_cpus=4) == (
        "ok", {0: 100, 1: 100, 2: 100, 3: 100})


@pytest.mark.slow
def test_sweep_worker_kill_x_workflow_exactly_once(tmp_path):
    def case(s):
        chaos = _chaos(s.rt)
        workflow = importlib.import_module(f"{s.rt.__name__}.workflow")
        workflow.init(str(tmp_path / s.rt.__name__ / "wf"))

        def add(x, i):
            time.sleep(0.1)
            return x + i

        step = workflow.step(max_retries=10)(add)
        node = step.bind(0, 1)
        for i in range(2, 6):
            node = step.bind(node, i)
        killer = chaos.NodeKiller([chaos.worker_kill_target()], seed=23,
                                  interval_s=(0.1, 0.3), max_kills=2)
        with killer:
            result = workflow.run(node, workflow_id="chaos_wf")
        return (result, workflow.get_status("chaos_wf"),
                workflow.get_output("chaos_wf"))

    assert twin(case, num_cpus=4) == ("ok", (15, "SUCCESS", 15))
