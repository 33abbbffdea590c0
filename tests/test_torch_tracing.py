"""Twins of the tracing plane and the task events: the reference
(``ray_tpu._private.tracing``, ``task_events``, on
``ray_tpu.init(num_cpus=4, worker_mode="thread")``) beside the port
(``ray_tpu_torch._private.tracing``, ``task_events``, on
``ray_tpu_torch.init(num_cpus=4)``), in one process.

The runtime twins run the same programs through both and compare the
per-task state sequences (tasks, actor calls, a failing task, a
streaming generator) and the span trees of traced tasks and actor calls.
The units (context wire form, the bounded ring, nested spans, the
cold-start stash, the task-event buffer's eviction, ``drain_since`` and
``ingest``, Chrome-trace shapes) run once per implementation, from
``tests/test_tracing.py``, without its spill and cross-process parts.
Every tracer is uninstalled by a fixture, every wait is bounded, and
nothing asserts on wall-clock time.
"""

import time
from collections import defaultdict

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu._private import task_events as ref_task_events
from ray_tpu._private import tracing as ref_tracing
from ray_tpu._private.ids import TaskID as RefTaskID
from ray_tpu_torch._private import task_events as port_task_events
from ray_tpu_torch._private import tracing as port_tracing
from ray_tpu_torch._private.ids import TaskID as PortTaskID

T = 30.0   # bound on every get and poll

# (tracing module, task-event module, TaskID class) of each side.
SIDES = {
    "reference": (ref_tracing, ref_task_events, RefTaskID),
    "port": (port_tracing, port_task_events, PortTaskID),
}
RUNTIMES = {"reference": ray_tpu, "port": ray_tpu_torch}


@pytest.fixture(autouse=True)
def _clean_tracers():
    for tr, _, _ in SIDES.values():
        tr.uninstall()
    yield
    for tr, _, _ in SIDES.values():
        tr.uninstall()


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


def _worker(side):
    if side == "reference":
        from ray_tpu._private.worker import global_worker
    else:
        from ray_tpu_torch._private.worker import global_worker
    return global_worker()


def _poll(cond):
    deadline = time.monotonic() + T
    while time.monotonic() < deadline:
        out = cond()
        if out:
            return out
        time.sleep(0.02)
    return cond()


# ---------------------------------------------------------------- programs
def _program(rt):
    """Tasks (one waiting on another), a failing task, a streaming
    generator, and a sync actor's calls (one failing)."""

    @rt.remote
    def inc(x):
        return x + 1

    @rt.remote
    def bad():
        raise ValueError("boom")

    @rt.remote
    def gen(n):
        for i in range(n):
            yield i

    @rt.remote
    class Acc:
        def __init__(self):
            self.n = 0

        def add(self, x):
            self.n += x
            return self.n

        def boom(self):
            raise KeyError("k")

    out = [rt.get(inc.remote(inc.remote(1)), timeout=T)]
    try:
        rt.get(bad.remote(), timeout=T)
    except Exception as exc:  # noqa: BLE001 — the error is the outcome
        out.append(type(exc).__name__)
    out.append([rt.get(r, timeout=T) for r in
                gen.options(num_returns="streaming").remote(3)])
    acc = Acc.remote()
    out.append(rt.get([acc.add.remote(i) for i in range(3)], timeout=T))
    try:
        rt.get(acc.boom.remote(), timeout=T)
    except Exception as exc:  # noqa: BLE001
        out.append(type(exc).__name__)
    return out


def _sequences(side):
    """Each task's states in order, as (name, states), sorted."""
    w = _worker(side)
    states, names = defaultdict(list), {}
    for ev in w.task_events.list_events():
        states[ev.task_id].append(ev.state)
        names[ev.task_id] = ev.name
    return sorted((names[t], tuple(s)) for t, s in states.items())


def _settled(side, n_terminal):
    """The sequences once ``n_terminal`` tasks reached a terminal state
    (get() can return a beat before the FINISHED record)."""
    def done():
        seqs = _sequences(side)
        ended = sum(1 for _, s in seqs if s[-1] in ("FINISHED", "FAILED"))
        return seqs if ended >= n_terminal else None

    return _poll(done)


# ------------------------------------------------------------ runtime twins
def test_task_state_sequences_match_the_reference(runtimes):
    values = {side: _program(rt) for side, rt in RUNTIMES.items()}
    assert values["port"] == values["reference"]
    seqs = {side: _settled(side, 8) for side in RUNTIMES}
    assert seqs["port"] == seqs["reference"]
    by_name = defaultdict(set)
    for name, s in seqs["port"]:
        by_name[name].add(s)
    full = ("PENDING_ARGS_AVAIL", "PENDING_NODE_ASSIGNMENT", "RUNNING")
    assert by_name["inc"] == {full + ("FINISHED",)}
    assert by_name["bad"] == {full + ("FAILED",)}
    assert by_name["gen"] == {full + ("FINISHED",)}
    assert by_name["Acc.add"] == {
        ("PENDING_ACTOR_TASK", "RUNNING", "FINISHED")}
    assert by_name["Acc.boom"] == {
        ("PENDING_ACTOR_TASK", "RUNNING", "FAILED")}


def test_async_actor_calls_record_their_execution(runtimes):
    """Port only: the async loop records RUNNING and the terminal state
    too (the reference's records PENDING_ACTOR_TASK alone)."""

    @ray_tpu_torch.remote
    class Async:
        async def twice(self, x):
            return 2 * x

    a = Async.remote()
    assert ray_tpu_torch.get([a.twice.remote(i) for i in range(3)],
                             timeout=T) == [0, 2, 4]
    seqs = _settled("port", 3)
    assert seqs == [("Async.twice",
                     ("PENDING_ACTOR_TASK", "RUNNING", "FINISHED"))] * 3


def _span_tree(tr, trace_id):
    """(name, parent's name, status, task tag) of each span of a trace,
    sorted."""
    spans = tr.local_spans(trace_id)
    by_id = {s["span_id"]: s["name"] for s in spans}
    return sorted((s["name"], by_id.get(s["parent_id"], s["parent_id"]),
                   s["status"], s["tags"].get("task", ""))
                  for s in spans)


def test_traced_span_trees_match_the_reference(runtimes):
    trees = {}
    for side, rt in RUNTIMES.items():
        tr = SIDES[side][0]
        tr.install()
        with tr.start_span("root") as root:
            _program(rt)
        trace_id = root.ctx.trace_id
        # 8 traced tasks: a queue span each, an exec span each.
        trees[side] = _poll(lambda: (
            lambda t: t if sum(1 for n, *_ in t if n == "task.exec") >= 8
            else None)(_span_tree(tr, trace_id)))
        assert all(s["trace_id"] == trace_id
                   for s in tr.local_spans(trace_id))
    assert trees["port"] == trees["reference"]
    names = [n for n, *_ in trees["port"]]
    assert names.count("task.exec") == 8 and names.count("task.queue") == 8
    assert ("task.exec", "root", "error", "bad") in trees["port"]
    assert ("task.exec", "root", "error", "Acc.boom") in trees["port"]


def test_task_payload_carries_trace_only_when_armed(runtimes):
    """TaskSpec.trace is the ambient context at submit when armed, and
    None otherwise (no payload key)."""
    w = _worker("port")
    captured = []
    orig = w.submit_task

    def spy(spec):
        captured.append(spec)
        return orig(spec)

    w.submit_task = spy
    try:
        @ray_tpu_torch.remote
        def f(x):
            return x

        assert ray_tpu_torch.get(f.remote(1), timeout=T) == 1
        assert captured[-1].trace is None
        port_tracing.install()
        with port_tracing.start_span("root") as s:
            assert ray_tpu_torch.get(f.remote(2), timeout=T) == 2
        assert captured[-1].trace == (s.ctx.trace_id, s.ctx.span_id)
    finally:
        w.submit_task = orig


def test_tracing_off_records_zero_spans_for_tasks(runtimes):
    @ray_tpu_torch.remote
    def f(x):
        return x

    @ray_tpu_torch.remote
    class Echo:
        def echo(self, x):
            return x

    e = Echo.remote()
    assert ray_tpu_torch.get([f.remote(i) for i in range(8)],
                             timeout=T) == list(range(8))
    assert ray_tpu_torch.get(e.echo.remote(3), timeout=T) == 3
    assert port_tracing.tracer() is None
    assert port_tracing.local_spans() == []
    assert port_tracing.task_context(b"x" * 24) is None
    # Task events are always on; only the bridge is gated.
    assert _worker("port").task_events.summary()


def test_init_arms_from_the_environment_and_shutdown_disarms(monkeypatch):
    ray_tpu_torch.shutdown()
    monkeypatch.setenv(port_tracing.ENV_VAR, "1")
    ray_tpu_torch.init(num_cpus=2)
    try:
        assert port_tracing.active()
    finally:
        ray_tpu_torch.shutdown()
    assert port_tracing.tracer() is None
    monkeypatch.setenv(port_tracing.ENV_VAR, "0")
    ray_tpu_torch.init(num_cpus=2)
    try:
        assert port_tracing.tracer() is None
    finally:
        ray_tpu_torch.shutdown()


# -------------------------------------------------- units, on both sides
@pytest.mark.parametrize("side", list(SIDES))
def test_off_mode_is_inert(side):
    tr = SIDES[side][0]
    assert not tr.active()
    assert tr.inject() is None
    assert tr.extract(("a", "b")) is None
    assert tr.local_spans() == []
    assert tr.begin("x") is None
    tr.finish(None)
    tr.event("x")
    assert tr.new_trace() is None
    assert tr.take_cold_start() is None
    with tr.start_span("y") as s:
        assert s is None


@pytest.mark.parametrize("side", list(SIDES))
def test_inject_extract_roundtrip(side):
    tr = SIDES[side][0]
    tr.install()
    with tr.start_span("root") as s:
        wire = tr.inject()
        assert wire == (s.ctx.trace_id, s.ctx.span_id)
        ctx = tr.extract(wire)
        assert (ctx.trace_id, ctx.span_id) == wire
        ctx2 = tr.extract((wire[0].encode(), wire[1].encode()))
        assert ctx2.trace_id == s.ctx.trace_id
    assert tr.extract(None) is None
    assert tr.extract("garbage") is None
    assert tr.inject() is None   # no ambient context left


@pytest.mark.parametrize("side", list(SIDES))
def test_span_ring_is_bounded(side):
    tr = SIDES[side][0]
    t = tr.install(capacity=32)
    with tr.start_span("root"):
        for i in range(200):
            tr.event(f"e{i}")
    assert len(tr.local_spans()) <= 32
    assert t.spans_recorded == 201


@pytest.mark.parametrize("side", list(SIDES))
def test_nested_spans_parent_and_error_status(side):
    tr = SIDES[side][0]
    tr.install()
    with tr.start_span("outer") as outer:
        with pytest.raises(ValueError):
            with tr.start_span("inner", k=1):
                raise ValueError("boom")
        tr.event("mark", why="x")
    spans = {s["name"]: s for s in tr.local_spans()}
    assert spans["inner"]["parent_id"] == outer.ctx.span_id
    assert spans["inner"]["status"] == "error"
    assert spans["inner"]["tags"] == {"k": "1"}
    assert spans["outer"]["status"] == "ok"
    assert spans["outer"]["parent_id"] == ""
    assert spans["mark"]["parent_id"] == outer.ctx.span_id
    assert spans["mark"]["dur"] == 0.0
    assert {s["trace_id"] for s in spans.values()} == {outer.ctx.trace_id}


def _cold_start_case(tr):
    tr.install()
    with tr.start_span("req") as s:
        tr.stash_cold_start()
    ctx = tr.take_cold_start()
    got = [ctx.trace_id == s.ctx.trace_id, tr.take_cold_start() is None]
    with tr.start_span("wake") as w:
        tr.stash_cold_start()
        tr.clear_cold_start(w.ctx)
    got.append(tr.take_cold_start() is None)
    with tr.start_span("other") as o:
        tr.stash_cold_start()
    tr.clear_cold_start(tr.TraceContext("deadbeef", "x"))
    got.append(tr.take_cold_start().trace_id == o.ctx.trace_id)
    with tr.start_span("retry") as r:
        tr.stash_cold_start()
    ctx2, deadline = tr.take_cold_start_timed()
    tr.stash_cold_start(ctx2, deadline=deadline)
    got.append(tr.take_cold_start_timed()[1] == deadline)
    tr.stash_cold_start(r.ctx, deadline=0.0)   # long expired
    got.append(tr.take_cold_start_timed() is None)
    return got


def test_cold_start_stash_matches_the_reference():
    assert _cold_start_case(port_tracing) == _cold_start_case(ref_tracing)
    assert all(_cold_start_case(port_tracing))


def test_cold_start_parent_reads_the_stash_without_taking_it():
    """Port only: the in-process cold-start chain (the reference reads
    RAY_TPU_TRACE_PARENT, which a launched daemon inherits)."""
    port_tracing.install()
    assert port_tracing.cold_start_parent() is None
    with port_tracing.start_span("serve.wake") as w:
        port_tracing.stash_cold_start()
    for _ in range(2):   # several replicas of one wake share it
        assert port_tracing.cold_start_parent().span_id == w.ctx.span_id
    port_tracing.clear_cold_start(w.ctx)
    assert port_tracing.cold_start_parent() is None
    port_tracing.stash_cold_start(w.ctx, deadline=0.0)
    assert port_tracing.cold_start_parent() is None


@pytest.mark.parametrize("side", list(SIDES))
def test_chrome_trace_shapes(side):
    tr = SIDES[side][0]
    tr.install()
    with tr.start_span("root") as s:
        s.event("marker")
    events = tr.chrome_trace(tr.local_spans(s.ctx.trace_id))
    assert [(e["name"], e["ph"], e["cat"]) for e in events] == [
        ("root", "X", "driver"), ("marker", "i", "event")]
    assert all("trace_id" in e["args"] for e in events)


def test_task_bridge_spans_match_the_reference():
    """The bridge alone: RUNNING after a pending state emits task.queue,
    a terminal state task.exec (error on FAILED), a bare terminal record
    a zero-length task.<state> marker."""
    out = {}
    for side, (tr, te, tid_cls) in SIDES.items():
        tr.install()
        buf = te.TaskEventBuffer(capacity=64)
        base = tid_cls(b"t" * 24)
        with tr.start_span("root") as root:
            for i, terminal in enumerate(("FINISHED", "FAILED")):
                tid = tid_cls.of(base, i)
                tr.register_task(tid.binary(), tr.inject())
                buf.record(tid, "PENDING_ARGS_AVAIL", name=f"t{i}")
                buf.record(tid, "RUNNING", name=f"t{i}")
                buf.record(tid, terminal, name=f"t{i}")
            bare = tid_cls.of(base, 9)
            tr.register_task(bare.binary(), root.ctx)
        buf.record(bare, "FINISHED", name="bare")
        buf.record(tid_cls.of(base, 10), "FINISHED", name="unregistered")
        out[side] = _span_tree(tr, root.ctx.trace_id)
    assert out["port"] == out["reference"]
    assert ("task.finished", "root", "ok", "bare") in out["port"]
    assert ("task.exec", "root", "error", "t1") in out["port"]


# --------------------------------------------------- task-event buffer
@pytest.mark.parametrize("side", list(SIDES))
def test_task_event_terminal_eviction_is_deterministic_and_bounded(side):
    _, te, tid_cls = SIDES[side]
    base_x, base_y = tid_cls(b"x" * 24), tid_cls(b"y" * 24)
    buf = te.TaskEventBuffer(capacity=64)
    for i in range(64 * 5):
        tid = tid_cls.of(base_x, i)
        buf.record(tid, "RUNNING", name="t")
        buf.record(tid, "FINISHED", name="t")
    assert buf.index_size() <= 64
    live = [tid_cls.of(base_y, i) for i in range(10)]
    for tid in live:
        buf.record(tid, "RUNNING", name="live")
    for i in range(64 * 5, 64 * 10):
        tid = tid_cls.of(base_x, i)
        buf.record(tid, "RUNNING", name="t")
        buf.record(tid, "FINISHED", name="t")
    assert buf.index_size() <= 64 + 10
    states = {ev.task_id: ev.state for ev in buf.list_tasks()}
    assert all(states[tid] == "RUNNING" for tid in live)
    replay = live[0]
    buf.record(replay, "FINISHED", name="live")
    buf.record(replay, "RUNNING", name="live")
    for i in range(64 * 10, 64 * 12):
        buf.record(tid_cls.of(base_x, i), "FINISHED", name="t")
    assert {ev.state for ev in buf.list_tasks()
            if ev.task_id == replay} == {"RUNNING"}
    assert len(buf.list_events()) == 64   # the ring itself is bounded


@pytest.mark.parametrize("side", list(SIDES))
def test_task_event_drain_since_cursor(side):
    _, te, tid_cls = SIDES[side]
    buf = te.TaskEventBuffer(capacity=128)
    t1 = tid_cls.of(tid_cls(b"a" * 24), 1)
    buf.record(t1, "RUNNING", name="t")
    cursor, evs = buf.drain_since(0)
    assert [e.state for e in evs] == ["RUNNING"]
    cursor2, evs2 = buf.drain_since(cursor)
    assert evs2 == [] and cursor2 == cursor
    buf.record(t1, "FINISHED", name="t")
    cursor3, evs3 = buf.drain_since(cursor)
    assert [e.state for e in evs3] == ["FINISHED"]
    for i in range(10):
        buf.record(tid_cls.of(tid_cls(b"b" * 24), i), "FINISHED", name="t")
    c, evs = buf.drain_since(cursor3, limit=4)
    assert len(evs) == 4
    _, evs2 = buf.drain_since(c, limit=100)
    assert len(evs2) == 6
    assert buf.latest_seq() == 12


@pytest.mark.parametrize("side", list(SIDES))
def test_task_event_ingest_merges_with_node_tag(side):
    _, te, tid_cls = SIDES[side]
    buf = te.TaskEventBuffer(capacity=128)
    t1 = tid_cls.of(tid_cls(b"c" * 24), 1)
    n = buf.ingest([(t1, "RUNNING", time.time() - 1.0, "remote", None,
                     "node-A"),
                    (t1, "FINISHED", time.time(), "remote", 0.5,
                     "node-A")])
    assert n == 2
    rows = buf.list_tasks()
    assert len(rows) == 1 and rows[0].state == "FINISHED"
    assert rows[0].extra["node"] == "node-A"
    buf.ingest([(t1, "RUNNING", time.time() - 10.0, "remote", None,
                 "node-A")])
    assert buf.list_tasks()[0].state == "FINISHED"
    assert buf.summary() == {"FINISHED": 1}


def test_task_event_chrome_trace_matches_the_reference():
    out = {}
    for side, (_, te, tid_cls) in SIDES.items():
        buf = te.TaskEventBuffer(capacity=64)
        base = tid_cls(b"d" * 24)
        for i, terminal in enumerate(("FINISHED", "FAILED", None)):
            tid = tid_cls.of(base, i)
            buf.record(tid, "PENDING_NODE_ASSIGNMENT", name=f"t{i}")
            buf.record(tid, "RUNNING", name=f"t{i}")
            if terminal:
                buf.record(tid, terminal, name=f"t{i}")
        out[side] = [(e["name"], e["cat"], e["ph"], e["args"]["state"],
                      e["dur"] >= 1) for e in buf.to_chrome_trace()]
    assert out["port"] == out["reference"]
    assert [r[0] for r in out["port"]] == ["t0", "t1"]
