"""Twins of ``ray_tpu.util``'s remaining modules on the CPU: placement
groups and scheduling strategies, pub/sub, the host-plane sanitizer, the
load generator and the chaos plane, the reference's module beside the
port's on the same inputs.

Each case runs once per side, as a function of that side's namespace
(``REF`` or ``PORT``); the outcomes (values, error type names, violation
kinds) must be equal. Runtime cases run the reference on
``ray_tpu.init(num_cpus=4, worker_mode="thread")`` beside
``ray_tpu_torch.init(num_cpus=4)``. Cases come from
``tests/test_platform.py:22`` and ``:31``, ``tests/test_head.py:631``,
the 13 of ``tests/test_sanitizer.py``, the 8 of ``tests/test_loadgen.py``
and ``tests/test_chaos_matrix.py:100``, ``:112`` and ``:590``; the wall
clock is never bounded (the open-loop case checks that fires overlap
instead of timing them).

Every wait is bounded. The fixtures switch the sanitizer off, uninstall
both chaos injectors and wait (bounded) for every
``ray_tpu_sanitizer_watch``, ``ray_tpu_loadgen*`` and
``ray_tpu_node_killer`` thread to end: the reference's watchdog stop and
the generator's pool shutdown do not join.
"""

import json
import subprocess
import sys
import threading
import time
import types

import pytest

import ray_tpu
import ray_tpu.serve as j_serve
import ray_tpu.util as j_util
import ray_tpu_torch
import ray_tpu_torch.serve as t_serve
import ray_tpu_torch.util as t_util
from ray_tpu._private import chaos as j_chaos_private
from ray_tpu._private import flight as j_flight
from ray_tpu.channels import channel as j_channel
from ray_tpu.util import chaos as j_chaos
from ray_tpu.util import loadgen as j_loadgen
from ray_tpu.util import metrics as j_metrics
from ray_tpu.util import pubsub as j_pubsub
from ray_tpu.util import sanitizer as j_sanitizer
from ray_tpu.util import scheduling_strategies as j_strategies
from ray_tpu.util import state as j_state
from ray_tpu_torch._private import chaos as t_chaos_private
from ray_tpu_torch._private import flight as t_flight
from ray_tpu_torch.channels import channel as t_channel
from ray_tpu_torch.util import chaos as t_chaos
from ray_tpu_torch.util import loadgen as t_loadgen
from ray_tpu_torch.util import metrics as t_metrics
from ray_tpu_torch.util import pubsub as t_pubsub
from ray_tpu_torch.util import sanitizer as t_sanitizer
from ray_tpu_torch.util import scheduling_strategies as t_strategies
from ray_tpu_torch.util import state as t_state

T = 30.0

REF = types.SimpleNamespace(
    name="ref", rt=ray_tpu, serve=j_serve, util=j_util,
    strategies=j_strategies, pubsub=j_pubsub, sanitizer=j_sanitizer,
    loadgen=j_loadgen,
    chaos=j_chaos, chaos_private=j_chaos_private, state=j_state,
    channel=j_channel, metrics=j_metrics, flight=j_flight,
    init=lambda **kw: ray_tpu.init(worker_mode="thread",
                                   ignore_reinit_error=True, **kw))
PORT = types.SimpleNamespace(
    name="port", rt=ray_tpu_torch, serve=t_serve, util=t_util,
    strategies=t_strategies, pubsub=t_pubsub, sanitizer=t_sanitizer,
    loadgen=t_loadgen,
    chaos=t_chaos, chaos_private=t_chaos_private, state=t_state,
    channel=t_channel, metrics=t_metrics, flight=t_flight,
    init=lambda **kw: ray_tpu_torch.init(**kw))
SIDES = (REF, PORT)

# Threads these modules start whose stop does not join them in the
# reference (the port's stop, shutdown and uninstall join their own).
_THREAD_PREFIXES = ("ray_tpu_sanitizer_watch", "ray_tpu_loadgen",
                    "ray_tpu_node_killer")


def _wait_for_threads(prefixes=_THREAD_PREFIXES, bound=T):
    deadline = time.monotonic() + bound
    for t in threading.enumerate():
        if t.name.startswith(prefixes):
            t.join(max(deadline - time.monotonic(), 0.0))
    return [t.name for t in threading.enumerate()
            if t.name.startswith(prefixes)]


def _reset():
    for s in SIDES:
        s.sanitizer.enable(False)
        s.sanitizer.clear()
        s.chaos.uninstall()
        s.flight.uninstall()
        s.rt.shutdown()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # The watchdogs a runtime starts poll every 0.05 s here (5 s by
    # default), so the reference's unjoined one ends within the bound.
    for s in SIDES:
        monkeypatch.setattr(s.sanitizer.StallWatchdog.__init__,
                            "__defaults__", (30.0, 0.05))
        # The stall cases count fires in each sanitizer's module counter;
        # put it back, so no later test in this process reads them.
        monkeypatch.setattr(s.sanitizer, "watchdog_fires",
                            s.sanitizer.watchdog_fires)
    _reset()
    yield
    _reset()
    assert _wait_for_threads() == []


@pytest.fixture
def runtimes():
    for s in SIDES:
        s.init(num_cpus=4)
    yield


def _outcome(case, s):
    try:
        return ("ok", case(s))
    except Exception as exc:  # noqa: BLE001 — the error is the outcome
        return ("err", type(exc).__name__)


def _twin(case):
    ref = _outcome(case, REF)
    port = _outcome(case, PORT)
    assert port == ref
    return ref


def _wait_for(cond, bound=T):
    deadline = time.monotonic() + bound
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


# ------------------------------------------------------ placement groups
def test_util_exports_match_the_reference():
    assert sorted(t_util.__all__) == sorted(
        j_util.__all__ + ["annotate", "profile_trace", "trace_files"])
    for name in j_util.__all__:
        assert hasattr(t_util, name), name
    for name in ("DEFAULT", "SPREAD"):
        assert getattr(t_strategies, name) == getattr(j_strategies, name)


def test_placement_group_single_node_reserve_release(runtimes):
    """``tests/test_platform.py:22``: two bundles reserve 2 of 4 CPUs;
    removing the group gives them back."""

    def case(s):
        pg = s.util.placement_group([{"CPU": 1}, {"CPU": 1}],
                                    strategy="PACK")
        ready = pg.wait(5)
        during = s.rt.available_resources()["CPU"]
        table = s.state.list_placement_groups()
        s.util.remove_placement_group(pg)
        return (ready, during, [(r["strategy"], r["state"]) for r in table],
                s.rt.available_resources()["CPU"],
                s.state.list_placement_groups())

    assert _twin(case) == ("ok", (True, 2.0, [("PACK", "CREATED")], 4.0,
                                  []))


def test_placement_group_infeasible_raises(runtimes):
    """``tests/test_platform.py:31``: a demand above the total raises."""

    def case(s):
        s.util.placement_group([{"CPU": 100}])

    assert _twin(case) == ("err", "ValueError")


@pytest.mark.parametrize("bundles,strategy", [
    ([{"CPU": 1}, {"CPU": 1}], "STRICT_SPREAD"),
    ([{"CPU": 1}], "NOT_A_STRATEGY"),
    ([{"CPU": 1}, {}], "PACK"),
])
def test_placement_group_refusals(runtimes, bundles, strategy):
    """STRICT_SPREAD over two bundles cannot be honoured on one node; an
    unknown strategy and an empty bundle are refused too."""

    def case(s):
        s.util.placement_group(bundles, strategy=strategy)

    assert _twin(case) == ("err", "ValueError")


def test_pending_group_stays_pending_in_the_table(runtimes):
    """A group that fits the total but not what is free now stays
    PENDING, by name and in the table; removing either group releases
    only what was reserved."""

    def case(s):
        held = s.util.placement_group([{"CPU": 3}], name="held")
        pending = s.util.placement_group([{"CPU": 2}], strategy="SPREAD",
                                         name="pending")
        got = (held.wait(5), pending.wait(0.05),
               s.util.get_placement_group("pending") is pending,
               sorted((r["name"], r["state"], r["bundles"][0]["CPU"])
                      for r in s.util.placement_group_table().values()),
               s.rt.available_resources()["CPU"])
        s.util.remove_placement_group(pending)
        after_pending = s.rt.available_resources()["CPU"]
        s.util.remove_placement_group(held)
        s.util.remove_placement_group(held)     # a second remove: no-op
        return got + (after_pending, s.rt.available_resources()["CPU"],
                      s.util.placement_group_table())

    assert _twin(case) == ("ok", (
        True, False, True, [("held", "CREATED", 3), ("pending", "PENDING",
                                                     2)],
        1.0, 1.0, 4.0, {}))
    with pytest.raises(ValueError):
        t_util.get_placement_group("pending")


def test_strategy_draws_from_the_pool_not_the_bundle(runtimes):
    """A task carrying ``PlacementGroupSchedulingStrategy`` draws its CPU
    from the pool, as the reference's single-node scheduler does (it only
    records the strategy); an actor holds its CPU only while it is
    created, on both sides; ``ready()`` resolves True for a created
    group."""

    def case(s):
        pg = s.util.placement_group([{"CPU": 2}], strategy="STRICT_PACK")
        strategy = s.strategies.PlacementGroupSchedulingStrategy(pg, 0)

        @s.rt.remote(num_cpus=1)
        def inside():
            return s.rt.available_resources()["CPU"]

        @s.rt.remote(num_cpus=1)
        class Inside:
            def free(self):
                return s.rt.available_resources()["CPU"]

        ready = s.rt.get(pg.ready(), timeout=T)
        in_task = s.rt.get(inside.options(
            scheduling_strategy=strategy).remote(), timeout=T)
        actor = Inside.options(scheduling_strategy=strategy).remote()
        in_actor = s.rt.get(actor.free.remote(), timeout=T)
        s.rt.kill(actor)
        s.util.remove_placement_group(pg)
        return ready, in_task, in_actor

    assert _twin(case) == ("ok", (True, 1.0, 2.0))


# ----------------------------------------------------------------- pubsub
def test_pubsub_local_fallback():
    """``tests/test_head.py:631``: without a head attachment the API
    works in-process; a callback subscriber counts as a handler."""

    def case(s):
        seen = []
        sub = s.pubsub.subscribe("local:topic")
        cb = s.pubsub.subscribe("local:topic", seen.append)
        try:
            n = s.pubsub.publish("local:topic", 7)
            got = sub.get(timeout=5)
        finally:
            sub.close()
        after = s.pubsub.publish("local:topic", 8)
        s.pubsub._local_subs.get("local:topic", []).clear()
        cb.close()
        return n, got, after, seen, s.pubsub.publish("local:topic", 9)

    assert _twin(case) == ("ok", (2, 7, 1, [7, 8], 0))
    assert t_pubsub.NODE_EVENTS_TOPIC == j_pubsub.NODE_EVENTS_TOPIC


# -------------------------------------------------------------- sanitizer
@pytest.fixture
def sanitized():
    for s in SIDES:
        s.sanitizer.enable(True)
        s.sanitizer.clear()
    yield


def _kinds(s):
    return [v.split("] ", 1)[1].split(":", 1)[0]
            for v in s.sanitizer.violations()]


def test_refcount_underflow_detected(sanitized):
    def case(s):
        s.init(num_cpus=1)
        try:
            w = s.rt._private.worker.global_worker()
            ref = s.rt.put(41)
            oid = ref.object_id
            w.store.add_submitted_ref(oid)
            w.store.remove_local_ref(oid)    # 1 -> 0: legitimate
            try:
                w.store.remove_local_ref(oid)    # 0 -> -1: double release
            except s.sanitizer.SanitizerError as exc:
                return "underflow" in str(exc), _kinds(s)
        finally:
            # The ref's own release would underflow again at collection.
            s.sanitizer.enable(False)
            del ref
            s.rt.shutdown()
            s.sanitizer.enable(True)

    assert _twin(case) == ("ok", (True, ["refcount-underflow"]))


def test_channel_double_read_detected(sanitized):
    def case(s):
        ch = s.channel.IntraProcessChannel(num_readers=2)
        ch.write("v1")
        first = ch.read(0, timeout=1)
        ch._read_version[0] = 0
        try:
            ch.read(0, timeout=1)
        except s.sanitizer.SanitizerError as exc:
            return first, "double-read" in str(exc), _kinds(s)

    assert _twin(case) == ("ok", ("v1", True, ["channel-double-read"]))


def test_channel_version_gap_detected(sanitized):
    def case(s):
        ch = s.channel.IntraProcessChannel(num_readers=1)
        ch.write("v1")
        ch._version = 3
        ch._reads_left = 1
        ch.read(0, timeout=1)

    assert _twin(case) == ("err", "SanitizerError")
    assert _kinds(PORT) == _kinds(REF) == ["channel-version-gap"]


def test_clean_run_has_no_violations(sanitized):
    """Tasks, an actor and a channel under the sanitizer report nothing;
    the runtime started the stall watchdog, and the port's shutdown
    joined it."""

    def case(s):
        s.init(num_cpus=2)
        try:
            @s.rt.remote
            def sq(x):
                return x * x

            @s.rt.remote
            class A:
                def __init__(self):
                    self.n = 0

                def inc(self):
                    self.n += 1
                    return self.n

            out = s.rt.get([sq.remote(i) for i in range(8)], timeout=T)
            a = s.rt.get(A.remote().inc.remote(), timeout=T)
            ch = s.channel.IntraProcessChannel(num_readers=1)
            for i in range(5):
                ch.write(i)
                out.append(ch.read(0, timeout=1))
            watch = s.rt._private.worker.global_worker().sanitizer_watchdog
            return out, a, watch is not None, s.sanitizer.violations()
        finally:
            s.rt.shutdown()

    assert _twin(case) == ("ok", ([i * i for i in range(8)] + list(range(5)),
                                  1, True, []))
    # The port's shutdown joined its watchdog; the reference's may
    # still be ending (its stop does not join).
    assert _wait_for_threads(bound=T) == []


def test_stall_watchdog_reports_stuck_queue(sanitized, monkeypatch):
    monkeypatch.setenv("RAY_TPU_SANITIZE_MODE", "warn")

    class FakeScheduler:
        def backlog_size(self):
            return 3

    class FakePool:
        def available(self):
            return {"CPU": 4.0}

    def case(s):
        wd = s.sanitizer.StallWatchdog(FakeScheduler(), FakePool(),
                                       threshold_s=0.2, period_s=0.05)
        try:
            fired = _wait_for(lambda: s.sanitizer.violations(), 5)
            return fired, sorted(set(_kinds(s)))
        finally:
            wd.stop()

    assert _twin(case) == ("ok", (True, ["scheduler-stall"]))


def test_stall_on_the_runtime_feeds_the_watchdog_gauge(sanitized,
                                                       monkeypatch):
    """A real stall on each runtime: a task needs a resource that a
    placement group holds, so it queues with nothing running and CPUs
    idle. The runtime's watchdog reports it once its threshold passes
    (0.2 s here); with the flight recorder disarmed the sanitizer's own
    counter takes the fire, and the ``watchdog_fires`` gauge sums both
    counters. Removing the group lets the task run."""
    monkeypatch.setenv("RAY_TPU_SANITIZE_MODE", "warn")
    for s in SIDES:
        monkeypatch.setattr(s.sanitizer.StallWatchdog.__init__,
                            "__defaults__", (0.2, 0.05))

    def case(s):
        s.init(num_cpus=2, resources={"slot": 1.0})
        try:
            fires0 = s.sanitizer.watchdog_fires
            pg = s.util.placement_group([{"slot": 1.0}])

            @s.rt.remote(resources={"slot": 1.0})
            def blocked():
                return "ran"

            ref = blocked.remote()
            fired = _wait_for(lambda: "scheduler-stall" in _kinds(s), 10)
            w = s.rt._private.worker.global_worker()
            # The watchdog may fire again while the gauge refreshes.
            fires1 = s.sanitizer.watchdog_fires
            s.metrics.refresh_framework_metrics(w)
            gauge, = s.metrics.framework_metrics()[
                "watchdog_fires"]._samples().values()
            fires2 = s.sanitizer.watchdog_fires
            s.util.remove_placement_group(pg)
            out = s.rt.get(ref, timeout=T)
            return fired, fires1 > fires0, fires1 <= gauge <= fires2, out
        finally:
            s.rt.shutdown()

    assert _twin(case) == ("ok", (True, True, True, "ran"))


def test_watchdog_fires_through_the_armed_recorder(monkeypatch):
    """With the flight recorder armed a stall fire goes to the recorder,
    not to the sanitizer's counter, and the gauge still counts it."""
    monkeypatch.setenv("RAY_TPU_SANITIZE_MODE", "warn")

    class FakeScheduler:
        def backlog_size(self):
            return 2

    class FakePool:
        def available(self):
            return {"CPU": 1.0}

    def case(s):
        rec = s.flight.install(component="driver")
        fires0 = s.sanitizer.watchdog_fires
        wd = s.sanitizer.StallWatchdog(FakeScheduler(), FakePool(),
                                       threshold_s=0.1, period_s=0.02)
        try:
            fired = _wait_for(lambda: rec.watchdog_fires >= 1, 5)
        finally:
            wd.stop()
        s.metrics.refresh_framework_metrics(None)
        gauge = list(s.metrics.framework_metrics()[
            "watchdog_fires"]._samples().values())[0]
        s.flight.uninstall()
        return (fired, s.sanitizer.watchdog_fires == fires0,
                gauge == rec.watchdog_fires + fires0)

    assert _twin(case) == ("ok", (True, True, True))


def test_lock_order_cycle_detected_before_deadlock(sanitized):
    def case(s):
        a = s.sanitizer.tracked_lock("order.A")
        b = s.sanitizer.tracked_lock("order.B")
        with a:
            with b:
                pass
        with b:
            with a:
                pass

    assert _twin(case) == ("err", "SanitizerError")
    assert _kinds(PORT) == _kinds(REF) == ["lock-order-cycle"]


def test_lock_order_cycle_detected_across_threads(sanitized):
    def case(s):
        a = s.sanitizer.tracked_lock("xthread.A")
        b = s.sanitizer.tracked_lock("xthread.B")
        errors = []

        def first():
            s.sanitizer.enable(True)
            with a:
                with b:
                    pass

        def second():
            s.sanitizer.enable(True)
            try:
                with b:
                    with a:
                        pass
            except s.sanitizer.SanitizerError as exc:
                errors.append(exc)

        for fn in (first, second):
            t = threading.Thread(target=fn)
            t.start()
            t.join(timeout=10)
        return [type(e).__name__ for e in errors], \
            ["lock-order-cycle" in str(e) for e in errors]

    assert _twin(case) == ("ok", (["SanitizerError"], [True]))


def test_lock_order_transitive_cycle(sanitized):
    def case(s):
        a, b, c = (s.sanitizer.tracked_lock(f"tri.{n}") for n in "ABC")
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        try:
            with c:
                with a:
                    pass
        except s.sanitizer.SanitizerError as exc:
            return "tri.C" in str(exc), sorted(
                (k, sorted(v))
                for k, v in s.sanitizer.lock_order_watcher.edges().items())

    assert _twin(case) == ("ok", (True, [
        ("tri.A", ["tri.B"]), ("tri.B", ["tri.C"]), ("tri.C", ["tri.A"])]))


def test_lock_order_self_deadlock_detected(sanitized):
    def case(s):
        a = s.sanitizer.tracked_lock("self.A")
        try:
            with a:
                with a:
                    pass
        except s.sanitizer.SanitizerError:
            stack = list(s.sanitizer.lock_order_watcher._stack())
            s.sanitizer.lock_order_watcher._stack().clear()
            return "raised", a.locked(), stack

    assert _twin(case) == ("ok", ("raised", False, []))


def test_lock_order_consistent_order_is_clean(sanitized):
    def case(s):
        a = s.sanitizer.tracked_lock("clean.A")
        b = s.sanitizer.tracked_lock("clean.B")
        r = s.sanitizer.tracked_rlock("clean.R")
        for _ in range(3):
            with a:
                with b:
                    pass
        with r:
            with r:
                with a:
                    pass
        return s.sanitizer.violations(), r.locked()

    assert _twin(case) == ("ok", ([], False))


def test_tracked_lock_inert_when_disabled(sanitized):
    def case(s):
        s.sanitizer.enable(False)
        a = s.sanitizer.tracked_lock("inert.A")
        b = s.sanitizer.tracked_lock("inert.B")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        edges = s.sanitizer.lock_order_watcher.edges()
        s.sanitizer.enable(True)
        return edges, s.sanitizer.violations()

    assert _twin(case) == ("ok", ({}, []))


def test_tracked_lock_toggle_mid_hold_does_not_strand_stack(sanitized):
    def case(s):
        a = s.sanitizer.tracked_lock("toggle.A")
        b = s.sanitizer.tracked_lock("toggle.B")
        a.acquire()
        s.sanitizer.enable(False)
        a.release()
        s.sanitizer.enable(True)
        stack = list(s.sanitizer.lock_order_watcher._stack())
        with b:
            pass
        return stack, any("toggle.A" in e for e in
                          s.sanitizer.lock_order_watcher.edges())

    assert _twin(case) == ("ok", ([], False))


def test_tracked_rlock_locked_probe(sanitized):
    def case(s):
        r = s.sanitizer.tracked_rlock("probe.R")
        states = [r.locked()]
        with r:
            states.append(r.locked())
        states.append(r.locked())
        return states

    assert _twin(case) == ("ok", [False, True, False])


def test_tracked_locks_feed_the_flight_lock_plane():
    """With the recorder armed (sanitizer off) a tracked lock's hold is
    timed by the recorder's lock plane on both sides."""

    def case(s):
        rec = s.flight.install(component="driver")
        lock = s.sanitizer.tracked_rlock("flight.R")
        with lock:
            with lock:
                held = sorted(n for _, n in rec._holds)
        after = list(rec._holds)
        s.flight.uninstall()
        return held, after

    assert _twin(case) == ("ok", (["flight.R"], []))


# ---------------------------------------------------------------- loadgen
def _shape(s):
    return (s.loadgen.Ramp(1.0, 10.0, 5.0) >> s.loadgen.Spike(20.0, 2.0)
            >> s.loadgen.Ramp(10.0, 1.0, 5.0))


def test_schedule_is_seeded_and_replayable():
    def case(s):
        shape = _shape(s)
        a, b, c = (shape.schedule(seed=k) for k in (7, 7, 8))
        return (a, a == b, a != c, all(0 <= t < shape.duration_s for t in a),
                a == sorted(a))

    out = _twin(case)
    assert out[0] == "ok" and out[1][1:] == (True, True, True, True)


def test_schedule_count_tracks_integrated_rate():
    def case(s):
        shape = s.loadgen.Ramp(0.0, 10.0, 10.0) >> s.loadgen.Spike(20.0, 2.0)
        return len(shape.schedule(seed=3))

    out = _twin(case)
    assert out[0] == "ok" and 50 <= out[1] <= 130


def test_phase_rates_compose_piecewise():
    def case(s):
        shape = (s.loadgen.Step(2.0, 4.0) >> s.loadgen.Ramp(2.0, 6.0, 4.0)
                 >> s.loadgen.Diurnal(5.0, 3.0, 8.0, cycles=2))
        return (shape.duration_s, shape.rate_at(1.0), shape.rate_at(6.0),
                shape.rate_at(10.0), shape.rate_at(-1.0),
                shape.rate_at(100.0), shape.peak_rate(), shape.describe())

    out = _twin(case)
    assert out[1][:7] == (24.0, 2.0, 4.0, 8.0, 0.0, 0.0, 8.0)
    assert [d["kind"] for d in out[1][7]] == ["Step", "Ramp", "Diurnal"]


def test_diurnal_floors_at_zero():
    def case(s):
        d = s.loadgen.Diurnal(1.0, 5.0, 4.0)
        return d.rate_at(3.0), d.peak_rate(), d.schedule(seed=1)

    out = _twin(case)
    assert out[1][:2] == (0.0, 6.0)


def test_generator_drives_fire_and_records_outcomes():
    def case(s):
        calls = []

        def fire(i, t):
            calls.append(i)
            if i % 5 == 1:
                raise ValueError("boom")
            return i * 2

        gen = s.loadgen.LoadGenerator(s.loadgen.Step(50.0, 0.4), fire,
                                      seed=1, max_concurrency=8)
        records = gen.run(timeout_s=T)
        summary = gen.summary()
        return (sorted(calls), [(r.index, r.outcome, r.value
                                 if r.outcome == "ok" else None)
                                for r in records],
                {k: summary[k] for k in ("scheduled", "fired", "ok",
                                         "errors")})

    out = _twin(case)
    calls, records, summary = out[1]
    assert calls == [r[0] for r in records]
    assert any(o == "ok" for _, o, _ in records)
    assert all(o == ("error:ValueError" if i % 5 == 1 else "ok")
               for i, o, _ in records)
    assert summary["fired"] == len(records)


def test_generator_open_loop_does_not_reshape_arrivals():
    """A slow fire() does not stretch the schedule: fires overlap (the
    pool dispatches while earlier fires run), every fire starts at or
    after its scheduled time, and each side fires the same schedule."""

    def case(s):
        active, peak, lock = [0], [0], threading.Lock()

        def slow_fire(i, t):
            with lock:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
            time.sleep(0.05)
            with lock:
                active[0] -= 1

        gen = s.loadgen.LoadGenerator(s.loadgen.Step(40.0, 0.5), slow_fire,
                                      seed=2, max_concurrency=64)
        records = gen.run(timeout_s=T)
        return (gen.schedule, peak[0] > 1,
                all(r.started_t >= r.scheduled_t for r in records),
                all(r.outcome == "ok" for r in records))

    out = _twin(case)
    assert out[1][1:] == (True, True, True)


def test_generator_stop_skips_remaining():
    def case(s):
        fired = []
        gen = s.loadgen.LoadGenerator(s.loadgen.Step(20.0, 2.0),
                                      lambda i, t: fired.append(i), seed=4)
        stopper = threading.Timer(0.3, gen.stop)
        stopper.start()
        records = gen.run(timeout_s=10)
        stopper.cancel()
        stopper.join(5)
        skipped = [r for r in records if r.outcome == "skipped"]
        return bool(fired), bool(skipped), len(records)

    out = _twin(case)
    assert out[1][:2] == (True, True)


def test_explicit_schedule_replay():
    def case(s):
        shape = s.loadgen.Step(10.0, 1.0)
        sched = shape.schedule(seed=9)
        gen = s.loadgen.LoadGenerator(shape, lambda i, t: None,
                                      schedule=sched)
        records = gen.run(timeout_s=10)
        return sched, gen.schedule == sched, \
            [r.scheduled_t for r in records] == sched

    out = _twin(case)
    assert out[1][1:] == (True, True)


# ------------------------------------------------------------------ chaos
def test_chaos_env_parsing_strict(monkeypatch):
    def case(s):
        cfg = s.chaos.ChaosConfig
        out = [cfg.from_env(""), cfg.from_env("off"), cfg.from_env("0")]
        c = cfg.from_env('{"seed": 7, "drop": 0.1, "sites": ["peer"]}')
        out.append(c.to_dict())
        for bad in ('{"dorp": 0.1}', '[1, 2]'):
            try:
                cfg.from_env(bad)
                out.append("accepted")
            except ValueError:
                out.append("ValueError")
        monkeypatch.setenv("RAY_TPU_CHAOS", '{"seed": 3, "dup": 0.5}')
        inj = s.chaos.install_from_env()
        out.append((s.chaos.active(), inj.config.to_dict()))
        s.chaos.uninstall()
        monkeypatch.delenv("RAY_TPU_CHAOS")
        out.append((s.chaos.install_from_env(), s.chaos.active()))
        return out

    out = _twin(case)
    assert out[1][:3] == [None, None, None]
    assert out[1][4:6] == ["ValueError", "ValueError"]


def test_seeded_decisions_replay_exactly():
    """The same seed gives the same decision stream, on each side and
    across the two: the port's list equals the reference's."""
    cfg = dict(drop=0.2, delay=0.05, dup=0.1, corrupt=0.05, reset=0.02)

    def case(s):
        a, b, c = (s.chaos.ChaosInjector(s.chaos.ChaosConfig(seed=k, **cfg))
                   for k in (11, 11, 12))
        da = [a.decide("s") for _ in range(500)]
        db = [b.decide("s") for _ in range(500)]
        dc = [c.decide("s") for _ in range(500)]
        return da, da == db, da != dc, a.counters == b.counters, \
            a.counters, a.totals()

    out = _twin(case)
    assert out[1][1:4] == (True, True, True)
    assert out[1][4]["s"]["frames_seen"] == 500


def test_node_killer_schedule_is_seeded_and_recorded():
    def case(s):
        def fake(log):
            def _kill():
                log.append("x")
                return {"pid": len(log)}

            return _kill

        logs = ([], [])
        killers = [s.chaos.NodeKiller(
            [s.chaos.KillTarget("a", "worker", fake(log)),
             s.chaos.KillTarget("b", "daemon", fake(log))],
            seed=21, interval_s=(0.01, 0.03), max_kills=5) for log in logs]
        before = s.chaos.snapshot()["num_kills"]
        with killers[0], killers[1]:
            _wait_for(lambda: all(len(k.kills) >= 5 for k in killers), 10)
        names = [[k["name"] for k in killer.kills] for killer in killers]
        return (names[0], names[0] == names[1],
                all("pid" in k for k in killers[0].kills),
                s.chaos.snapshot()["num_kills"] - before,
                [t._thread.is_alive() for t in killers])

    out = _twin(case)
    assert out[1][1:] == (True, True, 10, [False, False])
    assert len(out[1][0]) == 5


def _sleeper():
    return subprocess.Popen([sys.executable, "-c",
                             "import time; time.sleep(60)"])


def test_chaos_summary_after_a_recorded_kill(runtimes):
    """A NodeKiller SIGKILLs a subprocess through ``popen_kill_target``;
    ``util.state.chaos_summary`` reports that kill (and, with Serve up,
    each deployment's admission stats), ``snapshot`` counts it, and the
    target leaves the rotation."""

    def case(s):
        from_serve = s.serve

        @from_serve.deployment
        def echo(x):
            return x

        from_serve.run(echo.bind()).remote(1).result(timeout=T)
        proc = _sleeper()
        try:
            before = s.chaos.snapshot()["num_kills"]
            killer = s.chaos.NodeKiller(
                [s.chaos.popen_kill_target("sleeper", proc, kind="driver")],
                seed=5, interval_s=(0.01, 0.02), max_kills=1)
            with killer:
                _wait_for(lambda: killer.kills, 10)
            rc = proc.wait(timeout=T)
            summary = s.state.chaos_summary()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=T)
            from_serve.shutdown()
        kills = [k for k in summary["kills"] if k.get("pid") == proc.pid]
        return (rc, summary["num_kills"] - before,
                [(k["name"], k["kind"]) for k in kills], killer.targets,
                summary["active"], summary["wire_counters"],
                sorted(summary["serve_shedding"]),
                summary["serve_shed_total"], summary["llm_shed_total"])

    assert _twin(case) == ("ok", (-9, 1, [("sleeper", "driver")], [], False,
                                  {}, ["echo"], 0, 0))


def test_pid_kill_target_and_the_controller_report():
    """``pid_kill_target`` re-resolves its pid each kill and refuses this
    process; ``ChaosController`` installs the config, runs the killer and
    reports both, and uninstalls at stop."""

    def case(s):
        proc = _sleeper()
        try:
            target = s.chaos.pid_kill_target("by_pid", lambda: proc.pid)
            with s.chaos.ChaosController(
                    wire=s.chaos.ChaosConfig(seed=2, drop=0.5),
                    targets=[target], seed=3, interval_s=(0.01, 0.02),
                    max_kills=1) as ctl:
                _wait_for(lambda: ctl.killer.kills, 10)
                decisions = [s.chaos.current().decide("peer")
                             for _ in range(20)]
                active = s.chaos.active()
                report = ctl.report()
            rc = proc.wait(timeout=T)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=T)
        try:
            s.chaos.pid_kill_target("self", lambda: None).kill()
            refused = "no"
        except RuntimeError:
            refused = "RuntimeError"
        return (decisions, active, s.chaos.active(), rc,
                report["wire"]["config"], report["wire"]["counters"],
                [(k["name"], k["pid"] == proc.pid)
                 for k in report["kills"]], refused)

    out = _twin(case)
    assert out[1][1:4] == (True, False, -9)
    assert out[1][6] == [("by_pid", True)] and out[1][7] == "RuntimeError"


def test_flight_bundle_chaos_entry_is_the_wire_counters():
    """The flight bundle's ``chaos`` entry is ``wire_counters()``: the
    installed injector's per-site counters, ``{}`` with none."""

    def case(s):
        s.flight.install(component="driver")
        try:
            empty = s.flight.local_bundle()["chaos"]
            inj = s.chaos.install(s.chaos.ChaosConfig(seed=4, dup=0.3))
            for _ in range(50):
                inj.decide("head")
            return empty, s.flight.local_bundle()["chaos"], \
                s.chaos.wire_counters()
        finally:
            s.chaos.uninstall()
            s.flight.uninstall()

    out = _twin(case)
    assert out[1][0] == {} and out[1][1] == out[1][2]
    assert out[1][1]["head"]["frames_seen"] == 50


def test_snapshot_is_all_zero_when_chaos_never_ran():
    snap = t_chaos.snapshot()
    assert snap["active"] is False and snap["config"] is None
    assert snap["wire_counters"] == {} and snap["wire_totals"] == {}
    assert set(snap) == set(j_chaos.snapshot())
    assert json.loads(json.dumps(snap)) == snap
