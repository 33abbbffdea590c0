"""Twins of the flight recorder: the reference
(``ray_tpu._private.flight``) beside the port
(``ray_tpu_torch._private.flight``), in one process, from
``tests/test_flight.py`` without its spill and cross-process parts.

The units run once per implementation: disarmed inertness, folded stacks
of a known synthetic stack, the sampler's bounds, the event ring and the
GC hook, lock-hold outliers, and the lock-hold, heartbeat-gap and
task-stuck watchdogs firing once an episode (the lock plane is fed with
``note_lock_acquired`` directly: the reference's tracked locks live in
``util/sanitizer.py``, not ported). The bundle twins compare the key set
of a bundle and of ``cluster_dump``'s manifest, with both runtimes up;
``profile_trace`` on the CPU registers its logdir as an artifact.

Every recorder is uninstalled (its threads joined) and every config
override reset by a fixture; every wait is bounded.
"""

import json
import os
import threading
import time

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu._private import flight as ref_flight
from ray_tpu._private.config import GlobalConfig as RefConfig
from ray_tpu_torch._private import flight as port_flight
from ray_tpu_torch._private.config import GlobalConfig as PortConfig

T = 30.0

SIDES = {"reference": (ref_flight, RefConfig),
         "port": (port_flight, PortConfig)}


@pytest.fixture(autouse=True)
def _clean_flight():
    for fl, cfg in SIDES.values():
        fl.uninstall()
        cfg.reset()
    yield
    for fl, cfg in SIDES.values():
        fl.uninstall()
        cfg.reset()


def _wait_for(cond, bound=5.0):
    deadline = time.monotonic() + bound
    while time.monotonic() < deadline and not cond():
        time.sleep(0.02)
    return cond()


# ---------------------------------------------------------------- units
@pytest.mark.parametrize("side", list(SIDES))
def test_disarmed_is_inert(side, monkeypatch):
    fl, _ = SIDES[side]
    monkeypatch.delenv(fl.ENV_VAR, raising=False)
    monkeypatch.delenv(fl.ENV_PROFILE, raising=False)
    assert fl.install_from_env() is None
    assert not fl.active() and fl.recorder() is None
    fl.record_event("x", a=1)
    fl.beat("hb")
    fl.note_lock_acquired("l")
    fl.note_lock_released("l")
    fl.note_task_started("t")
    fl.note_task_finished()
    fl.note_watchdog_fire("k", "m")
    fl.add_section("s", lambda: {})
    fl.note_artifact("/nowhere")
    assert fl.local_bundle() is None
    assert fl.auto_dump("r") is None
    assert fl.set_profiling(True) is False
    assert fl.collapsed_stacks() == []
    assert not [t for t in threading.enumerate()
                if t.name.startswith("ray_tpu_flight")]


@pytest.mark.parametrize("side", list(SIDES))
def test_disarmed_records_nothing(side):
    fl, _ = SIDES[side]
    for _ in range(100):
        fl.record_event("never")
    rec = fl.install(component="late")
    assert rec.events_recorded == 0
    assert rec.sampler is None
    assert rec.local_bundle()["profile"]["samples_taken"] == 0


def test_install_from_env_and_uninstall_joins_threads(monkeypatch):
    monkeypatch.delenv(port_flight.ENV_VAR, raising=False)
    monkeypatch.setenv(port_flight.ENV_PROFILE, "1")
    rec = port_flight.install_from_env()
    assert rec is not None and rec.sampler is not None
    threads = [rec._wd_thread, rec.sampler._thread]
    assert all(t.is_alive() for t in threads)
    port_flight.uninstall()
    assert not any(t.is_alive() for t in threads)
    assert port_flight.recorder() is None


def _leaf_park(stop: threading.Event):
    stop.wait(30)


def _mid_hop(stop):
    _leaf_park(stop)


def _outer_entry(stop):
    _mid_hop(stop)


@pytest.mark.parametrize("side", list(SIDES))
def test_folded_stack_matches_synthetic_stack(side):
    fl, _ = SIDES[side]
    rec = fl.install(component="t", profile=True)
    rec.sampler.set_running(False)   # sample by hand only
    stop = threading.Event()
    t = threading.Thread(target=_outer_entry, args=(stop,),
                         name="synthetic_stack", daemon=True)
    t.start()
    time.sleep(0.05)
    try:
        rec.sampler.sample_once()
        syn = [ln for ln in rec.sampler.collapsed()
               if ln.startswith("synthetic_stack;")]
        assert syn
        stack, count = syn[0].rsplit(" ", 1)
        assert int(count) >= 1
        here = os.path.basename(__file__)
        i_outer = stack.find(f"{here}:_outer_entry")
        i_mid = stack.find(f"{here}:_mid_hop")
        i_leaf = stack.find(f"{here}:_leaf_park")
        assert 0 < i_outer < i_mid < i_leaf, stack
        doc = rec.sampler.speedscope()
        names = {f["name"] for f in doc["shared"]["frames"]}
        assert f"{here}:_leaf_park" in names
        assert doc["profiles"][0]["type"] == "sampled"
        assert len(doc["profiles"][0]["samples"]) == \
            len(doc["profiles"][0]["weights"])
    finally:
        stop.set()
        t.join(5)


@pytest.mark.parametrize("side", list(SIDES))
def test_sampler_excludes_itself_and_bounds_distinct_stacks(side):
    fl, _ = SIDES[side]
    rec = fl.install(component="t", profile=True)
    s = rec.sampler
    s.set_running(False)
    s.sample_once()
    assert not any("ray_tpu_flight_sampler" in ln for ln in s.collapsed())
    with s._lock:
        s._agg.clear()
        for i in range(s.max_stacks):
            s._agg[f"synthetic;stack{i}"] = 1
    before = len(s._agg)
    s.sample_once()
    assert len(s._agg) == before
    assert s.stacks_dropped >= 1
    assert fl.set_profiling(True) is True
    assert fl.set_profiling(False) is False


@pytest.mark.parametrize("side", list(SIDES))
def test_event_ring_is_bounded(side):
    fl, _ = SIDES[side]
    rec = fl.install(component="t", event_capacity=32)
    for i in range(100):
        fl.record_event("e", i=i)
    assert rec.events_recorded >= 100
    assert len(rec.events()) <= 32


def test_gc_hook_records_pauses_and_reenters_the_ring_lock():
    """Port only: with a 0 ms bound every collection lands in the ring; a
    collection that starts while the ring's lock is held (any allocation
    under it) records on the same thread without deadlocking, which the
    reference's plain lock would (so its side is not run with a 0 ms
    bound here); uninstall unhooks it."""
    import gc

    rec = port_flight.install(component="t")
    rec._gc_min_s = 0.0
    gc.collect()
    assert "gc.pause" in [e["kind"] for e in rec.events()]

    def collect_under_the_lock():
        with rec._ev_lock:
            rec._on_gc("start", {})
            rec._on_gc("stop", {"generation": 2, "collected": 0})

    t = threading.Thread(target=collect_under_the_lock, daemon=True)
    t.start()
    t.join(T)
    assert not t.is_alive()
    assert rec.events()[-1]["data"]["generation"] == 2
    port_flight.uninstall()
    assert rec._on_gc not in gc.callbacks


@pytest.mark.parametrize("side", list(SIDES))
def test_lock_hold_outlier_event(side):
    fl, cfg = SIDES[side]
    rec = fl.install(component="t")
    cfg.set("flight_lock_hold_ms", 1.0)
    fl.note_lock_acquired("outlier_lock")
    time.sleep(0.01)
    fl.note_lock_released("outlier_lock")
    fl.note_lock_acquired("quick_lock")
    cfg.set("flight_lock_hold_ms", 10_000.0)
    fl.note_lock_released("quick_lock")
    assert rec.lock_hold_outliers == 1
    ev = [e for e in rec.events() if e["kind"] == "lock.hold"]
    assert [e["data"]["lock"] for e in ev] == ["outlier_lock"]


def _fast_watchdog(cfg):
    """A 50 ms watchdog tick with no dump rate limit; the loop-lag bound
    out of reach, so a loaded machine's late wake-up adds no fire to the
    count a test asserts."""
    cfg.set("flight_watchdog_period_s", 0.05)
    cfg.set("flight_dump_min_interval_s", 0.0)
    cfg.set("flight_loop_lag_s", 3600.0)


def _incidents(path):
    return sorted(f for f in os.listdir(path)
                  if f.startswith("incident-") and f.endswith(".json"))


@pytest.mark.parametrize("side", list(SIDES))
def test_lock_hold_watchdog_fires_once_an_episode(side, tmp_path):
    """A lock noted as held past the bound fires the watchdog exactly
    once for the episode and writes one auto dump whose stacks show the
    holder."""
    fl, cfg = SIDES[side]
    _fast_watchdog(cfg)
    cfg.set("flight_lock_watchdog_s", 0.2)
    rec = fl.install(component="t")
    rec.dump_dir = str(tmp_path)
    held, release = threading.Event(), threading.Event()

    def holder():
        fl.note_lock_acquired("wedged_lock")
        held.set()
        release.wait(T)
        fl.note_lock_released("wedged_lock")

    t = threading.Thread(target=holder, name="lock_holder", daemon=True)
    t.start()
    try:
        assert held.wait(T)
        assert _wait_for(lambda: _incidents(tmp_path))
        time.sleep(0.4)   # more watchdog ticks: no second fire
    finally:
        release.set()
        t.join(T)
    assert rec.watchdog_fires == 1
    assert [k for _, k, _ in rec.watchdog_last] == ["lock-hold"]
    (name,) = _incidents(tmp_path)
    bundle = json.loads((tmp_path / name).read_text())
    assert any(k.startswith("lock_holder") for k in bundle["stacks"])
    assert any(f.endswith(".stacks.txt") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("side", list(SIDES))
def test_heartbeat_gap_watchdog_one_fire_per_episode(side, tmp_path):
    fl, cfg = SIDES[side]
    _fast_watchdog(cfg)
    cfg.set("flight_heartbeat_gap_s", 0.2)
    rec = fl.install(component="t")
    rec.dump_dir = str(tmp_path)
    fl.beat("hb")
    assert _wait_for(lambda: rec.watchdog_fires >= 1)
    time.sleep(0.4)
    assert rec.watchdog_fires == 1
    fl.beat("hb")   # resuming beats re-arms
    assert _wait_for(lambda: rec.watchdog_fires >= 2)
    fl.clear_beat("hb")   # a retired feed never fires again
    time.sleep(0.4)
    assert rec.watchdog_fires == 2


@pytest.mark.parametrize("side", list(SIDES))
def test_task_stuck_watchdog(side, tmp_path):
    fl, cfg = SIDES[side]
    _fast_watchdog(cfg)
    cfg.set("flight_task_stuck_s", 0.2)
    rec = fl.install(component="t")
    rec.dump_dir = str(tmp_path)
    fl.note_task_started("wedged_task")
    assert _wait_for(lambda: rec.watchdog_fires >= 1)
    time.sleep(0.3)
    assert rec.watchdog_fires == 1
    assert any(k == "task-stuck" and "wedged_task" in m
               for _, k, m in rec.watchdog_last)
    fl.note_task_finished()
    assert rec.local_bundle()["tasks_in_flight"] == []


def test_auto_dump_is_rate_limited(tmp_path):
    port_flight.install(component="t").dump_dir = str(tmp_path)
    PortConfig.set("flight_dump_min_interval_s", 60.0)
    assert port_flight.auto_dump("first").endswith(".json")
    assert port_flight.auto_dump("second") is None
    assert len(_incidents(tmp_path)) == 1


def test_a_wedged_section_reports_itself_blocked():
    rec = port_flight.install(component="t")
    gate = threading.Event()
    rec.add_section("wedged", lambda: gate.wait(T))
    rec.add_section("fine", lambda: {"x": (1, 2), "b": b"\x01"})
    rec.add_section("raises", lambda: 1 / 0)
    try:
        sections = rec._render_sections(timeout_s=0.2)
    finally:
        gate.set()
    assert "blocked" in sections["wedged"]["error"]
    assert sections["fine"] == {"x": [1, 2], "b": "01"}
    assert "ZeroDivisionError" in sections["raises"]["error"]
    rec.remove_section("wedged")
    assert "wedged" not in rec._render_sections(timeout_s=0.2)


# -------------------------------------------------------- bundle twins
@pytest.fixture
def armed_runtimes(tmp_path):
    """Both recorders armed before their runtimes start (so each
    registers its runtime section), each dumping under tmp_path."""
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    for side, (fl, _) in SIDES.items():
        fl.install(component="driver").dump_dir = str(tmp_path / side)
    ray_tpu.init(num_cpus=2, worker_mode="thread", ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2)
    try:
        yield tmp_path
    finally:
        ray_tpu.shutdown()
        ray_tpu_torch.shutdown()


def _tasks(rt):
    @rt.remote
    def f(x):
        return x

    return rt.get([f.remote(i) for i in range(4)], timeout=T)


def test_bundle_keys_match_the_reference(armed_runtimes):
    assert _tasks(ray_tpu_torch) == _tasks(ray_tpu)
    bundles = {side: fl.local_bundle()
               for side, (fl, _) in SIDES.items()}
    assert set(bundles["port"]) == set(bundles["reference"])
    assert "runtime" in bundles["port"]["sections"]
    assert set(bundles["port"]["sections"]) == \
        set(bundles["reference"]["sections"])
    assert set(bundles["port"]["sections"]["runtime"]) >= {
        "backlog", "running", "finished", "store_objects",
        "resources_available"}
    assert bundles["port"]["chaos"] == {}
    assert bundles["port"]["component"] == "driver"
    assert bundles["port"]["incidents"] == []


def test_cluster_dump_manifest_matches_the_reference(armed_runtimes):
    from ray_tpu.util.state import cluster_dump as ref_dump
    from ray_tpu_torch.util.state import cluster_dump as port_dump

    out = {}
    for side, dump in (("reference", ref_dump), ("port", port_dump)):
        incident = dump(str(armed_runtimes / f"dumps-{side}"))
        manifest = json.loads(
            open(os.path.join(incident, "manifest.json")).read())
        driver = json.loads(
            open(os.path.join(incident, "driver.json")).read())
        out[side] = (sorted(os.listdir(incident)), sorted(manifest),
                     sorted(manifest["sources"]),
                     sorted(manifest["sources"]["driver"]),
                     manifest["num_processes"], sorted(driver))
    assert out["port"] == out["reference"]
    assert out["port"][0] == ["driver.json", "manifest.json"]


def test_debug_dump_disarmed_writes_an_empty_manifest(tmp_path):
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2)
    try:
        incident = ray_tpu_torch.debug_dump(str(tmp_path))
    finally:
        ray_tpu_torch.shutdown()
    assert os.listdir(incident) == ["manifest.json"]
    manifest = json.loads(open(os.path.join(incident,
                                            "manifest.json")).read())
    assert manifest["sources"] == {} and manifest["num_processes"] == 0


def test_profile_trace_notes_its_logdir_as_an_artifact(tmp_path):
    import torch

    from ray_tpu_torch.util import profiling

    rec = port_flight.install(component="t")
    logdir = tmp_path / "trace"
    with profiling.profile_trace(str(logdir), device="cpu"):
        torch.ones(4).sum()
    assert rec.local_bundle()["artifacts"] == [os.path.abspath(logdir)]
    port_flight.uninstall()
    with profiling.profile_trace(str(tmp_path / "off"), device="cpu"):
        torch.ones(4).sum()   # disarmed: nothing to note, no error
