"""Flight recorder: always-on process observability (counterpart of
``ray_tpu/_private/flight.py``, trimmed to the one-process runtime).

Three pieces, one module:

- **Sampling wall profiler**: a daemon thread walks
  ``sys._current_frames()`` on a jittered interval and aggregates FOLDED
  stacks (``thread;file.py:fn;file.py:fn`` -> count) into a bounded
  table, exportable as collapsed format (flamegraph.pl / speedscope
  paste) or speedscope JSON. Armed by ``RAY_TPU_PROFILE``.
- **Structured event ring**: a bounded deque of ``(ts, kind, data)``
  tuples: state transitions, lock-hold outliers, GC pauses (a
  ``gc.callbacks`` hook). Off = one module-global ``is None`` branch.
- **Watchdogs**: heartbeat gap (``beat()`` feeds it), loop lag (the
  watchdog loop times its own wake overshoot: a whole-process stall
  shows up as lag), lock hold (a lock noted with ``note_lock_acquired``
  and held past the bound: the shape of a deadlock) and a stuck task
  (``note_task_started`` without its finish). On firing they write an
  automatic local dump (all-thread stacks via faulthandler and a frame
  walk, the event ring, a metrics snapshot, registered subsystem
  sections); rate-limited, counted as a framework metrics gauge.

``ray_tpu_torch.debug_dump()`` / ``util.state.cluster_dump()`` write this
process's bundle as a directory-per-incident archive. Nothing moves
until someone asks.

``RAY_TPU_FLIGHT`` arms the recorder (event ring, watchdogs, bundles);
``RAY_TPU_PROFILE`` also arms the sampler (and implies the recorder).
Both are read at ``init()``.

None of the recorder's threads makes a CUDA call: the sampler and the
watchdog walk Python frames and read host counters, and a section
renderer reads host state only, so they can run beside a CUDA graph
capture. A worker process of the process plane, which nothing can
dial, spills a bundle snapshot into ``RAY_TPU_FLIGHT_DIR`` every
``_SPILL_PERIOD_S`` seconds (``spill_once``); the hosting runtime's
``debug_dump`` merges the newest snapshot of each
(``read_spilled_bundles``, ``local_bundle(include_dir=True)``). The
bundle's ``chaos`` entry is
the chaos plane's ``wire_counters()`` (``{}`` with no injector
installed).
"""

from __future__ import annotations

import faulthandler
import gc
import json
import os
import random
import sys
import tempfile
import threading
import time
import traceback
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "FlightRecorder", "install", "install_from_env", "uninstall",
    "recorder", "active", "record_event", "beat", "clear_beat",
    "note_lock_acquired", "note_lock_released", "note_task_started",
    "note_task_finished", "note_watchdog_fire", "add_section",
    "remove_section", "note_artifact", "local_bundle", "auto_dump",
    "set_profiling", "collapsed_stacks", "read_spilled_bundles",
]

ENV_VAR = "RAY_TPU_FLIGHT"
ENV_PROFILE = "RAY_TPU_PROFILE"
# Dump and spill directory; worker processes inherit it.
ENV_DIR = "RAY_TPU_FLIGHT_DIR"
# Marks ENV_DIR as pointed by a runtime (its session directory), so a
# later runtime re-points it; an operator-set ENV_DIR stays.
ENV_DIR_AUTO = "RAY_TPU_FLIGHT_DIR_AUTO"
# Node identity a head-attached runtime gives its worker processes.
ENV_NODE = "RAY_TPU_FLIGHT_NODE"

# Recorder slot: None = off, every hot-path site guards with one global
# load + `is None` branch.
_FLIGHT: Optional["FlightRecorder"] = None

_install_lock = threading.Lock()

# Bound on joining the recorder's threads at uninstall.
_JOIN_TIMEOUT_S = 2.0
# A worker spills a bundle snapshot every _SPILL_PERIOD_S (jittered
# +-20%); a merged dump leaves out snapshots older than _BUNDLE_STALE_S
# (a pooled worker that exited).
_SPILL_PERIOD_S = 5.0
_BUNDLE_STALE_S = 120.0


def _cfg(name: str, default):
    """A config flag, read at each use (tests and operators tune the
    bounds with ``GlobalConfig.set`` without a restart)."""
    from ray_tpu_torch._private.config import GlobalConfig

    return type(default)(GlobalConfig.get(name))


def _truthy(raw: Optional[str]) -> bool:
    raw = (raw or "").strip().lower()
    return bool(raw) and raw not in ("0", "false", "off")


def _log():
    from ray_tpu_torch._private.log import get_logger

    return get_logger("flight")


# ------------------------------------------------------------------ sampler
def _fold_frame(frame) -> List[str]:
    """Root->leaf folded frames for one thread: ``file.py:fn`` parts,
    depth-bounded (a deep recursion must not balloon the keys)."""
    parts: List[str] = []
    depth = 0
    while frame is not None and depth < 64:
        code = frame.f_code
        parts.append(
            f"{os.path.basename(code.co_filename)}:{code.co_name}")
        frame = frame.f_back
        depth += 1
    parts.reverse()
    return parts


class _StackSampler:
    """Jittered-interval wall sampler over ``sys._current_frames()``.

    Aggregates into ``{folded_stack: count}`` bounded at
    ``profile_max_stacks`` distinct stacks (overflow counts into
    ``stacks_dropped``). The jitter (+-50% of the period) keeps the
    sampler from phase-locking onto periodic work."""

    def __init__(self, hz: float, max_stacks: int):
        self.period = 1.0 / max(float(hz), 0.1)
        self.max_stacks = max(int(max_stacks), 16)
        self._agg: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.samples_taken = 0
        self.stacks_dropped = 0
        self._running = threading.Event()
        self._running.set()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ray_tpu_flight_sampler")
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(
                self.period * random.uniform(0.5, 1.5)):
            if self._running.is_set():
                try:
                    self.sample_once()
                except Exception as exc:  # the sampler must not die
                    _log().debug("stack sample failed: %r", exc)

    def sample_once(self) -> int:
        """One sweep over every live thread's current frame (the
        sampler's own thread excluded). Returns threads sampled."""
        skip = {threading.get_ident(), self._thread.ident}
        names = {t.ident: t.name for t in threading.enumerate()}
        n = 0
        for tid, frame in sys._current_frames().items():
            if tid in skip:
                continue
            folded = ";".join(
                [names.get(tid, f"tid-{tid}")] + _fold_frame(frame))
            with self._lock:
                if folded in self._agg:
                    self._agg[folded] += 1
                elif len(self._agg) < self.max_stacks:
                    self._agg[folded] = 1
                else:
                    self.stacks_dropped += 1
            n += 1
        self.samples_taken += 1
        return n

    def set_running(self, on: bool):
        (self._running.set if on else self._running.clear)()

    @property
    def running(self) -> bool:
        return self._running.is_set()

    def collapsed(self) -> List[str]:
        """Brendan Gregg's collapsed format: ``stack count`` lines,
        hottest first."""
        with self._lock:
            items = sorted(self._agg.items(), key=lambda kv: -kv[1])
        return [f"{stack} {count}" for stack, count in items]

    def speedscope(self, name: str = "ray_tpu_torch") -> dict:
        """Minimal speedscope 'sampled' profile document."""
        with self._lock:
            items = list(self._agg.items())
        frames: List[dict] = []
        index: Dict[str, int] = {}
        samples, weights = [], []
        for stack, count in items:
            idxs = []
            for part in stack.split(";"):
                if part not in index:
                    index[part] = len(frames)
                    frames.append({"name": part})
                idxs.append(index[part])
            samples.append(idxs)
            weights.append(count)
        return {
            "$schema": "https://www.speedscope.app/file-format-schema.json",
            "shared": {"frames": frames},
            "profiles": [{
                "type": "sampled", "name": name, "unit": "none",
                "startValue": 0, "endValue": max(sum(weights), 1),
                "samples": samples, "weights": weights,
            }],
        }

    def stop(self, timeout: float = _JOIN_TIMEOUT_S):
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout)


# ----------------------------------------------------------------- recorder
class FlightRecorder:
    """Per-process flight-recorder state: event ring, optional sampler,
    watchdogs, section providers and bundle assembly."""

    def __init__(self, component: str = "driver", node: str = "",
                 profile: bool = False, spill: bool = False,
                 event_capacity: Optional[int] = None):
        self.component = component
        self.node = node
        self.pid = os.getpid()
        cap = event_capacity if event_capacity is not None \
            else _cfg("flight_event_capacity", 4096)
        self._events: "deque[tuple]" = deque(maxlen=max(int(cap), 16))
        # Re-entrant: a collection can start on any allocation, also one
        # made while this lock is held, and the GC hook then records its
        # pause on the same thread (a plain lock would deadlock there).
        self._ev_lock = threading.RLock()
        self.events_recorded = 0
        # Lock-hold plane: in-flight holds for the deadlock scan.
        self._holds: Dict[tuple, tuple] = {}  # (tid, name) -> (t0, mono0)
        self._hold_lock = threading.Lock()
        self.lock_hold_outliers = 0
        # Heartbeat plane: name -> last-beat monotonic; _beat_fired keeps
        # one fire per gap episode (reset when beats resume).
        self._beats: Dict[str, float] = {}
        self._beat_fired: Dict[str, bool] = {}
        self._beat_lock = threading.Lock()
        # In-flight task plane (executor and actor threads mark a task's
        # start and finish): tid -> [name, mono0, fired] for the
        # task-stuck watchdog.
        self._tasks: Dict[int, list] = {}
        self._task_lock = threading.Lock()
        # Watchdog escalation state.
        self.watchdog_fires = 0
        self.watchdog_last: "deque[tuple]" = deque(maxlen=32)
        self._dump_lock = threading.Lock()
        self._last_dump_mono = 0.0
        # Registered subsystem sections (runtime depths, LLM engines,
        # Serve deployments) rendered at dump time.
        self._sections: Dict[str, Callable[[], Any]] = {}
        self._sections_lock = threading.Lock()
        # Device traces captured this session (util.profiling logdirs).
        self._artifacts: List[str] = []
        # Where auto dumps land ('' = <tmp>/ray_tpu_torch_flight).
        self.dump_dir = os.environ.get(ENV_DIR) or _cfg("flight_dir", "")
        self.sampler: Optional[_StackSampler] = None
        if profile:
            self.sampler = _StackSampler(
                _cfg("profile_hz", 19.0),
                _cfg("profile_max_stacks", 2048))
        # GC-pause hook: a pause past flight_gc_ms becomes an event.
        self._gc_t0: Optional[float] = None
        self._gc_min_s = _cfg("flight_gc_ms", 20.0) / 1000.0
        gc.callbacks.append(self._on_gc)
        self._stop = threading.Event()
        # Watchdog loop: one thread checks every condition; its own wake
        # overshoot IS the loop-lag probe.
        self._wd_period = max(_cfg("flight_watchdog_period_s", 1.0), 0.05)
        self._wd_thread = threading.Thread(
            target=self._watchdog_loop, daemon=True,
            name="ray_tpu_flight_watchdog")
        self._wd_thread.start()
        # Worker-process spill: a bundle snapshot lands in the dump dir
        # every period, the first at once (a short-lived worker still
        # leaves one).
        self._spill_path: Optional[str] = None
        self._spill_records = 0
        self._spill_cap = max(int(_cfg("flight_spill_max_records", 8)), 1)
        self._spill_thread = None
        if spill and self.dump_dir:
            try:
                os.makedirs(self.dump_dir, exist_ok=True)
                self._spill_path = os.path.join(
                    self.dump_dir,
                    f"bundle-{self.pid}-{uuid.uuid4().hex[:8]}.jsonl")
            except OSError:
                self._spill_path = None
            if self._spill_path:
                self._spill_thread = threading.Thread(
                    target=self._spill_loop, daemon=True,
                    name="ray_tpu_flight_spill")
                self._spill_thread.start()

    # ------------------------------------------------------------ identity
    def set_identity(self, component: Optional[str] = None,
                     node: Optional[str] = None):
        if component is not None:
            self.component = component
        if node is not None:
            self.node = node

    # -------------------------------------------------------------- events
    def record(self, kind: str, data: Optional[dict] = None) -> None:
        with self._ev_lock:
            self._events.append((time.time(), kind, data))
            self.events_recorded += 1

    def events(self) -> List[dict]:
        with self._ev_lock:
            recs = list(self._events)
        return [{"ts": float(ts), "kind": kind,
                 "data": {str(k): _jsonable(v)
                          for k, v in (data or {}).items()}}
                for ts, kind, data in recs]

    def _on_gc(self, phase: str, info: dict):
        if phase == "start":
            self._gc_t0 = time.monotonic()
        elif phase == "stop" and self._gc_t0 is not None:
            dur = time.monotonic() - self._gc_t0
            self._gc_t0 = None
            if dur >= self._gc_min_s:
                self.record("gc.pause", {
                    "ms": round(dur * 1000.0, 3),
                    "generation": info.get("generation"),
                    "collected": info.get("collected")})

    # ---------------------------------------------------------- lock plane
    def note_lock_acquired(self, name: str) -> None:
        with self._hold_lock:
            self._holds[(threading.get_ident(), name)] = (
                time.time(), time.monotonic())

    def note_lock_released(self, name: str) -> None:
        key = (threading.get_ident(), name)
        with self._hold_lock:
            entry = self._holds.pop(key, None)
        if entry is None:
            return
        held_s = time.monotonic() - entry[1]
        if held_s * 1000.0 >= _cfg("flight_lock_hold_ms", 50.0):
            self.lock_hold_outliers += 1
            self.record("lock.hold", {"lock": name,
                                      "ms": round(held_s * 1000.0, 3)})

    # ------------------------------------------------------ heartbeat plane
    def beat(self, name: str) -> None:
        with self._beat_lock:
            self._beats[name] = time.monotonic()
            self._beat_fired[name] = False

    def clear_beat(self, name: str) -> None:
        """Retire a heartbeat feed (its loop is shutting down cleanly):
        a retired name never gap-fires."""
        with self._beat_lock:
            self._beats.pop(name, None)
            self._beat_fired.pop(name, None)

    # ----------------------------------------------------------- task plane
    def note_task_started(self, name: str) -> None:
        with self._task_lock:
            self._tasks[threading.get_ident()] = [
                str(name), time.monotonic(), False]

    def note_task_finished(self) -> None:
        with self._task_lock:
            self._tasks.pop(threading.get_ident(), None)

    # ------------------------------------------------------- watchdog loop
    def _watchdog_loop(self):
        while True:
            # Bounds re-read each tick: GlobalConfig.set tunes them live.
            lag_bound = _cfg("flight_loop_lag_s", 2.0)
            gap_bound = _cfg("flight_heartbeat_gap_s", 30.0)
            hold_bound = _cfg("flight_lock_watchdog_s", 10.0)
            t0 = time.monotonic()
            if self._stop.wait(self._wd_period):
                return
            lag = time.monotonic() - t0 - self._wd_period
            try:
                # Loop lag: this thread asked to sleep period seconds;
                # waking `lag` late means no thread was scheduled
                # promptly, the whole-process stall shape.
                if lag > lag_bound:
                    self._fire("loop-lag",
                               f"watchdog wake {lag:.2f}s late "
                               f"(bound {lag_bound}s): process-wide "
                               f"scheduling stall")
                now = time.monotonic()
                with self._beat_lock:
                    gaps = [(n, now - last)
                            for n, last in self._beats.items()
                            if now - last > gap_bound
                            and not self._beat_fired.get(n)]
                    for n, _ in gaps:
                        self._beat_fired[n] = True
                for n, gap in gaps:
                    self._fire("heartbeat-gap",
                               f"{n!r} last beat {gap:.1f}s ago "
                               f"(bound {gap_bound}s)")
                # Task-stuck: an executing task past the bound, one fire
                # per task episode; diagnostics only, never a kill.
                stuck_bound = _cfg("flight_task_stuck_s", 300.0)
                with self._task_lock:
                    hung = []
                    for entry in self._tasks.values():
                        if (not entry[2]
                                and now - entry[1] > stuck_bound):
                            entry[2] = True
                            hung.append((entry[0], now - entry[1]))
                for tname, dur in hung:
                    self._fire("task-stuck",
                               f"task {tname!r} executing for "
                               f"{dur:.1f}s (bound {stuck_bound}s): "
                               f"hung task or runaway loop")
                with self._hold_lock:
                    stuck = [(name, now - mono0)
                             for (_tid, name), (_t0, mono0)
                             in self._holds.items()
                             if now - mono0 > hold_bound]
                for name, held in stuck:
                    # One fire per episode: drop the entry, as a truly
                    # deadlocked lock's release never pops it.
                    with self._hold_lock:
                        for key in [k for k in self._holds
                                    if k[1] == name]:
                            self._holds.pop(key, None)
                    self._fire("lock-hold",
                               f"lock {name!r} held {held:.1f}s (bound "
                               f"{hold_bound}s): deadlock or a lock held "
                               f"across blocking work")
            except Exception as exc:  # the watchdog must not die
                _log().warning("watchdog check failed: %r", exc)

    def _fire(self, kind: str, message: str):
        self.watchdog_fires += 1
        self.watchdog_last.append((time.time(), kind, message))
        self.record(f"watchdog.{kind}", {"message": message})
        _log().error("watchdog %s fired: %s; capturing a local dump",
                     kind, message)
        self.auto_dump(kind)

    # ------------------------------------------------------------- bundles
    def stacks(self) -> Dict[str, List[str]]:
        """Structured all-thread stacks now (the JSON twin of the
        faulthandler text dump)."""
        names = {t.ident: t.name for t in threading.enumerate()}
        out: Dict[str, List[str]] = {}
        for tid, frame in sys._current_frames().items():
            rendered = [
                f"{fs.filename}:{fs.lineno} {fs.name}"
                for fs in traceback.extract_stack(frame)]
            out[f"{names.get(tid, 'tid')}-{tid}"] = rendered
        return out

    def local_bundle(self, include_dir: bool = False) -> dict:
        """This process's flight bundle: identity, all-thread stacks,
        event ring, profile aggregate, metrics snapshot, watchdog state,
        device-trace artifacts and registered subsystem sections."""
        bundle: Dict[str, Any] = {
            "ts": time.time(),
            "pid": self.pid,
            "component": self.component,
            "node": self.node,
            "argv": list(sys.argv),
            "stacks": self.stacks(),
            "events": self.events(),
            "events_recorded": self.events_recorded,
            "watchdog_fires": self.watchdog_fires,
            "watchdog_last": [
                {"ts": ts, "kind": k, "message": m}
                for ts, k, m in list(self.watchdog_last)],
            "lock_hold_outliers": self.lock_hold_outliers,
            "artifacts": list(self._artifacts),
        }
        now = time.monotonic()
        with self._task_lock:
            bundle["tasks_in_flight"] = [
                {"name": name, "running_s": round(now - mono0, 3)}
                for name, mono0, _fired in self._tasks.values()]
        s = self.sampler
        bundle["profile"] = {
            "armed": s is not None,
            "running": bool(s and s.running),
            "samples_taken": s.samples_taken if s else 0,
            "stacks_dropped": s.stacks_dropped if s else 0,
            "collapsed": s.collapsed() if s else [],
        }
        from ray_tpu_torch.util.metrics import export_prometheus

        bundle["metrics"] = export_prometheus()
        from ray_tpu_torch._private.chaos import wire_counters

        bundle["chaos"] = wire_counters()
        # Span-ring tail (tracing armed): the last slice of what this
        # process was doing request-wise, bounded.
        from ray_tpu_torch._private import tracing

        t = tracing.tracer()
        if t is not None:
            bundle["spans_recorded"] = t.spans_recorded
            bundle["span_tail"] = t.dump(include_dir=False)[-256:]
        else:
            bundle["spans_recorded"] = 0
            bundle["span_tail"] = []
        bundle["sections"] = self._render_sections()
        if self.dump_dir:
            try:
                bundle["incidents"] = sorted(
                    f for f in os.listdir(self.dump_dir)
                    if f.startswith("incident-"))
            except OSError:
                bundle["incidents"] = []
        if include_dir:
            bundle["workers"] = read_spilled_bundles(
                self.dump_dir, exclude_pid=self.pid)
        return bundle

    def _render_sections(self, timeout_s: float = 2.0) -> Dict[str, Any]:
        """Render each registered section in its OWN bounded daemon
        thread: providers take subsystem locks, and when a dump fires
        BECAUSE one of those locks is wedged, a synchronous call would
        hang the watchdog thread instead of dumping. A section that does
        not answer in time reports itself blocked."""
        with self._sections_lock:
            providers = dict(self._sections)
        results: Dict[str, Any] = {}
        threads = []
        for name, fn in providers.items():
            def render(name=name, fn=fn):
                try:
                    results[name] = _jsonable(fn())
                except Exception as exc:  # noqa: BLE001 — one section
                    results[name] = {"error": repr(exc)}

            t = threading.Thread(
                target=render, daemon=True,
                name=f"ray_tpu_flight_section_{name}")
            t.start()
            threads.append((name, t))
        deadline = time.monotonic() + timeout_s
        for name, t in threads:
            t.join(max(deadline - time.monotonic(), 0.0))
            if t.is_alive() and name not in results:
                results[name] = {
                    "error": f"section {name!r} blocked for "
                             f">{timeout_s}s (lock wedged?)"}
        return results

    def add_section(self, name: str, fn: Callable[[], Any]) -> None:
        with self._sections_lock:
            self._sections[name] = fn

    def remove_section(self, name: str) -> None:
        with self._sections_lock:
            self._sections.pop(name, None)

    def note_artifact(self, path: str) -> None:
        if path and path not in self._artifacts:
            self._artifacts.append(path)

    # ---------------------------------------------------------- auto dump
    def auto_dump(self, reason: str) -> Optional[str]:
        """Write this process's bundle to the dump dir now (the
        watchdogs' escalation). Rate-limited. Returns the incident path
        (None when rate-limited or the dir is unwritable)."""
        with self._dump_lock:
            now = time.monotonic()
            if (self._last_dump_mono and now - self._last_dump_mono
                    < _cfg("flight_dump_min_interval_s", 5.0)):
                return None
            self._last_dump_mono = now
        dump_dir = self.dump_dir or os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch_flight")
        stamp = time.strftime("%Y%m%d-%H%M%S")
        base = os.path.join(
            dump_dir, f"incident-{stamp}-{reason}-{self.pid}")
        try:
            os.makedirs(dump_dir, exist_ok=True)
            # faulthandler first: if bundle assembly itself wedges or
            # raises, the raw stacks are already on disk.
            with open(base + ".stacks.txt", "w") as f:
                faulthandler.dump_traceback(file=f, all_threads=True)
            with open(base + ".json", "w") as f:
                json.dump(self.local_bundle(), f)
        except OSError:
            return None
        return base + ".json"

    # -------------------------------------------------------------- spill
    def _spill_loop(self):
        period = _SPILL_PERIOD_S
        self.spill_once()
        while not self._stop.wait(period * random.uniform(0.8, 1.2)):
            self.spill_once()

    def spill_once(self) -> None:
        """Append one bundle snapshot line to this worker's spill file,
        restarted at the newest window past ``flight_spill_max_records``
        lines."""
        if not self._spill_path:
            return
        try:
            line = json.dumps(self.local_bundle()) + "\n"
            mode = "a"
            if self._spill_records >= self._spill_cap:
                mode = "w"
                self._spill_records = 0
            with open(self._spill_path, mode) as f:
                f.write(line)
            self._spill_records += 1
        except (OSError, ValueError):
            self._spill_path = None  # disk gone: ring-only from here

    # --------------------------------------------------------------- stop
    def stop(self, timeout: float = _JOIN_TIMEOUT_S):
        """Stop and join the watchdog, the spill loop and the sampler,
        unhook GC."""
        self._stop.set()
        if self.sampler is not None:
            self.sampler.stop(timeout)
        try:
            gc.callbacks.remove(self._on_gc)
        except ValueError:
            pass
        for t in (self._wd_thread, self._spill_thread):
            if t is not None and t is not threading.current_thread():
                t.join(timeout)


def _jsonable(v):
    """Best-effort JSON-serializable projection (sections return
    arbitrary subsystem dicts; a stray object must not kill a dump)."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, bytes):
        return v.hex()
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_jsonable(x) for x in v]
    return repr(v)


def read_spilled_bundles(spill_dir: Optional[str],
                         exclude_pid: Optional[int] = None,
                         stale_s: Optional[float] = None) -> List[dict]:
    """The newest bundle snapshot of each spill file under
    ``spill_dir``, skipping files this process wrote and snapshots older
    than ``stale_s`` (default ``_BUNDLE_STALE_S``: a pooled worker
    that exited must not pass for a live one)."""
    if not spill_dir:
        return []
    if stale_s is None:
        stale_s = _BUNDLE_STALE_S
    prefix_self = f"bundle-{exclude_pid}-" if exclude_pid else None
    try:
        names = sorted(os.listdir(spill_dir))
    except OSError:
        return []
    out: List[dict] = []
    now = time.time()
    for name in names:
        if not name.startswith("bundle-") or not name.endswith(".jsonl"):
            continue
        if prefix_self and name.startswith(prefix_self):
            continue
        last = None
        try:
            with open(os.path.join(spill_dir, name)) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        last = line
        except OSError:
            continue
        if not last:
            continue
        try:
            bundle = json.loads(last)
        except ValueError:
            continue  # racing writer mid-line / rotation
        if now - float(bundle.get("ts", 0.0)) > stale_s:
            continue
        out.append(bundle)
    return out


# ------------------------------------------------------------ installation
def install(component: str = "driver", node: str = "",
            profile: bool = False, spill: bool = False,
            event_capacity: Optional[int] = None) -> FlightRecorder:
    """Arm the flight recorder process-wide (idempotent: a second install
    re-labels the existing recorder, and adds a sampler if
    ``profile=True`` arrived late)."""
    global _FLIGHT
    with _install_lock:
        if _FLIGHT is not None:
            _FLIGHT.set_identity(component=component, node=node or None)
            if profile and _FLIGHT.sampler is None:
                _FLIGHT.sampler = _StackSampler(
                    _cfg("profile_hz", 19.0),
                    _cfg("profile_max_stacks", 2048))
            return _FLIGHT
        _FLIGHT = FlightRecorder(
            component=component, node=node, profile=profile, spill=spill,
            event_capacity=event_capacity)
        return _FLIGHT


def install_from_env(component: str = "driver", spill: bool = False
                     ) -> Optional[FlightRecorder]:
    """Arm iff ``RAY_TPU_FLIGHT`` or ``RAY_TPU_PROFILE`` is truthy
    (profiling implies the recorder); None otherwise."""
    armed = _truthy(os.environ.get(ENV_VAR))
    profiled = _truthy(os.environ.get(ENV_PROFILE))
    if not (armed or profiled):
        return None
    return install(component=component, profile=profiled, spill=spill,
                   node=os.environ.get(ENV_NODE, ""))


def uninstall() -> None:
    """Disarm, and stop and join the recorder's threads."""
    global _FLIGHT
    with _install_lock:
        rec, _FLIGHT = _FLIGHT, None
    if rec is not None:
        rec.stop()


def recorder() -> Optional[FlightRecorder]:
    return _FLIGHT


def active() -> bool:
    return _FLIGHT is not None


# ----------------------------------------------------- module-level facade
# Every site below is the one-global-load + `is None` branch.
def record_event(kind: str, **data) -> None:
    r = _FLIGHT
    if r is None:
        return
    r.record(kind, data or None)


def beat(name: str) -> None:
    r = _FLIGHT
    if r is None:
        return
    r.beat(name)


def clear_beat(name: str) -> None:
    r = _FLIGHT
    if r is None:
        return
    r.clear_beat(name)


def note_lock_acquired(name: str) -> None:
    r = _FLIGHT
    if r is None:
        return
    r.note_lock_acquired(name)


def note_lock_released(name: str) -> None:
    r = _FLIGHT
    if r is None:
        return
    r.note_lock_released(name)


def note_task_started(name: str) -> None:
    r = _FLIGHT
    if r is None:
        return
    r.note_task_started(name)


def note_task_finished() -> None:
    r = _FLIGHT
    if r is None:
        return
    r.note_task_finished()


def note_watchdog_fire(kind: str, message: str) -> None:
    """External watchdogs escalate through here: counted, ringed and
    auto-dumped like the built-ins."""
    r = _FLIGHT
    if r is None:
        return
    r._fire(kind, message)


def add_section(name: str, fn: Callable[[], Any]) -> None:
    r = _FLIGHT
    if r is None:
        return
    r.add_section(name, fn)


def remove_section(name: str) -> None:
    r = _FLIGHT
    if r is None:
        return
    r.remove_section(name)


def note_artifact(path: str) -> None:
    r = _FLIGHT
    if r is None:
        return
    r.note_artifact(path)


def local_bundle(include_dir: bool = False) -> Optional[dict]:
    r = _FLIGHT
    if r is None:
        return None
    return r.local_bundle(include_dir=include_dir)


def auto_dump(reason: str) -> Optional[str]:
    r = _FLIGHT
    if r is None:
        return None
    return r.auto_dump(reason)


def set_profiling(on: bool) -> bool:
    """Pause or resume the sampler. Returns the new running state."""
    r = _FLIGHT
    if r is None or r.sampler is None:
        return False
    r.sampler.set_running(bool(on))
    return r.sampler.running


def collapsed_stacks() -> List[str]:
    r = _FLIGHT
    if r is None or r.sampler is None:
        return []
    return r.sampler.collapsed()
