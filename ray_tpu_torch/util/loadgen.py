"""Traffic-shape DSL + seeded load generator (copy of
``ray_tpu/util/loadgen.py``, standard library only): elasticity and
overload scenarios as DRIVEN, replayable artifacts, like the chaos
schedules in ``util.chaos``.

A *shape* is a piecewise rate function ``rate_at(t) -> requests/sec``
built from phases::

    from ray_tpu_torch.util import loadgen

    shape = (loadgen.Ramp(0.5, 8.0, 10.0)       # ramp 0.5 -> 8 rps
             >> loadgen.Spike(12.0, 3.0)         # 3 s spike at 12 rps
             >> loadgen.Ramp(8.0, 0.5, 6.0))     # fall back down

    sched = shape.schedule(seed=7)               # [t0, t1, ...] seconds
    gen = loadgen.LoadGenerator(shape, fire=send_one, seed=7)
    outcomes = gen.run()                         # blocking episode

Schedules are SEEDED and REPLAYABLE: ``schedule(seed)`` is a pure
function of (shape, seed) — the same pair always yields the identical
arrival-time list (thinning over a seeded ``random.Random``), so an
episode that exposed a bug replays exactly, the same contract the
chaos plane's kill schedules and wire-fault decision streams keep.

``LoadGenerator`` dispatches ``fire(i, t)`` at each arrival on a
bounded thread pool, records per-request (start, latency, outcome),
and never lets a slow request stall the arrival clock (open-loop load:
arrivals keep their schedule even while earlier requests run — the
overload-honest shape, unlike closed-loop drivers whose arrival rate
collapses with latency).
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = [
    "Phase", "Step", "Ramp", "Spike", "Diurnal", "TrafficShape",
    "LoadGenerator",
]


class Phase:
    """One piece of a traffic shape: a rate function over a bounded
    local time window ``[0, duration_s)``."""

    duration_s: float = 0.0

    def rate_at(self, t: float) -> float:  # local time within the phase
        raise NotImplementedError

    def peak_rate(self) -> float:
        raise NotImplementedError

    # Composition: ``a >> b`` plays b after a (TrafficShape flattens).
    def __rshift__(self, other: "Phase") -> "TrafficShape":
        return TrafficShape([self]) >> other

    # A single phase IS a (one-phase) shape: schedule/describe promote.
    def schedule(self, seed: int = 0) -> List[float]:
        return TrafficShape([self]).schedule(seed)

    def describe(self) -> List[Dict[str, Any]]:
        return TrafficShape([self]).describe()


@dataclass
class Step(Phase):
    """Constant ``rps`` for ``duration_s``."""

    rps: float
    duration_s: float

    def rate_at(self, t: float) -> float:
        return float(self.rps)

    def peak_rate(self) -> float:
        return float(self.rps)


@dataclass
class Ramp(Phase):
    """Linear ramp ``start_rps -> end_rps`` over ``duration_s``."""

    start_rps: float
    end_rps: float
    duration_s: float

    def rate_at(self, t: float) -> float:
        if self.duration_s <= 0:
            return float(self.end_rps)
        frac = min(max(t / self.duration_s, 0.0), 1.0)
        return float(self.start_rps) + \
            (float(self.end_rps) - float(self.start_rps)) * frac

    def peak_rate(self) -> float:
        return max(float(self.start_rps), float(self.end_rps))


@dataclass
class Spike(Phase):
    """Short plateau at ``peak_rps`` — the flash-crowd phase."""

    peak_rps: float
    duration_s: float

    def rate_at(self, t: float) -> float:
        return float(self.peak_rps)

    def peak_rate(self) -> float:
        return float(self.peak_rps)


@dataclass
class Diurnal(Phase):
    """Sinusoidal day/night cycle: rate swings ``base_rps ±
    amplitude_rps`` over ``period_s``, for ``cycles`` periods (the
    compressed-time diurnal shape autoscaler papers test against).
    Rates floor at 0 when the amplitude exceeds the base."""

    base_rps: float
    amplitude_rps: float
    period_s: float
    cycles: int = 1
    duration_s: float = field(init=False, default=0.0)

    def __post_init__(self):
        self.duration_s = float(self.period_s) * int(self.cycles)

    def rate_at(self, t: float) -> float:
        import math

        phase = 2.0 * math.pi * (t / float(self.period_s))
        return max(0.0, float(self.base_rps)
                   + float(self.amplitude_rps) * math.sin(phase))

    def peak_rate(self) -> float:
        return float(self.base_rps) + abs(float(self.amplitude_rps))


class TrafficShape(Phase):
    """Ordered phase composition; itself a Phase, so shapes nest."""

    def __init__(self, phases: Sequence[Phase]):
        self.phases: List[Phase] = []
        for p in phases:
            if isinstance(p, TrafficShape):
                self.phases.extend(p.phases)
            else:
                self.phases.append(p)
        self.duration_s = sum(p.duration_s for p in self.phases)

    def __rshift__(self, other: Phase) -> "TrafficShape":
        return TrafficShape(self.phases + [other])

    def rate_at(self, t: float) -> float:
        if t < 0:
            return 0.0
        for p in self.phases:
            if t < p.duration_s:
                return p.rate_at(t)
            t -= p.duration_s
        return 0.0

    def peak_rate(self) -> float:
        return max((p.peak_rate() for p in self.phases), default=0.0)

    def schedule(self, seed: int = 0) -> List[float]:
        """Arrival times (seconds from episode start) for one episode:
        an inhomogeneous Poisson process sampled by THINNING against
        the shape's peak rate, over a dedicated seeded RNG — pure in
        (shape, seed), so a schedule replays exactly."""
        rng = random.Random(seed)
        peak = self.peak_rate()
        if peak <= 0 or self.duration_s <= 0:
            return []
        out: List[float] = []
        t = 0.0
        while True:
            # Candidate gap from the homogeneous peak-rate process...
            t += rng.expovariate(peak)
            if t >= self.duration_s:
                return out
            # ...thinned by the instantaneous rate ratio.
            if rng.random() * peak <= self.rate_at(t):
                out.append(t)

    def describe(self) -> List[Dict[str, Any]]:
        """Replayable phase spec (JSON-safe) for bench artifacts."""
        out = []
        for p in self.phases:
            d = {"kind": type(p).__name__}
            d.update({k: v for k, v in vars(p).items()
                      if isinstance(v, (int, float))})
            out.append(d)
        return out


@dataclass
class RequestRecord:
    """One fired request's outcome, appended by the generator."""

    index: int
    scheduled_t: float      # seconds from episode start (schedule time)
    started_t: float        # actual dispatch time (lag = started - sched)
    latency_s: Optional[float] = None
    outcome: str = "pending"   # ok | error:<Type> | pending
    value: Any = None


class LoadGenerator:
    """Open-loop driver for one episode of a shape.

    ``fire(i, t)`` is invoked once per scheduled arrival on a bounded
    worker pool; its return value (or raised exception) is recorded.
    The arrival clock never waits for ``fire`` — a saturated pool
    records growing dispatch lag instead of silently reshaping the
    traffic (``max_lag_s`` in ``summary()`` discloses it).
    """

    def __init__(self, shape: TrafficShape,
                 fire: Callable[[int, float], Any], *,
                 seed: int = 0, max_concurrency: int = 64,
                 schedule: Optional[List[float]] = None):
        self.shape = shape
        self.fire = fire
        self.seed = seed
        self.max_concurrency = max(1, int(max_concurrency))
        self.schedule = (list(schedule) if schedule is not None
                         else shape.schedule(seed))
        self.records: List[RequestRecord] = [
            RequestRecord(i, t, 0.0) for i, t in enumerate(self.schedule)]
        self._stop = threading.Event()

    def _fire_one(self, rec: RequestRecord, t_start: float):
        # Dispatch lag is measured at WORKER start: a saturated pool
        # shows up as lag (disclosed), never as a reshaped schedule.
        rec.started_t = time.perf_counter() - t_start
        try:
            t0 = time.perf_counter()
            rec.value = self.fire(rec.index, rec.scheduled_t)
            rec.latency_s = time.perf_counter() - t0
            rec.outcome = "ok"
        except BaseException as exc:  # noqa: BLE001 — outcome is data
            rec.latency_s = time.perf_counter() - t0
            rec.outcome = f"error:{type(exc).__name__}"
            rec.value = exc

    def run(self, timeout_s: Optional[float] = None) -> List[RequestRecord]:
        """Play the schedule (blocking); returns the records."""
        from concurrent.futures import ThreadPoolExecutor

        t_start = time.perf_counter()
        futures = []
        pool = ThreadPoolExecutor(
            max_workers=self.max_concurrency,
            thread_name_prefix="ray_tpu_loadgen")
        try:
            for rec in self.records:
                if self._stop.is_set():
                    rec.outcome = "skipped"
                    continue
                delay = rec.scheduled_t - (time.perf_counter() - t_start)
                if delay > 0 and self._stop.wait(delay):
                    rec.outcome = "skipped"
                    continue
                futures.append(
                    (rec, pool.submit(self._fire_one, rec, t_start)))
            deadline = None if timeout_s is None else \
                time.monotonic() + timeout_s
            for _, f in futures:
                remaining = None if deadline is None else \
                    max(0.0, deadline - time.monotonic())
                try:
                    f.result(remaining)
                except Exception:  # noqa: BLE001 — recorded per-request
                    pass
        finally:
            # Not waiting: a fire() still running past ``timeout_s`` must
            # not hold run() (its ray_tpu_loadgen thread ends with it).
            pool.shutdown(wait=False, cancel_futures=True)
        for rec, f in futures:
            if f.cancelled():
                rec.outcome = "skipped"  # never started
        return self.records

    def stop(self):
        self._stop.set()

    def summary(self) -> Dict[str, Any]:
        done = [r for r in self.records if r.latency_s is not None]
        lats = sorted(r.latency_s for r in done)
        ok = sum(1 for r in done if r.outcome == "ok")

        def pct(p: float) -> float:
            if not lats:
                return 0.0
            return lats[min(len(lats) - 1, int(len(lats) * p))]

        return {
            "scheduled": len(self.records),
            "fired": len(done),
            "ok": ok,
            "errors": len(done) - ok,
            "p50_latency_s": pct(0.50),
            "p99_latency_s": pct(0.99),
            "max_lag_s": max((r.started_t - r.scheduled_t
                              for r in self.records if r.latency_s
                              is not None), default=0.0),
        }
