"""Deterministic, seeded fault injection and a chaos-monkey process
killer (counterpart of ``ray_tpu/_private/chaos.py``).

Two layers:

- **Wire faults** (:class:`ChaosConfig` / :class:`ChaosInjector`):
  ``transport.FramedConnection`` consults one module-level slot
  (``transport._CHAOS``) on every frame send
  (:meth:`ChaosInjector.on_send`). With chaos off the slot is ``None``
  and the send path pays one global load and an ``is None`` branch. With
  chaos on, a frame may be dropped, delayed, duplicated, corrupted (one
  byte flipped, so the receiver's decode fails) or its connection reset
  (closed, with ``ConnectionResetError`` at the sender). Decisions come
  from one seeded ``random.Random``, so a run is reproducible, and
  per-(site, fault) counters record every decision. Sites are the
  connections' labels (``head``, ``peer``, ``object``, ``conn``);
  ``ChaosConfig.sites`` scopes injection to some of them.

- **Process faults** (:class:`NodeKiller` / :class:`ChaosController`):
  a seeded schedule thread that SIGKILLs a random target (a subprocess,
  or whatever pid a callable resolves) at jittered intervals during a
  live workload, recording every kill. ``stop()`` joins the thread
  (bounded). ``worker_kill_target`` SIGKILLs a worker process of the
  process plane's pool, ``popen_kill_target`` a node daemon and
  ``head_kill_target`` the head.

Activation: the ``RAY_TPU_CHAOS`` env var (a JSON object) through
:func:`install_from_env`, or :func:`install` / :func:`uninstall` from a
test or :class:`ChaosController`. Off by default.
"""

from __future__ import annotations

import json
import os
import random
import signal
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "ChaosConfig",
    "ChaosInjector",
    "ChaosController",
    "NodeKiller",
    "KillTarget",
    "install",
    "install_from_env",
    "uninstall",
    "active",
    "wire_counters",
    "snapshot",
    "worker_kill_target",
    "head_kill_target",
]

ENV_VAR = "RAY_TPU_CHAOS"

# Fault kinds the injector can apply to one outbound frame.
FAULTS = ("drop", "delay", "dup", "corrupt", "reset")


@dataclass(frozen=True)
class ChaosConfig:
    """Wire-fault probabilities (per frame send) + determinism seed.

    All probabilities default to 0 — a default config injects nothing
    even when installed. ``sites`` empty means every connection; else
    only connections whose ``site`` label is listed are faulted (the
    handshake itself rides the same frames, so a faulted site may also
    fail to *establish* connections — that is chaos working)."""

    seed: int = 0
    drop: float = 0.0      # frame silently not sent
    delay: float = 0.0     # frame sent after delay_ms
    delay_ms: float = 5.0
    dup: float = 0.0       # frame sent twice
    corrupt: float = 0.0   # one payload byte flipped
    reset: float = 0.0     # connection closed + ConnectionResetError
    sites: Tuple[str, ...] = ()

    @classmethod
    def from_env(cls, raw: Optional[str] = None) -> Optional["ChaosConfig"]:
        """Parse ``RAY_TPU_CHAOS`` (JSON object). ``None``/empty → no
        chaos. Unknown keys are rejected loudly — a typoed fault name
        must not silently run a clean experiment."""
        if raw is None:
            raw = os.environ.get(ENV_VAR, "")
        raw = (raw or "").strip()
        if not raw or raw in ("0", "false", "off"):
            return None
        d = json.loads(raw)
        if not isinstance(d, dict):
            raise ValueError(f"{ENV_VAR} must be a JSON object, got {d!r}")
        known = {"seed", "drop", "delay", "delay_ms", "dup", "corrupt",
                 "reset", "sites"}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown {ENV_VAR} keys {sorted(unknown)}; "
                             f"known: {sorted(known)}")
        if "sites" in d:
            d["sites"] = tuple(d["sites"])
        return cls(**d)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "seed": self.seed, "drop": self.drop, "delay": self.delay,
            "delay_ms": self.delay_ms, "dup": self.dup,
            "corrupt": self.corrupt, "reset": self.reset,
            "sites": list(self.sites),
        }


class ChaosInjector:
    """Applies one :class:`ChaosConfig` to outbound frames.

    Thread-safe; decisions draw from one seeded RNG under a lock, so a
    single-threaded traffic pattern replays bit-identically for the
    same seed, and multi-threaded runs stay reproducible in aggregate.
    Counters are ``{site: {fault: count}}`` plus a ``frames_seen``
    total per site — tests assert exactly what was injected."""

    def __init__(self, config: ChaosConfig):
        self.config = config
        self._rng = random.Random(config.seed)
        self._lock = threading.Lock()
        self.counters: Dict[str, Dict[str, int]] = {}

    # ------------------------------------------------------------- helpers
    def _count(self, site: str, fault: str, n: int = 1):
        per_site = self.counters.setdefault(site, {})
        per_site[fault] = per_site.get(fault, 0) + n

    def _targets(self, site: str) -> bool:
        return not self.config.sites or site in self.config.sites

    def decide(self, site: str) -> Optional[str]:
        """One seeded decision for one frame at ``site`` (also counts
        ``frames_seen``). Returns a fault name or None. Exposed so the
        determinism test can replay the decision stream."""
        cfg = self.config
        with self._lock:
            self._count(site, "frames_seen")
            u = self._rng.random()
            edge = 0.0
            for fault in FAULTS:
                edge += getattr(cfg, fault)
                if u < edge:
                    self._count(site, fault)
                    return fault
        return None

    def on_send(self, conn, payload) -> Optional[list]:
        """Called by the transport for each outbound frame. Returns the
        payloads to write instead (empty: dropped, two: duplicated), or
        None to send the original unchanged. May sleep (delay), or close
        the connection and raise ``ConnectionResetError`` (reset)."""
        site = getattr(conn, "site", "conn")
        if not self._targets(site):
            return None
        fault = self.decide(site)
        if fault is None:
            return None
        if fault == "drop":
            return []
        if fault == "delay":
            time.sleep(self.config.delay_ms / 1e3)
            return None
        if fault == "dup":
            return [payload, payload]
        if fault == "corrupt":
            corrupted = bytearray(payload)
            if corrupted:
                # Flip the high bit at a seeded position: the length
                # stays, so the fault lands in the receiver's decode.
                with self._lock:
                    pos = self._rng.randrange(len(corrupted))
                corrupted[pos] ^= 0x80
            return [bytes(corrupted)]
        # reset: tear the socket down under the peer and fail the sender
        # as a mid-write RST does.
        try:
            conn.close()
        except Exception:  # noqa: BLE001 — the raise below is the fault
            pass
        raise ConnectionResetError(
            f"chaos: injected connection reset at site {site!r}")

    def totals(self) -> Dict[str, int]:
        """Cross-site totals per fault kind (convenient assertions)."""
        out: Dict[str, int] = {}
        with self._lock:
            for per_site in self.counters.values():
                for fault, n in per_site.items():
                    out[fault] = out.get(fault, 0) + n
        return out

    def counters_snapshot(self) -> Dict[str, Dict[str, int]]:
        """Consistent copy of the per-site counters (taken under the
        injection lock — concurrent senders insert new site/fault keys,
        so readers must not iterate the live dicts)."""
        with self._lock:
            return {site: dict(per) for site, per in self.counters.items()}


# ------------------------------------------------------------ installation
# Re-entrant: install() can trigger transport's first import, whose
# bootstrap (RAY_TPU_CHAOS set) calls install_from_env -> install on the
# same thread.
_lock = threading.RLock()


def _transport():
    from ray_tpu_torch._private import transport

    return transport


def install(config: ChaosConfig) -> ChaosInjector:
    """Activate wire-fault injection process-wide. Returns the injector
    (its counters are live). Replaces any previous injector."""
    injector = ChaosInjector(config)
    with _lock:
        _transport()._CHAOS = injector
    return injector


def install_from_env() -> Optional[ChaosInjector]:
    cfg = ChaosConfig.from_env()
    return install(cfg) if cfg is not None else None


def uninstall() -> None:
    with _lock:
        _transport()._CHAOS = None


def active() -> bool:
    return _transport()._CHAOS is not None


def current() -> Optional[ChaosInjector]:
    return _transport()._CHAOS


def wire_counters() -> Dict[str, Dict[str, int]]:
    """Per-site injected-fault counters ({} when chaos is off)."""
    inj = _transport()._CHAOS
    return inj.counters_snapshot() if inj is not None else {}


# -------------------------------------------------------------- NodeKiller
@dataclass
class KillTarget:
    """One killable thing. ``kill()`` performs ONE kill and returns a
    short description (e.g. the pid); raise to record a failed attempt.
    ``once`` targets (a head process) leave the rotation after a
    successful kill."""

    name: str
    kind: str                      # "worker" | "daemon" | "head" | ...
    kill: Callable[[], Any]
    once: bool = False


def worker_kill_target(worker=None, name: str = "worker",
                       seed: int = 0) -> KillTarget:
    """Target that SIGKILLs a random live worker process of the runtime's
    pool (the process plane). The victim pid draws from the target's OWN
    seeded RNG, so a NodeKiller schedule replays for a given (seed, pid
    pool)."""
    rng = random.Random(seed)

    def _kill():
        from ray_tpu_torch._private.worker import global_worker

        w = worker if worker is not None else global_worker()
        pool = getattr(w, "worker_pool", None)
        pids = sorted(p for p in (pool.pids() if pool is not None else [])
                      if p and p != os.getpid())
        if not pids:
            raise RuntimeError("no live worker pids to kill")
        pid = rng.choice(pids)
        os.kill(pid, signal.SIGKILL)
        return {"pid": pid}

    return KillTarget(name=name, kind="worker", kill=_kill)


def popen_kill_target(name: str, proc, kind: str = "daemon",
                      once: bool = True) -> KillTarget:
    """Target that SIGKILLs one subprocess (a node daemon or head
    spawned by a test or a harness). ``once`` by default — a dead
    daemon stays dead unless the harness restarts it."""

    def _kill():
        proc.kill()
        return {"pid": proc.pid}

    return KillTarget(name=name, kind=kind, kill=_kill, once=once)


def head_kill_target(proc, name: str = "head") -> KillTarget:
    """Target that SIGKILLs the head process (the control plane itself).
    ``once``: a dead primary stays dead; the warm standby promotes over
    the shared state log and clients fail over by epoch."""
    return popen_kill_target(name, proc, kind="head", once=True)


def pid_kill_target(name: str, pid_fn: Callable[[], Optional[int]],
                    kind: str = "worker", once: bool = False) -> KillTarget:
    """Target that SIGKILLs whatever pid ``pid_fn`` currently resolves
    to (e.g. a serve replica's ``_runtime.pid`` — re-resolved each kill
    so replacement replicas stay killable)."""

    def _kill():
        pid = pid_fn()
        if not pid or pid == os.getpid():
            raise RuntimeError(f"target {name!r} has no killable pid")
        os.kill(pid, signal.SIGKILL)
        return {"pid": pid}

    return KillTarget(name=name, kind=kind, kill=_kill, once=once)


class NodeKiller:
    """Seeded chaos monkey: kills a random target at jittered intervals.

    ``interval_s`` is a (min, max) uniform range drawn from the seeded
    RNG; the victim is drawn from the same RNG, so a schedule replays
    for a given seed + target list. Every attempt is recorded in
    ``kills`` (monotonic timestamp, target, result or error), which
    ``snapshot()`` and ``util.state.chaos_summary`` report.
    ``max_kills`` bounds the schedule; ``stop()`` sets the stop event and
    joins the thread (bounded)."""

    def __init__(self, targets: Sequence[KillTarget], *, seed: int = 0,
                 interval_s: Tuple[float, float] = (0.5, 2.0),
                 max_kills: Optional[int] = None):
        self.targets = list(targets)
        self.seed = seed
        self.interval_s = interval_s
        self.max_kills = max_kills
        self.kills: List[Dict[str, Any]] = []
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "NodeKiller":
        if self._thread is None or not self._thread.is_alive():
            # Registered for snapshot() on START (a
            # constructed-but-never-run killer is not an experiment);
            # the registry is a bounded deque, so long-lived processes
            # running many experiments don't accumulate forever.
            if self not in _KILLERS:
                _KILLERS.append(self)
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="ray_tpu_node_killer")
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def _loop(self):
        while not self._stop.is_set():
            if self.max_kills is not None and \
                    len([k for k in self.kills if "error" not in k]) \
                    >= self.max_kills:
                return
            lo, hi = self.interval_s
            if self._stop.wait(self._rng.uniform(lo, hi)):
                return
            if not self.targets:
                return
            target = self._rng.choice(self.targets)
            rec: Dict[str, Any] = {
                "t": time.monotonic(), "name": target.name,
                "kind": target.kind,
            }
            try:
                info = target.kill()
                if isinstance(info, dict):
                    rec.update(info)
                if target.once:
                    self.targets = [t for t in self.targets
                                    if t is not target]
            except Exception as exc:  # noqa: BLE001 — recorded, not fatal
                rec["error"] = repr(exc)
            self.kills.append(rec)


# Started killers, most recent last (snapshot() keeps reporting a
# stopped killer's record; bounded so a process running many
# experiments doesn't pin them all).
_KILLERS: "deque[NodeKiller]" = deque(maxlen=32)


class ChaosController:
    """One handle over a chaos experiment: installs the wire-fault
    config on start, runs the NodeKiller schedule, and reports both
    when asked. Context-manager friendly::

        with ChaosController(wire=ChaosConfig(seed=7, delay=0.2),
                             targets=[popen_kill_target("d", proc)],
                             seed=7) as chaos:
            ... drive the workload ...
        report = chaos.report()
    """

    def __init__(self, wire: Optional[ChaosConfig] = None,
                 targets: Sequence[KillTarget] = (), *, seed: int = 0,
                 interval_s: Tuple[float, float] = (0.5, 2.0),
                 max_kills: Optional[int] = None):
        self.wire = wire
        self.injector: Optional[ChaosInjector] = None
        self.killer = NodeKiller(targets, seed=seed, interval_s=interval_s,
                                 max_kills=max_kills) if targets else None

    def start(self) -> "ChaosController":
        if self.wire is not None:
            self.injector = install(self.wire)
        if self.killer is not None:
            self.killer.start()
        return self

    def stop(self):
        if self.killer is not None:
            self.killer.stop()
        if self.injector is not None:
            uninstall()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def report(self) -> Dict[str, Any]:
        return {
            "wire": {
                "config": self.wire.to_dict() if self.wire else None,
                "counters": (self.injector.counters_snapshot()
                             if self.injector else {}),
            },
            "kills": list(self.killer.kills) if self.killer else [],
        }


def snapshot() -> Dict[str, Any]:
    """Process-wide chaos observability: the active wire config +
    per-site injected-fault counters, and every kill recorded by
    killers started in this process. Backs
    ``util.state.chaos_summary`` — always safe to call (all-zero when
    chaos never ran)."""
    inj = current()
    kills = [k for killer in _KILLERS for k in killer.kills]
    return {
        "active": inj is not None,
        "config": inj.config.to_dict() if inj is not None else None,
        "wire_counters": wire_counters(),
        "wire_totals": inj.totals() if inj is not None else {},
        "kills": kills,
        "num_kills": len([k for k in kills if "error" not in k]),
    }
