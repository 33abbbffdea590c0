"""Memory monitor and task OOM killer (counterpart of
``ray_tpu/_private/memory_monitor.py``).

A driver thread samples system memory; when the used fraction crosses the
threshold (``memory_monitor_threshold``) it kills the worker process
running the MOST RECENTLY started process task (the reference's
youngest-first policy: the youngest task has the least sunk work). The
killed task fails with ``OutOfMemoryError``, retriable like the other
system failures, so transient pressure retries instead of crashing the
job. Only process tasks are candidates: the thread plane has no process
to kill, and card memory is not what this watches.
"""

from __future__ import annotations

import os
import threading

from ray_tpu_torch._private.log import get_logger

log = get_logger(__name__)


def _read_meminfo() -> dict:
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                parts = line.split()
                out[parts[0].rstrip(":")] = int(parts[1]) * 1024
    except OSError:
        pass
    return out


def system_memory_usage_fraction() -> float:
    """Used fraction of system memory (cgroup-unaware simple reading)."""
    info = _read_meminfo()
    total = info.get("MemTotal")
    avail = info.get("MemAvailable")
    if not total or avail is None:
        return 0.0
    return 1.0 - avail / total


def process_rss_bytes(pid: int) -> int:
    try:
        with open(f"/proc/{pid}/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, IndexError, ValueError):
        return 0


class MemoryMonitor:
    """Poll memory pressure; kill the youngest running process task's
    worker when above the threshold."""

    def __init__(self, scheduler, threshold_fraction: float = 0.95,
                 min_worker_rss_bytes: int = 64 << 20,
                 poll_s: float = 0.25):
        self._scheduler = scheduler
        self.threshold = threshold_fraction
        self.min_worker_rss = min_worker_rss_bytes
        self._poll_s = poll_s
        self._stop = threading.Event()
        self.num_kills = 0
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ray_tpu_torch_memory_monitor")
        self._thread.start()

    def _loop(self):
        while not self._stop.wait(self._poll_s):
            try:
                if system_memory_usage_fraction() >= self.threshold:
                    self._kill_one()
            except Exception as exc:  # monitor must not die
                log.warning("memory-monitor sweep failed; retrying next "
                            "period: %r", exc)

    def _pick_victim(self):
        """Youngest running process task whose worker is actually using
        memory (don't kill an idle-RSS worker; pressure is elsewhere)."""
        sched = self._scheduler
        with sched._lock:
            running = list(sched._proc_running.items())  # insertion order
        for task_id, proc in reversed(running):
            if proc.alive() and (
                    process_rss_bytes(proc.pid) >= self.min_worker_rss):
                return task_id, proc
        if running:  # all small: still relieve pressure, youngest first
            return running[-1]
        return None

    def _kill_one(self):
        victim = self._pick_victim()
        if victim is None:
            return
        task_id, proc = victim
        # Mark the failure kind BEFORE the kill so the executor reports
        # OutOfMemoryError instead of a generic worker crash.
        self._scheduler._oom_killed.add(task_id)
        proc.kill()
        self.num_kills += 1

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
