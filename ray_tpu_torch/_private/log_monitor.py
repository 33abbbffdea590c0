"""Worker log aggregation (counterpart of
``ray_tpu/_private/log_monitor.py``).

Worker processes write their stdout and stderr to per-worker files under
``<session_dir>/logs`` (``worker-<id>-<pid>.out`` / ``.err``, pumped by
``WorkerPool``); one driver thread tails the directory and re-emits new
lines to the driver's stderr as ``(worker=<id> pid=<pid>) line``, so a
``print()`` inside any task or process-backed actor shows up at the
driver. ``init(worker_mode="process")`` creates the session directory
(under the temporary directory, ``ray_tpu_torch/session_<hex>``).
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, TextIO


class LogMonitor:
    """Tail every ``*.out``/``*.err`` file in a directory, streaming new
    lines (prefixed with the producing worker's identity) to a sink."""

    def __init__(self, log_dir: str, sink: TextIO = None,
                 poll_s: float = 0.15):
        self.log_dir = log_dir
        self._sink = sink
        self._poll_s = poll_s
        self._offsets: Dict[str, int] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ray_tpu_torch_log_monitor")
        self._thread.start()

    def _emit(self, fname: str, line: str):
        # worker-<id>-<pid>.out -> "(worker <id> pid=<pid>)" prefix.
        base = fname.rsplit(".", 1)[0]
        parts = base.split("-")
        tag = base
        if len(parts) >= 3 and parts[0] == "worker":
            tag = f"worker={parts[1]} pid={parts[2]}"
        sink = self._sink if self._sink is not None else sys.stderr
        try:
            sink.write(f"({tag}) {line}\n")
            sink.flush()
        except Exception:  # noqa: BLE001 — sink gone at teardown
            pass

    def poll_once(self):
        """One tail pass (also used directly by tests)."""
        try:
            names = sorted(os.listdir(self.log_dir))
        except OSError:
            return
        for fname in names:
            if not (fname.endswith(".out") or fname.endswith(".err")):
                continue
            path = os.path.join(self.log_dir, fname)
            try:
                size = os.path.getsize(path)
                offset = self._offsets.get(fname, 0)
                if size <= offset:
                    continue
                # Binary mode: offsets stay in TRUE file bytes. Decoding
                # with errors='replace' first would turn each invalid
                # byte (1 on disk) into U+FFFD (3 re-encoded), inflating
                # the offset and silently skipping later log content.
                with open(path, "rb") as f:
                    f.seek(offset)
                    chunk = f.read()
                # Only complete lines; partial tails re-read next pass.
                end = chunk.rfind(b"\n")
                if end < 0:
                    continue
                self._offsets[fname] = offset + end + 1
                for raw in chunk[:end].split(b"\n"):
                    if raw:
                        self._emit(fname,
                                   raw.decode("utf-8", errors="replace"))
            except OSError:
                continue

    def _loop(self):
        while not self._stop.wait(self._poll_s):
            self.poll_once()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
        self.poll_once()  # final drain


def list_log_files(log_dir: str):
    try:
        return sorted(
            f for f in os.listdir(log_dir)
            if f.endswith(".out") or f.endswith(".err"))
    except OSError:
        return []


def latest_session_dir(base: str = None) -> str:
    """The most recent session directory."""
    import tempfile

    base = base or os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    link = os.path.join(base, "session_latest")
    if os.path.islink(link) or os.path.isdir(link):
        return os.path.realpath(link)
    sessions = sorted(
        (d for d in os.listdir(base) if d.startswith("session_")),
        key=lambda d: os.path.getmtime(os.path.join(base, d)))
    if not sessions:
        raise FileNotFoundError(f"no ray_tpu_torch sessions under {base}")
    return os.path.join(base, sessions[-1])
