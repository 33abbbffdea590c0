"""Worker process pool: spawn, lease, crash detection, replacement
(counterpart of ``ray_tpu/_private/worker_pool.py``).

Workers are OS processes running ``ray_tpu_torch._private.worker_main``,
spawned by ``subprocess.Popen`` (fork and exec: the driver may own a CUDA
context, which a plain fork must not copy). The driver leases one per
task, ships the task over a shared-memory mutable-object channel of the
native store, and sees a worker's death through process liveness, so a
crashed or ``kill -9``-ed worker fails only its task
(``WorkerCrashedError``), never the driver. Workers spawn lazily, up to
the base size at once and past it (to four times) when every worker is
held, as a task blocked in a nested ``get`` holds its lease.

A worker never reaches the card: it is spawned with
``CUDA_VISIBLE_DEVICES=""``. A task or a process-backed actor that asks
for ``num_gpus`` still holds the driver's GPU resource and still runs
without the card; ``warn_no_card`` logs that once per function or class.
Each worker's stdout and stderr are pumped
into ``worker-<id>-<pid>.out`` / ``.err`` under the session's log
directory, which the log monitor tails back to the driver's stderr.
Values cross in the wire form (``serialization.wire_dumps``). A task
whose runtime env names a pip/uv venv leases from that env's own
sub-pool (``_lease_env``): its workers run under the venv's interpreter,
built at the first lease; idle workers of one sub-pool are evicted when
the other needs the slot.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import queue
import subprocess
import sys
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.log import get_logger
from ray_tpu_torch._private.serialization import (
    require_cloudpickle,
    wire_dumps,
)
from ray_tpu_torch._private.worker_main import _ShmRef
from ray_tpu_torch.exceptions import (
    ChannelError,
    ChannelTimeoutError,
    TaskCancelledError,
    WorkerCrashedError,
    WorkerPoolExhaustedError,
)

log = get_logger(__name__)

_INLINE_LIMIT = 256 * 1024   # args bigger than this ride the shm store

_warned_no_card: set = set()
_warned_lock = threading.Lock()


def warn_no_card(kind: str, name: str, num_gpus: float) -> None:
    """Log, once per ``(kind, name)``, that a process-plane task or
    actor asked for the card and will run in a worker process without
    it: its CUDA tensors arrive there on the CPU. ``runtime="driver"``
    keeps an actor on the card."""
    with _warned_lock:
        if (kind, name) in _warned_no_card:
            return
        _warned_no_card.add((kind, name))
    log.warning(
        "%s %r asks for num_gpus=%s on the process plane: it runs in a "
        "worker process, which never sees the card (its CUDA tensors "
        "arrive there on the CPU). Create an actor with runtime=\"driver\" "
        "for card work.", kind, name, num_gpus)


def _pump_stream(stream, path: str):
    """Copy one worker pipe into its session log file, line by line."""
    try:
        with open(path, "ab", buffering=0) as f:
            for chunk in iter(stream.readline, b""):
                f.write(chunk)
    except Exception as exc:  # noqa: BLE001 — the worker died mid-write
        log.debug("worker log pump for %s stopped: %r", path, exc)


class WorkerProcess:
    """One spawned worker and its request/reply channels."""

    _id_counter = [0]
    _id_lock = threading.Lock()

    def __init__(self, store, max_msg: int = 1 << 20,
                 log_dir: Optional[str] = None,
                 python_exe: Optional[str] = None,
                 env_key: Optional[str] = None):
        from ray_tpu_torch._native.store import NativeMutableChannel

        with WorkerProcess._id_lock:
            WorkerProcess._id_counter[0] += 1
            self.worker_id = WorkerProcess._id_counter[0]
        self._store = store
        self.max_msg = max_msg
        # A pip/uv runtime env's worker runs under its venv's interpreter
        # and returns to that env's sub-pool (env_key).
        self.python_exe = python_exe or sys.executable
        self.env_key = env_key
        # Channel object ids live in a reserved high range, apart from
        # task-return and put keys (which hash whole ObjectIDs).
        base = (0xC0FF_EE00_0000_0000
                | (os.getpid() & 0xFFFF) << 24 | self.worker_id << 4)
        self._req_id = base | 1
        self._rep_id = base | 2
        self._api_req_id = base | 3
        self._api_rep_id = base | 5
        self._ack_id = base | 6
        self._req = NativeMutableChannel(
            store, self._req_id, max_size=max_msg, num_readers=1)
        self._rep = NativeMutableChannel(
            store, self._rep_id, max_size=max_msg, num_readers=1)
        # Streaming acks (driver -> worker) on a small channel of their
        # own, so a watermark never lands where a request is read.
        self._ack = NativeMutableChannel(
            store, self._ack_id, max_size=8192, num_readers=1)
        # The reverse API pair: ray_tpu_torch.* calls made inside the
        # worker go to the driver's service thread (driver_service.py).
        self._api_req = NativeMutableChannel(
            store, self._api_req_id, max_size=max_msg, num_readers=1)
        self._api_rep = NativeMutableChannel(
            store, self._api_rep_id, max_size=max_msg, num_readers=1)
        cmd = [
            self.python_exe, "-m", "ray_tpu_torch._private.worker_main",
            "--store", store.name,
            "--req-id", str(self._req_id),
            "--rep-id", str(self._rep_id),
            "--api-req-id", str(self._api_req_id),
            "--api-rep-id", str(self._api_rep_id),
            "--ack-id", str(self._ack_id),
            "--worker-id", str(self.worker_id),
            "--max-msg", str(max_msg),
        ]
        env = dict(os.environ)
        # Workers never spawn pools of their own (the driver owns the
        # process plane), and they import the modules the driver loaded
        # from locations only its sys.path names.
        env["RAY_TPU_WORKER_MODE"] = "thread"
        # A worker never reaches the card (design decision (a) of the
        # README): no CUDA device is visible to it, whatever its task
        # requested.
        env["CUDA_VISIBLE_DEVICES"] = ""
        # The orphan fence's handshake (worker_main._install_pdeathsig).
        env["RAY_TPU_TORCH_PARENT_PID"] = str(os.getpid())
        extra_path = [p for p in sys.path if p]
        prev = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = os.pathsep.join(
            extra_path + ([prev] if prev else []))
        self.log_files: List[str] = []
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.proc = subprocess.Popen(cmd, env=env,
                                         stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE)
            # Named after the spawn, so the file carries the worker's pid;
            # copy threads drain the pipes into the files.
            for stream, ext in ((self.proc.stdout, "out"),
                                (self.proc.stderr, "err")):
                path = os.path.join(
                    log_dir, f"worker-{self.worker_id}-{self.proc.pid}.{ext}")
                threading.Thread(
                    target=_pump_stream, args=(stream, path), daemon=True,
                    name=f"ray_tpu_torch_logpump_{self.worker_id}_{ext}",
                ).start()
                self.log_files.append(path)
        else:
            self.proc = subprocess.Popen(cmd, env=env)
        self._dead = False
        self._svc_stop = False
        from ray_tpu_torch._private.driver_service import service_loop

        self._svc_thread = threading.Thread(
            target=service_loop, args=(self,), daemon=True,
            name=f"ray_tpu_torch_api_svc_{self.worker_id}")
        self._svc_thread.start()

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return not self._dead and self.proc.poll() is None

    def request(self, msg: Tuple, timeout: Optional[float] = None,
                cancel_event: Optional[threading.Event] = None):
        """Send one request and block for the reply, polling in short
        slices so a dead worker (kill -9) shows within ~200 ms as
        WorkerCrashedError (or TaskCancelledError when the kill was a
        force-cancel)."""
        if not self.alive():
            raise WorkerCrashedError(f"worker {self.pid} is dead")
        try:
            self._req.write(msg, timeout=timeout or 60.0)
        except (ChannelError, ChannelTimeoutError) as e:
            if not self.alive():
                raise WorkerCrashedError(
                    f"worker {self.pid} died before accepting the task"
                ) from e
            raise
        while True:
            try:
                status, value = self._rep.read(timeout=0.2)
                break
            except ChannelTimeoutError:
                if self.proc.poll() is not None:
                    self._dead = True
                    if cancel_event is not None and cancel_event.is_set():
                        raise TaskCancelledError()
                    raise WorkerCrashedError(
                        f"worker {self.pid} died mid-task "
                        f"(exit code {self.proc.returncode})")
        if status == "err":
            raise pickle.loads(value)
        if status == "okshm":
            data = bytes(self._store.get(value))
            self._store.delete(value)
            return data
        return value

    def kill(self):
        self._dead = True
        self._svc_stop = True
        try:
            self.proc.kill()
        except Exception:  # noqa: BLE001 — already gone
            pass

    def _destroy_channels(self):
        # The worker is dead: reclaim the channel arenas in the store.
        for ch in (self._req, self._rep, self._api_req, self._api_rep,
                   self._ack):
            try:
                ch.destroy()
            except Exception:  # noqa: BLE001 — store torn down
                pass

    def shutdown(self, timeout: float = 2.0):
        self._svc_stop = True
        if self.alive():
            try:
                self._req.write(("exit",), timeout=0.5)
                self.proc.wait(timeout=timeout)
            except Exception:  # noqa: BLE001 — force it
                self.kill()
        else:
            self.kill()
        try:
            self.proc.wait(timeout=timeout)
        except Exception:  # noqa: BLE001 — reaped below by the kernel
            pass
        self._svc_thread.join(timeout=1.0)
        self._destroy_channels()


class WorkerPool:
    """Lazily spawned worker processes with lease/release and crash
    replacement."""

    def __init__(self, store, num_workers: int, max_msg: int = 1 << 20,
                 max_workers: Optional[int] = None,
                 log_dir: Optional[str] = None):
        self._store = store
        self._max_msg = max_msg
        self._log_dir = log_dir
        self._lock = threading.Lock()
        self._idle: "queue.Queue[WorkerProcess]" = queue.Queue()
        # Idle workers of each pip/uv runtime env, by env_key.
        self._env_idle: Dict[str, "queue.Queue[WorkerProcess]"] = {}
        self._all: List[WorkerProcess] = []
        self._shutdown = False
        self._spawning = 0   # growth slots reserved, not yet spawned
        self._base_workers = max(int(num_workers), 1)
        # Elastic cap: a worker blocked in a nested get() holds its
        # lease, so the pool grows past the base size rather than
        # deadlocking.
        self._max_workers = max_workers or self._base_workers * 4

    def _try_spawn(self, limit: int, python_exe: Optional[str] = None,
                   env_key: Optional[str] = None
                   ) -> Optional[WorkerProcess]:
        """Reserve a slot under ``limit`` and spawn outside the lock."""
        with self._lock:
            if (self._shutdown
                    or len(self._all) + self._spawning >= limit):
                return None
            self._spawning += 1
        try:
            fresh = WorkerProcess(self._store, max_msg=self._max_msg,
                                  log_dir=self._log_dir,
                                  python_exe=python_exe, env_key=env_key)
        except Exception as exc:  # noqa: BLE001 — e.g. the shm store full
            log.warning("worker spawn failed: %r", exc)
            fresh = None
        with self._lock:
            self._spawning -= 1
            if fresh is not None and not self._shutdown:
                self._all.append(fresh)
                return fresh
        if fresh is not None:   # raced shutdown
            fresh.shutdown(timeout=0.1)
        return None

    def lease(self, timeout: float = 60.0,
              runtime_env=None) -> WorkerProcess:
        env_key = runtime_env.env_key() if runtime_env is not None else None
        if env_key is not None:
            return self._lease_env(runtime_env, env_key, timeout)
        deadline = time.monotonic() + timeout
        while True:
            if self._shutdown:
                # Nothing idle and nothing will spawn: fail now rather
                # than spin out the deadline.
                raise WorkerPoolExhaustedError("worker pool is shut down")
            try:
                w = self._idle.get_nowait()
            except queue.Empty:
                fresh = self._try_spawn(self._base_workers)
                if fresh is not None:
                    return fresh
            else:
                if w.alive():
                    return w
                self._replace(w)
                continue
            try:
                w = self._idle.get(timeout=0.5)
            except queue.Empty:
                fresh = self._try_spawn(self._max_workers)
                if fresh is None and self._evict_idle_env_worker():
                    # At the cap with idle env workers: one makes room,
                    # so neither sub-pool starves behind the other.
                    fresh = self._try_spawn(self._max_workers)
                if fresh is not None:
                    return fresh
                if time.monotonic() >= deadline:
                    raise WorkerPoolExhaustedError(
                        f"no idle worker within {timeout:.0f}s "
                        f"(pool size {self.size}); long-running tasks may "
                        f"be holding every worker") from None
                continue
            if w.alive():
                return w
            self._replace(w)   # crashed while idle

    def _evict_idle_env_worker(self) -> bool:
        with self._lock:
            queues = list(self._env_idle.values())
        for q in queues:
            try:
                w = q.get_nowait()
            except queue.Empty:
                continue
            self._remove_dead(w)
            return True
        return False

    def _lease_env(self, runtime_env, env_key: str,
                   timeout: float) -> WorkerProcess:
        """Lease a worker bound to a pip/uv runtime env. The venv is
        built at the first lease that needs it, before the deadline
        starts (a long first install must not fake pool exhaustion)."""
        with self._lock:
            q = self._env_idle.setdefault(env_key, queue.Queue())
        python_exe = runtime_env.python_executable()
        deadline = time.monotonic() + timeout
        while True:
            if self._shutdown:
                raise WorkerPoolExhaustedError("worker pool is shut down")
            try:
                w = q.get_nowait()
            except queue.Empty:
                fresh = self._try_spawn(self._max_workers,
                                        python_exe=python_exe,
                                        env_key=env_key)
                if fresh is None:
                    # At the cap with idle default workers: evict one,
                    # so env demand does not starve behind them.
                    try:
                        idle_default = self._idle.get_nowait()
                    except queue.Empty:
                        pass
                    else:
                        self._remove_dead(idle_default)
                        fresh = self._try_spawn(self._max_workers,
                                                python_exe=python_exe,
                                                env_key=env_key)
                if fresh is not None:
                    return fresh
                try:
                    w = q.get(timeout=0.5)
                except queue.Empty:
                    if time.monotonic() >= deadline:
                        raise WorkerPoolExhaustedError(
                            f"no idle worker for runtime env {env_key} "
                            f"within {timeout:.0f}s") from None
                    continue
            if w.alive():
                return w
            self._remove_dead(w)

    def _remove_dead(self, dead: WorkerProcess):
        """Drop a worker from the pool without a replacement (env workers
        and evictions respawn on demand)."""
        with self._lock:
            try:
                self._all.remove(dead)
            except ValueError:
                pass
        dead.shutdown(timeout=0.1)

    def release(self, w: WorkerProcess):
        if self._shutdown:
            return
        if not w.alive():
            if w.env_key is not None:
                self._remove_dead(w)
            else:
                self._replace(w)
            return
        if w.env_key is not None:
            with self._lock:
                q = self._env_idle.setdefault(w.env_key, queue.Queue())
            q.put(w)
        else:
            self._idle.put(w)

    def _replace(self, dead: WorkerProcess):
        with self._lock:
            if self._shutdown:
                return
            try:
                self._all.remove(dead)
            except ValueError:
                pass
        dead.shutdown(timeout=0.1)
        fresh = self._try_spawn(self._max_workers)
        if fresh is not None:
            self._idle.put(fresh)

    @property
    def size(self) -> int:
        with self._lock:
            return len(self._all)

    def pids(self) -> List[int]:
        with self._lock:
            return [w.pid for w in self._all]

    def shutdown(self):
        with self._lock:
            self._shutdown = True
            workers = list(self._all)
            self._all.clear()
        # Every exit first, then reap against one shared deadline.
        for w in workers:
            w._svc_stop = True
            if w.alive():
                try:
                    w._req.write(("exit",), timeout=0.05)
                except Exception:  # noqa: BLE001 — force it
                    w.kill()
            else:
                w.kill()
        deadline = time.monotonic() + 1.0
        for w in workers:
            while w.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.01)
            if w.proc.poll() is None:
                w.kill()
                try:
                    w.proc.wait(timeout=1.0)
                except Exception:  # noqa: BLE001
                    pass
            w._svc_thread.join(timeout=0.5)
            w._destroy_channels()


# ---------------------------------------------------------------------------
# Task payload packing (driver side)
# ---------------------------------------------------------------------------

# Keyed by the function OBJECT (weakly): an id()-keyed cache would serve a
# stale entry when CPython reuses the id of a collected function.
_fn_digest_cache: "weakref.WeakKeyDictionary[Any, Tuple[bytes, bytes]]" = (
    weakref.WeakKeyDictionary())
_fn_cache_lock = threading.Lock()


def pack_function(fn) -> Tuple[bytes, bytes]:
    """(digest, fn_bytes), cached per function; workers cache by digest,
    so the bytes cross once per (worker, function)."""
    cloudpickle = require_cloudpickle()
    try:
        with _fn_cache_lock:
            hit = _fn_digest_cache.get(fn)
        if hit is not None:
            return hit
        cacheable = True
    except TypeError:   # unhashable callable
        cacheable = False
    data = cloudpickle.dumps(fn)
    digest = hashlib.sha1(data).digest()
    if cacheable:
        try:
            with _fn_cache_lock:
                _fn_digest_cache[fn] = (digest, data)
        except TypeError:   # not weakref-able: no caching
            pass
    return digest, data


def oid_key(object_id) -> int:
    """Stable u64 key of an ObjectID in the shm store. It hashes the
    WHOLE id (the first 8 bytes are the task prefix that every return of
    a task shares) and clears the top nibble, apart from the reserved
    channel (0xC...) and staging (0xA...) ranges."""
    digest = hashlib.blake2b(object_id.binary(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & 0x0FFF_FFFF_FFFF_FFFF


_stage_counter = [0]
_stage_lock = threading.Lock()


def _next_stage_key() -> int:
    with _stage_lock:
        _stage_counter[0] += 1
        return 0xA4A0_0000_0000_0000 | (_stage_counter[0] & 0xFFFF_FFFF_FFFF)


def maybe_stage(store, data: bytes, limit: int):
    """Inline a small blob; stage a big one in the store. Returns (field,
    staged_keys); the caller deletes the keys after the reply."""
    if len(data) <= limit:
        return data, []
    key = _next_stage_key()
    store.put(key, data)
    return ("shm", key), [key]


def _driver_custom_serializers():
    """The live driver context's registered serializers (None without a
    runtime or a registration)."""
    from ray_tpu_torch._private.worker import try_live_worker

    w = try_live_worker()
    ctx = getattr(w, "serialization_context", None)
    custom = getattr(ctx, "custom_serializers", None)
    return (custom() or None) if custom is not None else None


def pack_args(store, args, kwargs) -> Tuple[bytes, List[int]]:
    """(args, kwargs) in the wire form, through the driver context's
    registered serializers; an argument too big to inline is staged in
    the shm store and replaced by a _ShmRef the worker fetches. Returns
    (payload, staged_keys)."""
    staged: List[int] = []
    custom = _driver_custom_serializers()

    def _pack(v):
        if isinstance(v, _ShmRef):
            return v
        raw = wire_dumps(v, custom)
        if len(raw) <= _INLINE_LIMIT:
            return v
        key = _next_stage_key()
        store.put(key, raw)
        staged.append(key)
        return _ShmRef(key)

    packed_args = tuple(_pack(a) for a in args)
    packed_kwargs = {k: _pack(v) for k, v in kwargs.items()}
    return wire_dumps((packed_args, packed_kwargs), custom), staged
