"""Typed config/flag registry with environment-variable override (copy of
``ray_tpu/_private/config.py``, trimmed to the flags the one-process
runtime reads).

Every knob is declared once with a type and default, overridable by a
``RAY_TPU_<NAME>`` environment variable or a ``_system_config`` dict
passed to ``init()``. ``worker_mode`` picks the execution plane; its
default, ``"thread"``, is the one flag whose default differs from the
reference's (``"process"``): the port's card paths run CUDA work inside
tasks and actors, and a worker process never reaches the card.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict

_ENV_PREFIX = "RAY_TPU_"


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


_PARSERS: Dict[type, Callable[[str], Any]] = {
    bool: _parse_bool,
    int: int,
    float: float,
    str: str,
    dict: json.loads,
    list: json.loads,
}


@dataclass
class _Flag:
    name: str
    type: type
    default: Any
    doc: str = ""


class ConfigRegistry:
    """Declare-once flag registry; values resolve env > override > default."""

    def __init__(self):
        self._flags: Dict[str, _Flag] = {}
        self._overrides: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def declare(self, name: str, type_: type, default: Any, doc: str = ""):
        with self._lock:
            if name in self._flags:
                raise ValueError(f"flag {name!r} declared twice")
            self._flags[name] = _Flag(name, type_, default, doc)

    def get(self, name: str) -> Any:
        flag = self._flags[name]
        env_val = os.environ.get(_ENV_PREFIX + name.upper())
        if env_val is not None:
            return _PARSERS[flag.type](env_val)
        with self._lock:
            if name in self._overrides:
                return self._overrides[name]
        return flag.default

    def set(self, name: str, value: Any):
        flag = self._flags[name]
        if not isinstance(value, flag.type):
            value = _PARSERS[flag.type](str(value))
        with self._lock:
            self._overrides[name] = value

    def reset(self):
        """Drop every override (test boundaries)."""
        with self._lock:
            self._overrides.clear()

    def apply_system_config(self, system_config: Dict[str, Any]):
        for k, v in (system_config or {}).items():
            if k not in self._flags:
                raise ValueError(f"unknown system config flag {k!r}")
            self.set(k, v)

    def __getattr__(self, name: str) -> Any:
        # Attribute-style access for declared flags.
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self.get(name)
        except KeyError:
            raise AttributeError(name) from None


GlobalConfig = ConfigRegistry()

_D = GlobalConfig.declare
_D("task_max_retries", int, 3, "Default max retries for retriable tasks.")
_D("actor_max_restarts", int, 0, "Default max actor restarts.")
_D("worker_pool_size", int, 0,
   "Threads executing tasks (0 = max(num_cpus, 4)).")
_D("generator_backpressure_items", int, 0,
   "Consumer-driven backpressure for num_returns='streaming' generator "
   "tasks: the producer's yield loop pauses while this many committed "
   "items remain unconsumed, resuming on consumption "
   "(RAY_TPU_GENERATOR_BACKPRESSURE_ITEMS; 0 = unlimited).")
_D("log_level", str, "warning",
   "Threshold for the ray_tpu_torch logger hierarchy (debug/info/warning/"
   "error).")
_D("serve_wake_timeout_s", float, 30.0,
   "Scale-to-zero wake bound: a request arriving at a deployment with "
   "zero replicas queues while the controller scales it back up, and "
   "fails typed only past this many seconds.")
_D("channel_read_timeout_s", float, 60.0,
   "Default bound on a compiled-DAG channel read or write.")
_D("llm_kv_publish_ttl_s", float, 30.0,
   "Disaggregated serving publish TTL: a prefill replica's exported KV "
   "blocks (held for a decode replica's pull) free automatically this "
   "many seconds after publication if never acked, so a crashed or "
   "rerouted decode side can never leak prefill-pool blocks.")
_D("llm_disagg_pull_timeout_s", float, 10.0,
   "Disaggregated serving pull bound: how long a decode replica waits "
   "for a published KV payload before abandoning the graft and "
   "re-prefilling locally (typed fallback, not a hang).")
_D("llm_disagg_prefill_timeout_s", float, 30.0,
   "Disaggregated serving prefill RPC bound: how long the pairing layer "
   "waits for a prefill replica's ticket before falling back to the "
   "colocated path on the decode pool.")
_D("task_events_max_buffer", int, 100_000,
   "Ring-buffer capacity for task state events (state API/timeline).")
_D("trace_max_spans", int, 65536,
   "Per-process span ring capacity of the tracing plane (RAY_TPU_TRACE "
   "arms tracing at init(); off = zero spans, no payload keys).")
_D("trace_cold_start_window_s", float, 180.0,
   "How long a context parked in the cold-start stash (a Serve wake) "
   "stays adoptable: a replica constructed inside the window parents "
   "its replica.init span to it; past it, a later unrelated replica "
   "start is not attributed to a finished trace.")
_D("profile_hz", float, 19.0,
   "Flight-recorder stack sampler frequency (RAY_TPU_PROFILE arms the "
   "sampler; the interval is jittered +-50% so periodic work is not "
   "phase-locked out of the profile).")
_D("profile_max_stacks", int, 2048,
   "Bound on DISTINCT folded stacks the sampler aggregates; overflow "
   "counts into stacks_dropped instead of growing memory.")
_D("flight_event_capacity", int, 4096,
   "Per-process flight-recorder event ring capacity (state "
   "transitions, lock-hold outliers, GC pauses).")
_D("flight_dir", str, "",
   "Directory for the watchdogs' auto dumps and the default root of "
   "debug_dump() archives ('' = a ray_tpu_torch directory under the "
   "temporary directory).")
_D("flight_gc_ms", float, 20.0,
   "GC pauses at or above this many milliseconds become gc.pause "
   "events in the flight ring (gc.callbacks hook).")
_D("flight_lock_hold_ms", float, 50.0,
   "Noted lock hold time above which the release records a lock.hold "
   "outlier event in the flight ring.")
_D("flight_lock_watchdog_s", float, 10.0,
   "Noted lock hold time above which the lock-hold watchdog fires an "
   "automatic local dump (the shape of a deadlock or of a lock held "
   "across blocking work).")
_D("flight_heartbeat_gap_s", float, 30.0,
   "Gap since the last flight.beat() above which the heartbeat-gap "
   "watchdog fires an automatic local dump (one fire per gap episode; "
   "beats resuming re-arm it).")
_D("flight_loop_lag_s", float, 2.0,
   "Watchdog-loop wake overshoot above which the loop-lag watchdog "
   "fires: no thread scheduled for this long is a process-wide stall.")
_D("flight_watchdog_period_s", float, 1.0,
   "Flight watchdog check period (also the loop-lag probe's expected "
   "sleep).")
_D("flight_dump_min_interval_s", float, 5.0,
   "Rate limit between watchdog auto dumps: a flapping watchdog must "
   "not fill the disk with incident files.")
_D("workflow_storage", str, "",
   "Default workflow storage root ('' = ~/.ray_tpu_torch/workflows; a "
   "local path or a registered scheme such as memory://).")
_D("flight_task_stuck_s", float, 300.0,
   "An executing task or actor call past this bound fires the "
   "task-stuck watchdog (diagnostics only, never a kill; one fire per "
   "task).")
_D("worker_mode", str, "thread",
   "Task execution plane: 'thread' (executor threads in the driver, the "
   "port's default: tasks and actors reach the card) or 'process' "
   "(worker processes over the native shm store, the reference's "
   "default; a worker never reaches the card). RAY_TPU_WORKER_MODE.")
_D("shm_store_bytes", int, 256 * 1024 * 1024,
   "Shared-memory segment size of the process plane's native object "
   "store.")
_D("shm_store_slots", int, 4096,
   "Max concurrent objects in the native shared-memory store.")
_D("worker_channel_bytes", int, 1024 * 1024,
   "Request/reply channel buffer size per worker process (its channels "
   "live in the shm store; larger blobs are staged as shm objects).")
_D("memory_monitor_threshold", float, 0.95,
   "System memory-used fraction above which the monitor kills the "
   "youngest running process task (OutOfMemoryError, retriable). "
   "0 disables the monitor.")
_D("object_store_memory_bytes", int, 512 * 1024 * 1024,
   "Host bytes the driver's object store holds before it spills sealed "
   "host payloads to disk (device tensors neither spill nor count).")
# The cluster's control plane (the head service, its client, the
# transport and the object server).
_D("dep_wait_s", float, 300.0,
   "Bound on waiting for an object another driver has not announced "
   "yet (get() with no timeout); GetTimeoutError past it "
   "(RAY_TPU_DEP_WAIT_S).")
_D("head_client_timeout_s", float, 5.0,
   "Heartbeat silence after which the head marks a client dead and "
   "collects its named actors and objects.")
_D("head_log_compact_records", int, 50000,
   "Compact the head's append-only state log once it holds this many "
   "records (snapshot + truncate; 0 disables compaction).")
_D("head_addresses", str, "",
   "Comma-separated head addresses, primary first then standbys "
   "(RAY_TPU_HEAD_ADDRESSES), merged into every HeadClient's dial "
   "list.")
_D("runtime_env_cache", str, "",
   "Directory for built runtime-env (pip/uv) environments "
   "('' = ~/.cache/ray_tpu_torch/runtime_envs).")
_D("coordinator_address", str, "",
   "Multi-process device-plane coordinator address for "
   "parallel.distributed.initialize ('' = single-process mesh).")
_D("autoscaler_launch_retries", int, 3,
   "Provider node launches retry up to this many times (jittered "
   "exponential backoff) before the autoscaler surfaces a typed "
   "NodeLaunchFailedError instead of silent membership absence.")
_D("autoscaler_launch_backoff_s", float, 0.5,
   "Base backoff between node-launch attempts (doubled per attempt, "
   "jittered x0.5-1.5 so concurrent launch storms spread).")
_D("autoscaler_launch_grace_s", float, 60.0,
   "Grace window for a LAUNCHING node: the bound on reading its joined "
   "line, and the window in which a node never seen busy is not "
   "idle-reaped while unmet demand remains.")
_D("flight_spill_max_records", int, 8,
   "Past this many snapshot lines a worker's bundle spill file restarts "
   "at the newest window.")
