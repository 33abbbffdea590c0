"""Typed config/flag registry with environment-variable override (copy of
``ray_tpu/_private/config.py``, trimmed to the flags the one-process
runtime reads).

Every knob is declared once with a type and default, overridable by a
``RAY_TPU_<NAME>`` environment variable or a ``_system_config`` dict
passed to ``init()``. The port has one execution plane (threads in the
calling process), so the reference's ``worker_mode`` is not a flag here.
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
