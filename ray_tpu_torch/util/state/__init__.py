"""State API (counterpart of ``ray_tpu/util/state/__init__.py``, its
local half): listings and summaries of tasks, actors, objects and LLM
engines, the task-event timeline, trace assembly, the metrics scrape and
the debug bundle archive, backed by the worker's task-event buffer, its
registries and this process's tracer and flight recorder.

Every function covers this process only, as the reference's do without a
head client. Not ported: ``chaos_summary`` (with the chaos plane),
``autoscaler_summary`` and ``ownership_summary`` (with the cluster,
ROADMAP A.5b) and ``list_placement_groups`` (with
``util/placement_group``). The workflow listings read the storage root
of ``workflow.init`` (or the default root).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.worker import global_worker


@dataclass
class TaskState:
    task_id: str
    name: str
    state: str
    duration_s: Optional[float]
    node: str = ""  # shipping node's id ("" = this runtime)


@dataclass
class ActorState:
    actor_id: str
    class_name: str
    name: Optional[str]
    state: str
    num_restarts: int


@dataclass
class WorkflowState:
    workflow_id: str
    status: str
    root: str
    updated_at: Optional[float]


@dataclass
class LLMEngineState:
    """One live inference engine's operational counters (park and
    preemption pressure, block occupancy, prefix-cache hit rate and
    prefill tokens saved)."""

    engine_id: int
    tp_size: int
    steps: int
    running: int
    waiting: int
    generated_tokens: int
    prefill_tokens: int
    blocks_in_use: int
    free_blocks: int
    cached_free_blocks: int
    park_events: int
    num_preempted: int
    prefix_cache_queries: int
    prefix_cache_hits: int
    prefill_tokens_saved: int
    prefix_cache_hit_rate: float
    cow_copies: int
    max_prefill_tokens_per_step: int


@dataclass
class ObjectState:
    object_id: str
    ready: bool
    size_bytes: int
    local_refs: int
    submitted_refs: int
    spilled: bool


def list_tasks(filters: Optional[List] = None,
               limit: int = 1000) -> List[TaskState]:
    """Each task's latest state; ``filters`` are ``(key, op, value)``
    triples with op ``=``, ``==`` or ``!=``."""
    worker = global_worker()
    out: List[TaskState] = []
    for ev in worker.task_events.list_tasks(limit=limit * 4):
        st = TaskState(task_id=ev.task_id.hex(), name=ev.name,
                       state=ev.state, duration_s=ev.duration,
                       node=ev.extra.get("node", ""))
        if _matches(st, filters):
            out.append(st)
        if len(out) >= limit:
            break
    return out


def list_actors(filters: Optional[List] = None,
                limit: int = 1000) -> List[ActorState]:
    worker = global_worker()
    out = []
    for actor_id, runtime in list(worker.actors.items()):
        st = ActorState(
            actor_id=actor_id.hex(), class_name=runtime.class_name,
            name=runtime.actor_name,
            state="DEAD" if runtime.dead else "ALIVE",
            num_restarts=runtime.restarts_used)
        if _matches(st, filters):
            out.append(st)
        if len(out) >= limit:
            break
    return out


def list_objects(filters: Optional[List] = None,
                 limit: int = 1000) -> List[ObjectState]:
    worker = global_worker()
    out = []
    for oid, ready, size, lrefs, srefs, spilled in (
            worker.store.entries_snapshot()):
        st = ObjectState(object_id=oid.hex(), ready=ready, size_bytes=size,
                         local_refs=lrefs, submitted_refs=srefs,
                         spilled=spilled)
        if _matches(st, filters):
            out.append(st)
        if len(out) >= limit:
            break
    return out


def list_workflows(filters: Optional[List] = None,
                   limit: int = 1000) -> List[WorkflowState]:
    """Durable workflows under the process-global workflow storage root
    (set by ``workflow.init`` or the first run or resume)."""
    from ray_tpu_torch.workflow.api import _ensure_storage

    out: List[WorkflowState] = []
    for rec in _ensure_storage(None).list_workflows():
        st = WorkflowState(
            workflow_id=rec.get("workflow_id", "?"),
            status=rec.get("status", "?"),
            root=rec.get("root", ""),
            updated_at=rec.get("updated_at"))
        if _matches(st, filters):
            out.append(st)
        if len(out) >= limit:
            break
    return out


def summarize_workflows(
        workflows: Optional[List[WorkflowState]] = None) -> Dict[str, int]:
    """Workflows per status; pass a ``list_workflows`` result to skip a
    second scan of the storage."""
    counts: Dict[str, int] = {}
    for wf in (workflows if workflows is not None else list_workflows()):
        counts[wf.status] = counts.get(wf.status, 0) + 1
    return counts


def list_llm_engines(limit: int = 100) -> List[LLMEngineState]:
    """Inference engines alive in this process: the scheduler's counters
    (parks, preemptions, block occupancy) and the prefix cache's (hit
    rate, prefill tokens saved, copy-on-write copies)."""
    from ray_tpu_torch.llm.engine import live_engines

    out: List[LLMEngineState] = []
    for eng in live_engines()[:limit]:
        st = eng.stats()
        out.append(LLMEngineState(
            **{f: st[f] for f in LLMEngineState.__dataclass_fields__}))
    return out


def summarize_llm_engines(
        engines: Optional[List[LLMEngineState]] = None) -> Dict[str, Any]:
    """Fleet-level cache-effectiveness rollup."""
    rows = engines if engines is not None else list_llm_engines()
    saved = sum(e.prefill_tokens_saved for e in rows)
    computed = sum(e.prefill_tokens for e in rows)
    return {
        "num_engines": len(rows),
        "running": sum(e.running for e in rows),
        "waiting": sum(e.waiting for e in rows),
        "generated_tokens": sum(e.generated_tokens for e in rows),
        "blocks_in_use": sum(e.blocks_in_use for e in rows),
        "park_events": sum(e.park_events for e in rows),
        "num_preempted": sum(e.num_preempted for e in rows),
        "prefill_tokens_saved": saved,
        "prefix_cache_hit_rate": (
            saved / (saved + computed) if (saved + computed) else 0.0),
    }


def summarize_tasks() -> Dict[str, int]:
    return global_worker().task_events.summary()


def summarize_actors() -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for a in list_actors():
        counts[a.state] = counts.get(a.state, 0) + 1
    return counts


def summarize_objects() -> Dict[str, Any]:
    rows = global_worker().store.entries_snapshot()
    return {
        "num_objects": len(rows),
        "num_ready": sum(1 for r in rows if r[1]),
        "total_bytes": sum(r[2] for r in rows),
        "num_spilled": sum(1 for r in rows if r[5]),
    }


def get_timeline() -> List[dict]:
    """Chrome-tracing events of the task-event ring."""
    return global_worker().task_events.to_chrome_trace()


# ------------------------------------------------------------ tracing
def collect_trace_spans(trace_id: Optional[str] = None) -> List[dict]:
    """This process's spans (of one trace, if given), deduplicated and
    sorted by start. Empty when tracing is off."""
    from ray_tpu_torch._private import tracing

    seen = set()
    out = []
    for s in tracing.local_spans(trace_id):
        key = (s.get("span_id"), s.get("t0"), s.get("name"))
        if key in seen:
            continue
        seen.add(key)
        out.append(s)
    out.sort(key=lambda s: s.get("t0", 0.0))
    return out


def collect_trace_index() -> Dict[str, Dict[str, Any]]:
    """Per-trace aggregates of this process's ring."""
    from ray_tpu_torch._private import tracing

    merged: Dict[str, Dict[str, Any]] = {}
    for tid, r in tracing.trace_index().items():
        merged[tid] = {
            "num_spans": int(r["num_spans"]),
            "processes": set(r["pids"]),
            "components": set(r["components"]),
            "first_t0": r["first_t0"], "errors": int(r["errors"]),
            "root": r["root"]}
    return merged


def trace_summary(trace_id: Optional[str] = None) -> Dict[str, Any]:
    """The assembled trace view. With ``trace_id``: every span of that
    trace (sorted), the processes and components it crossed, and
    Chrome-tracing JSON. Without: an index of every trace held."""
    from ray_tpu_torch._private import tracing

    if trace_id is None:
        traces = collect_trace_index()
        return {
            "num_traces": len(traces),
            "traces": {
                tid: {
                    "num_spans": r["num_spans"],
                    "num_processes": len(r["processes"]),
                    "components": sorted(r["components"]),
                    "first_t0": r["first_t0"],
                    "errors": r["errors"],
                    "root": r["root"],
                } for tid, r in traces.items()
            },
        }
    spans = collect_trace_spans(trace_id)
    procs = sorted({tracing.process_key(s.get("node", ""),
                                        s.get("pid", 0)) for s in spans})
    t0s = [s["t0"] for s in spans]
    ends = [s["t0"] + s.get("dur", 0.0) for s in spans]
    return {
        "trace_id": trace_id,
        "num_spans": len(spans),
        "spans": spans,
        "processes": procs,
        "num_processes": len(procs),
        "components": sorted({s.get("component", "")
                              for s in spans}),
        "nodes": sorted({s.get("node", "") for s in spans
                         if s.get("node")}),
        "errors": sum(1 for s in spans
                      if s.get("status") == "error"),
        "wall_span_s": (max(ends) - min(t0s)) if spans else 0.0,
        "chrome_trace": tracing.chrome_trace(spans),
    }


def trace_waterfall(trace_id: str) -> List[Dict[str, Any]]:
    """Per-request waterfall rows: the spans of one trace sorted by
    start, with offsets from the trace's first span."""
    spans = collect_trace_spans(trace_id)
    if not spans:
        return []
    t0 = min(s["t0"] for s in spans)
    return [{
        "offset_s": s["t0"] - t0,
        "dur_s": s.get("dur", 0.0),
        "name": s["name"],
        "component": s.get("component", ""),
        "pid": s.get("pid", 0),
        "node": s.get("node", ""),
        "status": s.get("status", "ok"),
        "span_id": s.get("span_id", ""),
        "parent_id": s.get("parent_id", ""),
    } for s in spans]


def cluster_metrics() -> str:
    """This process's registry as one Prometheus text blob, its samples
    tagged ``node``/``component`` as the reference tags the driver's."""
    from ray_tpu_torch.util.metrics import (
        export_prometheus,
        merge_prometheus,
        refresh_framework_metrics,
        relabel_prometheus,
    )

    refresh_framework_metrics(global_worker())
    return merge_prometheus([relabel_prometheus(
        export_prometheus(), {"node": "driver", "component": "driver"})])


# ------------------------------------------------------- flight recorder
def collect_debug_bundles() -> Dict[str, dict]:
    """This process's flight bundle under ``"driver"``, with the
    framework gauges refreshed first; empty while the recorder is
    disarmed."""
    from ray_tpu_torch._private import flight
    from ray_tpu_torch.util.metrics import refresh_framework_metrics

    refresh_framework_metrics(global_worker())
    local = flight.local_bundle()
    return {"driver": local} if local else {}


def _dump_root() -> str:
    from ray_tpu_torch._private.config import GlobalConfig

    return GlobalConfig.flight_dir or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch", "debug_dumps")


def cluster_dump(out_dir: Optional[str] = None) -> str:
    """Write ONE directory-per-incident archive,
    ``<out_dir>/debug-<stamp>-<id>/``, holding one ``<source>.json`` per
    process (here ``driver.json``, when the recorder is armed) and a
    ``manifest.json`` index. Returns the incident directory."""
    bundles = collect_debug_bundles()
    root = out_dir or _dump_root()
    incident = os.path.join(
        root, f"debug-{time.strftime('%Y%m%d-%H%M%S')}-"
              f"{uuid.uuid4().hex[:6]}")
    os.makedirs(incident, exist_ok=True)
    manifest = {"ts": time.time(), "sources": {}}
    for source, bundle in sorted(bundles.items()):
        with open(os.path.join(incident, f"{source}.json"), "w") as f:
            json.dump(bundle, f, indent=1)
        manifest["sources"][source] = {
            "files": [f"{source}.json"],
            "pid": bundle.get("pid"),
            "component": bundle.get("component"),
            "node": bundle.get("node"),
            "watchdog_fires": bundle.get("watchdog_fires", 0),
            "num_workers": 0,
        }
    manifest["num_processes"] = len(manifest["sources"])
    with open(os.path.join(incident, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return incident


def set_cluster_profiling(on: bool) -> Dict[str, bool]:
    """Pause or resume this process's stack sampler. Returns
    ``{"driver": running}``."""
    from ray_tpu_torch._private import flight

    return {"driver": flight.set_profiling(on)}


def _matches(item, filters) -> bool:
    if not filters:
        return True
    for key, op, value in filters:
        actual = getattr(item, key, None)
        if op in ("=", "=="):
            if str(actual) != str(value):
                return False
        elif op == "!=":
            if str(actual) == str(value):
                return False
        else:
            raise ValueError(f"unsupported filter op {op!r}")
    return True
