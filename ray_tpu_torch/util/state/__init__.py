"""State API (counterpart of ``ray_tpu/util/state/__init__.py``, its
local half): listings and summaries of tasks, actors, objects and LLM
engines, the task-event timeline, trace assembly, the metrics scrape and
the debug bundle archive, backed by the worker's task-event buffer, its
registries and this process's tracer and flight recorder.

Every function covers this process and its worker processes (their
spilled spans and flight bundles). On a driver attached to a head, the
trace, metrics and flight collections also take the head's and pull
every live node daemon's (``_pull_live_nodes``: the daemon's direct
server first, the head relay as the fallback), and ``ownership_summary``
reports the ownership plane's counters. ``autoscaler_summary`` reads
every ``ClusterAutoscaler`` alive in this process and Serve's scale and
wake records. The workflow listings read the storage root of
``workflow.init`` (or the default root).
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


def chaos_summary() -> Dict[str, Any]:
    """Chaos and load-shedding panel: the active fault config and
    per-site fault counters, every kill recorded by NodeKillers in this
    process, and shed/admission stats from both shedding tiers — Serve
    deployments (priority admission in the router) and LLM engines
    (waitqueue eviction). Always safe to call; all-zero/empty when chaos
    never ran and nothing shed."""
    import sys

    from ray_tpu_torch._private import chaos as _chaos

    out: Dict[str, Any] = _chaos.snapshot()

    # Serve-tier shedding: per-deployment admission stats off the live
    # controller singleton (never constructs one just to report zeros).
    serve_shedding: Dict[str, Any] = {}
    ctl_mod = sys.modules.get("ray_tpu_torch.serve.controller")
    ctl = getattr(ctl_mod, "_controller", None)
    if ctl is not None:
        with ctl._lock:
            infos = list(ctl._deployments.values())
        for info in infos:
            serve_shedding[info.name] = info.replica_set.admission_stats()
    out["serve_shedding"] = serve_shedding
    out["serve_shed_total"] = sum(
        s.get("shed_total", 0) for s in serve_shedding.values())

    # LLM-tier shedding: waitqueue evictions per engine, read only when
    # the llm layer is already loaded.
    llm_shedding: Dict[int, Any] = {}
    engine_mod = sys.modules.get("ray_tpu_torch.llm.engine")
    for eng in (engine_mod.live_engines() if engine_mod else ()):
        st = eng.stats()
        llm_shedding[st["engine_id"]] = {
            "shed_requests": st.get("shed_requests", 0),
            "shed_by_class": st.get("shed_by_class", {}),
            "submitted_by_class": st.get("submitted_by_class", {}),
        }
    out["llm_shedding"] = llm_shedding
    out["llm_shed_total"] = sum(
        s.get("shed_requests", 0) for s in llm_shedding.values())
    return out


def autoscaler_summary() -> Dict[str, Any]:
    """Elasticity panel (``/api/elastic``): every live
    ClusterAutoscaler's launch and drain counters and scale-up events
    (``launch_attempts``/``launch_failures`` are the provider-level
    tries behind the typed ``NodeLaunchFailedError``; ``scale_events``
    carry join latency, the node half of the cold start), plus each
    Serve deployment's scale and wake record (the replica half). Safe
    in any process; empty sections when nothing autoscales here."""
    import sys

    scalers = []
    mod = sys.modules.get("ray_tpu_torch.autoscaler")
    try:
        for sc in (mod.live_autoscalers() if mod is not None else ()):
            scalers.append(sc.summary())
    except Exception:  # noqa: BLE001 — panel must not fail the API
        pass
    out: Dict[str, Any] = {
        "autoscalers": scalers,
        **{k: sum(s.get(k, 0) for s in scalers) for k in (
            "launch_attempts", "launch_failures", "launch_errors",
            "drained_nodes", "drain_transferred_objects",
            "drain_untransferred_objects")},
    }
    serve_scaling: Dict[str, Any] = {}
    ctl_mod = sys.modules.get("ray_tpu_torch.serve.controller")
    ctl = getattr(ctl_mod, "_controller", None)
    if ctl is not None:
        try:
            for name, st in ctl.status().items():
                serve_scaling[name] = {k: st[k] for k in (
                    "replicas", "target_replicas", "scale_events",
                    "wake_events", "last_wake_latency_s")}
        except Exception:  # noqa: BLE001 — panel must not fail the API
            pass
    out["serve_scaling"] = serve_scaling
    try:
        router = global_worker().remote_router
    except Exception:  # noqa: BLE001 — no runtime in this process
        router = None
    if router is not None:
        out["drain_reroutes"] = router.drain_reroutes
        out["offloaded_objects"] = router.offloaded_objects
        out["fn_preship_sent"] = router.fn_preship_sent
    return out


def list_placement_groups(limit: int = 1000) -> List[Dict[str, Any]]:
    from ray_tpu_torch.util.placement_group import placement_group_table

    return list(placement_group_table().values())[:limit]


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


def ownership_summary() -> Dict[str, Any]:
    """The ownership plane's counters: this runtime's owner side
    (locations tracked, owner-direct locates and pulls served, direct
    and relayed completion reports), its resolver side, and the head's
    RPC and state-log counters (the head stays O(membership), not
    O(objects)). Safe without a head (the local side only)."""
    w = global_worker()
    out: Dict[str, Any] = {"ownership_directory": True}
    router = w.remote_router
    if router is not None:
        directory = router.owner_directory
        with router._lock:
            tracked = len(router._oid_owner)
        out["owner"] = {
            "locations_tracked": tracked,
            "locates_served": directory.locates_served,
            "notifies_sent": directory.notifies_sent,
            "owner_table_pulls": router.owner_table_pulls,
            "direct_done_reports": router.direct_done_reports,
            "relayed_done_reports": router.relayed_done_reports,
        }
    if w.owner_resolver is not None:
        out["resolver"] = w.owner_resolver.counters()
    if w.head_client is not None:
        try:
            out["head"] = w.head_client.head_stats()
        except Exception as exc:  # noqa: BLE001 — head down: local view
            out["head"] = {"error": repr(exc)}
    return out


def get_timeline() -> List[dict]:
    """Chrome-tracing events of the task-event ring."""
    return global_worker().task_events.to_chrome_trace()


# ------------------------------------------------------------ tracing
def _pull_live_nodes(direct_msg: tuple, relay_fn) -> List[tuple]:
    """One payload from every live node daemon, pulled concurrently:
    the node's direct object-server call (``direct_msg``) first, the
    head relay (``relay_fn(client_id)``) as the fallback. Returns
    ``(node, payload)`` pairs; a node that answers neither way is
    skipped, so one dead dial bounds the wall time, not their sum."""
    from concurrent.futures import ThreadPoolExecutor

    w = global_worker()
    hc = w.head_client
    router = w.remote_router
    if hc is None or router is None:
        return []
    nodes = [n for n in router.nodes(refresh=True) if n.get("alive")]
    if not nodes:
        return []

    def fetch(n):
        addr = n.get("peer_addr")
        if addr:
            try:
                return hc._peers.call((str(addr[0]), int(addr[1])),
                                      direct_msg)
            except Exception:  # noqa: BLE001 — dead dial: the relay
                pass
        try:
            return relay_fn(n["client_id"])
        except Exception:  # noqa: BLE001 — node mid-death: skipped
            return None

    with ThreadPoolExecutor(
            max_workers=min(8, len(nodes)),
            thread_name_prefix="state-node-pull") as pool:
        results = list(pool.map(fetch, nodes))
    return [(n, r) for n, r in zip(nodes, results) if r]


def collect_trace_spans(trace_id: Optional[str] = None) -> List[dict]:
    """Spans (of one trace, if given) of this process (and its worker
    processes' spills), the head's ring and every live node daemon's
    ``trace_dump``, deduplicated and sorted by start. Empty when
    tracing is off everywhere."""
    from ray_tpu_torch._private import tracing

    spans: List[dict] = list(tracing.local_spans(trace_id))
    hc = global_worker().head_client
    if hc is not None:
        try:
            spans.extend(hc.trace_dump(trace_id or ""))
        except Exception:  # noqa: BLE001 — head down: local view only
            pass
        for _n, dumped in _pull_live_nodes(
                ("trace_dump", trace_id or ""),
                lambda cid: hc.node_trace_dump(cid, trace_id or "")):
            spans.extend(dict(s) for s in dumped)
    seen = set()
    out = []
    for s in spans:
        key = (s.get("span_id"), s.get("t0"), s.get("name"))
        if key in seen:
            continue
        seen.add(key)
        out.append(s)
    out.sort(key=lambda s: s.get("t0", 0.0))
    return out


def collect_trace_index() -> Dict[str, Dict[str, Any]]:
    """Per-trace aggregates, from the same sources as
    :func:`collect_trace_spans` (each ships O(traces) aggregates)."""
    from ray_tpu_torch._private import tracing

    merged: Dict[str, Dict[str, Any]] = {}

    def fold(idx):
        for tid, r in (idx or {}).items():
            rec = merged.setdefault(tid, {
                "num_spans": 0, "processes": set(), "components": set(),
                "first_t0": r.get("first_t0", 0.0), "errors": 0,
                "root": ""})
            rec["num_spans"] += int(r.get("num_spans", 0))
            rec["processes"].update(r.get("pids", ()))
            rec["components"].update(r.get("components", ()))
            rec["first_t0"] = min(rec["first_t0"],
                                  r.get("first_t0", rec["first_t0"]))
            rec["errors"] += int(r.get("errors", 0))
            if not rec["root"] and r.get("root"):
                rec["root"] = r["root"]

    fold(tracing.trace_index())
    hc = global_worker().head_client
    if hc is not None:
        try:
            fold(hc.trace_index())
        except Exception:  # noqa: BLE001 — head down: local view only
            pass
        for _n, idx in _pull_live_nodes(
                ("trace_dump", "", True),
                lambda cid: hc.node_trace_index(cid)):
            fold(idx)
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
    """One Prometheus text blob: this process's registry and every live
    node daemon's ``metrics_dump``, each sample tagged with its source's
    ``node``/``component``."""
    from ray_tpu_torch.util.metrics import (
        export_prometheus,
        merge_prometheus,
        refresh_framework_metrics,
        relabel_prometheus,
    )

    w = global_worker()
    refresh_framework_metrics(w)
    parts = [relabel_prometheus(
        export_prometheus(), {"node": "driver", "component": "driver"})]
    hc = w.head_client
    if hc is not None:
        for n, text in _pull_live_nodes(
                ("metrics_dump",), lambda cid: hc.node_metrics_dump(cid)):
            parts.append(relabel_prometheus(
                str(text), {"node": n["client_id"], "component": "node"}))
    return merge_prometheus(parts)


# ------------------------------------------------------- flight recorder
def collect_debug_bundles() -> Dict[str, dict]:
    """This process's flight bundle under ``"driver"`` (the framework
    gauges refreshed first), with the newest bundle each of its worker
    processes spilled under its ``"workers"``; with a head, the head's
    bundle under ``"head"`` and every live node daemon's under
    ``"node-<client>"`` (its worker processes' nested under its
    ``"workers"``). A source whose recorder is disarmed is absent."""
    from ray_tpu_torch._private import flight
    from ray_tpu_torch.util.metrics import refresh_framework_metrics

    w = global_worker()
    refresh_framework_metrics(w)
    out: Dict[str, dict] = {}
    local = flight.local_bundle(include_dir=True)
    if local:
        out["driver"] = local
    hc = getattr(w, "head_client", None)
    if hc is not None:
        head_bundle = hc.debug_dump()
        if head_bundle:
            out["head"] = head_bundle
        for n, bundle in _pull_live_nodes(
                ("debug_dump",), lambda cid: hc.node_debug_dump(cid)):
            out[f"node-{n['client_id']}"] = dict(bundle)
    return out


def _dump_root() -> str:
    from ray_tpu_torch._private.config import GlobalConfig

    return GlobalConfig.flight_dir or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch", "debug_dumps")


def cluster_dump(out_dir: Optional[str] = None) -> str:
    """Write ONE directory-per-incident archive,
    ``<out_dir>/debug-<stamp>-<id>/``, holding one ``<source>.json`` per
    process (``driver.json`` when the recorder is armed, ``head.json``
    with an armed head; worker processes' bundles split out as
    ``<source>.worker-<pid>.json``) and a ``manifest.json`` index.
    Returns the incident directory."""
    bundles = collect_debug_bundles()
    root = out_dir or _dump_root()
    incident = os.path.join(
        root, f"debug-{time.strftime('%Y%m%d-%H%M%S')}-"
              f"{uuid.uuid4().hex[:6]}")
    os.makedirs(incident, exist_ok=True)
    manifest = {"ts": time.time(), "sources": {}}
    for source, bundle in sorted(bundles.items()):
        workers = bundle.pop("workers", []) or []
        with open(os.path.join(incident, f"{source}.json"), "w") as f:
            json.dump(bundle, f, indent=1)
        files = [f"{source}.json"]
        for wb in workers:
            wname = f"{source}.worker-{wb.get('pid', 0)}.json"
            with open(os.path.join(incident, wname), "w") as f:
                json.dump(wb, f, indent=1)
            files.append(wname)
        manifest["sources"][source] = {
            "files": files,
            "pid": bundle.get("pid"),
            "component": bundle.get("component"),
            "node": bundle.get("node"),
            "watchdog_fires": bundle.get("watchdog_fires", 0),
            "num_workers": len(workers),
        }
    manifest["num_processes"] = sum(
        1 + s["num_workers"] for s in manifest["sources"].values())
    with open(os.path.join(incident, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return incident


def set_cluster_profiling(on: bool) -> Dict[str, bool]:
    """Pause or resume the stack sampler of this process, the head and
    every live node daemon. Returns ``{source: running}`` for each
    sampler reached (an unreachable node is absent)."""
    from ray_tpu_torch._private import flight

    out = {"driver": flight.set_profiling(on)}
    hc = global_worker().head_client
    if hc is not None:
        try:
            head_state = hc.flight_ctl_head(on)
            if head_state:
                out["head"] = bool(head_state.get("running"))
        except Exception:  # noqa: BLE001 — head down: partial toggle
            pass
        for n, state in _pull_live_nodes(
                ("flight_ctl", "profile", bool(on)),
                lambda cid: hc.node_flight_ctl(cid, on)):
            if isinstance(state, dict):
                out[f"node-{n['client_id']}"] = bool(state.get("running"))
    return out


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
