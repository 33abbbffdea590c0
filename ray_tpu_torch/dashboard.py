"""Thin web dashboard over the state API (counterpart of
``ray_tpu/dashboard.py``): one stdlib HTTP server with a JSON snapshot
endpoint and a self-refreshing HTML page. Every endpoint is a
passthrough to ``ray_tpu_torch.util.state`` in this process (on a
driver attached to a head, the trace, debug and metrics endpoints pull
every live node daemon's too).

Endpoints:
- ``GET /``             live HTML overview (auto-refreshes every 2s)
- ``GET /api/snapshot`` full cluster snapshot as JSON (with the
  elasticity panel under ``elastic``)
- ``GET /api/tasks``    task states (state API passthrough)
- ``GET /api/actors``   actor states
- ``GET /api/workflows`` durable workflow states (journal view)
- ``GET /api/llm``      live inference-engine counters (scheduler
  parks/preemptions, block occupancy, prefix-cache hit rate and
  prefill-tokens-saved — cache effectiveness, live)
- ``GET /api/chaos``    chaos + overload panel: injected wire-fault
  counters per site, NodeKiller kill log, and load-shedding /
  priority-admission stats from serve deployments and LLM engines
- ``GET /api/elastic``  elasticity panel: autoscaler launch/drain
  counters, scale-up events with join latency, serve deployment
  scale/wake records (the cold-start SLO observables)
- ``GET /api/head``     ownership-directory panel: the head's per-kind
  steady-state RPC counts + FT-log appends (the O(membership)-not-
  O(objects) flatness observable) and this runtime's owner/resolver
  counters
- ``GET /api/traces``   distributed-tracing index (every trace any
  process holds spans for); ``?trace_id=`` returns the assembled
  cluster-wide trace, ``&view=waterfall`` the per-request waterfall
  rows (RAY_TPU_TRACE must be armed for spans to exist)
- ``GET /api/debug``    flight-recorder panel: every live process's
  debug bundle (all-thread stacks, event rings, profile aggregates,
  watchdog fires — RAY_TPU_FLIGHT/RAY_TPU_PROFILE must be armed);
  ``?archive=1`` writes a directory-per-incident archive server-side
  and returns its path
- ``GET /metrics``      cluster Prometheus scrape assembled driver-side
  (this registry + every live node's, tagged node/component)
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_PAGE = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title>
<style>
 body { font-family: monospace; margin: 2em; background: #111;
        color: #ddd; }
 h1 { color: #7fd7ff; } h2 { color: #9fe8a0; margin-bottom: 0.2em; }
 table { border-collapse: collapse; margin: 0.5em 0 1.5em; }
 td, th { border: 1px solid #444; padding: 4px 10px; text-align: left; }
 th { background: #222; }
</style></head>
<body><h1>ray_tpu_torch dashboard</h1><div id="root">loading…</div>
<script>
async function refresh() {
  const r = await fetch('/api/snapshot'); const s = await r.json();
  const row = (k, v) => `<tr><td>${k}</td><td>${v}</td></tr>`;
  const table = (obj) => '<table>' + Object.entries(obj).map(
      ([k, v]) => row(k, JSON.stringify(v))).join('') + '</table>';
  document.getElementById('root').innerHTML =
    '<h2>resources</h2>' + table(s.resources) +
    '<h2>tasks</h2>' + table(s.tasks) +
    '<h2>actors</h2>' + table(s.actors) +
    '<h2>object store</h2>' + table(s.object_store) +
    '<h2>workflows</h2>' + table(s.workflows) +
    '<h2>llm engines</h2>' + table(s.llm) +
    '<h2>chaos & shedding</h2>' + table(s.chaos) +
    '<h2>object directory (ownership)</h2>' + table(s.head) +
    '<h2>autoscaling</h2>' + table(s.elastic) +
    '<h2>workers</h2>' + table(s.workers);
}
refresh(); setInterval(refresh, 2000);
</script></body></html>"""


def _snapshot() -> dict:
    from ray_tpu_torch._private.worker import global_worker
    from ray_tpu_torch.util.state import (
        list_actors,
        summarize_actors,
        summarize_tasks,
    )

    w = global_worker()
    shm = None
    if w.shm_store is not None:
        shm = w.shm_store.stats()
    pool = w.worker_pool
    return {
        "resources": {
            "total": w.resource_pool.total,
            "available": w.resource_pool.available(),
        },
        "tasks": summarize_tasks(),
        "actors": {
            "summary": summarize_actors(),
            "named": sorted(n for _, n in w.named_actors),
        },
        "object_store": {
            "python_store_objects": len(getattr(w.store, "_entries", {})),
            "shm": shm,
        },
        "workflows": _workflow_summary(),
        "llm": _llm_summary(),
        "chaos": _chaos_summary(),
        "head": _head_summary(),
        "elastic": _elastic_summary(),
        "workers": {
            "mode": w.worker_mode,
            "pool_size": pool.size if pool is not None else 0,
            "pids": pool.pids() if pool is not None else [],
            "session_dir": w.session_dir,
        },
        "actors_detail": list_actors(limit=100),
    }


def _workflow_summary() -> dict:
    """Durable-workflow panel: per-status counts plus the most recently
    updated entries (journal view; empty when no storage root has been
    touched this process)."""
    try:
        from ray_tpu_torch.util.state import (
            list_workflows,
            summarize_workflows,
        )

        rows = list_workflows(limit=1000)
        recent = sorted(rows, key=lambda r: r.updated_at or 0.0,
                        reverse=True)[:10]
        return {
            "summary": summarize_workflows(rows),
            "recent": {r.workflow_id: r.status for r in recent},
        }
    except Exception as exc:  # noqa: BLE001 — panel must not kill page
        return {"error": repr(exc)}


def _llm_summary() -> dict:
    """LLM-serving panel: fleet rollup plus per-engine counters (empty
    when no engine has been constructed this process)."""
    try:
        from ray_tpu_torch.util.state import list_llm_engines, \
            summarize_llm_engines

        rows = list_llm_engines(limit=20)
        return {
            "summary": summarize_llm_engines(rows),
            "engines": {e.engine_id: {
                "running": e.running,
                "blocks_in_use": e.blocks_in_use,
                "prefix_cache_hit_rate": round(
                    e.prefix_cache_hit_rate, 4),
                "prefill_tokens_saved": e.prefill_tokens_saved,
                "park_events": e.park_events,
                "preemptions": e.num_preempted,
            } for e in rows},
        }
    except Exception as exc:  # noqa: BLE001 — panel must not kill page
        return {"error": repr(exc)}


def _chaos_summary() -> dict:
    """Chaos + shedding panel: injected-fault counters, kill log size,
    shed/admission stats (all-zero when chaos never ran)."""
    try:
        from ray_tpu_torch.util.state import chaos_summary

        return chaos_summary()
    except Exception as exc:  # noqa: BLE001 — panel must not kill page
        return {"error": repr(exc)}


def _elastic_summary() -> dict:
    """Elasticity panel: the autoscalers' launch and drain counters and
    Serve's scale records (``util.state.autoscaler_summary``)."""
    try:
        from ray_tpu_torch.util.state import autoscaler_summary

        return autoscaler_summary()
    except Exception as exc:  # noqa: BLE001 — panel must not kill page
        return {"error": repr(exc)}


def _head_summary() -> dict:
    """Ownership-directory panel: head steady-state RPC/log counters +
    local owner/resolver counters (local-only view without a head)."""
    try:
        from ray_tpu_torch.util.state import ownership_summary

        return ownership_summary()
    except Exception as exc:  # noqa: BLE001 — panel must not kill page
        return {"error": repr(exc)}


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):
        pass

    def do_GET(self):
        try:
            if self.path.startswith("/api/snapshot"):
                payload = json.dumps(_snapshot(), default=str).encode()
                ctype = "application/json"
            elif self.path.startswith("/api/tasks"):
                from ray_tpu_torch.util.state import list_tasks

                payload = json.dumps(list_tasks(limit=1000),
                                     default=str).encode()
                ctype = "application/json"
            elif self.path.startswith("/api/actors"):
                from ray_tpu_torch.util.state import list_actors

                payload = json.dumps(list_actors(limit=1000),
                                     default=str).encode()
                ctype = "application/json"
            elif self.path.startswith("/api/workflows"):
                from ray_tpu_torch.util.state import list_workflows

                payload = json.dumps(
                    [w.__dict__ for w in list_workflows(limit=1000)],
                    default=str).encode()
                ctype = "application/json"
            elif self.path.startswith("/api/llm"):
                from ray_tpu_torch.util.state import list_llm_engines

                payload = json.dumps(
                    [e.__dict__ for e in list_llm_engines(limit=100)],
                    default=str).encode()
                ctype = "application/json"
            elif self.path.startswith("/api/chaos"):
                from ray_tpu_torch.util.state import chaos_summary

                payload = json.dumps(chaos_summary(),
                                     default=str).encode()
                ctype = "application/json"
            elif self.path.startswith("/api/head"):
                from ray_tpu_torch.util.state import ownership_summary

                payload = json.dumps(ownership_summary(),
                                     default=str).encode()
                ctype = "application/json"
            elif self.path.startswith("/api/elastic"):
                from ray_tpu_torch.util.state import autoscaler_summary

                payload = json.dumps(autoscaler_summary(),
                                     default=str).encode()
                ctype = "application/json"
            elif self.path.startswith("/api/traces"):
                from urllib.parse import parse_qs, urlparse

                from ray_tpu_torch.util.state import (
                    trace_summary,
                    trace_waterfall,
                )

                qs = parse_qs(urlparse(self.path).query)
                tid = qs.get("trace_id", [None])[0]
                if tid and qs.get("view", [""])[0] == "waterfall":
                    body = trace_waterfall(tid)
                else:
                    body = trace_summary(tid)
                payload = json.dumps(body, default=str).encode()
                ctype = "application/json"
            elif self.path.startswith("/api/debug"):
                from urllib.parse import parse_qs, urlparse

                from ray_tpu_torch.util.state import (
                    cluster_dump,
                    collect_debug_bundles,
                )

                qs = parse_qs(urlparse(self.path).query)
                if qs.get("archive", [""])[0]:
                    # ?archive=1 writes the incident directory server-
                    # side and returns its path (the one-click dump).
                    body = {"incident_dir": cluster_dump()}
                else:
                    body = collect_debug_bundles()
                payload = json.dumps(body, default=str).encode()
                ctype = "application/json"
            elif self.path.startswith("/metrics"):
                from ray_tpu_torch.util.state import cluster_metrics

                payload = cluster_metrics().encode()
                ctype = "text/plain; version=0.0.4"
            else:
                payload = _PAGE.encode()
                ctype = "text/html"
            self.send_response(200)
        except Exception as exc:  # noqa: BLE001 — snapshot error boundary
            payload = json.dumps({"error": repr(exc)}).encode()
            ctype = "application/json"
            self.send_response(500)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)


class Dashboard:
    def __init__(self, host: str = "127.0.0.1", port: int = 8265):
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="ray_tpu_torch_dashboard")
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()


_dashboard: Optional[Dashboard] = None


def start_dashboard(host: str = "127.0.0.1",
                    port: int = 8265) -> Dashboard:
    global _dashboard
    if _dashboard is None:
        _dashboard = Dashboard(host, port)
    return _dashboard


def stop_dashboard():
    global _dashboard
    if _dashboard is not None:
        _dashboard.shutdown()
        _dashboard = None
