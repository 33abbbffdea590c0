"""User and framework metrics with Prometheus text exposition (copy of
``ray_tpu/util/metrics.py``).

One process-global registry of ``Counter``, ``Gauge`` and ``Histogram``;
``export_prometheus()`` renders text format 0.0.4, ``relabel_prometheus``
and ``merge_prometheus`` tag and merge several expositions into one
valid blob, and ``serve_metrics()`` exposes /metrics over the stdlib's
HTTP server. ``framework_metrics()`` are the runtime's built-in gauges
(scheduler backlog, finished tasks, store objects, spans recorded,
watchdog fires, flight events), refreshed from the port's worker by
``refresh_framework_metrics``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: List["Metric"] = []


class Metric:
    metric_type = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()
        self._default_tags: Dict[str, str] = {}
        with _registry_lock:
            _registry.append(self)

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple[str, ...]:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        extra = set(merged) - set(self.tag_keys)
        if extra:
            raise ValueError(
                f"metric {self.name}: undeclared tag keys {sorted(extra)}")
        return tuple(merged.get(k, "") for k in self.tag_keys)

    def _samples(self):
        with self._lock:
            return dict(self._values)


class Counter(Metric):
    metric_type = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("counters only increase")
        k = self._key(tags)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(Metric):
    metric_type = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values[self._key(tags)] = float(value)


class Histogram(Metric):
    metric_type = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = (),
                 tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries) or [
            0.001, 0.01, 0.1, 1.0, 10.0, 100.0]
        self._buckets: Dict[Tuple[str, ...], List[int]] = {}
        self._sums: Dict[Tuple[str, ...], float] = {}
        self._counts: Dict[Tuple[str, ...], int] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        k = self._key(tags)
        with self._lock:
            buckets = self._buckets.setdefault(
                k, [0] * (len(self.boundaries) + 1))
            idx = len(self.boundaries)
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    idx = i
                    break
            buckets[idx] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._counts[k] = self._counts.get(k, 0) + 1

    def _samples(self):
        with self._lock:
            return {
                k: (list(v), self._sums.get(k, 0.0), self._counts.get(k, 0))
                for k, v in self._buckets.items()
            }


def _fmt_tags(keys, values) -> str:
    if not keys:
        return ""
    pairs = ",".join(f'{k}="{v}"' for k, v in zip(keys, values))
    return "{" + pairs + "}"


def export_prometheus() -> str:
    """Render every registered metric in Prometheus text format."""
    lines: List[str] = []
    with _registry_lock:
        metrics = list(_registry)
    for m in metrics:
        lines.append(f"# HELP {m.name} {m.description}")
        lines.append(f"# TYPE {m.name} {m.metric_type}")
        if isinstance(m, Histogram):
            for k, (buckets, total, count) in m._samples().items():
                cum = 0
                for b, n in zip(m.boundaries, buckets):
                    cum += n
                    tag = _fmt_tags(m.tag_keys + ("le",),
                                    k + (str(b),))
                    lines.append(f"{m.name}_bucket{tag} {cum}")
                cum += buckets[-1]
                tag = _fmt_tags(m.tag_keys + ("le",), k + ("+Inf",))
                lines.append(f"{m.name}_bucket{tag} {cum}")
                lines.append(
                    f"{m.name}_sum{_fmt_tags(m.tag_keys, k)} {total}")
                lines.append(
                    f"{m.name}_count{_fmt_tags(m.tag_keys, k)} {count}")
        else:
            for k, v in m._samples().items():
                lines.append(f"{m.name}{_fmt_tags(m.tag_keys, k)} {v}")
    return "\n".join(lines) + "\n"


def clear_registry():
    """Unregister every metric; the framework gauges register again at
    the next ``framework_metrics()``."""
    global _framework
    with _registry_lock:
        _registry.clear()
    with _framework_lock:
        _framework = None


_SAMPLE_RE = None  # compiled lazily (scrape path only)


def relabel_prometheus(text: str, extra_tags: Dict[str, str]) -> str:
    """Re-render Prometheus text with ``extra_tags`` prepended to every
    sample line (``util.state.cluster_metrics`` stamps node and
    component onto the registry). Comment lines pass through."""
    global _SAMPLE_RE
    if not extra_tags:
        return text
    if _SAMPLE_RE is None:
        import re

        _SAMPLE_RE = re.compile(
            r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?( .+)$")
    prefix = ",".join(f'{k}="{v}"' for k, v in extra_tags.items())
    out: List[str] = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            out.append(line)
            continue
        name, tags, value = m.groups()
        merged = f"{prefix},{tags}" if tags else prefix
        out.append(f"{name}{{{merged}}}{value}")
    return "\n".join(out) + ("\n" if text.endswith("\n") else "")


def merge_prometheus(parts: List[str]) -> str:
    """Merge several exposition texts into ONE valid Prometheus blob.
    The text format allows each metric family's ``# HELP``/``# TYPE``
    at most once and requires a family's samples to be contiguous, so a
    plain concatenation of registries that export the same gauges is
    rejected by a real Prometheus scraper. Groups samples by family
    (first-seen order, first HELP/TYPE kept)."""
    help_lines: Dict[str, str] = {}
    type_lines: Dict[str, str] = {}
    samples: Dict[str, List[str]] = {}
    order: List[str] = []

    def family(fam: str) -> List[str]:
        if fam not in samples:
            samples[fam] = []
            order.append(fam)
        return samples[fam]

    for text in parts:
        for line in text.splitlines():
            if not line:
                continue
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                try:
                    fam = line.split(None, 3)[2]
                except IndexError:
                    continue
                family(fam)
                target = (help_lines if line.startswith("# HELP ")
                          else type_lines)
                target.setdefault(fam, line)
            elif line.startswith("#"):
                continue
            else:
                family(line.split("{", 1)[0].split(" ", 1)[0]).append(line)
    out: List[str] = []
    for fam in order:
        if fam in help_lines:
            out.append(help_lines[fam])
        if fam in type_lines:
            out.append(type_lines[fam])
        out.extend(samples[fam])
    return "\n".join(out) + ("\n" if out else "")


_framework = None
_framework_lock = threading.Lock()


def framework_metrics() -> Dict[str, Metric]:
    """Built-in per-process runtime gauges, registered once per process:
    scheduler backlog, finished-task count, store object count, trace
    spans recorded, watchdog fires, flight events."""
    global _framework
    with _framework_lock:
        if _framework is None:
            _framework = {
                "backlog": Gauge(
                    "ray_tpu_scheduler_backlog",
                    "Queued + running tasks on this runtime's scheduler"),
                "tasks_finished": Gauge(
                    "ray_tpu_tasks_finished",
                    "Tasks finished by this runtime's scheduler"),
                "store_objects": Gauge(
                    "ray_tpu_store_objects",
                    "Objects resident in this runtime's python store"),
                "trace_spans": Gauge(
                    "ray_tpu_trace_spans_recorded",
                    "Spans recorded by this process's tracer "
                    "(0 while tracing is off)"),
                "watchdog_fires": Gauge(
                    "ray_tpu_watchdog_fires",
                    "Watchdog escalations in this process (flight-"
                    "recorder heartbeat-gap/loop-lag/lock-hold/"
                    "task-stuck fires)"),
                "flight_events": Gauge(
                    "ray_tpu_flight_events_recorded",
                    "Events recorded by this process's flight "
                    "recorder (0 while the recorder is off)"),
            }
        return _framework


def refresh_framework_metrics(worker) -> None:
    """Refresh the built-in gauges from a live runtime (never raises).
    Per-gauge-group isolation: ``worker=None`` (no runtime) still
    refreshes the tracing and flight gauges."""
    m = framework_metrics()
    try:
        m["backlog"].set(float(worker.scheduler.backlog_size()))
        m["tasks_finished"].set(
            float(getattr(worker.scheduler, "_num_finished", 0)))
        m["store_objects"].set(
            float(len(getattr(worker.store, "_entries", ()))))
    except Exception:  # noqa: BLE001 — telemetry must not fail callers
        pass
    from ray_tpu_torch._private import flight, tracing

    t = tracing.tracer()
    m["trace_spans"].set(float(t.spans_recorded if t is not None else 0))
    from ray_tpu_torch.util import sanitizer

    rec = flight.recorder()
    # Exactly one counter takes each stall fire (the recorder's when it
    # is armed, the sanitizer's otherwise): the gauge sums the two.
    m["watchdog_fires"].set(float(
        (rec.watchdog_fires if rec is not None else 0)
        + sanitizer.watchdog_fires))
    m["flight_events"].set(
        float(rec.events_recorded if rec is not None else 0))


_server = None
_server_thread = None


def serve_metrics(host: str = "127.0.0.1", port: int = 0):
    """Expose /metrics (a Prometheus scrape endpoint) on a daemon
    thread; ``stop_metrics_server`` shuts it down. Returns (host,
    port)."""
    global _server, _server_thread
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path != "/metrics":
                self.send_response(404)
                self.end_headers()
                return
            body = export_prometheus().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    _server = http.server.ThreadingHTTPServer((host, port), Handler)
    _server_thread = threading.Thread(
        target=_server.serve_forever, daemon=True, name="metrics-exporter")
    _server_thread.start()
    return _server.server_address


def stop_metrics_server():
    global _server, _server_thread
    if _server is not None:
        _server.shutdown()
        _server.server_close()
        _server_thread.join(5.0)
        _server, _server_thread = None, None
