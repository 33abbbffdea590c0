"""Tracing plane (counterpart of ``ray_tpu/_private/tracing.py``, trimmed
to the one-process runtime).

One span ring per process, and trace CONTEXT carried on every hop of a
request, so one request assembles into one trace:

- A :class:`TraceContext` (trace_id, span_id) is minted at the public
  entry points (``.remote()``, Serve handles, the HTTP proxy, the LLM
  engine's ``submit``) and rides with the work: a ``TaskSpec``'s
  ``trace``, an actor call's registered context, Serve's LLM request
  dicts (``_trace``).
- The process records COMPLETED spans into a bounded deque
  (``RAY_TPU_TRACE_MAX_SPANS``), the ring idiom of ``task_events.py``.
  ``util.state.trace_summary()`` and ``ray_tpu_torch.timeline(
  trace_id=...)`` read it.

Off by default. With tracing off the module-global ``_TRACER`` slot is
``None`` and every instrumentation point pays ONE global load and an
``is None`` branch: no span objects, no extra payload keys.
``RAY_TPU_TRACE`` (any truthy value, read at ``init()``) or a call of
:func:`install` arms it.

Worker processes of the process plane, which nothing can dial, append
their finished spans to a spill file in ``RAY_TPU_TRACE_DIR`` (the
hosting runtime points it at its session's ``traces`` directory);
``Tracer.dump`` and ``trace_index`` merge those files. Node daemons
serve their rings to peers (``trace_dump``), and ``timeline`` pulls
every live daemon's.

The cold-start chain: a Serve wake parks its context in the stash, and
a replica constructed meanwhile parents its ``replica.init`` span to it.
A process launched for a traced request (a node daemon) inherits
``RAY_TPU_TRACE_PARENT`` (:func:`encode_cold_start_parent`, with its
expiry in the value) and parents its ``node.init`` span to it
(:func:`cold_start_parent` reads the variable before the stash).
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "TraceContext", "Tracer", "install", "install_from_env", "uninstall",
    "tracer", "active", "new_trace", "begin", "finish", "start_span",
    "event", "inject", "extract", "current_context", "use_context",
    "register_task", "task_context", "on_task_event", "stash_cold_start",
    "take_cold_start", "take_cold_start_timed", "clear_cold_start",
    "cold_start_parent", "encode_cold_start_parent", "local_spans",
    "trace_index", "chrome_trace",
]

ENV_VAR = "RAY_TPU_TRACE"
# Spill directory of worker processes (set by the hosting runtime).
ENV_DIR = "RAY_TPU_TRACE_DIR"
# Node identity a head-attached runtime gives its worker processes.
ENV_NODE = "RAY_TPU_TRACE_NODE"
# Trace context a launched process (a node daemon) parents its init to.
ENV_PARENT = "RAY_TPU_TRACE_PARENT"

# Tracing slot: None = off, every hot-path site guards with one global
# load + `is None` branch.
_TRACER: Optional["Tracer"] = None

# Terminal task states the task-event bridge closes exec spans on.
_TERMINAL = ("FINISHED", "FAILED")

_tls = threading.local()


class TraceContext:
    """One position in a trace: (trace_id, span_id). ``span_id`` is the
    span new children parent to. Wire form: a ``(trace_id, span_id)``
    tuple of hex strings."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def encode(self) -> str:
        return f"{self.trace_id}:{self.span_id}"

    @classmethod
    def decode(cls, s: str) -> Optional["TraceContext"]:
        try:
            trace_id, span_id = s.split(":", 1)
            return cls(trace_id, span_id) if trace_id else None
        except ValueError:
            return None

    def __repr__(self):
        return f"TraceContext({self.trace_id[:8]}…, {self.span_id[:8]}…)"


class _SpanHandle:
    """An OPEN span: children minted while it is ambient parent to it;
    ``finish`` (or context-manager exit) emits the completed record."""

    __slots__ = ("ctx", "name", "t0", "tags", "events", "component",
                 "_prev", "_done")

    def __init__(self, ctx: TraceContext, name: str, tags, component):
        self.ctx = ctx
        self.name = name
        self.t0 = time.time()
        self.tags = tags
        self.events: List[list] = []
        self.component = component
        self._prev = None
        self._done = False

    def event(self, name: str):
        self.events.append([time.time(), str(name)])

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        finish(self, status="error" if exc_type is not None else "ok")
        return False


class Tracer:
    """Per-process span sink: a bounded ring of completed spans, the
    task-id -> context map of the task-event bridge and, in a worker
    process, a spill file."""

    def __init__(self, capacity: int = 65536, component: str = "driver",
                 node: str = "", spill_dir: Optional[str] = None):
        self.component = component
        self.node = node
        self.pid = os.getpid()
        self._spans: "deque[tuple]" = deque(maxlen=max(int(capacity), 16))
        self.spans_recorded = 0
        # Separate locks for the span ring and the task-context map:
        # submit threads register contexts while executor threads emit
        # spans.
        self._lock = threading.Lock()        # span ring
        self._ctx_lock = threading.Lock()    # task-context map
        # task_id bin -> TraceContext, bounded FIFO.
        self._task_ctx: Dict[bytes, TraceContext] = {}
        self._task_order: "deque[bytes]" = deque()
        self._spill_path: Optional[str] = None
        self._spill_file = None
        self._spill_lock = threading.Lock()
        self._spill_cap = self._spans.maxlen
        self._spilled = 0
        if spill_dir:
            try:
                os.makedirs(spill_dir, exist_ok=True)
                self._spill_path = os.path.join(
                    spill_dir,
                    f"spans-{self.pid}-{uuid.uuid4().hex[:8]}.jsonl")
            except OSError:
                self._spill_path = None

    # ------------------------------------------------------------ identity
    def set_identity(self, component: Optional[str] = None,
                     node: Optional[str] = None):
        if component is not None:
            self.component = component
        if node is not None:
            self.node = node

    # -------------------------------------------------------------- record
    # Spans live in the ring as TUPLES (no per-emit dict build);
    # ``_as_dict`` renders them when read.
    def emit(self, trace_id: str, span_id: str, parent_id: str, name: str,
             t0: float, dur: float, status: str = "ok",
             component: Optional[str] = None,
             tags: Optional[Dict[str, Any]] = None,
             events: Optional[List[list]] = None) -> None:
        rec = (trace_id, span_id, parent_id, name, t0,
               dur if dur > 0.0 else 0.0, status,
               component or self.component, tags, events)
        with self._lock:
            self._spans.append(rec)
            self.spans_recorded += 1
        if self._spill_path is not None:
            self._spill(self._as_dict(rec))

    def _spill(self, span: dict):
        """Append one span to the spill file, restarted at the newest
        window once it holds the ring's capacity (bounded on disk as the
        ring is in memory)."""
        line = json.dumps(span) + "\n"
        with self._spill_lock:
            try:
                if self._spill_file is None:
                    self._spill_file = open(  # noqa: SIM115 — long-lived
                        self._spill_path, "a", buffering=1)
                elif self._spilled >= self._spill_cap:
                    self._spill_file.close()
                    self._spill_file = open(  # noqa: SIM115 — long-lived
                        self._spill_path, "w", buffering=1)
                    self._spilled = 0
                self._spill_file.write(line)
                self._spilled += 1
            except OSError:
                self._spill_path = None  # disk gone: ring-only from here

    def close_spill(self):
        with self._spill_lock:
            if self._spill_file is not None:
                self._spill_file.close()
                self._spill_file = None

    def _as_dict(self, rec: tuple) -> dict:
        tags, events = rec[8], rec[9]
        return {
            "trace_id": rec[0],
            "span_id": rec[1],
            "parent_id": rec[2],
            "name": rec[3],
            "t0": float(rec[4]),
            "dur": float(rec[5]),
            "status": rec[6],
            "component": rec[7],
            "pid": self.pid,
            "node": self.node,
            "tags": {str(k): str(v) for k, v in tags.items()}
            if tags else {},
            "events": [[float(ts), str(n)] for ts, n in events]
            if events else [],
        }

    # ---------------------------------------------------------- task bridge
    def register_task(self, tid_bin: bytes, ctx: TraceContext):
        with self._ctx_lock:
            if tid_bin not in self._task_ctx:
                self._task_order.append(tid_bin)
            self._task_ctx[tid_bin] = ctx
            while len(self._task_order) > 65536:
                self._task_ctx.pop(self._task_order.popleft(), None)

    def task_context(self, tid_bin: bytes) -> Optional[TraceContext]:
        with self._ctx_lock:
            return self._task_ctx.get(tid_bin)

    # ---------------------------------------------------------------- read
    def dump(self, trace_id: Optional[str] = None,
             include_dir: bool = True) -> List[dict]:
        """This process's spans, oldest first (of one trace, if given),
        and with ``include_dir`` those its worker processes spilled into
        ``RAY_TPU_TRACE_DIR``."""
        with self._lock:
            recs = list(self._spans)
        if trace_id:
            recs = [r for r in recs if r[0] == trace_id]
        spans = [self._as_dict(r) for r in recs]
        if include_dir:
            extra = _read_spill_dir(os.environ.get(ENV_DIR),
                                    exclude_pid=self.pid)
            if trace_id:
                extra = [s for s in extra
                         if s.get("trace_id") == trace_id]
            spans.extend(extra)
        return spans

    def trace_index(self, include_dir: bool = True) -> Dict[str, dict]:
        """Per-trace aggregates over the ring (and the worker processes'
        spill files): span count, first start, errors, the root span's
        name, processes and components."""
        out: Dict[str, dict] = {}

        def add(tid, t0, status, comp, proc, name, parent):
            rec = out.get(tid)
            if rec is None:
                rec = out[tid] = {
                    "num_spans": 0, "first_t0": t0, "errors": 0,
                    "root": "", "pids": set(), "components": set()}
            rec["num_spans"] += 1
            rec["first_t0"] = min(rec["first_t0"], t0)
            if status == "error":
                rec["errors"] += 1
            if not parent:
                rec["root"] = name
            rec["pids"].add(proc)
            rec["components"].add(comp)

        with self._lock:
            recs = list(self._spans)
        proc = process_key(self.node, self.pid)
        for r in recs:
            add(r[0], float(r[4]), r[6], r[7], proc, r[3], r[2])
        if include_dir:
            for s in _read_spill_dir(os.environ.get(ENV_DIR),
                                     exclude_pid=self.pid):
                add(s.get("trace_id", ""), float(s.get("t0", 0.0)),
                    s.get("status", "ok"), s.get("component", ""),
                    process_key(s.get("node", ""), s.get("pid", 0)),
                    s.get("name", ""), s.get("parent_id", ""))
        for rec in out.values():
            rec["pids"] = sorted(rec["pids"])
            rec["components"] = sorted(rec["components"])
        return out


def process_key(node: str, pid) -> str:
    """Process identity for assembled views (``node:pid``)."""
    return f"{node or ''}:{pid}"


def _read_spill_dir(spill_dir: Optional[str],
                    exclude_pid: Optional[int] = None) -> List[dict]:
    """Spans spilled by worker processes into ``spill_dir``; files this
    process wrote itself are skipped (its ring holds them)."""
    if not spill_dir:
        return []
    out: List[dict] = []
    prefix_self = f"spans-{exclude_pid}-" if exclude_pid else None
    try:
        names = sorted(os.listdir(spill_dir))
    except OSError:
        return []
    for name in names:
        if not name.endswith(".jsonl") or not name.startswith("spans-"):
            continue
        if prefix_self and name.startswith(prefix_self):
            continue
        try:
            with open(os.path.join(spill_dir, name)) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        out.append(json.loads(line))
        except (OSError, ValueError):
            continue  # racing writer mid-line / rotated file
    return out


# ------------------------------------------------------------ installation
_install_lock = threading.Lock()


def _capacity() -> int:
    from ray_tpu_torch._private.config import GlobalConfig

    return int(GlobalConfig.trace_max_spans)


def install(component: str = "driver", node: str = "",
            capacity: Optional[int] = None, spill: bool = False) -> Tracer:
    """Arm tracing process-wide (idempotent: a second install re-labels
    the existing tracer instead of dropping its ring). ``spill=True`` (a
    worker process) also appends finished spans to
    ``RAY_TPU_TRACE_DIR``."""
    global _TRACER
    with _install_lock:
        if _TRACER is not None:
            _TRACER.set_identity(component=component, node=node or None)
            return _TRACER
        _TRACER = Tracer(
            capacity=capacity if capacity is not None else _capacity(),
            component=component, node=node,
            spill_dir=os.environ.get(ENV_DIR) if spill else None)
        return _TRACER


def install_from_env(component: str = "driver",
                     spill: bool = False) -> Optional[Tracer]:
    raw = (os.environ.get(ENV_VAR) or "").strip().lower()
    if not raw or raw in ("0", "false", "off"):
        return None
    return install(component=component,
                   node=os.environ.get(ENV_NODE, ""), spill=spill)


def uninstall() -> None:
    global _TRACER, _cold_start_ctx
    with _install_lock:
        t, _TRACER = _TRACER, None
    if t is not None:
        t.close_spill()
    with _cold_start_lock:
        _cold_start_ctx = None


def tracer() -> Optional[Tracer]:
    return _TRACER


def active() -> bool:
    return _TRACER is not None


# ------------------------------------------------------------- span API
# Span ids are (random per-process prefix) + (counter): unique w.h.p. at
# ~50 ns per id.
_ID_PREFIX = os.urandom(4).hex()
_ids = itertools.count(1)


def _new_id() -> str:
    return f"{_ID_PREFIX}{next(_ids):08x}"


def new_trace() -> Optional[TraceContext]:
    if _TRACER is None:
        return None
    return TraceContext(uuid.uuid4().hex, "")


def current_context() -> Optional[TraceContext]:
    if _TRACER is None:
        return None
    return getattr(_tls, "ctx", None)


class use_context:
    """Make ``ctx`` the ambient parent for this thread (no-op when
    tracing is off or ``ctx`` is None)."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx
        self._prev = None

    def __enter__(self):
        if _TRACER is not None and self._ctx is not None:
            self._prev = getattr(_tls, "ctx", None)
            _tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        if _TRACER is not None and self._ctx is not None:
            _tls.ctx = self._prev
        return False


def begin(name: str, parent: Optional[TraceContext] = None,
          component: Optional[str] = None,
          **tags) -> Optional[_SpanHandle]:
    """Open a span (ambient parent unless ``parent`` given; a fresh
    trace when neither exists) and make it the thread's ambient
    context. Returns None when tracing is off; ``finish`` accepts None,
    so call sites stay branch-free."""
    t = _TRACER
    if t is None:
        return None
    if parent is None:
        parent = getattr(_tls, "ctx", None)
    if parent is None:
        ctx = TraceContext(uuid.uuid4().hex, _new_id())
        parent_id = ""
    else:
        ctx = TraceContext(parent.trace_id, _new_id())
        parent_id = parent.span_id
    handle = _SpanHandle(ctx, name, dict(tags), component)
    handle.tags["_parent"] = parent_id  # carried to finish
    handle._prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return handle


def finish(handle: Optional[_SpanHandle], status: str = "ok",
           **tags) -> None:
    t = _TRACER
    if t is None or handle is None or handle._done:
        return
    handle._done = True
    _tls.ctx = handle._prev
    all_tags = dict(handle.tags)
    parent_id = all_tags.pop("_parent", "")
    all_tags.update(tags)
    t.emit(handle.ctx.trace_id, handle.ctx.span_id, parent_id,
           handle.name, handle.t0, time.time() - handle.t0,
           status=status, component=handle.component, tags=all_tags,
           events=handle.events)


def start_span(name: str, parent: Optional[TraceContext] = None,
               **tags):
    """Context-manager span: ``with tracing.start_span("x") as s: ...``
    (``s`` is None when tracing is off)."""
    handle = begin(name, parent=parent, **tags)
    if handle is None:
        return _NULL_SPAN
    return handle


class _NullSpan:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def event(name: str, ctx: Optional[TraceContext] = None,
          component: Optional[str] = None, **tags) -> None:
    """A point-in-time record: a zero-duration span under ``ctx`` (or
    the ambient context). Dropped without a context."""
    t = _TRACER
    if t is None:
        return
    if ctx is None:
        ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return
    t.emit(ctx.trace_id, _new_id(), ctx.span_id, name, time.time(), 0.0,
           component=component, tags=tags)


# --------------------------------------------------------------- wire form
def inject(ctx: Optional[TraceContext] = None
           ) -> Optional[Tuple[str, str]]:
    """Wire form of a context: ``(trace_id, span_id)`` or None when
    tracing is off or no context exists. Payload builders add a key only
    on a non-None return: off means no extra key."""
    if _TRACER is None:
        return None
    if ctx is None:
        ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return None
    return (ctx.trace_id, ctx.span_id)


def extract(wire: Any) -> Optional[TraceContext]:
    """Inverse of :func:`inject`; tolerant of lists and byte strings.
    None when tracing is off."""
    if _TRACER is None or wire is None:
        return None
    try:
        trace_id, span_id = wire
        if isinstance(trace_id, bytes):
            trace_id = trace_id.decode()
        if isinstance(span_id, bytes):
            span_id = span_id.decode()
        return TraceContext(str(trace_id), str(span_id))
    except (TypeError, ValueError):
        return None


# ------------------------------------------------------- task-event bridge
def register_task(tid_bin: bytes, wire_or_ctx: Any) -> None:
    """Associate a task id with a trace context so the task-event
    bridge (scheduler and actor state transitions) emits spans for it."""
    t = _TRACER
    if t is None or wire_or_ctx is None:
        return
    ctx = wire_or_ctx if isinstance(wire_or_ctx, TraceContext) \
        else extract(wire_or_ctx)
    if ctx is not None:
        t.register_task(bytes(tid_bin), ctx)


def task_context(tid_bin: bytes) -> Optional[TraceContext]:
    t = _TRACER
    if t is None:
        return None
    return t.task_context(bytes(tid_bin))


def on_task_event(task_id, state: str, name: str, prev) -> None:
    """Called by ``TaskEventBuffer.record`` (under no lock) for task
    state transitions. Entry into RUNNING closes a ``task.queue`` span
    (time spent pending) and a terminal state closes ``task.exec``, so a
    traced task costs two emits, not one per bookkeeping state."""
    t = _TRACER
    if t is None:
        return
    emit_queue = state == "RUNNING" and prev is not None
    emit_exec = state in _TERMINAL
    if not (emit_queue or emit_exec):
        return
    try:
        tid_bin = task_id.binary()
    except AttributeError:
        return
    ctx = t.task_context(tid_bin)
    if ctx is None:
        return
    now = time.time()
    if emit_queue:
        t.emit(ctx.trace_id, _new_id(), ctx.span_id, "task.queue",
               prev.timestamp, now - prev.timestamp,
               tags={"task": name})
        return
    if prev is None:
        # Bare terminal record (no prior state in this buffer): a
        # zero-duration marker still shows the completion happened.
        t.emit(ctx.trace_id, _new_id(), ctx.span_id,
               f"task.{state.lower()}", now, 0.0, tags={"task": name})
        return
    status = "error" if state == "FAILED" else "ok"
    t.emit(ctx.trace_id, _new_id(), ctx.span_id, "task.exec",
           prev.timestamp, now - prev.timestamp, status=status,
           tags={"task": name})


# ------------------------------------------------------- cold-start chain
# One-slot stash: the thread that discovers missing capacity (a Serve
# wake) parks its context here; a replica constructed meanwhile parents
# its init span to it.
_cold_start_lock = threading.Lock()
_cold_start_ctx: Optional[Tuple[TraceContext, float]] = None


def _cold_start_window_s() -> float:
    from ray_tpu_torch._private.config import GlobalConfig

    return float(GlobalConfig.trace_cold_start_window_s)


def stash_cold_start(ctx: Optional[TraceContext] = None,
                     deadline: Optional[float] = None) -> None:
    """Park ``ctx`` (or the ambient context). ``deadline`` (monotonic)
    lets a caller re-park a context it took without resetting the expiry
    window."""
    global _cold_start_ctx
    if _TRACER is None:
        return
    if ctx is None:
        ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return
    if deadline is None:
        deadline = time.monotonic() + _cold_start_window_s()
    with _cold_start_lock:
        _cold_start_ctx = (ctx, deadline)


def clear_cold_start(ctx: Optional[TraceContext]) -> None:
    """Drop the stash iff it still holds ``ctx``'s trace: the waker's
    exit path, so a later unrelated replica start inside the window does
    not adopt a finished context."""
    global _cold_start_ctx
    if _TRACER is None or ctx is None:
        return
    with _cold_start_lock:
        if (_cold_start_ctx is not None
                and _cold_start_ctx[0].trace_id == ctx.trace_id):
            _cold_start_ctx = None


def take_cold_start() -> Optional[TraceContext]:
    entry = take_cold_start_timed()
    return entry[0] if entry else None


def take_cold_start_timed() -> Optional[Tuple[TraceContext, float]]:
    """:func:`take_cold_start` plus the stash deadline, for callers that
    may re-park the context (pass the deadline back to
    :func:`stash_cold_start`)."""
    global _cold_start_ctx
    if _TRACER is None:
        return None
    with _cold_start_lock:
        stashed, _cold_start_ctx = _cold_start_ctx, None
    if stashed is None:
        return None
    ctx, deadline = stashed
    if time.monotonic() > deadline:
        return None
    return (ctx, deadline)


def encode_cold_start_parent(ctx: TraceContext) -> str:
    """``RAY_TPU_TRACE_PARENT``'s value for a process launched for
    ``ctx``: ``trace_id:span_id:expires_epoch``. The expiry rides the
    value, since environment copies outlive the launch."""
    return (f"{ctx.trace_id}:{ctx.span_id}:"
            f"{time.time() + _cold_start_window_s():.0f}")


def cold_start_parent() -> Optional[TraceContext]:
    """The context an init span parents to: the one a parent process
    put in ``RAY_TPU_TRACE_PARENT`` (None past its baked-in expiry), else
    the stash, read without taking it (several replicas of one wake
    share it), or None past its window."""
    if _TRACER is None:
        return None
    raw = os.environ.get(ENV_PARENT, "")
    if raw:
        parts = raw.split(":")
        if len(parts) >= 3:
            try:
                if time.time() > float(parts[2]):
                    return None
            except ValueError:
                pass
            return TraceContext(parts[0], parts[1]) if parts[0] else None
        return TraceContext.decode(raw)
    with _cold_start_lock:
        stashed = _cold_start_ctx
    if stashed is None or time.monotonic() > stashed[1]:
        return None
    return stashed[0]


# ----------------------------------------------------------------- reading
def local_spans(trace_id: Optional[str] = None) -> List[dict]:
    t = _TRACER
    if t is None:
        return []
    return t.dump(trace_id=trace_id)


def trace_index() -> Dict[str, dict]:
    t = _TRACER
    if t is None:
        return {}
    return t.trace_index()


def chrome_trace(spans: List[dict]) -> List[dict]:
    """Chrome-tracing JSON (``chrome://tracing`` / Perfetto): one "X"
    event per span, grouped by process (pid) and component."""
    out = []
    for s in spans:
        out.append({
            "name": s["name"],
            "cat": s.get("component", "span"),
            "ph": "X",
            "ts": s["t0"] * 1e6,
            "dur": max(s["dur"] * 1e6, 1.0),
            "pid": s.get("pid", 0),
            "tid": s.get("component", ""),
            "args": {
                "trace_id": s["trace_id"],
                "span_id": s["span_id"],
                "parent_id": s.get("parent_id", ""),
                "status": s.get("status", "ok"),
                "node": s.get("node", ""),
                **s.get("tags", {}),
            },
        })
        for ts, name in s.get("events", []):
            out.append({
                "name": name, "cat": "event", "ph": "i",
                "ts": ts * 1e6, "pid": s.get("pid", 0),
                "tid": s.get("component", ""), "s": "p",
                "args": {"trace_id": s["trace_id"]},
            })
    return out
