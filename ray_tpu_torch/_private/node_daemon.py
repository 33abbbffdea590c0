"""Node daemon: joins this machine's runtime to a head service
(counterpart of ``ray_tpu/_private/node_daemon.py``).

Run it as::

    python -m ray_tpu_torch._private.node_daemon --address H:P \
        --num-cpus N --resources '{"feed": 1}' --worker-mode thread|process

It prints ``ray_tpu_torch node <id> joined H:P as <client>`` once it has
registered. The daemon:

- boots a full local runtime (``init(address=...)``: object store,
  scheduler and, on the process plane, the worker pool), minus any
  application code;
- registers its node id and resources with the head's membership and
  heartbeats its backlog, so routers spill to the least loaded node;
- serves ``task_push`` on two planes: the driver-dialled direct plane
  (this node's object server) and the head relay. A pushed task's ref
  args are resolved through their owner (``owner_resolver``: a
  peer-to-peer pull from the node holding the bytes, waiting out
  pending pull refs whose producer still runs), it runs on the local
  scheduler, and its completion is reported (``task_done``, coalesced
  per driver by one reporter thread) with its result sizes, its errors
  and its small results inline; larger results stay here until pulled;
- caches pushed functions by content digest (``need_fn`` when a digest
  is unknown), takes pre-shipped ones, serves stream acks and cancels,
  ``trace_dump``, ``metrics_dump``, ``debug_dump`` and ``flight_ctl``,
  drains on ``node_drain`` (cordon, finish, hand the results back to
  their owners) and re-joins a promoted head after a failover;
- hosts actors placed here (``remote_actor.ActorHost``).

**The card.** The daemon advertises ``GPU``: the count of CUDA cards its
process sees (``worker._count_gpus``, the counterpart of the
reference's TPU count), taken without creating a CUDA context. A daemon
started with ``CUDA_VISIBLE_DEVICES=""`` advertises none. With
``--worker-mode thread`` its tasks and actors run in the daemon's own
process, which can own ``cuda:0``; with ``--worker-mode process`` they
run in worker processes, which never see the card.

Kill it with SIGKILL and the head's heartbeat monitor declares the node
dead; drivers reroute its in-flight work and re-execute lost results
from lineage.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict

from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.log import get_logger
from ray_tpu_torch._private.scheduler import TaskSpec
from ray_tpu_torch._private import tracing
from ray_tpu_torch.runtime_env import coerce_runtime_env

log = get_logger(__name__)

# Results and streamed items at or under this size ride their completion
# report to the owner; larger ones stay here until pulled.
INLINE_MAX_BYTES = 100 * 1024


def completion_fields(store, return_ids: list, name: str):
    """(sizes, errs, inline) for one finished task's results — the done
    payload's directory inputs, shared by the task plane and the actor
    host: sizes feed locality scoring, ERRORS cross as pickled
    exceptions (no pullable bytes exist for them), and SMALL RESULTS
    ride inline (<= inline_object_max_bytes — the reference's
    small-return-to-owner path)."""
    sizes: Dict[bytes, int] = {}
    errs: Dict[bytes, bytes] = {}
    inline: Dict[bytes, bytes] = {}
    inline_cap = INLINE_MAX_BYTES
    for oid in return_ids:
        ob = oid.binary()
        err = store.peek_error(oid)
        if err is not None:
            try:
                errs[ob] = pickle.dumps(err, protocol=5)
            except Exception:  # noqa: BLE001 — unpicklable error
                from ray_tpu_torch.exceptions import RayTaskError

                errs[ob] = pickle.dumps(
                    RayTaskError(name, repr(err)), protocol=5)
        else:
            size = store.size_of(oid)
            sizes[ob] = size
            # Resident-only: inlining a SPILLED result would pay a
            # synchronous disk restore on the (single) reporter thread,
            # stalling every other completion behind it — spilled bytes
            # move on the pull path instead.
            if size <= inline_cap and store.holds_in_memory(oid):
                try:
                    inline[ob] = store.get(oid, timeout=5.0).to_bytes()
                except Exception:  # noqa: BLE001 — racing eviction
                    pass
    return sizes, errs, inline


def prefetch_serialized(pull_fn: Callable[[bytes], Any], oid_bins: list,
                        pool: ThreadPoolExecutor) -> Dict[bytes, Any]:
    """Pull many objects' serialized bytes CONCURRENTLY (pipelined
    argument prefetch): every pull starts before any finishes, so a
    task's dispatch overlaps its transfers instead of serializing
    behind them. Returns {oid_bin: raw_or_None}; a pull that raised
    maps to its exception (the caller decides per-arg)."""
    futures = {ob: pool.submit(pull_fn, ob) for ob in dict.fromkeys(oid_bins)}
    out: Dict[bytes, Any] = {}
    for ob, fut in futures.items():
        try:
            out[ob] = fut.result()
        except BaseException as exc:  # noqa: BLE001 — per-arg failure
            out[ob] = exc
    return out


class NodeDaemon:
    def __init__(self, address: str, num_cpus: int = 2,
                 resources: Dict[str, float] | None = None,
                 worker_mode: str | None = None):
        import time as _time

        import ray_tpu_torch
        from ray_tpu_torch._private.worker import global_worker

        init_t0 = _time.time()
        ray_tpu_torch.init(num_cpus=num_cpus, resources=resources,
                     worker_mode=worker_mode, address=address)
        self.worker = global_worker()
        self.head = self.worker.head_client
        # Cold-start chain: a node launched FOR a traced request carries
        # RAY_TPU_TRACE_PARENT — its init (runtime boot → registration)
        # becomes a span in that trace, and the join context rides the
        # node_register RPC so the head records its half.
        tracer = tracing.tracer()
        self._join_trace = None
        # The launch context is only meaningful for THIS cold start:
        # once the window passes, drop it from our environment so
        # worker processes spawned for later, unrelated scale-ups
        # don't parent their replica.init into a long-finished trace.
        self._trace_parent_expire = (
            _time.monotonic() + GlobalConfig.trace_cold_start_window_s)
        if tracer is not None:
            tracer.set_identity(component="node",
                                node=self.head.client_id)
            # Spawned worker processes inherit this node identity so
            # their spilled spans carry a cluster-unique process key.
            os.environ[tracing.ENV_NODE] = self.head.client_id
            parent = tracing.cold_start_parent()
            if parent is not None:
                span = tracing.begin("node.init", parent=parent,
                                     component="node")
                span.t0 = init_t0  # covers the runtime boot too
                self._join_trace = tracing.inject(span.ctx)
                self._init_span = span
            else:
                self._init_span = None
        else:
            self._init_span = None
        self.head.handlers["task_push"] = self._on_task_push
        # Direct plane: drivers dial this node's request server and push
        # task batches peer-to-peer (one vectored write per batch); the
        # head relay above stays as the NAT/dial-failure fallback.
        self.head._object_server.handlers["task_push"] = \
            self._on_direct_task_push
        # Drain-before-reap (autoscaler -> head relay -> here, with a
        # direct-plane twin): cordon, finish in-flight work, lease-
        # transfer held result bytes, then report back so the reaper
        # may terminate this process without stranding a borrowed ref.
        self.head.handlers["node_drain"] = self._on_node_drain
        self.head._object_server.handlers["node_drain"] = \
            self._on_node_drain
        # Function-cache pre-ship: a driver that sees this node join
        # pushes its hot function bytes ahead of the first task, so the
        # cold node's first fan-out wave skips the need_fn round trip.
        self.head._object_server.handlers["fn_preship"] = \
            self._on_fn_preship
        # Streaming-generator control plane: consumption acks resume a
        # backpressure-paused producer, cancels stop it between yields.
        # Direct messages from the consuming driver; the pub/sub topic
        # ``stream|<this client>`` is the head-relayed fallback.
        self.head._object_server.handlers["stream_ack"] = self._on_stream_ack
        self.head._object_server.handlers["stream_cancel"] = \
            self._on_stream_cancel
        try:
            self.head.subscribe(f"stream|{self.head.client_id}",
                                self._on_stream_pub)
        except Exception:  # noqa: BLE001 — direct plane still works
            pass
        self.head.status_fn = self._status
        # Cluster actor plane: host actors placed here by remote drivers
        # (direct actor_op requests + head-relayed actor_push fallback).
        from ray_tpu_torch._private.remote_actor import ActorHost

        # Created before ActorHost registers its handlers: an actor op
        # can arrive the moment node_register lands, and its owner
        # callback writes these.
        self._seen_lock = threading.Lock()
        self._last_owner: tuple | None = None  # (addr, driver_id)
        self.actor_host = ActorHost(self.worker, self.head,
                                    on_owner_seen=self._note_owner)
        self.head.node_register(
            self.worker.node_id.hex(), self.worker.resource_pool.total,
            trace=self._join_trace)
        # Head failover: when the client observes a promoted head
        # (epoch bump), re-join — the promoted head replayed membership
        # from the shared log, but a register lost in the dead
        # primary's torn tail (or a log-less head) reconciles here, and
        # the re-join refreshes peer_addr/status ahead of the next
        # heartbeat.
        self.head.failover_callbacks.append(self._on_head_failover)
        if self._init_span is not None:
            tracing.finish(self._init_span)
            self._init_span = None
        # Observability pull plane: peers/state clients dump this node's
        # span ring (+ its worker processes' spilled spans) and its
        # metrics registry — served on the direct object server with a
        # head-relayed twin, zero steady-state cost.
        self.head._object_server.handlers["trace_dump"] = self._on_trace_dump
        self.head.handlers["trace_dump"] = self._on_trace_dump
        self.head._object_server.handlers["metrics_dump"] = \
            self._on_metrics_dump
        self.head.handlers["metrics_dump"] = self._on_metrics_dump
        # Flight-recorder pull plane (same topology): debug_dump ships
        # this node's bundle (+ its worker processes' spilled bundles),
        # flight_ctl toggles the stack sampler live (the bench A/B and
        # operators arm cluster-wide profiling without restarts).
        from ray_tpu_torch._private import flight as _flight

        rec = _flight.recorder()
        if rec is not None:
            rec.set_identity(component="node", node=self.head.client_id)
            os.environ[_flight.ENV_NODE] = self.head.client_id
            rec.add_section("node", self._flight_node_section)
        self.head._object_server.handlers["debug_dump"] = \
            self._on_debug_dump
        self.head.handlers["debug_dump"] = self._on_debug_dump
        self.head._object_server.handlers["flight_ctl"] = \
            self._on_flight_ctl
        self.head.handlers["flight_ctl"] = self._on_flight_ctl
        # Bounded pools replace the old thread-per-pushed-task model:
        # _intake unpacks + prefetches args + submits; _pulls runs the
        # concurrent argument pulls; _reporter ships task_done RPCs
        # (which coalesce into batch frames at the head client).
        self._intake = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="ray_tpu_node_intake")
        self._pulls = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="ray_tpu_node_pull")
        # Wait plane for tasks gated on async-shipped (still-pending)
        # dependencies: wide enough that waiters rarely queue, bounded
        # so a flood cannot spawn unbounded threads. Dep-free tasks
        # (every producer) always flow through _intake, so a consumer
        # here can never starve the producer it waits for.
        self._gated = ThreadPoolExecutor(
            max_workers=64, thread_name_prefix="ray_tpu_node_gated")
        # Recently accepted task ids (exactly-once across ambiguous
        # push-retry windows).
        from collections import deque as _deque

        self._seen_tasks: set = set()
        self._seen_order: "_deque" = _deque()
        # Streaming tasks whose commit listener is already installed
        # (a replayed push must not double-report items).
        self._streaming_wired: set = set()
        # Streaming tasks this node already finished AND cleaned up:
        # late consumption acks for them must not recreate StreamStates
        # (bounded like _seen_tasks).
        self._stream_done: set = set()
        self._stream_done_order: "_deque" = _deque()
        # StreamStates created by an ack that arrived BEFORE any push for
        # the task (the driver's post-accept watermark can race ahead, or
        # the task rerouted to another node after acks were already sent
        # here): bounded LRU so misrouted acks can't grow streams forever.
        self._ack_created_order: "_deque" = _deque()
        # Completion reports coalesce: one reporter thread drains every
        # finish that accumulated while the previous flush was on the
        # wire into ONE announce flight + ONE vectored task_done batch
        # per driver (flush-on-idle — same shape as the push plane).
        from collections import deque

        self._stop = threading.Event()
        self._report_q: "deque" = deque()
        self._report_cv = threading.Condition()
        self._reporter = threading.Thread(
            target=self._report_loop, daemon=True,
            name="ray_tpu_node_done")
        self._reporter.start()
        # Pushed-function cache, keyed by content digest: a fan-out ships
        # the SAME function bytes ONCE per node; every later payload
        # carries only the digest. Byte-capped LRU (pickle size as the
        # weight proxy) so many distinct functions with fat closures
        # can't pin unbounded memory; an evicted digest answers
        # ``need_fn`` and the driver reships.
        from collections import OrderedDict

        self._fn_cache: "OrderedDict[bytes, tuple]" = OrderedDict()
        self._fn_cache_bytes = 0
        self._fn_cache_cap = 64 << 20
        self._fn_lock = threading.Lock()
        self.fn_bytes_received = 0  # bench counter: cache effectiveness
        # Ownership-directory counters: completion batches delivered
        # owner-direct (zero head object traffic) vs. locations the
        # relay fallback had to announce to the head.
        self.direct_report_batches = 0
        self.announce_fallback_oids = 0
        # Drain-before-reap state: once draining, every new push is
        # refused typed ("draining") and the driver reroutes — a node
        # chosen for reap must never accept work it will not report.
        # _result_owner maps node-held result oids -> (driver_id,
        # driver_addr) so drain can lease-transfer each object's bytes
        # back to its owner (bounded FIFO like _seen_tasks; evicted
        # entries fall back to lineage on reap, same as a crash).
        self._draining = False
        self._result_owner: Dict[bytes, tuple] = {}
        self._result_owner_order: "_deque" = _deque()
        self.drain_refusals = 0
        self.drain_transferred = 0
        self.drain_untransferred = 0
        self.fn_preshipped = 0  # functions registered ahead of any push
        # Task-event shipping cursor: the reporter piggybacks this
        # node's ring (events recorded since the last flush) onto its
        # coalesced completion batches — the driver's state API sees
        # cluster tasks with ZERO new steady-state head RPCs.
        self._events_cursor = 0
        self.events_shipped = 0

    def _on_head_failover(self, old_epoch: int, new_epoch: int):
        """Re-join announcement for the promoted head (reconciles the
        replayed membership — idempotent on the head side)."""
        try:
            self.head.node_register(self.worker.node_id.hex(),
                                    self.worker.resource_pool.total)
            log.warning("re-registered with promoted head (epoch %d -> "
                        "%d)", old_epoch, new_epoch)
        except Exception as exc:  # noqa: BLE001 — next failover retries;
            # the log-replayed membership entry still covers us.
            log.warning("node re-register after head failover failed "
                        "(log-replayed membership still covers this "
                        "node): %r", exc)

    def _note_owner(self, addr: tuple, driver_id):
        """Remember the last driver this node reported to (set from
        task completions AND actor ops): tail task events whose
        terminal record landed after the final completion flush ship
        to it on the next heartbeat tick — direct plane, zero head
        RPCs."""
        with self._seen_lock:
            self._last_owner = (addr, driver_id)

    # ------------------------------------------------------ observability
    def _on_trace_dump(self, msg: tuple):
        """This node's span ring + its worker processes' spilled spans,
        optionally filtered to one trace id (hex str, '' = all). A
        truthy third element asks for the per-trace INDEX instead of
        full spans (O(traces) on the wire, the /api/traces listing)."""
        trace_id = None
        if len(msg) > 1 and msg[1]:
            trace_id = msg[1].decode() if isinstance(msg[1], bytes) \
                else str(msg[1])
        t = tracing.tracer()
        if len(msg) > 2 and msg[2]:
            return t.trace_index() if t is not None else {}
        return t.dump(trace_id=trace_id) if t is not None else []

    def _on_metrics_dump(self, msg: tuple):
        """This process's metrics registry in Prometheus text form; the
        scraping side re-labels every sample with node/component tags."""
        from ray_tpu_torch.util.metrics import (
            export_prometheus,
            refresh_framework_metrics,
        )

        refresh_framework_metrics(self.worker)
        return export_prometheus()

    def _on_debug_dump(self, msg: tuple):
        """This node's flight bundle: all-thread stacks, event ring,
        profile aggregate, metrics/chaos snapshots, runtime sections —
        plus the newest spilled bundle from every worker process this
        daemon hosts (they have no dialable server of their own).
        ``{}`` when the recorder is disarmed (the puller skips us)."""
        from ray_tpu_torch._private import flight as _flight
        from ray_tpu_torch.util.metrics import refresh_framework_metrics

        if not _flight.active():
            return {}
        refresh_framework_metrics(self.worker)
        return _flight.local_bundle(include_dir=True) or {}

    def _on_flight_ctl(self, msg: tuple):
        """Live flight-recorder control: ("flight_ctl", "profile", 0|1)
        pauses/resumes this node's stack sampler. Returns a dict (so a
        successful pause — running False — still reads as a truthy
        ANSWER, distinguishable from an unreachable node)."""
        from ray_tpu_torch._private import flight as _flight

        if len(msg) > 2 and msg[1] in ("profile", b"profile"):
            return {"running": bool(_flight.set_profiling(bool(msg[2])))}
        return {"running": False}

    def _flight_node_section(self) -> dict:
        """Node-plane depths for the flight bundle: what this daemon
        was doing (accept/report/drain state) when the dump landed."""
        return {
            "draining": self._draining,
            "drain_refusals": self.drain_refusals,
            "drain_transferred": self.drain_transferred,
            "seen_tasks": len(self._seen_tasks),
            "report_queue": len(self._report_q),
            "fn_cache_bytes": self._fn_cache_bytes,
            "direct_report_batches": self.direct_report_batches,
            "announce_fallback_oids": self.announce_fallback_oids,
            "events_shipped": self.events_shipped,
        }

    # -------------------------------------------------------- function cache
    def _register_fn(self, fn_bytes: bytes) -> bytes:
        """Digest + cache one pushed function's bytes (deserialization is
        deferred to first use). Returns the digest."""
        import hashlib

        key = hashlib.sha256(fn_bytes).digest()
        with self._fn_lock:
            hit = self._fn_cache.get(key)
            if hit is not None:
                self._fn_cache.move_to_end(key)
                return key
            self.fn_bytes_received += len(fn_bytes)
            self._fn_cache[key] = (None, bytes(fn_bytes))
            self._fn_cache_bytes += len(fn_bytes)
            while self._fn_cache_bytes > self._fn_cache_cap \
                    and len(self._fn_cache) > 1:
                _, (_, stale) = self._fn_cache.popitem(last=False)
                self._fn_cache_bytes -= len(stale)
        return key

    def _fn_bytes_for(self, digest: bytes):
        with self._fn_lock:
            hit = self._fn_cache.get(bytes(digest))
            return hit[1] if hit is not None else None

    def _load_fn(self, digest: bytes, fallback_bytes=None):
        """Function for a digest: cache first, else the bytes pinned to
        the task at accept time (an eviction between accept and start
        must not fail a task the node already said 'accepted' to)."""
        import cloudpickle

        key = bytes(digest)
        with self._fn_lock:
            hit = self._fn_cache.get(key)
            if hit is not None:
                self._fn_cache.move_to_end(key)
                fn, fn_bytes = hit
                if fn is not None:
                    return fn
            elif fallback_bytes is None:
                raise KeyError(
                    f"function digest {key.hex()[:16]}… is not cached on "
                    f"this node (evicted between accept and start) and "
                    f"the task carried no pinned bytes")
            else:
                fn_bytes = fallback_bytes
        fn = cloudpickle.loads(fn_bytes)
        with self._fn_lock:
            if key in self._fn_cache:
                self._fn_cache[key] = (fn, fn_bytes)
        return fn

    # ------------------------------------------------------- streaming ctl
    def _on_stream_ack(self, msg: tuple):
        """Consumption watermark from the consuming driver: wakes the
        producer's paused yield loop (thread plane via the stream cv;
        process plane via the pump's ack-channel forwarding). The state
        is CREATED if absent — the post-accept watermark re-send of a
        replayed task can beat _start_task's stream wiring, and a
        dropped ack there would park the replay at the backpressure
        budget forever; _start_task's get_or_create then shares this
        instance. Only acks for already-finished streams are ignored."""
        tid = TaskID(bytes(msg[1]))
        with self._seen_lock:
            done = tid in self._stream_done
        if not done:
            st = self.worker.streams.get(tid)
            if st is None:
                st = self.worker.streams.get_or_create(tid)
                with self._seen_lock:
                    if tid not in self._streaming_wired:
                        # No push for this task has landed here (yet, or
                        # ever — it may have rerouted): keep the orphan
                        # pool bounded. Eviction re-checks wiredness so a
                        # stream the push later claims is never dropped.
                        self._ack_created_order.append(tid)
                        while len(self._ack_created_order) > 4096:
                            old = self._ack_created_order.popleft()
                            if old not in self._streaming_wired:
                                self.worker.streams.pop(old)
            st.advance_consumed(int(msg[2]))
        return None

    def _on_stream_cancel(self, msg: tuple):
        tid = TaskID(bytes(msg[1]))
        st = self.worker.streams.get(tid)
        if st is not None:
            st.cancel()
        self.worker.scheduler.cancel(tid)
        return None

    def _on_stream_pub(self, payload):
        """Head-relayed fallback for stream control messages."""
        try:
            kind = payload[0]
            if kind == "ack":
                self._on_stream_ack((kind, payload[1], payload[2]))
            elif kind == "cancel":
                self._on_stream_cancel((kind, payload[1]))
        except Exception:  # noqa: BLE001 — keep the event thread alive
            pass

    def _status(self) -> dict:
        from ray_tpu_torch.util.metrics import refresh_framework_metrics

        # Heartbeat-rate refresh of the built-in gauges: every node's
        # metrics_dump always carries current series for the cluster
        # scrape to tag.
        refresh_framework_metrics(self.worker)
        if tracing.ENV_PARENT in os.environ \
                and time.monotonic() > self._trace_parent_expire:
            os.environ.pop(tracing.ENV_PARENT, None)
        if self._last_owner is not None and \
                self.worker.task_events.latest_seq() > self._events_cursor:
            # Tail task events with no completion flush to ride (the
            # terminal record can land after the last report went out):
            # nudge the reporter to ship them direct. Owner-gated so a
            # node nobody has reported to yet doesn't wake its reporter
            # every heartbeat for events it cannot ship.
            with self._report_cv:
                self._report_q.append(("events",))
                self._report_cv.notify()
        hosted = sum(1 for a in self.worker.actors.values()
                     if not getattr(a, "borrower", False))
        router = self.worker.remote_router
        return {
            "backlog": self.worker.scheduler.backlog_size(),
            "available": self.worker.resource_pool.available(),
            "actors": hosted,  # borrowed handles are not load
            "unmet": router.unmet_shapes() if router is not None else [],
            # Cordon marker: routers skip draining nodes for NEW
            # placements (the typed push refusal covers the heartbeat
            # staleness window).
            "draining": self._draining,
        }

    # ----------------------------------------------------------- task serve
    def _on_task_push(self, event: tuple):
        return self._accept_payload(event[1])

    def _on_direct_task_push(self, msg: tuple):
        return self._accept_payload(msg[1])

    def _accept_payload(self, payload_bytes):
        """Admission for one pushed task (either plane). The function
        cache is settled synchronously HERE — before the ``accepted``
        reply — so a driver that marks a digest as shipped can never
        race a not-yet-registered cache entry."""
        if self._draining:
            # Reap race: this node was chosen for reap while the push
            # was in flight. Refuse-and-reroute (typed, counted) — an
            # accepted task would execute into a terminating process
            # and its completion report would never land.
            with self._seen_lock:
                self.drain_refusals += 1
            return "draining"
        payload = pickle.loads(bytes(payload_bytes))
        if tracing._TRACER is not None and payload.get("trace") is not None:
            # submit→accept hop: register the context (one extract, one
            # lock) so the scheduler's task-event bridge emits this
            # task's queue/exec spans, and stamp the arrival.
            ctx = tracing.extract(payload["trace"])
            if ctx is not None:
                tracing.register_task(bytes(payload["task_id"]), ctx)
                tracing.event("task.accept", ctx=ctx, component="node",
                              task=payload.get("name", ""))
        fn_bytes = payload.get("fn")
        digest = payload.get("fn_digest")
        if fn_bytes:
            digest = payload["fn_digest"] = self._register_fn(fn_bytes)
            payload["fn"] = None  # cached; drop the heavy reference
        else:
            # ONE locked lookup settles presence AND pins the bytes to
            # this task — a concurrent eviction between a separate
            # membership check and the pin would fail a task the node
            # already answered "accepted" for.
            fn_bytes = self._fn_bytes_for(digest) if digest else None
            if fn_bytes is None:
                return "need_fn"  # evicted/restarted: driver reships
        # Pinned: an LRU eviction between accept and start cannot fail
        # the task (the bytes ride the queued payload).
        payload["_fn_bytes"] = fn_bytes
        # Exactly-once across the ambiguous-failure window: a direct
        # push whose connection died after the send may be resent
        # verbatim via the head relay — the task already runs here, so
        # a repeated (task_id, push_id) is acknowledged without
        # re-submitting (side effects must not double). Deliberate
        # re-pushes (lineage re-execution, need_fn reships) carry a
        # FRESH push_id and are admitted; need_fn refusals never enter
        # this set.
        key = bytes(payload["task_id"]) + bytes(
            payload.get("push_id") or b"")
        with self._seen_lock:
            if key in self._seen_tasks:
                return "accepted"
            self._seen_tasks.add(key)
            self._seen_order.append(key)
            while len(self._seen_order) > 65536:
                self._seen_tasks.discard(self._seen_order.popleft())
        # Tasks whose PENDING pull-refs (producer still in flight when
        # the driver shipped them) are not yet local may WAIT here up to
        # the dep-wait bound — they run on a separate bounded wait plane
        # so gated waiters can never clog the intake/pull pools or
        # deadlock a producer queued behind its consumers (producers
        # with no pending deps always flow through _intake).
        pending = any(
            not self.worker.store.is_ready(ObjectID(bytes(ob)))
            for ob in payload.get("pending_refs") or ())
        if pending:
            payload["_gated"] = True
            self._gated.submit(self._start_task, payload)
        else:
            self._intake.submit(self._start_task, payload)
        return "accepted"

    def _ensure_object(self, oid_bin: bytes,
                       deadline: float | None = None,
                       owner: tuple | None = None):
        """Materialize one pull-ref's bytes into the local store through
        its OWNER (the driver that pushed the task): ``owner_locate``
        over the p2p plane names the node holding the bytes — or
        subscribes this node when the producer is still in flight (async
        dependency shipping), so the owner's ``owner_notify`` wakes the
        wait the moment the completion report lands. The head's
        directory is strictly the fallback (owner unreachable /
        lease-transferred entries); a dead owner with no fallback copy
        materializes a typed ``OwnerDiedError``. A producer that FAILED
        arrives as a pickled error in the locate answer; it
        materializes locally so execution reports the real error
        instead of a timeout."""
        oid = ObjectID(bytes(oid_bin))
        store = self.worker.store
        if store.is_ready(oid):
            return
        if deadline is None:
            deadline = time.monotonic() + GlobalConfig.dep_wait_s
        owner_id = owner[0] if owner else None
        owner_addr = tuple(owner[1]) if owner and owner[1] else None
        self.worker.owner_resolver.resolve(
            oid.binary(), owner_addr, owner_id, deadline=deadline,
            stop=self._stop)

    def _unwire_arg(self, wired: tuple, deadline: float | None = None,
                    owner: tuple | None = None):
        from ray_tpu_torch._private.serialization import SerializedObject

        kind, data = wired
        if kind == "v":
            return self.worker.serialization_context.deserialize(
                SerializedObject.from_bytes(data))
        # Pull-ref: prefetched into the store by _start_task.
        oid = ObjectID(bytes(data))
        self._ensure_object(oid.binary(), deadline, owner)  # no-op when
        serialized = self.worker.store.get(oid)              # prefetched
        return self.worker.serialization_context.deserialize(serialized)

    def _start_task(self, payload: dict):
        """Unpack a pushed task, prefetch its remote args in parallel
        (waiting out pending producers — the execution gate for async-
        shipped dependencies), submit to the local scheduler, and report
        completion from the store's ready callbacks — no blocking wait,
        no per-task thread (event-driven dispatch end to end)."""
        return_ids = [ObjectID(bytes(b)) for b in payload["return_ids"]]
        # This node will produce these objects: gated waiters for them
        # (colocated consumers) ride the store's ready event instead of
        # polling the head's directory.
        for oid in return_ids:
            self.worker.store.mark_local_producer(oid)
        streaming = bool(payload.get("streaming"))
        if streaming:
            # Pre-wire the producer-side stream BEFORE execution: every
            # yield's commit enqueues an item_done report (small items
            # inline, large items announce + p2p pull — the per-yield
            # analogue of task_done). A replayed push reuses the existing
            # state, so the listener installs exactly once per task.
            tid = TaskID(bytes(payload["task_id"]))
            with self._seen_lock:
                fresh = tid not in self._streaming_wired
                self._streaming_wired.add(tid)
                # A deliberate re-push (lineage recovery on the same
                # node) reopens the stream: acks must apply again.
                self._stream_done.discard(tid)
            if fresh:
                stream = self.worker.streams.get_or_create(tid)

                def _on_commit(idx, oid, _payload=payload):
                    with self._report_cv:
                        self._report_q.append(("item", _payload, idx, oid))
                        self._report_cv.notify()

                stream.add_commit_listener(_on_commit)
        try:
            fn = self._load_fn(payload["fn_digest"],
                               payload.get("_fn_bytes"))
            deadline = time.monotonic() + GlobalConfig.dep_wait_s
            # The pushing driver OWNS every pull-ref in this payload
            # (its router inlines foreign-owned values before shipping):
            # resolve arg locations owner-direct, not through the head.
            # Owner tuples are (owner_id, addr) everywhere — the same
            # order serialized refs carry.
            owner = (payload.get("driver_id"), payload.get("driver_addr"))
            wired = list(payload["args"]) + list(payload["kwargs"].values())
            pull_bins = [bytes(d) for k, d in wired if k == "r"]
            dep_span = None
            if pull_bins and tracing._TRACER is not None \
                    and payload.get("trace") is not None:
                dep_span = tracing.begin(
                    "task.dep_fetch",
                    parent=tracing.extract(payload["trace"]),
                    component="node", task=payload.get("name", ""),
                    num_deps=len(pull_bins))
            try:
                if payload.get("_gated"):
                    # Pending producers: this task runs on its OWN
                    # thread, so wait-out pulls happen inline — the
                    # shared pull pool stays free for immediately-
                    # resolvable transfers.
                    for ob in pull_bins:
                        self._ensure_object(ob, deadline, owner)
                elif pull_bins:
                    # Pool threads have no ambient thread-local trace
                    # context: re-enter the dep-fetch span's so their
                    # pull meta frames carry it (no-op when off).
                    dep_ctx = dep_span.ctx if dep_span is not None \
                        else None

                    def _pull(ob, _ctx=dep_ctx):
                        with tracing.use_context(_ctx):
                            return self._ensure_object(ob, deadline,
                                                       owner)

                    prefetched = prefetch_serialized(
                        _pull, pull_bins, self._pulls)
                    for exc in prefetched.values():
                        if isinstance(exc, BaseException):
                            raise exc
            except BaseException:
                tracing.finish(dep_span, status="error")
                dep_span = None
                raise
            finally:
                tracing.finish(dep_span)
            args = tuple(self._unwire_arg(a, deadline, owner)
                         for a in payload["args"])
            kwargs = {k: self._unwire_arg(v, deadline, owner)
                      for k, v in payload["kwargs"].items()}
            spec = TaskSpec(
                task_id=TaskID(bytes(payload["task_id"])),
                function=fn, args=args, kwargs=kwargs,
                num_returns=payload["num_returns"],
                return_ids=return_ids,
                name=payload["name"],
                resources=dict(payload["resources"]),
                max_retries=payload["max_retries"],
                retry_exceptions=payload["retry_exceptions"],
                runtime_env=coerce_runtime_env(payload.get("runtime_env")),
                streaming=streaming,
                backpressure=int(payload.get("backpressure", 0)),
                trace=payload.get("trace"))
            self.worker.scheduler.submit(spec)
        except BaseException as exc:  # noqa: BLE001 — report, don't die
            from ray_tpu_torch.exceptions import RayTaskError

            err = exc if isinstance(exc, RayTaskError) else \
                RayTaskError.from_exception(payload.get("name", "task"), exc)
            for oid in return_ids:
                if not self.worker.store.is_ready(oid):
                    self.worker.store.put_error(oid, err)
        # Completion rides the store's ready callbacks (errors also
        # materialize as ready): when the LAST output lands, report
        # task_done from the reporter pool — the RPC itself coalesces
        # into the head client's batch frames.
        remaining = [len(return_ids)]
        lock = threading.Lock()

        def _one_ready():
            with lock:
                remaining[0] -= 1
                if remaining[0] != 0:
                    return
            with self._report_cv:
                self._report_q.append(("done", payload, return_ids))
                self._report_cv.notify()

        for oid in return_ids:
            self.worker.store.on_ready(oid, _one_ready)

    def _build_done(self, payload: dict, return_ids: list):
        """(done_bytes, oid_bins, driver_addr, driver_id) for one
        finished task (completion_fields carries the shared
        sizes/errs/inline semantics). ERRORED oids are announced too:
        a remote consumer's pull then RAISES the typed task error (the
        owner's store serves errors by raising; wire_to_exc keeps the
        type) instead of spinning against a location-less directory
        until the dep-wait bound."""
        sizes, errs, inline = completion_fields(
            self.worker.store, return_ids, payload.get("name", "task"))
        oid_bins = [o.binary() for o in return_ids]
        # Drain bookkeeping: results whose BYTES stay node-held (too
        # big to inline) are exactly the refs a reap could strand —
        # remember their owner so drain can offload them back.
        addr0 = payload.get("driver_addr")
        if addr0:
            with self._seen_lock:
                for ob in sizes:
                    if ob not in inline and ob not in self._result_owner:
                        self._result_owner[ob] = (
                            payload["driver_id"], tuple(addr0))
                        self._result_owner_order.append(ob)
                while len(self._result_owner_order) > 65536:
                    self._result_owner.pop(
                        self._result_owner_order.popleft(), None)
        done_fields = {
            "task_id": bytes(payload["task_id"]),
            "oid_bins": oid_bins,
            "node_client": self.head.client_id,
            "sizes": sizes,
            "errs": errs,
            "inline": inline,
        }
        # Ship this node's task-event ring home piggybacked on the
        # completion report (exactly the coalesced batch that is going
        # out anyway — no new RPC, no new frame): the driver ingests
        # them so util.state.list_tasks() covers cluster tasks.
        events = self._drain_reportable_events()
        if events:
            done_fields["node_events"] = events
            self.events_shipped += len(events)
        done = pickle.dumps(done_fields, protocol=5)
        addr = payload.get("driver_addr")
        if addr:
            self._note_owner(tuple(addr), payload["driver_id"])
        return (done, oid_bins, tuple(addr) if addr else None,
                payload["driver_id"])

    def _build_item(self, payload: dict, idx: int, oid):
        """One yield's item_done report: inline the bytes when small
        (<= inline_object_max_bytes), else ship owner + size so the
        consumer pulls p2p. Returns (item_bytes, announce_oid_or_None,
        addr, driver_id)."""
        store = self.worker.store
        size = store.size_of(oid)
        inline = None
        if size <= INLINE_MAX_BYTES \
                and store.holds_in_memory(oid):
            try:
                inline = store.get(oid, timeout=5.0).to_bytes()
            except Exception:  # noqa: BLE001 — racing eviction
                pass
        item_fields = {
            "task_id": bytes(payload["task_id"]),
            "idx": int(idx),
            "oid": oid.binary(),
            "inline": inline,
            "size": size,
            "node_client": self.head.client_id,
        }
        if tracing._TRACER is not None and payload.get("trace") is not None:
            # Streaming per-yield reports carry the producer task's
            # context: the consumer stamps stream.item trace events.
            item_fields["trace"] = payload["trace"]
        item = pickle.dumps(item_fields, protocol=5)
        addr = payload.get("driver_addr")
        announce = oid.binary() if inline is None else None
        if announce is not None and addr:
            # Streamed items too big to inline are node-held borrowed
            # bytes exactly like task returns: drain must be able to
            # lease-transfer them, or reaping an idle producer node
            # strands the consumer's not-yet-pulled tail items.
            with self._seen_lock:
                if announce not in self._result_owner:
                    self._result_owner[announce] = (
                        payload["driver_id"], tuple(addr))
                    self._result_owner_order.append(announce)
                while len(self._result_owner_order) > 65536:
                    self._result_owner.pop(
                        self._result_owner_order.popleft(), None)
        return (item, announce, tuple(addr) if addr else None,
                payload["driver_id"])

    def _report_loop(self):
        """Drain finished tasks into batched completion reports: ONE
        vectored task_done/item_done batch pushed DIRECT to each
        driver's object server. The driver that pushed the task OWNS its
        results: the direct report IS the location record (the owner's
        table answers peer ``owner_locate`` queries), so the head sees no
        steady-state object traffic. Only the per-driver RELAY fallback
        (a driver that cannot be dialled) records its batch's locations
        at the head, whose fallback directory then serves the relayed
        consumer. Streaming item_done reports ride the same batches:
        yields that accumulate while one flush is on the wire coalesce
        into one vectored flight per driver."""
        from ray_tpu_torch._private.object_server import PeerUnreachableError

        while True:
            with self._report_cv:
                while not self._report_q and not self._stop.is_set():
                    self._report_cv.wait()
                if self._stop.is_set() and not self._report_q:
                    return
                items = list(self._report_q)
                self._report_q.clear()
            # ("task_done"/"item_done", bytes, addr, drv, announce_oids)
            built = []
            tail_events = False
            for entry in items:
                try:
                    if entry[0] == "events":
                        tail_events = True
                        continue
                    if entry[0] == "item":
                        _, payload, idx, oid = entry
                        item, ann, addr, drv = self._build_item(
                            payload, idx, oid)
                        built.append(("item_done", item, addr, drv,
                                      [ann] if ann is not None else []))
                    else:
                        _, payload, return_ids = entry
                        done, oid_bins, addr, drv = self._build_done(
                            payload, return_ids)
                        built.append(("task_done", done, addr, drv,
                                      oid_bins))
                        if payload.get("streaming"):
                            tid = TaskID(bytes(payload["task_id"]))
                            self.worker.streams.pop(tid)
                            with self._seen_lock:
                                self._streaming_wired.discard(tid)
                                self._stream_done.add(tid)
                                self._stream_done_order.append(tid)
                                while len(self._stream_done_order) > 65536:
                                    self._stream_done.discard(
                                        self._stream_done_order.popleft())
                except Exception as exc:  # keep reporting others
                    log.warning("dropping one malformed completion "
                                "record; reporting the rest: %r", exc)
            by_driver: Dict[tuple, list] = {}
            for rec in built:
                by_driver.setdefault((rec[2], rec[3]), []).append(rec)
            for (addr, driver_id), entries in by_driver.items():
                if addr is not None:
                    try:
                        replies = self.head._peers.call_many(
                            addr, [(kind, data)
                                   for kind, data, *_ in entries])
                        # call_many surfaces DRIVER-side handler errors
                        # as exception objects per message: those
                        # records were NOT delivered — they must take
                        # the relay below or their completion (and only
                        # location record) is silently lost.
                        failed = [rec for rec, rep in zip(entries,
                                                          replies)
                                  if isinstance(rep, BaseException)]
                        if not failed:
                            self.direct_report_batches += 1
                            continue
                        log.warning("%d completion record(s) failed in "
                                    "the driver's handler; relaying "
                                    "them via the head", len(failed))
                        entries = failed
                    except PeerUnreachableError:
                        pass  # driver not directly dialable: relay below
                # Relay fallback: the head becomes the directory of record
                # for this batch. The task_done relay records its oid
                # locations head-side; only large streamed items need
                # the explicit announce flight.
                fallback = [ob for rec in entries for ob in rec[4]
                            if rec[0] == "item_done"]
                try:
                    if fallback:
                        self.head.object_announce_many(fallback)
                    self.announce_fallback_oids += len(fallback)
                except Exception as exc:  # pub/sub item consumers
                    log.debug("fallback announce failed (item pulls "
                              "resolve via owner only): %r", exc)
                dones = [(rec[4], rec[1]) for rec in entries
                         if rec[0] == "task_done"]
                try:
                    if dones:
                        # One coalesced flight for the whole batch — the
                        # relay fallback must not serialize N round trips.
                        self.head.task_done_many(driver_id, dones)
                    for rec in entries:
                        if rec[0] == "item_done":
                            # Per-item relay fallback rides pub/sub.
                            self.head.publish(f"stream|{driver_id}",
                                              ("item_done", rec[1]))
                except Exception as exc:  # driver gone: results stay
                    log.debug("completion relay to driver %s failed "
                              "(results stay local): %r", driver_id, exc)
            if tail_events:
                # Completion batches in this drain already shipped what
                # they could; anything recorded since goes direct to
                # the last reported-to driver (best-effort telemetry —
                # still zero head RPCs).
                self._flush_tail_events()

    def _drain_reportable_events(self):
        """Drain task events past the shipping cursor, rendered to the
        wire tuple shape both shipping paths (piggybacked ``node_events``
        and the direct ``task_events`` tail flush) unpack. Only the
        states the cluster view renders ship (RUNNING + terminal);
        transient PENDING_* bookkeeping stays local. Reporter-thread
        only: the cursor advances unconditionally."""
        cursor, fresh = self.worker.task_events.drain_since(
            self._events_cursor)
        self._events_cursor = cursor
        return [(ev.task_id.binary(), ev.state, ev.timestamp, ev.name,
                 ev.duration) for ev in fresh
                if not ev.state.startswith("PENDING")]

    def _flush_tail_events(self):
        with self._seen_lock:
            owner = self._last_owner
        if owner is None or owner[0] is None:
            return
        events = self._drain_reportable_events()
        if not events:
            return
        blob = pickle.dumps((self.head.client_id, events), protocol=5)
        try:
            self.head._peers.call(tuple(owner[0]),
                                  ("task_events", blob))
            self.events_shipped += len(events)
        except Exception as exc:  # noqa: BLE001 — owner gone: telemetry
            log.debug("tail task-event ship to %s failed (telemetry "
                      "only): %r", owner[1], exc)

    # ----------------------------------------------------------------- drain
    def _on_fn_preship(self, msg: tuple):
        """Function-cache pre-ship on node join: register pushed
        function bytes ahead of any task so a cold node's first wave
        skips the need_fn round trip. Idempotent (digest-keyed)."""
        count = 0
        for fnb in msg[1]:
            self._register_fn(bytes(fnb))
            count += 1
        with self._seen_lock:
            self.fn_preshipped += count
        return count

    def _on_node_drain(self, msg: tuple):
        """Drain-before-reap: cordon this node (new pushes refuse
        typed), wait out in-flight tasks and pending completion
        reports, then lease-transfer node-held result bytes to their
        owning drivers (``object_offload`` over the direct plane) and
        re-point the head's fallback directory entries at the new
        holder (``object_transfer``, the lease-handoff path).
        Returns the drain report; the reaper terminates the process
        only after this reply, so a drained reap can never strand a
        borrowed ref. Bounded by the caller-supplied timeout — a
        wedged drain degrades to crash semantics (lineage replay).

        Exactly-once under racing reapers: the FIRST drain claims the
        node (cordon); a concurrent second pass observes the cordon
        and returns immediately with ``already_draining`` set and
        current counters — it must neither re-run the offload (double
        ``object_offload`` would double-count lease transfers) nor be
        treated by its caller as a completed drain it owns."""
        timeout_s = float(msg[1]) if len(msg) > 1 else 15.0
        with self._seen_lock:
            if self._draining:
                return {"transferred": self.drain_transferred,
                        "untransferred": self.drain_untransferred,
                        "refused": self.drain_refusals,
                        "already_draining": True}
            self._draining = True
        deadline = time.monotonic() + max(timeout_s, 0.1)
        # 1. In-flight work finishes: queued + running tasks, then the
        # reporter queue flushes (a completed task whose report never
        # left would strand its locations driver-side as "pending").
        while time.monotonic() < deadline:
            with self._report_cv:
                reports_pending = bool(self._report_q)
            if self.worker.scheduler.backlog_size() == 0 \
                    and not reports_pending:
                break
            time.sleep(0.05)
        # 2. Lease-transfer node-held result bytes, grouped per owner.
        with self._seen_lock:
            owned = list(self._result_owner.items())
        by_owner: Dict[tuple, list] = {}
        store = self.worker.store
        for ob, owner in owned:
            oid = ObjectID(bytes(ob))
            if not store.is_ready(oid) or store.peek_error(oid) \
                    is not None:
                continue
            try:
                raw = store.get(oid, timeout=5.0).to_bytes()
            except Exception:  # noqa: BLE001 — racing eviction
                continue
            by_owner.setdefault(owner, []).append((ob, raw))
        transferred: list = []  # (oid_bin, holder) for the head re-point
        for (drv, addr), entries in by_owner.items():
            # Chunked flights bound the frame size; the driver stores
            # the bytes locally and re-points its owner table.
            # Accounting is PER CHUNK: a partially-successful owner
            # transfer counts exactly what moved (transferred +
            # untransferred always sums to the held set).
            for i in range(0, len(entries), 64):
                chunk = entries[i:i + 64]
                try:
                    self.head._peers.call(
                        tuple(addr), ("object_offload", chunk))
                    transferred.extend((ob, drv) for ob, _ in chunk)
                    self.drain_transferred += len(chunk)
                except Exception as exc:  # noqa: BLE001 — owner gone:
                    self.drain_untransferred += len(chunk)
                    log.warning("drain offload of %d object(s) to "
                                "driver %s failed (lineage will "
                                "replay): %r", len(chunk), drv, exc)
        # 3. Re-point head FALLBACK directory entries naming this node
        # as holder: the owning driver holds the bytes now, so relayed
        # borrowers keep resolving after this process exits.
        if transferred:
            try:
                self.head.object_transfer_many(transferred)
            except Exception as exc:  # noqa: BLE001 — head gone: the
                log.debug("drain head re-point failed (owner-direct "
                          "resolution still covers these): %r", exc)
        return {"transferred": self.drain_transferred,
                "untransferred": self.drain_untransferred,
                "refused": self.drain_refusals,
                "already_draining": False}

    # -------------------------------------------------------------- lifecycle
    def run_forever(self):
        signal.signal(signal.SIGTERM, lambda *_: self._stop.set())
        try:
            while not self._stop.wait(0.5):
                pass
        except KeyboardInterrupt:
            pass
        self.shutdown()

    def shutdown(self):
        import ray_tpu_torch

        self._stop.set()
        with self._report_cv:
            self._report_cv.notify_all()
        for pool in (self._intake, self._pulls, self._gated):
            pool.shutdown(wait=False, cancel_futures=True)
        self.actor_host.shutdown()
        ray_tpu_torch.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--address", required=True, help="head host:port")
    ap.add_argument("--num-cpus", type=int, default=2)
    ap.add_argument("--resources", default="{}",
                    help='extra resources, e.g. \'{"accel": 1}\'')
    ap.add_argument("--worker-mode", default=None,
                    choices=(None, "process", "thread"))
    args = ap.parse_args(argv)
    daemon = NodeDaemon(
        args.address, num_cpus=args.num_cpus,
        resources=json.loads(args.resources),
        worker_mode=args.worker_mode)
    print(f"ray_tpu_torch node {daemon.worker.node_id.hex()[:16]} joined "
          f"{args.address} as {daemon.head.client_id}", flush=True)
    daemon.run_forever()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
