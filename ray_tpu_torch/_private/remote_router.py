"""Driver-side router that pushes tasks onto remote node daemons
(counterpart of ``ray_tpu/_private/remote_router.py``).

A driver attached to a head service sees the registered node daemons
(``node_daemon.py``) and routes a task onto them when:

- the task's resource demand is infeasible locally (a custom resource
  only a remote node offers, or any demand on a ``ray://`` thin client),
- a ``NodeAffinitySchedulingStrategy`` targets a daemon node, or
- the local backlog passes ``SPILL_BACKLOG_FACTOR`` times the local CPUs
  and a feasible node is less loaded.

The head stays out of steady-state dispatch:

- **Direct dispatch.** The driver dials each node daemon's request
  server once (its address rides the node's heartbeat into the head's
  directory) and pushes payload batches peer to peer in one vectored
  ``send_many`` a flush; a failed dial falls back to the head-relayed
  ``task_push``. One batch in flight per node, so batches grow under
  load.
- **Locality.** ``_choose_node`` scores feasible nodes by the ref-arg
  bytes already resident there (owners from the completion stream,
  sizes from ``task_done``; a pending dep counts at its producer's
  node), so a consumer runs where its argument lives.
- **The per-node function cache.** ``cloudpickle.dumps(fn)`` ships once
  per (node, digest); later payloads carry the digest. A node that lost
  it answers ``need_fn`` and the payload reships with bytes. A joining
  node gets the driver's recent functions pushed ahead (the pre-ship).
- **Asynchronous dependency shipping.** A task whose ref args are
  produced by other routed tasks ships at once with pending pull refs;
  the node daemon waits out the producer. A producer's failure fails its
  dependents here, iteratively.

Results stay on the producing node until a consumer pulls them; small
ones and task errors ride the ``task_done`` report. The router keeps the
``TaskSpec`` lineage of everything it pushed: when the head's heartbeat
monitor calls a node dead, ``_watch_loop`` reroutes its in-flight tasks,
and ``ensure_local`` re-executes a lost result from lineage. Remote actor
calls are tracked here too (``register_external``) but never re-executed.
"""

from __future__ import annotations

import pickle
import threading
import time
import weakref
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Set, Tuple

from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch._private.ids import ObjectID, TaskID
from ray_tpu_torch._private.log import get_logger
from ray_tpu_torch._private.object_server import PeerUnreachableError
from ray_tpu_torch._private.scheduler import TaskSpec, _collect_refs
from ray_tpu_torch._private import tracing

log = get_logger(__name__)
from ray_tpu_torch.exceptions import (
    GetTimeoutError,
    NodeDrainingError,
    RayTaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

_NODES_TTL_S = 0.5
_MAX_PUSH_ATTEMPTS = 3
_DRAINING_TTL_S = 60.0  # push-refusal cordon memory (reap follows soon)
# Spill a locally feasible task to a less loaded node once the local
# backlog passes this many tasks per local CPU.
SPILL_BACKLOG_FACTOR = 4.0
# Locality: prefer the feasible node already holding at least this many
# bytes of a task's ref args, while its reported backlog per CPU stays
# within LOCALITY_LOAD_SLACK of the least loaded node's.
LOCALITY_MIN_BYTES = 64 * 1024
LOCALITY_LOAD_SLACK = 8.0
# Bound on pull retries for a completed result that no node serves and
# no lineage can rebuild (actor-call results included; the actor host
# pins results as long): past it the object is declared lost.
EXTERNAL_PULL_TTL_S = 600.0


class _DepNotReady(Exception):
    """A payload build found a dependency that must be awaited (owner
    died between dep classification and wiring). Raised instead of
    blocking: the spec re-enters _accept, whose blocker path waits on
    the dedicated blocking-wait pool — never on a drain lane."""


class RemoteRouter:
    def __init__(self, worker):
        self.worker = worker
        self.head = worker.head_client
        self.head.handlers["task_done"] = self._on_task_done_relayed
        # Completion fast path: nodes push task_done straight to this
        # driver's object/request server (address shipped in the task
        # payload) — the head only sees coalesced object announces.
        self.head._object_server.handlers["task_done"] = \
            self._on_task_done_direct
        # Streaming generators: per-yield item_done reports arrive on the
        # same direct plane (small items inline, large items announce +
        # p2p pull), exactly like task_done; the pub/sub topic
        # ``stream|<client>`` is the head-relayed fallback.
        self.head._object_server.handlers["item_done"] = self._on_item_done
        # Drain-before-reap receiving side: a draining node lease-
        # transfers the result bytes it holds for THIS owner in
        # object_offload flights — the bytes land in the local store
        # and the owner table re-points at ourselves, so borrowers keep
        # resolving after the node exits.
        self.head._object_server.handlers["object_offload"] = \
            self._on_object_offload
        # Node task-event shipping (observability): events ride the
        # task_done payloads; TAIL events (terminal records that raced
        # past the last completion flush) arrive on this side channel.
        self.head._object_server.handlers["task_events"] = \
            self._on_task_events
        self.lineage: Dict[TaskID, TaskSpec] = {}
        self._done: Dict[TaskID, threading.Event] = {}
        self._done_cbs: Dict[TaskID, List[Callable[[], None]]] = {}
        self._task_node: Dict[TaskID, str] = {}   # -> node client_id
        self._inflight: Dict[str, int] = {}       # node client -> pushed
        # Assigned-but-not-yet-delivered per node: counted into _load so
        # a burst CHOOSING nodes faster than batches hit the wire still
        # spreads (the in-flight counter alone lags by one drain cycle).
        self._assigned: Dict[str, int] = {}
        self._oid_owner: Dict[bytes, str] = {}    # done oids -> node client
        self._oid_sizes: Dict[bytes, int] = {}    # done oids -> byte size
        self._failed: Dict[TaskID, BaseException] = {}
        # Completed tids, marked INSIDE _on_task_done's locked block (the
        # done Events are set after the lock releases, too late for the
        # push-reply race check in _register_pushed). Recency-bounded:
        # the race window it closes is the push round trip, so old
        # entries are dead weight in a long-lived driver.
        self._completed: Set[TaskID] = set()
        self._completed_order: "deque" = deque()
        # Async dependency shipping: producer tid -> tids of pushed tasks
        # carrying a PENDING pull-ref on one of its outputs. A producer
        # failure fails the children promptly driver-side (the node-side
        # pull would otherwise only time out at the dep-wait bound).
        self._dep_children: Dict[TaskID, Set[TaskID]] = {}
        # Per-node function cache bookkeeping (driver side): digests this
        # driver has shipped to each node. Marked optimistically at
        # payload build; the node's ``need_fn`` reply self-heals a mark
        # that outran a failed push or a node-side eviction.
        self._fn_shipped: Dict[str, Set[bytes]] = {}
        self._fn_wire_cache: "weakref.WeakKeyDictionary" = \
            weakref.WeakKeyDictionary()  # fn -> (digest, bytes)
        # Remote ACTOR tasks: completion tracked here (task_done +
        # object pull), but never re-executed from lineage — interrupted
        # actor calls fail (reference restart semantics); the
        # RemoteActorRuntime's watcher materializes the errors.
        self.external: Dict[TaskID, str] = {}     # tid -> node client_id
        self.remote_actors: List = []             # RemoteActorRuntime watch
        self._spread_counter = 0
        self._placed_counts: Dict[str, int] = {}  # node -> actors placed
        # Demand surface for the autoscaler: tasks no current node (and
        # no local capacity) can run are PARKED here until membership
        # changes; their shapes ride the driver's heartbeat status so
        # the autoscaler can provision nodes that fit (reference:
        # resource_demand in the raylet's load report).
        self._parked: List[TaskSpec] = []
        self._unmet_hints: List[tuple] = []  # (shape, ts) — actor asks
        if self.head.status_fn is None:
            self.head.status_fn = self._status
        self._recovering: set = set()
        self._prefetching: set = set()
        # Nodes that refused a push with "draining" (reap cordon):
        # skipped by _choose_node until the TTL lapses — the membership
        # heartbeat's draining marker takes over once it propagates.
        self._draining_nodes: Dict[str, float] = {}  # cid -> marked at
        self.drain_reroutes = 0    # pushes refused by a draining node
        self.offloaded_objects = 0  # drain lease-transfers received
        # Function-cache pre-ship: the last few distinct functions this
        # driver shipped anywhere (digest -> bytes, tiny LRU). A newly
        # joined node gets them pushed ahead of its first task, so the
        # cold-start fan-out wave skips the need_fn round trip.
        from collections import OrderedDict as _OrderedDict

        self._fn_recent: "_OrderedDict[bytes, bytes]" = _OrderedDict()
        self.fn_preship_sent = 0
        # Streaming generator bookkeeping: tasks whose consumption acks
        # this driver must propagate (consume-listener installed once per
        # task), the coalesced ack watermarks awaiting a wire flush, and
        # the per-task single-flight sender guard.
        self._stream_tasks: Set[TaskID] = set()
        self._stream_ack_pending: Dict[TaskID, int] = {}
        self._stream_ack_inflight: Set[TaskID] = set()
        self._stream_sub = False  # lazy fallback-topic subscription
        self._lock = threading.Lock()
        self._nodes_cache: tuple = (0.0, [])
        # Dispatch plane: a single grouping thread drains submitted
        # tasks into per-node pending lists; one in-flight push batch
        # per node (single-flight) means the NEXT batch accumulates
        # while the previous round trip is on the wire.
        self._dispatch_q: "deque" = deque()  # (spec, node|None, tried)
        self._dispatch_cv = threading.Condition()
        self._node_pending: Dict[str, list] = {}  # cid -> [(spec, tried)]
        self._node_busy: Set[str] = set()
        self._node_rec: Dict[str, dict] = {}      # cid -> membership rec
        # Prospective placement (assigned, possibly not yet pushed):
        # locality scoring colocates a fast chain's links through this
        # map before _task_node registration lands.
        self._task_target: Dict[TaskID, str] = {}
        # Ownership-based object directory (owner side): this driver
        # owns every ref its tasks return — the completion stream above
        # IS the location table, and peers resolve/subscribe against it
        # over the p2p object plane (``owner_locate``/``owner_notify``)
        # instead of asking the head. The head keeps only membership +
        # the fallback directory (lease handoff on shutdown).
        from ray_tpu_torch._private.ownership import OwnerDirectory

        self.owner_directory = OwnerDirectory(self)
        # Bench counters (the cross-node fast-path proof surface).
        self.direct_pushes = 0     # tasks pushed peer-to-peer
        self.relayed_pushes = 0    # tasks pushed via head relay
        self.direct_batches = 0    # wire round trips on the direct plane
        self.direct_done_reports = 0   # completions pushed peer-to-peer
        self.relayed_done_reports = 0  # completions via head relay
        self.inline_results = 0    # results that arrived in task_done
        self.owner_table_pulls = 0  # result pulls resolved from the
        #                             owner's own table (no head RPC)
        self.fn_bytes_sent = 0     # function bytes actually shipped
        self.fn_payloads_with_bytes = 0
        self.fn_payloads_digest_only = 0
        self._pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="ray_tpu_router")
        # Blocking waits (prefetch ensure_local, dep awaits) get their
        # OWN pool so queued push batches and lineage re-execution on
        # self._pool never starve behind them.
        self._prefetch_pool = ThreadPoolExecutor(
            max_workers=8, thread_name_prefix="ray_tpu_router_prefetch")
        self._stop = threading.Event()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="ray_tpu_router_dispatch")
        self._dispatcher.start()
        self._watcher = threading.Thread(
            target=self._watch_loop, daemon=True, name="ray_tpu_router_watch")
        self._watcher.start()
        try:
            # Membership events drive the function-cache pre-ship (a
            # joining node gets this driver's hot functions before its
            # first task) — best-effort; need_fn stays the safety net.
            self.head.subscribe("ray_tpu_torch:node_events",
                                self._on_node_event)
        except Exception:  # noqa: BLE001 — headless/standalone runtime
            pass

    # ------------------------------------------------------------- routing
    def nodes(self, refresh: bool = False) -> List[dict]:
        now = time.monotonic()
        ts, cached = self._nodes_cache
        if not refresh and now - ts < _NODES_TTL_S:
            return cached
        try:
            nodes = self.head.node_list()
        except Exception:  # noqa: BLE001 — head unreachable: no routing
            nodes = []
        self._nodes_cache = (now, nodes)
        return nodes

    @staticmethod
    def _fits(node: dict, demand: Dict[str, float]) -> bool:
        res = node.get("resources") or {}
        return all(res.get(k, 0.0) >= v for k, v in demand.items())

    @staticmethod
    def _node_addr(node: dict) -> Optional[Tuple[str, int]]:
        """The node daemon's direct request/object server address
        (published through the node directory / its heartbeat)."""
        addr = node.get("peer_addr") or \
            (node.get("status") or {}).get("_peer_addr")
        return (str(addr[0]), int(addr[1])) if addr else None

    def _locality_bytes(self, spec: TaskSpec) -> Dict[str, int]:
        """Bytes of ``spec``'s ref args resident per node client. Owners
        and sizes come from the task_done stream; a PENDING dep (producer
        still running) counts as presence at its producer's node —
        weighted at the locality threshold so chains colocate."""
        loc: Dict[str, int] = {}
        for ref in _collect_refs(spec.args, spec.kwargs):
            ob = ref.object_id.binary()
            tid = ref.object_id.task_id()
            with self._lock:
                owner = self._oid_owner.get(ob)
                if owner is not None:
                    size = max(self._oid_sizes.get(ob, 0), 1)
                else:
                    owner = self._task_node.get(tid) or \
                        self._task_target.get(tid)
                    size = int(LOCALITY_MIN_BYTES)
            if owner is not None:
                loc[owner] = loc.get(owner, 0) + size
        return loc

    def _is_draining(self, n: dict) -> bool:
        """Cordoned for reap: the heartbeat's draining marker, or a
        recent typed push refusal from the node itself (which beats the
        heartbeat by up to one period)."""
        if (n.get("status") or {}).get("draining"):
            return True
        if not self._draining_nodes:
            # Lock-free steady-state fast path: nothing has ever
            # drained, so don't pay lock contention per candidate per
            # task. The benign race (a refusal landing right now) is
            # already covered by the typed push refusal itself.
            return False
        with self._lock:
            ts = self._draining_nodes.get(n["client_id"])
            if ts is None:
                return False
            if time.monotonic() - ts > _DRAINING_TTL_S:
                self._draining_nodes.pop(n["client_id"], None)
                return False
        return True

    def _choose_node(self, spec: TaskSpec,
                     exclude: tuple = ()) -> Optional[dict]:
        nodes = [n for n in self.nodes()
                 if n.get("alive") and n["client_id"] not in exclude
                 and not self._is_draining(n)]
        strat = spec.scheduling_strategy
        if isinstance(strat, NodeAffinitySchedulingStrategy):
            for n in nodes:
                if n.get("node_id") == strat.node_id:
                    return n
            if not getattr(strat, "soft", False):
                return None
            # Soft affinity: target gone, fall through to least-loaded.
        feasible = [n for n in nodes if self._fits(n, spec.resources)]
        if not feasible:
            return None
        if len(feasible) > 1:
            # Locality-aware placement: the node already holding the
            # task's argument bytes wins over pure least-loaded, as long
            # as it is not drastically more loaded (slack bound) — the
            # reference's bytes-resident lease policy.
            loc = self._locality_bytes(spec)
            if loc:
                best = max(feasible,
                           key=lambda n: loc.get(n["client_id"], 0))
                resident = loc.get(best["client_id"], 0)
                if resident >= LOCALITY_MIN_BYTES:
                    # Slack compares REPORTED backlogs (actually-runnable
                    # work), not the driver-side assignment counters: an
                    # async-shipped chain assigns all its links up front
                    # while only one is ever runnable — counting them as
                    # load would evict the chain from its data.
                    min_load = min(self._reported_load(n)
                                   for n in feasible)
                    if self._reported_load(best) <= \
                            min_load + LOCALITY_LOAD_SLACK:
                        return best
        return min(feasible, key=self._load)

    @staticmethod
    def _reported_load(n: dict) -> float:
        """Heartbeat-reported backlog per CPU only — the node's actually
        runnable work, without this driver's assignment counters."""
        status = n.get("status") or {}
        cpus = max((n.get("resources") or {}).get("CPU", 1.0), 1.0)
        return float(status.get("backlog", 0)) / cpus

    def _load(self, n: dict) -> float:
        """Reported backlog (heartbeat, ~0.5 s stale) plus locally-known
        in-flight pushes, so a burst submitted between heartbeats spreads
        instead of piling onto one node."""
        status = n.get("status") or {}
        cpus = max((n.get("resources") or {}).get("CPU", 1.0), 1.0)
        with self._lock:
            inflight = self._inflight.get(n["client_id"], 0) \
                + self._assigned.get(n["client_id"], 0)
        return (float(status.get("backlog", 0)) + inflight) / cpus

    # ------------------------------------------------------ actor placement
    @staticmethod
    def actor_demand(opts: dict) -> Dict[str, float]:
        """Resource demand of an actor from its options (num_cpus,
        num_gpus, custom resources, a PG bundle's shape). ``num_gpus``
        asks for the ``GPU`` resource that card nodes advertise (the
        reference's accelerator is a TPU, which its actors ask for by a
        custom resource)."""
        demand: Dict[str, float] = {}
        if opts.get("num_cpus"):
            demand["CPU"] = float(opts["num_cpus"])
        if opts.get("num_gpus"):
            demand["GPU"] = float(opts["num_gpus"])
        strat = opts.get("scheduling_strategy")
        from ray_tpu_torch.util.scheduling_strategies import (
            PlacementGroupSchedulingStrategy,
        )

        if isinstance(strat, PlacementGroupSchedulingStrategy):
            # PG-aware placement: the bundle's resource shape is the
            # demand; the PG itself reserves per-node capacity only in
            # the sim plane, so here bundles steer feasibility.
            pg = strat.placement_group
            idx = strat.placement_group_bundle_index
            bundles = getattr(pg, "bundles", None) or []
            if bundles:
                bundle = bundles[max(idx, 0) % len(bundles)]
                demand.update({k: float(v) for k, v in bundle.items()})
        demand.update({k: float(v)
                       for k, v in (opts.get("resources") or {}).items()})
        return demand

    def place_actor(self, opts: dict) -> Optional[dict]:
        """Placement decision for a new actor (GcsActorScheduler role).
        Returns the hosting node's membership record, or None for a
        driver-local actor. Same policy family as maybe_route:

        - ``NodeAffinitySchedulingStrategy`` pins to that node;
        - a resource demand infeasible locally goes to a feasible node
          (loud error when none exists);
        - ``scheduling_strategy="SPREAD"`` round-robins over the local
          runtime + all feasible nodes;
        - thin clients (``ray://``) always place on the cluster;
        - otherwise the actor stays local (driver-owned, zero latency).
        """
        demand = self.actor_demand(opts)
        strat = opts.get("scheduling_strategy")
        # Draining nodes are cordoned for ACTORS too: placing onto a
        # node mid-reap creates the actor into a terminating process
        # (its creation either fails typed or strands node-side work).
        nodes = [n for n in self.nodes(refresh=True)
                 if n.get("alive") and not self._is_draining(n)]
        client_mode = getattr(self.worker, "client_mode", False)
        if isinstance(strat, NodeAffinitySchedulingStrategy):
            if strat.node_id == self.worker.node_id.hex() \
                    and not client_mode:
                return None
            for n in nodes:
                if n.get("node_id") == strat.node_id:
                    return n
            if not getattr(strat, "soft", False):
                raise ValueError(
                    f"no alive node {strat.node_id!r} for actor "
                    f"NodeAffinity placement")
        feasible = [n for n in nodes if self._fits(n, demand)]
        local_fits = (self.worker.resource_pool.fits(demand)
                      and not client_mode)
        if not local_fits:
            if not feasible:
                # Record the shape so an autoscaler can provision for a
                # retry, then fail loudly (actor creation is synchronous
                # — it cannot park like a task).
                with self._lock:
                    self._unmet_hints.append((dict(demand),
                                              time.monotonic()))
                # Cold-start chain: the request that exposed the
                # capacity gap parks its trace context so the
                # autoscaler's launch (and the launched node's init /
                # head join) lands in the same trace.
                tracing.stash_cold_start()
                from ray_tpu_torch.exceptions import PlacementInfeasibleError

                raise PlacementInfeasibleError(
                    f"actor resource demand {demand} is infeasible: no "
                    f"local capacity and no feasible cluster node")
            return self._record_placement(
                min(feasible, key=self._actor_load))
        if strat == "SPREAD" and feasible:
            # Round-robin across local + feasible nodes so replica/worker
            # groups land on every machine.
            with self._lock:
                slot = self._spread_counter
                self._spread_counter += 1
            candidates: List[Optional[dict]] = [None] + feasible
            return self._record_placement(
                candidates[slot % len(candidates)])
        return None

    def _record_placement(self, node: Optional[dict]) -> Optional[dict]:
        """Count placements locally so a burst placed between heartbeats
        spreads instead of piling onto one node (same trick as the task
        router's in-flight counter)."""
        if node is not None:
            with self._lock:
                cid = node["client_id"]
                self._placed_counts[cid] = \
                    self._placed_counts.get(cid, 0) + 1
        return node

    def _actor_load(self, n: dict) -> float:
        status = n.get("status") or {}
        with self._lock:
            placed = self._placed_counts.get(n["client_id"], 0)
        # The heartbeat-reported count eventually includes our local
        # placements; take the max so they are not double-counted.
        return max(float(status.get("actors", 0)), float(placed)) \
            + self._load(n)

    def register_external(self, tid: TaskID, node_client: str):
        """Track a remote actor task: completion arrives via task_done;
        the result oids resolve through ensure_local like routed tasks."""
        with self._lock:
            self.external[tid] = node_client
            self._done.setdefault(tid, threading.Event())

    def watch_remote_actor(self, runtime):
        """Register a RemoteActorRuntime for node-death watching (fail
        in-flight calls + restart-on-surviving-node)."""
        with self._lock:
            self.remote_actors.append(runtime)

    # --------------------------------------------------------- demand report
    def unmet_shapes(self) -> List[Dict[str, float]]:
        """Resource shapes this driver wants but no current node serves
        (parked tasks + recent infeasible actor asks) — the autoscaler's
        scale-up signal."""
        now = time.monotonic()
        with self._lock:
            self._unmet_hints = [(s, ts) for s, ts in self._unmet_hints
                                 if now - ts < 30.0]
            return [dict(s.resources) for s in self._parked] + \
                [dict(s) for s, _ in self._unmet_hints]

    def _status(self) -> dict:
        return {
            "backlog": self.worker.scheduler.backlog_size(),
            "unmet": self.unmet_shapes(),
        }

    def _retry_parked(self):
        with self._lock:
            parked, self._parked = self._parked, []
        still = []
        for spec in parked:
            node = self._choose_node(spec)
            if node is None:
                still.append(spec)
            else:
                self._accept(spec, node)
        if still:
            with self._lock:
                self._parked = still + self._parked

    def maybe_route(self, spec: TaskSpec) -> bool:
        """Called by Worker.submit_task before local submission. Returns
        True iff the task was taken over for remote execution."""
        strat = spec.scheduling_strategy
        affinity_remote = (
            isinstance(strat, NodeAffinitySchedulingStrategy)
            and any(n.get("node_id") == strat.node_id
                    for n in self.nodes()))
        local_fits = (self.worker.resource_pool.fits(spec.resources)
                      and not getattr(self.worker, "client_mode", False))
        spill = False
        if local_fits and not affinity_remote:
            backlog = self.worker.scheduler.backlog_size()
            cpus = max(
                self.worker.resource_pool.total.get("CPU", 1.0), 1.0)
            spill = backlog / cpus > SPILL_BACKLOG_FACTOR
        if not (affinity_remote or not local_fits or spill):
            return False
        node = self._choose_node(spec)
        if node is None:
            hard_affinity = (isinstance(strat, NodeAffinitySchedulingStrategy)
                            and not getattr(strat, "soft", False))
            if not local_fits and not hard_affinity \
                    and not getattr(self.worker, "client_mode", False):
                # Infeasible EVERYWHERE: park it and advertise the shape
                # so an autoscaler can provision a node that fits; the
                # watch loop retries when membership changes. (Thin
                # clients keep their loud no-capacity error; a hard
                # NodeAffinity miss is a strategy miss, not a resource
                # shape an autoscaler could satisfy — don't park it.)
                with self._lock:
                    self._parked.append(spec)
                    self.lineage[spec.task_id] = spec
                    self._done.setdefault(spec.task_id, threading.Event())
                return True
            return False
        if not local_fits or affinity_remote or self._node_less_loaded(node):
            self._accept(spec, node)
            return True
        return False

    def _node_less_loaded(self, node: dict) -> bool:
        status = node.get("status") or {}
        cpus = max((node.get("resources") or {}).get("CPU", 1.0), 1.0)
        local_cpus = max(
            self.worker.resource_pool.total.get("CPU", 1.0), 1.0)
        return (float(status.get("backlog", 0)) / cpus
                < self.worker.scheduler.backlog_size() / local_cpus)

    # ---------------------------------------------------------- acceptance
    def _accept(self, spec: TaskSpec, node: Optional[dict],
                tried: tuple = ()):
        """Take ownership of a spec for remote execution. Deps produced
        by other ROUTER-TRACKED tasks do NOT block shipping (they travel
        as pending pull-refs — async dependency shipping); only deps the
        driver itself must inline (untracked local producers) hold the
        task back, on the blocking-wait pool, event-driven."""
        if spec.streaming:
            self._track_stream(spec)
        with self._lock:
            self.lineage[spec.task_id] = spec
            self._done.setdefault(spec.task_id, threading.Event())
            if node is not None:
                cid = node["client_id"]
                self._assigned[cid] = self._assigned.get(cid, 0) + 1
                # Prospective target recorded at CHOICE time, not at
                # dispatch: the next link of a fast-submitted chain
                # must see its parent's placement to colocate.
                self._task_target[spec.task_id] = cid
        blockers = self._dep_blockers(spec)
        if blockers:
            self._prefetch_pool.submit(
                self._await_then_enqueue, spec, node, tried, blockers)
        else:
            self._enqueue(spec, node, tried)

    def _dep_blockers(self, spec: TaskSpec) -> List[ObjectID]:
        """Ref args that must be resolved driver-side before the task
        can ship: not store-ready, not served by a live owner, and not
        produced by a STILL-RUNNING tracked task (those ship as pending
        pull-refs instead). A tracked dep that COMPLETED but lost its
        owner (node died after finishing) blocks too — it needs
        lineage recovery, not a doomed directory poll."""
        blockers: List[ObjectID] = []
        for ref in _collect_refs(spec.args, spec.kwargs):
            oid = ref.object_id
            if self.worker.store.is_ready(oid):
                continue
            ob = oid.binary()
            tid = oid.task_id()
            with self._lock:
                owner = self._oid_owner.get(ob)
                ev = self._done.get(tid)
                done = ev is not None and ev.is_set()
                tracked = (tid in self.lineage or tid in self.external) \
                    and tid not in self._failed
            if owner is not None and self._client_alive(owner):
                continue
            if tracked and not done:
                continue  # pending: ships as an async pull-ref
            blockers.append(oid)
        return blockers

    def _await_blocker(self, oid: ObjectID):
        """Resolve one blocking dep on the wait pool: a tracked dep
        that completed but lost its owner goes through ensure_local
        (pull-or-re-execute-from-lineage — the recovery semantics);
        anything else waits event-driven for production."""
        tid = oid.task_id()
        with self._lock:
            ev = self._done.get(tid)
            done = ev is not None and ev.is_set()
            tracked = (tid in self.lineage or tid in self.external) \
                and tid not in self._failed
        if tracked and done and not self.worker.store.is_ready(oid):
            self.ensure_local(oid, timeout=GlobalConfig.dep_wait_s)
            return
        self._await_dep(oid)

    def _await_then_enqueue(self, spec: TaskSpec, node: Optional[dict],
                            tried: tuple, blockers: List[ObjectID]):
        try:
            for oid in blockers:
                self._await_blocker(oid)
        except BaseException as exc:  # noqa: BLE001 — dep failed/timed out
            if node is not None:
                with self._lock:
                    self._dec_assigned_locked(node["client_id"])
            self._fail(spec, exc)
            return
        self._enqueue(spec, node, tried)

    def _enqueue(self, spec: TaskSpec, node: Optional[dict],
                 tried: tuple = ()):
        with self._dispatch_cv:
            if self._stop.is_set():
                return
            self._dispatch_q.append((spec, node, tuple(tried)))
            self._dispatch_cv.notify()

    # ------------------------------------------------------------ dispatch
    def _dispatch_loop(self):
        """Group submitted tasks by target node and drain them through
        per-node single-flight batches: while one batch's round trip is
        in flight, the node's next batch accumulates — so a fan-out
        burst rides a handful of vectored writes, not N round trips."""
        while True:
            with self._dispatch_cv:
                while not self._dispatch_q and not self._stop.is_set():
                    self._dispatch_cv.wait()
                if self._stop.is_set():
                    return
                items = list(self._dispatch_q)
                self._dispatch_q.clear()
            to_start = []
            for spec, node, tried in items:
                assigned_here = node is None
                if node is None:
                    node = self._choose_node(spec, exclude=tried)
                if node is None:
                    self._fail(spec, WorkerCrashedError(
                        f"no reachable node accepted task {spec.name!r}"))
                    continue
                cid = node["client_id"]
                with self._lock:
                    self._node_rec[cid] = node
                    self._task_target[spec.task_id] = cid
                    if assigned_here:
                        self._assigned[cid] = \
                            self._assigned.get(cid, 0) + 1
                    self._node_pending.setdefault(cid, []).append(
                        (spec, tried))
                    if cid not in self._node_busy:
                        self._node_busy.add(cid)
                        to_start.append(cid)
            for cid in to_start:
                self._pool.submit(self._drain_node, cid)

    def _drain_node(self, cid: str):
        while True:
            with self._lock:
                entries = self._node_pending.pop(cid, [])
                if not entries:
                    self._node_busy.discard(cid)
                    return
                node = self._node_rec.get(cid)
            try:
                self._push_group(node, entries)
            except Exception as exc:  # noqa: BLE001 — batch boundary
                for spec, _ in entries:
                    self._fail(spec, exc)

    def _push_group(self, node: dict, entries: list):
        cid = node["client_id"]
        addr = self._node_addr(node)
        built = []
        for spec, tried in entries:
            try:
                built.append((spec, tried,
                              self._build_payload(spec, cid)))
            except _DepNotReady:
                # A dep must be awaited after all: re-accept (node
                # re-chosen after the wait — the owner it was placed
                # for may be gone).
                with self._lock:
                    self._dec_assigned_locked(cid)
                self._accept(spec, None, tried)
            except BaseException as exc:  # noqa: BLE001 — per-spec build
                with self._lock:
                    self._dec_assigned_locked(cid)
                self._fail(spec, exc)
        if built:
            self._deliver(cid, addr, built, reship_ok=True)

    def _deliver(self, cid: str, addr, built: list, reship_ok: bool,
                 transfer: bool = True):
        """Push one batch of built payloads to a node: direct plane
        first, head relay as the fallback. In-flight accounting is
        ATOMIC with push success: a task registers in ``_task_node``
        only once its payload was accepted (or decrements right away if
        its completion raced the reply), so the watch loop can never
        observe a half-pushed registration and double-re-execute."""
        payloads = [p for _, _, p in built]
        with self._lock:
            if transfer:  # assignment graduates to in-flight at wire time
                for _ in built:
                    self._dec_assigned_locked(cid)
            self._inflight[cid] = self._inflight.get(cid, 0) + len(built)
        try:
            replies = self._send_batch(cid, addr, payloads)
        except Exception as exc:  # noqa: BLE001 — node unreachable
            with self._lock:
                for _ in built:
                    self._dec_inflight_locked(cid)
            for spec, tried, _ in built:
                self._retry_or_fail(spec, tried + (cid,), exc)
            return
        reship = []
        for (spec, tried, _), rep in zip(built, replies):
            if rep == "accepted":
                self._register_pushed(spec.task_id, cid)
                if spec.streaming:
                    # Replayed producers start a FRESH StreamState with
                    # consumed=0 on the new node; without re-sending the
                    # consumer's watermark the replay parks at the
                    # backpressure budget before re-reaching the
                    # consumer's index and the stream deadlocks — acks
                    # otherwise fire only on NEW consumption.
                    st = self.worker.streams.get(spec.task_id)
                    if st is not None and st.consumed > 0:
                        self._send_stream_ack(spec.task_id, st.consumed)
            elif rep == "draining":
                # Reap race: the node was chosen for reap while this
                # push was in flight. Typed refuse-and-reroute — cordon
                # the node locally and re-dispatch elsewhere (counted;
                # never a task failure).
                with self._lock:
                    self._dec_inflight_locked(cid)
                    self._draining_nodes[cid] = time.monotonic()
                    self.drain_reroutes += 1
                self._retry_or_fail(spec, tried + (cid,),
                                    NodeDrainingError(cid))
            elif rep == "need_fn" and reship_ok:
                # The node lost (or never saw) this digest: rebuild with
                # the function bytes forced in and push once more.
                with self._lock:
                    self._dec_inflight_locked(cid)
                try:
                    reship.append((spec, tried, self._build_payload(
                        spec, cid, force_fn=True)))
                except _DepNotReady:
                    # A dep's owner vanished mid-reship: back through
                    # the blocker path, same as the first-build case.
                    self._accept(spec, None, tried)
                except BaseException as exc:  # noqa: BLE001
                    self._fail(spec, exc)
            else:
                exc = rep if isinstance(rep, BaseException) else \
                    WorkerCrashedError(
                        f"node {cid} rejected task {spec.name!r}: {rep!r}")
                with self._lock:
                    self._dec_inflight_locked(cid)
                self._retry_or_fail(spec, tried + (cid,), exc)
        if reship:
            self._deliver(cid, addr, reship, reship_ok=False,
                          transfer=False)

    def _send_batch(self, cid: str, addr, payloads: list) -> list:
        """One wire round trip carrying the whole batch. Direct plane
        (vectored send_many to the node's server) unless disabled or
        unreachable; head-relayed task_push batch otherwise (those ride
        the head client's request coalescer — still ~1 round trip)."""
        if addr is not None:
            try:
                replies = self.head.task_push_direct(addr, payloads)
                with self._lock:
                    self.direct_pushes += len(payloads)
                    self.direct_batches += 1
                return replies
            except PeerUnreachableError:
                pass  # NAT / dead dial: control-plane fallback below
        replies = self.head.task_push_many(cid, payloads)
        with self._lock:
            self.relayed_pushes += len(payloads)
        return replies

    def _register_pushed(self, tid: TaskID, cid: str):
        with self._lock:
            if tid in self._completed or tid in self._failed:
                # task_done (or a failure) raced the push reply: the
                # completion path never saw a _task_node entry, so the
                # in-flight count is settled here instead. (_completed
                # is written inside _on_task_done's locked block — the
                # done Event is set too late to close this race.)
                self._dec_inflight_locked(cid)
            else:
                self._task_node[tid] = cid

    def _retry_or_fail(self, spec: TaskSpec, tried: tuple,
                       exc: BaseException):
        if len(tried) >= _MAX_PUSH_ATTEMPTS:
            self._fail(spec, WorkerCrashedError(
                f"no reachable node accepted task {spec.name!r} "
                f"(last error: {exc})"))
        else:
            self._enqueue(spec, None, tried)

    # ---------------------------------------------------------------- wire
    def _fn_wire(self, fn) -> Tuple[bytes, bytes]:
        """(digest, cloudpickle bytes) of a task function, serialized
        ONCE per function object per driver (weak-keyed cache)."""
        try:
            cached = self._fn_wire_cache.get(fn)
        except TypeError:
            cached = None
        if cached is not None:
            return cached
        import hashlib

        import cloudpickle

        fnb = cloudpickle.dumps(fn)
        cached = (hashlib.sha256(fnb).digest(), fnb)
        try:
            self._fn_wire_cache[fn] = cached
        except TypeError:  # unhashable/unweakrefable callable
            pass
        with self._lock:
            # Hot-function LRU feeding the node-join pre-ship (small,
            # bytes-bounded by entry count — fat closures are capped by
            # the node-side cache anyway).
            self._fn_recent[cached[0]] = fnb
            self._fn_recent.move_to_end(cached[0])
            while len(self._fn_recent) > 8:
                self._fn_recent.popitem(last=False)
        return cached

    def _build_payload(self, spec: TaskSpec, cid: str,
                       force_fn: bool = False) -> bytes:
        ctx = self.worker.serialization_context
        pending_refs: List[bytes] = []  # producers still in flight

        def _wire_arg(v):
            from ray_tpu_torch._private.worker import ObjectRef

            if not isinstance(v, ObjectRef):
                return ("v", ctx.serialize(v).to_bytes())
            oid = v.object_id
            ob = oid.binary()
            tid = oid.task_id()
            with self._lock:
                owner = self._oid_owner.get(ob)
            if owner is not None and self._client_alive(owner):
                return ("r", ob)
            if self.worker.store.is_ready(oid):
                # Driver-local (or recovered-to-driver) value: inline it.
                value = self.worker.get_object(v)
                return ("v", ctx.serialize(value).to_bytes())
            with self._lock:
                # Failure re-check and dep-edge registration are ONE
                # critical section with _fail's pop of _dep_children:
                # either we see the producer's failure here, or _fail
                # sees (and fires) the edge we registered — a child can
                # never ship against a failed producer unnotified.
                exc = self._failed.get(tid)
                if exc is not None:
                    raise exc
                ev = self._done.get(tid)
                done = ev is not None and ev.is_set()
                tracked = tid in self.lineage or tid in self.external
                if tracked and not done:
                    # Pending pull-ref (async dependency shipping): ship
                    # NOW and let the node daemon wait out the producer.
                    self._dep_children.setdefault(tid, set()).add(
                        spec.task_id)
                    pending_refs.append(ob)
            if tracked and not done:
                return ("r", ob)
            # Completed-but-ownerless (node died holding the bytes) or
            # untracked producer that slipped past the blocker check:
            # do NOT block this drain lane — bounce the spec back
            # through _accept, whose blocker path recovers (lineage
            # re-execution / event-driven wait) on the dedicated pool.
            raise _DepNotReady()

        digest, fnb = self._fn_wire(spec.function)
        with self._lock:
            shipped = self._fn_shipped.setdefault(cid, set())
            include_fn = force_fn or digest not in shipped
            if include_fn:
                # Optimistic mark: a push that later fails leaves a stale
                # mark, which the node's need_fn reply self-heals.
                shipped.add(digest)
        import os as _os

        payload = {
            "driver_id": self.head.client_id,
            # The driver's own object/request server: nodes push
            # task_done straight back here (head out of the completion
            # path) when they can dial it.
            "driver_addr": list(self.head._object_server.address),
            # Unique per BUILD: the node dedupes (task_id, push_id), so
            # a verbatim resend after an ambiguous wire failure cannot
            # double-execute, while deliberate re-pushes (new build)
            # are admitted.
            "push_id": _os.urandom(8),
            "task_id": spec.task_id.binary(),
            "return_ids": [o.binary() for o in spec.return_ids],
            "num_returns": spec.num_returns,
            "name": spec.name,
            "resources": spec.resources,
            "max_retries": spec.max_retries,
            "retry_exceptions": spec.retry_exceptions,
            # The task's runtime env (a dict on the wire); the daemon's
            # scheduler applies it as this process's would.
            "runtime_env": (dict(spec.runtime_env)
                            if spec.runtime_env is not None else None),
            "fn_digest": digest,
            "args": [_wire_arg(a) for a in spec.args],
            "kwargs": {k: _wire_arg(v) for k, v in spec.kwargs.items()},
        }
        if spec.streaming:
            # Streaming generator: the node commits one object per yield
            # and pushes per-item ``item_done`` reports back over this
            # same direct plane; the backpressure budget governs its
            # yield loop, resumed by this driver's consumption acks.
            payload["streaming"] = True
            payload["backpressure"] = int(spec.backpressure)
        if spec.trace is not None and tracing._TRACER is not None:
            # Trace context rides the task dict (tracing off = key
            # absent = zero extra wire bytes); the node daemon's
            # task-event bridge emits accept/queue/exec spans under it.
            payload["trace"] = tuple(spec.trace)
        if pending_refs:
            # The node gates THESE refs on its wait plane; ordinary
            # owner-resolvable pull-refs stay on its bounded pull pools.
            payload["pending_refs"] = pending_refs
        with self._lock:
            if include_fn:
                payload["fn"] = fnb
                self.fn_bytes_sent += len(fnb)
                self.fn_payloads_with_bytes += 1
            else:
                self.fn_payloads_digest_only += 1
        return pickle.dumps(payload, protocol=5)

    # -------------------------------------------------------------- failure
    def _fail(self, spec: TaskSpec, exc: BaseException):
        """Fail a task and, iteratively, every async-shipped dependent
        recorded against it (a worklist, NOT recursion — a failed
        1000-link chain must not blow the stack mid-cascade and leave
        tail tasks waiting out the dep bound)."""
        if not isinstance(exc, (RayTaskError, WorkerCrashedError)):
            exc = RayTaskError.from_exception(spec.name, exc)
        work: deque = deque([spec])
        while work:
            s = work.popleft()
            for oid in s.return_ids:
                self.worker.store.put_error(oid, exc)
            tid = s.task_id
            with self._lock:
                self._failed[tid] = exc
                self._task_target.pop(tid, None)
                children = self._dep_children.pop(tid, set())
                ev = self._done.get(tid)
            if ev is not None:
                ev.set()
            self._notify_done(tid)
            self.owner_directory.publish_many(
                [o.binary() for o in s.return_ids])
            # Dependents can never run now — fail them too instead of
            # letting their node-side pulls stall to the dep bound.
            for ctid in children:
                with self._lock:
                    cspec = None if ctid in self._failed \
                        else self.lineage.get(ctid)
                if cspec is not None:
                    work.append(cspec)

    def _fail_downstream(self, tid: TaskID, exc: BaseException):
        with self._lock:
            if tid in self._failed:
                return
            spec = self.lineage.get(tid)
        if spec is not None:
            self._fail(spec, exc)

    # ------------------------------------------------------- dep resolution
    def _on_done(self, tid: TaskID, cb: Callable[[], None]):
        """Run ``cb`` when the task's completion event fires (now, if it
        already has) — the event-driven edge `_await_dep` waits on."""
        with self._lock:
            ev = self._done.get(tid)
            if ev is None or not ev.is_set():
                self._done_cbs.setdefault(tid, []).append(cb)
                return
        cb()

    def _notify_done(self, tid: TaskID):
        with self._lock:
            cbs = self._done_cbs.pop(tid, [])
        for cb in cbs:
            try:
                cb()
            except Exception:  # noqa: BLE001 — waiter callback bug
                pass

    def _await_dep(self, object_id: ObjectID,
                   timeout: Optional[float] = None):
        """Event-driven wait until a dependency is PRODUCED — locally
        ready in the store, or completed by a router-tracked remote task
        (wherever its bytes live). No poll loops: the store's on_ready
        callback and the router's completion callbacks both flip one
        event. Raises the producer's error if it failed, or a typed
        ``GetTimeoutError`` after ``RAY_TPU_DEP_WAIT_S``."""
        if timeout is None:
            timeout = GlobalConfig.dep_wait_s
        tid = object_id.task_id()
        produced = threading.Event()
        self.worker.store.on_ready(object_id, produced.set)
        with self._lock:
            tracked = (tid in self._done or tid in self.lineage
                       or tid in self.external)
        if tracked:
            # Untracked producers never fire _notify_done — registering
            # would leak the callback forever; their completion signal
            # is the store's on_ready above.
            self._on_done(tid, produced.set)
        if not produced.wait(timeout):
            raise GetTimeoutError(
                f"dependency {object_id.hex()[:16]}… was not produced "
                f"within {timeout:.0f}s (RAY_TPU_DEP_WAIT_S)")
        with self._lock:
            exc = self._failed.get(tid)
        if exc is not None:
            raise exc
        err = self.worker.store.peek_error(object_id)
        if err is not None:
            raise err

    def _client_alive(self, client_id: str) -> bool:
        return any(n["client_id"] == client_id and n.get("alive")
                   for n in self.nodes())

    def _holder_addr(self, client_id: str) -> Optional[Tuple[str, int]]:
        """Direct object-server address of the node currently holding
        an object's bytes (owner directory answers carry this)."""
        with self._lock:
            node = self._node_rec.get(client_id)
        if node is None:
            node = next((n for n in self.nodes()
                         if n["client_id"] == client_id), None)
        return self._node_addr(node) if node else None

    # ----------------------------------------------------------- completion
    def _dec_inflight_locked(self, cid: str):
        n = self._inflight.get(cid, 0) - 1
        if n <= 0:
            self._inflight.pop(cid, None)
        else:
            self._inflight[cid] = n

    def _dec_assigned_locked(self, cid: str):
        n = self._assigned.get(cid, 0) - 1
        if n <= 0:
            self._assigned.pop(cid, None)  # floor at zero: transient
        else:                              # imprecision must not stick
            self._assigned[cid] = n

    def _on_task_done_direct(self, msg: tuple):
        with self._lock:
            self.direct_done_reports += 1
        return self._on_task_done(msg)

    def _on_task_done_relayed(self, event: tuple):
        with self._lock:
            self.relayed_done_reports += 1
        return self._on_task_done(event)

    def _on_task_done(self, event: tuple):
        from ray_tpu_torch._private.serialization import SerializedObject

        payload = pickle.loads(event[1])
        tid = TaskID(payload["task_id"])
        # Task errors ride the done payload (no pullable bytes exist for
        # them): materialize them locally so gets raise promptly instead
        # of pull-looping against an owner that can never serve them.
        err_objs: Dict[bytes, BaseException] = {}
        first_exc: Optional[BaseException] = None
        for ob, eb in (payload.get("errs") or {}).items():
            try:
                exc = pickle.loads(eb)
            except Exception:  # noqa: BLE001 — error didn't survive wire
                exc = WorkerCrashedError(
                    "remote task failed and its error was not "
                    "transferable")
            err_objs[bytes(ob)] = exc
            if first_exc is None:
                first_exc = exc
        with self._lock:
            for ob in payload["oid_bins"]:
                ob = bytes(ob)
                if ob in err_objs:
                    self._oid_owner.pop(ob, None)
                else:
                    self._oid_owner[ob] = payload["node_client"]
            for ob, sz in (payload.get("sizes") or {}).items():
                self._oid_sizes[bytes(ob)] = int(sz)
            while len(self._oid_sizes) > 131072:
                # Locality hints only — recency-bounded (FIFO via dict
                # insertion order), unlike the pre-existing lineage maps.
                self._oid_sizes.pop(next(iter(self._oid_sizes)))
            self._completed.add(tid)
            self._completed_order.append(tid)
            while len(self._completed_order) > 65536:
                self._completed.discard(self._completed_order.popleft())
            cid = self._task_node.pop(tid, None)
            if cid is not None:
                self._dec_inflight_locked(cid)
            self._task_target.pop(tid, None)
            # Stream bookkeeping ends with the task: no more item
            # reports will need acks, and leaving entries behind grows
            # the router unboundedly under continuous streaming load.
            self._stream_tasks.discard(tid)
            self._stream_ack_pending.pop(tid, None)
            if first_exc is not None:
                self._failed.setdefault(tid, first_exc)
            children = self._dep_children.pop(tid, set())
            ev = self._done.setdefault(tid, threading.Event())
        for ob, exc in err_objs.items():
            self.worker.store.put_error(ObjectID(ob), exc)
        # Small results ride the done payload itself (the reference's
        # small-return-to-owner path): materialize them before waking
        # waiters, so gets never pay a pull round trip for them.
        for ob, raw in (payload.get("inline") or {}).items():
            self.worker.store.put(
                ObjectID(bytes(ob)), SerializedObject.from_bytes(raw))
            with self._lock:
                self.inline_results += 1
        ev.set()
        self._notify_done(tid)
        # Owner directory: wake any peer subscribed to these results
        # (no-op when nobody asked — the common case).
        self.owner_directory.publish_many(
            [bytes(ob) for ob in payload["oid_bins"]])
        if first_exc is not None:
            for ctid in children:
                self._fail_downstream(ctid, first_exc)
        # Node task events ride home on this report (zero new head
        # RPCs): merge them so util.state.list_tasks() sees cluster
        # tasks, and stamp the driver-side completion into the trace.
        shipped = payload.get("node_events")
        if shipped:
            node_client = payload["node_client"]
            self.worker.task_events.ingest(
                (TaskID(bytes(tb)), state, ts, name, dur, node_client)
                for tb, state, ts, name, dur in shipped)
        if tracing._TRACER is not None:
            ctx = tracing.task_context(bytes(payload["task_id"]))
            if ctx is not None:
                tracing.event("task.done", ctx=ctx,
                              node=payload["node_client"],
                              error=str(first_exc is not None))
        return None

    def _on_task_events(self, msg: tuple):
        """Tail task events from a node (no completion report left to
        ride): merge them into the driver's state-API ring."""
        node_client, events = pickle.loads(bytes(msg[1]))
        return self.worker.task_events.ingest(
            (TaskID(bytes(tb)), state, ts, name, dur, node_client)
            for tb, state, ts, name, dur in events)

    # --------------------------------------------------------------- drain
    def _on_object_offload(self, msg: tuple):
        """A draining node lease-transfers result bytes it holds for
        this owner: store them locally and re-point the owner table at
        ourselves — borrowers' ``owner_locate`` then resolves against
        OUR store/server, and reap cannot strand the refs."""
        from ray_tpu_torch._private.serialization import SerializedObject

        stored = 0
        for ob, raw in msg[1]:
            oid = ObjectID(bytes(ob))
            if not self.worker.store.is_ready(oid):
                self.worker.store.put(
                    oid, SerializedObject.from_bytes(bytes(raw)))
            with self._lock:
                # Local bytes win every later lookup (OwnerDirectory
                # checks the store first); drop the stale holder entry.
                self._oid_owner.pop(bytes(ob), None)
                self.offloaded_objects += 1
            stored += 1
        self.owner_directory.publish_many(
            [bytes(ob) for ob, _ in msg[1]])
        return stored

    def _on_node_event(self, payload):
        """Membership event (head pub/sub): a newly joined node gets
        this driver's hot function bytes pushed ahead of its first
        task (cold-start attack: the first fan-out wave on a fresh
        autoscaled node skips the need_fn round trip)."""
        try:
            if not isinstance(payload, dict) or \
                    payload.get("event") != "node_added":
                return
            cid = payload.get("client_id")
            with self._lock:
                fn_bytes = list(self._fn_recent.values())
            if not fn_bytes or cid is None:
                return
            self._prefetch_pool.submit(self._preship_fns, cid, fn_bytes)
        except Exception:  # noqa: BLE001 — keep the event thread alive
            pass

    def _preship_fns(self, cid: str, fn_bytes: list):
        # The join event can beat the node's first heartbeat (which
        # carries its direct-server address): wait it out briefly.
        addr = None
        for _ in range(20):
            node = next((n for n in self.nodes(refresh=True)
                         if n["client_id"] == cid), None)
            addr = self._node_addr(node) if node else None
            if addr is not None or self._stop.is_set():
                break
            time.sleep(0.25)
        if addr is None:
            return
        try:
            self.head._peers.call(addr, ("fn_preship", fn_bytes))
            import hashlib

            with self._lock:
                self.fn_preship_sent += len(fn_bytes)
                # Mark the digests shipped for this node: payload
                # builds go digest-only on the first push (the whole
                # point); the node's need_fn reply self-heals any
                # divergence, same as every other stale mark.
                shipped = self._fn_shipped.setdefault(cid, set())
                for fnb in fn_bytes:
                    shipped.add(hashlib.sha256(fnb).digest())
        except Exception as exc:  # noqa: BLE001 — cold node not yet
            log.debug("fn pre-ship to %s failed (need_fn covers it): "
                      "%r", cid, exc)

    # ----------------------------------------------------------- streaming
    def _track_stream(self, spec: TaskSpec):
        """First acceptance of a streaming spec: install the consumption
        listener (acks propagate to whichever node currently runs the
        producer) and the head-relayed fallback subscription."""
        with self._lock:
            if spec.task_id in self._stream_tasks:
                return  # re-accept (replay): listener already installed
            self._stream_tasks.add(spec.task_id)
            need_sub = not self._stream_sub
            self._stream_sub = True
        if need_sub:
            try:
                self.head.subscribe(f"stream|{self.head.client_id}",
                                    self._on_stream_pub)
            except Exception:  # noqa: BLE001 — direct plane still works
                pass
        stream = self.worker.streams.get_or_create(spec.task_id)
        stream.add_consume_listener(
            lambda n, _tid=spec.task_id: self._send_stream_ack(_tid, n))

    def _on_stream_pub(self, payload):
        """Head-relayed fallback for per-item reports (NAT'd nodes)."""
        try:
            if payload and payload[0] == "item_done":
                self._on_item_done(("item_done", payload[1]))
        except Exception:  # noqa: BLE001 — keep the event thread alive
            pass

    def _on_item_done(self, msg: tuple):
        """One yield committed on the producing node: small items arrive
        INLINE (materialize -> the consumer's next() unblocks on the
        store event); large items record owner + size so next() drives a
        p2p pull."""
        from ray_tpu_torch._private.serialization import SerializedObject

        payload = pickle.loads(bytes(msg[1]))
        tid = TaskID(bytes(payload["task_id"]))
        stream = self.worker.streams.get(tid)
        if stream is None:
            # The consumer already closed/released this stream: a late
            # report must not resurrect a StreamState nothing will pop,
            # nor pin item bytes the generator's one-shot free covered.
            return None
        oid = ObjectID(bytes(payload["oid"]))
        raw = payload.get("inline")
        if raw is not None:
            self.worker.store.put(oid, SerializedObject.from_bytes(raw))
        else:
            size = int(payload.get("size", 0))
            with self._lock:
                self._oid_owner[oid.binary()] = payload["node_client"]
                self._oid_sizes[oid.binary()] = size
            stream.known_remote_sizes[int(payload["idx"])] = size
        stream.commit(int(payload["idx"]))
        if tracing._TRACER is not None:
            ctx = tracing.extract(payload.get("trace"))
            if ctx is not None:
                tracing.event("stream.item", ctx=ctx,
                              idx=int(payload["idx"]),
                              node=payload["node_client"])
        self.owner_directory.publish_many([oid.binary()])
        return None

    def _stream_node(self, tid: TaskID):
        """(addr, client_id) of the node currently running a stream's
        producer, or (None, None)."""
        with self._lock:
            cid = self._task_node.get(tid) or self._task_target.get(tid)
            node = self._node_rec.get(cid) if cid else None
        if node is None and cid is not None:
            node = next((n for n in self.nodes()
                         if n["client_id"] == cid), None)
        return (self._node_addr(node) if node else None), cid

    def _send_stream_ack(self, tid: TaskID, n: int):
        """Coalesced, single-flight-per-task ack sender: only the LATEST
        consumption watermark matters, so a fast consumer costs one wire
        message per flush, not one per item."""
        with self._lock:
            cur = self._stream_ack_pending.get(tid, 0)
            self._stream_ack_pending[tid] = max(cur, n)
            if tid in self._stream_ack_inflight:
                return
            self._stream_ack_inflight.add(tid)
        self._prefetch_pool.submit(self._flush_stream_acks, tid)

    def _flush_stream_acks(self, tid: TaskID):
        while True:
            with self._lock:
                n = self._stream_ack_pending.pop(tid, None)
                if n is None:
                    self._stream_ack_inflight.discard(tid)
                    return
            self._stream_ctl(tid, ("stream_ack", tid.binary(), int(n)),
                             ("ack", tid.binary(), int(n)))

    def cancel_stream(self, tid: TaskID):
        """Generator dropped/closed consumer-side: cancel the in-flight
        producer task on its node (cooperative — the node's yield loop
        stops between yields) and release its stream state."""
        with self._lock:
            self._stream_tasks.discard(tid)
            self._stream_ack_pending.pop(tid, None)
        self._stream_ctl(tid, ("stream_cancel", tid.binary()),
                         ("cancel", tid.binary()))

    def _stream_ctl(self, tid: TaskID, direct_msg: tuple, pub_msg: tuple):
        addr, cid = self._stream_node(tid)
        if cid is None:
            return
        if addr is not None:
            try:
                self.head._peers.call(addr, direct_msg)
                return
            except Exception:  # noqa: BLE001 — fall back to the relay
                pass
        try:
            self.head.publish(f"stream|{cid}", pub_msg)
        except Exception:  # noqa: BLE001 — producer stays paused until
            pass           # the next watermark flush retries

    def handles(self, object_id: ObjectID) -> bool:
        with self._lock:
            tid = object_id.task_id()
            return tid in self.lineage or tid in self.external

    def prefetch(self, object_id: ObjectID, timeout: float = 30.0):
        """Background ensure_local with in-flight dedup: wait() polls may
        call this repeatedly without saturating the router pool."""
        with self._lock:
            if object_id in self._prefetching:
                return
            self._prefetching.add(object_id)

        def _run():
            try:
                self.ensure_local(object_id, timeout=timeout,
                                  _from_prefetch=True)
            except Exception:  # noqa: BLE001 — best-effort prefetch
                pass
            finally:
                with self._lock:
                    self._prefetching.discard(object_id)

        self._prefetch_pool.submit(_run)

    def ensure_local(self, object_id: ObjectID,
                     timeout: Optional[float] = None,
                     _from_prefetch: bool = False) -> None:
        """Block until a router-owned object's bytes are in the local
        store: wait on the completion event (with pull-polling so a
        missed task_done event cannot hang us), chunk-pull from the
        owning node, and re-execute from lineage if the owner died
        first. External (actor-task) results are never re-executed;
        their post-completion pull retries are BOUNDED by the owner's
        pin TTL — past it an ObjectLostError materializes into the
        store instead of ray_tpu_torch.get hanging forever on evicted bytes."""
        from ray_tpu_torch._private.serialization import SerializedObject
        from ray_tpu_torch.exceptions import ObjectLostError

        deadline = None if timeout is None else time.monotonic() + timeout
        tid = object_id.task_id()
        external_deadline = None
        backoff = 0.05
        next_head_poll = time.monotonic() + 2.0
        while not self.worker.store.is_ready(object_id):
            if deadline is not None and time.monotonic() > deadline:
                raise GetTimeoutError(
                    f"remote object {object_id.hex()[:16]}… not available "
                    f"within timeout")
            with self._lock:
                ev = self._done.get(tid)
                exc = self._failed.get(tid)
            if exc is not None:
                return  # error already materialized into the store
            if not _from_prefetch:
                # A background prefetch is already transferring this
                # object: wait for it instead of starting a duplicate
                # full-byte pull (get() kicks off prefetches for the
                # whole ref list right before its foreground loop).
                with self._lock:
                    prefetching = object_id in self._prefetching
                if prefetching:
                    self.worker.store.wait([object_id], 1, timeout=0.25)
                    continue
            if ev is not None:
                # Event-driven completion wakeup; the bounded wait only
                # covers the missed-task_done case (head restart).
                ev.wait(timeout=0.5)
            # OWNER-table pull first: this driver owns the object and
            # learned its holder from the direct completion stream — the
            # transfer is p2p, zero head involvement.
            raw = None
            ob = object_id.binary()
            with self._lock:
                holder = self._oid_owner.get(ob)
            if holder is not None:
                addr = self._holder_addr(holder)
                if addr is not None:
                    raw = self.head._peers.pull_retrying(addr, ob)
                    if raw is not None:
                        with self._lock:
                            self.owner_table_pulls += 1
                if raw is None and self._client_alive(holder):
                    # Holder alive but not directly reachable (NAT,
                    # poisoned lanes): the head relays the bytes from
                    # the holder WE name — its directory is not
                    # consulted (the owner's table is the directory).
                    try:
                        raw = self.head.object_pull_from(holder, ob)
                    except RayTaskError as task_exc:
                        self.worker.store.put_error(object_id, task_exc)
                        return
                    except Exception as exc:  # noqa: BLE001 — head busy
                        log.debug("relay-from-holder pull failed: %r",
                                  exc)
                        raw = None
            done_now = ev is not None and ev.is_set()
            if raw is None and (done_now
                                or time.monotonic() >= next_head_poll):
                # Head FALLBACK directory: relay-path locations, lease-
                # transferred entries, and the missed-task_done edge
                # (head restart). While the producer is still running
                # this is throttled — a pending result must not turn
                # into a per-round head RPC.
                next_head_poll = time.monotonic() + 2.0
                try:
                    raw = self.head.object_pull(ob)
                except RayTaskError as task_exc:
                    # The owner's store holds the task's ERROR, not bytes
                    # — surface it instead of retrying a pull that can
                    # never produce data (belt-and-braces for a missed
                    # errs payload, e.g. across a head restart).
                    self.worker.store.put_error(object_id, task_exc)
                    return
                except Exception as exc:  # head hiccup: retry loop
                    log.debug("ensure_local pull failed; retrying: %r",
                              exc)
                    raw = None
            if raw is not None:
                self.worker.store.put(
                    object_id, SerializedObject.from_bytes(raw))
                return
            if ev is not None and ev.is_set():
                with self._lock:
                    external = tid in self.external
                    has_lineage = tid in self.lineage
                if not external and not has_lineage:
                    # Completed, owner can't serve the bytes, and there
                    # is no lineage spec to re-execute (lineage pinning
                    # off / spec dropped): unbounded pull retries can
                    # never converge — bound them like the external
                    # case and materialize a typed loss. Chaos-induced
                    # connection resets land here instead of spinning.
                    if external_deadline is None:
                        external_deadline = (
                            time.monotonic()
                            + EXTERNAL_PULL_TTL_S)
                    elif time.monotonic() > external_deadline:
                        self.worker.store.put_error(
                            object_id, ObjectLostError(
                                f"object {object_id.hex()[:16]}… "
                                f"completed but its bytes are no longer "
                                f"served by any node and no lineage is "
                                f"pinned to reconstruct it"))
                        return
                    if self._stop.wait(backoff):
                        return  # router shutting down
                    # Jittered exponential backoff: concurrent pullers
                    # must not stampede a recovering owner in lockstep.
                    backoff = min(backoff * 2, 1.0)
                    continue
                if external:
                    # Actor-task result: never re-executed. The hosting
                    # node may still be serializing — retry with backoff;
                    # if the node died, the RemoteActorRuntime watcher
                    # materializes an ActorDiedError. If the node is
                    # alive but its pin TTL/cap evicted the bytes, every
                    # pull returns None forever — bound the retries and
                    # declare the object lost.
                    if external_deadline is None:
                        external_deadline = (
                            time.monotonic()
                            + EXTERNAL_PULL_TTL_S)
                    elif time.monotonic() > external_deadline:
                        self.worker.store.put_error(
                            object_id, ObjectLostError(
                                f"remote actor-task result "
                                f"{object_id.hex()[:16]}… completed but "
                                f"its bytes are no longer served by the "
                                f"hosting node (result pin expired or "
                                f"evicted); actor tasks are not "
                                f"re-executed from lineage"))
                        return
                    if self._stop.wait(backoff):
                        return  # router shutting down
                    backoff = min(backoff * 2, 1.0)
                    continue
                # Task finished but its owner cannot serve the bytes:
                # the node died holding them. Re-execute from lineage.
                self._reexecute(tid)

    def _reexecute(self, tid: TaskID):
        with self._lock:
            spec = self.lineage.get(tid)
            if spec is None or tid in self._recovering:
                return
            self._recovering.add(tid)
            self._completed.discard(tid)  # re-executing: not done anymore
            ev = self._done.get(tid)
            if ev is not None:
                ev.clear()
            dead = self._task_node.pop(tid, None)
            if dead is not None:
                self._dec_inflight_locked(dead)
            # Result locations on the dead owner are stale now.
            for ob in [o.binary() for o in spec.return_ids]:
                self._oid_owner.pop(ob, None)
        # Recover args that lived on dead nodes first (transitive lineage).
        for ref in _collect_refs(spec.args, spec.kwargs):
            ob = ref.object_id.binary()
            with self._lock:
                owner = self._oid_owner.get(ob)
            if owner is not None and not self._client_alive(owner) \
                    and not self.worker.store.is_ready(ref.object_id):
                with self._lock:
                    self._oid_owner.pop(ob, None)
                self.ensure_local(ref.object_id, timeout=60.0)
        try:
            self._accept(spec, None, tried=(dead,) if dead else ())
        finally:
            with self._lock:
                self._recovering.discard(tid)

    # ------------------------------------------------------------- watcher
    def _watch_loop(self):
        """Re-route in-flight tasks off dead nodes (node failure
        detection: membership comes from the head's heartbeat monitor)."""
        while not self._stop.wait(0.5):
            with self._lock:
                parked = bool(self._parked)
                inflight = dict(self._task_node)
                actors = list(self.remote_actors)
            if parked:
                self._retry_parked()
            if not inflight and not actors:
                continue
            nodes = self.nodes(refresh=True)
            alive = {n["client_id"] for n in nodes if n.get("alive")}
            for rt in actors:
                try:
                    rt.check_node(alive)
                except Exception as exc:  # keep the watcher alive
                    log.warning("remote-actor liveness check failed; "
                                "watcher continues: %r", exc)
            with self._lock:
                self.remote_actors = [rt for rt in self.remote_actors
                                      if not rt.dead]
            if not inflight:
                continue
            for tid, client_id in inflight.items():
                if client_id in alive:
                    continue
                with self._lock:
                    spec = self.lineage.get(tid)
                    still_there = self._task_node.get(tid) == client_id
                    if still_there:
                        self._task_node.pop(tid, None)
                        self._dec_inflight_locked(client_id)
                if spec is None or not still_there:
                    continue
                if spec.attempt >= spec.max_retries:
                    # Retries exhausted (max_retries=0 tasks never
                    # replay): materialize the typed error — for a
                    # streaming task it lands on the end marker, so the
                    # consumer's next() raises instead of hanging.
                    self._fail(spec, WorkerCrashedError(
                        f"task {spec.name!r} was in flight on a node "
                        f"that died and max_retries={spec.max_retries} "
                        f"is exhausted"))
                    continue
                import dataclasses

                retry = dataclasses.replace(spec, attempt=spec.attempt + 1)
                self._accept(retry, None, tried=(client_id,))

    def shutdown(self):
        self._stop.set()
        # Lease handoff: directory entries that must outlive this owner
        # (bytes living on cluster nodes) transfer to the head's
        # fallback directory in ONE coalesced flight, so borrowers of a
        # gracefully-exited driver keep resolving. A SIGKILLed owner
        # skips this — its consumers fail typed (OwnerDiedError).
        try:
            entries = self.owner_directory.snapshot_locations()
            if entries:
                self.head.object_transfer_many(entries)
        except Exception as exc:  # noqa: BLE001 — head gone: the
            log.debug("lease handoff failed (head unreachable); "
                      "borrowed refs will fail typed: %r", exc)
        with self._dispatch_cv:
            self._dispatch_cv.notify_all()
        self._pool.shutdown(wait=False, cancel_futures=True)
        self._prefetch_pool.shutdown(wait=False, cancel_futures=True)
