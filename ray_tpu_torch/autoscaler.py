"""Demand-driven autoscaling (counterpart of ``ray_tpu/autoscaler.py``).

Two autoscalers. ``AutoscalingCluster`` grows and shrinks the simulated
``cluster_utils.Cluster`` in this process: a monitor thread watches
infeasible task submissions, unplaceable placement groups, explicit
``request_resources`` asks and scheduler backlog, bin-packs the unmet
shapes onto configured node types, launches simulated nodes (within each
type's ``min_workers``/``max_workers``) and removes nodes idle past the
timeout. ``ClusterAutoscaler`` does the same for REAL nodes against a
head service: it reads demand from the head (``demand_report``: the
unmet shapes each router advertises, ``remote_router.unmet_shapes``,
and each node's backlog), launches node daemons through a
``NodeProvider`` (``LocalSubprocessProvider`` spawns ``python -m
ray_tpu_torch._private.node_daemon``; the types one update bin-packs
launch at once, each on its own thread), drains a node before it
reaps it (claiming it first, so two reap passes drain it once), and
keeps parked demand through a provider brown-out. ``summary`` feeds
``util.state.autoscaler_summary`` and the dashboard's ``/api/elastic``.

**The card.** A port daemon advertises ``GPU`` as the count of CUDA
cards its process sees, while the bin-packer plans on the shape a type
DECLARES, so the provider makes the two meet: a type that declares no
``GPU`` is launched with ``CUDA_VISIBLE_DEVICES=""`` (it advertises no
card, and the router never places card work there); a type that
declares ``GPU: n`` is given n cards of the provider's own through
``CUDA_VISIBLE_DEVICES``, so that nodes on a many-card host hold
disjoint cards. The provider's cards are the ``CUDA_VISIBLE_DEVICES``
list of its ``env`` (else of its own environment), else every card the
host has; a card is free again once the node that held it has exited
(reaped, or dead). A launch that finds fewer free cards than its type
declares is a failed attempt before anything is spawned. Once the node
joins, the provider reads the count it advertises from the head. The
count the daemon sees wins, and a launch whose count differs from the
declared one is a failed attempt: the node is killed before it is
handed to the autoscaler. When the attempts run out the launch raises
``NodeLaunchFailedError``. ``GPU`` never rides ``--resources``,
so no node advertises a card it cannot see.
"""

from __future__ import annotations

import threading
import time
import uuid
import weakref
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.log import get_logger
from ray_tpu_torch.cluster_utils import Cluster, SimNode

log = get_logger(__name__)

# Drain before reap: an idle node chosen for reap waits this long for its
# in-flight tasks to finish and its held results to move to their owners
# before it is terminated undrained.
DRAIN_TIMEOUT_S = 15.0


@dataclass
class NodeTypeConfig:
    """One launchable node shape (reference: available_node_types entry)."""

    name: str
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 10


@dataclass
class _NodeMeta:
    type_name: str
    idle_since: Optional[float] = None  # None = busy


class AutoscalingCluster(Cluster):
    """A Cluster that grows and shrinks with demand.

    Tasks whose resource shape no current node can ever satisfy are parked
    (instead of failing, as the fixed Cluster does) until the monitor
    provisions a node type that fits; same for placement groups.
    """

    def __init__(self, node_types: List[NodeTypeConfig],
                 head_resources: Optional[Dict[str, float]] = None,
                 idle_timeout_s: float = 2.0,
                 update_interval_s: float = 0.1):
        head = dict(head_resources or {"CPU": 1})
        super().__init__(initialize_head=True,
                         head_node_args={"num_cpus": int(head.get("CPU", 1)),
                                         "resources": {k: v
                                                       for k, v in head.items()
                                                       if k != "CPU"}})
        self.node_types = {t.name: t for t in node_types}
        self.idle_timeout_s = idle_timeout_s
        self._interval = update_interval_s
        self._meta: Dict[SimNode, _NodeMeta] = {}
        self._pending_specs: List[Any] = []
        self._pending_pgs: List[Any] = []
        self._requested: List[Dict[str, float]] = []
        self._as_lock = threading.Lock()
        self._stop = threading.Event()
        self.launched: List[str] = []    # type names, launch order
        self.terminated: List[str] = []  # type names, termination order
        for t in node_types:
            for _ in range(t.min_workers):
                self._launch(t)
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name="ray_tpu_torch_autoscaler")
        self._monitor.start()

    # ------------------------------------------------------------ demand in
    def submit(self, spec):
        try:
            super().submit(spec)
        except RuntimeError:
            if not self._fits_some_type(spec.resources):
                raise  # no configured node type can EVER satisfy this
            # Infeasible today: park it; the monitor provisions a node type
            # that fits and resubmits (upstream queues in the raylet and
            # the autoscaler sees it via resource_demand).
            with self._as_lock:
                self._pending_specs.append(spec)

    def reserve_placement_group(self, pg):
        try:
            super().reserve_placement_group(pg)
        except ValueError:
            if not all(self._fits_some_type(b) for b in pg.bundles):
                raise  # a bundle no node type can ever host
            with self._as_lock:
                self._pending_pgs.append(pg)

    def request_resources(self, bundles: List[Dict[str, float]]):
        """Explicit demand floor (reference: autoscaler sdk
        request_resources): provision capacity for these shapes even with
        no tasks submitted yet."""
        with self._as_lock:
            self._requested = [dict(b) for b in bundles]

    # --------------------------------------------------------- provisioning
    def _launch(self, t: NodeTypeConfig) -> Optional[SimNode]:
        count = sum(1 for m in self._meta.values() if m.type_name == t.name)
        if count >= t.max_workers:
            return None
        res = dict(t.resources)
        node = self.add_node(num_cpus=int(res.pop("CPU", 1)), resources=res)
        self._meta[node] = _NodeMeta(t.name)
        self.launched.append(t.name)
        return node

    def _terminate(self, node: SimNode):
        meta = self._meta.pop(node, None)
        if meta is not None:
            self.terminated.append(meta.type_name)
        self.remove_node(node, lose_objects=False)

    def _fits_some_type(self, shape: Dict[str, float]) -> bool:
        return any(
            all(t.resources.get(k, 0.0) >= v for k, v in shape.items())
            for t in self.node_types.values())

    def _unmet_shapes(self) -> List[Dict[str, float]]:
        """Resource shapes with no node that could (eventually) run them."""
        with self._as_lock:
            shapes = [s.resources for s in self._pending_specs]
            for pg in self._pending_pgs:
                shapes.extend(pg.bundles)
            shapes.extend(self._requested)
        with self._lock:
            alive = [n for n in self.nodes if n.alive]
        unmet = []
        capacity = [dict(n.resource_pool.total) for n in alive]
        for shape in shapes:
            placed = False
            for cap in capacity:  # first-fit against existing capacity
                if all(cap.get(k, 0.0) >= v for k, v in shape.items()):
                    for k, v in shape.items():
                        cap[k] = cap.get(k, 0.0) - v
                    placed = True
                    break
            if not placed:
                unmet.append(dict(shape))
        return unmet

    def _backlog_pressure(self) -> int:
        """Queued-beyond-capacity task count across alive nodes."""
        with self._lock:
            alive = [n for n in self.nodes if n.alive]
        pressure = 0
        for n in alive:
            cpus = max(int(n.resource_pool.total.get("CPU", 1)), 1)
            pressure += max(n.scheduler.backlog_size() - cpus, 0)
        return pressure

    def _bin_pack(self, shapes: List[Dict[str, float]]):
        """Pick node types covering the shapes (first-fit decreasing by
        CPU), respecting max_workers."""
        to_launch: List[NodeTypeConfig] = []
        headroom: List[Dict[str, float]] = []
        for shape in sorted(shapes, key=lambda s: -s.get("CPU", 0.0)):
            placed = False
            for cap in headroom:
                if all(cap.get(k, 0.0) >= v for k, v in shape.items()):
                    for k, v in shape.items():
                        cap[k] = cap.get(k, 0.0) - v
                    placed = True
                    break
            if placed:
                continue
            for t in sorted(self.node_types.values(),
                            key=lambda t: t.resources.get("CPU", 0.0)):
                if all(t.resources.get(k, 0.0) >= v
                       for k, v in shape.items()):
                    planned = (sum(1 for m in self._meta.values()
                                   if m.type_name == t.name)
                               + sum(1 for x in to_launch
                                     if x.name == t.name))
                    if planned >= t.max_workers:
                        continue
                    to_launch.append(t)
                    cap = dict(t.resources)
                    for k, v in shape.items():
                        cap[k] = cap.get(k, 0.0) - v
                    headroom.append(cap)
                    break
        return to_launch

    # -------------------------------------------------------------- monitor
    def _monitor_loop(self):
        while not self._stop.wait(self._interval):
            try:
                self._update()
            except Exception as exc:  # monitor must not die
                log.warning("autoscaler update failed; retrying next "
                            "period: %r", exc)

    def _update(self):
        # 1. Scale up for unmet demand.
        unmet = self._unmet_shapes()
        if self._backlog_pressure() > 0:
            with self._lock:
                alive = [n for n in self.nodes if n.alive]
            has_free_cpu = any(
                n.resource_pool.available().get("CPU", 0.0) >= 1.0
                for n in alive)
            if not has_free_cpu:
                # Generic pressure: at most one extra CPU node per tick;
                # the idle reaper trims any overshoot.
                unmet.append({"CPU": 1.0})
        for t in self._bin_pack(unmet):
            self._launch(t)

        # 2. Retry parked work now that capacity may exist.
        with self._as_lock:
            specs, self._pending_specs = self._pending_specs, []
            pgs, self._pending_pgs = self._pending_pgs, []
        for spec in specs:
            self.submit(spec)  # re-parks if still infeasible
        for pg in pgs:
            self.reserve_placement_group(pg)

        # 3. Scale down idle nodes past the timeout (never below
        # min_workers; the head node is not managed).
        now = time.monotonic()
        with self._as_lock:
            requested = list(self._requested)
        with self._lock:
            nodes = [n for n in self.nodes if n.alive and n in self._meta]
        for node in nodes:
            if any(all(node.resource_pool.total.get(k, 0.0) >= v
                       for k, v in shape.items()) for shape in requested):
                continue  # request_resources floor covers this node
            busy = (node.resource_pool.utilization() > 0
                    or node.scheduler.backlog_size() > 0)
            meta = self._meta[node]
            if busy:
                meta.idle_since = None
                continue
            if meta.idle_since is None:
                meta.idle_since = now
                continue
            if now - meta.idle_since < self.idle_timeout_s:
                continue
            t = self.node_types[meta.type_name]
            count = sum(1 for m in self._meta.values()
                        if m.type_name == meta.type_name)
            if count > t.min_workers:
                self._terminate(node)

    def num_nodes_of_type(self, name: str) -> int:
        return sum(1 for m in self._meta.values() if m.type_name == name)

    def shutdown(self):
        self._stop.set()
        self._monitor.join(timeout=2)
        super().shutdown()


# ===================================================================== real
class NodeProvider:
    """Launches/terminates REAL cluster nodes (reference role:
    autoscaler v1 NodeProvider — AWS/GCP/local implementations). A
    provider returns an opaque handle per launched node; the autoscaler
    owns lifecycle decisions, the provider owns mechanism. ``launch``
    may be called from several threads at once (the types one update
    bin-packs launch together), so a provider must be thread-safe."""

    def launch(self, node_type: "NodeTypeConfig"):
        raise NotImplementedError

    def terminate(self, handle) -> None:
        raise NotImplementedError

    def poll_alive(self, handle) -> bool:
        raise NotImplementedError


class _CardsShort(Exception):
    """Fewer free cards than a node type declares: a failed attempt."""


class _Reserved:
    """The holder of a card between its reservation and its node's
    launch: held (``poll`` says running)."""

    @staticmethod
    def poll():
        return None


_RESERVED = _Reserved()


class LocalSubprocessProvider(NodeProvider):
    """Launches genuine ``node_daemon`` OS processes against a head —
    the FakeMultiNodeProvider analogue, except the nodes are real: they
    register with the head, lease tasks, host actors, and die by
    SIGTERM. A type without ``GPU`` is launched with the cards hidden; a
    type that declares ``GPU: n`` gets n of the provider's cards and must
    advertise that count (module docstring).

    Launch failures are TYPED: each attempt waits out the launching-
    node grace window (``RAY_TPU_AUTOSCALER_LAUNCH_GRACE_S`` — a slow
    cold start is not a dead node), failed attempts retry with jittered
    exponential backoff (``RAY_TPU_AUTOSCALER_LAUNCH_RETRIES`` /
    ``_BACKOFF_S``), and exhaustion raises ``NodeLaunchFailedError``
    instead of surfacing as silent membership absence.
    ``launch_attempts``/``launch_failures`` count every try (exposed
    through ``util.state.autoscaler_summary``)."""

    def __init__(self, address: str, worker_mode: Optional[str] = None,
                 env: Optional[Dict[str, str]] = None):
        self.address = address
        self.worker_mode = worker_mode
        self.env = env
        self.launch_attempts = 0   # every provider launch try
        self.launch_failures = 0   # tries that did not produce a node
        self._count_lock = threading.Lock()   # launches run concurrently
        self._cards: Optional[List[str]] = None   # _card_pool
        self._holders: Dict[str, Any] = {}    # card -> the node's process

    def _card_pool(self) -> List[str]:
        """The cards this provider hands out (module docstring)."""
        if self._cards is None:
            import os

            env = self.env if self.env is not None else os.environ
            visible = env.get("CUDA_VISIBLE_DEVICES")
            if visible is not None:
                self._cards = [c.strip() for c in visible.split(",")
                               if c.strip()]
            else:
                import torch

                self._cards = [str(i)
                               for i in range(torch.cuda.device_count())]
        return self._cards

    def _take_cards(self, n: int) -> List[str]:
        """Up to n free cards, reserved until ``_hold`` hands them to the
        node's process (or ``None``: free again)."""
        with self._count_lock:
            free = [c for c in self._card_pool()
                    if c not in self._holders
                    or self._holders[c].poll() is not None][:n]
            for c in free:
                self._holders[c] = _RESERVED
            return free

    def _hold(self, cards: List[str], proc) -> None:
        with self._count_lock:
            for c in cards:
                if proc is None:
                    del self._holders[c]
                else:
                    self._holders[c] = proc

    def _spawn(self, node_type: "NodeTypeConfig"):
        """The node's daemon, seeing cards of its own (``_CardsShort``
        before anything is spawned when too few are free)."""
        import json
        import os
        import subprocess
        import sys

        res = dict(node_type.resources)
        cpus = int(res.pop("CPU", 1))
        need = int(res.pop("GPU", 0))
        cards = self._take_cards(need) if need else []
        if len(cards) < need:
            self._hold(cards, None)
            raise _CardsShort(f"a node launched on the {len(cards)} free "
                              f"card(s) advertises GPU {len(cards)} where "
                              f"its type declares {need}")
        cmd = [sys.executable, "-m", "ray_tpu_torch._private.node_daemon",
               "--address", self.address, "--num-cpus", str(cpus),
               "--resources", json.dumps(res)]
        if self.worker_mode:
            cmd += ["--worker-mode", self.worker_mode]
        env = dict(self.env if self.env is not None else os.environ)
        env["CUDA_VISIBLE_DEVICES"] = ",".join(cards)
        # Standby list inheritance: a daemon launched mid-failover (or
        # alive across one) must know every head it may need to dial —
        # the provider's own address list (which may already be
        # "primary,standby") plus any configured RAY_TPU_HEAD_ADDRESSES
        # ride into the spawned process's environment.
        from ray_tpu_torch._private.config import GlobalConfig

        standby_list = GlobalConfig.head_addresses or (
            self.address if "," in self.address else "")
        if standby_list:
            env["RAY_TPU_HEAD_ADDRESSES"] = standby_list
        from ray_tpu_torch._private import tracing

        ctx = tracing.current_context()
        if ctx is not None:
            # Traced cold start (the launch span is ambient on this
            # thread): the daemon parents its node.init span — and the
            # head its node.join record — to this context.
            env[tracing.ENV_PARENT] = tracing.encode_cold_start_parent(ctx)
        else:
            env.pop(tracing.ENV_PARENT, None)
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                                    env=env)
        except BaseException:
            self._hold(cards, None)
            raise
        self._hold(cards, proc)
        return proc

    @staticmethod
    def _read_join_line(proc, grace_s: float) -> Optional[str]:
        """The daemon prints "... joined <addr> as <client_id>" once
        registered. Bounded read: a cold start slower than the grace
        window (or a daemon killed mid-boot — EOF) returns None instead
        of pinning the autoscaler's monitor thread forever."""
        out: list = []
        done = threading.Event()

        def _read():
            try:
                out.append(proc.stdout.readline())
            except Exception:  # noqa: BLE001 — pipe torn by a kill
                out.append("")
            done.set()

        t = threading.Thread(target=_read, daemon=True,
                             name="ray_tpu_torch_launch_read")
        t.start()
        if not done.wait(max(grace_s, 0.1)):
            return None
        line = out[0] if out else ""
        return line if "joined" in line else None

    def _gpu_mismatch(self, client_id: str,
                      declared: float) -> Optional[str]:
        """Why the joined node ``client_id`` does not advertise the
        ``GPU`` count its type declares (read from the head, through a
        head client of its own), or None when it does."""
        if not declared:
            return None  # launched with the card hidden
        from ray_tpu_torch._private.head_client import HeadClient

        try:
            head = HeadClient(self.address,
                              client_id=f"provider-{uuid.uuid4().hex[:8]}")
            try:
                nodes = head.node_list()
            finally:
                head.close()
        except Exception as exc:  # noqa: BLE001 — a failed attempt
            return f"GPU count unreadable: {exc!r}"
        seen = [float((n.get("resources") or {}).get("GPU", 0))
                for n in nodes if n["client_id"] == client_id]
        if not seen:
            return f"joined node {client_id} is not in the membership"
        if seen[0] != declared:
            return (f"node advertises GPU {seen[0]:g} where its type "
                    f"declares {declared:g}")
        return None

    def launch(self, node_type: "NodeTypeConfig"):
        import random

        from ray_tpu_torch._private.config import GlobalConfig
        from ray_tpu_torch.exceptions import NodeLaunchFailedError

        attempts = max(1, int(GlobalConfig.autoscaler_launch_retries))
        backoff = float(GlobalConfig.autoscaler_launch_backoff_s)
        grace = float(GlobalConfig.autoscaler_launch_grace_s)
        declared = float(node_type.resources.get("GPU", 0))
        last = "no attempt ran"
        for attempt in range(attempts):
            with self._count_lock:
                self.launch_attempts += 1
            try:
                proc = self._spawn(node_type)
            except _CardsShort as short:
                proc, last = None, str(short)
            else:
                line = self._read_join_line(proc, grace)
                if line is not None:
                    client_id = line.strip().rsplit(" ", 1)[-1]
                    mismatch = self._gpu_mismatch(client_id, declared)
                    if mismatch is None:
                        return {"proc": proc, "client_id": client_id}
                    last = mismatch
                else:
                    rc = proc.poll()
                    last = (f"daemon exited rc={rc} before joining" if rc
                            is not None else
                            f"no join within the {grace:.0f}s launch "
                            f"grace")
            with self._count_lock:
                self.launch_failures += 1
            if proc is not None:
                proc.kill()
                try:
                    proc.wait(timeout=5)
                except Exception:  # noqa: BLE001 — unreaped zombie at worst
                    pass
            log.warning("node launch attempt %d/%d for type %r failed "
                        "(%s); %s", attempt + 1, attempts,
                        node_type.name, last,
                        "retrying with backoff"
                        if attempt + 1 < attempts else "giving up")
            if attempt + 1 < attempts:
                time.sleep(backoff * (2 ** attempt)
                           * (0.5 + random.random()))
        raise NodeLaunchFailedError(
            node_type.name, attempts,
            f"node type {node_type.name!r} failed to launch after "
            f"{attempts} attempt(s); last error: {last}")

    def terminate(self, handle) -> None:
        proc = handle["proc"]
        proc.terminate()
        try:
            proc.wait(timeout=5)
        except Exception:  # noqa: BLE001 — stubborn daemon
            proc.kill()
            proc.wait(timeout=5)

    def poll_alive(self, handle) -> bool:
        return handle["proc"].poll() is None


@dataclass
class _Managed:
    type_name: str
    handle: Any
    client_id: str
    idle_since: Optional[float] = None
    launched_at: float = 0.0  # join time (monotonic): reap-grace anchor
    was_busy: bool = False    # observed doing work at least once


# Live ClusterAutoscaler registry (weak): util.state.autoscaler_summary
# reads launch/drain counters and cold-start events off it.
_AUTOSCALERS: "weakref.WeakSet" = weakref.WeakSet()


class ClusterAutoscaler:
    """Demand-driven autoscaling of REAL nodes against a head service.

    Watches head-observed demand — unmet resource shapes advertised in
    client heartbeats (parked infeasible tasks, failed actor placements)
    plus scheduler backlog beyond capacity — bin-packs the unmet shapes
    onto configured node types, launches nodes through the provider,
    and terminates nodes idle past the timeout (never below
    ``min_workers``). Only nodes THIS autoscaler launched are ever
    terminated. (Reference roles: StandardAutoscaler + monitor.py over
    the GCS resource load.)
    """

    def __init__(self, address: str, node_types: List[NodeTypeConfig],
                 provider: Optional[NodeProvider] = None,
                 idle_timeout_s: float = 5.0,
                 update_interval_s: float = 1.0):
        from ray_tpu_torch._private.head_client import HeadClient

        self.node_types = {t.name: t for t in node_types}
        self.provider = provider or LocalSubprocessProvider(address)
        self.idle_timeout_s = idle_timeout_s
        self._interval = update_interval_s
        self._managed: List[_Managed] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.launched: List[str] = []
        self.terminated: List[str] = []
        # Cold-start SLO surface: one record per scale-up event —
        # {type, launch_started, joined, client_id} on the shared
        # CLOCK_MONOTONIC domain, so a replica's first-token timestamp
        # (same machine) subtracts directly.
        self.scale_events: List[Dict[str, Any]] = []
        self.launch_errors = 0     # typed NodeLaunchFailedError count
        self.drained_nodes = 0     # reaps that completed a drain
        self.drain_transferred_objects = 0
        # Node-held results a drain could not hand back (the report's
        # "untransferred"): 0 when no reap stranded a borrowed ref.
        self.drain_untransferred_objects = 0
        self.head = HeadClient(
            address, client_id=f"autoscaler-{uuid.uuid4().hex[:8]}")
        _AUTOSCALERS.add(self)
        for t in node_types:
            for _ in range(t.min_workers):
                self._launch(t)
        self._monitor = threading.Thread(
            target=self._monitor_loop, daemon=True,
            name="ray_tpu_torch_cluster_autoscaler")
        self._monitor.start()

    # --------------------------------------------------------------- sizing
    def _counts(self) -> Dict[str, int]:
        with self._lock:
            counts: Dict[str, int] = {}
            for m in self._managed:
                counts[m.type_name] = counts.get(m.type_name, 0) + 1
        return counts

    def num_nodes_of_type(self, name: str) -> int:
        return self._counts().get(name, 0)

    def _launch(self, t: NodeTypeConfig) -> bool:
        from ray_tpu_torch._private import tracing
        from ray_tpu_torch.exceptions import NodeLaunchFailedError

        if self._counts().get(t.name, 0) >= t.max_workers:
            return False
        t_start = time.monotonic()
        # Traced cold start: adopt the context parked by the request /
        # reconcile thread that exposed the capacity gap — the launch
        # becomes a span in ITS trace, and the provider forwards the
        # context to the spawned daemon via RAY_TPU_TRACE_PARENT.
        cold = tracing.take_cold_start_timed()
        cold_parent, cold_deadline = cold if cold else (None, 0.0)
        span = tracing.begin("node.launch", parent=cold_parent,
                             node_type=t.name) \
            if tracing.active() else None
        try:
            handle = self.provider.launch(t)
        except NodeLaunchFailedError as exc:
            # Typed exhaustion (the provider already retried with
            # backoff): surfaced loudly, next monitor tick re-decides.
            with self._lock:
                self.launch_errors += 1
                self._record_event({
                    "type": t.name, "launch_started": t_start,
                    "joined": None, "client_id": None,
                    "error": repr(exc)})
            log.warning("node launch for type %r failed typed: %s",
                        t.name, exc)
            tracing.finish(span, status="error")
            # Re-park the requesting context WITH its original deadline:
            # the retried launch on the next tick must land in the SAME
            # trace (or the assembled cold-start chain loses
            # launch/join/init whenever the first attempt fails), but
            # repeated failures must not keep resetting the expiry.
            if cold_parent is not None:
                tracing.stash_cold_start(cold_parent,
                                         deadline=cold_deadline)
            return False
        except Exception:  # noqa: BLE001 — provider failure: retry later
            tracing.finish(span, status="error")
            if cold_parent is not None:
                tracing.stash_cold_start(cold_parent,
                                         deadline=cold_deadline)
            return False
        now = time.monotonic()
        client_id = handle.get("client_id", "") \
            if isinstance(handle, dict) else ""
        tracing.finish(span, client_id=client_id)
        with self._lock:
            self._managed.append(_Managed(t.name, handle, client_id,
                                          launched_at=now))
            self.launched.append(t.name)
            self._record_event({
                "type": t.name, "launch_started": t_start,
                "joined": now, "client_id": client_id})
        return True

    def _launch_all(self, types: List[NodeTypeConfig]) -> None:
        """Launch ``types`` at once, one thread each: each launch waits
        for its daemon's joined line, so in sequence the cold starts of
        one update would add up."""
        threads = [threading.Thread(target=self._launch, args=(t,),
                                    daemon=True,
                                    name="ray_tpu_torch_node_launch")
                   for t in types]
        for th in threads:
            th.start()
        for th in threads:
            th.join()

    def _record_event(self, event: Dict[str, Any]) -> None:
        """Bounded scale-event history (observability, not a ledger) —
        caller holds self._lock."""
        self.scale_events.append(event)
        if len(self.scale_events) > 256:
            del self.scale_events[:len(self.scale_events) - 256]

    def _terminate(self, m: _Managed, drain: bool = False) -> bool:
        """Reap one managed node. With ``drain=True`` (the idle-reap
        path) the node is first asked to DRAIN: it cordons itself
        (refuse-and-reroute for racing pushes), finishes in-flight
        tasks, and lease-transfers node-held result bytes to their
        owners (``object_offload``) + re-points head fallback entries
        (``object_transfer``) — so reaping can never strand a borrowed
        ref. A drain that fails (node wedged/gone) falls through to a
        plain terminate: crash semantics (lineage) still cover it.

        Claim-first: the node leaves ``_managed`` BEFORE any drain
        work, so two racing reap passes over the same node resolve to
        exactly one drain + one terminate — the loser returns False
        and must not double-count (the node side is idempotent too:
        its second drain answers ``already_draining``)."""
        with self._lock:
            if m not in self._managed:
                return False  # a concurrent pass already claimed it
            self._managed.remove(m)
        if drain and m.client_id:
            try:
                report = self.head.node_drain(m.client_id,
                                              timeout=DRAIN_TIMEOUT_S)
                with self._lock:
                    self.drained_nodes += 1
                    self.drain_transferred_objects += int(
                        (report or {}).get("transferred", 0))
                    self.drain_untransferred_objects += int(
                        (report or {}).get("untransferred", 0))
            except Exception as exc:  # noqa: BLE001 — wedged node:
                log.warning("drain of node %s failed (%r); reaping "
                            "undrained — lineage covers its refs",
                            m.client_id, exc)
        try:
            self.provider.terminate(m.handle)
        except Exception:  # noqa: BLE001 — already gone
            pass
        with self._lock:
            self.terminated.append(m.type_name)
        return True

    # --------------------------------------------------------------- demand
    def _observe(self):
        """(unmet shapes, per-node report by client_id) from the head."""
        report = self.head.demand_report()
        shapes: List[Dict[str, float]] = []
        nodes: Dict[str, dict] = {}
        backlog_pressure = 0
        for c in report:
            status = c.get("status") or {}
            for s in status.get("unmet") or ():
                shapes.append({k: float(v) for k, v in dict(s).items()})
            if c.get("is_node"):
                nodes[c["client_id"]] = c
                cpus = max((c.get("resources") or {}).get("CPU", 1.0), 1.0)
                backlog_pressure += max(
                    int(status.get("backlog", 0)) - int(cpus), 0)
        return shapes, nodes, backlog_pressure

    def _bin_pack(self, shapes: List[Dict[str, float]],
                  capacity: List[Dict[str, float]]):
        """First-fit shapes against existing capacity; launch node types
        for the remainder (smallest feasible type first)."""
        to_launch: List[NodeTypeConfig] = []
        headroom = [dict(c) for c in capacity]
        counts = self._counts()
        planned: Dict[str, int] = dict(counts)
        for shape in sorted(shapes, key=lambda s: -sum(s.values())):
            placed = False
            for cap in headroom:
                if all(cap.get(k, 0.0) >= v for k, v in shape.items()):
                    for k, v in shape.items():
                        cap[k] = cap.get(k, 0.0) - v
                    placed = True
                    break
            if placed:
                continue
            for t in sorted(self.node_types.values(),
                            key=lambda t: sum(t.resources.values())):
                if not all(t.resources.get(k, 0.0) >= v
                           for k, v in shape.items()):
                    continue
                if planned.get(t.name, 0) >= t.max_workers:
                    continue
                to_launch.append(t)
                planned[t.name] = planned.get(t.name, 0) + 1
                cap = dict(t.resources)
                for k, v in shape.items():
                    cap[k] = cap.get(k, 0.0) - v
                headroom.append(cap)
                break
        return to_launch

    # -------------------------------------------------------------- monitor
    def _monitor_loop(self):
        while not self._stop.wait(self._interval):
            try:
                self._update()
            except Exception as exc:  # monitor must not die
                log.warning("autoscaler update failed; retrying next "
                            "period: %r", exc)

    def _update(self):
        shapes, nodes, backlog_pressure = self._observe()
        # 1. Reap handles whose process died underneath us, then top the
        # pool back up to min_workers (a crashed node must be replaced,
        # not just forgotten).
        with self._lock:
            managed = list(self._managed)
        for m in managed:
            if not self.provider.poll_alive(m.handle):
                with self._lock:
                    if m in self._managed:
                        self._managed.remove(m)
        counts = self._counts()
        for t in self.node_types.values():
            for _ in range(t.min_workers - counts.get(t.name, 0)):
                self._launch(t)
        # 2. Scale up: unmet shapes first-fit against ALIVE capacity.
        # Parked shapes that now fit an existing node are dropped — the
        # routers' retry loops will place them without new hardware.
        capacity = [dict(n.get("resources") or {})
                    for n in nodes.values() if n.get("alive")]
        self._launch_all(self._bin_pack(shapes, capacity))
        # 3. Generic backlog pressure: tasks queued beyond capacity fit
        # existing node TOTALS by definition, so they must not be
        # first-fit against capacity — launch one CPU node per tick
        # while no alive node reports a free CPU (the idle reaper trims
        # any overshoot).
        if backlog_pressure > 0:
            free_cpu = any(
                float(((n.get("status") or {}).get("available")
                       or {}).get("CPU", 0.0)) >= 1.0
                for n in nodes.values() if n.get("alive"))
            if not free_cpu:
                for t in sorted(self.node_types.values(),
                                key=lambda t: sum(t.resources.values())):
                    if t.resources.get("CPU", 0.0) >= 1.0 \
                            and self._launch(t):
                        break
        # 4. Scale down idle managed nodes past the timeout —
        # drain-before-reap (cordon, finish in-flight, lease-transfer
        # held bytes) so no borrowed ref strands. Launching-node grace:
        # a node inside its launch grace window is never idle-reaped —
        # a slow cold start (engine init, jit warmup) looks exactly
        # like idleness to the load signals.
        from ray_tpu_torch._private.config import GlobalConfig

        grace = float(GlobalConfig.autoscaler_launch_grace_s)
        now = time.monotonic()
        counts = self._counts()
        with self._lock:
            managed = list(self._managed)
        for m in managed:
            entry = nodes.get(m.client_id)
            if entry is None:
                continue  # not registered yet — grace
            status = entry.get("status") or {}
            total = entry.get("resources") or {}
            avail = status.get("available")
            busy = (int(status.get("backlog", 0)) > 0
                    or int(status.get("actors", 0)) > 0
                    or (avail is not None and dict(avail) != dict(total)))
            if busy:
                m.idle_since = None
                m.was_busy = True
                continue
            if not m.was_busy and now - m.launched_at < grace \
                    and shapes:
                # Launching-node grace: while unmet demand still exists,
                # a node never yet seen doing work looks exactly like an
                # idle node although its payload (replica placement,
                # engine init) is still in flight — reaping it would
                # thrash launch/reap cycles against the very demand it
                # was launched for. Once it has been busy — or demand
                # drained — idleness is idleness.
                continue
            if m.idle_since is None:
                m.idle_since = now
                continue
            if now - m.idle_since < self.idle_timeout_s:
                continue
            t = self.node_types[m.type_name]
            if counts.get(m.type_name, 0) > t.min_workers:
                if self._terminate(m, drain=True):
                    counts[m.type_name] = counts.get(m.type_name, 0) - 1

    def summary(self) -> Dict[str, Any]:
        """Operational counters for ``util.state.autoscaler_summary``:
        launch tries/failures (provider-level), typed launch errors,
        drain outcomes, and every scale-up event with its join latency
        (the cold-start SLO's node-plane half)."""
        with self._lock:
            events = [dict(e) for e in self.scale_events]
            out = {
                "managed_nodes": len(self._managed),
                "launched": list(self.launched),
                "terminated": list(self.terminated),
                "launch_errors": self.launch_errors,
                "drained_nodes": self.drained_nodes,
                "drain_transferred_objects":
                    self.drain_transferred_objects,
                "drain_untransferred_objects":
                    self.drain_untransferred_objects,
            }
        out["launch_attempts"] = getattr(
            self.provider, "launch_attempts", 0)
        out["launch_failures"] = getattr(
            self.provider, "launch_failures", 0)
        for e in events:
            if e.get("joined") is not None:
                e["join_latency_s"] = e["joined"] - e["launch_started"]
        out["scale_events"] = events
        return out

    def shutdown(self, terminate_nodes: bool = True):
        self._stop.set()
        self._monitor.join(timeout=5)
        if terminate_nodes:
            with self._lock:
                managed = list(self._managed)
            for m in managed:
                self._terminate(m)
        self.head.close()


def live_autoscalers() -> List["ClusterAutoscaler"]:
    """ClusterAutoscalers alive in this process (state-API feed)."""
    return list(_AUTOSCALERS)
