"""Simulated multi-node cluster (counterpart of ``ray_tpu/cluster_utils.py``,
the role of Ray's ``python/ray/cluster_utils.py``: several node stacks in
one process, nodes killable mid-test).

Each SimNode owns a ResourcePool + LocalScheduler (sharing the process
object store — object *placement* is tracked logically per node so node
loss can invalidate objects). The ClusterScheduler implements the
reference's node-selection policies: hybrid (pack until a utilization
threshold, then least-utilized), SPREAD, node affinity, and placement-group
bundle routing — and lineage-based object reconstruction when a node's
objects are lost (ObjectRecoveryManager parity). It runs on either
execution plane: on ``worker_mode="process"`` every node's scheduler
shares the runtime's worker pool and shm store. It needs no head.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.ids import NodeID
from ray_tpu_torch._private.scheduler import (
    LocalScheduler,
    ResourcePool,
    TaskSpec,
)
from ray_tpu_torch._private.worker import auto_init
from ray_tpu_torch.exceptions import WorkerCrashedError
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

# The hybrid policy packs tasks onto the first node below this load,
# then spreads to the least loaded.
SPREAD_THRESHOLD = 0.5


class SimNode:
    def __init__(self, cluster: "Cluster", resources: Dict[str, float],
                 worker):
        self.node_id = NodeID.from_random()
        self.alive = True
        self.resource_pool = ResourcePool(resources)
        self.scheduler = LocalScheduler(
            worker.store, self.resource_pool,
            max(int(resources.get("CPU", 1)), 1),
            task_events=worker.task_events,
            worker_pool=worker.worker_pool, shm_store=worker.shm_store,
            lineage=cluster.lineage)
        self.cluster = cluster

    def hex(self) -> str:
        return self.node_id.hex()

    def __repr__(self):
        state = "ALIVE" if self.alive else "DEAD"
        return f"SimNode({self.hex()[:8]}…, {state})"


class Cluster:
    """Multi-node simulation; becomes the worker's task router on connect."""

    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[dict] = None):
        self.lineage: Dict[Any, TaskSpec] = {}
        self._lock = threading.Lock()
        self.nodes: List[SimNode] = []
        self._task_node: Dict[Any, SimNode] = {}   # task_id -> node
        self._object_node: Dict[Any, SimNode] = {}  # object_id -> node
        self._recovering: set = set()
        self.worker = auto_init()
        self.worker.cluster = self
        if initialize_head:
            self.add_node(**(head_node_args or {"num_cpus": 2}))

    # --------------------------------------------------------------- nodes
    def add_node(self, num_cpus: int = 2,
                 resources: Optional[Dict[str, float]] = None,
                 **_kw) -> SimNode:
        total = {"CPU": float(num_cpus)}
        total.update(resources or {})
        node = SimNode(self, total, self.worker)
        with self._lock:
            self.nodes.append(node)
        return node

    @property
    def head_node(self) -> SimNode:
        return self.nodes[0]

    def remove_node(self, node: SimNode, lose_objects: bool = True):
        """Kill a node: running tasks fail (retriable ones resubmit
        elsewhere); optionally its objects become lost, to be reconstructed
        from lineage on next access."""
        node.alive = False
        with self._lock:
            if node in self.nodes:
                self.nodes.remove(node)
        # Fail/retry tasks currently on that node.
        running = node.scheduler.running_task_ids()
        queued = node.scheduler.queued_specs()
        node.scheduler.stop()
        for spec in queued:
            self._resubmit_or_fail(spec)
        for task_id in running:
            spec = self.lineage.get(task_id)
            if spec is not None:
                self._resubmit_or_fail(spec)
        # The dead node's running attempts end on their own threads.
        node.scheduler.join()
        if lose_objects:
            with self._lock:
                lost = [oid for oid, n in self._object_node.items()
                        if n is node]
                for oid in lost:
                    del self._object_node[oid]
            for oid in lost:
                self.worker.store.mark_lost(oid)

    def _resubmit_or_fail(self, spec: TaskSpec):
        if spec.attempt < spec.max_retries:
            self.submit(dataclasses.replace(spec, attempt=spec.attempt + 1))
        else:
            err = WorkerCrashedError(
                f"node died while running task {spec.name!r}")
            for oid in spec.return_ids:
                self.worker.store.put_error(oid, err)

    # ---------------------------------------------------------- scheduling
    def submit(self, spec: TaskSpec):
        # Reconstruct lost dependencies first — the dep-wait machinery only
        # fires on put(), which for a lost object requires re-execution.
        from ray_tpu_torch._private.scheduler import _collect_refs

        for dep in _collect_refs(spec.args, spec.kwargs):
            if self.worker.store.is_lost(dep.object_id):
                if self.recover_object(dep.object_id):
                    self.worker.store.clear_lost(dep.object_id)
        node = self._choose_node(spec)
        with self._lock:
            self._task_node[spec.task_id] = node
            for oid in spec.return_ids:
                self._object_node[oid] = node
        node.scheduler.submit(spec)

    def _choose_node(self, spec: TaskSpec) -> SimNode:
        with self._lock:
            alive = [n for n in self.nodes if n.alive]
        if not alive:
            raise RuntimeError("no alive nodes in cluster")
        strat = spec.scheduling_strategy
        if isinstance(strat, NodeAffinitySchedulingStrategy):
            for n in alive:
                if n.hex() == strat.node_id:
                    return n
            if not strat.soft:
                raise RuntimeError(
                    f"node {strat.node_id[:8]}… not alive (hard affinity)")
        if isinstance(strat, PlacementGroupSchedulingStrategy):
            pg = strat.placement_group
            idx = strat.placement_group_bundle_index
            idx = 0 if idx is None or idx < 0 else idx
            target_hex = pg.bundle_nodes[idx]
            for n in alive:
                if n.hex() == target_hex:
                    return n
            raise RuntimeError("placement group bundle node is gone")
        feasible = [n for n in alive if n.resource_pool.fits(spec.resources)]
        if not feasible:
            raise RuntimeError(
                f"no node can ever satisfy {spec.resources} "
                f"(infeasible demand)")
        def load(n: SimNode) -> float:
            # Acquired resources + queued demand: choose-time decisions must
            # see tasks that are queued but not yet dispatched, or a burst
            # of submissions all packs onto one node.
            cpus = max(n.resource_pool.total.get("CPU", 1.0), 1.0)
            return (n.resource_pool.utilization()
                    + n.scheduler.backlog_size() / cpus)

        if strat == "SPREAD":
            return min(feasible, key=load)
        # Hybrid default: pack onto the first node below the spread
        # threshold, else spread by least load.
        for n in feasible:
            if load(n) < SPREAD_THRESHOLD:
                return n
        return min(feasible, key=load)

    # ------------------------------------------------------- object recovery
    def recover_object(self, object_id) -> bool:
        """Lineage reconstruction: re-execute the producing task (and,
        transitively, producers of its lost args)."""
        spec = self.lineage.get(object_id.task_id())
        if spec is None:
            return False
        with self._lock:
            if object_id in self._recovering:
                return True
            self._recovering.add(object_id)
        try:
            from ray_tpu_torch._private.scheduler import _collect_refs

            for dep in _collect_refs(spec.args, spec.kwargs):
                if not self.worker.store.is_ready(dep.object_id):
                    self.recover_object(dep.object_id)
            self.submit(dataclasses.replace(spec))
            return True
        finally:
            with self._lock:
                self._recovering.discard(object_id)

    # ------------------------------------------------------ placement groups
    def reserve_placement_group(self, pg):
        """Map bundles to nodes per strategy and reserve resources."""
        with self._lock:
            alive = [n for n in self.nodes if n.alive]
        strategy = pg.strategy
        placed: List[SimNode] = []
        acquired: List[Dict[str, float]] = []

        def rollback():
            for n, res in zip(placed, acquired):
                n.resource_pool.release(res)

        for i, bundle in enumerate(pg.bundles):
            candidates = list(alive)
            if strategy in ("PACK", "STRICT_PACK") and placed:
                candidates = [placed[0]] + [
                    n for n in candidates if n is not placed[0]]
                if strategy == "STRICT_PACK":
                    candidates = [placed[0]]
            if strategy == "STRICT_SPREAD":
                candidates = [n for n in candidates if n not in placed]
            chosen = None
            for n in candidates:
                if n.resource_pool.try_acquire(bundle):
                    chosen = n
                    break
            if chosen is None:
                rollback()
                raise ValueError(
                    f"cannot place bundle {i} {bundle} with strategy "
                    f"{strategy}")
            placed.append(chosen)
            acquired.append(bundle)
            pg.bundle_nodes[i] = chosen.hex()
        pg._cluster_reserved = list(zip(placed, acquired))
        pg._ready.set()

    def release_placement_group(self, pg):
        for node, res in getattr(pg, "_cluster_reserved", []):
            node.resource_pool.release(res)

    # -------------------------------------------------------------- teardown
    def shutdown(self):
        for node in list(self.nodes):
            node.scheduler.shutdown()
        self.nodes.clear()
        if getattr(self.worker, "cluster", None) is self:
            self.worker.cluster = None
