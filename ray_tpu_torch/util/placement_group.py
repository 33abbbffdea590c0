"""Placement groups (counterpart of ``ray_tpu/util/placement_group.py``).

A placement group atomically reserves resource bundles. On the simulated
cluster (``cluster_utils.Cluster``) each bundle maps to a node by the
group's strategy and reserves there (``bundle_nodes``), and a task with
``PlacementGroupSchedulingStrategy`` runs on its bundle's node. As in
the reference, groups reserve nothing on node daemons: there a bundle's
shape only steers the router's placement of an actor that carries the
strategy (``RemoteRouter.actor_demand``). On one node
every bundle reserves against the runtime's ``ResourcePool``: there ``STRICT_SPREAD`` over more than
one bundle cannot be honoured and raises ``ValueError``, as does a demand
that exceeds the pool's total. A group that fits the total but not what
is free now stays ``PENDING``; nothing reserves it later, and its
``ready()`` task resolves ``True`` after 30 s all the same, as the
reference's does (ROADMAP C.11). A task or actor that carries a
``PlacementGroupSchedulingStrategy`` draws its resources from the pool,
not from its group's reservation (the reference's scheduler only records
the strategy).
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, List, Optional

from ray_tpu_torch._private.worker import auto_init

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")

# How long a ready() task waits for a pending group before it resolves
# anyway (the reference's bound).
_READY_WAIT_S = 30


class PlacementGroup:
    def __init__(self, pg_id: str, bundles: List[Dict[str, float]],
                 strategy: str, name: str = ""):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        self._ready = threading.Event()
        self._removed = False
        self._reserved: Optional[Dict[str, float]] = None
        # The node (hex id) of each bundle on the simulated cluster.
        self.bundle_nodes: List[Optional[str]] = [None] * len(bundles)

    def ready(self):
        """An ObjectRef that resolves ``True``: ``get(pg.ready())``."""
        import ray_tpu_torch

        @ray_tpu_torch.remote
        def _pg_ready(pg_id):
            pg = auto_init().placement_groups.get(pg_id)
            if pg is None:
                raise ValueError(f"placement group {pg_id} removed")
            pg._ready.wait(timeout=_READY_WAIT_S)
            return True

        return _pg_ready.remote(self.id)

    def wait(self, timeout_seconds: float = 30) -> bool:
        return self._ready.wait(timeout=timeout_seconds)

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self.bundles)

    def __repr__(self):
        return (f"PlacementGroup(id={self.id[:8]}…, "
                f"strategy={self.strategy}, bundles={self.bundles})")


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "",
                    lifetime: Optional[str] = None) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"strategy must be one of {VALID_STRATEGIES}, got {strategy!r}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be non-empty resource dicts")
    worker = auto_init()
    pg = PlacementGroup(uuid.uuid4().hex, [dict(b) for b in bundles],
                        strategy, name)
    if worker.cluster is not None:
        worker.cluster.reserve_placement_group(pg)
        worker.placement_groups[pg.id] = pg
        return pg
    if strategy == "STRICT_SPREAD" and len(bundles) > 1:
        raise ValueError(
            "STRICT_SPREAD needs one node per bundle; single-node "
            "runtime has 1 (start a cluster fixture for multi-node)")
    total: Dict[str, float] = {}
    for b in bundles:
        for k, v in b.items():
            total[k] = total.get(k, 0.0) + v
    if not worker.resource_pool.fits(total):
        raise ValueError(
            f"placement group demand {total} exceeds cluster total "
            f"{worker.resource_pool.total}")
    # Feasible but not free now: the group stays pending.
    if worker.resource_pool.try_acquire(total):
        pg._reserved = total
        pg._ready.set()
    worker.placement_groups[pg.id] = pg
    return pg


def remove_placement_group(pg: PlacementGroup) -> None:
    worker = auto_init()
    stored = worker.placement_groups.pop(pg.id, None)
    if stored is None:
        return
    stored._removed = True
    if stored._reserved:
        worker.resource_pool.release(stored._reserved)
    if worker.cluster is not None:
        worker.cluster.release_placement_group(stored)


def get_placement_group(name: str) -> PlacementGroup:
    for pg in auto_init().placement_groups.values():
        if pg.name == name:
            return pg
    raise ValueError(f"no placement group named {name!r}")


def placement_group_table() -> Dict[str, dict]:
    return {
        pg.id: {
            "name": pg.name,
            "strategy": pg.strategy,
            "bundles": pg.bundles,
            "state": ("REMOVED" if pg._removed else
                      "CREATED" if pg._ready.is_set() else "PENDING"),
        }
        for pg in auto_init().placement_groups.values()
    }
