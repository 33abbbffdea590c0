"""Scheduling strategies (copy of ``ray_tpu/util/scheduling_strategies.py``).

Strategy objects attach to tasks and actors through
``options(scheduling_strategy=...)``. The one-process runtime accepts and
records them, as the reference's single-node runtime does: a task that
carries a ``PlacementGroupSchedulingStrategy`` draws its resources from
the pool, not from its group's reservation.
"""

from __future__ import annotations


class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group,
                 placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: bool = False):
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = (
            placement_group_capture_child_tasks)


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: str, soft: bool = False):
        self.node_id = node_id
        self.soft = soft


# String strategies (the reference accepts these literals).
DEFAULT = "DEFAULT"
SPREAD = "SPREAD"
