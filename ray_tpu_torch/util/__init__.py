"""ray_tpu_torch.util (counterpart of ``ray_tpu.util``): placement
groups and scheduling strategies, topic pub/sub, and device profiling.
``tracing``, ``metrics`` and ``state`` (the observability plane),
``sanitizer`` (the host-plane invariant checks), ``loadgen`` (seeded
traffic shapes) and ``chaos`` (seeded fault injection) are its
submodules."""

from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    get_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util.profiling import annotate, profile_trace, trace_files
from ray_tpu_torch.util.scheduling_strategies import (
    DEFAULT,
    SPREAD,
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

from ray_tpu_torch.util import pubsub  # noqa: F401 — general topic pub/sub

__all__ = [
    "pubsub",
    "DEFAULT",
    "NodeAffinitySchedulingStrategy",
    "PlacementGroup",
    "PlacementGroupSchedulingStrategy",
    "SPREAD",
    "annotate",
    "get_placement_group",
    "placement_group",
    "placement_group_table",
    "profile_trace",
    "remove_placement_group",
    "trace_files",
]
