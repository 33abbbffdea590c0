"""ray_tpu_torch.util (counterpart of ``ray_tpu.util``): placement
groups and scheduling strategies, topic pub/sub, and device profiling.
``tracing``, ``metrics`` and ``state`` (the observability plane),
``sanitizer`` (the host-plane invariant checks), ``loadgen`` (seeded
traffic shapes) and ``chaos`` (seeded fault injection) are its
submodules. ``profiling``'s names (``annotate``, ``profile_trace``,
``trace_files``) load at first use: they need torch, and a process that
imports ``util`` for its host-plane pieces (the head service, a worker
process) boots without it."""

from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    get_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import (
    DEFAULT,
    SPREAD,
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)

from ray_tpu_torch.util import pubsub  # noqa: F401 — general topic pub/sub

_PROFILING_NAMES = ("annotate", "profile_trace", "trace_files")


def __getattr__(name):
    if name in _PROFILING_NAMES:
        from ray_tpu_torch.util import profiling

        return getattr(profiling, name)
    raise AttributeError(
        f"module 'ray_tpu_torch.util' has no attribute {name!r}")

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
