"""Collectives of the PyTorch/CUDA port (counterpart of
``ray_tpu/collective``, the in-program plane only): operations over the
per-shard tensors of a mesh axis, or of every group of a mesh along an
axis, driven by one process (ops.py). The
reference's out-of-program actor groups need the runtime (ROADMAP A.5).
"""

from ray_tpu_torch.collective.ops import (
    all_to_all,
    allgather,
    allreduce,
    axis_index,
    axis_indices,
    axis_size,
    broadcast,
    groups,
    permute,
    reducescatter,
    send_recv,
)

__all__ = [
    "all_to_all",
    "allgather",
    "allreduce",
    "axis_index",
    "axis_indices",
    "axis_size",
    "broadcast",
    "groups",
    "permute",
    "reducescatter",
    "send_recv",
]
