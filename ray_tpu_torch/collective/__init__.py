"""Collectives of the PyTorch/CUDA port (counterpart of
``ray_tpu/collective``), on two planes:

- **In-program** (ops.py, the fast path): operations over the per-shard
  tensors of a mesh axis, or of every group of a mesh along an axis,
  driven by one process. ``allreduce``, ``allgather``, ``reducescatter``,
  ``broadcast`` and the rest of this package's top level are these;
  ``backward_order`` (order.py) gives the exchanges across processes of
  a graph one backward order.
- **Actor plane** (collective.py): named groups of the runtime's actors
  exchanging tensors through a store rendezvous, with the reference's
  group management. Its group verbs (``init_collective_group``,
  ``create_collective_group``, ``get_rank``, ``get_collective_group_size``,
  ``barrier``, ``send``, ``recv``, ``destroy_collective_group``) are
  exported here too; its ``allreduce``, ``allgather``, ``reducescatter``
  and ``broadcast`` share their names with the in-program ops and are
  reached as ``ray_tpu_torch.collective.collective.allreduce`` and so on.
"""

from ray_tpu_torch.collective import collective
from ray_tpu_torch.collective.collective import (
    barrier,
    create_collective_group,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    recv,
    send,
)
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
from ray_tpu_torch.collective.order import backward_order

__all__ = [
    "all_to_all",
    "allgather",
    "allreduce",
    "axis_index",
    "axis_indices",
    "axis_size",
    "backward_order",
    "barrier",
    "broadcast",
    "collective",
    "create_collective_group",
    "destroy_collective_group",
    "get_collective_group_size",
    "get_rank",
    "groups",
    "init_collective_group",
    "permute",
    "recv",
    "reducescatter",
    "send",
    "send_recv",
]
