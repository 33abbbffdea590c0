"""Typed single-writer/multi-reader channels for compiled graphs
(counterpart of ``ray_tpu/channels``): fixed-buffer, versioned pipes
between the stages of an actor-backend compiled DAG
(``dag/compiled_dag.py``).

Every channel here lives in the calling process (a mutable slot and a
condition variable) and passes values BY REFERENCE: a CUDA tensor written
by one stage is the very tensor the next stage reads, with no copy and no
host round trip. The reference's cross-process channels over its native
shared-memory store (``ShmBufferedChannel``, ``SharedMemoryChannel``)
serve process-backed actors, which the port does not have.
"""

from ray_tpu_torch.channels.channel import (
    BufferedChannel,
    Channel,
    CompositeChannel,
    IntraProcessChannel,
)

__all__ = [
    "BufferedChannel",
    "Channel",
    "CompositeChannel",
    "IntraProcessChannel",
]
