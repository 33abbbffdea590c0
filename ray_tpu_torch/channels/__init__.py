"""Typed single-writer/multi-reader channels for compiled graphs
(counterpart of ``ray_tpu/channels``): fixed-buffer, versioned pipes
between the stages of an actor-backend compiled DAG
(``dag/compiled_dag.py``).

The in-process channels (a mutable slot and a condition variable) pass
values BY REFERENCE: a CUDA tensor written by one stage is the very
tensor the next stage reads, with no copy and no host round trip. The
cross-process channels ride the native shared-memory store of the
process plane: ``ShmBufferedChannel`` (a ring of mutable objects that
peer processes attach to by slot ids) and ``SharedMemoryChannel`` (one
mutable object); their values are host values, pickled.
"""

from ray_tpu_torch.channels.channel import (
    BufferedChannel,
    Channel,
    CompositeChannel,
    IntraProcessChannel,
    ShmBufferedChannel,
)


def SharedMemoryChannel(max_size: int = 1 << 20, num_readers: int = 1,
                        store=None):
    """Cross-process channel over one mutable object of the native shm
    store (the reference's shared_memory_channel over plasma mutable
    objects). Without ``store`` it lives in a segment of the runtime's
    own, created at first use and unlinked at ``shutdown``."""
    from ray_tpu_torch._native.store import (
        NativeMutableChannel,
        NativeObjectStore,
    )

    if store is None:
        from ray_tpu_torch._private.worker import global_worker

        worker = global_worker()
        store = worker._channel_store
        if store is None:
            store = worker._channel_store = NativeObjectStore.create()
    return NativeMutableChannel(store, max_size=max_size,
                                num_readers=num_readers)


__all__ = [
    "BufferedChannel",
    "Channel",
    "CompositeChannel",
    "IntraProcessChannel",
    "SharedMemoryChannel",
    "ShmBufferedChannel",
]
