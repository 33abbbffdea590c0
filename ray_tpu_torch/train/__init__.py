"""ray_tpu_torch.train (counterpart of ``ray_tpu.train``): checkpoints.
The trainers, sessions and storage URIs wait for the runtime (ROADMAP
A.5, A.6)."""

from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    load_pytree,
    save_pytree,
)

__all__ = ["Checkpoint", "load_pytree", "save_pytree"]
