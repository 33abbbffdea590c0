"""ray_tpu_torch.train (counterpart of ``ray_tpu.train``): checkpoints.
The trainers and storage URIs are not ported yet (ROADMAP
A.5, A.6)."""

from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    load_pytree,
    save_pytree,
)

__all__ = ["Checkpoint", "load_pytree", "save_pytree"]
