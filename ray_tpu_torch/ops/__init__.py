"""Hot ops of the PyTorch/CUDA port (counterpart of ``ray_tpu/ops``).

``flash_attention``/``flash_attention_grouped`` run a hand-written Hopper
kernel on CUDA tensors and their plain PyTorch version on CPU tensors.
Paged attention is plain PyTorch, as its reference is plain JAX.
"""

from ray_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_grouped,
)
from ray_tpu_torch.ops.paged_attention import (
    paged_attention_decode,
    paged_attention_prefill,
)

__all__ = [
    "flash_attention",
    "flash_attention_grouped",
    "paged_attention_decode",
    "paged_attention_prefill",
]
