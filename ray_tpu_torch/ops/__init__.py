"""Hot ops of the PyTorch/CUDA port (counterpart of ``ray_tpu/ops``).

``flash_attention``/``flash_attention_grouped`` run hand-written Hopper
kernels (forward, and for ``flash_attention`` the dQ and dK/dV backward)
on CUDA tensors and their plain PyTorch versions on CPU tensors;
``rms_norm_fused`` runs a Triton kernel the same way. Paged attention and
``softmax_cross_entropy`` are plain PyTorch, as their references are
plain JAX.
"""

from ray_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_grouped,
)
from ray_tpu_torch.ops.fused import rms_norm_fused, softmax_cross_entropy
from ray_tpu_torch.ops.paged_attention import (
    paged_attention_decode,
    paged_attention_prefill,
)

__all__ = [
    "flash_attention",
    "flash_attention_grouped",
    "paged_attention_decode",
    "paged_attention_prefill",
    "rms_norm_fused",
    "softmax_cross_entropy",
]
