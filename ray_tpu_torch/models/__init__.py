"""Flagship model of the PyTorch/CUDA port (counterpart of
``ray_tpu/models``): the dense decoder's serving path."""

from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    decode_step,
    forward,
    init_kv_cache,
    init_params,
    prefill_chunk,
    prefill_with_cache,
    serving_params,
)

__all__ = [
    "TransformerConfig",
    "decode_step",
    "forward",
    "init_kv_cache",
    "init_params",
    "params_from_jax",
    "prefill_chunk",
    "prefill_with_cache",
    "serving_params",
]
