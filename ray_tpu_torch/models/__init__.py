"""Flagship model of the PyTorch/CUDA port (counterpart of
``ray_tpu/models``): the decoder's serving and one-card training paths,
dense or MoE (the reference's dense fallback), the manual multi-axis
training step over a one-controller mesh (``make_spmd_train_step``,
with expert-parallel MoE), tensor-parallel serving over such a mesh
(``param_specs``), and the speculative-decoding draft helpers."""

from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.draft import draft_config, shift_params
from ray_tpu_torch.models.transformer import (
    TransformerConfig,
    decode_step,
    forward,
    init_kv_cache,
    init_params,
    loss_fn,
    make_spmd_train_step,
    make_train_step,
    param_specs,
    prefill_chunk,
    prefill_with_cache,
    serving_params,
    shard_params_for_step,
    verify_step,
)

__all__ = [
    "TransformerConfig",
    "decode_step",
    "draft_config",
    "forward",
    "init_kv_cache",
    "init_params",
    "loss_fn",
    "make_spmd_train_step",
    "make_train_step",
    "param_specs",
    "params_from_jax",
    "prefill_chunk",
    "prefill_with_cache",
    "serving_params",
    "shard_params_for_step",
    "shift_params",
    "verify_step",
]
