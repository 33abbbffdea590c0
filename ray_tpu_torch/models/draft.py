"""Draft-model helpers for speculative decoding (counterpart of
``ray_tpu/models/draft.py``).

- ``draft_config``: a shrunk ``TransformerConfig`` derived from the
  flagship's (same vocab, so proposals are scoreable by the flagship;
  half the depth and width by default). Overrides win field by field.
- ``shift_params``: a synthetic parameterization whose greedy next token
  is exactly ``(t + shift) % vocab_size`` for last token ``t``, on any
  config with ``d_model >= vocab_size``: zero attention and MLP weights
  make every layer an identity residual update, a one-hot embedding
  carries the token through the residual stream and a shift-permutation
  ``lm_head`` reads it back out. A shift draft and a shift flagship agree
  token for token by construction (acceptance 1.0).

``shift_params`` sets every leaf, so its values equal the reference's
leaf for leaf whatever generator ``init_params`` uses; the dtypes are the
reference's too (f32 layer weights and final norm, ``cfg.dtype`` embed
and ``lm_head``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.convert import _expected_shapes, _layer_keys
from ray_tpu_torch.models.transformer import TransformerConfig

__all__ = ["draft_config", "shift_params"]

def draft_config(base: TransformerConfig, **overrides
                 ) -> TransformerConfig:
    """A small draft config derived from the flagship's: same vocab and
    context window, half the depth and width by default (floored so tiny
    configs stay valid). Overrides win field by field."""
    small: Dict[str, Any] = dict(
        n_layers=max(1, base.n_layers // 2),
        d_model=max(32, base.d_model // 2),
        n_heads=max(1, base.n_heads // 2),
        n_kv_heads=max(1, base.n_kv_heads // 2),
        d_ff=max(32, base.d_ff // 2),
    )
    small.update(overrides)
    return dataclasses.replace(base, **small)


def shift_params(cfg: TransformerConfig, shift: int = 1,
                 device="cuda") -> Dict[str, Any]:
    """Parameters realizing greedy next == ``(last_token + shift) %
    vocab`` exactly (see module docstring), on ``device``. Requires
    ``d_model >= vocab_size`` so the one-hot embedding fits the residual
    stream. An MoE config's router and expert leaves are zeroed too (a
    zero router routes every token to expert 0, whose output is zero)."""
    if cfg.d_model < cfg.vocab_size:
        raise ValueError(
            f"shift_params needs d_model ({cfg.d_model}) >= vocab_size "
            f"({cfg.vocab_size}) for the one-hot embedding")
    dev = resolve_device(device)
    shapes = _expected_shapes(cfg)
    # Zero every layer weight, keep every norm gain at one: each layer is
    # x -> x (attention output and MLP both exactly zero).
    layers = {name: (torch.ones if name.endswith("norm") else torch.zeros)(
        shapes[name], device=dev) for name in _layer_keys(cfg)}
    D, V = cfg.d_model, cfg.vocab_size
    # One-hot embed: token t -> e_t in the first vocab dims; final_norm of
    # ones rescales each row positively, which keeps the argmax.
    tok = torch.arange(V, device=dev)
    embed = torch.zeros((V, D), dtype=cfg.dtype, device=dev)
    embed[tok, tok] = 1.0
    # Shift-permutation readout: logits[v] = x[(v - shift) % vocab], so
    # the one positive residual dim t votes for (t + shift) % vocab.
    head = torch.zeros((D, V), dtype=cfg.dtype, device=dev)
    head[tok, (tok + shift) % V] = 1.0
    return {"embed": embed, "layers": layers,
            "final_norm": torch.ones((D,), device=dev), "lm_head": head}
