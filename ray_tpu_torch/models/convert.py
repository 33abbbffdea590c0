"""Parameter conversion from the JAX reference.

``params_from_jax`` maps the reference's ``init_params`` tree, given as
numpy arrays (the caller runs ``np.asarray`` on the JAX side, so this
module imports no JAX), one to one onto the port's tree: same key names,
same stacked ``[L, ...]`` shapes, same dtypes. An MoE config
(``num_experts > 0``) adds the ``router``, ``e_gate``, ``e_up`` and
``e_down`` leaves.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.transformer import TransformerConfig

_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
               "w_up", "w_down")
_MOE_KEYS = ("router", "e_gate", "e_up", "e_down")


def _layer_keys(cfg: TransformerConfig) -> tuple:
    """The layer leaves of ``cfg``: the MoE leaves exactly when
    ``cfg.num_experts > 0``."""
    return _LAYER_KEYS + (_MOE_KEYS if cfg.num_experts else ())


def _expected_shapes(cfg: TransformerConfig) -> Dict[str, tuple]:
    D, F, Hd, L = cfg.d_model, cfg.d_ff, cfg.head_dim, cfg.n_layers
    nq, nkv, E = cfg.n_heads, cfg.n_kv_heads, cfg.num_experts
    return {
        "embed": (cfg.vocab_size, D),
        "final_norm": (D,),
        "lm_head": (D, cfg.vocab_size),
        "attn_norm": (L, D), "mlp_norm": (L, D),
        "wq": (L, D, nq * Hd), "wk": (L, D, nkv * Hd),
        "wv": (L, D, nkv * Hd), "wo": (L, nq * Hd, D),
        "w_gate": (L, D, F), "w_up": (L, D, F), "w_down": (L, F, D),
        "router": (L, D, E), "e_gate": (L, E, D, F), "e_up": (L, E, D, F),
        "e_down": (L, E, F, D),
    }


def params_from_jax(tree: Dict[str, Any], cfg: TransformerConfig,
                    device="cuda") -> Dict[str, Any]:
    """Convert a reference parameter tree of numpy arrays to the port's
    tree of tensors on ``device``. Raises on a missing or extra key or a
    shape that does not match ``cfg``."""
    dev = resolve_device(device)
    shapes = _expected_shapes(cfg)
    if set(tree) != {"embed", "layers", "final_norm", "lm_head"}:
        raise KeyError(f"unexpected top-level keys {sorted(tree)}")
    keys = _layer_keys(cfg)
    if set(tree["layers"]) != set(keys):
        raise KeyError(f"unexpected layer keys {sorted(tree['layers'])}")

    def conv(name, arr):
        a = np.asarray(arr)
        if a.shape != shapes[name]:
            raise ValueError(f"{name}: shape {a.shape} != {shapes[name]}")
        return torch.from_numpy(np.array(a)).to(dev)  # writable copy

    return {
        "embed": conv("embed", tree["embed"]),
        "layers": {k: conv(k, tree["layers"][k]) for k in keys},
        "final_norm": conv("final_norm", tree["final_norm"]),
        "lm_head": conv("lm_head", tree["lm_head"]),
    }
