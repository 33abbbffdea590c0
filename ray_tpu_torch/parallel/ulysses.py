"""Ulysses (all-to-all) sequence parallelism (counterpart of
``ray_tpu/parallel/ulysses.py``).

Inputs arrive sequence-sharded over ``sp``; an ``all_to_all`` re-shards
them to head-sharded with the whole sequence, attention runs on each
shard with every token visible, and a second ``all_to_all`` restores
sequence sharding. q/k/v are per-shard lists over a mesh, as in
``ring_attention``; ``attn_fn`` runs on one shard's tensors.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ray_tpu_torch.collective import ops as cops
from ray_tpu_torch.collective.order import in_order
from ray_tpu_torch.parallel.mesh import Mesh
from ray_tpu_torch.parallel.ring_attention import reference_attention


@in_order
def ulysses_attention(qs: Sequence[torch.Tensor],
                      ks: Sequence[torch.Tensor],
                      vs: Sequence[torch.Tensor], *, mesh: Mesh,
                      axis_name: str = "sp", causal: bool = True,
                      scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None
                      ) -> List[torch.Tensor]:
    """q/k/v per-shard [B, H, S_local, D] (sequence-sharded) -> per-shard
    [B, H, S_local, D]. H must be divisible by the axis size."""
    n = cops.axis_size(mesh, axis_name)
    if attn_fn is None:
        def attn_fn(q, k, v):
            return reference_attention(q, k, v, causal=causal, scale=scale)
    if n == 1:
        return [attn_fn(q, k, v) for q, k, v in zip(qs, ks, vs)]
    H = qs[0].shape[1]
    if H % n:
        raise ValueError(f"heads {H} not divisible by {axis_name} size {n}")

    def seq_to_heads(xs):
        # [B, H, S_local, D] -> [B, H/n, S_global, D]: scatter head groups
        # to their shard, gather the full sequence (shard order = token
        # order, so the concat restores the global sequence).
        return cops.all_to_all(xs, mesh, axis_name, split_axis=1,
                               concat_axis=2, tiled=True)

    def heads_to_seq(xs):
        # inverse: [B, H/n, S_global, D] -> [B, H, S_local, D]
        return cops.all_to_all(xs, mesh, axis_name, split_axis=2,
                               concat_axis=1, tiled=True)

    qh, kh, vh = seq_to_heads(qs), seq_to_heads(ks), seq_to_heads(vs)
    return heads_to_seq([attn_fn(q, k, v) for q, k, v in zip(qh, kh, vh)])
