"""Attention over a paged KV cache (counterpart of
``ray_tpu/ops/paged_attention.py``).

The cache is a pool of fixed-size blocks ``[num_blocks, block_size,
n_kv_heads, head_dim]``; each sequence's block table maps logical
positions to physical slots. GQA stays grouped: queries fold to
``[.., n_kv_heads, group, head_dim]`` and contract against the cache at
``n_kv_heads`` width.

The reference is plain JAX (a gather plus a masked grouped einsum, no
Pallas kernel), so this is plain PyTorch: the same gather, masks and
softmax precision. A kernel that walks the block table without
materializing the gathered context is later performance work.

Under tensor parallelism pass ``mesh``/``rules``: q and the two caches
are then lists of per-shard tensors along the ``kv_heads`` mesh axis,
each shard attends its own heads over its own pool on its own device, and
the result is the list of per-shard outputs (the reference constrains
the same shards for GSPMD; the output projection's sum lives in the
model). A tensor argument (block tables, lengths) is replicated to every
shard; a list gives each shard its own.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from ray_tpu_torch.collective.ops import axis_size
from ray_tpu_torch.parallel.sharding import ShardingRules


def _neg_inf_like(s):
    """The reference's -1e30 mask fill in ``s``'s dtype (-inf in f16)."""
    fill = float("-inf") if s.dtype == torch.float16 else -1e30
    return torch.full((), fill, dtype=s.dtype, device=s.device)


def _gather(cache, block_tables, B, Hkv, Dh):
    # [B, max_blocks * block_size, Hkv, Dh]
    return cache[block_tables.long()].reshape(B, -1, Hkv, Dh)


def _per_shard(fn: Callable, mesh, rules, q, k_cache, v_cache, *rest
               ) -> List[torch.Tensor]:
    """fn over each shard of the kv_heads axis."""
    n = axis_size(mesh, (rules or ShardingRules()).kv_heads)
    if not len(q) == len(k_cache) == len(v_cache) == n:
        raise ValueError(f"{len(q)} query, {len(k_cache)} and "
                         f"{len(v_cache)} cache shards for {n} kv_heads "
                         f"shards")
    return [fn(q[j], k_cache[j], v_cache[j],
               *[a[j] if isinstance(a, (list, tuple)) else a.to(q[j].device)
                 for a in rest])
            for j in range(n)]


def paged_attention_decode(q, k_cache, v_cache, block_tables, context_lens,
                           mesh=None, rules=None):
    """One query token per sequence against its paged context.

    q [B, n_heads, head_dim]; k/v cache [num_blocks, block_size,
    n_kv_heads, head_dim]; block_tables [B, max_blocks] (rows padded with
    the null block); context_lens [B]. Slots at or past
    ``context_lens[b]`` are masked. Returns ``[B, n_heads, head_dim]`` in
    q's dtype. With ``mesh``, per shard (module docstring).
    """
    if mesh is not None:
        return _per_shard(paged_attention_decode, mesh, rules, q, k_cache,
                          v_cache, block_tables, context_lens)
    B, Hq, Dh = q.shape
    Hkv = k_cache.shape[2]
    if Hq % Hkv:
        raise ValueError(f"n_heads {Hq} % n_kv_heads {Hkv} != 0")
    group = Hq // Hkv
    k = _gather(k_cache, block_tables, B, Hkv, Dh)
    v = _gather(v_cache, block_tables, B, Hkv, Dh)
    s_len = k.shape[1]
    qg = q.reshape(B, Hkv, group, Dh)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) * (Dh ** -0.5)
    valid = (torch.arange(s_len, device=q.device)[None, :]
             < context_lens.to(q.device)[:, None])                # [B, S]
    s = torch.where(valid[:, None, None, :], s,
                    _neg_inf_like(s))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    o = torch.einsum("bhgs,bshd->bhgd", p, v)
    return o.reshape(B, Hq, Dh)


def paged_attention_prefill(q, k_cache, v_cache, block_tables, q_positions,
                            mesh=None, rules=None):
    """A chunk of C query tokens per sequence against the paged context
    written so far (cached prefix, earlier chunks and the chunk itself).

    q [B, C, n_heads, head_dim]; q_positions [B, C] absolute positions. A
    token attends every slot at position <= its own. Padded rows produce
    garbage the caller ignores. Returns ``[B, C, n_heads, head_dim]``.
    With ``mesh``, per shard (module docstring).
    """
    if mesh is not None:
        return _per_shard(paged_attention_prefill, mesh, rules, q, k_cache,
                          v_cache, block_tables, q_positions)
    B, C, Hq, Dh = q.shape
    Hkv = k_cache.shape[2]
    if Hq % Hkv:
        raise ValueError(f"n_heads {Hq} % n_kv_heads {Hkv} != 0")
    group = Hq // Hkv
    k = _gather(k_cache, block_tables, B, Hkv, Dh)
    v = _gather(v_cache, block_tables, B, Hkv, Dh)
    s_len = k.shape[1]
    qg = q.reshape(B, C, Hkv, group, Dh)
    s = torch.einsum("bchgd,bshd->bhgcs", qg, k) * (Dh ** -0.5)
    valid = (torch.arange(s_len, device=q.device)[None, None, :]
             <= q_positions.to(q.device)[:, :, None])            # [B, C, S]
    s = torch.where(valid[:, None, None, :, :], s,
                    _neg_inf_like(s))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    o = torch.einsum("bhgcs,bshd->bchgd", p, v)
    return o.reshape(B, C, Hq, Dh)
