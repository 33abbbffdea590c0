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
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _gather(cache, block_tables, B, Hkv, Dh):
    # [B, max_blocks * block_size, Hkv, Dh]
    return cache[block_tables.long()].reshape(B, -1, Hkv, Dh)


def paged_attention_decode(q, k_cache, v_cache, block_tables, context_lens):
    """One query token per sequence against its paged context.

    q [B, n_heads, head_dim]; k/v cache [num_blocks, block_size,
    n_kv_heads, head_dim]; block_tables [B, max_blocks] (rows padded with
    the null block); context_lens [B]. Slots at or past
    ``context_lens[b]`` are masked. Returns ``[B, n_heads, head_dim]`` in
    q's dtype.
    """
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
                    torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    o = torch.einsum("bhgs,bshd->bhgd", p, v)
    return o.reshape(B, Hq, Dh)


def paged_attention_prefill(q, k_cache, v_cache, block_tables, q_positions):
    """A chunk of C query tokens per sequence against the paged context
    written so far (cached prefix, earlier chunks and the chunk itself).

    q [B, C, n_heads, head_dim]; q_positions [B, C] absolute positions. A
    token attends every slot at position <= its own. Padded rows produce
    garbage the caller ignores. Returns ``[B, C, n_heads, head_dim]``.
    """
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
                    torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    o = torch.einsum("bhgcs,bshd->bchgd", p, v)
    return o.reshape(B, C, Hq, Dh)
