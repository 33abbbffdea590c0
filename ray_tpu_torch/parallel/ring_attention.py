"""Ring attention: exact blockwise attention over a context-parallel axis
(counterpart of ``ray_tpu/parallel/ring_attention.py``).

Each shard along ``sp`` holds a contiguous block of the sequence's
Q/K/V. K/V blocks rotate around the ring (the group ``permute`` of
``ray_tpu_torch.collective``, device d -> d + 1) while each shard merges
its queries' attention over the visiting block online (running max and
sum, as flash attention does), so no shard holds the whole score matrix.
Plain PyTorch, as the reference is plain ``jnp.einsum``: no kernel.

One controller drives every shard: q/k/v are the per-shard lists over a
mesh (``xs`` of ``ray_tpu_torch.collective``: one group along the axis,
or every shard of the mesh in the order of ``mesh.devices.flat``; of a
mesh that spans processes, this process's shards, and the hops between
processes go over ``torch.distributed``). The
reference's ``fori_loop`` also rotates K/V after the last block, a value
it never reads; here the ring makes n - 1 hops for n blocks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ray_tpu_torch.collective import ops as cops
from ray_tpu_torch.collective.order import in_order
from ray_tpu_torch.parallel.mesh import Mesh

NEG_INF = -1e30


def _block_attn(q, k, v, bias, scale):
    # q: [B, H, Sq, D], k/v: [B, H, Sk, D] -> scores [B, H, Sq, Sk]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        s = s + bias
    m = torch.amax(s, dim=-1, keepdim=True)
    # Guard fully-masked rows (all -inf): exp(0)=1 row but weight 0 below.
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m_safe)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    return o, m_safe, l


def _causal_bias(q, my, kv_shard, s_local):
    """[1, 1, S_local, S_local] in q's dtype: 0 where the query's global
    position is at or after the key's, NEG_INF elsewhere (the reference's
    weakly typed constant takes the scores' dtype)."""
    pos = torch.arange(s_local, device=q.device)
    mask = (my * s_local + pos)[:, None] >= (kv_shard * s_local + pos)[None]
    bias = torch.zeros(mask.shape, dtype=q.dtype, device=q.device)
    return bias.masked_fill(~mask, NEG_INF)[None, None]


@in_order
def ring_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor], *, mesh: Mesh,
                   axis_name: str = "sp", causal: bool = True,
                   scale: Optional[float] = None) -> List[torch.Tensor]:
    """Exact attention with K/V ring-rotated over ``axis_name``.

    Per shard q/k/v [B, H, S_local, D], the global sequence laid out
    contiguously across the axis (shard i holds tokens [i*S_local,
    (i+1)*S_local)). Returns the per-shard [B, H, S_local, D]."""
    if scale is None:
        scale = qs[0].shape[-1] ** -0.5
    n = cops.axis_size(mesh, axis_name)
    my = (list(range(n)) if len(qs) == n and not mesh.spans_processes
          else cops.axis_indices(mesh, axis_name))
    s_local = qs[0].shape[2]
    if n == 1:
        outs = []
        for q, k, v, i in zip(qs, ks, vs, my):
            bias = _causal_bias(q, i, 0, s_local) if causal else None
            o, _, l = _block_attn(q, k, v, bias, scale)
            outs.append(o / torch.clamp(l, min=1e-30))
        return outs
    o = [torch.zeros_like(q) for q in qs]
    m = [torch.full(q.shape[:3] + (1,), NEG_INF, dtype=q.dtype,
                    device=q.device) for q in qs]
    l = [torch.zeros(q.shape[:3] + (1,), dtype=q.dtype, device=q.device)
         for q in qs]
    k_cur, v_cur = list(ks), list(vs)
    perm = [(j, (j + 1) % n) for j in range(n)]
    for step in range(n):
        for j, q in enumerate(qs):
            kv_shard = (my[j] - step) % n
            bias = (_causal_bias(q, my[j], kv_shard, s_local) if causal
                    else None)
            o_i, m_i, l_i = _block_attn(q, k_cur[j], v_cur[j], bias, scale)
            # Online softmax merge of (o, m, l) with the new block.
            m_new = torch.maximum(m[j], m_i)
            a = torch.exp(m[j] - m_new)
            b = torch.exp(m_i - m_new)
            o[j] = o[j] * a + o_i * b
            l[j] = l[j] * a + l_i * b
            m[j] = m_new
        if step < n - 1:
            # Rotate K/V one hop around the ring (device d -> d+1).
            k_cur = cops.permute(k_cur, mesh, axis_name, perm)
            v_cur = cops.permute(v_cur, mesh, axis_name, perm)
    return [oj / torch.clamp(lj, min=1e-30) for oj, lj in zip(o, l)]


def reference_attention(q, k, v, causal=True, scale=None):
    """Unsharded exact attention, for tests."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask[None, None], s,
                        torch.full((), NEG_INF, dtype=s.dtype,
                                   device=s.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)
