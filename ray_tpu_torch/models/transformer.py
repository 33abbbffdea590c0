"""Flagship decoder-only transformer: training on one card and serving
(counterpart of ``ray_tpu/models/transformer.py``).

Dense and MoE models on one device: an MoE layer takes the reference's
dense fallback (every expert on every token, the top-1 expert's output
kept, scaled by its gate); the expert-parallel ``ep`` axis waits for the
multi-axis step. The parameter tree keeps the reference's key names and
stacked ``[L, ...]`` layer layout, so weights convert one to one
(``models/convert.py``). Activations are
``[B, S, H, Dh]`` inside the model; the KV pool is ``[L, num_blocks,
block_size, n_kv_heads, head_dim]`` with block 0 as the NULL block.

Differences from the JAX reference, none of which change results:

- ``lax.scan`` over stacked layers is a Python loop over ``[L, ...]``
  slices.
- The reference jits the cached programs with the pool donated; here the
  pool tensors are updated in place (``index_put_``) and the functions
  return the same cache dict. Padded rows and tails write into NULL block
  0 with duplicate indices, whose order is unspecified; block 0 is always
  masked, so that is harmless.
- The reference casts each f32 master weight to ``cfg.dtype`` at every
  use. Here each use calls ``.to(cfg.dtype)``, a no-op when the caller has
  converted the tree once with ``serving_params`` (the cast is exact and
  deterministic, so results are the same).
- ``forward`` and ``loss_fn`` are differentiable; the serving programs
  run under ``torch.no_grad``.
- ``make_train_step`` is the one-device counterpart of
  ``make_spmd_train_step``: no mesh, so no gradient sync and no
  collectives; ``torch.optim.AdamW`` with optax.adamw's defaults updates
  the f32 master parameters in place. A leaf that no layer uses (the dense
  MLP of a model whose every layer is MoE) gets a zero gradient, so AdamW
  decays it as optax does.
- The reference selects an MoE layer's output with ``jnp.where`` on the
  traced layer index, computing both branches; here the layer index is a
  Python int and only the kept branch runs (the same values).
- ``_attention_dense`` follows one rule, ``_attention_route`` of
  ``ops/flash_attention.py``: a head_dim that is no multiple of 8 takes
  the dense grouped einsum, as the reference does, each such call counted
  in ``plain_routes``. Every other head_dim takes the flash kernels on a
  CUDA tensor (which raise above head_dim 256, where no kernel is written
  yet and the reference runs Pallas; ROADMAP B), whatever S: the reference takes Pallas only
  for TPU-tileable lengths (S a multiple of 128), a rule the CUDA kernels
  do not need because they mask ragged lengths. CPU tensors take the
  dense grouped einsum, the reference's path off the TPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_grouped,
    neg_inf_like,
    take_route,
)
from ray_tpu_torch.ops.paged_attention import (
    paged_attention_decode,
    paged_attention_prefill,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 1376
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    # MoE: 0 = dense; otherwise every `moe_every`-th layer is MoE.
    num_experts: int = 0
    moe_every: int = 2
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.bfloat16
    remat: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_params(cfg: TransformerConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Stacked-layer parameter tree with the reference's key names and
    init scales, f32 master weights, drawn from a ``torch.Generator``
    seeded with ``seed`` (on the CPU, so a seed gives the same weights on
    every device). MoE configs add ``router`` [L, D, E], ``e_gate`` /
    ``e_up`` [L, E, D, F] and ``e_down`` [L, E, F, D]."""
    dev = resolve_device(device)
    D, F_, Hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    nq, nkv, L = cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    gen = torch.Generator().manual_seed(int(seed))

    def dense(shape, fan_in):
        return torch.randn(shape, generator=gen) * (1.0 / math.sqrt(fan_in))

    # One draw per weight family, in a fixed order, so same-shaped
    # families never share values.
    embed = torch.randn((cfg.vocab_size, D), generator=gen) * 0.02
    lm_head = dense((D, cfg.vocab_size), D)
    layers = {
        "attn_norm": torch.ones((L, D)),
        "wq": dense((L, D, nq * Hd), D),
        "wk": dense((L, D, nkv * Hd), D),
        "wv": dense((L, D, nkv * Hd), D),
        "wo": dense((L, nq * Hd, D), nq * Hd),
        "mlp_norm": torch.ones((L, D)),
        "w_gate": dense((L, D, F_), D),
        "w_up": dense((L, D, F_), D),
        "w_down": dense((L, F_, D), F_),
    }
    if cfg.num_experts:
        E = cfg.num_experts
        layers["router"] = dense((L, D, E), D)
        layers["e_gate"] = dense((L, E, D, F_), D)
        layers["e_up"] = dense((L, E, D, F_), D)
        layers["e_down"] = dense((L, E, F_, D), F_)
    tree = {"embed": embed, "layers": layers,
            "final_norm": torch.ones((D,)), "lm_head": lm_head}
    return _map_tree(tree, lambda t: t.to(dev))


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def serving_params(params: Dict[str, Any], cfg: TransformerConfig,
                   device="cuda") -> Dict[str, Any]:
    """The tree cast once to ``cfg.dtype`` on ``device``: every use in this
    module casts to that dtype anyway, so serving from the cast copy skips
    the per-call conversion and gives identical results."""
    dev = resolve_device(device)
    return _map_tree(params, lambda t: t.to(device=dev, dtype=cfg.dtype))


def rms_norm(x, w, eps=1e-6):
    # Casts to x's dtype BEFORE multiplying by w, as the reference does
    # (rms_norm_fused multiplies in f32; that is a different rounding).
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def rope(x, positions, theta):
    # x: [B, S, H, Dh]; rotate pairs (even, odd halves).
    Dh = x.shape[-1]
    half = Dh // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device)
        * (math.log(theta) / half))
    angles = positions[..., None].float() * freqs            # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention_dense(q, k, v, causal=True, grad=True):
    """q [B,S,Hq,Dh], k/v [B,S,Hkv,Dh] -> [B,S,Hq,Dh].

    A head_dim that ``_attention_route`` sends to the plain path takes the
    dense grouped einsum on every device (counted in ``plain_routes``).
    Otherwise a CUDA tensor runs the flash kernels (``_attention_flash``)
    and a CPU tensor the dense grouped einsum (under autograd when grad is
    on), as the reference does off the TPU."""
    if take_route(q.dtype, q.shape[-1]) != "plain" and q.is_cuda:
        return _attention_flash(q, k, v, causal, grad)
    return _attention_einsum(q, k, v, causal)


def _attention_flash(q, k, v, causal=True, grad=True):
    """Flash attention in the model's layout. Serving (``grad=False``) with
    GQA takes the grouped forward, K/V at n_kv_heads width. The
    differentiable path (``grad=True``) repeat-expands K/V as the
    reference's ``jnp.repeat(k, group, axis=2)`` does (each KV head
    repeated ``group`` times in place: ``repeat_interleave``, not
    ``Tensor.repeat``, which would tile the heads in another order), since
    the backward kernels want matched head counts."""
    Hq, Hkv = q.shape[2], k.shape[2]
    if Hq != Hkv and not grad:
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        return flash_attention_grouped(qt, kt, vt,
                                       causal=causal).transpose(1, 2)
    if Hq != Hkv:
        k = torch.repeat_interleave(k, Hq // Hkv, dim=2)
        v = torch.repeat_interleave(v, Hq // Hkv, dim=2)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    return flash_attention(qt, kt, vt, causal=causal).transpose(1, 2)


def _attention_einsum(q, k, v, causal=True):
    """The dense grouped einsum: queries fold to [B, S, Hkv, group, Dh]
    and contract against K/V at n_kv_heads width."""
    B, S, Hq, Dh = q.shape
    Hkv = k.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B, S, Hkv, group, Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * (Dh ** -0.5)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, neg_inf_like(s))
    p = torch.softmax(s.float(), dim=-1).to(q.dtype)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return o.reshape(B, S, Hq, Dh)


def _project_qkv(cfg, lp, h, positions):
    """h [B, S, D] -> q [B,S,Hq,Dh], k/v [B,S,Hkv,Dh] with rope."""
    dt = cfg.dtype
    B, S, _ = h.shape
    Hd = cfg.head_dim
    q = (h @ lp["wq"].to(dt)).reshape(B, S, -1, Hd)
    k = (h @ lp["wk"].to(dt)).reshape(B, S, -1, Hd)
    v = (h @ lp["wv"].to(dt)).reshape(B, S, -1, Hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _swiglu(cfg, lp, h):
    dt = cfg.dtype
    g = h @ lp["w_gate"].to(dt)
    u = h @ lp["w_up"].to(dt)
    return (F.silu(g) * u) @ lp["w_down"].to(dt)


def _moe_route(cfg, lp, h):
    """Top-1 routing of h [B, S, D]: (probs [B*S, E] f32, top [B*S]),
    router logits in f32 as in the reference."""
    logits = (h.float() @ lp["router"].float()).reshape(-1, cfg.num_experts)
    probs = torch.softmax(logits, dim=-1)
    return probs, torch.argmax(probs, dim=-1)


def _moe_dense(cfg, lp, h):
    """The reference's dense fallback (no ``ep`` axis): every expert runs
    on every token, the top-1 expert's rows are kept, scaled by its gate
    cast to ``cfg.dtype``. The expert products are plain batched products
    (no Pallas kernel in the reference either)."""
    dt = cfg.dtype
    B, S, D = h.shape
    E = cfg.num_experts
    probs, top = _moe_route(cfg, lp, h)
    rows = torch.arange(B * S, device=h.device)
    gate = probs[rows, top].to(dt)
    toks = h.reshape(1, B * S, D).expand(E, B * S, D)
    g = torch.einsum("ecd,edf->ecf", toks, lp["e_gate"].to(dt))
    u = torch.einsum("ecd,edf->ecf", toks, lp["e_up"].to(dt))
    outs = torch.einsum("ecf,efd->ecd", F.silu(g) * u, lp["e_down"].to(dt))
    return (outs[top, rows] * gate[:, None]).reshape(B, S, D)


def _mlp_block(cfg, lp, h, layer_idx):
    """Post-norm MLP or MoE for one layer over ``h`` [B, S, D]: with
    experts, layer ``i`` is MoE when ``i % moe_every == moe_every - 1``
    (every layer when ``moe_every == 1``, which never runs the dense
    branch), else the dense SwiGLU."""
    if cfg.num_experts and (layer_idx % cfg.moe_every
                            == cfg.moe_every - 1):
        return _moe_dense(cfg, lp, h)
    return _swiglu(cfg, lp, h)


def _layer(params, i):
    return {name: w[i] for name, w in params["layers"].items()}


def _layer_fn(cfg, lp, x, positions, layer_idx):
    """One transformer block over x [B, S, D] (the training layer body)."""
    dt = cfg.dtype
    B, S, _ = x.shape
    h = rms_norm(x, lp["attn_norm"])
    q, k, v = _project_qkv(cfg, lp, h, positions)
    o = _attention_dense(q, k, v)
    x = x + o.reshape(B, S, -1) @ lp["wo"].to(dt)
    h = rms_norm(x, lp["mlp_norm"])
    return x + _mlp_block(cfg, lp, h, layer_idx)


def forward(cfg: TransformerConfig, params, tokens) -> torch.Tensor:
    """Cacheless forward: tokens [B, S] -> logits [B, S, V] f32.
    Differentiable; with ``cfg.remat`` each layer is checkpointed and
    recomputed in the backward (the reference's ``jax.checkpoint``)."""
    dt = cfg.dtype
    B, S = tokens.shape
    tokens = tokens.long()
    x = params["embed"].to(dt)[tokens]
    positions = torch.arange(S, device=x.device).expand(B, S)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        if cfg.remat:
            x = checkpoint(_layer_fn, cfg, lp, x, positions, i,
                           use_reentrant=False)
        else:
            x = _layer_fn(cfg, lp, x, positions, i)
    x = rms_norm(x, params["final_norm"])
    return (x @ params["lm_head"].to(dt)).float()


def loss_fn(cfg: TransformerConfig, params, tokens, targets
            ) -> torch.Tensor:
    """Mean next-token NLL: log-softmax of the f32 logits, gathered at the
    targets (reference ``loss_fn``)."""
    logp = torch.log_softmax(forward(cfg, params, tokens), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    return nll.mean()


def make_train_step(cfg: TransformerConfig, params, lr: float = 3e-4
                    ) -> Callable[[torch.Tensor, torch.Tensor],
                                  torch.Tensor]:
    """One-device training step (counterpart of ``make_spmd_train_step``
    on a one-device mesh, whose gradient sync and pmean do nothing).

    ``params`` is the f32 master tree; its leaves are marked as requiring
    grad and updated in place. The optimizer is AdamW with optax.adamw's
    defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4; PyTorch's
    default weight decay of 1e-2 would differ). A leaf that the loss does
    not reach (the dense MLP when ``moe_every == 1``) gets a zero gradient,
    as under ``jax.grad``, so AdamW still decays it. Returns
    ``step(tokens, targets) -> loss`` (the loss before the update,
    detached)."""
    leaves = _leaves(params)
    for t in leaves:
        if t.dtype != torch.float32:
            raise TypeError(f"make_train_step wants f32 master parameters, "
                            f"got {t.dtype}")
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)

    def step(tokens, targets):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(cfg, params, tokens, targets)
        loss.backward()
        for t in leaves:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        opt.step()
        return loss.detach()

    return step


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def init_kv_cache(cfg: TransformerConfig, num_blocks: int, block_size: int,
                  dtype: Optional[torch.dtype] = None,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """Preallocate the paged KV pool ``[L, num_blocks, block_size,
    n_kv_heads, head_dim]`` for K and V, zeros so unwritten slots are
    finite. Block 0 is the NULL block."""
    dev = resolve_device(device)
    dt = dtype or cfg.dtype
    shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


@torch.no_grad()
def prefill_with_cache(cfg: TransformerConfig, params, cache, tokens,
                       prompt_lens, block_tables
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process right-padded prompts, writing every position's K/V into the
    paged cache (in place), and return the last-real-position logits.

    tokens [B, S]; prompt_lens [B]; block_tables [B, M] with
    M * block_size >= S (padded entries point at the NULL block). Returns
    (logits [B, vocab] f32 at position prompt_lens - 1, cache)."""
    B, S = tokens.shape
    dt = cfg.dtype
    ck, cv = cache["k"], cache["v"]
    block_size = ck.shape[2]
    x = params["embed"].to(dt)[tokens.long()]
    positions = torch.arange(S, device=x.device).expand(B, S)
    blk = torch.gather(block_tables.long(), 1, positions // block_size)
    off = positions % block_size
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["attn_norm"])
        q, k, v = _project_qkv(cfg, lp, h, positions)
        ck[i][blk, off] = k.to(ck.dtype)
        cv[i][blk, off] = v.to(cv.dtype)
        o = _attention_dense(q, k, v, causal=True, grad=False)
        x = x + o.reshape(B, S, -1) @ lp["wo"].to(dt)
        h = rms_norm(x, lp["mlp_norm"])
        x = x + _mlp_block(cfg, lp, h, i)
    x = rms_norm(x, params["final_norm"])
    last_idx = (prompt_lens.long().to(x.device) - 1).clamp(min=0)
    last = x[torch.arange(B, device=x.device), last_idx]
    logits = (last @ params["lm_head"].to(dt)).float()
    return logits, cache


@torch.no_grad()
def prefill_chunk(cfg: TransformerConfig, params, cache, tokens, start_pos,
                  chunk_lens, block_tables
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process one chunk of each prompt against the paged cache: tokens
    [B, C] start at absolute position start_pos[b] and attend everything
    already cached plus the chunk itself. Returns (logits [B, vocab] f32
    at the chunk's last valid position, cache)."""
    x = _chunk_scan(cfg, params, cache, tokens, start_pos, block_tables)
    B = x.shape[0]
    last_idx = (chunk_lens.long().to(x.device) - 1).clamp(min=0)
    last = x[torch.arange(B, device=x.device), last_idx]
    return (last @ params["lm_head"].to(cfg.dtype)).float(), cache


@torch.no_grad()
def verify_step(cfg: TransformerConfig, params, cache, tokens, start_pos,
                block_tables
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Speculative-decode verify: advance each sequence by C tokens in one
    call and return the logits at every position, so the flagship scores
    a draft model's proposals in one batched step.

    tokens [B, C]: row b holds its last accepted token followed by the
    draft's proposals, starting at absolute position ``start_pos[b]``;
    block_tables as in ``prefill_chunk``. Returns (logits [B, C, vocab]
    f32, cache). K/V of all C positions is written, rejected proposals
    included; the engine overwrites a rejected slot before any later step
    attends over it."""
    x = _chunk_scan(cfg, params, cache, tokens, start_pos, block_tables)
    return (x @ params["lm_head"].to(cfg.dtype)).float(), cache


def _chunk_scan(cfg: TransformerConfig, params, cache, tokens, start_pos,
                block_tables):
    """Shared body of ``prefill_chunk`` and ``verify_step``: run a chunk
    through every layer against the paged cache, writing each position's
    K/V before it is attended; returns the final-normed hidden states
    [B, C, D]."""
    B, C = tokens.shape
    dt = cfg.dtype
    ck, cv = cache["k"], cache["v"]
    block_size = ck.shape[2]
    block_tables = block_tables.long()
    M = block_tables.shape[1]
    x = params["embed"].to(dt)[tokens.long()]
    positions = (start_pos.long().to(x.device)[:, None]
                 + torch.arange(C, device=x.device)[None, :])    # [B, C]
    blk = torch.gather(block_tables, 1,
                       torch.clamp(positions // block_size, max=M - 1))
    off = positions % block_size
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["attn_norm"])
        q, k, v = _project_qkv(cfg, lp, h, positions)
        # Write the chunk's K/V, then attend over [0, position] per token.
        ck[i][blk, off] = k.to(ck.dtype)
        cv[i][blk, off] = v.to(cv.dtype)
        o = paged_attention_prefill(q, ck[i], cv[i], block_tables,
                                    positions)
        x = x + o.reshape(B, C, -1) @ lp["wo"].to(dt)
        h = rms_norm(x, lp["mlp_norm"])
        x = x + _mlp_block(cfg, lp, h, i)
    return rms_norm(x, params["final_norm"])


@torch.no_grad()
def decode_step(cfg: TransformerConfig, params, cache, tokens, positions,
                block_tables
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One continuous-batching iteration: each sequence advances by one
    token against its paged context.

    tokens [B] (the token at ``positions``); positions [B] (0-based);
    block_tables [B, M]. Padded rows carry position 0 and a NULL table.
    Returns (logits [B, vocab] f32, cache)."""
    B = tokens.shape[0]
    dt = cfg.dtype
    ck, cv = cache["k"], cache["v"]
    block_size = ck.shape[2]
    block_tables = block_tables.long()
    x = params["embed"].to(dt)[tokens.long()][:, None]     # [B, 1, D]
    positions = positions.long().to(x.device)
    context_lens = positions + 1
    blk = torch.gather(block_tables, 1,
                       (positions // block_size)[:, None])[:, 0]
    off = positions % block_size
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["attn_norm"])
        q, k, v = _project_qkv(cfg, lp, h, positions[:, None])
        # Write this token's K/V, then attend over [0, positions].
        ck[i][blk, off] = k[:, 0].to(ck.dtype)
        cv[i][blk, off] = v[:, 0].to(cv.dtype)
        o = paged_attention_decode(q[:, 0], ck[i], cv[i], block_tables,
                                   context_lens)
        x = x + o.reshape(B, 1, -1) @ lp["wo"].to(dt)
        h = rms_norm(x, lp["mlp_norm"])
        x = x + _mlp_block(cfg, lp, h, i)
    x = rms_norm(x[:, 0], params["final_norm"])
    return (x @ params["lm_head"].to(dt)).float(), cache
