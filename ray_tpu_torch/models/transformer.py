"""Flagship decoder-only transformer: training on one card or over a
mesh (the manual multi-axis step), and serving on one device or
tensor-parallel (counterpart of ``ray_tpu/models/transformer.py``).

Dense and MoE models: without an ``ep`` axis an MoE layer takes the
reference's dense fallback (every expert on every token, the top-1
expert's output kept, scaled by its gate); the multi-axis step's ``ep``
axis dispatches each token to its expert's shard (``parallel/moe.py``).
The parameter tree keeps the reference's key names and stacked
``[L, ...]`` layer layout, so weights convert one to one
(``models/convert.py``). Activations are ``[B, S, H, Dh]`` inside the
model; the KV pool is ``[L, num_blocks, block_size, n_kv_heads,
head_dim]`` with block 0 as the NULL block.

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
  Python int and only the kept branch runs (the same values). Under the
  ``ep`` axis that ``where`` also sets the type: the MoE branch is f32
  (the f32 gate times the experts' output), so every layer's output is
  f32 and a bf16 model's residual stream is f32 from layer 1 on, as in
  the reference (ROADMAP C.4). jnp promotes a mixed product; torch
  refuses one, so each weight is promoted where the stream is wider
  (``_wt``).
- ``make_spmd_train_step`` runs the reference's ``shard_map`` program on
  a one-controller mesh (``ray_tpu_torch.parallel``): one process holds
  every shard's tensors, each layer runs over per-shard lists
  (``_block``, the one layer body of every path: with one shard and no
  collective it is the one-device layer op for op), and every collective
  is an explicit op of ``ray_tpu_torch.collective`` whose autograd
  backward is its ``lax`` transpose. Autograd of the sum of the shards'
  losses gives each shard the gradient the reference's ``jax.grad``
  gives it inside ``shard_map``. Its state lives in place, as in
  ``make_train_step``: see its docstring for how its signature differs
  from the reference's. On a mesh that spans processes
  (``parallel.distributed``) each process runs this program over its own
  shards, and every collective whose group spans processes crosses them
  (any axis may).
- ``_attention_dense`` follows one rule, ``_attention_route`` of
  ``ops/flash_attention.py``: a head_dim that is no multiple of 8, or
  fewer than 8 tokens, takes the dense grouped einsum, as the reference's
  flash wrappers fall back there, each such call counted in
  ``plain_routes``. Every other call takes the flash kernels on a CUDA
  tensor, at every ragged length: the reference takes Pallas only for
  TPU-tileable lengths (S a multiple of 128), a rule the CUDA kernels do
  not need because they mask ragged lengths. CPU tensors take the dense
  grouped einsum, the reference's path off the TPU.
- Tensor parallelism (``mesh=``/``rules=`` of ``prefill_chunk``,
  ``verify_step`` and ``decode_step``): the reference constrains
  activations and lets GSPMD insert the collectives; here the Megatron
  recipe is explicit, shard by shard, over the tp axis of a
  one-controller mesh (``ray_tpu_torch.parallel``). ``params`` is then
  the list of per-shard trees that ``shard_params`` cuts by
  ``param_specs`` and ``cache`` the list of per-shard pools
  (``kv_cache_specs``). The embedding is vocab-parallel (each shard looks
  up the tokens of its vocab slice, zeros elsewhere, and an ``allreduce``
  sums them, exactly); q/k/v are column-parallel, each shard attending
  with its own heads over its own pool; ``wo``, ``w_down`` and the
  experts' ``e_down`` are row-parallel, each followed by an
  ``allreduce`` of the partial products (another summation order than
  one device's); ``lm_head`` is vocab-parallel and the logits are
  allgathered. The other mesh axes must have size 1 (the reference's
  engine builds a tp-only mesh).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.collective import ops as cops
from ray_tpu_torch.collective.order import backward_order
from ray_tpu_torch.collective.ops import allgather, allreduce
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
from ray_tpu_torch.parallel.mesh import AXES, mesh_shape
from ray_tpu_torch.parallel.moe import moe_dispatch_combine
from ray_tpu_torch.parallel.pipeline import pipeline_spmd
from ray_tpu_torch.parallel.ring_attention import ring_attention
from ray_tpu_torch.parallel.sharding import (
    ShardingRules,
    shard_host_local,
    shard_params,
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


def param_specs(cfg: TransformerConfig,
                rules: Optional[ShardingRules] = None) -> Dict[str, Any]:
    """Spec tree matching ``init_params`` (the reference's, entry for
    entry). Layer weights carry the leading stacked-layer axis (on pp when
    a pipeline mesh is used, else a size-1 axis); 2-D weights shard their
    wide axis on tp and the other on fsdp (ZeRO-3)."""
    r = rules or ShardingRules()
    st, tp, fs = r.stage, r.mlp, r.fsdp_shard
    layers = {
        "attn_norm": (st, None),
        "wq": (st, fs, tp), "wk": (st, fs, tp), "wv": (st, fs, tp),
        "wo": (st, tp, fs),
        "mlp_norm": (st, None),
        "w_gate": (st, fs, tp), "w_up": (st, fs, tp),
        "w_down": (st, tp, fs),
    }
    if cfg.num_experts:
        layers.update({
            "router": (st, None, None),
            "e_gate": (st, r.expert, None, tp),
            "e_up": (st, r.expert, None, tp),
            "e_down": (st, r.expert, tp, None),
        })
    return {
        "embed": (r.vocab, None),
        "layers": layers,
        "final_norm": (None,),
        "lm_head": (fs, r.vocab),
    }


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

    A call that ``_attention_route`` sends to the plain path (a head_dim
    no multiple of 8, or fewer than 8 tokens, as a one-token prompt's
    prefill) takes the dense grouped einsum on every device (counted in
    ``plain_routes``). Otherwise a CUDA tensor runs the flash kernels
    (``_attention_flash``) and a CPU tensor the dense grouped einsum (under
    autograd when grad is on), as the reference does off the TPU."""
    if (take_route(q.dtype, q.shape[-1], q.shape[1], k.shape[1]) != "plain"
            and q.is_cuda):
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


def _wt(w, dt, x):
    """Weight ``w`` cast to the model's dtype ``dt`` for a product with
    ``x``, then promoted to x's dtype where that is wider: ``jnp`` promotes
    a mixed product (a bf16 weight times the f32 residual stream of the
    expert-parallel path, ROADMAP C.4), where torch refuses one. With x in
    ``dt`` the cast is the plain ``.to(dt)``."""
    w = w.to(dt)
    return w if x.dtype == w.dtype else w.to(
        torch.promote_types(x.dtype, w.dtype))


def _project_qkv(cfg, lp, h, positions):
    """h [B, S, D] -> q [B,S,Hq,Dh], k/v [B,S,Hkv,Dh] with rope."""
    dt = cfg.dtype
    B, S, _ = h.shape
    Hd = cfg.head_dim
    q = (h @ _wt(lp["wq"], dt, h)).reshape(B, S, -1, Hd)
    k = (h @ _wt(lp["wk"], dt, h)).reshape(B, S, -1, Hd)
    v = (h @ _wt(lp["wv"], dt, h)).reshape(B, S, -1, Hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _swiglu(cfg, lp, h):
    dt = cfg.dtype
    g = h @ _wt(lp["w_gate"], dt, h)
    u = h @ _wt(lp["w_up"], dt, h)
    a = F.silu(g) * u
    return a @ _wt(lp["w_down"], dt, a)


def _moe_route(cfg, lp, h):
    """Top-1 routing of h [B, S, D]: (probs [B*S, E] f32, top [B*S]),
    router logits in f32 as in the reference."""
    logits = (h.float() @ lp["router"].float()).reshape(-1, cfg.num_experts)
    probs = torch.softmax(logits, dim=-1)
    return probs, torch.argmax(probs, dim=-1)


def _experts(cfg, lp, toks):
    """The SwiGLU of each expert over its tokens: toks [E, C, D] ->
    [E, C, D] (this shard's d_ff slice under tensor parallelism). Plain
    batched products, as in the reference (no Pallas kernel)."""
    dt = cfg.dtype
    g = torch.einsum("ecd,edf->ecf", toks, _wt(lp["e_gate"], dt, toks))
    u = torch.einsum("ecd,edf->ecf", toks, _wt(lp["e_up"], dt, toks))
    a = F.silu(g) * u
    return torch.einsum("ecf,efd->ecd", a, _wt(lp["e_down"], dt, a))


def _moe_kept(cfg, lp, h):
    """The reference's dense fallback over h [B, S, D] (no ``ep`` axis):
    every expert on every token; returns (the top-1 expert's rows
    [B*S, D], its gate [B*S] in ``cfg.dtype``). Under tensor parallelism
    the rows are this shard's partial sums over its d_ff slice, summed
    across shards before the gate scales them."""
    B, S, D = h.shape
    E = cfg.num_experts
    probs, top = _moe_route(cfg, lp, h)
    rows = torch.arange(B * S, device=h.device)
    gate = probs[rows, top].to(cfg.dtype)
    outs = _experts(cfg, lp, h.reshape(1, B * S, D).expand(E, B * S, D))
    return outs[top, rows], gate


def _moe_ep(cfg, lps, hs, tp_sum, mesh, ep_axis):
    """An MoE layer over the ``ep`` axis: each shard routes its own
    tokens, ``moe_dispatch_combine`` sends them to their expert's shard
    and back, and the row-parallel ``e_down`` is summed over tp inside
    the experts, as the reference's ``expert_fn`` does. The f32 gate
    makes the output f32 whatever ``cfg.dtype`` is (ROADMAP C.4)."""
    B, S, D = hs[0].shape
    logits = [(h.float() @ lp["router"].float()).reshape(
        B * S, cfg.num_experts) for lp, h in zip(lps, hs)]
    outs = moe_dispatch_combine(
        [h.reshape(B * S, D) for h in hs], logits,
        lambda toks: tp_sum([_experts(cfg, lp, t)
                             for lp, t in zip(lps, toks)]),
        mesh=mesh, num_experts=cfg.num_experts,
        capacity_factor=cfg.capacity_factor, axis_name=ep_axis)
    return [o.reshape(B, S, D) for o in outs]


def _is_moe_layer(cfg, layer_idx) -> bool:
    return bool(cfg.num_experts) and (layer_idx % cfg.moe_every
                                      == cfg.moe_every - 1)


def _same(parts):
    return parts


def _mlp_shards(cfg, lps, hs, layer_idx, tp_sum=_same, ep=None):
    """Post-norm MLP or MoE of one layer over the per-shard ``hs``
    [B, S, D]: with experts, layer ``i`` is MoE when ``i % moe_every ==
    moe_every - 1`` (every layer when ``moe_every == 1``, which never runs
    the dense branch), else the dense SwiGLU. ``tp_sum`` sums the
    row-parallel partial products across the tp group (the identity
    without one); ``ep`` is ``(mesh, axis)`` of the expert-parallel path,
    or None for the reference's dense fallback.

    The reference selects the branch with ``jnp.where`` on the traced
    layer index and computes both; here only the kept branch runs. Under
    ``ep`` the where still decides the type: the MoE branch is f32, so a
    dense layer's output is promoted to f32 as well (ROADMAP C.4)."""
    if ep is not None and cfg.num_experts:
        if _is_moe_layer(cfg, layer_idx):
            return _moe_ep(cfg, lps, hs, tp_sum, *ep)
        dense = tp_sum([_swiglu(cfg, lp, h) for lp, h in zip(lps, hs)])
        return [d.to(torch.promote_types(d.dtype, torch.float32))
                for d in dense]
    if _is_moe_layer(cfg, layer_idx):
        kept = [_moe_kept(cfg, lp, h) for lp, h in zip(lps, hs)]
        rows = tp_sum([r for r, _ in kept])
        return [(r * g[:, None]).reshape(h.shape)
                for r, (_, g), h in zip(rows, kept, hs)]
    return tp_sum([_swiglu(cfg, lp, h) for lp, h in zip(lps, hs)])


def _mlp_block(cfg, lp, h, layer_idx):
    """``_mlp_shards`` on one device."""
    return _mlp_shards(cfg, [lp], [h], layer_idx)[0]


def _layer(params, i):
    return {name: w[i] for name, w in params["layers"].items()}


def _block(cfg, lps, xs, positions, layer_idx, attend, tp_sum=_same,
           ep=None):
    """One transformer block over per-shard lists: the one layer body of
    the one-device step, the sharded step and the tensor-parallel serving
    programs. ``attend(qs, ks, vs)`` returns each shard's attention
    output [B, S, Hq, Dh]; ``wo`` and the MLP's row-parallel products are
    summed by ``tp_sum`` before their residual adds."""
    dt = cfg.dtype
    qkv = [_project_qkv(cfg, lp, rms_norm(x, lp["attn_norm"]), pos)
           for lp, x, pos in zip(lps, xs, positions)]
    outs = attend(*map(list, zip(*qkv)))
    sums = tp_sum([o.reshape(*x.shape[:2], -1) @ _wt(lp["wo"], dt, o)
                   for o, x, lp in zip(outs, xs, lps)])
    xs = [x + s for x, s in zip(xs, sums)]
    hs = [rms_norm(x, lp["mlp_norm"]) for x, lp in zip(xs, lps)]
    return [x + m for x, m in zip(
        xs, _mlp_shards(cfg, lps, hs, layer_idx, tp_sum, ep))]


@dataclasses.dataclass(frozen=True)
class _StepAxes:
    """The shards a training layer runs on: one device (no mesh), or every
    shard of ``mesh`` (one pipeline stage's sub-mesh) with the collective
    axes of the manual step (None where the axis has size 1)."""

    mesh: Any = None
    sp: Optional[str] = None
    ep: Optional[str] = None
    tp: Optional[str] = None

    def tp_sum(self, parts):
        if self.tp is None:
            return parts
        return cops.allreduce(parts, self.mesh, self.tp)

    def attend(self, qs, ks, vs):
        if self.sp is None:
            return [_attention_dense(q, k, v) for q, k, v in zip(qs, ks, vs)]
        # Ring attention over sp, GQA's K/V repeat-expanded first.
        group = qs[0].shape[2] // ks[0].shape[2]
        if group != 1:
            ks = [torch.repeat_interleave(k, group, dim=2) for k in ks]
            vs = [torch.repeat_interleave(v, group, dim=2) for v in vs]
        outs = ring_attention([q.transpose(1, 2) for q in qs],
                              [k.transpose(1, 2) for k in ks],
                              [v.transpose(1, 2) for v in vs],
                              mesh=self.mesh, axis_name=self.sp, causal=True)
        return [o.transpose(1, 2) for o in outs]


def _layer_shards(cfg, ax: _StepAxes, lps, xs, positions, layer_idx):
    """One training block over per-shard lists (the reference's
    ``_layer_fn`` with its ``sp_axis``, ``ep_axis`` and ``tp_axis``)."""
    ep = None if ax.ep is None else (ax.mesh, ax.ep)
    return _block(cfg, lps, xs, positions, layer_idx, ax.attend, ax.tp_sum,
                  ep)


_ONE_DEVICE = _StepAxes()


def _layer_fn(cfg, lp, x, positions, layer_idx):
    """One transformer block over x [B, S, D] on one device: the sharded
    body with one shard and no collective."""
    return _layer_shards(cfg, _ONE_DEVICE, [lp], [x], [positions],
                         layer_idx)[0]


def forward(cfg: TransformerConfig, params, tokens, mesh=None, rules=None
            ) -> torch.Tensor:
    """Cacheless forward: tokens [B, S] -> logits [B, S, V] f32.
    Differentiable; with ``cfg.remat`` each layer is checkpointed and
    recomputed in the backward (the reference's ``jax.checkpoint``).

    ``mesh`` and ``rules`` are taken as the reference's GSPMD path takes
    them, which only adds sharding constraints on the activations and the
    logits: the values are the same with or without them. Their placement
    is not mirrored here: the computation and the result stay on the
    device of ``params`` and ``tokens``."""
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
    return (x @ _wt(params["lm_head"], dt, x)).float()


def loss_fn(cfg: TransformerConfig, params, tokens, targets, mesh=None,
            rules=None) -> torch.Tensor:
    """Mean next-token NLL: log-softmax of the f32 logits, gathered at the
    targets (reference ``loss_fn``). ``mesh`` and ``rules`` as in
    ``forward``: accepted, the value unchanged, placement not mirrored."""
    logp = torch.log_softmax(forward(cfg, params, tokens, mesh, rules),
                             dim=-1)
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
    detached); ``step.optimizer`` is the AdamW, so that a checkpoint of
    ``{"params": params, "opt": step.optimizer.state_dict()}`` resumes
    into a fresh step (``ray_tpu_torch.train.checkpoint``)."""
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

    step.optimizer = opt
    return step


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# Manual SPMD training step over the (dp, fsdp, pp, tp, sp, ep) mesh.
# ---------------------------------------------------------------------------

DATA_SPEC = (("dp", "fsdp"), "sp")


def _stage_params_spec(cfg: TransformerConfig) -> Dict[str, tuple]:
    """Specs of the stacked layer tree in the manual step: the leading
    layer axis over pp, wide weight axes over tp, experts over ep."""
    sp = {
        "attn_norm": ("pp", None),
        "wq": ("pp", None, "tp"), "wk": ("pp", None, "tp"),
        "wv": ("pp", None, "tp"), "wo": ("pp", "tp", None),
        "mlp_norm": ("pp", None),
        "w_gate": ("pp", None, "tp"), "w_up": ("pp", None, "tp"),
        "w_down": ("pp", "tp", None),
    }
    if cfg.num_experts:
        sp.update({
            "router": ("pp", None, None),
            "e_gate": ("pp", "ep", None, "tp"),
            "e_up": ("pp", "ep", None, "tp"),
            "e_down": ("pp", "ep", "tp", None),
        })
    return sp


def _named(tree, prefix=""):
    """[(path, leaf)] of a nested dict, in its key order."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in _named(v, f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _at(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


def _sharded_axes(spec) -> set:
    return {a for part in spec if part is not None
            for a in ((part,) if isinstance(part, str) else part)}


def _sync_grads(mesh, specs, grads, axes=AXES):
    """Per-leaf gradient sync (the reference's ``_sync_grads``). ``grads``
    holds, for each leaf (spec ``specs[i]``), its per-shard gradients: on
    each shard d(sum of every shard's local loss)/d(that shard's leaf).
    Each local loss is the mean over its own tokens (distinct across dp,
    fsdp and sp, the same function across tp, pp and ep), so a leaf
    sharded over axes S gets the global-mean gradient as the sum over
    the axes not in S, divided by the number of shards."""
    n_total = math.prod(mesh.shape[a] for a in AXES)
    out = []
    for spec, gs in zip(specs, grads):
        sharded = _sharded_axes(spec)
        repl = tuple(a for a in axes if a not in sharded)
        out.append([g / n_total for g in cops.allreduce(gs, mesh, repl)])
    return out


def shard_params_for_step(params, mesh, pspec) -> list:
    """The f32 tree cut by the step's specs: one tree per shard of the
    mesh, in the order of ``mesh.devices.flat``."""
    return shard_params(params, mesh, pspec)


def make_spmd_train_step(cfg: TransformerConfig, mesh, params,
                         optimizer: Optional[Callable] = None,
                         n_microbatches: int = 2):
    """Build the manual multi-axis training step on a one-controller mesh
    (counterpart of the reference's ``make_spmd_train_step``), every
    collective explicit: Megatron tp with row-parallel sums after ``wo``,
    ``w_down`` and the experts' ``e_down``; ring attention over sp; MoE
    dispatch over ep; the GPipe pipeline over pp; data cut over
    (dp, fsdp) and sp; the per-leaf gradient sync; the loss's mean over
    (dp, fsdp, sp). fsdp splits only the data: parameters stay replicated
    over it, as in the reference.

    Returns ``(step, pspec, shards)``. The reference returns ``(step,
    pspec, ospec)`` with a pure ``step(params, opt_state, tokens,
    targets) -> (params, opt_state, loss)``; here, as in
    ``make_train_step``, the state lives in place: ``shards`` are the
    per-shard f32 trees (``shard_params_for_step(params, mesh, pspec)``,
    in the order of ``mesh.devices.flat``) that ``step(tokens, targets)
    -> loss`` updates, and the optimizer's state lives in the torch
    optimizer. ``optimizer`` maps the list of every shard's leaves to a
    ``torch.optim.Optimizer`` (the update is elementwise, so one
    optimizer over all shards updates each shard as its own would);
    the default is AdamW with optax.adamw's defaults at lr 3e-4, the
    reference's default. tokens and targets are the global [B, S]
    batch; the loss returned is the shards' mean (detached).

    On a mesh that spans processes (``parallel.distributed``) every
    process builds the step alike: ``shards`` are this process's, and
    each process passes ``step`` only its rows of the global batch
    (``distributed.host_local_batch_slice(B, mesh=mesh)``: the rows of
    the (dp, fsdp) blocks its shards hold, so processes that differ only
    along ``tp``, ``sp``, ``ep`` or ``pp`` pass the same rows, and ``sp``
    cuts the sequence inside them). The loss is the global mean and each
    shard updates as under the one-process step over the whole batch.
    Any axis may cross processes, and each of its collectives then
    crosses them over ``torch.distributed``: the row-parallel sums after
    ``wo``, ``w_down`` and ``e_down`` over ``tp``, ring attention's K/V
    hops over ``sp``, MoE's dispatch and combine over ``ep``, the
    pipeline's activation hops over ``pp`` (``pipeline_spmd``), the
    gradient sync over every axis a leaf is replicated on and the
    loss's mean over (``dp``, ``fsdp``, ``sp``). Autograd runs through
    the exchanges across processes in one order in every process,
    however many devices a process drives (``collective/ops.py``); each
    step's forward is a chain of its own.

    Raises ``ValueError`` where the reference does: here for
    ``n_layers % pp``, heads % tp and experts % ep; at the step for a
    local batch that the microbatches do not divide (and for a batch or
    sequence that the mesh does not divide). Unlike the reference, it
    also raises for ``cfg.remat`` on a mesh that spans processes where a
    process drives more than one device: a checkpoint's recompute makes
    its exchanges across processes inside the backward, outside any
    chain, so each device's autograd thread would post them in an order
    of its own."""
    shape = mesh_shape(mesh)
    pp, tp, sp_n, ep_n = shape["pp"], shape["tp"], shape["sp"], shape["ep"]
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers {cfg.n_layers} % pp {pp} != 0")
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError("heads must divide tp")
    if cfg.num_experts and cfg.num_experts % ep_n:
        raise ValueError("experts must divide ep")
    n_dev = len({str(d) for d in mesh.local_devices})
    if cfg.remat and mesh.spans_processes and n_dev > 1:
        raise ValueError(
            f"remat on a mesh that spans processes needs one device in "
            f"each, this process drives {n_dev}: the recompute's "
            f"exchanges across processes run inside the backward, in the "
            f"order each device's autograd thread reaches them")
    layers_per_stage = cfg.n_layers // pp
    pspec = {"embed": (None, None), "layers": _stage_params_spec(cfg),
             "final_norm": (None,), "lm_head": (None, None)}
    axes = dict(sp="sp" if sp_n > 1 else None,
                ep="ep" if ep_n > 1 else None,
                tp="tp" if tp > 1 else None)
    with torch.no_grad():
        shards = shard_params_for_step(params, mesh, pspec)
    paths = [path for path, _ in _named(shards[0])]
    specs = [_at(pspec, path) for path in paths]
    # by_leaf[i]: leaf i (spec specs[i]) on every shard.
    by_leaf = [[_at(tree, path) for tree in shards] for path in paths]
    leaves = [t for ts in by_leaf for t in ts]
    for t in leaves:
        if t.dtype != torch.float32:
            raise TypeError(f"make_spmd_train_step wants f32 master "
                            f"parameters, got {t.dtype}")
        t.requires_grad_(True)
    if optimizer is None:
        opt = torch.optim.AdamW(leaves, lr=3e-4, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=1e-4)
    else:
        opt = optimizer(leaves)

    def run_stage(stage, sub_mesh, layer_trees, xs):
        """This stage's layers_per_stage layers over the per-shard
        activations of the sub-mesh's shards."""
        ax = _StepAxes(mesh=sub_mesh, **axes)
        B, S = xs[0].shape[:2]
        positions = [
            (torch.arange(S, device=x.device) + s * S).expand(B, S)
            for x, s in zip(xs, cops.axis_indices(sub_mesh, "sp"))]
        for i in range(layers_per_stage):
            lps = [{k: w[i] for k, w in t.items()} for t in layer_trees]
            gidx = stage * layers_per_stage + i
            if cfg.remat:
                xs = checkpoint(_layer_shards, cfg, ax, lps, xs, positions,
                                gidx, use_reentrant=False)
            else:
                xs = _layer_shards(cfg, ax, lps, xs, positions, gidx)
        return xs

    def local_losses(toks, tgts):
        """Each shard's loss over its tokens [B_local, S_local]."""
        dt = cfg.dtype
        B, S = toks[0].shape
        xs = [p["embed"].to(dt)[t] for p, t in zip(shards, toks)]
        layer_trees = [p["layers"] for p in shards]
        if pp > 1:
            mb = n_microbatches
            if B % mb:
                raise ValueError(f"local batch {B} % microbatches {mb}")
            outs = pipeline_spmd(
                run_stage, layer_trees,
                [x.reshape(mb, B // mb, S, -1) for x in xs], mesh=mesh,
                axis_name="pp")
            xs = [o.reshape(B, S, -1) for o in outs]
        else:
            xs = run_stage(0, mesh, layer_trees, xs)
        losses = []
        for x, p, t in zip(xs, shards, tgts):
            x = rms_norm(x, p["final_norm"])
            logits = (x @ _wt(p["lm_head"], dt, x)).float()
            logp = torch.log_softmax(logits, dim=-1)
            losses.append(-torch.gather(logp, -1, t[..., None])[..., 0]
                          .mean())
        return losses

    def step(tokens, targets):
        toks = [t.long() for t in shard_host_local(tokens, mesh, DATA_SPEC)]
        tgts = [t.long()
                for t in shard_host_local(targets, mesh, DATA_SPEC)]
        opt.zero_grad(set_to_none=True)
        with backward_order():
            losses = local_losses(toks, tgts)
        first = losses[0].device
        torch.stack([l.to(first) for l in losses]).sum().backward()
        # A leaf the loss does not reach gets a zero gradient, as under
        # jax.grad (make_train_step does the same).
        grads = [[torch.zeros_like(t) if t.grad is None else t.grad
                  for t in ts] for ts in by_leaf]
        with torch.no_grad():
            for ts, gs in zip(by_leaf, _sync_grads(mesh, specs, grads)):
                for t, g in zip(ts, gs):
                    t.grad = g
            loss = cops.allreduce([l.detach() for l in losses], mesh,
                                  ("dp", "fsdp", "sp"), op="mean")[0]
        opt.step()
        return loss

    return step, pspec, shards


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
                  chunk_lens, block_tables, mesh=None, rules=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Process one chunk of each prompt against the paged cache: tokens
    [B, C] start at absolute position start_pos[b] and attend everything
    already cached plus the chunk itself. Returns (logits [B, vocab] f32
    at the chunk's last valid position, cache). With ``mesh`` the program
    is tensor-parallel (module docstring): ``params`` and ``cache`` are
    per-shard lists and the logits live on the first shard's device."""
    sh = _Shards(mesh, rules, params, cache)
    B = tokens.shape[0]
    hs = _chunk_scan(cfg, sh, tokens, start_pos, block_tables)
    lasts = [h[torch.arange(B, device=h.device), (n - 1).clamp(min=0)]
             for h, n in zip(hs, sh.put(chunk_lens.long()))]
    return sh.logits(cfg, lasts), cache


@torch.no_grad()
def verify_step(cfg: TransformerConfig, params, cache, tokens, start_pos,
                block_tables, mesh=None, rules=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Speculative-decode verify: advance each sequence by C tokens in one
    call and return the logits at every position, so the flagship scores
    a draft model's proposals in one batched step.

    tokens [B, C]: row b holds its last accepted token followed by the
    draft's proposals, starting at absolute position ``start_pos[b]``;
    block_tables as in ``prefill_chunk``. Returns (logits [B, C, vocab]
    f32, cache). K/V of all C positions is written, rejected proposals
    included; the engine overwrites a rejected slot before any later step
    attends over it. ``mesh`` as in ``prefill_chunk``."""
    sh = _Shards(mesh, rules, params, cache)
    return sh.logits(cfg, _chunk_scan(cfg, sh, tokens, start_pos,
                                      block_tables)), cache


def _chunk_scan(cfg: TransformerConfig, sh: "_Shards", tokens, start_pos,
                block_tables):
    """Shared body of ``prefill_chunk`` and ``verify_step``: run a chunk
    through every layer against the paged cache, writing each position's
    K/V before it is attended; returns the final-normed hidden states
    [B, C, D], one per shard."""
    C = tokens.shape[1]
    block_size = sh.cache[0]["k"].shape[2]
    M = block_tables.shape[1]
    tables = sh.put(block_tables.long())
    positions = [s[:, None] + torch.arange(C, device=s.device)[None, :]
                 for s in sh.put(start_pos.long())]               # [B, C]
    blk = [torch.gather(t, 1, torch.clamp(p // block_size, max=M - 1))
           for t, p in zip(tables, positions)]
    off = [p % block_size for p in positions]

    def attend(i, qs, ks, vs):
        # Write the chunk's K/V, then attend over [0, position] per token.
        for c, k, v, b, o in zip(sh.cache, ks, vs, blk, off):
            c["k"][i][b, o] = k.to(c["k"].dtype)
            c["v"][i][b, o] = v.to(c["v"].dtype)
        return sh.attend(paged_attention_prefill, i, qs, tables, positions)

    xs = sh.layers(cfg, sh.embed(cfg, tokens), positions, attend)
    return [rms_norm(x, p["final_norm"]) for x, p in zip(xs, sh.params)]


@torch.no_grad()
def decode_step(cfg: TransformerConfig, params, cache, tokens, positions,
                block_tables, mesh=None, rules=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One continuous-batching iteration: each sequence advances by one
    token against its paged context.

    tokens [B] (the token at ``positions``); positions [B] (0-based);
    block_tables [B, M]. Padded rows carry position 0 and a NULL table.
    Returns (logits [B, vocab] f32, cache). ``mesh`` as in
    ``prefill_chunk``."""
    sh = _Shards(mesh, rules, params, cache)
    block_size = sh.cache[0]["k"].shape[2]
    tables = sh.put(block_tables.long())
    pos = sh.put(positions.long())
    blk = [torch.gather(t, 1, (p // block_size)[:, None])[:, 0]
           for t, p in zip(tables, pos)]
    off = [p % block_size for p in pos]
    context_lens = [p + 1 for p in pos]

    def attend(i, qs, ks, vs):
        # Write this token's K/V, then attend over [0, positions].
        for c, k, v, b, o in zip(sh.cache, ks, vs, blk, off):
            c["k"][i][b, o] = k[:, 0].to(c["k"].dtype)
            c["v"][i][b, o] = v[:, 0].to(c["v"].dtype)
        return sh.attend(paged_attention_decode, i, [q[:, 0] for q in qs],
                         tables, context_lens)

    xs = [x[:, None] for x in sh.embed(cfg, tokens)]          # [B, 1, D]
    xs = sh.layers(cfg, xs, [p[:, None] for p in pos], attend)
    return sh.logits(cfg, [rms_norm(x[:, 0], p["final_norm"])
                           for x, p in zip(xs, sh.params)]), cache


class _Shards:
    """The shards one cached call runs on: the one device of ``params``
    (no mesh), or the tp axis of ``mesh`` (``rules.heads``) with its
    per-shard parameter trees and KV pools in the axis's order. One
    layer body serves both; with one shard every collective is the
    identity and the embedding a plain lookup, so the one-device program
    is exactly the unsharded one."""

    def __init__(self, mesh, rules, params, cache):
        self.mesh, self.rules = mesh, rules
        if mesh is None:
            self.params, self.cache = [params], [cache]
            self.devices = [params["embed"].device]
            return
        r = rules or ShardingRules()
        axis = r.heads
        if not isinstance(axis, str) or (r.kv_heads, r.mlp, r.vocab) != (
                axis, axis, axis):
            raise ValueError(
                f"tensor-parallel programs shard heads, kv_heads, mlp and "
                f"vocab over one mesh axis; rules give {r.heads!r}, "
                f"{r.kv_heads!r}, {r.mlp!r}, {r.vocab!r}")
        others = {a: n for a, n in mesh.shape.items() if a != axis and n > 1}
        if others:
            raise ValueError(f"tensor-parallel programs shard over {axis!r} "
                             f"alone; mesh axes {others} must have size 1")
        self.axis, self.rules = axis, r
        self.devices = mesh.axis_devices(axis)
        if len(params) != len(self.devices) or \
                len(cache) != len(self.devices):
            raise ValueError(
                f"{len(params)} parameter shards and {len(cache)} pool "
                f"shards for a tp axis of {len(self.devices)}")
        self.params, self.cache = params, cache

    def put(self, t: torch.Tensor):
        """``t`` (a host-side index tensor) on every shard's device."""
        return [t.to(d) for d in self.devices]

    def allreduce(self, parts):
        if self.mesh is None:
            return parts
        return allreduce(parts, self.mesh, self.axis)

    def embed(self, cfg, tokens):
        """The token embeddings, one copy per shard. Under a mesh the
        lookup is vocab-parallel: each shard's rows for the tokens in its
        vocab slice, zeros for the rest, summed across shards (exact: one
        term of each sum is not zero)."""
        if self.mesh is None:
            return [self.params[0]["embed"].to(cfg.dtype)[
                tokens.long().to(self.devices[0])]]
        parts = []
        for j, (p, tok) in enumerate(zip(self.params,
                                         self.put(tokens.long()))):
            table = p["embed"].to(cfg.dtype)
            rows = table.shape[0]
            local = tok - j * rows
            hit = (local >= 0) & (local < rows)
            found = table[local.clamp(0, rows - 1)]
            parts.append(torch.where(hit[..., None], found, torch.zeros(
                (), dtype=found.dtype, device=found.device)))
        return self.allreduce(parts)

    def attend(self, fn, i, qs, *rest):
        """Paged attention ``fn`` of layer i over each shard's own heads
        and pool: ``rest`` are per-shard lists (tables, positions)."""
        ks = [c["k"][i] for c in self.cache]
        vs = [c["v"][i] for c in self.cache]
        if self.mesh is None:
            return [fn(qs[0], ks[0], vs[0], *[r[0] for r in rest])]
        return fn(qs, ks, vs, *rest, mesh=self.mesh, rules=self.rules)

    def layers(self, cfg, xs, positions, attend):
        """Every layer over the per-shard hidden states ``xs`` (replicated,
        [B, S, D] each); ``attend(i, qs, ks, vs)`` writes layer i's K/V
        into each shard's pool and returns each shard's attention output.
        The row-parallel products (``wo``, ``w_down``, ``e_down``) are
        summed across shards before the residual add. Returns the hidden
        states after the last layer, before the final norm."""
        for i in range(cfg.n_layers):
            xs = _block(cfg, [_layer(p, i) for p in self.params], xs,
                        positions, i,
                        lambda qs, ks, vs, i=i: attend(i, qs, ks, vs),
                        self.allreduce)
        return xs

    def logits(self, cfg, hs) -> torch.Tensor:
        """``lm_head`` in f32, vocab-parallel under a mesh: each shard's
        logit columns, allgathered onto the first shard's device."""
        parts = [h @ p["lm_head"].to(cfg.dtype)
                 for h, p in zip(hs, self.params)]
        if self.mesh is None:
            return parts[0].float()
        return allgather(parts, self.mesh, self.axis,
                         gather_axis=-1)[0].float()
