"""The port's rule of attention routes (``_attention_route``) and the
shapes and dtypes it sends to the plain path, held against the JAX
reference on the CPU.

The reference falls back to plain attention when head_dim is no multiple
of 8 (``flash_attention``'s ``_fallback``, the model's dense einsum); the
port does the same, and counts each plain route in ``plain_routes``, so a
run can show that a model never took it. Every other head_dim takes a
kernel route (above 256 the wide kernels, which split the head dimension
across blocks); a CPU tensor runs the kernel's plain version like any
other kernel route. f32
inputs compare at 1e-5 (the same math in another summation order); f16
and bf16 configs at a few ulps of their O(1) logits.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.models as jm
from ray_tpu.models import transformer as jt
from ray_tpu_torch import models as tm
from ray_tpu_torch.models import transformer as tt

torch.set_num_threads(1)

# Both packages re-export the function under its module's name.
fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
jfa = importlib.import_module("ray_tpu.ops.flash_attention")

ATOL = 1e-5
GRAD_REL = 1e-5
# f16 keeps 11 bits, bf16 8: logits of magnitude ~3 after one layer agree
# to a few ulps (2^-9 and 2^-6 relative), rounded at other places in the
# two frameworks.
LOW_PRECISION_ATOL = {torch.float16: 0.02, torch.bfloat16: 0.1}

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
          "f16": torch.float16}


@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
@pytest.mark.parametrize("D", [12, 64, 128, 200, 256, 264, 512, 1024,
                               1032])
def test_attention_route_rule(D, dtype):
    dt = DTYPES[dtype]
    want = ("plain" if D == 12
            else "wide_f32" if D > 256 and dt == torch.float32
            else "wide_wgmma" if D > 256
            else "wgmma" if dt != torch.float32
            else "tiled_f32")
    assert fa._attention_route(dt, D) == want
    before = fa.plain_routes
    assert fa.take_route(dt, D) == want
    assert fa.plain_routes - before == (want == "plain")
    # The backward pair takes the forward's variant: one rule for both
    # directions (f32 up to 256: the tiled f32 forward and pair).
    if want != "plain":
        assert fa._forward_variant(dt, D) == want


@pytest.mark.parametrize("sq,sk", [(4, 16), (16, 5), (7, 7), (1, 1),
                                   (8, 8), (16, 130)])
@pytest.mark.parametrize("D", [64, 264])
def test_attention_route_takes_plain_below_eight_tokens(sq, sk, D):
    """A query or key length under 8 takes the plain path at every dtype
    and head_dim (the reference's wrappers fall back there: its Pallas
    kernel needs both lengths at least 8), counted in plain_routes; a call
    without lengths keeps the head_dim rule alone."""
    plain = sq < 8 or sk < 8
    for dt in DTYPES.values():
        want = "plain" if plain else fa._forward_variant(dt, D)
        assert fa._attention_route(dt, D, sq, sk) == want
        before = fa.plain_routes
        assert fa.take_route(dt, D, sq, sk) == want
        assert fa.plain_routes - before == plain
        assert fa._attention_route(dt, D) == fa._forward_variant(dt, D)


@pytest.mark.parametrize("sq,sk", [(4, 16), (16, 5)])
def test_short_lengths_take_the_reference_fallback(sq, sk):
    """flash_attention and flash_attention_grouped at a length under 8:
    one plain route each, no launch, the plain version's result exactly
    (``_fallback`` / ``_fallback_grouped``), equal to the reference's
    wrappers (which fall back too); the model's ``_attention_dense`` on a
    4-token input takes the dense einsum and counts one plain route."""
    D = 64
    q = np.random.default_rng(sq).standard_normal((2, 4, sq, D)).astype(
        np.float32)
    k, v = (np.random.default_rng(sk + i).standard_normal(
        (2, 4, sk, D)).astype(np.float32) for i in range(2))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    before, launched = fa.plain_routes, _launch_counts()
    out = fa.flash_attention(tq, tk, tv, causal=True)
    grouped = fa.flash_attention_grouped(tq, tk[:, :2], tv[:, :2],
                                         causal=True)
    assert fa.plain_routes == before + 2
    assert _launch_counts() == launched
    assert torch.equal(out, fa._fallback(tq, tk, tv, True, D ** -0.5))
    assert torch.equal(grouped, fa._fallback_grouped(
        tq, tk[:, :2], tv[:, :2], True, D ** -0.5))
    np.testing.assert_allclose(out.numpy(), np.asarray(
        jfa.flash_attention(jq, jk, jv, causal=True)), atol=ATOL)
    np.testing.assert_allclose(grouped.numpy(), np.asarray(
        jfa.flash_attention_grouped(jq, jk[:, :2], jv[:, :2], causal=True)),
        atol=ATOL)
    mq, mk, mv = (t[:, :, :4].transpose(1, 2) for t in (tq, tk, tv))
    before = fa.plain_routes
    dense = tt._attention_dense(mq, mk, mv)
    assert fa.plain_routes == before + 1
    assert torch.equal(dense, tt._attention_einsum(mq, mk, mv))


def _qkv(seed, Hq, Hkv, S, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((2, Hq, S, D), (2, Hkv, S, D), (2, Hkv, S, D))]


def _launch_counts():
    return (fa.launches, fa.dq_launches, fa.dkv_launches)


@pytest.mark.parametrize("D", [12, 264])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_route_matches_reference(D, causal):
    """flash_attention equals the reference's flash_attention, forward
    and gradients, with no launch: at D=12 through the counted plain route
    (the reference's ``_fallback``); at D=264 through the kernel route,
    whose CPU tensors run the plain version (the reference's Pallas kernel
    in interpret mode), with no plain route counted."""
    q, k, v = _qkv(D, 2, 2, 16, D)
    do = np.random.default_rng(D + 1).standard_normal(q.shape).astype(
        np.float32)
    ref, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
        q, k, v, causal=causal), *(jnp.asarray(a) for a in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before, launched = fa.plain_routes, _launch_counts()
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    assert fa.plain_routes == before + (D == 12)
    assert _launch_counts() == launched
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL)
    for r, g in zip(ref_grads, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=ATOL)


def test_flash_attention_grouped_plain_route_matches_reference():
    q, k, v = _qkv(3, 4, 2, 16, 12)
    ref = jfa.flash_attention_grouped(*(jnp.asarray(a) for a in (q, k, v)))
    before = fa.plain_routes
    out = fa.flash_attention_grouped(*(torch.from_numpy(a)
                                       for a in (q, k, v)))
    assert fa.plain_routes == before + 1
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


# Configs the reference computes and the port once refused on the card:
# head_dim 12 (d_model 48 over 4 heads), head_dim 256 (d_model 512 over
# 2), head_dim 264, head_dim 512 (d_model 1024 over 2 heads) and head_dim
# 1032 (d_model 2064 over 2 heads: the tensor-core forward streams Q, and
# its last 256-column chunk holds 8 columns), the last three on the wide
# kernels' route, which computes on the card and runs the plain version
# on the CPU.
BASE = jm.TransformerConfig(vocab_size=64, d_model=48, n_layers=2,
                            n_heads=4, n_kv_heads=2, d_ff=64,
                            dtype=jnp.float32)
CONFIGS = {
    "hd12": BASE,
    "hd256": dataclasses.replace(BASE, d_model=512, n_heads=2,
                                 n_kv_heads=1, n_layers=1),
    "hd264": dataclasses.replace(BASE, d_model=264, n_heads=1,
                                 n_kv_heads=1, n_layers=1),
    "hd512": dataclasses.replace(BASE, d_model=1024, n_heads=2,
                                 n_kv_heads=2, n_layers=1),
    "hd1032": dataclasses.replace(BASE, d_model=2064, n_heads=2,
                                  n_kv_heads=2, n_layers=1),
}


def _port_cfg(cfg, dtype=torch.float32):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = dtype
    return tt.TransformerConfig(**fields)


def _pair(cfg, dtype=torch.float32):
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                            _port_cfg(cfg, dtype), device="cpu")
    return jp, tp


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_loss_and_grads_match_reference(name):
    cfg = CONFIGS[name]
    jp, tp = _pair(cfg)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 64, (2, 12)).astype(np.int32)
    targets = rng.integers(0, 64, (2, 12)).astype(np.int32)
    ref_logits = jm.forward(cfg, jp, jnp.asarray(tokens))
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jt.loss_fn(cfg, p, jnp.asarray(tokens),
                             jnp.asarray(targets)))(jp)
    tcfg = _port_cfg(cfg)
    before = fa.plain_routes
    logits = tm.forward(tcfg, tp, torch.from_numpy(tokens))
    assert fa.plain_routes - before == (cfg.n_layers if name == "hd12"
                                        else 0)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), atol=1e-4)
    for t in tt._leaves(tp):
        t.requires_grad_(True)
    loss = tm.loss_fn(tcfg, tp, torch.from_numpy(tokens),
                      torch.from_numpy(targets))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-6)
    ref_flat = {"/".join(str(getattr(p, "key", p)) for p in path): leaf
                for path, leaf in
                jax.tree_util.tree_leaves_with_path(ref_grads)}
    for path, ref in ref_flat.items():
        keys = path.split("/")
        leaf = tp[keys[0]] if len(keys) == 1 else tp[keys[0]][keys[1]]
        ref = np.asarray(ref)
        err = np.abs(leaf.grad.numpy() - ref).max() / max(
            np.abs(ref).max(), 1e-30)
        assert err <= GRAD_REL, (path, err)


@pytest.mark.parametrize("name,dtype", [("hd12", torch.float16),
                                        ("hd256", torch.bfloat16),
                                        ("hd256", torch.float16)])
def test_low_precision_config_serves_like_reference(name, dtype):
    """A float16 config and a bf16 head_dim-256 config: forward logits and
    the prefill-with-cache logits against the reference's."""
    jdt = {torch.float16: jnp.float16, torch.bfloat16: jnp.bfloat16}[dtype]
    cfg = dataclasses.replace(CONFIGS[name], dtype=jdt)
    jp, tp = _pair(cfg, dtype)
    tcfg = _port_cfg(cfg, dtype)
    tokens = np.random.default_rng(6).integers(0, 64, (2, 8)).astype(
        np.int32)
    ref = jm.forward(cfg, jp, jnp.asarray(tokens))
    out = tm.forward(tcfg, tp, torch.from_numpy(tokens))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               atol=LOW_PRECISION_ATOL[dtype])
    table = np.arange(1, 5, dtype=np.int32)[None].repeat(2, 0)
    table[1] += 4
    lens = np.array([8, 5], np.int32)
    jl, _ = jm.prefill_with_cache(cfg, jp, jm.init_kv_cache(cfg, 9, 4),
                                  jnp.asarray(tokens), jnp.asarray(lens),
                                  jnp.asarray(table))
    tl, _ = tm.prefill_with_cache(
        tcfg, tp, tm.init_kv_cache(tcfg, 9, 4, device="cpu"),
        torch.from_numpy(tokens), torch.from_numpy(lens),
        torch.from_numpy(table))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl, np.float32),
                               atol=LOW_PRECISION_ATOL[dtype])


@pytest.mark.parametrize("name", ["hd512", "hd1032"])
def test_wide_config_prefill_matches_reference(name):
    """The wide configs in f32: prefill_with_cache logits (ragged lengths,
    a paged cache) against the reference's at the forward's tolerance,
    through the kernel route (the plain version on the CPU), no plain
    route counted."""
    cfg = CONFIGS[name]
    jp, tp = _pair(cfg)
    tcfg = _port_cfg(cfg)
    tokens = np.random.default_rng(7).integers(0, 64, (2, 12)).astype(
        np.int32)
    table = np.arange(1, 4, dtype=np.int32)[None].repeat(2, 0)
    table[1] += 3
    lens = np.array([12, 9], np.int32)
    jl, _ = jm.prefill_with_cache(cfg, jp, jm.init_kv_cache(cfg, 7, 4),
                                  jnp.asarray(tokens), jnp.asarray(lens),
                                  jnp.asarray(table))
    before = fa.plain_routes
    tl, _ = tm.prefill_with_cache(
        tcfg, tp, tm.init_kv_cache(tcfg, 7, 4, device="cpu"),
        torch.from_numpy(tokens), torch.from_numpy(lens),
        torch.from_numpy(table))
    assert fa.plain_routes == before
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
