"""Parity of the PyTorch port's training path (ray_tpu_torch.models
``loss_fn``, ``make_train_step``, the differentiable attention) with the
JAX reference, on the CPU.

Weights come from the reference's ``init_params`` through
``params_from_jax``; tokens and targets from a numpy seed. Both sides run
in f32. On the CPU both take the dense einsum attention (the reference's
path off the TPU); the flash path's expand-and-backward is held against
the reference's attention by ``test_flash_attention_path_grads_match``.
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
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu_torch import models as tm
from ray_tpu_torch.models import transformer as tt

# The suite runs in several worker processes on one machine: one intra-op
# thread per process keeps these tests from starving the timing-sensitive
# engine tests that run beside them.
torch.set_num_threads(1)

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

GQA = jm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                           n_kv_heads=2, d_ff=48, dtype=jnp.float32)
MHA = dataclasses.replace(GQA, n_kv_heads=4)
B, S = 2, 16

# Loss and gradients in f32: the same math in another summation order.
# Gradients are held per leaf as max|port - ref| over max|ref|, since a
# leaf's small elements carry the absolute error of its large ones.
LOSS_RTOL = 1e-6
GRAD_REL = 1e-5
# After three AdamW steps (lr 3e-4), every parameter element within a few
# f32 ulps of the largest weights (the norm gains, at 1.0: one ulp is
# 1.2e-7). Adam moves each element by up to lr whatever the size of its
# gradient, so a sign or scale error in any gradient shows as ~lr, more
# than 100x this limit.
LR = 3e-4
PARAM_ATOL = 1e-6


def _port_cfg(cfg, **kw):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields.update(dtype=torch.float32, **kw)
    return tt.TransformerConfig(**fields)


def _pair(cfg):
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                            _port_cfg(cfg), device="cpu")
    return jp, tp


def _batch(seed, vocab):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (B, S)).astype(np.int32))


def _flat(jtree, ttree):
    """(name, reference array, port tensor) for every leaf."""
    out = []
    for name in ("embed", "final_norm", "lm_head"):
        out.append((name, np.asarray(jtree[name]), ttree[name]))
    for name in sorted(ttree["layers"]):
        out.append((f"layers.{name}", np.asarray(jtree["layers"][name]),
                    ttree["layers"][name]))
    return out


def _rel_err(ref, got):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("cfg", [MHA, GQA], ids=["mha", "gqa"])
def test_loss_and_grads_match_reference(cfg):
    jp, tp = _pair(cfg)
    tokens, targets = _batch(1, cfg.vocab_size)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jt.loss_fn(cfg, p, jnp.asarray(tokens),
                             jnp.asarray(targets)))(jp)
    for t in tt._leaves(tp):
        t.requires_grad_(True)
    loss = tm.loss_fn(_port_cfg(cfg), tp, torch.from_numpy(tokens),
                      torch.from_numpy(targets))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss),
                               rtol=LOSS_RTOL)
    for name, ref, leaf in _flat(ref_grads, tp):
        assert leaf.grad is not None, name
        err = _rel_err(ref, leaf.grad)
        assert err <= GRAD_REL, (name, err)


@pytest.mark.parametrize("cfg", [MHA, GQA], ids=["mha", "gqa"])
def test_remat_matches_no_remat(cfg):
    """Per-layer checkpointing recomputes the same layers: identical loss
    and gradients."""
    tokens, targets = (torch.from_numpy(a) for a in _batch(2, cfg.vocab_size))
    grads = []
    for remat in (False, True):
        _, tp = _pair(cfg)
        for t in tt._leaves(tp):
            t.requires_grad_(True)
        loss = tm.loss_fn(_port_cfg(cfg, remat=remat), tp, tokens, targets)
        loss.backward()
        grads.append((loss.item(), [t.grad for t in tt._leaves(tp)]))
    (l0, g0), (l1, g1) = grads
    assert l0 == l1
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("cfg", [MHA, GQA], ids=["mha", "gqa"])
def test_train_steps_match_spmd_train_step_on_one_device(cfg):
    import optax

    jp, tp = _pair(cfg)
    tokens, targets = _batch(3, cfg.vocab_size)
    mesh = make_mesh(MeshConfig(dp=1), devices=jax.devices("cpu")[:1])
    jstep, pspec, _ = jt.make_spmd_train_step(
        cfg, mesh, jp, optimizer=optax.adamw(LR))
    jparams = jt.shard_params_for_step(jp, mesh, pspec)
    opt_state = optax.adamw(LR).init(jparams)
    step = tm.make_train_step(_port_cfg(cfg), tp, lr=LR)
    tt_tokens, tt_targets = torch.from_numpy(tokens), torch.from_numpy(targets)
    for i in range(3):
        jparams, opt_state, jloss = jstep(jparams, opt_state,
                                          jnp.asarray(tokens),
                                          jnp.asarray(targets))
        loss = step(tt_tokens, tt_targets)
        np.testing.assert_allclose(loss.item(), float(jloss),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
    for name, ref, leaf in _flat(jparams, tp):
        np.testing.assert_allclose(leaf.detach().numpy(), ref, rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def test_flash_attention_path_grads_match():
    """The model's flash path (``_attention_flash``: GQA repeat-expanded
    with repeat_interleave, then the differentiable flash_attention, whose
    CPU backward is the plain backward) against the reference's attention
    under ``jax.vjp``."""
    rng = np.random.default_rng(4)
    Bq, Sq, Hq, Hkv, Dh = 2, 32, 4, 2, 16
    q = rng.standard_normal((Bq, Sq, Hq, Dh)).astype(np.float32)
    k = rng.standard_normal((Bq, Sq, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, Hkv, Dh)).astype(np.float32)
    do = rng.standard_normal((Bq, Sq, Hq, Dh)).astype(np.float32)
    ref_o, vjp = jax.vjp(lambda q, k, v: jt._attention_dense(q, k, v),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref_grads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = fa.launches, fa.dq_launches, fa.dkv_launches
    o = tt._attention_flash(tq, tk, tv, causal=True, grad=True)
    grads = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == before
    assert _rel_err(np.asarray(ref_o), o) <= GRAD_REL
    for ref, got in zip(ref_grads, grads):
        assert _rel_err(np.asarray(ref), got) <= GRAD_REL


def test_make_train_step_refuses_non_f32_master_weights():
    cfg = _port_cfg(MHA)
    params = tm.init_params(cfg, 0, device="cpu")
    params["lm_head"] = params["lm_head"].bfloat16()
    with pytest.raises(TypeError):
        tm.make_train_step(cfg, params)
