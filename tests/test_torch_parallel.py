"""Parity of the port's parallel layer (``ray_tpu_torch.parallel``: ring
attention, Ulysses, MoE dispatch and combine, the GPipe pipeline), of
its collectives' gradients and of the training step on the dry run's
meshes, where these strategies meet (dense dp-pp-tp, MoE dp-sp-ep), with
the reference's ``shard_map`` programs, on the CPU.

The reference runs each program in ``jax.shard_map`` over its 8-device
CPU mesh (tests/conftest.py); the port runs the same program over 8
virtual CPU shards, one controller, on the same numpy inputs cut into
the same blocks. Shapes are ``tests/test_parallel.py``'s.

The dry run's steps use ``tests/test_torch_spmd.py``'s helpers and
tolerances (AdamW's at lr 1e-3). Here, the collectives' gradients are
sums of integers held as floats: exact. Attention, MoE and the pipeline
run in f32 in both frameworks, which order their sums differently: 1e-5
for values of size ~1 and 1e-4 for gradients, the values' an order
below the reference's own limit against its dense versions (1e-4).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

import ray_tpu.parallel as jpar
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.parallel.mesh import make_mesh as jmake_mesh
from ray_tpu.parallel.ring_attention import reference_attention as jref
import optax

import ray_tpu.models as jm
import ray_tpu_torch.collective as tops
from ray_tpu_torch import parallel as tpar
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel.ring_attention import reference_attention

from test_torch_spmd import (
    LOSS_RTOL,
    _adamw,
    _assert_shards_equal,
    _data,
    _port_step,
    _reference_step,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
VAL_TOL = 1e-5
GRAD_TOL = 1e-4
ADAM_ATOL = 1e-3 / 10


def _meshes(**sizes):
    return (jmake_mesh(JMeshConfig(**sizes), devices=jax.devices("cpu")[:8]),
            tmesh.make_mesh(tmesh.MeshConfig(**sizes), devices=[CPU] * 8))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _split(x, axis, n, mesh=None, along="sp"):
    """x cut along ``axis`` into n blocks, handed to every shard of the
    port's mesh by its coordinate along ``along`` (tensors that need
    grad, so a test can read each shard's gradient)."""
    blocks = np.split(x, n, axis=axis)
    idx = (tops.axis_indices(mesh, along) if mesh is not None
           else list(range(n)))
    return [torch.tensor(blocks[i], requires_grad=True) for i in idx]


# ------------------------------------------------------- collective grads
COLLECTIVES = {
    "psum_tp": (lambda a: lax.psum(a, "tp"),
                lambda xs, m: tops.allreduce(xs, m, "tp")),
    "psum_dp_tp": (lambda a: lax.psum(a, ("dp", "tp")),
                   lambda xs, m: tops.allreduce(xs, m, ("dp", "tp"))),
    "ppermute_tp": (
        lambda a: lax.ppermute(a, "tp", [(j, (j + 1) % 4) for j in range(4)]),
        lambda xs, m: tops.permute(xs, m, "tp",
                                   [(j, (j + 1) % 4) for j in range(4)])),
    "ppermute_partial_tp": (
        lambda a: lax.ppermute(a, "tp", [(0, 2), (2, 3), (3, 0)]),
        lambda xs, m: tops.permute(xs, m, "tp", [(0, 2), (2, 3), (3, 0)])),
    "all_to_all_tp": (
        lambda a: lax.all_to_all(a, "tp", split_axis=0, concat_axis=1,
                                 tiled=True),
        lambda xs, m: tops.all_to_all(xs, m, "tp", split_axis=0,
                                      concat_axis=1, tiled=True)),
}


@pytest.mark.parametrize("name", list(COLLECTIVES))
def test_collective_gradients_match_jax_grad(eight_device_mesh, name):
    """On a 2 x 4 mesh (dp 2, tp 4): the gradient of sum(w * op(x)) with
    respect to every shard's x, through torch.autograd over the port's
    op on the whole mesh, equals jax.grad of the shard_map'd op. This
    pins the transpose rules the training step rests on: psum -> psum to
    every member, ppermute -> the inverse permutation, all_to_all -> the
    inverse exchange. Integer inputs and weights: exact."""
    jfn, tfn = COLLECTIVES[name]
    jm, tm = _meshes(dp=2, tp=4)
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 9, (8 * 4, 4)).astype(np.float32)
    spec = P(tuple(tmesh.AXES))
    run = jax.shard_map(jfn, mesh=jm, in_specs=spec, out_specs=spec,
                        check_vma=False)
    want_val = np.asarray(run(x))
    w = rng.integers(-8, 9, want_val.shape).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: jnp.sum(run(a) * w))(x))

    xs = [torch.tensor(b, requires_grad=True) for b in np.split(x, 8)]
    outs = tfn(xs, tm)
    sum(torch.sum(o * torch.from_numpy(wj))
        for o, wj in zip(outs, np.split(w, 8))).backward()
    np.testing.assert_array_equal(
        torch.cat([o.detach() for o in outs]).numpy(), want_val)
    # A shard whose value no output reads gets no gradient from autograd
    # (None); jax.grad gives it zeros.
    got = torch.cat([torch.zeros_like(t) if t.grad is None else t.grad
                     for t in xs]).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ ring and ulysses
def _sp_program(jm, fn):
    spec = P(None, None, "sp", None)
    return jax.jit(jax.shard_map(fn, mesh=jm, in_specs=(spec,) * 3,
                                 out_specs=spec, check_vma=False))


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_reference(eight_device_mesh, causal):
    """sp 8, [2, 4, 32, 8]: the port's ring attention equals the
    reference's on every shard and the dense reference_attention, and its
    gradients (through the ring's permutes) equal jax.grad of the
    reference's ring."""
    jm, tm = _meshes(sp=8)
    B, H, S, D = 2, 4, 32, 8
    q, k, v = (_rand((B, H, S, D), i) for i in range(3))
    w = _rand((B, H, S, D), 3)
    f = _sp_program(jm, lambda q, k, v: jpar.ring_attention(
        q, k, v, axis_name="sp", causal=causal))
    want = np.asarray(f(q, k, v))
    want_g = jax.grad(lambda q, k, v: jnp.sum(f(q, k, v) * w),
                      argnums=(0, 1, 2))(q, k, v)
    np.testing.assert_allclose(
        want, np.asarray(jref(q, k, v, causal=causal)), atol=1e-4)

    qs, ks, vs = (_split(a, 2, 8, tm) for a in (q, k, v))
    outs = tpar.ring_attention(qs, ks, vs, mesh=tm, axis_name="sp",
                               causal=causal)
    sum(torch.sum(o * torch.from_numpy(wj))
        for o, wj in zip(outs, np.split(w, 8, axis=2))).backward()
    got = torch.cat([o.detach() for o in outs], dim=2).numpy()
    np.testing.assert_allclose(got, want, atol=VAL_TOL, rtol=0)
    np.testing.assert_allclose(
        got, reference_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 causal=causal).numpy(), atol=VAL_TOL)
    for ts, g in zip((qs, ks, vs), want_g):
        np.testing.assert_allclose(
            torch.cat([t.grad for t in ts], dim=2).numpy(), np.asarray(g),
            atol=GRAD_TOL, rtol=0)


def test_ring_attention_one_shard_and_bf16(eight_device_mesh):
    """The n == 1 shortcut (sp 1) equals the dense attention; a bf16 ring
    keeps bf16 (its causal bias takes the scores' type, as the
    reference's weakly typed constant does)."""
    _, tm = _meshes(dp=8)
    q, k, v = (torch.from_numpy(_rand((1, 2, 16, 8), i)) for i in range(3))
    outs = tpar.ring_attention([q] * 8, [k] * 8, [v] * 8, mesh=tm)
    want = reference_attention(q, k, v).numpy()
    for o in outs:
        np.testing.assert_allclose(o.numpy(), want, atol=VAL_TOL)
    _, tm = _meshes(sp=8)
    qb, kb, vb = (list(torch.from_numpy(_rand((1, 2, 64, 8), i))
                       .to(torch.bfloat16).chunk(8, dim=2)) for i in range(3))
    assert all(o.dtype == torch.bfloat16 for o in
               tpar.ring_attention(qb, kb, vb, mesh=tm))


def test_ulysses_matches_reference(eight_device_mesh):
    """sp 8, [2, 8, 32, 8]: Ulysses equals the reference's on every shard
    and the dense attention; a head count the axis does not divide
    raises ValueError, as in the reference."""
    jm, tm = _meshes(sp=8)
    B, H, S, D = 2, 8, 32, 8
    q, k, v = (_rand((B, H, S, D), i) for i in range(3))
    want = np.asarray(_sp_program(jm, lambda q, k, v: jpar.ulysses_attention(
        q, k, v, axis_name="sp"))(q, k, v))
    qs, ks, vs = (_split(a, 2, 8, tm) for a in (q, k, v))
    got = torch.cat(tpar.ulysses_attention(qs, ks, vs, mesh=tm), dim=2)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=VAL_TOL,
                               rtol=0)
    np.testing.assert_allclose(want, np.asarray(jref(q, k, v)), atol=1e-4)
    q4 = [t[:, :4] for t in qs]
    with pytest.raises(ValueError):
        tpar.ulysses_attention(q4, q4, q4, mesh=tm)
    with pytest.raises(ValueError):
        _sp_program(jm, lambda q, k, v: jpar.ulysses_attention(
            q, k, v, axis_name="sp"))(q[:, :4], k[:, :4], v[:, :4])


# ------------------------------------------------------------------- moe
def test_moe_dispatch_matches_reference(eight_device_mesh):
    """ep 8, T 64, D 16, E 8, capacity_factor E (nothing dropped): the
    combined output equals the reference's on every shard and the dense
    top-1 product; its gradients with respect to x, the router logits
    and the experts equal jax.grad of the reference's program."""
    jm, tm = _meshes(ep=8)
    T, D, E = 64, 16, 8
    x = _rand((T, D), 0)
    logits = _rand((T, E), 1)
    W = _rand((E, D, D), 2) * 0.1
    w = _rand((T, D), 3)

    def run(x, logits, W_local):
        return jpar.moe_dispatch_combine(
            x, logits, lambda tok: jnp.einsum("ecd,edf->ecf", tok, W_local),
            num_experts=E, capacity_factor=float(E), axis_name="ep")

    f = jax.jit(jax.shard_map(
        run, mesh=jm, in_specs=(P(), P(), P("ep", None, None)),
        out_specs=P(), check_vma=False))
    want = np.asarray(f(x, logits, W))
    want_g = jax.grad(lambda *a: jnp.sum(f(*a) * w), argnums=(0, 1, 2))(
        x, logits, W)

    xt, lt, Wt = (torch.tensor(a, requires_grad=True) for a in (x, logits, W))
    # Replicated x and logits, the experts cut over ep: differentiable
    # views of one tensor, so autograd sums each shard's contribution.
    outs = tpar.moe_dispatch_combine(
        [xt] * 8, [lt] * 8,
        lambda toks: [torch.einsum("ecd,edf->ecf", tok, Wt[i:i + 1])
                      for i, tok in enumerate(toks)],
        mesh=tm, num_experts=E, capacity_factor=float(E), axis_name="ep")
    for o in outs:
        np.testing.assert_allclose(o.detach().numpy(), want, atol=VAL_TOL,
                                   rtol=0)
    idx = np.argmax(logits, axis=-1)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    gate = (p / p.sum(-1, keepdims=True))[np.arange(T), idx]
    dense = np.einsum("td,tdf->tf", x, W[idx]) * gate[:, None]
    np.testing.assert_allclose(want, dense, atol=1e-4)
    # out_specs=P(): the reference's output is one shard's; so is the loss.
    torch.sum(outs[0] * torch.from_numpy(w)).backward()
    for t, g in zip((xt, lt, Wt), want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   atol=GRAD_TOL, rtol=0)


def test_moe_drops_over_capacity(eight_device_mesh):
    """ep 2, every token routed to expert 0 with capacity 2: the first two
    combine to their gated value, the rest to zeros, as in the reference;
    experts that ep does not divide raise ValueError."""
    jm, tm = _meshes(ep=2)
    T, D, E = 16, 4, 2
    x = np.ones((T, D), np.float32)
    logits = np.stack([np.full((T,), 5.0), np.zeros(T)], -1).astype(
        np.float32)

    def run(x, logits):
        return jpar.moe_dispatch_combine(
            x, logits, lambda tok: tok, num_experts=E, capacity_factor=0.25,
            axis_name="ep")

    want = np.asarray(jax.jit(jax.shard_map(
        run, mesh=jm, in_specs=(P(), P()), out_specs=P(),
        check_vma=False))(x, logits))
    xs = [torch.from_numpy(x)] * 8
    ls = [torch.from_numpy(logits)] * 8
    outs = tpar.moe_dispatch_combine(xs, ls, lambda toks: toks, mesh=tm,
                                     num_experts=E, capacity_factor=0.25,
                                     axis_name="ep")
    for o in outs:
        np.testing.assert_array_equal(o.numpy(), want)
        assert (o[2:] == 0).all() and (o[:2] != 0).all()
    with pytest.raises(ValueError):
        tpar.moe_dispatch_combine(xs, ls, lambda toks: toks, mesh=tm,
                                  num_experts=3, axis_name="ep")


def test_load_balancing_loss_matches_reference():
    logits = _rand((64, 8), 0)
    idx = np.argmax(logits, axis=-1)
    want = float(jpar.moe.load_balancing_loss(jnp.asarray(logits),
                                              jnp.asarray(idx), 8))
    got = tpar.load_balancing_loss(torch.from_numpy(logits),
                                   torch.from_numpy(idx), 8).item()
    assert abs(got - want) <= 1e-6 * abs(want)
    ti, tg = tpar.top1_router(torch.from_numpy(logits))
    ji, jg = jpar.moe.top1_router(jnp.asarray(logits))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)


# -------------------------------------------------------------- pipeline
def test_pipeline_matches_reference_and_grads(eight_device_mesh):
    """pp 4 (dp 2), M 8, [2, 16]: the pipeline's output on every shard
    equals the reference's and the sequential stages', and the gradient
    of its weights equals jax.grad of the reference's pipeline and of
    the sequential program."""
    jm, tm = _meshes(pp=4)
    M, B, D = 8, 2, 16
    Ws = _rand((4, D, D), 3) * 0.3
    xs = _rand((M, B, D), 4)

    f = jax.jit(jax.shard_map(
        lambda Ws, xs: jpar.pipeline_spmd(
            lambda w, a: jnp.tanh(a @ w[0]), Ws, xs, axis_name="pp"),
        mesh=jm, in_specs=(P("pp", None, None), P()), out_specs=P(),
        check_vma=False))
    want = np.asarray(f(Ws, xs))
    want_g = np.asarray(jax.grad(lambda W: jnp.sum(f(W, xs) ** 2))(Ws))

    Wt = torch.tensor(Ws, requires_grad=True)
    stage_of = tops.axis_indices(tm, "pp")

    def stage_fn(stage, sub_mesh, ws, acts):
        assert sub_mesh.shape["pp"] == 1 and len(ws) == len(acts) == 2
        return [torch.tanh(a @ w[0]) for w, a in zip(ws, acts)]

    outs = tpar.pipeline_spmd(stage_fn,
                              [Wt[s:s + 1] for s in stage_of],
                              [torch.from_numpy(xs)] * 8, mesh=tm)
    seq = torch.from_numpy(xs)
    for i in range(4):
        seq = torch.tanh(seq @ torch.from_numpy(Ws[i]))
    for o in outs:
        np.testing.assert_allclose(o.detach().numpy(), want, atol=VAL_TOL,
                                   rtol=0)
        np.testing.assert_allclose(o.detach().numpy(), seq.numpy(),
                                   atol=VAL_TOL, rtol=0)
    # out_specs=P(): the reference's output is one shard's.
    torch.sum(outs[0] ** 2).backward()
    np.testing.assert_allclose(Wt.grad.numpy(), want_g, atol=GRAD_TOL,
                               rtol=0)


def test_pipeline_one_stage_maps_microbatches(eight_device_mesh):
    _, tm = _meshes(dp=8)
    xs = torch.from_numpy(_rand((3, 2, 4), 0))
    outs = tpar.pipeline_spmd(
        lambda s, m, ws, acts: [(a * 2, b + 1) for a, b in acts],
        [None] * 8, [(xs, xs)] * 8, mesh=tm)
    for a, b in outs:
        np.testing.assert_array_equal(a.numpy(), (xs * 2).numpy())
        np.testing.assert_array_equal(b.numpy(), (xs + 1).numpy())


# ------------------------------------------------- the dry run's meshes
# __graft_entry__.py's dry run at n = 8: dp, pp, tp = 2, 2, 2 and
# dp, sp, ep = 2, 2, 2.
DRY_DENSE = jm.TransformerConfig(
    vocab_size=64, d_model=16, n_layers=4, n_heads=2, n_kv_heads=2,
    d_ff=32, dtype=jnp.float32)
DRY_MOE = jm.TransformerConfig(
    vocab_size=64, d_model=16, n_layers=2, n_heads=4, n_kv_heads=4,
    d_ff=32, num_experts=2, moe_every=2, dtype=jnp.float32)


DRY_RUNS = {
    "dense-dp-pp-tp": (DRY_DENSE, dict(dp=2, pp=2, tp=2), 4, 16, 2, 0),
    "moe-dp-sp-ep": (DRY_MOE, dict(dp=2, sp=2, ep=2), 4, 8, 1, 3),
}


@contextlib.contextmanager
def _compiled_afresh(fresh):
    """With ``fresh``, JAX's persistent compilation cache (which
    tests/conftest.py turns on) is off: the reference's dp2-sp2-ep2 step,
    loaded from that cache inside a pytest-xdist worker, stalls in its
    collectives and aborts the worker; compiled afresh it runs."""
    from jax.experimental.compilation_cache import compilation_cache as cc

    if not fresh:
        yield
        return
    kept = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    cc.reset_cache()
    try:
        yield
    finally:
        jax.config.update("jax_enable_compilation_cache", kept)
        cc.reset_cache()


@pytest.mark.parametrize("name", list(DRY_RUNS))
def test_dryrun_meshes_match_reference(eight_device_mesh, name):
    """__graft_entry__.py's dry run at n = 8 (tokens as targets, AdamW at
    1e-3): the dense dp2-pp2-tp2 mesh and the MoE dp2-sp2-ep2 mesh, the
    only one where sp and ep meet."""
    cfg, mesh_kw, B, S, mb, key = DRY_RUNS[name]
    toks, _ = _data(cfg, B, S, seed=4)
    with _compiled_afresh(mesh_kw.get("sp", 1) > 1):
        params, p2, want_loss, jmesh = _reference_step(
            cfg, mesh_kw, toks, toks, optax.adamw(1e-3), mb, key=key)
    loss, shards, _ = _port_step(cfg, params, mesh_kw, toks, toks,
                                 _adamw(1e-3), mb)
    assert np.isfinite(loss)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    _assert_shards_equal(p2, shards, jmesh, ADAM_ATOL)
