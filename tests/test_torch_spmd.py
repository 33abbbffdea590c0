"""Parity of the port's manual multi-axis training step
(``ray_tpu_torch.models.make_spmd_train_step``) with the reference's
``make_spmd_train_step``, on the CPU.

The reference runs its ``shard_map`` step on its 8-device CPU mesh
(tests/conftest.py); the port runs its step over 8 virtual CPU shards of
a one-controller mesh. Weights come from the reference's ``init_params``
through ``params_from_jax``, tokens from a numpy seed. The meshes are
``tests/test_transformer.py``'s three (dp-tp-sp, dp-fsdp-pp,
moe-ep-tp-dp, with its ``DENSE`` and ``MOE`` configs and SGD at 0.1)
and a GQA config; ``tests/test_torch_parallel.py`` runs
``__graft_entry__.py``'s dry run's two meshes through these helpers.
Each test holds the loss
and every shard's every leaf after one step against the reference's
step (``addressable_shards``, device by device), and the loss against
the one-device ``loss_fn``.

Tolerances (f32 in both frameworks, which order their sums otherwise:
the row-parallel and gradient sums run over shards here and inside one
product or ``psum`` there): the loss to LOSS_RTOL; a leaf after SGD to
PARAM_ATOL, 1e-6 for weights of size ~0.1-1 moved by 0.1 times
gradients of size ~1e-2, so an error of 1e-5 of a gradient; after AdamW
the move of each element is lr * m / (sqrt(v) + eps) ~ lr, which an
ill-conditioned element (a gradient near eps) can change by its whole
size: ADAM_ATOL is lr / 10, which a sign error, a skipped sync or a
missing update breaks.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import ray_tpu.models as jm
from ray_tpu.models import transformer as jt
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.parallel.mesh import make_mesh as jmake_mesh
from jax.sharding import PartitionSpec as P
from ray_tpu_torch import models as tm
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

CPU = torch.device("cpu")
LOSS_RTOL = 1e-6
PARAM_ATOL = 1e-6

DENSE = jm.TransformerConfig(
    vocab_size=64, d_model=32, n_layers=4, n_heads=4, n_kv_heads=4,
    d_ff=64, dtype=jnp.float32)
MOE = jm.TransformerConfig(
    vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
    d_ff=64, num_experts=4, moe_every=2, capacity_factor=16.0,
    dtype=jnp.float32)
def _port_cfg(cfg, dtype=torch.float32):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = dtype
    return tt.TransformerConfig(**fields)


def _data(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flat(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _leaf(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


def _reference_step(cfg, mesh_kw, toks, tgts, opt, mb, key=0):
    jmesh = jmake_mesh(JMeshConfig(**mesh_kw),
                       devices=jax.devices("cpu")[:8])
    params = jm.init_params(cfg, jax.random.PRNGKey(key))
    step, _, _ = jm.make_spmd_train_step(cfg, jmesh, params, optimizer=opt,
                                         n_microbatches=mb)
    p2, _, loss = step(params, opt.init(params), jnp.asarray(toks),
                       jnp.asarray(tgts))
    return params, p2, float(loss), jmesh


def _port_step(cfg, params, mesh_kw, toks, tgts, make_opt, mb,
               dtype=torch.float32):
    mesh = tmesh.make_mesh(tmesh.MeshConfig(**mesh_kw), devices=[CPU] * 8)
    tree = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              _port_cfg(cfg), device="cpu")
    step, pspec, shards = tm.make_spmd_train_step(
        _port_cfg(cfg, dtype), mesh, tree, optimizer=make_opt,
        n_microbatches=mb)
    loss = step(torch.from_numpy(toks), torch.from_numpy(tgts)).item()
    return loss, shards, mesh


def _assert_shards_equal(p2, shards, jmesh, atol):
    """Every shard's leaf against the reference's buffer on the device at
    the same mesh coordinates."""
    for path, arr in _flat(p2):
        by_device = {s.device: np.asarray(s.data)
                     for s in arr.addressable_shards}
        for j, dev in enumerate(jmesh.devices.flat):
            got = _leaf(shards[j], path).detach().numpy()
            want = by_device[dev]
            assert got.shape == want.shape, (path, j)
            err = float(np.abs(got - want).max())
            assert err <= atol, f"{path} on shard {j}: {err} > {atol}"


def _sgd(leaves):
    return torch.optim.SGD(leaves, lr=0.1)


def _adamw(lr):
    return lambda leaves: torch.optim.AdamW(
        leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


CASES = {
    "dp-tp-sp": (DENSE, dict(dp=2, tp=2, sp=2), 4, 1),
    "dp-fsdp-pp": (DENSE, dict(dp=2, fsdp=2, pp=2), 8, 2),
    "moe-ep-tp-dp": (MOE, dict(ep=2, tp=2, dp=2), 4, 1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_spmd_sgd_step_matches_reference(eight_device_mesh, name):
    """tests/test_transformer.py's three meshes: one SGD(0.1) step."""
    cfg, mesh_kw, B, mb = CASES[name]
    toks, tgts = _data(cfg, B, 16)
    params, p2, want_loss, jmesh = _reference_step(
        cfg, mesh_kw, toks, tgts, optax.sgd(0.1), mb)
    loss, shards, _ = _port_step(cfg, params, mesh_kw, toks, tgts, _sgd, mb)
    one_device = float(jm.loss_fn(cfg, params, jnp.asarray(toks),
                                  jnp.asarray(tgts)))
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert abs(loss - one_device) <= 1e-5 * abs(one_device)
    _assert_shards_equal(p2, shards, jmesh, PARAM_ATOL)


def test_spmd_adamw_step_matches_reference(eight_device_mesh):
    """One step of the default optimizer (AdamW, optax.adamw's defaults
    at 3e-4) on dp2-fsdp2-pp2."""
    cfg, mesh_kw, B, mb = CASES["dp-fsdp-pp"]
    toks, tgts = _data(cfg, B, 16)
    params, p2, want_loss, jmesh = _reference_step(
        cfg, mesh_kw, toks, tgts, optax.adamw(3e-4), mb)
    loss, shards, _ = _port_step(cfg, params, mesh_kw, toks, tgts, None, mb)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    _assert_shards_equal(p2, shards, jmesh, 3e-4 / 10)


@pytest.mark.parametrize("mesh_kw", [dict(dp=2, tp=2, sp=2),
                                     dict(dp=4, tp=2)],
                         ids=["dp-tp-sp", "dp-tp"])
def test_spmd_gqa_matches_reference(eight_device_mesh, mesh_kw):
    """GQA (n_kv_heads 2) at tp 2: each shard holds one KV head for two
    query heads; under sp the ring repeat-expands K/V first."""
    cfg = dataclasses.replace(DENSE, n_kv_heads=2)
    toks, tgts = _data(cfg, 4, 16)
    params, p2, want_loss, jmesh = _reference_step(
        cfg, mesh_kw, toks, tgts, optax.sgd(0.1), 1)
    loss, shards, _ = _port_step(cfg, params, mesh_kw, toks, tgts, _sgd, 1)
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    _assert_shards_equal(p2, shards, jmesh, PARAM_ATOL)


REFUSALS = {
    "n_layers%pp": (DENSE, dict(pp=8), 8, 2, "make"),
    "heads%tp": (DENSE, dict(tp=8), 8, 1, "make"),
    "kv_heads%tp": (dataclasses.replace(DENSE, n_kv_heads=2), dict(tp=4),
                    8, 1, "make"),
    "experts%ep": (MOE, dict(ep=8), 8, 1, "make"),
    "batch%microbatches": (DENSE, dict(dp=2, fsdp=2, pp=2), 4, 2, "step"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_spmd_refusals_match_reference(eight_device_mesh, name):
    """Each ValueError the reference raises, raised at the same point:
    building the step, or the first step for a local batch that the
    microbatches do not divide."""
    cfg, mesh_kw, B, mb, where = REFUSALS[name]
    toks, tgts = _data(cfg, B, 16)
    jmesh = jmake_mesh(JMeshConfig(**mesh_kw),
                       devices=jax.devices("cpu")[:8])
    params = jm.init_params(cfg, jax.random.PRNGKey(0))
    opt = optax.sgd(0.1)
    mesh = tmesh.make_mesh(tmesh.MeshConfig(**mesh_kw), devices=[CPU] * 8)
    tree = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              _port_cfg(cfg), device="cpu")
    if where == "make":
        with pytest.raises(ValueError):
            jm.make_spmd_train_step(cfg, jmesh, params, optimizer=opt,
                                    n_microbatches=mb)
        with pytest.raises(ValueError):
            tm.make_spmd_train_step(_port_cfg(cfg), mesh, tree,
                                    optimizer=_sgd, n_microbatches=mb)
        return
    step, _, _ = jm.make_spmd_train_step(cfg, jmesh, params, optimizer=opt,
                                         n_microbatches=mb)
    with pytest.raises(ValueError):
        step(params, opt.init(params), jnp.asarray(toks), jnp.asarray(tgts))
    tstep, _, _ = tm.make_spmd_train_step(_port_cfg(cfg), mesh, tree,
                                          optimizer=_sgd, n_microbatches=mb)
    with pytest.raises(ValueError):
        tstep(torch.from_numpy(toks), torch.from_numpy(tgts))


@pytest.mark.parametrize("ep", [True, False], ids=["ep", "dense-fallback"])
def test_bf16_ep_layer_promotes_residual_to_f32(eight_device_mesh, ep):
    """Layer 0 (a dense layer) of a bf16 MoE model: under the ep axis the
    reference's jnp.where(is_moe, moe_out, dense_out) promotes the
    output to the MoE branch's f32, and so does the port; the dense
    fallback keeps bf16 in both (ROADMAP C.4). Values agree to one bf16
    ulp of the largest element (2**-7 relative), both sides rounding the
    same bf16 products in another order."""
    cfg = dataclasses.replace(MOE, dtype=jnp.bfloat16)
    jmesh = jmake_mesh(JMeshConfig(ep=2), devices=jax.devices("cpu")[:8])
    params = jm.init_params(cfg, jax.random.PRNGKey(0))
    lp = {n: w[0] for n, w in params["layers"].items()}
    B, S = 2, 16
    x = jnp.asarray(np.random.default_rng(5).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)).astype(jnp.bfloat16)
    positions = jnp.broadcast_to(jnp.arange(S), (B, S))
    specs = {n: (P("ep") if ep and n.startswith("e_") else P())
             for n in lp}
    ref = jax.jit(jax.shard_map(
        lambda lp, x: jt._layer_fn(cfg, lp, x, positions, 0,
                                   ep_axis="ep" if ep else None),
        mesh=jmesh, in_specs=(specs, P()), out_specs=P(),
        check_vma=False))(lp, x)

    mesh = tmesh.make_mesh(tmesh.MeshConfig(ep=2), devices=[CPU] * 8)
    tcfg = _port_cfg(cfg, torch.bfloat16)
    tree = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              _port_cfg(cfg), device="cpu")
    pspec = {"layers": tt._stage_params_spec(tcfg)}
    if not ep:
        pspec = {"layers": {n: (None,) for n in pspec["layers"]}}
    lps = [{n: w[0] for n, w in s["layers"].items()} for s in
           tm.shard_params_for_step({"layers": tree["layers"]}, mesh,
                                    pspec)]
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16)
    ax = tt._StepAxes(mesh=mesh, ep="ep" if ep else None)
    outs = tt._layer_shards(tcfg, ax, lps, [xt] * 8,
                            [torch.arange(S).expand(B, S)] * 8, 0)
    want_dtype = torch.float32 if ep else torch.bfloat16
    assert ref.dtype == (jnp.float32 if ep else jnp.bfloat16)
    want = np.asarray(ref.astype(jnp.float32))
    for o in outs:
        assert o.dtype == want_dtype
        err = float((o.float() - torch.from_numpy(want)).abs().max())
        assert err <= 2.0 ** -7 * float(np.abs(want).max())
