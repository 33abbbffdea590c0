"""Parity of the port's multi-process device plane
(``ray_tpu_torch.parallel.distributed``: the bootstrap, meshes that span
processes, collectives across processes, the pipeline, ring attention
and Ulysses across processes, and the training step with any axis
across them) with the reference, on the CPU.

The one-process twins hold ``tests/test_parallel.py``'s three tests of
``ray_tpu/parallel/distributed.py`` (the bootstrap, the axis tiers, a
sum over each tier) against the port on 8 virtual CPU shards, and pin
ROADMAP C.16 on both sides. The multi-process cases run two worker
processes (``torch_distributed_worker.py``, which imports no JAX),
each with 4 CPU shards, or four with 2 each, joined over gloo through a
TCP store on a free port; this process runs the reference on its
8-device CPU mesh and hands the workers their inputs through files.
Every wait is bounded (``WORKER_TIMEOUT_S``) and every worker is killed
on the way out.

The order of the backward's exchanges across processes
(``collective/ops.py``'s chain) is pinned in this process: CPU shards
share one autograd thread, so only a graph built to reach the exchanges
out of order shows it.

Tolerances: the steps are ``tests/test_torch_spmd.py``'s (f32 on both
sides, sums ordered otherwise): each loss to LOSS_RTOL = 1e-6 relative,
every leaf after two SGD(0.1) steps to PARAM_ATOL = 1e-6 and after two
AdamW steps to ADAM_ATOL = lr / 10, which a sign error, a skipped sync
or a missing update breaks. The collectives run on integers held as
floats, so values and gradients are exact. The pipeline alone is
``tests/test_torch_parallel.py``'s: f32 on both sides, VAL_TOL = 1e-5
for values of size ~1 and GRAD_TOL = 1e-4 for gradients.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax import lax
from jax.sharding import PartitionSpec as P

import ray_tpu.models as jm
from ray_tpu import parallel as jpar
from ray_tpu.parallel import distributed as jdist
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.parallel.mesh import make_mesh as jmake_mesh
import ray_tpu_torch.collective as tops
from ray_tpu_torch.collective import ops as cops
from ray_tpu_torch.collective import order as corder
from ray_tpu_torch import models as tm
from ray_tpu_torch import parallel as tpar
from ray_tpu_torch.parallel import distributed as tdist
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel.sharding import shard_host_local

import torch_distributed_worker as worker
from test_torch_parallel import _compiled_afresh
from test_torch_spmd import LOSS_RTOL, MOE, PARAM_ATOL, _flat, _port_cfg

torch.set_num_threads(1)

CPU = torch.device("cpu")
WORKER_TIMEOUT_S = 120.0
PROCESSES, SHARDS_EACH = 2, 4
LR_ADAM = 1e-3
VAL_TOL, GRAD_TOL = 1e-5, 1e-4
ADAM_ATOL = LR_ADAM / 10
STEPS, BATCH, LEN = 2, 8, 16

CFG = jm.TransformerConfig(
    vocab_size=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=4,
    d_ff=128, dtype=jnp.float32)
# CFG with each layer checkpointed: the recompute's tp sums cross the
# processes inside the backward (one device a process: the CPU).
REMAT = dataclasses.replace(CFG, remat=True)

# name -> (mesh, optimizer, microbatches[, config]): CFG unless the
# case names MOE (tests/test_torch_spmd.py's, 4 experts) or REMAT.
STEP_CASES = {
    "dp2-tp4-sgd": (dict(dp=2, tp=4), "sgd", 1),
    "dp2-tp4-adamw": (dict(dp=2, tp=4), "adamw", 1),
    "dp4-tp2-sgd": (dict(dp=4, tp=2), "sgd", 1),
    "dp4-tp2-adamw": (dict(dp=4, tp=2), "adamw", 1),
    "dp2-pp2-tp2-sgd": (dict(dp=2, pp=2, tp=2), "sgd", 2),
    "pp2-tp4-sgd": (dict(pp=2, tp=4), "sgd", 2),
    "pp2-tp4-adamw": (dict(pp=2, tp=4), "adamw", 2),
    # The ICI-bound axes across the two processes: fsdp (each process
    # its rows), tp (ring attention inside each process) and sp with ep
    # inside (the ring's K/V hops across processes).
    "fsdp2-tp4-sgd": (dict(fsdp=2, tp=4), "sgd", 1),
    "tp2-sp4-sgd": (dict(tp=2, sp=4), "sgd", 1),
    "tp2-sp4-adamw": (dict(tp=2, sp=4), "adamw", 1),
    "sp2-ep4-sgd": (dict(sp=2, ep=4), "sgd", 1, MOE),
    "tp2-sp4-remat-sgd": (dict(tp=2, sp=4), "sgd", 1, REMAT),
}
# Four processes x 2 CPU shards: dp and pp both cross processes, tp and
# sp both do (ep inside each process), or pp and tp both do.
FOUR_PROCESSES, FOUR_SHARDS_EACH = 4, 2
FOUR_STEP_CASES = {
    "dp2-pp2-tp2-sgd": (dict(dp=2, pp=2, tp=2), "sgd", 2),
    "tp2-sp2-ep2-sgd": (dict(tp=2, sp=2, ep=2), "sgd", 1, MOE),
    # pp and tp both across processes: each stage's tp sums run in that
    # stage's two processes alone.
    "pp2-tp4-sgd": (dict(pp=2, tp=4), "sgd", 2),
}
COLLECTIVE_MESHES = {"dp2-tp4": dict(dp=2, tp=4), "dp4-tp2": dict(dp=4, tp=2),
                     "pp2-tp4": dict(pp=2, tp=4),
                     "tp2-sp4": dict(tp=2, sp=4)}
# Ring attention and Ulysses on sp 8, four sequence blocks in each
# process (the ring's hops 3 -> 4 and 7 -> 0 cross them): [B, H, S, D].
ATTN_MESH = dict(sp=8)
ATTN_SHAPES = {"ring": (2, 4, 32, 8), "ulysses": (2, 8, 32, 8)}
# The pipeline twin: pipeline_spmd on pp2-tp4 (pp across the two
# processes), M microbatches of [PIPE_B, PIPE_D] a shard.
PIPE_MESH = dict(pp=2, tp=4)
PIPE_M, PIPE_B, PIPE_D = 3, 2, 8


def _jax_broadcast(a, root=1):
    return lax.psum(jnp.where(lax.axis_index("dp") == root, a, 0), "dp")


# name -> the lax counterpart. pmax has no transpose rule in jax: its
# counterpart is the max of an all_gather, whose gradient goes evenly to
# the members that hold the max, as the port's does.
JAX_OPS = {
    "allreduce_dp": lambda a: lax.psum(a, "dp"),
    "allreduce_dp_tp_mean": lambda a: lax.pmean(a, ("dp", "tp")),
    "allreduce_dp_max": lambda a: jnp.max(lax.all_gather(a, "dp", axis=0),
                                          axis=0),
    "allgather_dp": lambda a: lax.all_gather(a, "dp", axis=0, tiled=True),
    "allgather_dp_tp_stacked": lambda a: lax.all_gather(
        a, ("dp", "tp"), axis=0, tiled=False),
    "reducescatter_dp": lambda a: lax.psum_scatter(
        a, "dp", scatter_dimension=0, tiled=True),
    "allreduce_tp": lambda a: lax.psum(a, "tp"),
}


def _jax_op(name, sizes):
    """The lax counterpart of the worker's op ``name`` on a mesh of
    ``sizes`` (the permutations and the untiled split depend on them)."""
    if name in JAX_OPS:
        return JAX_OPS[name]
    if name == "broadcast_dp_root1":
        return lambda a: _jax_broadcast(a, min(1, sizes.get("dp", 1) - 1))
    kind, axis = name.rsplit("_", 1) if not name.endswith("untiled") \
        else ("all_to_all_untiled", "pp")
    n = sizes.get(axis, 1)
    if kind == "permute":
        return lambda a: lax.ppermute(a, axis, [(j, (j + 1) % n)
                                                for j in range(n)])
    if kind == "send_recv":
        return lambda a: lax.ppermute(a, axis, [(0, n - 1)])
    if kind == "all_to_all":
        return lambda a: lax.all_to_all(a, axis, 0, 1, tiled=True)
    # Untiled split and concat on one axis: this jax's vjp of an untiled
    # all_to_all with the two axes apart has mismatched shapes.
    return lambda a: lax.all_to_all(a.reshape(n, -1), axis, 0, 0,
                                    tiled=False)


def _jmesh(**sizes):
    return jmake_mesh(JMeshConfig(**sizes), devices=jax.devices("cpu")[:8])


# ------------------------------------------------------- one-process twins
def test_distributed_single_host_bootstrap():
    """tests/test_parallel.py:141 on both sides: with no coordinator
    ``initialize()`` is a one-process no-op."""
    for dist in (jdist, tdist):
        dist.initialize()
        assert dist.is_initialized()
        assert dist.process_count() == 1
        assert dist.process_index() == 0
        assert dist.host_local_batch_slice(64) == (0, 64)
        dist.shutdown()
        assert not dist.is_initialized()


def test_hybrid_mesh_axis_tiers(eight_device_mesh):
    """tests/test_parallel.py:155: DCN axes outermost, ICI axes inner,
    an ICI-bound axis on the DCN tier refused, on both sides."""
    for dist, devices in ((jdist, eight_device_mesh), (tdist, [CPU] * 8)):
        mesh = dist.make_hybrid_mesh(
            dist.HybridMeshConfig(dcn={"dp": 2}, ici={"tp": 2, "sp": 2}),
            devices=devices)
        assert mesh.axis_names == ("dp", "tp", "sp")
        assert dict(mesh.shape) == {"dp": 2, "tp": 2, "sp": 2}
        with pytest.raises(ValueError, match="must not cross DCN"):
            dist.make_hybrid_mesh(
                dist.HybridMeshConfig(dcn={"tp": 2}, ici={"dp": 4}),
                devices=devices)
        with pytest.raises(ValueError, match="mesh asks for 4 devices"):
            dist.make_hybrid_mesh(
                dist.HybridMeshConfig(dcn={"dp": 2}, ici={"tp": 2}),
                devices=devices)


def test_hybrid_mesh_runs_collectives(eight_device_mesh):
    """tests/test_parallel.py:173: a sum over each tier of
    ``make_hybrid_mesh(dcn dp 2, ici tp 4)``, shard by shard."""
    x = np.arange(8.0, dtype=np.float32)
    jmesh = jdist.make_hybrid_mesh(
        jdist.HybridMeshConfig(dcn={"dp": 2}, ici={"tp": 4}),
        devices=eight_device_mesh)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda a: lax.psum(lax.psum(a, "tp"), "dp"), mesh=jmesh,
        in_specs=P(("dp", "tp")), out_specs=P(("dp", "tp")),
        check_vma=False))(jnp.asarray(x)))
    assert float(want.sum()) == float(x.sum()) * 8
    mesh = tdist.make_hybrid_mesh(
        tdist.HybridMeshConfig(dcn={"dp": 2}, ici={"tp": 4}),
        devices=[CPU] * 8)
    xs = [torch.from_numpy(b) for b in np.split(x, 8)]
    got = tops.allreduce(tops.allreduce(xs, mesh, "tp"), mesh, "dp")
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


def test_hybrid_mesh_step_raises_keyerror_pp(eight_device_mesh):
    """ROADMAP C.16, a fault of the reference that the port mirrors:
    ``make_hybrid_mesh`` keeps only the axes larger than 1 and
    ``make_spmd_train_step`` reads all six, so the step cannot be built
    on a hybrid mesh (KeyError 'pp') on either side."""
    cfg = dataclasses.replace(CFG, n_layers=2)
    params = jm.init_params(cfg, jax.random.PRNGKey(0))
    config = jdist.HybridMeshConfig(dcn={"dp": 2}, ici={"tp": 4})
    with pytest.raises(KeyError, match="pp"):
        jm.make_spmd_train_step(
            cfg, jdist.make_hybrid_mesh(config, devices=eight_device_mesh),
            params, optimizer=optax.sgd(0.1))
    tree = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              _port_cfg(cfg), device="cpu")
    mesh = tdist.make_hybrid_mesh(
        tdist.HybridMeshConfig(dcn={"dp": 2}, ici={"tp": 4}),
        devices=[CPU] * 8)
    with pytest.raises(KeyError, match="pp"):
        tm.make_spmd_train_step(_port_cfg(cfg), mesh, tree,
                                optimizer=lambda ls: torch.optim.SGD(
                                    ls, lr=0.1))


def test_one_process_mesh_is_unchanged():
    """Without ``initialize`` a mesh is one process's: every entry local,
    no axis crossing, the per-shard lists whole. Given owners along
    ``tp``, the mesh spans processes and holds only this process's
    entries (any axis may cross)."""
    mesh = tmesh.make_mesh(tmesh.MeshConfig(dp=2, tp=4), devices=[CPU] * 8)
    assert not mesh.spans_processes
    assert mesh.local_indices == list(range(8))
    assert mesh.local_size == mesh.size == 8
    owners = np.arange(8).reshape(mesh.devices.shape) % 2
    across = tmesh.Mesh(mesh.devices, mesh.axis_names, owners)
    assert across.spans_processes
    assert across.local_indices == [0, 2, 4, 6]
    assert across.processes.tolist() == owners.tolist()


# ------------------------------------------------ two processes over gloo
def _inputs():
    params = jm.init_params(CFG, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, CFG.vocab_size, (STEPS, BATCH, LEN)).astype(
        np.int32)
    targets = rng.integers(0, CFG.vocab_size, (STEPS, BATCH, LEN)).astype(
        np.int32)
    return params, tokens, targets


def _case_cfg(case):
    return case[3] if len(case) > 3 else CFG


def _step_jobs(cases):
    """The workers' step jobs of ``cases``, and their parameter trees as
    arrays (``params/...`` for CFG and REMAT, ``params_moe/...`` for
    MOE): the reference's initial parameters of each config."""
    arrays, params, jobs = {}, {}, []
    for name, case in cases.items():
        sizes, opt, mb = case[:3]
        cfg = _case_cfg(case)
        prefix = "params_moe" if cfg is MOE else "params"
        if prefix not in params:
            params[prefix] = jm.init_params(cfg, jax.random.PRNGKey(0))
            tree = tm.params_from_jax(
                jax.tree_util.tree_map(np.asarray, params[prefix]),
                _port_cfg(cfg), device="cpu")
            arrays.update({f"{prefix}/{path}": leaf.numpy()
                           for path, leaf in _flat(tree)})
        fields = {f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg) if f.name != "dtype"}
        jobs.append({"kind": "step", "name": name, "cfg": fields,
                     "mesh": sizes, "optimizer": opt,
                     "lr": 0.1 if opt == "sgd" else LR_ADAM,
                     "steps": STEPS, "microbatches": mb, "params": prefix})
    return arrays, params, jobs


def _x(mesh_size=8):
    rng = np.random.default_rng(0)
    return rng.integers(-8, 9, (mesh_size * 4, 4)).astype(np.float32)


def _jax_collective(name, sizes, x, w):
    """The shard_map'd lax op on the reference's mesh: its value (every
    shard's blocks concatenated in flat order) and the gradient of
    sum(w * value) (the vjp of ``w``)."""
    jmesh = _jmesh(**sizes)
    spec = P(tuple(tmesh.AXES))
    run = jax.shard_map(_jax_op(name, sizes), mesh=jmesh,
                        in_specs=spec, out_specs=spec, check_vma=False)
    val, grad = jax.jit(lambda a, c: (run(a), jax.vjp(run, a)[1](c)[0]))(
        x, w)
    return np.asarray(val), np.asarray(grad)


def _one_process(name, sizes, x, w=None):
    """The op over 8 virtual CPU shards of one process: its value and,
    given weights, the gradient of sum(w * value)."""
    mesh = tmesh.make_mesh(tmesh.MeshConfig(**sizes), devices=[CPU] * 8)
    xs = [torch.tensor(b, requires_grad=True) for b in np.split(x, 8)]
    outs = worker.OPS[name](xs, mesh)
    val = torch.cat([o.detach() for o in outs]).numpy()
    if w is None:
        return val, None
    sum(torch.sum(o * torch.from_numpy(wj))
        for o, wj in zip(outs, np.split(w, 8))).backward()
    return val, torch.cat([torch.zeros_like(t) if t.grad is None
                           else t.grad for t in xs]).numpy()


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    """Every multi-process job in one pair of workers: the steps of
    STEP_CASES, each op of the worker's OPS on both meshes of
    COLLECTIVE_MESHES, the hybrid mesh's sums and the refusals. The
    reference's collectives run while the workers do."""
    _, tokens, targets = _inputs()
    arrays, params, jobs = _step_jobs(STEP_CASES)
    arrays.update(tokens=tokens, targets=targets, x=_x())
    rng = np.random.default_rng(7)
    for mesh_name, sizes in COLLECTIVE_MESHES.items():
        for op in worker.OPS:
            shape = _one_process(op, sizes, arrays["x"])[0].shape
            arrays[f"w/{mesh_name}/{op}"] = np.stack(np.split(
                rng.integers(-8, 9, shape).astype(np.float32), 8))
    cfg = {f.name: getattr(CFG, f.name)
           for f in dataclasses.fields(CFG) if f.name != "dtype"}
    jobs += [{"kind": "collectives", "name": mesh_name, "mesh": sizes,
              "ops": list(worker.OPS)}
             for mesh_name, sizes in COLLECTIVE_MESHES.items()]
    arrays.update(_pipe_inputs())
    jobs += [{"kind": "pipeline", "name": "pipe", "mesh": PIPE_MESH}]
    for op, shape in ATTN_SHAPES.items():
        arrays.update({f"attn_{op}/{t}": a
                       for t, a in zip("qkvw", _attn_inputs(shape))})
    jobs += [{"kind": "attention", "name": op, "op": op, "mesh": ATTN_MESH}
             for op in ATTN_SHAPES]
    jobs += [{"kind": "hybrid"},
             {"kind": "hybrid", "name": "hybrid_pp", "dcn": "pp",
              "cfg": cfg},
             {"kind": "mesh", "name": "mesh_tp_across",
              "mesh": dict(tp=PROCESSES * SHARDS_EACH)},
             {"kind": "refusals"}]
    workers = worker.start(jobs, tmp_path_factory.mktemp("dist"),
                           processes=PROCESSES, backend="gloo",
                           devices=["cpu"] * SHARDS_EACH, arrays=arrays,
                           timeout_s=WORKER_TIMEOUT_S)
    try:
        ref = {(mesh_name, op): _jax_collective(
                   op, sizes, arrays["x"],
                   np.concatenate(arrays[f"w/{mesh_name}/{op}"]))
               for mesh_name, sizes in COLLECTIVE_MESHES.items()
               for op in worker.OPS}
        ref["pipe"] = _jax_pipeline(arrays)
        for op in ATTN_SHAPES:
            ref[op] = _jax_attention(op, arrays)
    finally:
        outs = workers.join()
    merged = {}
    for out in outs:
        merged.update(out)
    return {"params": params, "tokens": tokens, "targets": targets,
            "arrays": arrays, "ref": ref, "outs": outs, "merged": merged}


@pytest.fixture(scope="module")
def four_processes(tmp_path_factory):
    """FOUR_STEP_CASES in four workers of 2 CPU shards each, over gloo:
    dp and pp both cross processes, or tp and sp both do."""
    _, tokens, targets = _inputs()
    arrays, params, jobs = _step_jobs(FOUR_STEP_CASES)
    arrays.update(tokens=tokens, targets=targets)
    outs = worker.launch(jobs, tmp_path_factory.mktemp("dist4"),
                         processes=FOUR_PROCESSES, backend="gloo",
                         devices=["cpu"] * FOUR_SHARDS_EACH, arrays=arrays,
                         timeout_s=WORKER_TIMEOUT_S)
    merged = {}
    for out in outs:
        merged.update(out)
    return {"params": params, "tokens": tokens, "targets": targets,
            "outs": outs, "merged": merged}


def _pipe_inputs():
    """The pipeline twin's inputs: each shard's weight [D, D], its
    microbatches [M, B, D] (only stage 0's are read) and the weights of
    sum(c * out), by the shard's flat index."""
    rng = np.random.default_rng(11)
    shape = (8, PIPE_M, PIPE_B, PIPE_D)
    return {"pipe/w": (rng.standard_normal((8, PIPE_D, PIPE_D)) * 0.4
                       ).astype(np.float32),
            "pipe/x": rng.standard_normal(shape).astype(np.float32),
            "pipe/c": rng.standard_normal(shape).astype(np.float32)}


def _jax_pipeline(arrays):
    """The reference's pipeline_spmd under shard_map on its 8-device
    mesh, every input and output cut one block a shard: (value,
    gradient of the weights, gradient of the microbatches) of
    sum(c * out)."""
    from ray_tpu.parallel.pipeline import pipeline_spmd

    spec = P(tuple(tmesh.AXES))
    run = jax.shard_map(
        lambda w, x: pipeline_spmd(lambda wj, a: jnp.tanh(a @ wj[0]), w,
                                   x[0], axis_name="pp")[None],
        mesh=_jmesh(**PIPE_MESH), in_specs=(spec, spec), out_specs=spec,
        check_vma=False)
    w, x, c = (jnp.asarray(arrays[f"pipe/{k}"]) for k in "wxc")
    val, vjp = jax.vjp(run, w, x)
    gw, gx = vjp(c)
    return np.asarray(val), np.asarray(gw), np.asarray(gx)


def _attn_inputs(shape):
    """q, k, v and the weights w of sum(w * out), [B, H, S, D] f32."""
    rng = np.random.default_rng(13)
    return [rng.standard_normal(shape).astype(np.float32) for _ in "qkvw"]


def _jax_attention(op, arrays):
    """The reference's ring attention or Ulysses under shard_map on its
    sp-8 mesh: (value, jax.grad of sum(w * value) for q, k and v)."""
    spec = P(None, None, "sp", None)
    fn = jpar.ring_attention if op == "ring" else jpar.ulysses_attention
    run = jax.shard_map(
        lambda q, k, v: fn(q, k, v, axis_name="sp", causal=True),
        mesh=_jmesh(**ATTN_MESH), in_specs=(spec,) * 3, out_specs=spec,
        check_vma=False)
    q, k, v, w = (jnp.asarray(arrays[f"attn_{op}/{t}"]) for t in "qkvw")
    val = np.asarray(jax.jit(run)(q, k, v))
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(run(q, k, v) * w),
                             argnums=(0, 1, 2)))(q, k, v)
    return val, [np.asarray(g) for g in grads]


def _reference_steps(sizes, opt, mb, params, tokens, targets, cfg=CFG):
    """The reference's steps, compiled afresh where sp > 1: a program
    whose sp and ep meet, loaded from JAX's persistent cache inside a
    pytest-xdist worker, aborts the worker (``_compiled_afresh``)."""
    step, _, _ = jm.make_spmd_train_step(cfg, _jmesh(**sizes), params,
                                         optimizer=opt, n_microbatches=mb)
    state, losses = opt.init(params), []
    with _compiled_afresh(sizes.get("sp", 1) > 1):
        for i in range(STEPS):
            params, state, loss = step(params, state,
                                       jnp.asarray(tokens[i]),
                                       jnp.asarray(targets[i]))
            losses.append(float(loss))
    return params, losses


def _check_steps(r, name, case, each):
    """Every process's losses against the reference's one-process step
    over the whole batch on the 8-device mesh, and every shard's every
    leaf after two steps against the reference's buffer on the device at
    the same mesh coordinates."""
    sizes, opt_name, mb = case[:3]
    cfg = _case_cfg(case)
    opt = optax.sgd(0.1) if opt_name == "sgd" else optax.adamw(LR_ADAM)
    params = r["params"]["params_moe" if cfg is MOE else "params"]
    p2, want = _reference_steps(sizes, opt, mb, params, r["tokens"],
                                r["targets"], cfg)
    atol = PARAM_ATOL if opt_name == "sgd" else ADAM_ATOL
    for p, out in enumerate(r["outs"]):
        np.testing.assert_allclose(out[f"{name}/losses"], want,
                                   rtol=LOSS_RTOL)
        assert out[f"{name}/local_indices"].tolist() == list(
            range(p * each, (p + 1) * each))
    jmesh = _jmesh(**sizes)
    seen = 0
    for path, arr in _flat(p2):
        by_device = {s.device: np.asarray(s.data)
                     for s in arr.addressable_shards}
        for j, dev in enumerate(jmesh.devices.flat):
            got = r["merged"][f"{name}/{j}/{path}"]
            want_leaf = by_device[dev]
            assert got.shape == want_leaf.shape, (path, j)
            err = float(np.abs(got - want_leaf).max())
            assert err <= atol, f"{path} on shard {j}: {err} > {atol}"
            seen += 1
    assert seen == 8 * len(_flat(p2))


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_two_process_step_matches_reference(eight_device_mesh,
                                            two_processes, name):
    """Two processes x 4 CPU shards, each passing the step only its rows
    of the global batch: both processes' losses equal the reference's
    one-process step over the whole batch on the 8-device mesh, and
    every shard's every leaf after two steps equals the reference's
    buffer on the device at the same mesh coordinates. dp crosses the
    processes (dp 2), or is split inside them too (dp 4); dp2-pp2-tp2
    keeps its pipeline inside each process, and pp2-tp4 puts one stage
    in each process, both of which feed the whole batch. fsdp2-tp4 cuts
    the batch over fsdp across the processes; tp2-sp4 puts the
    row-parallel sums across them (each process feeds the whole batch,
    sp cutting the sequence inside it); sp2-ep4, an MoE model, puts ring
    attention's K/V hops across them, MoE's dispatch staying inside;
    tp2-sp4-remat recomputes each layer, its tp sums across the
    processes, inside the backward."""
    _check_steps(two_processes, name, STEP_CASES[name], SHARDS_EACH)


@pytest.mark.parametrize("name", list(FOUR_STEP_CASES))
def test_four_process_step_matches_reference(eight_device_mesh,
                                             four_processes, name):
    """Four processes x 2 CPU shards, dp and pp both across processes:
    processes 0 and 1 hold dp block 0's two stages and feed its rows,
    processes 2 and 3 dp block 1's; or, on the MoE model, tp and sp both
    across processes (process 2 tp + sp, ep inside), all four feeding
    the whole batch; or pp and tp both across them (a stage's tp sums in
    its two processes alone, whose process groups the mesh's maker made
    in all four). The losses and every shard's every leaf equal the
    reference's, as for two processes."""
    _check_steps(four_processes, name, FOUR_STEP_CASES[name],
                 FOUR_SHARDS_EACH)


def test_pipeline_across_processes_matches_reference(eight_device_mesh,
                                                     two_processes):
    """pipeline_spmd on pp2-tp4, a stage in each process, M = 3: every
    shard's output and the gradients of sum(c * out) with respect to
    every shard's weight and microbatches equal the reference's
    pipeline_spmd under shard_map (f32: VAL_TOL and GRAD_TOL) and the
    one-process pipeline over 8 CPU shards."""
    r = two_processes
    val, gw, gx = r["ref"]["pipe"]
    got = {k: np.stack([r["merged"][f"pipe/{k}/{j}"] for j in range(8)])
           for k in ("out", "grad_w", "grad_x")}
    np.testing.assert_allclose(got["out"], val, atol=VAL_TOL, rtol=0)
    np.testing.assert_allclose(got["grad_w"], gw, atol=GRAD_TOL, rtol=0)
    np.testing.assert_allclose(got["grad_x"], gx, atol=GRAD_TOL, rtol=0)
    mesh = tmesh.make_mesh(tmesh.MeshConfig(**PIPE_MESH), devices=[CPU] * 8)
    a = r["arrays"]
    ws = [torch.tensor(w, requires_grad=True) for w in a["pipe/w"]]
    xs = [torch.tensor(x, requires_grad=True) for x in a["pipe/x"]]
    outs = tpar.pipeline_spmd(worker.pipeline_stage, ws, xs, mesh=mesh)
    sum(torch.sum(o * torch.from_numpy(c))
        for o, c in zip(outs, a["pipe/c"])).backward()
    np.testing.assert_allclose(
        got["out"], torch.stack(outs).detach().numpy(), atol=VAL_TOL, rtol=0)
    np.testing.assert_allclose(
        got["grad_w"], torch.stack([w.grad for w in ws]).numpy(),
        atol=GRAD_TOL, rtol=0)
    # Stage 1's microbatches are never read: no gradient reaches them.
    np.testing.assert_allclose(
        got["grad_x"], torch.stack([torch.zeros_like(x) if x.grad is None
                                    else x.grad for x in xs]).numpy(),
        atol=GRAD_TOL, rtol=0)


@pytest.mark.parametrize("op", list(worker.OPS))
@pytest.mark.parametrize("mesh_name", list(COLLECTIVE_MESHES))
def test_cross_process_collective(eight_device_mesh, two_processes,
                                  mesh_name, op):
    """Each op over this pair of processes, every shard's value and the
    gradient of sum(w * out) with respect to its input: equal to the
    one-process op over 8 virtual CPU shards, and to the shard_map'd lax
    op and its vjp (pmax's counterpart: the max of an all_gather). On
    dp4-tp2 each dp group holds two shards in each process."""
    sizes = COLLECTIVE_MESHES[mesh_name]
    r = two_processes
    val, grad = r["ref"][mesh_name, op]
    got_val = np.concatenate([r["merged"][f"{mesh_name}/{op}/out/{j}"]
                              for j in range(8)])
    got_grad = np.concatenate([r["merged"][f"{mesh_name}/{op}/grad/{j}"]
                               for j in range(8)])
    np.testing.assert_array_equal(got_val, val)
    np.testing.assert_array_equal(got_grad, grad)
    one_val, one_grad = _one_process(
        op, sizes, r["arrays"]["x"],
        np.concatenate(r["arrays"][f"w/{mesh_name}/{op}"]))
    np.testing.assert_array_equal(got_val, one_val)
    np.testing.assert_array_equal(got_grad, one_grad)


@pytest.mark.parametrize("op", list(ATTN_SHAPES))
def test_attention_across_processes_matches_reference(eight_device_mesh,
                                                      two_processes, op):
    """Ring attention and Ulysses on sp 8, four sequence blocks in each
    process: the ring's K/V hops and Ulysses' two all-to-alls cross the
    processes. Every shard's output and the gradients of sum(w * out)
    with respect to its q, k and v equal the reference's under shard_map
    and jax.grad (f32: VAL_TOL and GRAD_TOL), and the one-process op
    over 8 CPU shards."""
    r = two_processes
    val, grads = r["ref"][op]
    got = {k: np.concatenate([r["merged"][f"{op}/{k}/{j}"]
                              for j in range(8)], axis=2)
           for k in ("out", "grad_q", "grad_k", "grad_v")}
    np.testing.assert_allclose(got["out"], val, atol=VAL_TOL, rtol=0)
    for t, g in zip("qkv", grads):
        np.testing.assert_allclose(got[f"grad_{t}"], g, atol=GRAD_TOL,
                                   rtol=0)
    mesh = tmesh.make_mesh(tmesh.MeshConfig(**ATTN_MESH), devices=[CPU] * 8)
    q, k, v, w = (r["arrays"][f"attn_{op}/{t}"] for t in "qkvw")
    qs, ks, vs = ([torch.tensor(b, requires_grad=True)
                   for b in np.split(a, 8, axis=2)] for a in (q, k, v))
    fn = tpar.ring_attention if op == "ring" else tpar.ulysses_attention
    outs = fn(qs, ks, vs, mesh=mesh, axis_name="sp", causal=True)
    sum(torch.sum(o * torch.from_numpy(wj))
        for o, wj in zip(outs, np.split(w, 8, axis=2))).backward()
    np.testing.assert_allclose(
        got["out"], torch.cat([o.detach() for o in outs], dim=2).numpy(),
        atol=VAL_TOL, rtol=0)
    for t, ts in zip("qkv", (qs, ks, vs)):
        np.testing.assert_allclose(
            got[f"grad_{t}"], torch.cat([x.grad for x in ts], dim=2).numpy(),
            atol=GRAD_TOL, rtol=0)


def test_hybrid_mesh_across_processes(two_processes):
    """``make_hybrid_mesh(dcn dp 2, ici tp 4)`` in two processes: dp is
    the process axis, and a sum over each tier gives every shard the
    total."""
    r = two_processes
    x = r["arrays"]["x"]
    for out in r["outs"]:
        assert out["hybrid/axis_names"].tolist() == ["dp", "tp"]
        assert out["hybrid/processes"].tolist() == [[0] * 4, [1] * 4]
    total = sum(np.split(x, 8))
    for j in range(8):
        np.testing.assert_array_equal(r["merged"][f"hybrid/{j}"], total)


def test_pipeline_peer_death_fails_within_bound(tmp_path):
    """A process that dies mid-pipeline (process 1, at its first stage
    call) makes its peer fail, not hang: process 0's wait for the hop
    raises when the connection drops, well within WORKER_TIMEOUT_S."""
    job = {"kind": "pipeline", "name": "pipe", "mesh": PIPE_MESH,
           "die_in": 1}
    t0 = time.monotonic()
    workers = worker.start([job], tmp_path, processes=PROCESSES,
                           backend="gloo", devices=["cpu"] * SHARDS_EACH,
                           arrays=_pipe_inputs(), timeout_s=WORKER_TIMEOUT_S)
    with pytest.raises(AssertionError, match="worker exit codes") as said:
        workers.join()
    codes = [p.returncode for p in workers.procs]
    assert codes[1] == 3 and codes[0] not in (0, None), said.value
    assert time.monotonic() - t0 < WORKER_TIMEOUT_S / 2


def test_hybrid_pp_mesh_across_processes(two_processes):
    """``make_hybrid_mesh(dcn pp 2, ici tp 4)`` in two processes: pp is
    the process axis and a sum over each tier gives every shard the
    total; the training step on it still raises C.16's KeyError (the
    hybrid mesh drops the size-1 axes), as the reference's does."""
    r = two_processes
    total = sum(np.split(r["arrays"]["x"], 8))
    for out in r["outs"]:
        assert out["hybrid_pp/axis_names"].tolist() == ["pp", "tp"]
        assert out["hybrid_pp/processes"].tolist() == [[0] * 4, [1] * 4]
        assert str(out["hybrid_pp/step_raised"]).startswith("KeyError")
    for j in range(8):
        np.testing.assert_array_equal(r["merged"][f"hybrid_pp/{j}"], total)


# name -> what building the mesh raised in every process ("": nothing).
REFUSALS = {
    "mesh_tp_across": "",
    "hybrid_dcn_size": "ValueError: the DCN tier {'dp': 8} spans 8 "
                       "processes, have 2",
    "hybrid_tp_dcn": "ValueError: axis 'tp' must not cross DCN",
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_cross_process_refusals(two_processes, name):
    """A mesh whose tp crosses processes builds in every process, as the
    reference's ``make_mesh`` lays tp across hosts: tp 8, process-major,
    so shards 0-3 are process 0's and 4-7 process 1's. The hybrid mesh
    keeps the reference's refusals: a DCN tier that is not the processes,
    and an ICI axis on the DCN tier, raise in every process."""
    for p, out in enumerate(two_processes["outs"]):
        if name == "mesh_tp_across":
            assert out[f"{name}/processes"].reshape(-1).tolist() == \
                [0] * 4 + [1] * 4
            assert out[f"{name}/processes"].shape == (1, 1, 1, 8, 1, 1)
            assert out[f"{name}/local_indices"].tolist() == list(
                range(4 * p, 4 * p + 4))
            assert bool(out[f"{name}/spans_processes"])
            continue
        said = str(out[f"refusals/{name}"])
        assert said.startswith(REFUSALS[name]), said


def test_workers_import_no_jax(two_processes):
    """The workers joined as processes 0 and 1 of 2 (their address, size
    and rank from the RAY_TPU_* environment variables) and never
    imported JAX."""
    for p, out in enumerate(two_processes["outs"]):
        assert int(out["process_index"]) == p
        assert int(out["process_count"]) == PROCESSES
        assert not bool(out["jax_imported"])


def test_shard_host_local_refuses_rows_of_another_process():
    """``shard_host_local`` cuts this process's rows; a shard whose block
    lies in another process's rows raises (here: a mesh whose process 1
    holds the first dp block)."""
    mesh = tmesh.Mesh(np.array([CPU, CPU], dtype=object).reshape(2, 1),
                      ("dp", "tp"), np.array([[1], [0]]), process=0)
    with pytest.raises(ValueError, match="not among this process's rows"):
        shard_host_local(torch.zeros(2, 3), mesh, ("dp",))


# ------------------------------------- the order of the backward's exchanges
def _two_exchanges(monkeypatch, ordered):
    """Two all-reduces across processes, A then B in the forward, with
    ``dist.all_reduce`` recording the shape it is handed ([2] for A, [3]
    for B) instead of exchanging. B's consumers are made on a second
    thread, whose autograd sequence numbers start low, so the engine
    reaches A's backward first, as it would where a second device's
    thread finishes late. Returns the shapes the backward posted in
    order, and the gradients of both inputs."""
    posted = []
    monkeypatch.setattr(cops.dist, "all_reduce",
                        lambda t, op=None, group=None: posted.append(
                            tuple(t.shape)))
    x1 = torch.ones(2, requires_grad=True)
    x2 = torch.ones(3, requires_grad=True)
    with corder.backward_order():
        if ordered:
            a, = corder.ordered(cops._AllReduce, x1, None, "sum", None)
            b, = corder.ordered(cops._AllReduce, x2, None, "sum", None)
        else:
            a = cops._AllReduce.apply(x1, None, "sum", None, None)[0]
            b = cops._AllReduce.apply(x2, None, "sum", None, None)[0]
    box = {}
    later = threading.Thread(target=lambda: box.update(z=(b * 2).sum()))
    later.start()
    later.join()
    del posted[:]
    (a.sum() + box["z"]).backward()
    return posted, x1.grad, x2.grad


@pytest.mark.parametrize("ordered", [False, True])
def test_backward_exchanges_posted_in_one_order(monkeypatch, ordered):
    """Unchained, the engine posts A's backward before B's here, while a
    process whose B is reached first would post B first: the hazard of
    several devices in a process. Chained (``order.ordered``, what every
    exchange across processes does), B's backward hands A's token a zero
    cotangent, so A is not ready before B has run: the backward posts
    B, then A, the reverse of the forward, whatever order autograd
    reaches them in. The gradients are the same either way."""
    posted, g1, g2 = _two_exchanges(monkeypatch, ordered)
    assert posted == ([(3,), (2,)] if ordered else [(2,), (3,)])
    np.testing.assert_array_equal(g1.numpy(), np.ones(2))
    np.testing.assert_array_equal(g2.numpy(), np.full(3, 2.0))


def test_backward_order_chain_lifetime(monkeypatch):
    """A chain lives only in a scope: outside one an exchange joins none
    and leaves nothing behind; ``backward_order`` links the block's
    exchanges, gives a nested block a chain of its own and drops its
    chain when the block ends; ``in_order`` (every op of
    ``collective/ops.py``) joins the caller's chain, or opens one for the
    call; under no_grad or on inputs that need no gradient an exchange
    joins none. Two graphs made by calls outside any scope are not
    linked: each backward posts its own graph's exchanges only."""
    posted = []
    monkeypatch.setattr(cops.dist, "all_reduce",
                        lambda t, op=None, group=None: posted.append(
                            tuple(t.shape)))
    monkeypatch.setattr(corder, "_local", threading.local())

    def exchange(n=2, requires_grad=True):
        x = torch.ones(n, requires_grad=requires_grad)
        return corder.ordered(cops._AllReduce, x, None, "sum", None)[0]

    @corder.in_order
    def call(n=2):
        return exchange(n), corder._local.chain

    exchange()
    assert getattr(corder._local, "chain", None) is None
    with corder.backward_order():
        outer = corder._local.chain
        exchange()
        first = outer.last
        assert first is not None
        _, joined = call()
        assert joined is outer and outer.last is not first
        with corder.backward_order():
            inner = corder._local.chain
            exchange()
            assert inner is not outer and inner.last is not None
        assert corder._local.chain is outer
        last = outer.last
        with torch.no_grad():
            exchange()
        exchange(requires_grad=False)
        assert outer.last is last
    assert corder._local.chain is None
    a, chain_a = call(2)
    b, chain_b = call(3)
    assert chain_a is not chain_b and corder._local.chain is None
    del posted[:]
    b.sum().backward()
    assert posted == [(3,)]
    a.sum().backward()
    assert posted == [(3,), (2,)]


@pytest.mark.parametrize("sizes,owners", [
    ({"tp": 2, "sp": 2}, [0, 0, 1, 1]),
    ({"dp": 2, "fsdp": 2}, [0, 0, 1, 1]),
])
def test_step_refuses_remat_across_processes_from_several_devices(
        sizes, owners):
    """``cfg.remat`` on a mesh that spans processes, where this process
    drives two distinct devices, raises before any exchange: the
    recompute's exchanges run inside the backward, outside any chain.
    With one device a process the step takes ``remat``
    (``tp2-sp4-remat-sgd`` above, on CPU shards)."""
    shape = tuple(sizes.get(a, 1) for a in tmesh.AXES)
    devices = [torch.device("cuda", i % 2) for i in range(4)]
    mesh = tmesh.Mesh(np.array(devices, dtype=object).reshape(shape),
                      tmesh.AXES, np.array(owners).reshape(shape), process=0)
    cfg = tm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                               n_heads=2, n_kv_heads=2, d_ff=64,
                               max_seq_len=16, dtype=torch.float32,
                               remat=True)
    params = tm.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="remat on a mesh that spans "
                                         "processes needs one device"):
        tm.make_spmd_train_step(cfg, mesh, params)
