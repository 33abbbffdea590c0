"""``chip_smoke.py`` phase 21 (a) at a small size on the CPU: the port's
train step (2 layers, d_model 64, f32, ``device="cpu"``, parameters from
the reference's ``init_params`` through ``params_from_jax``, passed to
the actor's constructor) in the actor ``chip_smoke._NodeTrainer``, which
the router places on a port node daemon by a custom resource; each batch
is made by a remote task (``chip_smoke._node_feed``) on a second daemon
and passed to the step by ref, so the trainer's node pulls it from the
feed node. Its losses are held against the reference's one-device step
(``make_spmd_train_step`` on a one-device mesh with ``optax.adamw``, as
``tests/test_torch_cluster_train.py`` runs it) on the same batches, at
``tests/test_torch_train.py``'s f32 tolerance, ``LOSS_RTOL`` = 1e-6.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import ray_tpu.models as jm
import ray_tpu_torch
from ray_tpu.models import transformer as jt
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu_torch import models as tm
from ray_tpu_torch.models import transformer as tt

CFG = jm.TransformerConfig(vocab_size=128, d_model=64, n_layers=2,
                           n_heads=4, n_kv_heads=4, d_ff=128,
                           dtype=jnp.float32)
B, S, STEPS = 2, 32, 4
LR = 3e-4
# The f32 loss tolerance of tests/test_torch_train.py: the same math in
# another summation order.
LOSS_RTOL = 1e-6
T = 60.0


def _port_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields.update(dtype=torch.float32)
    return tt.TransformerConfig(**fields)


def _reference_losses(jp, n):
    import optax

    mesh = make_mesh(MeshConfig(dp=1), devices=jax.devices("cpu")[:1])
    jstep, pspec, _ = jt.make_spmd_train_step(
        CFG, mesh, jp, optimizer=optax.adamw(LR))
    jparams = jt.shard_params_for_step(jp, mesh, pspec)
    opt_state = optax.adamw(LR).init(jparams)
    losses = []
    for i in range(n):
        t = chip_smoke._node_batch(i, CFG.vocab_size, B, S + 1).numpy()
        jparams, opt_state, loss = jstep(
            jparams, opt_state, jnp.asarray(t[:, :-1].astype(np.int32)),
            jnp.asarray(t[:, 1:].astype(np.int32)))
        losses.append(float(loss))
    return losses


@pytest.fixture
def cluster(tmp_path):
    """A port head, the trainer's node ``{"card_a": 1}`` and a feed node
    ``{"feed": 1}`` (thread plane, no card)."""
    env = chip_smoke._cluster_env(RAY_TPU_HEAD_CLIENT_TIMEOUT_S="3.0",
                                  CUDA_VISIBLE_DEVICES="")
    head, address, _ = chip_smoke._start_head(str(tmp_path / "state.log"),
                                              env=env)
    procs = {}
    try:
        procs, _, missing = chip_smoke._start_daemons(address, [
            ("A", 1, {"card_a": 1}, "thread"),
            ("F1", 1, {"feed": 1, "feed_1": 1}, "thread")],
            lambda name: env)
        assert not missing, missing
        yield address, procs
    finally:
        for p in [head, *procs.values()]:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def test_placed_trainer_fed_by_remote_tasks_matches_reference(cluster):
    address, procs = cluster
    jp = jm.init_params(CFG, jax.random.PRNGKey(0))
    params = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                _port_cfg(CFG), device="cpu")
    ray_tpu_torch.shutdown()
    w = ray_tpu_torch.init(num_cpus=0, num_gpus=0, address=address)
    try:
        trainer = ray_tpu_torch.remote(chip_smoke._NodeTrainer).options(
            name=chip_smoke.NODE_ACTOR, resources={"card_a": 1}).remote(
                _port_cfg(CFG), "cpu", params)
        feed = ray_tpu_torch.remote(chip_smoke._node_feed).options(
            resources={"feed": 1})
        losses = [ray_tpu_torch.get(trainer.step.remote(
            feed.remote(i, CFG.vocab_size, B, S + 1)), timeout=T)
            for i in range(STEPS)]
        rep = ray_tpu_torch.get(trainer.report.remote(), timeout=T)
        rec = w.head_client.actor_locate(trainer._actor_id.binary())
        card = next(n for n in w.head_client.node_list()
                    if "card_a" in (n["resources"] or {}))
        relayed = w.remote_router.relayed_pushes
    finally:
        ray_tpu_torch.shutdown()
    assert rec is not None and rec["node"] == card["client_id"]
    assert rep["pid"] == procs["A"].pid and rep["device"] == "cpu"
    assert set(rep["feed_pids"]) == {procs["F1"].pid}
    assert os.getpid() not in rep["feed_pids"]
    assert relayed == 0
    ref = _reference_losses(jp, STEPS)
    np.testing.assert_allclose(losses, ref, rtol=LOSS_RTOL)
