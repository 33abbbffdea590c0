"""``chip_smoke.py`` phase 20 (a) at a small size on the CPU: the port's
train step (2 layers, d_model 64, f32, ``device="cpu"``, parameters
from the reference's ``init_params`` through ``params_from_jax``) hosted
as the named actor ``flagship_trainer`` in this process, which attaches
to a port head; a port peer driver (a subprocess) puts and announces
seeded batches and calls the actor by name through the head, each batch
passed by ref and pulled back through the head. Its losses are held
against the reference's step (``make_spmd_train_step`` on a one-device
mesh with ``optax.adamw``, the reference's one-device training step) on
the same batches, at ``tests/test_torch_train.py``'s f32 tolerance,
``LOSS_RTOL`` = 1e-6; the losses the actor published on the topic reach
the peer in order, and the peer never sees a card.
"""

import dataclasses

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
        t = chip_smoke._cluster_batch(i, CFG.vocab_size, B, S + 1).numpy()
        jparams, opt_state, loss = jstep(
            jparams, opt_state, jnp.asarray(t[:, :-1].astype(np.int32)),
            jnp.asarray(t[:, 1:].astype(np.int32)))
        losses.append(float(loss))
    return losses


@pytest.fixture
def head(tmp_path):
    proc, address, _ = chip_smoke._start_head(str(tmp_path / "state.log"))
    try:
        yield address
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_named_trainer_stepped_by_a_peer_driver_matches_reference(head):
    jp = jm.init_params(CFG, jax.random.PRNGKey(0))
    params = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                _port_cfg(CFG), device="cpu")
    ray_tpu_torch.shutdown()
    w = ray_tpu_torch.init(num_cpus=2, address=head)
    peer = None
    try:
        trainer = ray_tpu_torch.remote(chip_smoke._ClusterTrainer).options(
            name=chip_smoke.CLUSTER_ACTOR).remote(
            _port_cfg(CFG), "cpu", chip_smoke.CLUSTER_TOPIC, params)
        assert ray_tpu_torch.get(trainer.ping.remote(), timeout=T) == 0
        key = "test/cluster/peer"
        peer = chip_smoke._start_peer({
            "address": head, "actor": chip_smoke.CLUSTER_ACTOR,
            "topic": chip_smoke.CLUSTER_TOPIC, "key": key, "steps": STEPS,
            "relay_calls": 3, "vocab": CFG.vocab_size, "batch": B,
            "length": S + 1, "pull_bytes": 1 << 20, "poll_s": T,
            "hold_s": T})
        got = chip_smoke._wait_json(w, key, peer, 2 * T)
        assert "error" not in got, got.get("error")
        # The 1 MiB object the peer announced pulls back equal.
        from ray_tpu_torch._private.ids import ObjectID
        from ray_tpu_torch._private.worker import ObjectRef

        big = ray_tpu_torch.get(
            ObjectRef(ObjectID.from_hex(got["big_oid"])), timeout=T)
        assert big.nbytes == 1 << 20
        assert int(big.sum(dtype=np.int64)) == got["big_sum"]
        w.kv_put((key + "/done").encode(), b"1")
        assert peer.wait(timeout=T) == 0
    finally:
        if peer is not None and peer.poll() is None:
            peer.kill()
            peer.wait(timeout=10)
        ray_tpu_torch.shutdown()
    assert got["handle"] == "CrossDriverActorHandle"
    assert got["msgs"] == [[i, loss] for i, loss in enumerate(got["losses"])]
    assert not got["cuda_initialized"] and not got["cuda_available"]
    assert got["visible"] == ""
    want = _reference_losses(jp, STEPS)
    np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL)
