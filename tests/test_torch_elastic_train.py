"""``chip_smoke.py`` phase 22 (a) at a small size on the CPU: a job that
``JobSubmissionClient`` submits runs ``chip_smoke_job.main``, which
creates the trainer ``chip_smoke_job.ElasticTrainer`` (the port's train
step, 2 layers, d_model 64, f32, ``device="cpu"``, parameters from the
reference's ``init_params`` through ``params_from_jax``) on a node that
asks for a custom ``card`` resource. No node offers it, so a
``ClusterAutoscaler`` in this process launches a ``card`` node, and a
``feed`` node for the job's feed tasks (``chip_smoke._elastic_feed``,
under ``runtime_env={"env_vars": {"FEED_TAG": ...}}``), whose refs go
straight to the trainer. Its losses are held against the reference's
one-device step (``make_spmd_train_step`` on a one-device mesh with
``optax.adamw``) on the same batches, at ``tests/test_torch_train.py``'s
f32 tolerance, ``LOSS_RTOL`` = 1e-6.
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
        t = chip_smoke._elastic_batch(i, CFG.vocab_size, B, S + 1).numpy()
        jparams, opt_state, loss = jstep(
            jparams, opt_state, jnp.asarray(t[:, :-1].astype(np.int32)),
            jnp.asarray(t[:, 1:].astype(np.int32)))
        losses.append(float(loss))
    return losses


@pytest.fixture
def autoscaled(tmp_path):
    """A port head, this driver attached with no CPU, and an autoscaler
    of a ``card`` type (a custom resource) and a ``feed`` type, neither
    launched yet."""
    from ray_tpu_torch.autoscaler import (
        ClusterAutoscaler,
        LocalSubprocessProvider,
        NodeTypeConfig,
    )

    env = chip_smoke._cluster_env(RAY_TPU_HEAD_CLIENT_TIMEOUT_S="3.0",
                                  CUDA_VISIBLE_DEVICES="")
    head, address, _ = chip_smoke._start_head(str(tmp_path / "state.log"),
                                              env=env)
    scaler = None
    try:
        ray_tpu_torch.shutdown()
        w = ray_tpu_torch.init(num_cpus=0, num_gpus=0, address=address)
        scaler = ClusterAutoscaler(
            address,
            [NodeTypeConfig("card", {"CPU": 2, "card": 1}, 0, 1),
             NodeTypeConfig("feed", {"CPU": 2, "feed": 1}, 0, 1)],
            LocalSubprocessProvider(address, worker_mode="thread", env=env),
            idle_timeout_s=60.0, update_interval_s=0.5)
        yield address, w, scaler
    finally:
        if scaler is not None:
            scaler.shutdown()
        ray_tpu_torch.shutdown()
        if head.poll() is None:
            head.kill()
            head.wait(timeout=10)


def test_submitted_job_trains_on_autoscaled_nodes_matches_reference(
        autoscaled, tmp_path):
    from ray_tpu_torch.job_submission import JobStatus, JobSubmissionClient

    address, w, scaler = autoscaled
    members_at_start = [n for n in w.head_client.node_list()
                        if n.get("alive")]
    jp = jm.init_params(CFG, jax.random.PRNGKey(0))
    params = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                _port_cfg(CFG), device="cpu")
    path = str(tmp_path / "params.pt")
    torch.save(params, path)
    spec = {"address": address, "actor": chip_smoke.ELASTIC_ACTOR,
            "cfg": chip_smoke._cfg_spec(_port_cfg(CFG)), "dev": "cpu",
            "card": "card", "params": path, "tag": "cpu", "steps": STEPS,
            "batch": B, "length": S + 1, "poll_s": T}
    client = JobSubmissionClient()
    job, _ = chip_smoke._elastic_submit(client, spec, "cpu-job")
    try:
        got, status = chip_smoke._elastic_line(client, job, 2 * T,
                                               done=True)
    finally:
        client.stop_job(job)
    assert "error" not in got, got["error"]
    summary = scaler.summary()
    with scaler._lock:
        pids = {m.type_name: m.handle["proc"].pid for m in scaler._managed}
    rep = got["report"]
    assert members_at_start == []
    assert status == JobStatus.SUCCEEDED
    assert sorted(summary["launched"]) == ["card", "feed"]
    assert summary["launch_failures"] == 0
    assert rep["pid"] == pids["card"] and rep["device"] == "cpu"
    assert set(rep["feed_pids"]) == {pids["feed"]}
    assert not {os.getpid(), got["pid"]} & set(rep["feed_pids"])
    assert rep["feed_tags"] == [f"cpu-{i}" for i in range(STEPS)]
    assert got["job_tag"] == "cpu-job"
    np.testing.assert_allclose(got["losses"], _reference_losses(jp, STEPS),
                               rtol=LOSS_RTOL)
