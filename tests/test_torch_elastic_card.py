"""``chip_smoke.py`` phase 22 (a)'s autoscaled step on the card: a job
submitted with ``JobSubmissionClient`` runs ``chip_smoke_job.main``,
which creates the trainer ``chip_smoke_job.ElasticTrainer`` (built on
its node as ``chip_smoke._ElasticTrainer``) with ``num_gpus=1``; no node can place it, so a ``ClusterAutoscaler`` in this
process launches a ``card`` node (``{"CPU": 2, "GPU": 1}``, a daemon that
sees the card) and a ``feed`` node (the card hidden) for the job's feed
tasks, which run under a ``runtime_env``. The flagship's bf16 losses
equal the same steps called directly in this process, bit for bit, with
the forward, dQ and dK/dV launched ``n_layers`` times a step each on the
tensor cores inside the launched daemon's process (counted there,
returned by the actor) and no plain route.

Marked ``cuda``; it skips without a card. The file imports no JAX:
``python -m pytest tests/test_torch_elastic_card.py -m cuda --noconftest``.
"""

import pytest
import torch

import chip_smoke
import ray_tpu_torch
from ray_tpu_torch.models import TransformerConfig

STEPS = 3
T = 120.0


@pytest.fixture
def cluster(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flagship's step on cuda:0")
    from ray_tpu_torch.autoscaler import (
        ClusterAutoscaler,
        LocalSubprocessProvider,
        NodeTypeConfig,
    )

    env = chip_smoke._cluster_env(RAY_TPU_HEAD_CLIENT_TIMEOUT_S="3.0")
    head, address, _ = chip_smoke._start_head(str(tmp_path / "state.log"),
                                              env=env)
    scaler = None
    try:
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(num_cpus=0, num_gpus=0, address=address)
        scaler = ClusterAutoscaler(
            address,
            [NodeTypeConfig("card", {"CPU": 2, "GPU": 1}, 0, 1),
             NodeTypeConfig("feed", {"CPU": 2, "feed": 1}, 0, 1)],
            LocalSubprocessProvider(address, worker_mode="thread", env=env),
            idle_timeout_s=60.0, update_interval_s=0.5)
        yield torch.device("cuda", 0), address, scaler
    finally:
        if scaler is not None:
            scaler.shutdown()
        ray_tpu_torch.shutdown()
        if head.poll() is None:
            head.kill()
            head.wait(timeout=10)


@pytest.mark.cuda
def test_flagship_step_in_a_submitted_job_on_an_autoscaled_card_node(
        cluster):
    from ray_tpu_torch.job_submission import JobSubmissionClient

    dev, address, scaler = cluster
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig()
    client = JobSubmissionClient()
    spec = {"address": address, "actor": "elastic_card_test_trainer",
            "cfg": chip_smoke._cfg_spec(cfg), "dev": str(dev),
            "tag": "card", "steps": STEPS, "batch": chip_smoke.TRAIN_BATCH,
            "length": chip_smoke.TRAIN_LEN + 1, "poll_s": T}
    job, _ = chip_smoke._elastic_submit(client, spec, "card")
    try:
        direct, _ = chip_smoke._node_direct(cfg, dev, STEPS,
                                            chip_smoke._elastic_batch)
        got, _ = chip_smoke._elastic_line(client, job, 2 * T, done=True)
    finally:
        client.stop_job(job)
    assert "error" not in got, got["error"]
    rep = got["report"]
    with scaler._lock:
        pids = {m.type_name: m.handle["proc"].pid for m in scaler._managed}
    assert rep["pid"] == pids["card"] and rep["device"] == "cuda:0"
    assert set(rep["feed_pids"]) == {pids["feed"]}
    assert rep["feed_tags"] == [f"card-{i}" for i in range(STEPS)]
    assert got["losses"] == direct
    assert rep["counts"] == chip_smoke._want_counts(
        "wgmma", STEPS * cfg.n_layers, STEPS * cfg.n_layers)
    assert rep["plain_routes"] == 0
