"""``chip_smoke.py`` phase 21 (a)'s placed step on the card: the
flagship's bf16 ``make_train_step`` on ``cuda:0`` in the actor
``chip_smoke._NodeTrainer`` (``num_gpus=1``), which the router places on
a port node daemon that owns the card (``--worker-mode thread``), fed by
remote tasks on a feed node that sees no card. The losses equal the same
steps called directly in this process, bit for bit, with the forward, dQ
and dK/dV launched ``n_layers`` times a step each on the tensor cores
inside the daemon's process (counted there, returned by the actor) and
no plain route.

Marked ``cuda``; it skips without a card. The file imports no JAX:
``python -m pytest tests/test_torch_node_card.py -m cuda --noconftest``.
"""

import pytest
import torch

import chip_smoke
import ray_tpu_torch
from ray_tpu_torch.models import TransformerConfig

STEPS = 3
T = 120.0


@pytest.fixture
def nodes(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flagship's step on cuda:0")
    env = chip_smoke._cluster_env(RAY_TPU_HEAD_CLIENT_TIMEOUT_S="3.0")
    head, address, _ = chip_smoke._start_head(str(tmp_path / "state.log"),
                                              env=env)
    procs = {}
    try:
        procs, _, missing = chip_smoke._start_daemons(address, [
            ("A", 2, {"card_a": 1}, "thread"),
            ("F1", 2, {"feed": 1, "feed_1": 1}, "process")],
            lambda name: dict(env, CUDA_VISIBLE_DEVICES="")
            if name == "F1" else env)
        assert not missing, missing
        yield torch.device("cuda", 0), address, procs
    finally:
        for p in [head, *procs.values()]:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


@pytest.mark.cuda
def test_flagship_step_in_an_actor_placed_on_a_card_node(nodes):
    dev, address, procs = nodes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig()
    direct, _ = chip_smoke._node_direct(cfg, dev, STEPS)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=0, num_gpus=0, address=address)
    try:
        trainer = ray_tpu_torch.remote(chip_smoke._NodeTrainer).options(
            num_gpus=1).remote(cfg, str(dev))
        ray_tpu_torch.get(trainer.reset.remote(), timeout=T)
        feed = ray_tpu_torch.remote(chip_smoke._node_feed).options(
            resources={"feed": 1})
        losses = [ray_tpu_torch.get(trainer.step.remote(feed.remote(
            i, cfg.vocab_size, chip_smoke.TRAIN_BATCH,
            chip_smoke.TRAIN_LEN + 1)), timeout=T) for i in range(STEPS)]
        rep = ray_tpu_torch.get(trainer.report.remote(), timeout=T)
    finally:
        ray_tpu_torch.shutdown()
    assert rep["pid"] == procs["A"].pid and rep["device"] == "cuda:0"
    assert losses == direct
    assert rep["counts"] == chip_smoke._want_counts(
        "wgmma", STEPS * cfg.n_layers, STEPS * cfg.n_layers)
    assert rep["plain_routes"] == 0
