"""``chip_smoke.py`` phase 20 (a)'s step through a port head on the card:
the flagship's bf16 ``make_train_step`` on ``cuda:0`` in the named actor
``flagship_trainer`` of this driver, stepped by a peer driver (a
subprocess that sees no card) whose batches cross by ref through the
head. The losses equal the same steps called directly, bit for bit, with
the forward, dQ and dK/dV launched ``n_layers`` times a step each on the
tensor cores and no plain route.

Marked ``cuda``; it skips without a card. The file imports no JAX:
``python -m pytest tests/test_torch_cluster_card.py -m cuda --noconftest``.
"""

import pytest
import torch

import chip_smoke
import ray_tpu_torch
from ray_tpu_torch.models import TransformerConfig

STEPS = 3
T = 120.0


@pytest.fixture
def card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flagship's step on cuda:0")
    proc, address, _ = chip_smoke._start_head(str(tmp_path / "state.log"))
    try:
        yield torch.device("cuda", 0), address
    finally:
        proc.kill()
        proc.wait(timeout=10)


@pytest.mark.cuda
def test_flagship_step_relayed_through_the_head(card):
    dev, address = card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = TransformerConfig()
    direct, _ = chip_smoke._cluster_direct(cfg, dev, STEPS)
    fa = chip_smoke._flash_module()
    ray_tpu_torch.shutdown()
    w = ray_tpu_torch.init(num_cpus=2, address=address)
    peer = None
    try:
        trainer = ray_tpu_torch.remote(chip_smoke._ClusterTrainer).options(
            name=chip_smoke.CLUSTER_ACTOR).remote(
            cfg, dev, chip_smoke.CLUSTER_TOPIC)
        ray_tpu_torch.get(trainer.ping.remote(), timeout=T)
        chip_smoke._zero_counts()
        plain = fa.plain_routes
        key = "test/cluster_card/peer"
        peer = chip_smoke._start_peer({
            "address": address, "actor": chip_smoke.CLUSTER_ACTOR,
            "topic": chip_smoke.CLUSTER_TOPIC, "key": key, "steps": STEPS,
            "relay_calls": 0, "vocab": cfg.vocab_size,
            "batch": chip_smoke.TRAIN_BATCH,
            "length": chip_smoke.TRAIN_LEN + 1, "pull_bytes": 0,
            "poll_s": T, "hold_s": T})
        got = chip_smoke._wait_json(w, key, peer, 2 * T)
        counts = chip_smoke._counts()
        w.kv_put((key + "/done").encode(), b"1")
        peer.wait(timeout=T)
    finally:
        if peer is not None and peer.poll() is None:
            peer.kill()
            peer.wait(timeout=10)
        ray_tpu_torch.shutdown()
    assert "error" not in got, got.get("error")
    assert got["losses"] == direct
    assert counts == chip_smoke._want_counts(
        "wgmma", STEPS * cfg.n_layers, STEPS * cfg.n_layers)
    assert fa.plain_routes == plain
    assert not got["cuda_initialized"] and not got["cuda_available"]
