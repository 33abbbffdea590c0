"""The port's sharded paths across distinct CUDA cards: the collectives'
peer copies, the compiled DAG sharded over a mesh of real devices (run
eagerly: one CUDA graph cannot span devices), the tensor-parallel
engine over the visible cards, and one step of the manual multi-axis
training step at dp 2 x tp 2 over four cards.

Every test is marked ``cuda`` and skips unless at least two cards are
visible; each holds the multi-card result against the same computation
on one card. This file imports no JAX, so it runs on a machine that has
only PyTorch: ``python -m pytest tests/test_torch_multi_gpu.py -m cuda
--noconftest`` (``tests/conftest.py`` pins JAX to the CPU).
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch import collective
from ray_tpu_torch.dag import InputNode, reduce_tree
from ray_tpu_torch.llm import EngineConfig, InferenceEngine
from ray_tpu_torch.models import (
    TransformerConfig,
    init_params,
    make_spmd_train_step,
)
from ray_tpu_torch.parallel import MeshConfig, make_mesh
from ray_tpu_torch.parallel.mesh import VIRTUAL_DEVICES_ENV
from ray_tpu_torch.remote_function import remote


@pytest.fixture
def cards(monkeypatch):
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip(f"needs at least two CUDA cards, {n} visible")
    monkeypatch.delenv(VIRTUAL_DEVICES_ENV, raising=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.cuda
def test_collectives_across_cards(cards):
    mesh = make_mesh(devices=cards)            # dp = every card
    n = len(cards)
    rng = np.random.default_rng(0)
    host = [rng.integers(-8, 9, (4, 6)).astype(np.float32) for _ in cards]
    xs = [torch.from_numpy(h).to(d) for h, d in zip(host, cards)]
    total = sum(host)
    for got, d in zip(collective.allreduce(xs, mesh, "dp"), cards):
        assert got.device == d
        np.testing.assert_array_equal(got.cpu().numpy(), total)
    for got, d in zip(collective.allgather(xs, mesh, "dp"), cards):
        assert got.device == d
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      np.concatenate(host))
    shifted = collective.permute(xs, mesh, "dp",
                                 [(i, (i + 1) % n) for i in range(n)])
    for j, got in enumerate(shifted):
        assert got.device == cards[j]
        np.testing.assert_array_equal(got.cpu().numpy(), host[j - 1])


@remote
def _inc(x):
    return x + 1.0


@remote
def _add(a, b):
    return a + b


@pytest.mark.cuda
@pytest.mark.parametrize("dynamic", [False, True])
def test_sharded_dag_across_cards_equals_one_card(cards, dynamic):
    with InputNode() as inp:
        leaf = reduce_tree(_add, [_inc.bind(inp) for _ in range(64)],
                           arity=2)
    x = np.arange(4, dtype=np.float32)
    one = leaf.experimental_compile(backend="torch", payload_shape=(4,),
                                    dynamic=dynamic, device="cuda:0")
    sharded = leaf.experimental_compile(
        backend="torch", payload_shape=(4,), dynamic=dynamic,
        mesh=make_mesh(devices=cards))
    assert sharded.num_shards == len(cards)
    assert {t.device for t in sharded.shards()} == set(cards)
    want = one.execute(x).get()
    for _ in range(2):          # eager every time: no graph across cards
        np.testing.assert_array_equal(sharded.execute(x).get(), want)
    assert sharded.graph_replays == 0
    np.testing.assert_array_equal(want, (x + 1) * 64)


@pytest.mark.cuda
def test_tp_engine_across_cards_equals_one_card(cards):
    tp = 1 << (len(cards).bit_length() - 1)       # 2 or 4 of the cards
    cfg = TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                            n_heads=8, n_kv_heads=4, d_ff=512,
                            max_seq_len=512, dtype=torch.float32)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 40, 130, 17)]
    streams = {}
    for size in (1, tp):
        engine = InferenceEngine(EngineConfig(
            model=cfg, num_blocks=64, block_size=16, tp_size=size,
            device="cuda"))
        try:
            if size > 1:
                assert list(engine.mesh.devices.flat) == cards[:size]
                assert [p["lm_head"].device for p in engine.params] == \
                    cards[:size]
            streams[size] = [list(engine.generate(p, max_new_tokens=12))
                             for p in prompts]
        finally:
            engine.shutdown()
    assert streams[tp] == streams[1]


def _flat_cpu(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _flat_cpu(sub, f"{prefix}{name}.").items()}
    return {prefix[:-1]: tree.detach().cpu()}


@pytest.mark.cuda
def test_spmd_step_across_cards_equals_virtual_shards(cards):
    """One f32 SGD step of make_spmd_train_step on dp 2 x tp 2 over four
    cards against the same mesh over four virtual shards of the first
    card: the same kernels and the same sums in the same order, only the
    placement differs, so the loss and every shard's every leaf agree to
    f32 rounding (rtol 1e-5, atol 1e-7)."""
    if len(cards) < 4:
        pytest.skip(f"needs four CUDA cards, {len(cards)} visible")
    cfg = TransformerConfig(vocab_size=512, d_model=256, n_layers=2,
                            n_heads=4, n_kv_heads=4, d_ff=512,
                            dtype=torch.float32)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 129)))
    runs = {}
    for name, devices in (("cards", cards[:4]), ("virtual", [cards[0]] * 4)):
        mesh = make_mesh(MeshConfig(dp=2, tp=2), devices=devices)
        step, _, shards = make_spmd_train_step(
            cfg, mesh, init_params(cfg, 0, device=devices[0]),
            optimizer=lambda ls: torch.optim.SGD(ls, lr=0.1),
            n_microbatches=1)
        loss = step(tokens[:, :-1], tokens[:, 1:]).item()
        if name == "cards":
            assert [s["lm_head"].device for s in shards] == cards[:4]
        runs[name] = (loss, [_flat_cpu(s) for s in shards])
    (loss_c, leaves_c), (loss_v, leaves_v) = runs["cards"], runs["virtual"]
    assert np.isfinite(loss_c)
    assert abs(loss_c - loss_v) <= 1e-5 * abs(loss_v)
    for a, b in zip(leaves_c, leaves_v):
        for k in b:
            torch.testing.assert_close(a[k], b[k], rtol=1e-5, atol=1e-7)
