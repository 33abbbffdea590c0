"""The port's sharded paths across distinct CUDA cards: the collectives'
peer copies, the compiled DAG sharded over a mesh of real devices (run
eagerly: one CUDA graph cannot span devices), the tensor-parallel
engine over the visible cards, and one step of the manual multi-axis
training step at dp 2 x tp 2 over four cards. Across processes over
NCCL (``parallel.distributed``, workers of
``torch_distributed_worker.py``): the flagship's step and the
collectives with four processes of one card each (dp 4, dp 2 x pp 2
with the pipeline's stages in different processes, and tp 4 with the
row-parallel sums across them) and with two processes of two cards each
(dp 2 x tp 2, and tp 2 x sp 2 with tp across the processes and autograd
through the exchanges across them from a process of two cards), against
one process over the same four cards; and
two ``GPU: 2`` nodes of the autoscaler's provider on four cards.

Every test is marked ``cuda`` and skips unless at least two cards are
visible; each holds the multi-card result against the same computation
on one card. This file imports no JAX, so it runs on a machine that has
only PyTorch: ``python -m pytest tests/test_torch_multi_gpu.py -m cuda
--noconftest`` (``tests/conftest.py`` pins JAX to the CPU).
"""

import dataclasses

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

import torch_distributed_worker as worker


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


# ------------------------------------------------- across processes, NCCL
NCCL_STEPS, NCCL_BATCH, NCCL_LEN = 2, 4, 1024
NCCL_TIMEOUT_S = 600.0
LAYOUTS = {"4x1": (4, 1, dict(dp=4)), "2x2": (2, 2, dict(dp=2, tp=2)),
           "pp2x2": (4, 1, dict(dp=2, pp=2)),
           "tp4x1": (4, 1, dict(tp=4)), "tp2x2": (2, 2, dict(tp=2, sp=2))}
# The step's microbatches: the pipeline's where pp > 1 (both sides alike).
MICROBATCHES = {"4x1": 1, "2x2": 1, "pp2x2": 2, "tp4x1": 1, "tp2x2": 1}


def _flagship_f32():
    return dataclasses.replace(TransformerConfig(), dtype=torch.float32)


def _nccl_ids(processes, each):
    return [[p * each + i for i in range(each)] for p in range(processes)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_nccl_flagship_step_equals_one_process(cards, tmp_path, layout):
    """The f32 flagship's step (SGD 0.1, two steps, 4 x 1024 tokens),
    each process passing only its rows, against the one-process step on
    the same mesh over the same four cards: the same kernels on the same
    rows, the gradient sums across processes ordered by NCCL, so the
    losses agree to rtol 1e-5 and every shard's every leaf to rtol 1e-5,
    atol 1e-6. pp2x2 puts dp and pp both across the four processes (the
    pipeline's hops over NCCL, two microbatches on both sides); tp4x1
    puts the row-parallel sums across four processes (each feeding the
    whole batch, its 2 heads through the flash kernels), and tp2x2 tp
    across two processes of two cards each, sp inside each (ring
    attention), autograd crossing the processes from two cards."""
    if len(cards) < 4:
        pytest.skip(f"needs four CUDA cards, {len(cards)} visible")
    processes, each, sizes = LAYOUTS[layout]
    cfg = _flagship_f32()
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size,
                          (NCCL_STEPS, NCCL_BATCH, NCCL_LEN + 1))
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "dtype"}
    job = {"kind": "step", "name": layout, "cfg": fields, "mesh": sizes,
           "optimizer": "sgd", "lr": 0.1, "steps": NCCL_STEPS,
           "init_seed": 0, "microbatches": MICROBATCHES[layout]}
    outs = worker.launch([job], tmp_path, processes=processes,
                         backend="nccl",
                         local_device_ids=_nccl_ids(processes, each),
                         arrays={"tokens": tokens[:, :, :-1],
                                 "targets": tokens[:, :, 1:]},
                         timeout_s=NCCL_TIMEOUT_S)
    mesh = make_mesh(MeshConfig(**sizes), devices=cards[:4])
    step, _, shards = make_spmd_train_step(
        cfg, mesh, init_params(cfg, 0, device="cpu"),
        optimizer=lambda ls: torch.optim.SGD(ls, lr=0.1),
        n_microbatches=MICROBATCHES[layout])
    want = [step(torch.from_numpy(tokens[i, :, :-1]),
                 torch.from_numpy(tokens[i, :, 1:])).item()
            for i in range(NCCL_STEPS)]
    leaves = [_flat_cpu(s) for s in shards]
    for p, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{layout}/losses"], want,
                                   rtol=1e-5)
        assert out[f"{layout}/local_indices"].tolist() == list(
            range(p * each, (p + 1) * each))
        assert not bool(out["jax_imported"])
        for j in range(p * each, (p + 1) * each):
            for k, b in leaves[j].items():
                torch.testing.assert_close(
                    torch.from_numpy(out[f"{layout}/{j}/{k}"]), b,
                    rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_nccl_collectives_equal_one_process(cards, tmp_path, layout):
    """Every op of the worker's OPS across processes over NCCL against
    the one-process op over the same four cards: values and the gradient
    of sum(w * out) (integers: exact), also with two cards a process,
    where each card's autograd thread reaches the exchanges in an order
    of its own and the chain of ``collective/ops.py`` posts them in the
    forward's reverse."""
    if len(cards) < 4:
        pytest.skip(f"needs four CUDA cards, {len(cards)} visible")
    processes, each, sizes = LAYOUTS[layout]
    rng = np.random.default_rng(0)
    x = rng.integers(-8, 9, (4 * 4, 4)).astype(np.float32)
    mesh = make_mesh(MeshConfig(**sizes), devices=cards[:4])
    arrays, want = {"x": x}, {}
    for op, fn in worker.OPS.items():
        xs = [torch.tensor(b, device=d, requires_grad=True)
              for b, d in zip(np.split(x, 4), cards)]
        outs = fn(xs, mesh)
        w = rng.integers(-8, 9, (4,) + tuple(outs[0].shape)).astype(
            np.float32)
        arrays[f"w/{layout}/{op}"] = w
        sum(torch.sum(o * torch.from_numpy(wj).to(o.device)).to(cards[0])
            for o, wj in zip(outs, w)).backward()
        want[op] = ([o.detach().cpu().numpy() for o in outs],
                    [np.zeros_like(b) if t.grad is None
                     else t.grad.cpu().numpy()
                     for t, b in zip(xs, np.split(x, 4))])
    job = {"kind": "collectives", "name": layout, "mesh": sizes,
           "ops": list(worker.OPS)}
    outs = worker.launch([job], tmp_path, processes=processes,
                         backend="nccl",
                         local_device_ids=_nccl_ids(processes, each),
                         arrays=arrays, timeout_s=NCCL_TIMEOUT_S)
    merged = {k: v for out in outs for k, v in out.items()}
    for op, (vals, grads) in want.items():
        for j in range(4):
            np.testing.assert_array_equal(
                merged[f"{layout}/{op}/out/{j}"], vals[j], err_msg=op)
            np.testing.assert_array_equal(
                merged[f"{layout}/{op}/grad/{j}"], grads[j], err_msg=op)


@pytest.mark.cuda
def test_provider_launches_two_pair_nodes_on_four_cards(cards, tmp_path):
    """Two ``GPU: 2`` nodes of ``LocalSubprocessProvider`` on four cards:
    each joins advertising 2 (the provider checks it against the head),
    on cards no other node holds; a third finds none free and fails;
    once the first is reaped its cards go to the next."""
    if len(cards) < 4:
        pytest.skip(f"needs four CUDA cards, {len(cards)} visible")
    import chip_smoke
    from ray_tpu_torch._private.config import GlobalConfig
    from ray_tpu_torch.autoscaler import (
        LocalSubprocessProvider,
        NodeTypeConfig,
    )
    from ray_tpu_torch.exceptions import NodeLaunchFailedError

    env = chip_smoke._cluster_env()
    env.pop("CUDA_VISIBLE_DEVICES", None)
    head, address, _ = chip_smoke._start_head(str(tmp_path / "state.log"),
                                              env=env)
    pair = NodeTypeConfig("pair", {"CPU": 1, "GPU": 2})
    handles = []
    GlobalConfig.set("autoscaler_launch_retries", 1)
    try:
        prov = LocalSubprocessProvider(address, worker_mode="thread",
                                       env=env)
        handles += [prov.launch(pair), prov.launch(pair)]
        held = [sorted(c for c, proc in prov._holders.items()
                       if proc is h["proc"]) for h in handles]
        assert held == [["0", "1"], ["2", "3"]]
        with pytest.raises(NodeLaunchFailedError,
                           match="advertises GPU 0 where its type "
                                 "declares 2"):
            prov.launch(pair)
        prov.terminate(handles[0])
        handles.append(prov.launch(pair))
        assert sorted(c for c, proc in prov._holders.items()
                      if proc is handles[-1]["proc"]) == ["0", "1"]
    finally:
        GlobalConfig.reset()
        for h in handles:
            if h["proc"].poll() is None:
                h["proc"].kill()
                h["proc"].wait(timeout=10)
        head.kill()
        head.wait(timeout=10)
