"""The one-process runtime and Serve on the card: a CUDA tensor's
``put``/``get`` and task round trips stay on its device with equal
values, and the tiny model served on ``cuda:0`` streams what its own
engine's ``generate`` gives.

Every test is marked ``cuda`` and skips without a card. The file imports
no JAX, so it runs on a machine that has only PyTorch:
``python -m pytest tests/test_torch_serve_card.py -m cuda --noconftest``.
"""

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.llm import EngineConfig, InferenceEngine, build_llm_app
from ray_tpu_torch.models import TransformerConfig

T = 60.0
MODEL = TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=48, dtype=torch.float32)
PROMPTS = [[1, 2, 3], list(range(1, 14)), [7] * 9]


@pytest.fixture
def runtime():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device path of the object "
                    "store and the engine on cuda:0")
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    try:
        yield torch.device("cuda", 0)
    finally:
        serve.shutdown()
        ray_tpu_torch.shutdown()


@pytest.mark.cuda
def test_cuda_tensor_round_trips_stay_on_the_device(runtime):
    x = torch.randn(64, 128, device=runtime, generator=torch.Generator(
        runtime).manual_seed(0))
    back = ray_tpu_torch.get(ray_tpu_torch.put(x), timeout=T)
    assert back.device == x.device and torch.equal(back, x)
    # The store holds its own copy: the writer's later update and a
    # reader's do not reach it.
    kept = x.clone()
    ref = ray_tpu_torch.put(x)
    x.add_(1.0)
    first = ray_tpu_torch.get(ref, timeout=T)
    first.zero_()
    assert torch.equal(ray_tpu_torch.get(ref, timeout=T), kept)

    @ray_tpu_torch.remote
    def scale(t, k):
        assert t.is_cuda
        return t * k

    out = ray_tpu_torch.get(scale.remote(ray_tpu_torch.put(x), 2.0),
                            timeout=T)
    assert out.device == x.device and torch.equal(out, x * 2.0)
    assert ray_tpu_torch.get(scale.remote(x, 3.0), timeout=T).is_cuda


@pytest.mark.cuda
def test_served_tiny_model_equals_its_engine(runtime):
    cfg = EngineConfig(model=MODEL, num_blocks=128, block_size=4,
                       max_num_seqs=4, device="cuda")
    engine = InferenceEngine(cfg)
    try:
        want = [list(engine.generate(p, max_new_tokens=8)) for p in PROMPTS]
    finally:
        engine.shutdown()
    handle = serve.run(build_llm_app(cfg))
    got = [list(handle.options(stream=True).remote(
        {"prompt": p, "max_new_tokens": 8})) for p in PROMPTS]
    assert got == want
    st = handle.stats.remote().result(timeout=T)
    assert st["device"].startswith("cuda")
