"""The process plane beside the card: a CUDA tensor passed to a worker
process arrives there as a CPU tensor with equal values, a task (even one
that asks for the card) sees no card, and an actor created with
``runtime="driver"`` computes on ``cuda:0``.

Every test is marked ``cuda`` and skips without a card. The file imports
no JAX, so it runs on a machine that has only PyTorch:
``python -m pytest tests/test_torch_process_card.py -m cuda --noconftest``.
"""

import os
import shutil

import pytest
import torch

import ray_tpu_torch

T = 60.0


@pytest.fixture
def runtime():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the process plane beside the "
                    "driver's CUDA context")
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native layer of the process plane "
                    "cannot build")
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=2, worker_mode="process")
    try:
        yield torch.device("cuda", 0)
    finally:
        ray_tpu_torch.shutdown()


def _describe(t):
    return t.device.type, t.requires_grad, type(t).__name__, t


@pytest.mark.cuda
def test_cuda_argument_arrives_on_the_cpu(runtime):
    gen = torch.Generator(runtime).manual_seed(0)
    x = torch.randn(256, 64, device=runtime, generator=gen)
    p = torch.nn.Parameter(torch.randn(8, device=runtime, generator=gen))
    describe = ray_tpu_torch.remote(_describe)
    for value in (x, p, ray_tpu_torch.put(x)):
        kind, grad, name, back = ray_tpu_torch.get(describe.remote(value),
                                                   timeout=T)
        assert kind == "cpu" and back.device.type == "cpu"
        want = (x if value is not p else p).detach().cpu()
        assert torch.equal(back.detach(), want)
        assert (grad, name) == ((True, "Parameter") if value is p
                                else (False, "Tensor"))


def _probe():
    import torch as _torch

    return (os.getpid(), os.environ.get("CUDA_VISIBLE_DEVICES"),
            _torch.cuda.is_available())


@pytest.mark.cuda
def test_process_task_sees_no_card(runtime):
    probe = ray_tpu_torch.remote(_probe)
    for ref in (probe.remote(), probe.options(num_gpus=1).remote()):
        pid, visible, available = ray_tpu_torch.get(ref, timeout=T)
        assert pid != os.getpid() and visible == "" and not available
    assert ray_tpu_torch.cluster_resources()["GPU"] == float(
        torch.cuda.device_count())


class _OnCard:
    def __init__(self):
        self.w = torch.arange(12.0, device="cuda:0").reshape(3, 4)

    def apply(self, x):
        y = self.w @ x.to(self.w.device)
        return str(y.device), y.cpu(), os.getpid()


@pytest.mark.cuda
def test_driver_actor_computes_on_the_card(runtime):
    actor = ray_tpu_torch.remote(runtime="driver")(_OnCard).remote()
    x = torch.ones(4, 2)
    where, y, pid = ray_tpu_torch.get(actor.apply.remote(x), timeout=T)
    assert where == "cuda:0" and pid == os.getpid()
    assert torch.equal(y, torch.arange(12.0).reshape(3, 4) @ x)
