"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

It stands beside the JAX package (``ray_tpu``), which stays the reference,
and imports nothing of it or of JAX. It covers the flagship decoder's
serving and one-card training paths, dense or MoE: ``models`` (prefill
with cache, chunked prefill, decode over a paged KV cache, on one device
or tensor-parallel; the differentiable ``forward``, ``loss_fn`` and an
AdamW ``make_train_step``), ``llm`` (the continuous-batching engine) and
``ops`` (hand-written flash-attention forward and backward kernels for
sm_90a, a Triton RMSNorm kernel, plain PyTorch paged attention); the
compiled-DAG wave executor, on one device or sharded over a mesh:
``dag`` with the bind-only ``remote`` of ``remote_function``; and the
one-controller mesh and its collectives, ``parallel`` and
``collective``; and reinforcement learning, ``rl`` (tensor-native
environments, PPO, DQN and multi-agent PPO, each rollout and update one
CUDA graph on the card). Entry points take a ``device`` that defaults to
``"cuda"``; tests pass ``device="cpu"``.
"""

from ray_tpu_torch import rl
from ray_tpu_torch.remote_function import remote

__version__ = "0.1.0"
__all__ = ["remote", "rl"]
