"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper.

It stands beside the JAX package (``ray_tpu``), which stays the reference,
and imports nothing of it or of JAX. It covers the flagship decoder's
serving and one-card training paths, dense or MoE: ``models`` (prefill
with cache, chunked prefill, decode over a paged KV cache, on one device
or tensor-parallel; the differentiable ``forward``, ``loss_fn`` and an
AdamW ``make_train_step``), ``llm`` (the continuous-batching engine and
``build_llm_app``, its Serve deployment) and ``ops`` (hand-written
flash-attention forward and backward kernels for sm_90a, a Triton
RMSNorm kernel, plain PyTorch paged attention); the one-process runtime
(tasks, actors, ObjectRefs and streaming generators on threads in the
calling process: ``init``, ``remote``, ``get``, ``put``, ``wait``, ``cancel``,
``kill``, ``shutdown``, ``available_resources``, ``cluster_resources``)
and ``serve`` on top of it, disaggregated prefill/decode serving among
``llm``'s apps; DAGs (``dag``): interpreted on the runtime, compiled to
actor loops over channels (``channels``), or compiled to the wave
executor, on one device or sharded over a mesh; the one-controller mesh
and its collectives, ``parallel`` and ``collective`` (with the actor
plane's groups); reinforcement learning, ``rl`` (tensor-native
environments, PPO, DQN, IMPALA and multi-agent PPO, each rollout and
update one CUDA graph on the card, runners local or remote actors); and
``train`` with ``data`` on the runtime: worker-group trainers
(``DataParallelTrainer``, ``TorchTrainer``) with checkpoints persisted to
storage URIs, group restarts and ``restore``, fed by a ``Dataset``
streamed onto the card (``iter_torch_batches``). Entry points take a
``device`` that defaults to
``"cuda"``; tests pass ``device="cpu"``. Importing the package starts no
thread: ``init`` (or the first ``.remote()``) does, and ``shutdown``
joins them.
"""

from ray_tpu_torch._private.worker import (
    ObjectRef,
    ObjectRefGenerator,
    cancel,
    get,
    init,
    is_initialized,
    put,
    shutdown,
    wait,
)
from ray_tpu_torch.actor import ActorClass, ActorHandle, get_actor, kill
from ray_tpu_torch.remote_function import RemoteFunction, method, remote
from ray_tpu_torch.runtime_context import get_runtime_context
from ray_tpu_torch import exceptions, llm, rl, serve

__version__ = "0.1.0"


def available_resources():
    """Resources not held by running tasks: ``{"CPU": n, "GPU": m,
    ...}``."""
    from ray_tpu_torch._private.worker import global_worker

    return global_worker().resource_pool.available()


def cluster_resources():
    """Every resource of the runtime, held or not (one process: one
    node)."""
    from ray_tpu_torch._private.worker import global_worker

    return global_worker().resource_pool.total

__all__ = [
    "ActorClass",
    "ActorHandle",
    "ObjectRef",
    "ObjectRefGenerator",
    "RemoteFunction",
    "available_resources",
    "cancel",
    "cluster_resources",
    "exceptions",
    "get",
    "get_actor",
    "get_runtime_context",
    "init",
    "is_initialized",
    "kill",
    "llm",
    "method",
    "put",
    "remote",
    "rl",
    "serve",
    "shutdown",
    "wait",
]
