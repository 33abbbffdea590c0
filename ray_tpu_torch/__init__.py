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
streamed onto the card (``iter_torch_batches``); the observability plane:
task events, tracing (``util.tracing``), the flight recorder, the
metrics registry (``util.metrics``) and the state API (``util.state``),
read through ``timeline`` and ``debug_dump``; ``tune`` (the Tuner and its
trial controller, search spaces, searchers and schedulers) and
``workflow`` (durable step DAGs and virtual actors that survive their
driver's death), each a subpackage imported on its own, as in the
reference. Entry points take a
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


def timeline(trace_id=None, filename=None):
    """Chrome-tracing JSON. Without ``trace_id``: the task-event timeline
    (one event per task or actor call that ran to FINISHED or FAILED).
    With ``trace_id`` (tracing armed by ``RAY_TPU_TRACE``): that trace's
    spans. ``filename`` writes the JSON for chrome://tracing or Perfetto
    and returns the path."""
    if trace_id is not None:
        from ray_tpu_torch.util.state import trace_summary

        events = trace_summary(trace_id)["chrome_trace"]
    else:
        from ray_tpu_torch.util.state import get_timeline

        events = get_timeline()
    if filename is not None:
        import json as _json

        with open(filename, "w") as f:
            _json.dump(events, f)
        return filename
    return events


def debug_dump(out_dir=None):
    """Postmortem collection (the flight recorder, armed by
    ``RAY_TPU_FLIGHT`` / ``RAY_TPU_PROFILE``): this process's debug
    bundle (all-thread stacks, event ring, profile aggregate, metrics
    snapshot, subsystem sections, device-trace artifacts) written as one
    directory-per-incident archive. Returns the incident directory."""
    from ray_tpu_torch.util.state import cluster_dump

    return cluster_dump(out_dir)


__all__ = [
    "ActorClass",
    "ActorHandle",
    "ObjectRef",
    "ObjectRefGenerator",
    "RemoteFunction",
    "available_resources",
    "cancel",
    "cluster_resources",
    "debug_dump",
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
    "timeline",
    "wait",
]
