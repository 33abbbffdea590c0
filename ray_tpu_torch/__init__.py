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
``llm``'s apps; the process plane (``init(worker_mode="process")``:
tasks and actors in worker processes over a native shared-memory store,
which never reach the card; the default ``worker_mode`` stays
``"thread"``); DAGs (``dag``): interpreted on the runtime, compiled to
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
read through ``timeline`` and ``debug_dump``; the cluster's control
plane (a head service, ``python -m ray_tpu_torch._private.head_service``,
that drivers attach to with ``init(address="host:port")``: a
cluster-global KV, named actors called across drivers, objects pulled
across drivers with ``announce_object``, pub/sub, and a head restart
survived) and its node plane (node daemons,
``python -m ray_tpu_torch._private.node_daemon --address host:port``,
onto which an attached driver routes tasks and places actors peer to
peer, refs resolving through their owner, work surviving a dead node;
``init(address="ray://host:port")`` attaches a thin client that runs
nothing itself); the operator's surface on that cluster: per-task
runtime envs (``runtime_env``: env vars, a working directory, import
paths, a pip or uv venv), the demand-driven ``autoscaler`` that launches
and reaps node daemons, ``job_submission``, the ``dashboard`` and the
command line (``python -m ray_tpu_torch.scripts.cli``: ``start``,
``autoscale``, ``job submit``, ``debug``, ...); ``util``'s placement
groups, scheduling strategies and pub/sub, with its ``sanitizer``
(host-plane invariant checks), ``loadgen`` (seeded traffic shapes) and
``chaos`` (seeded fault decisions and process kills); ``tune`` (the Tuner and its
trial controller, search spaces, searchers and schedulers) and
``workflow`` (durable step DAGs and virtual actors that survive their
driver's death), each a subpackage imported on its own, as in the
reference. ``llm``, ``rl`` and ``serve`` load at first use. Entry
points take a
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
from ray_tpu_torch import exceptions

__version__ = "0.1.0"

# Loaded at first use (PEP 562): a worker process of the process plane
# imports this package to run a task and must not pay for torch and the
# model code unless the task uses them.
_LAZY_SUBMODULES = ("llm", "rl", "serve")


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        import importlib

        return importlib.import_module(f"ray_tpu_torch.{name}")
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")


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


def announce_object(ref) -> None:
    """Publish an object to the head's object directory so other
    attached drivers can ``get`` it (needs ``init(address=...)``)."""
    from ray_tpu_torch._private.worker import global_worker

    global_worker().announce_object(ref)


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
    snapshot, subsystem sections, device-trace artifacts), with a head
    the head's and every live node daemon's, written as one
    directory-per-incident archive. Returns the incident directory."""
    from ray_tpu_torch.util.state import cluster_dump

    return cluster_dump(out_dir)


__all__ = [
    "ActorClass",
    "ActorHandle",
    "ObjectRef",
    "ObjectRefGenerator",
    "RemoteFunction",
    "announce_object",
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
