"""Per-worker training session (counterpart of
``ray_tpu/train/session.py``).

A thread-local context carries the rank, the world size and the dataset
shards; ``report()`` streams metrics (and an optional checkpoint) back to
the trainer through the runtime's internal KV under ``(run_id, rank,
seq)`` keys, the store the actor-plane collective groups use. Reports are
pickled with stdlib ``pickle`` (protocol 5): Python numbers and a
``Checkpoint`` (a path), as in the reference; a metric that is a CUDA
tensor is pickled with its device.
"""

from __future__ import annotations

import pickle
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_local = threading.local()


def _report_key(run_id: str, rank: int, seq: int) -> bytes:
    return f"train|{run_id}|{rank}|{seq}".encode()


class TrainContext:
    def __init__(self, world_rank: int, world_size: int, run_id: str = "",
                 dataset_shards: Optional[Dict[str, Any]] = None,
                 latest_checkpoint: Optional[Checkpoint] = None,
                 trial_name: str = ""):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = world_rank
        self.trial_name = trial_name
        self.run_id = run_id
        self._report_seq = 0
        self._dataset_shards = dataset_shards or {}
        self._latest_checkpoint = latest_checkpoint

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_world_size(self) -> int:
        return self.world_size

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_trial_name(self) -> str:
        return self.trial_name

    @property
    def collective_group(self) -> str:
        """The worker group's actor-plane collective group name (joined
        by every worker before the loop runs)."""
        return _group_name(self.run_id)


def _group_name(run_id: str) -> str:
    """THE definition of a run's collective group name — trainer and
    session must agree or DP collectives join a group nobody set up."""
    return f"train-{run_id}"


def _set_context(ctx: Optional[TrainContext]):
    _local.ctx = ctx


def get_context() -> TrainContext:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        raise RuntimeError(
            "no training session active (call inside train_loop_per_worker)")
    return ctx


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    from ray_tpu_torch._private.worker import auto_init

    ctx = get_context()
    seq = ctx._report_seq
    ctx._report_seq = seq + 1
    auto_init().kv_put(
        _report_key(ctx.run_id, ctx.world_rank, seq),
        pickle.dumps((dict(metrics), checkpoint), protocol=5))


def get_checkpoint() -> Optional[Checkpoint]:
    return get_context()._latest_checkpoint


def get_dataset_shard(name: str = "train"):
    return get_context()._dataset_shards.get(name)
