"""Train config dataclasses (counterpart of ``ray_tpu/train/config.py``)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass
class ScalingConfig:
    num_workers: int = 1
    # As the reference's use_tpu, it reserves nothing: workers are threads
    # of the process that owns the card, and a loop places its own tensors.
    use_gpu: bool = False
    resources_per_worker: Optional[Dict[str, float]] = None

    @property
    def total_workers(self) -> int:
        return max(int(self.num_workers), 1)


@dataclasses.dataclass
class FailureConfig:
    max_failures: int = 0  # restarts of the whole worker group


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_frequency: int = 0
    # Persist checkpoints on a background upload thread so the trainer's
    # report-drain loop (and therefore the training step cadence) never
    # blocks on storage IO; drained once at fit() end.
    async_save: bool = False


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = dataclasses.field(
        default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    # Result-stream hooks (train/callbacks.py).
    callbacks: list = dataclasses.field(default_factory=list)
