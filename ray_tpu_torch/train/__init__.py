"""ray_tpu_torch.train (counterpart of ``ray_tpu.train``): worker-group
training on the one-process runtime. ``DataParallelTrainer`` (the
reference's ``JaxTrainer``, under the alias the reference also exports)
and ``TorchTrainer`` run ``train_loop_per_worker`` on N worker actors with
``report``, checkpoints persisted to a storage URI (``CheckpointStore``),
group restarts from the latest checkpoint and ``restore(uri)``;
``get_dataset_shard`` hands each rank its ``Dataset.split`` shard.
``TransformersTrainer`` fine-tunes a PyTorch ``transformers`` model on the
same worker group (``train/huggingface.py``).
"""

from ray_tpu_torch.train.callbacks import (
    Callback,
    CSVLoggerCallback,
    JsonLoggerCallback,
)
from ray_tpu_torch.train.checkpoint import (
    Checkpoint,
    load_pytree,
    save_pytree,
)
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import (
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from ray_tpu_torch.train.storage import CheckpointStore
from ray_tpu_torch.train import torch  # noqa: F401 — train.torch.*
from ray_tpu_torch.train.torch import TorchTrainer
from ray_tpu_torch.train.huggingface import TransformersTrainer
from ray_tpu_torch.train.trainer import (
    DataParallelTrainer,
    Result,
    TrainingFailedError,
)

__all__ = [
    "CSVLoggerCallback",
    "Callback",
    "Checkpoint",
    "CheckpointConfig",
    "CheckpointStore",
    "DataParallelTrainer",
    "FailureConfig",
    "JsonLoggerCallback",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "TorchTrainer",
    "TrainingFailedError",
    "TransformersTrainer",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "load_pytree",
    "report",
    "save_pytree",
]
