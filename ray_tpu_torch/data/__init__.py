"""ray_tpu_torch.data (counterpart of ``ray_tpu.data``): columnar numpy
blocks, a lazy plan run by a streaming executor on the one-process
runtime's tasks, and ``Dataset.iter_torch_batches``, the Train feed onto
the card. Sources: ``range``, ``from_items``, ``from_columns`` and
``from_numpy``. Not ported yet: the all-to-all operators (shuffle, sort,
groupby, repartition, zip), the file readers and writers, custom
datasources.
"""

from ray_tpu_torch.data.block import Block, BlockMetadata
from ray_tpu_torch.data.dataset import Dataset, MaterializedDataset
from ray_tpu_torch.data.filesystem import (
    Filesystem,
    MemoryFilesystem,
    register_filesystem,
    resolve_filesystem,
)
from ray_tpu_torch.data.read_api import (
    from_columns,
    from_items,
    from_numpy,
    range,  # noqa: A004
)
from ray_tpu_torch.data.stats import DatasetStats

__all__ = [
    "Block", "BlockMetadata", "Dataset", "DatasetStats", "Filesystem",
    "MaterializedDataset", "MemoryFilesystem", "from_columns",
    "from_items", "from_numpy", "range", "register_filesystem",
    "resolve_filesystem",
]
