"""ray_tpu_torch.data (counterpart of ``ray_tpu.data``): columnar numpy
blocks, a lazy plan run by a streaming executor on the one-process
runtime's tasks, and ``Dataset.iter_torch_batches``, the Train feed onto
the card. Sources: ``range``, ``from_items``, ``from_columns``,
``from_numpy``, ``from_pandas``, ``from_arrow``, the parquet, CSV, JSON,
image, numpy, binary, TFRecord and SQL readers and custom datasources;
paths on the local disk, ``memory://`` or any fsspec scheme. The
all-to-all operators (shuffle, sort, groupby with its aggregates,
repartition, zip); numpy, pandas and Arrow batches; the parquet, CSV,
JSON and TFRecord writers, ``to_pandas`` and custom datasinks.
"""

from ray_tpu_torch.data.block import Block, BlockMetadata
from ray_tpu_torch.data.dataset import Dataset, MaterializedDataset
from ray_tpu_torch.data.datasource import Datasink, Datasource, ReadTask
from ray_tpu_torch.data.filesystem import (
    Filesystem,
    MemoryFilesystem,
    register_filesystem,
    resolve_filesystem,
)
from ray_tpu_torch.data.grouped import (
    AggregateFn,
    Count,
    Max,
    Mean,
    Min,
    Std,
    Sum,
)
from ray_tpu_torch.data.read_api import (
    from_arrow,
    from_columns,
    from_items,
    from_numpy,
    from_pandas,
    range,  # noqa: A004
    read_binary_files,
    read_csv,
    read_datasource,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_sql,
    read_tfrecords,
)
from ray_tpu_torch.data.stats import DatasetStats

__all__ = [
    "AggregateFn", "Block", "BlockMetadata", "Count", "Dataset",
    "Datasink", "Datasource", "DatasetStats", "Filesystem",
    "MaterializedDataset", "Max", "Mean", "MemoryFilesystem", "Min",
    "ReadTask", "Std", "Sum", "from_arrow", "from_columns",
    "from_items", "from_numpy", "from_pandas", "range",
    "read_binary_files", "read_csv", "read_datasource", "read_images",
    "read_json", "read_numpy", "read_parquet", "read_sql",
    "read_tfrecords", "register_filesystem", "resolve_filesystem",
]
