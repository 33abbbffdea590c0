"""Dataset creation (counterpart of ``ray_tpu/data/read_api.py``, trimmed
to the in-memory sources). The file readers (parquet, csv, json,
tfrecords, images, sql) are not ported: the card's machine has no
``pyarrow`` or ``pandas``.
"""

from __future__ import annotations

import builtins
import math
from typing import Any, Callable, Dict, List

import numpy as np

from ray_tpu_torch.data.block import Block, normalize_block
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.data.executor import InputOperator
from ray_tpu_torch.data.logical import LogicalOp, LogicalPlan


def _from_read_tasks(name: str, tasks: List[Callable[[], List[Block]]]
                     ) -> Dataset:
    return Dataset(LogicalPlan([LogicalOp(
        kind="read", name=name, read_tasks=tasks,
        make_physical=lambda lo: InputOperator(lo.name, lo.read_tasks))]))


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    per = math.ceil(n / parallelism) if n else 0
    tasks = []
    for i in builtins.range(parallelism):
        lo, hi = i * per, min((i + 1) * per, n)
        if lo >= hi:
            continue
        tasks.append(lambda lo=lo, hi=hi: [
            {"id": np.arange(lo, hi, dtype=np.int64)}])
    return _from_read_tasks(f"Range[{n}]", tasks)


def from_items(items: List[Any], *, parallelism: int = 1) -> Dataset:
    blocks = []
    per = math.ceil(len(items) / parallelism) if items else 0
    for i in builtins.range(parallelism):
        chunk = items[i * per:(i + 1) * per]
        if chunk:
            blocks.append(chunk)
    tasks = [lambda c=c: [normalize_block(c)] for c in blocks]
    return _from_read_tasks("FromItems", tasks)


def from_columns(columns: Dict[str, Any], *, parallelism: int = 1) -> Dataset:
    block = {k: np.asarray(v) for k, v in columns.items()}
    n = len(next(iter(block.values()))) if block else 0
    per = math.ceil(n / parallelism) if n else 0
    tasks = []
    for i in builtins.range(parallelism):
        lo, hi = i * per, min((i + 1) * per, n)
        if lo >= hi:
            continue
        piece = {k: v[lo:hi] for k, v in block.items()}
        tasks.append(lambda p=piece: [p])
    return _from_read_tasks("FromColumns", tasks)


def from_numpy(arr: np.ndarray, *, parallelism: int = 1) -> Dataset:
    return from_columns({"data": arr}, parallelism=parallelism)
