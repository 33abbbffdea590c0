"""Dataset creation (counterpart of ``ray_tpu/data/read_api.py``): the
in-memory sources, the numpy, binary, TFRecord and SQL readers, and
custom datasources. The parquet, CSV, JSON and image readers and
``from_pandas`` / ``from_arrow`` are left out: the card's machine has no
``pyarrow``, ``pandas`` or ``PIL``.
"""

from __future__ import annotations

import builtins
import glob as globlib
import math
import os
from typing import Any, Callable, Dict, List, Optional

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


def _open_path(path: str, mode: str = "rb"):
    """Open a path through the filesystem registry (local, memory://, or
    a registered scheme)."""
    from ray_tpu_torch.data.filesystem import resolve_filesystem

    fs, p = resolve_filesystem(path)
    return fs.open(p, mode)


def _expand_paths(paths, suffix: Optional[str] = None) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if "://" in p:
            # Scheme-qualified: resolve through the filesystem registry.
            from ray_tpu_torch.data.filesystem import resolve_filesystem

            fs, fp = resolve_filesystem(p)
            if fs.isdir(fp):
                out.extend(f for f in fs.listdir(fp)
                           if suffix is None or f.endswith(suffix))
            else:
                out.append(p)
        elif os.path.isdir(p):
            out.extend(sorted(
                f for f in globlib.glob(os.path.join(p, "**", "*"),
                                        recursive=True)
                if os.path.isfile(f)
                and (suffix is None or f.endswith(suffix))))
        elif any(c in p for c in "*?["):
            out.extend(sorted(globlib.glob(p, recursive=True)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files matched {paths}")
    return out


def read_numpy(paths, **_opts) -> Dataset:
    """One block per ``.npy`` file, its array in a ``data`` column."""
    files = _expand_paths(paths)

    def make_task(f):
        def task() -> List[Block]:
            if "://" in f:
                with _open_path(f) as fh:
                    return [{"data": np.load(fh)}]
            return [{"data": np.load(f)}]

        return task

    return _from_read_tasks("ReadNumpy", [make_task(f) for f in files])


def read_binary_files(paths, **_opts) -> Dataset:
    """One row per file: its ``path`` and its ``bytes``."""
    files = _expand_paths(paths)

    def make_task(f):
        def task() -> List[Block]:
            with _open_path(f) as fh:
                data = fh.read()
            return [{"path": np.asarray([f], dtype=object),
                     "bytes": np.asarray([data], dtype=object)}]

        return task

    return _from_read_tasks("ReadBinary", [make_task(f) for f in files])


def read_tfrecords(paths, *, check_integrity: bool = True,
                   **_opts) -> Dataset:
    """Read TFRecord files of tf.train.Example protos (no tensorflow
    dependency: ``data/tfrecords.py`` holds the record framing and the
    protobuf codec). Each feature key becomes a column; single-element
    features scalarize, longer ones stay arrays in an object column.
    ``check_integrity`` (default on) validates each record's data CRC as
    well as its length CRC."""
    files = _expand_paths(paths)

    def make_task(f):
        def task() -> List[Block]:
            from ray_tpu_torch.data.tfrecords import (
                decode_example,
                examples_to_block,
                read_records,
            )

            with _open_path(f) as fh:
                rows = [decode_example(r)
                        for r in read_records(
                            fh, check_integrity=check_integrity)]
            return [examples_to_block(rows)]

        return task

    return _from_read_tasks("ReadTFRecords", [make_task(f) for f in files])


def read_sql(sql: str, connection_factory, *, parallelism: int = 1,
             **_opts) -> Dataset:
    """Read a SQL query through any DBAPI-2 connection factory. The
    factory runs inside each read task (connections do not pickle); with
    parallelism > 1 the query is sharded only when it embeds a
    ``{shard}`` / ``{num_shards}`` placeholder, otherwise one task reads
    the whole result."""
    sharded = "{shard}" in sql
    n_tasks = parallelism if sharded else 1

    def make_task(shard):
        def task() -> List[Block]:
            conn = connection_factory()
            try:
                cur = conn.cursor()
                # Targeted replacement, not str.format: SQL may hold other
                # braces (json paths etc.), and a query with only
                # {num_shards} must still substitute.
                query = sql.replace("{shard}", str(shard)) \
                    .replace("{num_shards}", str(n_tasks))
                cur.execute(query)
                cols = [d[0] for d in cur.description]
                rows = cur.fetchall()
            finally:
                conn.close()
            if not rows:
                return [{}]
            return [{c: np.asarray([r[i] for r in rows])
                     for i, c in enumerate(cols)}]

        return task

    return _from_read_tasks(
        "ReadSQL", [make_task(s) for s in builtins.range(n_tasks)])


def read_datasource(datasource, *, parallelism: int = 8, **opts) -> Dataset:
    """Custom Datasource protocol: an object whose
    ``get_read_tasks(parallelism)`` returns callables -> List[Block]."""
    tasks = datasource.get_read_tasks(parallelism, **opts)
    return _from_read_tasks(type(datasource).__name__, tasks)
