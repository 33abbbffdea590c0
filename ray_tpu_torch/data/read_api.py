"""Dataset creation (counterpart of ``ray_tpu/data/read_api.py``): the
in-memory sources (``from_items``, ``from_columns``, ``from_numpy``,
``from_pandas``, ``from_arrow``), the parquet (hive partitions, column
projection), CSV, JSON, image, numpy, binary, TFRecord and SQL readers,
and custom datasources.
"""

from __future__ import annotations

import builtins
import glob as globlib
import math
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np

# Pre-import the IO extension stacks on the importing thread: initializing
# the pyarrow/pandas extension modules concurrently from several read
# tasks' threads segfaults (seen on the import of pyarrow.dataset).
try:
    import pandas as _pd  # noqa: F401
    import pyarrow.dataset as _pads  # noqa: F401
    import pyarrow.parquet as _papq  # noqa: F401
except ImportError:  # pragma: no cover - optional IO packages
    pass

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


def from_pandas(df, *, parallelism: int = 1) -> Dataset:
    return from_columns({c: df[c].to_numpy() for c in df.columns},
                        parallelism=parallelism)


def from_arrow(table, *, parallelism: int = 1) -> Dataset:
    return from_columns(
        {c: table.column(c).to_numpy(zero_copy_only=False)
         for c in table.column_names}, parallelism=parallelism)


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


def _hive_partition_values(file_path: str, root: Optional[str]):
    """Hive-style ``key=value`` directory components of a file's path
    (root-relative when a dataset root directory is known; otherwise every
    path component — so globs and file lists keep their partitions)."""
    dirname = os.path.dirname(os.path.abspath(file_path))
    if root is not None:
        dirname = os.path.relpath(dirname, os.path.abspath(root))
    values = {}
    for part in dirname.split(os.sep):
        if "=" in part:
            k, _, v = part.partition("=")
            values[k] = v
    return values


def _typed_partitions(per_file: List[dict]) -> List[dict]:
    """Uniform partition schema across all files: the key UNION (missing
    keys fill as empty strings — mixed-depth trees must concat), with
    int/float inference when every file has the key and it parses
    (`ds.partitioning`'s inferred-type contract)."""
    keys = sorted(set().union(*per_file)) if per_file else []
    out = [dict(v) for v in per_file]
    for k in keys:
        raw = [v.get(k) for v in per_file]
        if any(r is None for r in raw):
            cast = str  # mixed depth: keep strings, fill ""
        else:
            cast = str
            for candidate in (int, float):
                try:
                    [candidate(r) for r in raw]
                    cast = candidate
                    break
                except ValueError:
                    continue
        for v in out:
            v[k] = cast(v[k]) if k in v else ""
    return out


def read_parquet(paths, *, columns: Optional[List[str]] = None,
                 **_opts) -> Dataset:
    """Read parquet files (file, glob, or partitioned directory tree).

    Hive-style ``key=value`` path components materialize as partition
    columns with int/float type inference — for directory roots, globs,
    and explicit file lists alike (`ds.partitioning` analogue).
    """
    files = _expand_paths(paths, ".parquet")
    roots = [paths] if isinstance(paths, str) else list(paths)
    root = roots[0] if len(roots) == 1 and os.path.isdir(roots[0]) else None
    per_file = _typed_partitions(
        [_hive_partition_values(f, root) for f in files])

    def make_task(f, part_values):
        if columns is not None:
            part_values = {k: v for k, v in part_values.items()
                           if k in columns}
            # [] (not None) when only partition columns are projected:
            # None means read-everything to pyarrow.
            file_columns = [c for c in columns if c not in part_values]
        else:
            file_columns = None

        def task() -> List[Block]:
            import pyarrow.parquet as pq

            if "://" in f:
                with _open_path(f) as fh:
                    table = pq.read_table(fh, columns=file_columns)
            else:
                table = pq.read_table(f, columns=file_columns)
            block = dict(normalize_block(table))
            n = len(next(iter(block.values()))) if block else table.num_rows
            for k, v in part_values.items():  # paths -> columns
                block[k] = np.full(n, v)
            return [block]

        return task

    return _from_read_tasks(
        "ReadParquet",
        [make_task(f, pv) for f, pv in zip(files, per_file)])


def read_csv(paths, **read_opts) -> Dataset:
    files = _expand_paths(paths)

    def make_task(f):
        def task() -> List[Block]:
            import pandas as pd

            if "://" in f:
                with _open_path(f) as fh:
                    return [normalize_block(pd.read_csv(fh, **read_opts))]
            # Local paths go through pandas directly so its
            # compression-by-extension inference (.csv.gz) keeps working.
            return [normalize_block(pd.read_csv(f, **read_opts))]

        return task

    return _from_read_tasks("ReadCSV", [make_task(f) for f in files])


def read_json(paths, **read_opts) -> Dataset:
    files = _expand_paths(paths)

    def make_task(f):
        def task() -> List[Block]:
            import pandas as pd

            read_opts.setdefault("lines", True)
            if "://" in f:
                with _open_path(f) as fh:
                    return [normalize_block(pd.read_json(fh, **read_opts))]
            return [normalize_block(pd.read_json(f, **read_opts))]

        return task

    return _from_read_tasks("ReadJSON", [make_task(f) for f in files])


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


def read_images(paths, *, size=None, mode: str = "RGB",
                **_opts) -> Dataset:
    """Read image files into an ``image`` column of HWC uint8 arrays,
    decoded with PIL, and a ``path`` column. ``size``
    resizes to (width, height); images decode inside the read tasks.
    Directory/glob expansion keeps only image extensions (a stray
    README/.csv in the tree must not fail the read)."""
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".webp",
            ".tif", ".tiff")
    files = [f for f in _expand_paths(paths)
             if f.lower().endswith(exts)]
    if not files:
        raise FileNotFoundError(
            f"no image files ({'/'.join(exts)}) matched {paths}")

    def make_task(f):
        def task() -> List[Block]:
            import io

            from PIL import Image

            with _open_path(f) as fh:
                img = Image.open(io.BytesIO(fh.read())).convert(mode)
            if size is not None:
                img = img.resize(tuple(size))
            arr = np.asarray(img)
            col = np.empty(1, dtype=object)
            col[0] = arr
            return [{"image": col,
                     "path": np.asarray([f], dtype=object)}]

        return task

    return _from_read_tasks("ReadImages", [make_task(f) for f in files])


def read_datasource(datasource, *, parallelism: int = 8, **opts) -> Dataset:
    """Custom Datasource protocol: an object whose
    ``get_read_tasks(parallelism)`` returns callables -> List[Block]."""
    tasks = datasource.get_read_tasks(parallelism, **opts)
    return _from_read_tasks(type(datasource).__name__, tasks)
