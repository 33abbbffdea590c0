"""Dataset: a lazy logical plan over columnar blocks (counterpart of
``ray_tpu/data/dataset.py``, on the one-process runtime).

Transforms append logical operations; consumption (materialize / take /
iter_batches / iter_torch_batches) plans and runs the streaming
executor. A MaterializedDataset pins its block refs so repeated
consumption is free. ``iter_torch_batches`` takes the place of the
reference's ``iter_jax_batches``: batches of tensors on the card (or
sharded over a mesh). Batches come as dicts of numpy arrays, pandas
DataFrames or Arrow tables (``batch_format``). The writers are
``write_parquet``, ``write_csv``, ``write_json``, ``write_tfrecords`` and
``write_datasink``; ``to_pandas`` gathers the whole dataset.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.data.block import (
    Block,
    BlockMetadata,
    block_num_rows,
    block_slice,
    block_take_indices,
    block_to_arrow,
    block_to_pandas,
    block_to_rows,
    concat_blocks,
    normalize_block,
)
from ray_tpu_torch.data.executor import (
    AllToAllOperator,
    LimitOperator,
    MapOperator,
    Operator,
    RangeShuffleOperator,
    ShuffleOperator,
    execute_plan,
    stream_plan,
)
from ray_tpu_torch.data.grouped import GroupedData
from ray_tpu_torch.data.logical import LogicalOp, LogicalPlan, physical_op
from ray_tpu_torch.data.stats import DatasetStats

BatchFormat = Union[str, None]


def _batch_from_block(block: Block, fmt: BatchFormat):
    if fmt in (None, "numpy", "default"):
        return dict(block)
    if fmt == "pandas":
        return block_to_pandas(block)
    if fmt == "pyarrow":
        return block_to_arrow(block)
    raise ValueError(f"unknown batch format {fmt!r}")


def _rebatch(blocks_iter: Iterator[Block], batch_size: Optional[int],
             drop_last: bool = False) -> Iterator[Block]:
    """Re-chunk a block stream into exact batch_size blocks."""
    if batch_size is None:
        yield from blocks_iter
        return
    buf: List[Block] = []
    buffered = 0
    for b in blocks_iter:
        n = block_num_rows(b)
        if n == 0:
            continue
        buf.append(b)
        buffered += n
        while buffered >= batch_size:
            merged = concat_blocks(buf)
            yield block_slice(merged, 0, batch_size)
            rest = block_slice(merged, batch_size, block_num_rows(merged))
            buf = [rest] if block_num_rows(rest) else []
            buffered = block_num_rows(rest)
    if buffered and not drop_last:
        yield concat_blocks(buf)


class Dataset:
    """A lazy pipeline: transforms append LOGICAL ops (data/logical.py);
    consumption optimizes the logical plan (fusion, limit pushdown) and
    only then plans physical operators for the streaming executor."""

    def __init__(self, plan):
        if isinstance(plan, LogicalPlan):
            self._logical = plan
        else:  # back-compat: a list of physical operators
            self._logical = LogicalPlan([physical_op(op) for op in plan])
        self._physical = None
        self._stats = None

    @property
    def _operators(self) -> List[Operator]:
        """The optimized physical plan (cached per Dataset instance)."""
        if self._physical is None:
            self._physical = self._logical.optimize().to_physical()
        return self._physical

    def explain(self) -> str:
        """Logical plan, optimized logical plan, and physical operators —
        the reference's plan-introspection surface."""
        opt = self._logical.optimize()
        phys = " -> ".join(op.name for op in opt.to_physical())
        return (f"Logical:   {self._logical.describe()}\n"
                f"Optimized: {opt.describe()}\n"
                f"Physical:  {phys}")

    # ------------------------------------------------------------ transforms
    def _append(self, op: Operator) -> "Dataset":
        return Dataset(self._logical.append(physical_op(op)))

    def _append_map(self, name: str, block_fn,
                    row_preserving: bool = False) -> "Dataset":
        return Dataset(self._logical.append(LogicalOp(
            kind="map", name=name, block_fn=block_fn,
            row_preserving=row_preserving,
            make_physical=lambda lo: MapOperator(lo.name, lo.block_fn))))

    def map_batches(self, fn: Callable, *, batch_size: Optional[int] = 4096,
                    batch_format: BatchFormat = None,
                    fn_args: tuple = (), fn_kwargs: Optional[dict] = None,
                    **_opts) -> "Dataset":
        fn_kwargs = fn_kwargs or {}

        def block_fn(block: Block) -> List[Block]:
            out: List[Block] = []
            n = block_num_rows(block)
            step = batch_size or max(n, 1)
            for start in range(0, max(n, 1), step):
                batch = block_slice(block, start, min(start + step, n))
                if block_num_rows(batch) == 0 and n > 0:
                    continue
                result = fn(_batch_from_block(batch, batch_format),
                            *fn_args, **fn_kwargs)
                out.append(normalize_block(result))
            return out or [block]

        return self._append_map(f"MapBatches({_name(fn)})", block_fn)

    def map(self, fn: Callable[[Dict], Dict], **_opts) -> "Dataset":
        def block_fn(block: Block) -> List[Block]:
            rows = [fn(r) for r in block_to_rows(block)]
            return [normalize_block(rows)] if rows else [block]

        return self._append_map(f"Map({_name(fn)})", block_fn,
                                row_preserving=True)

    def flat_map(self, fn: Callable[[Dict], List[Dict]], **_opts) -> "Dataset":
        def block_fn(block: Block) -> List[Block]:
            rows: List[Dict] = []
            for r in block_to_rows(block):
                rows.extend(fn(r))
            return [normalize_block(rows)] if rows else []

        return self._append_map(f"FlatMap({_name(fn)})", block_fn)

    def filter(self, fn: Callable[[Dict], bool], **_opts) -> "Dataset":
        def block_fn(block: Block) -> List[Block]:
            mask = np.asarray([bool(fn(r)) for r in block_to_rows(block)])
            if not mask.any():
                return []
            return [block_take_indices(block, np.nonzero(mask)[0])]

        return self._append_map(f"Filter({_name(fn)})", block_fn)

    def add_column(self, name: str, fn: Callable[[Dict], Any]) -> "Dataset":
        def block_fn(block: Block) -> List[Block]:
            vals = np.asarray([fn(r) for r in block_to_rows(block)])
            out = dict(block)
            out[name] = vals
            return [out]

        return self._append_map(f"AddColumn({name})", block_fn,
                                row_preserving=True)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def block_fn(block: Block) -> List[Block]:
            return [{k: v for k, v in block.items() if k not in cols}]

        return self._append_map(f"DropColumns({cols})", block_fn,
                                row_preserving=True)

    def select_columns(self, cols: List[str]) -> "Dataset":
        def block_fn(block: Block) -> List[Block]:
            return [{k: block[k] for k in cols}]

        return self._append_map(f"SelectColumns({cols})", block_fn,
                                row_preserving=True)

    def limit(self, n: int) -> "Dataset":
        return Dataset(self._logical.append(LogicalOp(
            kind="limit", name=f"Limit[{n}]", limit=n,
            make_physical=lambda lo: LimitOperator(lo.limit))))

    def repartition(self, num_blocks: int) -> "Dataset":
        def fn(blocks: List[Block]) -> List[Block]:
            merged = concat_blocks(blocks)
            n = block_num_rows(merged)
            if n == 0:
                return []
            per = math.ceil(n / num_blocks)
            return [block_slice(merged, i * per, min((i + 1) * per, n))
                    for i in range(num_blocks) if i * per < n]

        return self._append(AllToAllOperator(
            f"Repartition[{num_blocks}]", fn))

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        # Two-stage push shuffle: map tasks scatter rows to partitions,
        # reduce tasks permute each partition locally, with no
        # whole-dataset barrier on the driver. The seeds are the
        # reference's, so a seeded shuffle of the same blocks gives its
        # rows in its order.
        def partition(block: Block, P: int, idx: int) -> List[Block]:
            n = block_num_rows(block)
            rng = np.random.default_rng(
                None if seed is None else seed + idx * 9973)
            assign = rng.integers(0, P, size=n)
            return [block_take_indices(block, np.nonzero(assign == p)[0])
                    for p in range(P)]

        def reduce(parts: List[Block], p: int) -> List[Block]:
            merged = concat_blocks(parts)
            n = block_num_rows(merged)
            if n == 0:
                return []
            rng = np.random.default_rng(
                None if seed is None else seed * 31 + p)
            return [block_take_indices(merged, rng.permutation(n))]

        return self._append(ShuffleOperator(
            "RandomShuffle", partition, reduce))

    def sort(self, key: str, descending: bool = False) -> "Dataset":
        # Range-partitioned shuffle sort: sampled boundaries, per-range
        # reduce sorts, ordered concat is globally sorted.
        def reduce(parts: List[Block], _p: int) -> List[Block]:
            merged = concat_blocks(parts)
            if block_num_rows(merged) == 0:
                return []
            idx = np.argsort(merged[key], kind="stable")
            if descending:
                idx = idx[::-1]
            return [block_take_indices(merged, idx)]

        return self._append(RangeShuffleOperator(
            f"Sort({key})", key, reduce, descending=descending))

    def groupby(self, key: str) -> GroupedData:
        return GroupedData(self, key)

    def union(self, *others: "Dataset") -> "Dataset":
        all_ds = (self,) + others

        class UnionOperator(Operator):
            name = "Union"

            def execute(self, in_refs, stats):
                refs: List[Any] = []
                for ds in all_ds:
                    refs.extend(ds._materialize_refs())
                return refs

        return Dataset([UnionOperator()])

    def zip(self, other: "Dataset") -> "Dataset":
        left, right = self, other

        class ZipOperator(Operator):
            name = "Zip"

            def execute(self, in_refs, stats):
                lb = concat_blocks(
                    [rt.get(r) for r in left._materialize_refs()])
                rb = concat_blocks(
                    [rt.get(r) for r in right._materialize_refs()])
                if block_num_rows(lb) != block_num_rows(rb):
                    raise ValueError("zip requires equal row counts")
                out = dict(lb)
                for k, v in rb.items():
                    out[k if k not in out else f"{k}_1"] = v
                return [rt.put(out)]

        return Dataset([ZipOperator()])

    # ---------------------------------------------------------- consumption
    def _materialize_refs(self) -> List[Any]:
        rt.init(ignore_reinit_error=True)
        refs, stats = execute_plan(self._operators)
        self._stats = stats
        return refs

    def materialize(self) -> "MaterializedDataset":
        refs = self._materialize_refs()
        metas = [BlockMetadata.of(rt.get(r)) for r in refs]
        return MaterializedDataset(refs, metas, self._stats)

    def take(self, n: int = 20) -> List[Dict]:
        rows: List[Dict] = []
        for block in self.iter_blocks():
            rows.extend(block_to_rows(block))
            if len(rows) >= n:
                return rows[:n]
        return rows

    def take_all(self) -> List[Dict]:
        rows: List[Dict] = []
        for block in self.iter_blocks():
            rows.extend(block_to_rows(block))
        return rows

    def count(self) -> int:
        return sum(block_num_rows(b) for b in self.iter_blocks())

    def schema(self) -> Optional[Dict[str, str]]:
        for b in self.iter_blocks():
            if block_num_rows(b):
                return {k: str(v.dtype) for k, v in b.items()}
        return None

    def columns(self) -> Optional[List[str]]:
        s = self.schema()
        return list(s) if s else None

    def iter_blocks(self) -> Iterator[Block]:
        """Pull-based consumption: blocks stream out of the pipeline as
        they are produced (iter_batches over this never materializes the
        whole dataset)."""
        rt.init(ignore_reinit_error=True)
        stats = DatasetStats()
        for ref, _ in stream_plan(self._operators, stats=stats):
            yield rt.get(ref)
        self._stats = stats

    def iter_rows(self) -> Iterator[Dict]:
        for b in self.iter_blocks():
            yield from block_to_rows(b)

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: BatchFormat = None,
                     drop_last: bool = False) -> Iterator[Any]:
        for b in _rebatch(self.iter_blocks(), batch_size, drop_last):
            yield _batch_from_block(b, batch_format)

    def iter_torch_batches(self, *, batch_size: Optional[int] = 256,
                           drop_last: bool = True, device="cuda",
                           sharding=None) -> Iterator[Dict[str, Any]]:
        """Batches as dicts of tensors on ``device`` (the counterpart of
        the reference's ``iter_jax_batches``). With ``sharding=(mesh,
        spec)`` each column is cut by ``spec`` over the mesh instead
        (``parallel.sharding.shard_tensor``: a list of per-shard tensors
        in ``mesh.devices.flat`` order), as the reference places it with
        ``jax.device_put(v, sharding)``. Columns keep numpy's dtype (an
        int64 column stays int64, which the embedding lookup takes); the
        reference's JAX, without x64, turns int64 into int32."""
        if sharding is not None:
            from ray_tpu_torch.parallel.sharding import shard_tensor

            mesh, spec = sharding

            def place(v):
                return shard_tensor(torch.tensor(v), mesh, spec)
        else:
            from ray_tpu_torch.device import resolve_device

            dev = resolve_device(device)

            def place(v):
                return torch.tensor(v, device=dev)
        for batch in self.iter_batches(batch_size=batch_size,
                                       drop_last=drop_last):
            yield {k: place(v) for k, v in batch.items()}

    def split(self, n: int) -> List["MaterializedDataset"]:
        mat = self.materialize()
        merged = concat_blocks([rt.get(r) for r in mat._refs])
        total = block_num_rows(merged)
        per = math.ceil(total / n) if total else 0
        out = []
        for i in range(n):
            piece = block_slice(
                merged, min(i * per, total), min((i + 1) * per, total))
            ref = rt.put(piece)
            out.append(MaterializedDataset(
                [ref], [BlockMetadata.of(piece)], None))
        return out

    def streaming_split(self, n: int) -> List["MaterializedDataset"]:
        """Split by assigning whole blocks round-robin (greedy by rows) —
        no merge/re-slice of the dataset, so shards stream their blocks
        directly (the train-ingest path; reference: streaming_split
        returns block-iterators per consumer)."""
        mat = self.materialize()
        shard_refs: List[List[Any]] = [[] for _ in range(n)]
        shard_metas: List[List[BlockMetadata]] = [[] for _ in range(n)]
        shard_rows = [0] * n
        pairs = sorted(zip(mat._refs, mat._metas),
                       key=lambda rm: -rm[1].num_rows)
        for ref, meta in pairs:  # largest block to lightest shard
            i = shard_rows.index(min(shard_rows))
            shard_refs[i].append(ref)
            shard_metas[i].append(meta)
            shard_rows[i] += meta.num_rows
        return [MaterializedDataset(shard_refs[i], shard_metas[i], None)
                for i in range(n)]

    # --------------------------------------------------------------- writes
    @staticmethod
    def _out_fs(path: str):
        """(filesystem, stripped path) with the output dir ensured: write
        paths accept any registered scheme (local, memory://, fsspec)."""
        from ray_tpu_torch.data.filesystem import resolve_filesystem

        fs, p = resolve_filesystem(path)
        fs.makedirs(p)
        return fs, p.rstrip("/")

    def write_parquet(self, path: str) -> None:
        import pyarrow.parquet as pq

        fs, p = self._out_fs(path)
        for i, block in enumerate(self.iter_blocks()):
            with fs.open(f"{p}/part-{i:05d}.parquet", "wb") as fh:
                pq.write_table(block_to_arrow(block), fh)

    def write_csv(self, path: str) -> None:
        fs, p = self._out_fs(path)
        for i, block in enumerate(self.iter_blocks()):
            text = block_to_pandas(block).to_csv(index=False)
            with fs.open(f"{p}/part-{i:05d}.csv", "wb") as fh:
                fh.write(text.encode())

    def write_json(self, path: str) -> None:
        fs, p = self._out_fs(path)
        for i, block in enumerate(self.iter_blocks()):
            text = block_to_pandas(block).to_json(
                orient="records", lines=True)
            with fs.open(f"{p}/part-{i:05d}.json", "wb") as fh:
                fh.write(text.encode())

    def write_tfrecords(self, path: str) -> None:
        """Write blocks as TFRecord files of tf.train.Example protos (one
        file per block; no tensorflow dependency)."""
        from ray_tpu_torch.data.tfrecords import encode_example, write_record

        fs, p = self._out_fs(path)
        for i, block in enumerate(self.iter_blocks()):
            with fs.open(f"{p}/part-{i:05d}.tfrecords", "wb") as fh:
                n = block_num_rows(block)
                for r in range(n):
                    row = {k: v[r] for k, v in block.items()}
                    write_record(fh, encode_example(row))

    def write_datasink(self, sink) -> list:
        """Stream this dataset's blocks into a custom Datasink with the
        start/complete/failure lifecycle: ``on_write_failed`` sees the
        error before it re-raises."""
        sink.on_write_start()
        results = []
        try:
            for block in self.iter_blocks():
                results.append(sink.write([block]))
        except Exception as exc:
            try:
                sink.on_write_failed(exc)
            except Exception:  # noqa: BLE001 — a bug in the sink's hook
                pass
            raise
        sink.on_write_complete(results)
        return results

    def to_pandas(self):
        return block_to_pandas(
            concat_blocks(list(self.iter_blocks())))

    def stats(self) -> str:
        if self._stats is None:
            self._materialize_refs()
        return self._stats.summary()

    def __repr__(self):
        names = [op.name for op in self._operators]
        return f"Dataset(plan={' -> '.join(names)})"


class MaterializedDataset(Dataset):
    """Dataset with pinned block refs; re-consumption skips execution."""

    def __init__(self, refs: List[Any], metas: List[BlockMetadata], stats):
        class _Pinned(Operator):
            name = "Pinned"

            def execute(self, in_refs, s):
                return refs

        super().__init__([_Pinned()])
        self._refs = refs
        self._metas = metas
        self._stats = stats

    def num_blocks(self) -> int:
        return len(self._refs)

    def count(self) -> int:
        return sum(m.num_rows for m in self._metas)

    def size_bytes(self) -> int:
        return sum(m.size_bytes for m in self._metas)


def _name(fn) -> str:
    return getattr(fn, "__name__", type(fn).__name__)
