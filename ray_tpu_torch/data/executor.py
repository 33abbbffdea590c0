"""Streaming executor (counterpart of ``ray_tpu/data/executor.py``, on
the one-process runtime's tasks and streaming generators).

A driver scheduling loop pumps a pipeline of operators connected by
bounded queues of **RefBundles**, ``(block_ref, num_rows)`` pairs. Blocks
never round-trip through the driver between map-class stages:

- map/read tasks ``put`` their output blocks task-side and yield only
  the (ref, rows) metadata, so the driver handles bytes only at an
  explicit sink (``iter_*``/``take``);
- every streaming operator dispatches as soon as it has input and budget:
  operator 2 starts on operator 1's first completed block, not after its
  last;
- backpressure is two-sided: per-operator ``max_in_flight`` tasks plus a
  bounded inter-operator queue, and the sink generator only pumps the
  loop when the consumer pulls (``iter_batches`` streams end to end);
- all-to-all operators (sort/shuffle/groupby/repartition) remain
  barriers by nature: they run when their upstream completes, as
  parallel task fan-outs whose reduce outputs are again task-side puts.

Block order is part of the Dataset contract: completions are harvested
in submission order per operator (head-of-line), which preserves order
while still overlapping stages.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np

import ray_tpu_torch as rt
from ray_tpu_torch.data.block import (
    Block,
    block_num_rows,
    block_take_indices,
)
from ray_tpu_torch.data.logical import _compose
from ray_tpu_torch.data.stats import DatasetStats, OpStats

# The unit flowing between operators: (block ObjectRef, row count).
RefBundle = Tuple[Any, int]


class Operator:
    """Physical operator base. Streaming operators implement the
    dispatch/harvest pair; barrier operators implement execute() (refs
    in, refs out) or execute_bundles() when they know row counts."""

    name = "op"
    streaming = False

    def execute(self, in_refs: List[Any], stats: DatasetStats) -> List[Any]:
        raise NotImplementedError

    def execute_bundles(self, in_bundles: List["RefBundle"],
                        stats: DatasetStats) -> List["RefBundle"]:
        """Barrier entry point for the streaming loop. Default adapts
        legacy execute(); rows of unknown-count outputs stay None (the
        sink passes None through — nothing fetches blocks to count)."""
        refs = self.execute([r for r, _ in in_bundles], stats)
        return [(r, None) for r in refs]


def _put_blocks_remote(blocks: List[Block]) -> List[RefBundle]:
    """Task-side block publication: store each output block from inside
    the task and ship only (ref, rows) metadata back."""
    return [(rt.put(b), block_num_rows(b)) for b in blocks]


def _stream_blocks_remote(blocks) -> Iterator[RefBundle]:
    """Task-side block publication on the STREAMING plane: each output
    block is put task-side and its (ref, rows) metadata yielded — one
    committed item per block, so the driver harvests block 0 (and
    downstream operators dispatch on it) while this task is still
    producing block 1."""
    for b in blocks:
        yield (rt.put(b), block_num_rows(b))


def _drain_stream(gen) -> Tuple[List[RefBundle], bool]:
    """Non-blocking incremental harvest of one map/read task's item
    stream: returns the bundles whose yields have committed so far and
    whether the stream is exhausted. Unlike the old num_returns-list
    protocol, bundles are consumable BEFORE the producing task finishes."""
    bundles: List[RefBundle] = []
    while True:
        try:
            ref = gen.try_next()
        except StopIteration:
            return bundles, True
        if ref is None:
            return bundles, False
        bundles.append(tuple(rt.get(ref)))


class MapOperator(Operator):
    """Streaming task-pool map over block refs. Map tasks run with
    ``num_returns="streaming"``: every output block's (ref, rows)
    metadata commits per yield, so a multi-block map task feeds its
    downstream operator block by block instead of at task completion."""

    streaming = True

    def __init__(self, name: str, block_fn: Callable[[Block], List[Block]],
                 max_in_flight: int = 8):
        self.name = name
        self._block_fn = block_fn
        self._max_in_flight = max_in_flight
        fn = block_fn

        @rt.remote
        def _apply(block):
            yield from _stream_blocks_remote(fn(block))

        self._task = _apply

    # streaming interface ---------------------------------------------------
    def num_inputs(self) -> Optional[int]:
        return None  # consumes upstream bundles

    def dispatch(self, item: RefBundle):
        ref, _ = item
        return self._task.options(num_returns="streaming").remote(ref)


class InputOperator(Operator):
    """Source: produces blocks from read tasks (executed remotely on the
    streaming plane — the first block of a many-block read task is
    downstream-visible before the read finishes)."""

    streaming = True

    def __init__(self, name: str,
                 read_tasks: List[Callable[[], List[Block]]],
                 max_in_flight: int = 8):
        self.name = name
        self._read_tasks = read_tasks
        self._max_in_flight = max_in_flight

        @rt.remote
        def _read(task):
            yield from _stream_blocks_remote(task())

        self._task = _read

    def num_inputs(self) -> Optional[int]:
        return len(self._read_tasks)

    def dispatch(self, item):
        # item is a read-task callable
        return self._task.options(num_returns="streaming").remote(item)


def fuse_plan(operators: List[Operator]) -> List[Operator]:
    """Map fusion (reference role: the logical-plan OperatorFusionRule):
    adjacent map-class operators collapse into ONE task per block, and a
    map directly after a read fuses into the read task itself — so a
    ``read -> map -> map_batches`` pipeline costs one task per block, not
    three."""
    fused: List[Operator] = []
    for op in operators:
        prev = fused[-1] if fused else None
        if isinstance(op, MapOperator) and isinstance(prev, MapOperator):
            fused[-1] = MapOperator(
                f"{prev.name}->{op.name}",
                _compose(prev._block_fn, op._block_fn),
                max_in_flight=min(prev._max_in_flight, op._max_in_flight))
            continue
        if isinstance(op, MapOperator) and isinstance(prev, InputOperator):
            g = op._block_fn

            def _wrap(task, g=g):
                def read_then_map():
                    out = []
                    for b in task():
                        out.extend(g(b))
                    return out

                return read_then_map

            fused[-1] = InputOperator(
                f"{prev.name}->{op.name}",
                [_wrap(t) for t in prev._read_tasks],
                max_in_flight=prev._max_in_flight)
            continue
        fused.append(op)
    return fused


class ShuffleOperator(Operator):
    """Two-stage push shuffle: map tasks partition each input block into
    P parts, then one reduce task per partition combines its parts from
    every map. Both stages run as parallel tasks; reduce outputs are
    task-side puts, so the driver never touches block bytes."""

    MAX_PARTITIONS = 32

    def __init__(self, name: str, partition_fn, reduce_fn):
        self.name = name
        self._partition_fn = partition_fn  # (block, P, block_idx) -> [P]
        self._reduce_fn = reduce_fn        # (List[Block], p) -> List[Block]

    def _choose_partitions(self, in_refs) -> int:
        return min(max(len(in_refs), 1), self.MAX_PARTITIONS)

    def execute_bundles(self, in_bundles, stats):
        t0 = time.perf_counter()
        in_refs = [r for r, _ in in_bundles]
        if not in_refs:
            stats.ops.append(OpStats(self.name, 0.0, 0, 0))
            return []
        P = self._choose_partitions(in_refs)
        part = self._partition_fn
        red = self._reduce_fn

        @rt.remote
        def _map(block, idx):
            # Part p's ref commits as soon as it is yielded, so reduce p
            # dispatches while this task still emits parts p+1..P-1.
            yield from part(block, P, idx)

        @rt.remote
        def _reduce(p, *parts):
            return _put_blocks_remote(red(list(parts), p))

        map_gens = [
            _map.options(num_returns="streaming").remote(ref, i)
            for i, ref in enumerate(in_refs)
        ]
        out: List[RefBundle] = []
        rows = 0
        reduce_refs = []
        # Opportunistic harvest instead of lockstep next(): with a
        # backpressure budget < P, maps holding every worker slot park at
        # the budget while a not-yet-scheduled map's first yield is
        # awaited, and a strict round-robin next() deadlocks there.
        # Draining whichever map has committed parts keeps every
        # producer's acks flowing; reduce p still launches on every map's
        # p-th yield.
        parts: List[List] = [[] for _ in map_gens]
        done = [False] * len(map_gens)
        next_p = 0
        while next_p < P:
            progressed = False
            for mi, gen in enumerate(map_gens):
                while not done[mi]:
                    try:
                        ref = gen.try_next()
                    except StopIteration:
                        done[mi] = True
                        if len(parts[mi]) < P:
                            raise RuntimeError(
                                f"shuffle map {mi} of {self.name!r} "
                                f"yielded {len(parts[mi])} partitions, "
                                f"expected {P}")
                        break
                    if ref is None:
                        break
                    parts[mi].append(ref)
                    progressed = True
            while next_p < P and all(len(b) > next_p for b in parts):
                reduce_refs.append(_reduce.remote(
                    next_p, *[b[next_p] for b in parts]))
                next_p += 1
                progressed = True
            if next_p < P and not progressed:
                pending = [r for mi, gen in enumerate(map_gens)
                           if not done[mi] for r in gen.wait_refs()]
                if pending:
                    rt.wait(pending, num_returns=1, timeout=1.0)
        for mi, gen in enumerate(map_gens):
            if not done[mi]:  # settle the end markers (errors re-raise)
                for _ in gen:
                    pass
        for rref in reduce_refs:  # partition order IS output order
            for ref, n in rt.get(rref):
                rows += n
                out.append((ref, n))
        stats.ops.append(OpStats(
            name=self.name, wall_s=time.perf_counter() - t0,
            output_blocks=len(out), output_rows=rows))
        return out


class RangeShuffleOperator(ShuffleOperator):
    """Range-partitioned shuffle: samples the key column to pick P-1
    boundaries, partitions by ``searchsorted``, reduces per range, so
    the ordered concatenation of partition outputs is globally
    key-ordered (what sort and sorted groupby need)."""

    def __init__(self, name: str, key: str, reduce_fn,
                 descending: bool = False):
        self.key = key
        self.descending = descending
        super().__init__(name, None, reduce_fn)

    def execute_bundles(self, in_bundles, stats):
        in_refs = [r for r, _ in in_bundles]
        if not in_refs:
            stats.ops.append(OpStats(self.name, 0.0, 0, 0))
            return []
        P = self._choose_partitions(in_refs)
        key, desc = self.key, self.descending

        @rt.remote
        def _sample(block):
            vals = np.asarray(block[key])
            if len(vals) == 0:
                return vals
            k = min(len(vals), 64)
            sel = np.linspace(0, len(vals) - 1, k).astype(np.int64)
            return np.sort(vals)[sel]

        samples = np.concatenate(
            [np.asarray(s) for s in
             rt.get([_sample.remote(r) for r in in_refs])])
        if len(samples) and P > 1:
            samples = np.sort(samples)
            if samples.dtype.kind in "iuf":
                qs = np.linspace(0.0, 1.0, P + 1)[1:-1]
                bounds = np.quantile(samples, qs)
            else:  # strings etc.: evenly spaced sorted sample elements
                sel = np.linspace(0, len(samples) - 1, P + 1)[1:-1]
                bounds = samples[sel.astype(np.int64)]
        else:
            bounds = np.asarray([])

        def partition(block, P, _idx, bounds=bounds):
            vals = np.asarray(block[key])
            pidx = np.searchsorted(bounds, vals, side="right")
            if desc:
                pidx = (P - 1) - pidx
            return [block_take_indices(block, np.nonzero(pidx == p)[0])
                    for p in range(P)]

        self._partition_fn = partition
        return super().execute_bundles(in_bundles, stats)


class AllToAllOperator(Operator):
    """Barrier operator: consumes all blocks, emits a new block list.
    Runs driver-side (whole-dataset reshapes like repartition, where one
    function sees every block)."""

    def __init__(self, name: str,
                 fn: Callable[[List[Block]], List[Block]]):
        self.name = name
        self._fn = fn

    def execute(self, in_refs, stats):
        t0 = time.perf_counter()
        blocks = [rt.get(r) for r in in_refs]
        out_blocks = self._fn(blocks)
        refs = [rt.put(b) for b in out_blocks]
        rows = sum(block_num_rows(b) for b in out_blocks)
        stats.ops.append(OpStats(
            name=self.name, wall_s=time.perf_counter() - t0,
            output_blocks=len(refs), output_rows=rows))
        return refs


class LimitOperator(Operator):
    """Streaming limit with early termination: passes bundles through by
    metadata until the limit is hit, slices the boundary block in a task,
    then tells the scheduler to stop pumping upstream."""

    streaming = True

    def __init__(self, limit: int):
        self.name = f"Limit[{limit}]"
        self._limit = limit

    def num_inputs(self) -> Optional[int]:
        return None


@rt.remote
def _limit_slice(block, n):
    return [(rt.put({k: v[:n] for k, v in block.items()}), n)]


# --------------------------------------------------------------------------
# The streaming scheduling loop
# --------------------------------------------------------------------------
class _OpState:
    __slots__ = ("op", "inputs", "inflight", "done", "started_at", "rows",
                 "blocks", "source_items", "finished_at", "truncated")

    def __init__(self, op):
        self.op = op
        self.inputs: deque = deque()
        self.inflight: deque = deque()  # FIFO of out_refs (order contract)
        self.done = False
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.rows = 0
        self.blocks = 0
        self.truncated = False  # limit hit: stop pumping upstream
        n = op.num_inputs() if op.streaming else None
        if op.streaming and n is not None:
            self.source_items = deque(op._read_tasks)
        else:
            self.source_items = None


def stream_plan(operators: List[Operator], *,
                stats: Optional[DatasetStats] = None
                ) -> Iterator[RefBundle]:
    """Generator over the sink's RefBundles, produced as the pipeline
    streams. Pumps the scheduling loop only when the consumer pulls
    (pull-based sink); abandoning the generator stops further dispatch."""
    ops = fuse_plan(operators)
    st: List[_OpState] = [_OpState(op) for op in ops]
    t_start = time.perf_counter()
    out: deque = deque()  # sink bundles ready to yield
    _stats = stats if stats is not None else DatasetStats()

    def _upstream_done(i: int) -> bool:
        return i == 0 or st[i - 1].done

    def _record(i: int):
        s = st[i]
        if s.finished_at is None:
            s.finished_at = time.perf_counter()
            _stats.ops.append(OpStats(
                name=s.op.name,
                wall_s=s.finished_at - (s.started_at or s.finished_at),
                output_blocks=s.blocks, output_rows=s.rows))

    def _push_down(i: int, bundles: List[RefBundle]):
        s = st[i]
        s.blocks += len(bundles)
        s.rows += sum(n for _, n in bundles)
        if i + 1 < len(st):
            st[i + 1].inputs.extend(bundles)
        else:
            out.extend(bundles)

    def _pump_once() -> bool:
        progress = False
        for i, s in enumerate(st):
            if s.done:
                continue
            op = s.op
            if not op.streaming:
                # Barrier: runs once when its upstream is exhausted.
                if _upstream_done(i) and not s.inflight:
                    s.started_at = time.perf_counter()
                    in_bundles = list(s.inputs)
                    s.inputs.clear()
                    metas = op.execute_bundles(in_bundles, _stats)
                    # Barrier stats were recorded by execute_bundles();
                    # unknown row counts stay None (nothing fetches
                    # blocks just to count them).
                    s.blocks += len(metas)
                    s.done = True
                    s.finished_at = time.perf_counter()
                    if i + 1 < len(st):
                        st[i + 1].inputs.extend(metas)
                    else:
                        out.extend(metas)
                    progress = True
                continue
            if isinstance(op, LimitOperator):
                progress |= _pump_limit(i, s)
                continue
            # Harvest head-of-line streams (order preservation): the head
            # task's committed yields flow downstream IMMEDIATELY — block
            # 0 dispatches into operator i+1 while the producing task is
            # still emitting block 1. Later tasks' streams buffer in their
            # generators until the head finishes (order contract).
            while s.inflight:
                head = s.inflight[0]
                got, exhausted = _drain_stream(head)
                if got:
                    _push_down(i, got)
                    progress = True
                if not exhausted:
                    break
                s.inflight.popleft()
                progress = True
            # Dispatch while input + budget + downstream headroom exist.
            # The queue cap only applies when downstream consumes
            # incrementally (streaming op or the pull-based sink): a
            # barrier needs EVERY upstream bundle before it runs, so
            # capping its input queue would deadlock the pipeline.
            budget = op._max_in_flight
            down_cap = 2 * budget + 8
            if i + 1 < len(st):
                downstream_len = (len(st[i + 1].inputs)
                                  if st[i + 1].op.streaming else -1)
            else:
                downstream_len = len(out)
            if downstream_len < 0:
                downstream_len, down_cap = 0, float("inf")
            while len(s.inflight) < budget and downstream_len < down_cap:
                if s.source_items is not None:
                    if not s.source_items:
                        break
                    item = s.source_items.popleft()
                elif s.inputs:
                    item = s.inputs.popleft()
                else:
                    break
                if s.started_at is None:
                    s.started_at = time.perf_counter()
                s.inflight.append(op.dispatch(item))
                downstream_len += 1
                progress = True
            # Completion: no pending input anywhere and upstream is done.
            if not s.inflight and not s.inputs and (
                    s.source_items is not None and not s.source_items
                    or s.source_items is None and _upstream_done(i)):
                s.done = True
                _record(i)
                progress = True
        return progress

    def _pump_limit(i: int, s) -> bool:
        op: LimitOperator = s.op
        progress = False
        # Boundary slice in flight: harvest it.
        while s.inflight:
            head = s.inflight[0]
            ready, _ = rt.wait([head], num_returns=1, timeout=0)
            if not ready:
                break
            s.inflight.popleft()
            _push_down(i, list(rt.get(head)))
            progress = True
        remaining = op._limit - s.rows
        while s.inputs and remaining > 0 and not s.inflight:
            ref, n = s.inputs.popleft()
            if s.started_at is None:
                s.started_at = time.perf_counter()
            if n is None:  # barrier upstream: resolve the count now
                n = block_num_rows(rt.get(ref))
            if n <= remaining:
                _push_down(i, [(ref, n)])
                remaining -= n
            else:
                s.inflight.append(_limit_slice.remote(ref, remaining))
                remaining = 0
            progress = True
        if remaining <= 0 and not s.inflight and not s.truncated:
            # Early termination: upstream work is moot.
            s.truncated = True
            for j in range(i):
                st[j].done = True
                st[j].inputs.clear()
                if st[j].source_items is not None:
                    st[j].source_items.clear()
                st[j].inflight.clear()
                _record(j)
            s.done = True
            _record(i)
            progress = True
        elif not s.inflight and not s.inputs and _upstream_done(i):
            s.done = True
            _record(i)
            progress = True
        return progress

    try:
        while True:
            while out:
                # Unknown counts (barrier outputs) pass through as None —
                # consumers that only want refs must not force a driver
                # fetch of every block just to count rows.
                yield out.popleft()
            if all(s.done for s in st) and not out:
                break
            if not _pump_once() and not out:
                # Nothing completed and nothing dispatchable: block
                # briefly on ANY in-flight task instead of spinning.
                # Streaming map/read tasks contribute their next-item +
                # end-marker refs, so a mid-task yield wakes the loop.
                refs = []
                for s in st:
                    for h in s.inflight:
                        if isinstance(h, rt.ObjectRefGenerator):
                            refs.extend(h.wait_refs())
                        else:
                            refs.append(h)
                if refs:
                    rt.wait(refs, num_returns=1, timeout=0.1)
    finally:
        _stats.total_wall_s = time.perf_counter() - t_start


def execute_plan(operators: List[Operator]
                 ) -> Tuple[List[Any], DatasetStats]:
    stats = DatasetStats()
    refs = [ref for ref, _ in stream_plan(operators, stats=stats)]
    return refs, stats
