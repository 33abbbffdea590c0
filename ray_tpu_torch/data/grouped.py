"""GroupBy and aggregations (counterpart of ``ray_tpu/data/grouped.py``).

``GroupedData.aggregate`` and ``map_groups`` run over a range-partitioned
shuffle on the key: each reduce task handles a disjoint key range, so the
ordered concatenation of the outputs is globally key-sorted."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.block import (
    Block,
    block_num_rows,
    block_take_indices,
    concat_blocks,
    normalize_block,
)
from ray_tpu_torch.data.executor import RangeShuffleOperator


class AggregateFn:
    def __init__(self, name: str, init, accumulate, finalize=None,
                 on: Optional[str] = None):
        self.name = name
        self.init = init
        self.accumulate = accumulate
        self.finalize = finalize or (lambda x: x)
        self.on = on


def Count():
    return AggregateFn("count()", lambda: 0,
                       lambda acc, vals: acc + len(vals))


def Sum(on: str):
    return AggregateFn(f"sum({on})", lambda: 0.0,
                       lambda acc, vals: acc + float(np.sum(vals)), on=on)


def Min(on: str):
    return AggregateFn(f"min({on})", lambda: np.inf,
                       lambda acc, vals: min(acc, float(np.min(vals))),
                       on=on)


def Max(on: str):
    return AggregateFn(f"max({on})", lambda: -np.inf,
                       lambda acc, vals: max(acc, float(np.max(vals))),
                       on=on)


def Mean(on: str):
    return AggregateFn(
        f"mean({on})", lambda: (0.0, 0),
        lambda acc, vals: (acc[0] + float(np.sum(vals)),
                           acc[1] + len(vals)),
        lambda acc: acc[0] / acc[1] if acc[1] else float("nan"), on=on)


def Std(on: str):
    return AggregateFn(
        f"std({on})", lambda: [],
        lambda acc, vals: acc + [np.asarray(vals)],
        lambda acc: float(np.std(np.concatenate(acc))) if acc else
        float("nan"), on=on)


class GroupedData:
    def __init__(self, dataset, key: str):
        self._dataset = dataset
        self._key = key

    def aggregate(self, *aggs: AggregateFn):
        key = self._key

        def fn(blocks: List[Block]) -> List[Block]:
            merged = concat_blocks(blocks)
            if block_num_rows(merged) == 0:
                return []
            keys = merged[key]
            uniq, inverse = np.unique(keys, return_inverse=True)
            out: Dict[str, list] = {key: list(uniq)}
            for agg in aggs:
                col: List = []
                for gi in range(len(uniq)):
                    mask = inverse == gi
                    acc = agg.init()
                    vals = (merged[agg.on][mask] if agg.on
                            else np.nonzero(mask)[0])
                    acc = agg.accumulate(acc, vals)
                    col.append(agg.finalize(acc))
                out[agg.name] = col
            return [{k: np.asarray(v) for k, v in out.items()}]

        from ray_tpu_torch.data.dataset import Dataset

        # Range-partitioned shuffle on the key: each reduce aggregates its
        # disjoint key range, so the ordered concat is globally key-sorted.
        return Dataset(self._dataset._operators + [
            RangeShuffleOperator(
                f"GroupByAggregate({key})", key,
                lambda parts, _p: fn(parts))])

    def count(self):
        return self.aggregate(Count())

    def sum(self, on: str):
        return self.aggregate(Sum(on))

    def mean(self, on: str):
        return self.aggregate(Mean(on))

    def min(self, on: str):
        return self.aggregate(Min(on))

    def max(self, on: str):
        return self.aggregate(Max(on))

    def map_groups(self, fn: Callable[[Block], Block]):
        key = self._key

        def gfn(blocks: List[Block]) -> List[Block]:
            merged = concat_blocks(blocks)
            if block_num_rows(merged) == 0:
                return []
            keys = merged[key]
            uniq, inverse = np.unique(keys, return_inverse=True)
            out: List[Block] = []
            for gi in range(len(uniq)):
                idx = np.nonzero(inverse == gi)[0]
                out.append(normalize_block(
                    fn(block_take_indices(merged, idx))))
            return out

        from ray_tpu_torch.data.dataset import Dataset

        return Dataset(self._dataset._operators + [
            RangeShuffleOperator(
                f"MapGroups({key})", key,
                lambda parts, _p: gfn(parts))])
