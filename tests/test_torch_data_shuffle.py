"""Twins of the reference's all-to-all Data operators
(``tests/test_data.py:54-84``, ``:153-195`` and ``:452``) at small sizes,
on the CPU.

Both runtimes run in one process (the reference on
``ray_tpu.init(worker_mode="thread")``); each case builds the same
pipeline with each side's ``data`` module, and the rows must come back
equal and in the same order: a seeded ``random_shuffle`` uses the
reference's seeds (``seed + idx*9973`` per map, ``seed*31 + p`` per
reduce), ``sort`` and ``groupby`` the same sampled range boundaries.
Aggregates are held against numpy on the same table as well, within
``AGG_RTOL`` (both sides sum each group's values in the table's order,
so they agree exactly in practice; the bound allows for a different
pairwise grouping of the same float64 sums). Every wait is bounded by
the runtimes' own timeouts; nothing asserts on wall time.
"""

import math

import numpy as np
import pytest

import ray_tpu
import ray_tpu.data as jd
import ray_tpu_torch
import ray_tpu_torch.data as td
from ray_tpu._private.config import GlobalConfig as RefConfig
from ray_tpu.data import executor as jexec
from ray_tpu_torch._private.config import GlobalConfig as PortConfig
from ray_tpu_torch.data import executor as texec

AGG_RTOL = 1e-12


@pytest.fixture
def runtimes():
    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()
    ray_tpu.init(num_cpus=4, worker_mode="thread", ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4)
    try:
        yield
    finally:
        for rt in (ray_tpu, ray_tpu_torch):
            rt.shutdown()


def _plain(value):
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    if isinstance(value, (np.ndarray, np.generic)):
        return value.tolist()
    return value


def _twin(case):
    ref, port = _plain(case(jd)), _plain(case(td))
    assert port == ref
    return ref


def _table(n=240, seed=5):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 50, n).astype(np.int64)
    return {"key": key, "bucket": key % 7,
            "x": rng.standard_normal(n).astype(np.float32),
            "name": np.asarray([f"n{int(k) % 5}" for k in key])}


SHUFFLE_SOURCES = {
    "range_repartitioned": lambda d: d.range(500).repartition(8),
    "range_blocks": lambda d: d.range(64, parallelism=6),
    "table": lambda d: d.from_columns(_table(), parallelism=5),
    "one_block": lambda d: d.from_items([{"x": v} for v in [5, 3, 1, 4, 2]]),
}


@pytest.mark.parametrize("seed", [0, 7, 24])
@pytest.mark.parametrize("source", sorted(SHUFFLE_SOURCES))
def test_random_shuffle_seeded_equals_reference(runtimes, source, seed):
    def case(d):
        ds = SHUFFLE_SOURCES[source](d)
        return ds.take_all(), ds.random_shuffle(seed=seed).take_all()

    before, after = _twin(case)
    # A permutation of the rows.
    key = sorted(before[0])[0]
    assert sorted(r[key] for r in after) == sorted(r[key] for r in before)
    assert len(after) == len(before)


def test_random_shuffle_is_deterministic_and_permutes(runtimes):
    once = [r["id"] for r in
            td.range(500).repartition(8).random_shuffle(seed=7).take_all()]
    again = [r["id"] for r in
             td.range(500).repartition(8).random_shuffle(seed=7).take_all()]
    assert once == again and once != list(range(500))
    assert sorted(once) == list(range(500))
    unseeded = [r["id"] for r in
                td.range(500).repartition(8).random_shuffle().take_all()]
    assert sorted(unseeded) == list(range(500))


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("key", ["key", "x", "name"])
def test_sort_equals_reference_and_stable_argsort(runtimes, key,
                                                  descending):
    table = _table()

    def case(d):
        return [r[key] for r in d.from_columns(table, parallelism=6)
                .sort(key, descending=descending).take_all()]

    got = _twin(case)
    order = np.argsort(table[key], kind="stable")
    want = table[key][order]
    if descending:
        want = want[::-1]
    assert got == want.tolist()


def test_sort_small_and_multi_block(runtimes):
    def case(d):
        ds = d.from_items([{"x": v} for v in [5, 3, 1, 4, 2]])
        rng = np.random.default_rng(3)
        vals = rng.permutation(400).astype(np.int64)
        multi = d.from_columns({"v": vals}).repartition(8)
        return ([r["x"] for r in ds.sort("x").take_all()],
                [r["x"] for r in ds.sort("x", descending=True).take_all()],
                [r["v"] for r in multi.sort("v").take_all()],
                [r["v"] for r in multi.sort("v", descending=True)
                 .take_all()])

    up, down, multi_up, multi_down = _twin(case)
    assert up == [1, 2, 3, 4, 5] and down == [5, 4, 3, 2, 1]
    assert multi_up == list(range(400))
    assert multi_down == list(range(399, -1, -1))


def _aggs(d):
    return (d.Count(), d.Sum("x"), d.Mean("x"), d.Min("x"), d.Max("x"),
            d.Std("x"))


@pytest.mark.parametrize("key", ["bucket", "name"])
def test_groupby_every_aggregate(runtimes, key):
    table = _table()

    def case(d):
        return d.from_columns(table, parallelism=4).groupby(key).aggregate(
            *_aggs(d)).take_all()

    rows = _twin(case)
    keys = table[key]
    assert [r[key] for r in rows] == sorted(set(keys.tolist()))
    for r in rows:
        x = table["x"][keys == r[key]]
        assert r["count()"] == len(x)
        np.testing.assert_allclose(
            [r["sum(x)"], r["mean(x)"], r["min(x)"], r["max(x)"],
             r["std(x)"]],
            [float(np.sum(x)), float(np.sum(x)) / len(x), float(x.min()),
             float(x.max()), float(np.std(x))], rtol=AGG_RTOL)


def test_groupby_aggregate_small(runtimes):
    def case(d):
        ds = d.from_items([{"k": i % 3, "x": float(i)} for i in range(30)])
        return ds.groupby("k").aggregate(d.Sum("x"), d.Count()).take_all()

    out = _twin(case)
    by_k = {r["k"]: r for r in out}
    assert len(out) == 3
    assert by_k[0]["sum(x)"] == sum(float(i) for i in range(30) if i % 3 == 0)
    assert by_k[1]["count()"] == 10


def test_groupby_string_keys_range_shuffle(runtimes):
    keys = ["pear", "apple", "plum", "apple", "pear", "apple"]

    def case(d):
        ds = d.from_columns({"k": keys, "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]})
        return ds.repartition(3).groupby("k").aggregate(d.Sum("v")).take_all()

    out = _twin(case)
    assert {r["k"]: r["sum(v)"] for r in out} == {
        "apple": 12.0, "pear": 6.0, "plum": 3.0}
    assert [r["k"] for r in out] == sorted(set(keys))


@pytest.mark.parametrize("method", ["count", "sum", "mean", "min", "max"])
def test_groupby_shortcuts(runtimes, method):
    table = _table(120, seed=8)

    def case(d):
        g = d.from_columns(table, parallelism=3).groupby("bucket")
        return (g.count() if method == "count"
                else getattr(g, method)("x")).take_all()

    rows = _twin(case)
    assert [r["bucket"] for r in rows] == sorted(set(table["bucket"].tolist()))


def test_map_groups(runtimes):
    table = _table(90, seed=9)

    def case(d):
        return d.from_columns(table, parallelism=3).groupby("bucket") \
            .map_groups(lambda g: {"bucket": g["bucket"][:1],
                                   "n": np.asarray([len(g["x"])]),
                                   "top": np.asarray([g["x"].max()])}) \
            .take_all()

    rows = _twin(case)
    for r in rows:
        x = table["x"][table["bucket"] == r["bucket"]]
        assert r["n"] == len(x) and r["top"] == float(x.max())


@pytest.mark.parametrize("n", [1, 3, 5, 7, 16])
def test_repartition(runtimes, n):
    def case(d):
        ds = d.range(100, parallelism=3).repartition(n)
        mat = ds.materialize()
        return (mat.num_blocks(), [len(b["id"]) for b in ds.iter_blocks()],
                ds.take_all())

    blocks, sizes, rows = _twin(case)
    # Blocks of ceil(100 / n) rows: 16 asked for makes 15 of 7 rows or
    # fewer, as in the reference.
    assert blocks == math.ceil(100 / math.ceil(100 / n)) and sum(sizes) == 100
    assert [r["id"] for r in rows] == list(range(100))


def test_zip_lines_rows_up_and_refuses_unequal(runtimes):
    def case(d):
        z = d.from_columns({"a": np.arange(4)}).zip(
            d.from_columns({"b": np.arange(4) * 10}))
        clash = d.range(6, parallelism=2).zip(d.range(6, parallelism=3))
        try:
            d.range(5).zip(d.range(6)).take_all()
            err = None
        except ValueError as exc:
            err = str(exc)
        return z.take_all(), clash.take_all(), err

    rows, clash, err = _twin(case)
    assert rows[2] == {"a": 2, "b": 20}
    assert clash[4] == {"id": 4, "id_1": 4}
    assert err == "zip requires equal row counts"


def test_shuffle_more_maps_than_slots(runtimes):
    """More shuffle maps (6) than worker slots (4) with a generator
    backpressure budget (2) under the partition count: the harvest drains
    whichever map has committed parts, so the shuffle ends."""
    old = RefConfig.generator_backpressure_items, \
        PortConfig.generator_backpressure_items
    RefConfig.generator_backpressure_items = 2
    PortConfig.generator_backpressure_items = 2
    try:
        rows = _twin(lambda d: d.range(64, parallelism=6)
                     .random_shuffle(seed=0).take_all())
    finally:
        (RefConfig.generator_backpressure_items,
         PortConfig.generator_backpressure_items) = old
    assert sorted(r["id"] for r in rows) == list(range(64))


@pytest.mark.parametrize("side", ["reference", "port"])
def test_short_shuffle_map_raises(runtimes, side):
    """A partition function that yields fewer than P parts raises the
    reference's RuntimeError."""
    d, ex = (jd, jexec) if side == "reference" else (td, texec)
    op = ex.ShuffleOperator(
        "Short", lambda block, P, idx: [block], lambda parts, p: parts)
    refs = d.range(20, parallelism=2).materialize()._refs
    with pytest.raises(RuntimeError, match="yielded 1 partitions, "
                                           "expected 2"):
        op.execute_bundles([(r, None) for r in refs], d.DatasetStats())


def test_stats_and_explain_name_the_barriers(runtimes):
    def case(d):
        ds = d.range(40, parallelism=4).random_shuffle(seed=1).sort("id")
        ds.materialize()
        return ([op.name for op in ds._operators],
                [op.name for op in ds._stats.ops])

    ops, stats = _twin(case)
    assert ops[-2:] == ["RandomShuffle", "Sort(id)"]
    assert "RandomShuffle" in stats and "Sort(id)" in stats
