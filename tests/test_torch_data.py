"""Twins of the reference's Data pipelines (``tests/test_data.py:20-130``,
``:196``, ``:400-451``) and of its Train feed, on the CPU.

Both runtimes run in one process (the reference on
``ray_tpu.init(worker_mode="thread")``); each case builds the same
pipeline with each side's ``data`` module and the rows, batches, counts,
schemas and plans must be equal. ``iter_torch_batches`` is held against
``iter_jax_batches`` value for value; the dtypes differ on purpose: JAX
without x64 turns an int64 column into int32, the port keeps numpy's
int64 (what the port's embedding lookup takes). Every wait is bounded by
the runtimes' own timeouts; nothing asserts on wall time.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import ray_tpu
import ray_tpu.data as jd
import ray_tpu_torch
import ray_tpu_torch.data as td
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.parallel.mesh import make_mesh as jmake_mesh
from ray_tpu_torch.parallel import mesh as tmesh


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


SOURCES = {
    "range": lambda d: d.range(100),
    "range_blocks": lambda d: d.range(37, parallelism=5),
    "from_items": lambda d: d.from_items(
        [{"a": i, "b": float(i) / 2} for i in range(30)], parallelism=3),
    "from_columns": lambda d: d.from_columns(
        {"x": np.arange(24).reshape(12, 2), "y": np.arange(12) * 1.5},
        parallelism=4),
    "from_numpy": lambda d: d.from_numpy(
        np.arange(40, dtype=np.float32).reshape(10, 4), parallelism=2),
}


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_sources_rows_count_schema(runtimes, source):
    def case(d):
        ds = SOURCES[source](d)
        return (ds.take_all(), ds.count(), ds.take(5), ds.schema(),
                ds.columns(), ds.materialize().num_blocks())

    rows, count, head, _, _, _ = _twin(case)
    assert count == len(rows) and head == rows[:5]


def test_range_count_take(runtimes):
    rows = _twin(lambda d: (d.range(100).count(), d.range(100).take(5)))
    assert rows == [100, [{"id": i} for i in range(5)]]


def test_map_batches_numpy_and_dict(runtimes):
    def case(d):
        sq = d.range(1000).map_batches(
            lambda b: {"id": b["id"], "sq": b["id"] ** 2}, batch_size=128)
        arr = d.range(10).map_batches(lambda b: b["id"] * 3,
                                      batch_format="numpy", batch_size=4)
        return sq.take_all(), arr.take_all()

    sq, arr = _twin(case)
    assert len(sq) == 1000 and all(r["sq"] == r["id"] ** 2 for r in sq)
    assert [r["item"] for r in arr] == [3 * i for i in range(10)]


def test_map_filter_flat_map(runtimes):
    def case(d):
        ds = d.range(20).map(lambda r: {"v": int(r["id"]) + 1})
        ds = ds.filter(lambda r: r["v"] % 2 == 0)
        ds = ds.flat_map(lambda r: [{"v": r["v"]}, {"v": -r["v"]}])
        return [r["v"] for r in ds.take_all()]

    vals = _twin(case)
    assert vals == [s * v for v in range(2, 21, 2) for s in (1, -1)]


def test_columns_transforms(runtimes):
    def case(d):
        ds = d.range(12, parallelism=3).add_column("two", lambda r: 2 * r["id"])
        return (ds.select_columns(["two"]).take_all(),
                ds.drop_columns(["two"]).take_all(), ds.columns())

    _twin(case)


def test_limit_union(runtimes):
    def case(d):
        return (d.range(100).limit(7).take_all(), d.range(100).limit(7).count(),
                d.range(10).union(d.range(5)).take_all(),
                d.range(10).union(d.range(5), d.range(3)).count())

    _, count, _, three = _twin(case)
    assert (count, three) == (7, 18)


@pytest.mark.parametrize("drop_last", [False, True])
def test_iter_batches_exact_sizes(runtimes, drop_last):
    def case(d):
        return [b["id"] for b in d.range(1000).iter_batches(
            batch_size=256, drop_last=drop_last)]

    batches = _twin(case)
    assert [len(b) for b in batches] == (
        [256, 256, 256] if drop_last else [256, 256, 256, 232])


def test_split_and_schema(runtimes):
    def case(d):
        parts = d.range(100).split(3)
        return ([p.count() for p in parts], [p.take_all() for p in parts],
                d.range(5).schema())

    counts, _, schema = _twin(case)
    assert sum(counts) == 100 and schema == {"id": "int64"}


def test_streaming_split_is_blockwise(runtimes):
    def case(d):
        shards = d.range(100, parallelism=10).streaming_split(4)
        return ([s.count() for s in shards], [s.num_blocks() for s in shards],
                [[r["id"] for r in s.take_all()] for s in shards],
                [[len(b) for b in s.iter_blocks()] for s in shards])

    counts, blocks, ids, _ = _twin(case)
    assert sum(counts) == 100 and sum(blocks) == 10
    assert sorted(i for s in ids for i in s) == list(range(100))


def test_stats_populated(runtimes):
    def case(d):
        ds = d.range(100).map_batches(lambda b: b)
        ds.materialize()
        s = ds.stats()
        return "MapBatches" in s and "rows" in s

    assert _twin(case) is True


def test_logical_plan_fusion_and_explain(runtimes):
    def case(d):
        ds = (d.range(100)
              .map(lambda r: {"id": r["id"] * 2})
              .filter(lambda r: r["id"] % 4 == 0)
              .map_batches(lambda b: b))
        return (ds.explain(), len(ds._operators),
                sorted(r["id"] for r in ds.iter_rows()))

    _, n_ops, out = _twin(case)
    assert n_ops == 1 and out == [i * 2 for i in range(100) if i % 2 == 0]


def test_logical_limit_pushdown_and_merge(runtimes):
    def case(d):
        ds = d.range(50).map(lambda r: {"id": r["id"] + 1}).limit(10).limit(7)
        opt = ds._logical.optimize()
        return ([(op.kind, op.name, op.limit) for op in opt.ops],
                [r["id"] for r in ds.iter_rows()])

    plan, rows = _twin(case)
    assert [(k, lim) for k, _, lim in plan] == [
        ("read", None), ("limit", 7), ("map", None)]
    assert rows == list(range(1, 8))


@pytest.mark.parametrize("rule", ["limit_pushdown_rule", "limit_merge_rule"])
def test_logical_rules_on_their_own(rule):
    """A limit does not hop over a map that is not row-preserving, and two
    limits merge to the smaller (the reference's rule-unit checks)."""
    import ray_tpu.data.logical as jl
    import ray_tpu_torch.data.logical as tl

    def case(lg):
        flat = lg.LogicalOp(kind="map", name="FlatMap",
                            block_fn=lambda b: [b],
                            make_physical=lambda lo: None,
                            row_preserving=False)
        lim = lg.LogicalOp(kind="limit", name="Limit[3]", limit=3,
                           make_physical=lambda lo: None)
        lim5 = lg.LogicalOp(kind="limit", name="Limit[5]", limit=5,
                            make_physical=lambda lo: None)
        ops = [flat, lim] if rule == "limit_pushdown_rule" else [lim5, lim]
        return [(o.name, o.limit) for o in getattr(lg, rule)(ops)]

    got = case(jl)
    assert case(tl) == got
    assert got == ([("FlatMap", None), ("Limit[3]", 3)]
                   if rule == "limit_pushdown_rule" else [("Limit[5]", 3)])


def test_iter_torch_batches_against_iter_jax_batches(runtimes):
    cols = {"tokens": np.arange(64 * 9, dtype=np.int64).reshape(64, 9),
            "w": np.linspace(0, 1, 64, dtype=np.float32)}
    ref = list(jd.from_columns(cols, parallelism=3).iter_jax_batches(
        batch_size=24))
    got = list(td.from_columns(cols, parallelism=3).iter_torch_batches(
        batch_size=24, device="cpu"))
    assert len(got) == len(ref) == 2   # drop_last: 64 rows, 2 full batches
    for r, g in zip(ref, got):
        assert set(g) == set(r)
        for k in r:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]))
        # The stated difference: JAX (no x64) int32, the port numpy's int64.
        assert (str(r["tokens"].dtype), g["tokens"].dtype) == (
            "int32", torch.int64)
        assert (str(r["w"].dtype), g["w"].dtype) == ("float32", torch.float32)
    kept = list(td.range(10).iter_torch_batches(batch_size=4, drop_last=False,
                                                device="cpu"))
    assert [len(b["id"]) for b in kept] == [4, 4, 2]


def test_iter_torch_batches_defaults_to_the_card(runtimes, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(td.range(8).iter_torch_batches(batch_size=4))


def test_iter_torch_batches_sharded_over_eight_shards(runtimes):
    """``sharding=(mesh, spec)`` against ``jax.device_put`` with a
    NamedSharding over the reference's 8 CPU devices: each shard's block,
    in ``mesh.devices.flat`` order, equal to the reference's shard on the
    same mesh coordinate."""
    cols = {"x": np.arange(32 * 3, dtype=np.float32).reshape(32, 3)}
    jmesh = jmake_mesh(JMeshConfig(dp=8), devices=jax.devices("cpu")[:8])
    tm = tmesh.make_mesh(tmesh.MeshConfig(dp=8),
                         devices=[torch.device("cpu")] * 8)
    ref = list(jd.from_columns(cols).iter_jax_batches(
        batch_size=16, sharding=NamedSharding(jmesh, PartitionSpec("dp"))))
    got = list(td.from_columns(cols).iter_torch_batches(
        batch_size=16, sharding=(tm, ("dp",))))
    assert len(got) == len(ref) == 2
    order = {d: i for i, d in enumerate(jmesh.devices.flat)}
    for r, g in zip(ref, got):
        shards = sorted(r["x"].addressable_shards,
                        key=lambda s: order[s.device])
        assert len(g["x"]) == len(shards) == 8
        for s, t in zip(shards, g["x"]):
            np.testing.assert_array_equal(t.numpy(), np.asarray(s.data))
