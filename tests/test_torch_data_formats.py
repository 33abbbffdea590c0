"""Twins of the reference's pandas, Arrow, fsspec and PIL Data tests on
the CPU: ``tests/test_data.py:35`` (a pandas ``map_batches``), ``:95``
(parquet), ``:110`` (CSV) and ``:208`` (hive-partitioned parquet, column
projection, a groupby over a partition column); ``tests/test_data_io.py
:159`` (``memory://`` for each format), ``:180`` (worker processes read
what the driver wrote, CSV and parquet), ``:198`` (``.csv.gz``) and
``:232`` (images). Beside them: parquet, CSV and JSON files that one side
writes read back by the other (both ways), the fsspec scheme ``local://``,
``from_pandas`` / ``from_arrow`` / ``to_pandas``, the ``"pyarrow"`` batch
format and ``Datasource.get_name`` / ``estimate_inmemory_data_size``.

Both runtimes run in one process (the reference on
``ray_tpu.init(worker_mode="thread")``) and each case runs on both sides;
the outcomes must be equal exactly (values through the same pandas and
pyarrow, so no tolerance). Under pandas 3 a string column read back from
CSV or JSON has pandas' own ``str`` dtype on both sides: cases compare
values, not dtype names.
"""

import gzip
import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import ray_tpu
import ray_tpu.data as jd
import ray_tpu_torch
import ray_tpu_torch.data as td

SIDES = {"reference": jd, "port": td}
FORMATS = ("parquet", "csv", "json")


@pytest.fixture
def runtimes():
    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()
    ray_tpu.init(num_cpus=2, worker_mode="thread", ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2)
    try:
        yield
    finally:
        for d in SIDES.values():
            d.MemoryFilesystem.clear()
        for rt in (ray_tpu, ray_tpu_torch):
            rt.shutdown()


def _plain(value):
    if isinstance(value, pd.DataFrame):
        return {c: _plain(value[c].tolist()) for c in value.columns}
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


def _source(d, n=30):
    return d.from_columns({"a": np.arange(n, dtype=np.int64),
                           "b": np.arange(n).astype(np.float64) * 2,
                           "s": np.asarray([f"r{i}" for i in range(n)])},
                          parallelism=2)


def _sorted_frame(df):
    return df.sort_values("a").reset_index(drop=True)


# ------------------------------------------------------ tests/test_data.py
def test_map_batches_pandas_format(runtimes):
    def case(d):
        def add_col(df):
            df["y"] = df["id"] * 2
            return df

        ds = d.range(50).map_batches(add_col, batch_format="pandas")
        return ds.take(1)[0]["y"], ds.count(), \
            [r["y"] for r in ds.take_all()]

    first, count, ys = _twin(case)
    assert first == 0 and count == 50 and ys == [2 * i for i in range(50)]


def test_map_batches_pyarrow_format(runtimes):
    def case(d):
        def add_col(table):
            return table.append_column(
                "y", pa.array(table.column("id").to_numpy() * 3))

        ds = d.range(20, parallelism=3).map_batches(
            add_col, batch_format="pyarrow", batch_size=8)
        return [r["y"] for r in ds.take_all()], \
            [type(b).__name__ for b in
             d.range(5).iter_batches(batch_format="pyarrow")]

    ys, kinds = _twin(case)
    assert ys == [3 * i for i in range(20)] and kinds == ["Table"]


def test_parquet_roundtrip(runtimes, tmp_path):
    def case(d):
        path = str(tmp_path / d.__name__ / "pq")
        d.from_columns({
            "fare": np.arange(100, dtype=np.float32),
            "dist": np.arange(100, dtype=np.float32) * 2,
        }).repartition(4).write_parquet(path)
        ds = d.read_parquet(path)
        out = ds.map_batches(
            lambda b: {"tip": b["fare"] * 0.2 + b["dist"]},
            batch_size=32).materialize()
        return len(os.listdir(path)), ds.count(), out.count(), \
            sorted(r["tip"] for r in out.take_all())

    files, count, out, tips = _twin(case)
    assert (files, count, out) == (4, 100, 100)
    assert tips == sorted(np.float32(i) * np.float32(0.2) + np.float32(2 * i)
                          for i in range(100))


def test_csv_roundtrip(runtimes, tmp_path):
    def case(d):
        path = str(tmp_path / d.__name__ / "csv")
        d.from_items([{"a": i, "b": str(i)} for i in range(10)]
                     ).write_csv(path)
        ds = d.read_csv(os.path.join(path, "*.csv"))
        return ds.count(), sorted((r["a"], r["b"]) for r in ds.take_all())

    count, rows = _twin(case)
    assert count == 10 and rows == [[i, i] for i in range(10)]


def test_read_partitioned_parquet_hive_layout(runtimes, tmp_path):
    for year in ("2024", "2025"):
        for city in ("sf", "nyc"):
            d = tmp_path / f"year={year}" / f"city={city}"
            d.mkdir(parents=True)
            pq.write_table(pa.table({"fare": [1.0 * int(year[-1]), 2.0]}),
                           d / "part-0.parquet")

    def case(d):
        rows = d.read_parquet(str(tmp_path)).take_all()
        globbed = d.read_parquet(
            str(tmp_path / "**" / "*.parquet")).take_all()
        proj = d.read_parquet(str(tmp_path),
                              columns=["fare", "city"]).take_all()
        only_part = d.read_parquet(str(tmp_path), columns=["year"]).take_all()
        agg = (d.read_parquet(str(tmp_path)).groupby("city")
               .count().take_all())
        return (rows, globbed, sorted(proj[0]), proj,
                [r["year"] for r in only_part],
                sorted((r["city"], r["count()"]) for r in agg))

    rows, globbed, proj_keys, _, years, agg = _twin(case)
    assert len(rows) == 8 and {r["year"] for r in rows} == {2024, 2025}
    assert {r["city"] for r in globbed} == {"sf", "nyc"}
    assert proj_keys == ["city", "fare"] and len(years) == 8
    assert agg == [["nyc", 4], ["sf", 4]]


# --------------------------------------------------- tests/test_data_io.py
def test_memory_filesystem_write_read_roundtrip(runtimes):
    def case(d):
        src = d.from_columns({"a": np.arange(30, dtype=np.int64),
                              "b": np.arange(30).astype(np.float64) * 2},
                             parallelism=2)
        out = {}
        for fmt, writer, reader in [
                ("csv", src.write_csv, d.read_csv),
                ("json", src.write_json, d.read_json),
                ("parquet", src.write_parquet, d.read_parquet),
                ("tfrecords", src.write_tfrecords, d.read_tfrecords)]:
            uri = f"memory://bucket/{d.__name__}/{fmt}"
            writer(uri)
            out[fmt] = _sorted_frame(reader(uri).to_pandas())
        return out

    out = _twin(case)
    for fmt, df in out.items():
        assert df["a"] == list(range(30)), fmt
        assert df["b"] == [2.0 * i for i in range(30)], fmt


def test_memory_fs_visible_from_worker_processes(tmp_path):
    """Read tasks in worker processes of the process plane read what the
    driver wrote to memory:// (the runtime's KV), CSV and parquet (the
    parquet stack is pre-imported on the importing thread, not first
    imported inside concurrent read tasks)."""
    def case(d, rt):
        rt.shutdown()
        rt.init(num_cpus=2, worker_mode="process", ignore_reinit_error=True)
        try:
            src = d.from_columns({"x": np.arange(20, dtype=np.int64)},
                                 parallelism=2)
            src.write_csv("memory://procbucket/csv")
            src.write_parquet("memory://procbucket/pq")
            src.write_parquet(str(tmp_path / d.__name__))
            return [sorted(d.read_csv("memory://procbucket/csv")
                           .to_pandas()["x"]),
                    sorted(d.read_parquet("memory://procbucket/pq")
                           .to_pandas()["x"]),
                    sorted(d.read_parquet(str(tmp_path / d.__name__))
                           .map_batches(lambda b: {"x": b["x"] + 1})
                           .to_pandas()["x"])]
        finally:
            d.MemoryFilesystem.clear()
            rt.shutdown()

    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()
    ref = _plain(case(jd, ray_tpu))
    port = _plain(case(td, ray_tpu_torch))
    assert port == ref
    assert ref == [list(range(20)), list(range(20)), list(range(1, 21))]


def test_csv_gz_compression_inference(runtimes, tmp_path):
    p = tmp_path / "d.csv.gz"
    pd.DataFrame({"a": [1, 2, 3]}).to_csv(p, index=False,
                                          compression="gzip")
    # A gzip member, not plain text: pandas infers it from the suffix.
    assert gzip.open(p).read().startswith(b"a\n")

    assert _twin(lambda d: list(d.read_csv(str(p)).to_pandas()["a"])) == [
        1, 2, 3]


def test_read_images(runtimes, tmp_path):
    from PIL import Image

    rng = np.random.default_rng(3)
    pixels = []
    for i in range(3):
        arr = rng.integers(0, 256, (6, 8 + i, 3), dtype=np.uint8)
        Image.fromarray(arr).save(tmp_path / f"img{i}.png")
        pixels.append(arr)
    (tmp_path / "README.txt").write_text("not an image")

    def case(d):
        rows = sorted(d.read_images(str(tmp_path)).iter_rows(),
                      key=lambda r: r["path"])
        small = list(d.read_images(str(tmp_path), size=(4, 4)).iter_rows())
        return ([(os.path.basename(r["path"]), r["image"]) for r in rows],
                [(r["image"].shape, str(r["image"].dtype)) for r in small])

    rows, small = _twin(case)
    assert [name for name, _ in rows] == ["img0.png", "img1.png", "img2.png"]
    assert [img for _, img in rows] == [p.tolist() for p in pixels]
    assert small == [[[4, 4, 3], "uint8"]] * 3


# ------------------------------------------------------------------ beside
@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("writer", sorted(SIDES))
def test_files_interchange(runtimes, tmp_path, fmt, writer):
    """Files one side writes, the other reads equal, both ways."""
    path = str(tmp_path / fmt)
    getattr(_source(SIDES[writer]), f"write_{fmt}")(path)
    reader = SIDES["port" if writer == "reference" else "reference"]
    back = _plain(_sorted_frame(
        getattr(reader, f"read_{fmt}")(path).to_pandas()))
    same = _plain(_sorted_frame(
        getattr(SIDES[writer], f"read_{fmt}")(path).to_pandas()))
    assert back == same
    assert back["a"] == list(range(30)) and back["s"] == [
        f"r{i}" for i in range(30)]


@pytest.mark.parametrize("fmt", FORMATS)
def test_fsspec_local_scheme(runtimes, tmp_path, fmt):
    """An unregistered scheme goes to fsspec: ``local://`` round-trips,
    and the listing keeps the scheme."""
    def case(d):
        uri = f"local://{tmp_path}/{d.__name__}/{fmt}"
        getattr(_source(d), f"write_{fmt}")(uri)
        fs, p = d.resolve_filesystem(uri)
        root = f"{tmp_path}/{d.__name__}"
        listed = [f.replace(root, "<root>") for f in fs.listdir(p)]
        df = _sorted_frame(getattr(d, f"read_{fmt}")(uri).to_pandas())
        return type(fs).__name__, listed, df

    kind, listed, df = _twin(case)
    assert kind == "_FsspecFilesystem"
    assert listed == [f"local://<root>/{fmt}/part-0000{i}.{fmt}"
                      for i in range(2)]
    assert df["a"] == list(range(30)) and df["b"] == [
        2.0 * i for i in range(30)]


@pytest.mark.parametrize("side", sorted(SIDES))
def test_unknown_fsspec_scheme_raises(runtimes, side):
    with pytest.raises(ValueError, match="fsspec could not provide"):
        SIDES[side].resolve_filesystem("nosuchscheme://bucket/x")


def test_from_pandas_arrow_to_pandas(runtimes):
    frame = pd.DataFrame({"k": np.arange(12, dtype=np.int64) % 3,
                          "x": np.linspace(0.0, 1.0, 12),
                          "s": [f"v{i}" for i in range(12)]})

    def case(d):
        a = d.from_pandas(frame, parallelism=3)
        b = d.from_arrow(pa.Table.from_pandas(frame), parallelism=2)
        return (a.to_pandas(), b.to_pandas(),
                a.groupby("k").sum("x").take_all())

    a, b, sums = _twin(case)
    assert a == b == _plain(frame)
    assert [r["k"] for r in sums] == [0, 1, 2]


def test_datasource_name_and_size_estimate(runtimes):
    def case(d):
        class Squares(d.Datasource):
            def get_read_tasks(self, parallelism, **_):
                return [d.ReadTask(lambda: [{"i": np.arange(4)}],
                                   num_rows=4)]

        class Sized(Squares):
            def estimate_inmemory_data_size(self):
                return 32

            def get_name(self):
                return "sized"

        return (Squares().get_name(), Squares().estimate_inmemory_data_size(),
                Sized().get_name(), Sized().estimate_inmemory_data_size(),
                d.read_datasource(Sized()).count())

    assert _twin(case) == ["Squares", None, "sized", 32, 4]
