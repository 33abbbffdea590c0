"""Twins of the reference's Data IO tests (``tests/test_data_io.py:68-157``,
``:209`` and ``:246``) on the CPU: custom sources and sinks with the
sink's failure hook, the TFRecord codec and its CRC checks, files that
one side writes read back equal by the other (both ways), ``read_numpy``,
``read_binary_files``, ``read_sql`` over ``sqlite3`` and filesystem
registration.

Both runtimes run in one process (the reference on
``ray_tpu.init(worker_mode="thread")``). TFRecord files are compared
byte for byte: the port's writer is bit-compatible with the reference's.
Floats pass through TFRecord as float32 and come back as float64 on both
sides, so a float column read back equals the written one exactly after
a cast to float32. Every wait is bounded by the runtimes' own timeouts.
"""

import os
import sqlite3

import numpy as np
import pytest

import ray_tpu
import ray_tpu.data as jd
import ray_tpu_torch
import ray_tpu_torch.data as td
from ray_tpu.data import tfrecords as jtfr
from ray_tpu_torch.data import tfrecords as ttfr

SIDES = {"reference": jd, "port": td}


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


def _columns(d, ds):
    """Every block of ``ds`` concatenated into columns."""
    cols = {}
    for b in ds.iter_blocks():
        for k, v in b.items():
            cols.setdefault(k, []).append(np.asarray(v))
    return {k: np.concatenate(v) for k, v in cols.items()}


# ------------------------------------------------------------- datasource
def _squares_source(d, n):
    class SquaresSource(d.Datasource):
        """n rows of (i, i*i) split across read tasks."""

        def get_read_tasks(self, parallelism, **_):
            per = max(n // parallelism, 1)
            tasks, lo = [], 0
            while lo < n:
                hi = min(lo + per, n)
                tasks.append(d.ReadTask(
                    lambda lo=lo, hi=hi: [{
                        "i": np.arange(lo, hi, dtype=np.int64),
                        "sq": np.arange(lo, hi, dtype=np.int64) ** 2}],
                    num_rows=hi - lo))
                lo = hi
            return tasks

    return SquaresSource()


def _collect_sink(d, fail_on=None):
    class CollectSink(d.Datasink):
        def __init__(self):
            self.events, self.rows = [], 0
            self.completed = self.failed = None

        def on_write_start(self):
            self.events.append("start")

        def write(self, blocks):
            self.events.append("write")
            wrote = sum(len(next(iter(b.values()))) for b in blocks)
            if fail_on is not None and self.rows + wrote > fail_on:
                raise RuntimeError("sink exploded")
            self.rows += wrote
            return wrote

        def on_write_complete(self, results):
            self.events.append("complete")
            self.completed = results

        def on_write_failed(self, error):
            self.events.append("failed")
            self.failed = error

    return CollectSink()


@pytest.mark.parametrize("parallelism", [1, 4, 7])
def test_custom_datasource_roundtrip(runtimes, parallelism):
    def case(d):
        ds = d.read_datasource(_squares_source(d, 100),
                               parallelism=parallelism)
        ds = ds.map_batches(lambda b: {**b, "sq2": b["sq"] * 2})
        sink = _collect_sink(d)
        results = ds.write_datasink(sink)
        assert sink.completed == results
        small = d.read_datasource(_squares_source(d, 10)).take_all()
        return results, sink.rows, sink.events, small

    results, rows, events, small = _twin(case)
    assert rows == sum(results) == 100
    assert events[0] == "start" and events[-1] == "complete"
    assert [r["sq"] for r in small] == [i * i for i in range(10)]


def test_datasink_failure_hook(runtimes):
    def case(d):
        class Boom(d.Datasink):
            def __init__(self):
                self.failed = None

            def write(self, blocks):
                raise RuntimeError("sink exploded")

            def on_write_failed(self, error):
                self.failed = error

        sink = Boom()
        with pytest.raises(RuntimeError, match="sink exploded"):
            d.range(10).write_datasink(sink)
        return type(sink.failed).__name__

    assert _twin(case) == "RuntimeError"


def test_datasink_fails_mid_stream(runtimes):
    """A sink that fails on its third block: start, two writes, the
    failing write, then on_write_failed, and no complete."""
    def case(d):
        sink = _collect_sink(d, fail_on=25)
        with pytest.raises(RuntimeError, match="sink exploded"):
            d.range(40, parallelism=4).write_datasink(sink)
        return sink.events, sink.rows, str(sink.failed)

    events, rows, failed = _twin(case)
    assert events == ["start", "write", "write", "write", "failed"]
    assert rows == 20 and failed == "sink exploded"


# --------------------------------------------------------------- tfrecords
def _tfr_table():
    return {"id": np.arange(50, dtype=np.int64),
            "score": (np.arange(50) * 0.5).astype(np.float32),
            "name": np.asarray([f"row{i}".encode() for i in range(50)],
                               dtype=object),
            "vec": np.arange(150, dtype=np.int64).reshape(50, 3) - 70}


def test_tfrecords_roundtrip(runtimes, tmp_path):
    def case(d):
        path = str(tmp_path / d.__name__ / "tfr")
        d.from_columns(_tfr_table(), parallelism=3).write_tfrecords(path)
        cols = _columns(d, d.read_tfrecords(path))
        return (sorted(os.listdir(path)), cols["id"], cols["score"],
                list(cols["name"]), [list(v) for v in cols["vec"]])

    files, ids, score, names, vec = _twin(case)
    assert len(files) == 3
    assert ids == list(range(50))
    assert score == (np.arange(50) * 0.5).tolist()
    assert names[7] == b"row7"
    assert vec[1] == [-67, -66, -65]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_tfrecords_files_interchange(runtimes, tmp_path, writer):
    """A directory that one side writes, the other reads: the same files
    byte for byte, and the same rows."""
    src = SIDES[writer]
    other = td if writer == "reference" else jd
    path = str(tmp_path / "tfr")
    src.from_columns(_tfr_table(), parallelism=4).write_tfrecords(path)
    mine = str(tmp_path / "mine")
    other.from_columns(_tfr_table(), parallelism=4).write_tfrecords(mine)
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as a, \
                open(os.path.join(mine, name), "rb") as b:
            assert a.read() == b.read(), name
    a, b = _columns(src, src.read_tfrecords(path)), \
        _columns(other, other.read_tfrecords(path))
    assert a.keys() == b.keys() == set(_tfr_table())
    for k in a:
        assert _plain(list(a[k])) == _plain(list(b[k])), k
    assert np.array_equal(b["score"].astype(np.float32),
                          _tfr_table()["score"])


def test_tfrecords_codec_lists():
    """Multi-element features survive the Example codec, and both sides
    encode a row to the same bytes."""
    row = {"vec": np.asarray([1.5, 2.5, -3.0], dtype=np.float32),
           "ids": [7, -9, 1 << 40],
           "tag": b"hello", "word": "hi", "flag": True}
    enc = ttfr.encode_example(row)
    assert enc == jtfr.encode_example(row)
    decoded = ttfr.decode_example(enc)
    assert decoded == jtfr.decode_example(enc)
    assert np.allclose(decoded["vec"], [1.5, 2.5, -3.0])
    assert decoded["ids"] == [7, -9, 1 << 40]
    assert decoded["tag"] == [b"hello"] and decoded["word"] == [b"hi"]
    assert decoded["flag"] == [1]


@pytest.mark.parametrize("data", [b"", b"a", b"123456789", bytes(range(256))])
def test_crc32c_matches_reference(data):
    assert ttfr.crc32c(data) == jtfr.crc32c(data)
    assert ttfr._masked_crc(data) == jtfr._masked_crc(data)
    if data == b"123456789":   # the CRC-32C check value
        assert ttfr.crc32c(data) == 0xE3069283


def test_varints_and_examples_to_block_match_reference():
    for n in (0, 1, 127, 128, 300, 1 << 35, (1 << 64) - 1):
        enc = ttfr._varint(n)
        assert enc == jtfr._varint(n)
        assert ttfr._read_varint(enc, 0) == (n, len(enc))
    rows = [{"a": [1], "b": [1.5, 2.5], "c": [b"x"]},
            {"a": [2], "b": [3.5], "c": [b"y", b"z"]}]
    got, want = ttfr.examples_to_block(rows), jtfr.examples_to_block(rows)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        assert _plain(list(got[k])) == _plain(list(want[k]))
    assert ttfr.examples_to_block([]) == {}


@pytest.mark.parametrize("side", sorted(SIDES))
def test_tfrecords_crc_detects_corruption(runtimes, tmp_path, side):
    d = SIDES[side]
    d.range(10).write_tfrecords(str(tmp_path / "t"))
    files = sorted((tmp_path / "t").iterdir())
    raw = bytearray(files[0].read_bytes())
    raw[2] ^= 0xFF  # flip a length byte
    files[0].write_bytes(bytes(raw))
    with pytest.raises(Exception, match="CRC|truncated"):
        d.read_tfrecords(str(files[0])).materialize()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_tfrecords_data_crc_detects_payload_corruption(runtimes, tmp_path,
                                                       side):
    """A flipped payload byte leaves the length field (and its CRC)
    intact: only the per-record data CRC catches it."""
    d = SIDES[side]
    tfr = jtfr if side == "reference" else ttfr
    d.range(10).write_tfrecords(str(tmp_path / "t"))
    files = sorted((tmp_path / "t").iterdir())
    raw = bytearray(files[0].read_bytes())
    raw[12] ^= 0xFF  # the first data byte of the first record
    files[0].write_bytes(bytes(raw))
    with pytest.raises(Exception, match="data CRC"):
        d.read_tfrecords(str(files[0])).materialize()
    with open(files[0], "rb") as fh:
        recs = list(tfr.read_records(fh, check_integrity=False))
    assert len(recs) >= 1
    # Unchecked, the corrupt file still reads through the Dataset.
    assert d.read_tfrecords(str(files[0]),
                            check_integrity=False).count() >= 1


def test_tfrecords_truncated_record_raises(tmp_path):
    p = tmp_path / "one.tfrecords"
    with open(p, "wb") as fh:
        ttfr.write_record(fh, ttfr.encode_example({"a": 1}))
    raw = p.read_bytes()
    p.write_bytes(raw[:-6])
    for tfr in (ttfr, jtfr):
        with open(p, "rb") as fh, pytest.raises(ValueError,
                                                 match="truncated"):
            list(tfr.read_records(fh))


def test_tfrecords_memory_uri_roundtrip(runtimes):
    def case(d):
        src = d.from_columns({"a": np.arange(30, dtype=np.int64),
                              "b": np.arange(30).astype(np.float64) * 2},
                             parallelism=2)
        uri = f"memory://bucket/{d.__name__}/tfrecords"
        src.write_tfrecords(uri)
        cols = _columns(d, d.read_tfrecords(uri))
        return cols["a"], cols["b"]

    a, b = _twin(case)
    assert a == list(range(30)) and b == (np.arange(30) * 2.0).tolist()


# ------------------------------------------------------- numpy, binary, sql
def test_read_numpy(runtimes, tmp_path):
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal((5, 3)).astype(np.float32),
              rng.integers(0, 9, (4, 3))]
    for i, a in enumerate(arrays):
        np.save(tmp_path / f"a{i}.npy", a)

    def case(d):
        ds = d.read_numpy(str(tmp_path))
        return [b["data"] for b in ds.iter_blocks()], \
            d.read_numpy(str(tmp_path / "a1.npy")).count()

    blocks, count = _twin(case)
    assert blocks == [a.tolist() for a in arrays] and count == 4


def test_read_binary_files(runtimes, tmp_path):
    payloads = {"x.bin": b"\x00\x01\xff", "sub/y.bin": bytes(range(50))}
    for name, data in payloads.items():
        (tmp_path / name).parent.mkdir(exist_ok=True)
        (tmp_path / name).write_bytes(data)

    def case(d):
        rows = d.read_binary_files(str(tmp_path)).take_all()
        glob = d.read_binary_files(str(tmp_path / "*.bin")).count()
        return [(os.path.relpath(r["path"], tmp_path), r["bytes"])
                for r in rows], glob

    rows, glob = _twin(case)
    assert dict(rows) == payloads and glob == 1


@pytest.mark.parametrize("side", sorted(SIDES))
def test_read_missing_path_raises(runtimes, tmp_path, side):
    with pytest.raises(FileNotFoundError, match="no files matched"):
        SIDES[side].read_numpy(str(tmp_path / "*.npy"))


def test_read_sql_sqlite(runtimes, tmp_path):
    db = str(tmp_path / "t.db")
    conn = sqlite3.connect(db)
    conn.execute("CREATE TABLE pts (id INTEGER, v REAL)")
    conn.executemany("INSERT INTO pts VALUES (?, ?)",
                     [(i, i * 0.5) for i in range(40)])
    conn.commit()
    conn.close()

    def case(d):
        whole = d.read_sql("SELECT id, v FROM pts ORDER BY id",
                           lambda: sqlite3.connect(db)).take_all()
        sharded = d.read_sql(
            "SELECT id, v FROM pts WHERE id % {num_shards} = {shard}",
            lambda: sqlite3.connect(db), parallelism=4)
        empty = d.read_sql("SELECT id FROM pts WHERE id < 0",
                           lambda: sqlite3.connect(db)).count()
        return whole, sharded.take_all(), empty

    whole, sharded, empty = _twin(case)
    assert [r["id"] for r in whole] == list(range(40))
    assert [r["v"] for r in whole] == [i * 0.5 for i in range(40)]
    assert sorted(r["id"] for r in sharded) == list(range(40))
    assert [r["id"] % 4 for r in sharded[:10]] == [0] * 10
    assert empty == 0


# -------------------------------------------------------------- filesystem
@pytest.mark.parametrize("side", sorted(SIDES))
def test_custom_filesystem_registration(runtimes, side):
    d = SIDES[side]
    d.register_filesystem("mock", d.MemoryFilesystem())
    fs, p = d.resolve_filesystem("mock://x/y")
    assert isinstance(fs, d.MemoryFilesystem) and p == "mock://x/y"
    d.range(6, parallelism=2).write_tfrecords("mock://x/t")
    assert sorted(fs.listdir("mock://x/t")) == [
        "mock://x/t/part-00000.tfrecords", "mock://x/t/part-00001.tfrecords"]
    assert sorted(r["id"] for r in
                  d.read_tfrecords("mock://x/t").take_all()) == list(range(6))
