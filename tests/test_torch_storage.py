"""Twins of the reference's checkpoint storage
(``tests/test_checkpoint_storage.py:35-76``): storage URIs, the
``CheckpointStore`` and its upload thread, on the CPU.

Both runtimes run in one process (the reference on
``ray_tpu.init(worker_mode="thread")``), so each side's ``memory://``
keeps its keys in its own runtime's KV. The same operations run on each
side and their results are compared exactly: stored values, URIs, key
listings and their order, error type names. The reference's
non-blocking check bounds wall time; here uploads wait on a gate that the
test opens, so "does not block" is shown without a clock. Every wait is
bounded.
"""

import shutil
import threading

import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.data import filesystem as jfs
from ray_tpu.train import Checkpoint as JCheckpoint
from ray_tpu.train import CheckpointStore as JStore
from ray_tpu_torch.data import filesystem as tfs
from ray_tpu_torch.train import Checkpoint as TCheckpoint
from ray_tpu_torch.train import CheckpointStore as TStore

T = 30.0
SIDES = {"ref": (jfs, JCheckpoint, JStore), "port": (tfs, TCheckpoint, TStore)}


@pytest.fixture
def runtimes():
    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()
    ray_tpu.init(num_cpus=2, worker_mode="thread", ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=2)
    for fs, _, _ in SIDES.values():
        fs.MemoryFilesystem.clear()
    try:
        yield
    finally:
        for fs, _, _ in SIDES.values():
            fs.MemoryFilesystem.clear()
        for rt in (ray_tpu, ray_tpu_torch):
            rt.shutdown()


def _both(case, tmp_path):
    """The case's result on each side, each with a scratch dir of its own;
    the results must be equal."""
    out = {}
    for name, side in SIDES.items():
        scratch = tmp_path / name
        scratch.mkdir()
        out[name] = case(*side, str(scratch))
    assert out["port"] == out["ref"]
    return out["ref"]


def _plain(data):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in data.items()}


def _relative(uri, scratch):
    return uri.replace(scratch, "<scratch>")


@pytest.mark.parametrize("kind", ["memory", "file", "plain"])
def test_checkpoint_uri_roundtrip(runtimes, tmp_path, kind):
    def case(fs, Checkpoint, _store, scratch):
        uri = {"memory": "memory://ckpts/one", "file": f"file://{scratch}/one",
               "plain": f"{scratch}/one"}[kind]
        ckpt = Checkpoint.from_dict({"step": 7, "w": np.arange(4)})
        returned = ckpt.to_uri(uri)
        back = Checkpoint.from_uri(uri)
        try:
            data = _plain(back.to_dict())
        finally:
            shutil.rmtree(back.path)
        shutil.rmtree(ckpt.path)
        store, path = fs.resolve_filesystem(uri)
        keys = [_relative(k, scratch) for k in store.listdir(path)]
        return _relative(returned, scratch), data, keys

    returned, data, keys = _both(case, tmp_path)
    assert data == {"step": 7, "w": [0, 1, 2, 3]}
    assert [k.rsplit("/", 1)[-1] for k in keys] == ["data.pkl"]


@pytest.mark.parametrize("root", ["memory", "local"])
def test_store_persist_fetch_latest_delete(runtimes, tmp_path, root):
    def case(_fs, Checkpoint, Store, scratch):
        store = Store("memory://bucket/run" if root == "memory"
                      else f"{scratch}/run")
        made = []
        for step in (1, 2, 3):
            made.append(Checkpoint.from_dict({"step": step}))
            store.persist(made[-1], f"checkpoint_{step:06d}")
        listed = store.list_checkpoints()
        latest = store.latest()
        first = store.fetch(listed[0])
        out = [[_relative(u, scratch) for u in listed],
               latest.to_dict()["step"], first.to_dict()["step"]]
        store.delete(listed[0])
        out.append([_relative(u, scratch) for u in store.list_checkpoints()])
        for ck in made + ([latest, first] if root == "memory" else []):
            shutil.rmtree(ck.path)
        return out

    listed, latest, first, after = _both(case, tmp_path)
    assert [u.rsplit("/", 1)[-1] for u in listed] == [
        "checkpoint_000001", "checkpoint_000002", "checkpoint_000003"]
    assert (latest, first) == (3, 1)
    assert after == listed[1:]


def _gated(MemoryFilesystem, gate):
    class Gated(MemoryFilesystem):
        """Every open for writing waits for the gate."""

        def open(self, path, mode="rb"):
            if "w" in mode and not gate.wait(T):
                raise TimeoutError("gate never opened")
            return super().open(path, mode)

    return Gated()


def test_async_persist_does_not_block_caller(runtimes, tmp_path):
    def case(fs, Checkpoint, Store, _scratch):
        gate = threading.Event()
        fs.register_filesystem("gatedmem", _gated(fs.MemoryFilesystem, gate))
        store = Store("gatedmem://bucket/run")
        ckpt = Checkpoint.from_dict({"step": 1})
        try:
            futs = [store.persist_async(ckpt, f"checkpoint_{i:06d}")
                    for i in range(3)]
            # Every upload waits on the gate, yet all three were handed
            # over: persist_async returned without uploading.
            blocked = [f.done() for f in futs]
            gate.set()
            uris = store.wait(timeout=T)
            listed = store.list_checkpoints()
        finally:
            gate.set()
            store._pool.shutdown(wait=True)
            shutil.rmtree(ckpt.path)
        return blocked, uris, listed, [f.result(timeout=T) for f in futs]

    blocked, uris, listed, results = _both(case, tmp_path)
    assert blocked == [False, False, False]
    assert uris == results == listed == [
        f"gatedmem://bucket/run/checkpoint_{i:06d}" for i in range(3)]


def _broken(MemoryFilesystem):
    class Broken(MemoryFilesystem):
        """Every open for writing fails."""

        def open(self, path, mode="rb"):
            if "w" in mode:
                raise OSError("disk gone")
            return super().open(path, mode)

    return Broken()


def test_wait_raises_the_upload_error(runtimes, tmp_path):
    def case(fs, Checkpoint, Store, _scratch):
        fs.register_filesystem("brokenmem", _broken(fs.MemoryFilesystem))
        store = Store("brokenmem://bucket/run")
        ckpt = Checkpoint.from_dict({"step": 1})
        try:
            store.persist_async(ckpt, "checkpoint_000001")
            with pytest.raises(OSError) as err:
                store.wait(timeout=T)
            return type(err.value).__name__, str(err.value)
        finally:
            store._pool.shutdown(wait=True)
            shutil.rmtree(ckpt.path)

    assert _both(case, tmp_path) == ("OSError", "disk gone")


def test_unregistered_scheme_raises_value_error(runtimes, tmp_path):
    def case(fs, Checkpoint, Store, _scratch):
        ckpt = Checkpoint.from_dict({"step": 1})
        try:
            errors = []
            for call in (lambda: fs.resolve_filesystem("s3://bucket/x"),
                         lambda: ckpt.to_uri("s3://bucket/x"),
                         lambda: Checkpoint.from_uri("s3://bucket/x")):
                with pytest.raises(ValueError) as err:
                    call()
                errors.append(type(err.value).__name__)
            return errors
        finally:
            shutil.rmtree(ckpt.path)

    assert _both(case, tmp_path) == ["ValueError"] * 3


def test_close_joins_the_upload_thread(runtimes, tmp_path):
    store = TStore("memory://bucket/closing")
    ckpt = TCheckpoint.from_dict({"step": 1})
    try:
        store.persist_async(ckpt, "checkpoint_000001")
        store.close()
        assert not [t for t in threading.enumerate()
                    if t.name.startswith("ckpt-upload")]
        assert store.list_checkpoints() == [
            "memory://bucket/closing/checkpoint_000001"]
    finally:
        shutil.rmtree(ckpt.path)


def test_memory_keys_live_in_the_runtime_kv(runtimes):
    """While a runtime is up, ``memory://`` keys are the runtime's KV
    entries (so every actor of the runtime sees them), as in the
    reference; the two runtimes' stores are apart."""
    from ray_tpu._private.worker import global_worker as jworker
    from ray_tpu_torch._private.worker import global_worker as tworker

    for fs, value in ((jfs, b"ref"), (tfs, b"port")):
        memfs, path = fs.resolve_filesystem("memory://kv/x")
        with memfs.open(path, "wb") as f:
            f.write(value)
    assert jworker().kv_get(b"memfs|memory://kv/x") == b"ref"
    assert tworker().kv_get(b"memfs|memory://kv/x") == b"port"
