"""Twins of the reference filesystems' atomic create
(``ray_tpu/data/filesystem.py``'s ``put_if_absent``, ``exists``,
``children`` and ``atomic_put_if_absent``), which the workflow commit
markers rest on, on the CPU.

Each case runs the same operations on the reference's and the port's
``LocalFilesystem`` and ``MemoryFilesystem`` (the latter in the runtime's
KV while a runtime is up, in a process dict otherwise) and the results
must be equal. The race: N threads create one key at once and exactly one
wins, on each side. Every wait is bounded.
"""

import threading

import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.data import filesystem as jfs
from ray_tpu_torch.data import filesystem as tfs

T = 30.0
SIDES = {"ref": (jfs, ray_tpu), "port": (tfs, ray_tpu_torch)}


@pytest.fixture(params=["no_runtime", "runtime"])
def runtime(request):
    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()
    if request.param == "runtime":
        ray_tpu.init(num_cpus=2, worker_mode="thread",
                     ignore_reinit_error=True)
        ray_tpu_torch.init(num_cpus=2)
    for fs, _ in SIDES.values():
        fs.MemoryFilesystem.clear()
    try:
        yield request.param
    finally:
        for fs, _ in SIDES.values():
            fs.MemoryFilesystem.clear()
        for rt in (ray_tpu, ray_tpu_torch):
            rt.shutdown()


def _root(kind, side, tmp_path):
    if kind == "memory":
        return f"memory://fs_{side}"
    d = tmp_path / side
    d.mkdir(exist_ok=True)
    return str(d)


@pytest.mark.parametrize("kind", ["local", "memory"])
def test_put_if_absent_exists_children(runtime, tmp_path, kind):
    out = {}
    for name, (fs_mod, _) in SIDES.items():
        root = _root(kind, name, tmp_path)
        fs, base = fs_mod.resolve_filesystem(root)
        fs.makedirs(f"{base}/a/b")
        steps = [fs.atomic_put_if_absent, fs.exists(f"{base}/a/x")]
        steps.append(fs.put_if_absent(f"{base}/a/x", b"one"))
        steps.append(fs.put_if_absent(f"{base}/a/x", b"two"))
        with fs.open(f"{base}/a/x", "rb") as f:
            steps.append(f.read())
        steps.append(fs.exists(f"{base}/a/x"))
        steps.append(fs.put_if_absent(f"{base}/a/b/y", b"three"))
        with fs.open(f"{base}/a/b/z", "wb") as f:
            f.write(b"four")
        steps.append(fs.children(f"{base}/a"))
        steps.append(fs.children(f"{base}/a/b"))
        steps.append(fs.children(f"{base}/nothing"))
        steps.append(fs.exists(f"{base}/a"))
        fs.delete(f"{base}/a/x")
        steps.append((fs.exists(f"{base}/a/x"),
                      fs.put_if_absent(f"{base}/a/x", b"five")))
        out[name] = steps
    assert out["port"] == out["ref"]
    assert out["ref"][:5] == [True, False, True, False, b"one"]


def test_base_filesystem_put_if_absent_best_effort(tmp_path):
    """A backend without an exclusive create gets exists, write and read
    back, and says so with ``atomic_put_if_absent`` False."""
    out = {}
    for name, (fs_mod, _) in SIDES.items():
        class Plain(fs_mod.Filesystem):
            def __init__(self):
                self.local = fs_mod.LocalFilesystem()

            def open(self, path, mode="rb"):
                return self.local.open(path, mode)

            def listdir(self, path):
                return self.local.listdir(path)

            def makedirs(self, path):
                self.local.makedirs(path)

            def exists(self, path):
                return self.local.exists(path)

            def isdir(self, path):
                return self.local.isdir(path)

        fs = Plain()
        d = tmp_path / name
        d.mkdir()
        (d / "sub").mkdir()
        (d / "sub" / "f").write_bytes(b"x")
        out[name] = (fs.atomic_put_if_absent,
                     fs.put_if_absent(str(d / "k"), b"1"),
                     fs.put_if_absent(str(d / "k"), b"2"),
                     (d / "k").read_bytes(), fs.children(str(d)))
    assert out["port"] == out["ref"]
    assert out["ref"] == (False, True, False, b"1", ["k", "sub"])


@pytest.mark.parametrize("kind", ["local", "memory"])
def test_put_if_absent_race_has_one_winner(runtime, tmp_path, kind):
    n = 16
    out = {}
    for name, (fs_mod, _) in SIDES.items():
        fs, base = fs_mod.resolve_filesystem(_root(kind, name, tmp_path))
        key = f"{base}/marker.json"
        barrier = threading.Barrier(n)
        wins = []

        def create(i):
            barrier.wait(timeout=T)
            if fs.put_if_absent(key, f"writer{i}".encode()):
                wins.append(i)

        threads = [threading.Thread(target=create, args=(i,))
                   for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(T)
        assert not any(th.is_alive() for th in threads)
        with fs.open(key, "rb") as f:
            stored = f.read()
        assert len(wins) == 1
        assert stored == f"writer{wins[0]}".encode()
        out[name] = len(wins)
    assert out["port"] == out["ref"] == 1


def test_workflow_storage_warns_without_atomic_create(tmp_path):
    """WorkflowStorage warns on a backend without an exclusive create, on
    both sides."""
    from ray_tpu.workflow import WorkflowStorage as JStorage
    from ray_tpu_torch.workflow import WorkflowStorage as TStorage

    for (fs_mod, _), Storage in ((SIDES["ref"], JStorage),
                                 (SIDES["port"], TStorage)):
        class NoAtomic(fs_mod.LocalFilesystem):
            atomic_put_if_absent = False

        fs_mod.register_filesystem("noatomic", NoAtomic())
        with pytest.warns(RuntimeWarning, match="exclusive-create"):
            Storage(f"noatomic://{tmp_path}/w")
