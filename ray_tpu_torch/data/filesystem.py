"""Filesystems for storage URIs (counterpart of
``ray_tpu/data/filesystem.py``): what checkpoint storage, the Data
readers and writers and the workflow journal use.

A path may carry a URI scheme (``memory://bucket/x``, ``file:///tmp/x``,
``s3://...``); the registry resolves the scheme to a ``Filesystem``.
``file`` (or no scheme) is the local filesystem; ``memory`` is an
in-memory store shaped like a remote object store;
``register_filesystem`` adds a scheme. Any other scheme is handed to
``fsspec`` (imported there, at first use), and one that fsspec cannot
provide raises ``ValueError``.
"""

from __future__ import annotations

import io
import os
import threading
from typing import Dict, List, Tuple


class Filesystem:
    """The surface that storage needs."""

    # When True, resolve_filesystem hands this fs the FULL scheme-
    # qualified path, so two schemes backed by the same store class
    # cannot alias each other's keys.
    keeps_scheme = False

    # True when put_if_absent is a real atomic create (O_EXCL, the KV's
    # overwrite=False). Consumers that need one winner (workflow commit
    # markers) check it, to warn on a best-effort backend.
    atomic_put_if_absent = False

    def open(self, path: str, mode: str = "rb"):
        raise NotImplementedError

    def listdir(self, path: str) -> List[str]:
        """Recursive FILE listing under a directory path."""
        raise NotImplementedError

    def children(self, path: str) -> List[str]:
        """Immediate child names under a directory (one path segment,
        files and subdirectories alike), from the recursive listing
        unless a backend has a shallow scan."""
        base = path.rstrip("/") + "/"
        names = set()
        for key in self.listdir(path.rstrip("/")):
            rel = key[len(base):] if key.startswith(base) else None
            if rel:
                names.add(rel.split("/", 1)[0])
        return sorted(names)

    def put_if_absent(self, path: str, data: bytes) -> bool:
        """Create ``path`` holding ``data`` iff it does not exist; True
        when this call created it. Here exists, write and read back: best
        effort, not atomic (a backend with an exclusive create
        overrides it)."""
        if self.exists(path):
            return False
        with self.open(path, "wb") as f:
            f.write(data)
        try:
            with self.open(path, "rb") as f:
                return f.read() == data
        except OSError:
            return False

    def makedirs(self, path: str) -> None:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def isdir(self, path: str) -> bool:
        raise NotImplementedError


class LocalFilesystem(Filesystem):
    atomic_put_if_absent = True  # O_EXCL

    def open(self, path, mode="rb"):
        return open(path, mode)

    def listdir(self, path):
        out = []
        for root, _, files in os.walk(path):
            out.extend(os.path.join(root, f) for f in files)
        return sorted(out)

    def children(self, path):
        try:
            return sorted(e.name for e in os.scandir(path))
        except OSError:
            return []

    def put_if_absent(self, path, data):
        try:
            with open(path, "xb") as f:  # O_EXCL: the kernel's atomic create
                f.write(data)
            return True
        except FileExistsError:
            return False

    def delete(self, path):
        try:
            os.remove(path)
        except OSError:
            pass

    def makedirs(self, path):
        os.makedirs(path, exist_ok=True)

    def exists(self, path):
        return os.path.exists(path)

    def isdir(self, path):
        return os.path.isdir(path)


class _MemFile(io.BytesIO):
    def __init__(self, fs, key):
        super().__init__()
        self._fs = fs
        self._key = key

    def close(self):
        if not self.closed:
            self._fs._put(self._key, self.getvalue())
        super().close()


class MemoryFilesystem(Filesystem):
    """In-memory filesystem (remote-object-store shaped: flat keys,
    ``isdir`` is prefix-existence). Backed by the runtime's internal KV
    while a runtime is up, so every actor and task of the runtime sees
    what the driver wrote; a process-local dict otherwise."""

    keeps_scheme = True  # keys stay scheme-qualified in the shared store
    atomic_put_if_absent = True  # the KV's overwrite=False, under its lock
    _KV_PREFIX = b"memfs|"
    _store: Dict[str, bytes] = {}  # no-runtime fallback
    _lock = threading.Lock()

    @staticmethod
    def _worker():
        from ray_tpu_torch._private.worker import try_live_worker

        return try_live_worker()

    def _put(self, key: str, data: bytes):
        w = self._worker()
        if w is not None:
            w.kv_put(self._KV_PREFIX + key.encode(), data)
            return
        with self._lock:
            self._store[key] = data

    def put_if_absent(self, path, data):
        path = path.rstrip("/")
        w = self._worker()
        if w is not None:
            # overwrite=False is decided under the KV's own lock: an
            # atomic create.
            return bool(w.kv_put(self._KV_PREFIX + path.encode(), data,
                                 overwrite=False))
        with self._lock:
            if path in self._store:
                return False
            self._store[path] = data
            return True

    def _get(self, key: str):
        w = self._worker()
        if w is not None:
            return w.kv_get(self._KV_PREFIX + key.encode())
        with self._lock:
            return self._store.get(key)

    def _keys(self, prefix: str):
        w = self._worker()
        if w is not None:
            n = len(self._KV_PREFIX)
            return [k[n:].decode() for k in w.kv_keys(
                self._KV_PREFIX + prefix.encode())]
        with self._lock:
            return [k for k in self._store if k.startswith(prefix)]

    def open(self, path, mode="rb"):
        path = path.rstrip("/")
        if "r" in mode:
            data = self._get(path)
            if data is None:
                raise FileNotFoundError(path)
            return io.BytesIO(data)
        return _MemFile(self, path)

    def listdir(self, path):
        return sorted(self._keys(path.rstrip("/") + "/"))

    def makedirs(self, path):
        pass  # flat namespace

    def exists(self, path):
        path = path.rstrip("/")
        return self._get(path) is not None or bool(
            self._keys(path + "/"))

    def isdir(self, path):
        return bool(self._keys(path.rstrip("/") + "/"))

    def delete(self, path):
        w = self._worker()
        if w is not None:
            w.kv_del(self._KV_PREFIX + path.encode())
        with self._lock:
            self._store.pop(path, None)

    @classmethod
    def clear(cls):
        fs = cls()
        for k in fs._keys(""):
            fs.delete(k)
        with cls._lock:
            cls._store.clear()


_REGISTRY: Dict[str, Filesystem] = {
    "file": LocalFilesystem(),
    "memory": MemoryFilesystem(),
}


class _FsspecFilesystem(Filesystem):
    def __init__(self, fs, scheme: str):
        self._fs = fs
        self._scheme = scheme

    def open(self, path, mode="rb"):
        return self._fs.open(path, mode)

    def listdir(self, path):
        # fsspec's find() strips the scheme; re-qualify so the returned
        # paths stay resolvable through the registry.
        return sorted(
            f"{self._scheme}://{p}" if "://" not in p else p
            for p in self._fs.find(path)
            if not self._fs.isdir(p))

    def children(self, path):
        # A delimiter-based shallow listing: a recursive find() over a big
        # prefix only to learn the immediate child names would hammer an
        # object store's LIST.
        try:
            return sorted(
                p.rstrip("/").rsplit("/", 1)[-1]
                for p in self._fs.ls(path, detail=False))
        except (OSError, FileNotFoundError):
            return []

    def makedirs(self, path):
        self._fs.makedirs(path, exist_ok=True)

    def exists(self, path):
        return self._fs.exists(path)

    def isdir(self, path):
        return self._fs.isdir(path)

    def delete(self, path):
        try:
            self._fs.rm_file(path)
        except Exception:  # noqa: BLE001 — a directory, or already gone
            self._fs.rm(path, recursive=True)


def register_filesystem(scheme: str, fs: Filesystem) -> None:
    _REGISTRY[scheme] = fs


def resolve_filesystem(path: str) -> Tuple[Filesystem, str]:
    """(filesystem, scheme-stripped path) for a possibly-URI path."""
    if "://" not in path:
        return _REGISTRY["file"], path
    scheme, _, rest = path.partition("://")
    fs = _REGISTRY.get(scheme)
    if fs is not None:
        return (fs, path) if fs.keeps_scheme else (fs, rest)
    try:
        import fsspec

        return _FsspecFilesystem(fsspec.filesystem(scheme), scheme), path
    except Exception as exc:  # noqa: BLE001 — an unknown scheme
        raise ValueError(
            f"no filesystem registered for scheme {scheme!r} and fsspec "
            f"could not provide one: {exc}") from exc
