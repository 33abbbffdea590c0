"""Checkpoint storage (counterpart of ``ray_tpu/train/storage.py``).

A ``CheckpointStore`` moves checkpoint directories between the local
filesystem and a storage URI through the filesystem registry
(``ray_tpu_torch.data.filesystem``: local paths, ``file://``,
``memory://`` and any registered scheme). ``persist_async`` uploads on
one upload thread, so a training step loop never blocks on checkpoint
IO; ``wait()`` drains pending uploads and raises the first upload's
error; ``close()`` drains and joins the upload thread.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional

from ray_tpu_torch.data.filesystem import resolve_filesystem
from ray_tpu_torch.train.checkpoint import Checkpoint


def _is_uri(path: str) -> bool:
    return "://" in path


def upload_dir(local_dir: str, dest_uri: str) -> str:
    """Copy a local directory tree to a storage URI (flat re-rooted
    file copies, which suit object-store-shaped filesystems)."""
    fs, dest = resolve_filesystem(dest_uri)
    fs.makedirs(dest)
    dest = dest.rstrip("/")
    for root, _, files in os.walk(local_dir):
        rel = os.path.relpath(root, local_dir)
        for f in files:
            key = f"{dest}/{f}" if rel == "." else \
                f"{dest}/{rel.replace(os.sep, '/')}/{f}"
            fs.makedirs(key.rsplit("/", 1)[0])
            with open(os.path.join(root, f), "rb") as src, \
                    fs.open(key, "wb") as out:
                shutil.copyfileobj(src, out)  # streamed, not slurped
    return dest_uri


def download_dir(src_uri: str, local_dir: Optional[str] = None) -> str:
    """Fetch a storage URI's tree into a local directory."""
    fs, src = resolve_filesystem(src_uri)
    src = src.rstrip("/")
    local_dir = local_dir or tempfile.mkdtemp(
        prefix="ray_tpu_torch_ckpt_dl_")
    files = fs.listdir(src)
    if not files:
        raise FileNotFoundError(f"no checkpoint files under {src_uri}")
    for key in files:
        rel = key[len(src):].lstrip("/")
        target = os.path.join(local_dir, *rel.split("/"))
        os.makedirs(os.path.dirname(target), exist_ok=True)
        with fs.open(key, "rb") as inp, open(target, "wb") as out:
            shutil.copyfileobj(inp, out)
    return local_dir


class CheckpointStore:
    """Persist checkpoints under one storage root (URI or local dir)."""

    def __init__(self, root: str):
        self.root = root.rstrip("/")
        self.remote = _is_uri(self.root)
        if not self.remote:
            os.makedirs(self.root, exist_ok=True)
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-upload")
        self._pending: List[Future] = []
        self._lock = threading.Lock()

    # ---------------------------------------------------------------- write
    def persist(self, ckpt: Checkpoint, name: str) -> str:
        """Synchronous persist; returns the checkpoint's URI/path."""
        dest = f"{self.root}/{name}"
        if self.remote:
            upload_dir(ckpt.as_directory(), dest)
        else:
            ckpt.copy_to(dest)
        return dest

    def persist_async(self, ckpt: Checkpoint, name: str) -> Future:
        """Persist on the upload thread; the caller (a training step
        loop) continues at once. The returned future resolves to the
        destination URI."""
        fut = self._pool.submit(self.persist, ckpt, name)
        with self._lock:
            self._pending = [f for f in self._pending if not f.done()]
            self._pending.append(fut)
        return fut

    def wait(self, timeout: Optional[float] = None) -> List[str]:
        """Drain pending async persists; returns their URIs and raises
        the error of the first that failed."""
        with self._lock:
            pending, self._pending = self._pending, []
        return [f.result(timeout=timeout) for f in pending]

    def close(self) -> None:
        """Finish every pending upload and join the upload thread."""
        self._pool.shutdown(wait=True)

    # ----------------------------------------------------------------- read
    def list_checkpoints(self) -> List[str]:
        """Checkpoint URIs under the root, lexicographically sorted
        (names embed a monotonic stamp, so the last is the latest)."""
        if not self.remote:
            if not os.path.isdir(self.root):
                return []
            return [f"{self.root}/{d}"
                    for d in sorted(os.listdir(self.root))
                    if d.startswith("checkpoint_")]
        fs, p = resolve_filesystem(self.root)
        names = set()
        prefix = p.rstrip("/") + "/"
        for key in fs.listdir(p):
            rel = key[len(prefix):]
            head = rel.split("/", 1)[0]
            if head.startswith("checkpoint_"):
                names.add(head)
        return [f"{self.root}/{n}" for n in sorted(names)]

    def fetch(self, uri: str) -> Checkpoint:
        """Materialize a stored checkpoint locally."""
        if not _is_uri(uri):
            return Checkpoint(uri)
        return Checkpoint(download_dir(uri))

    def latest(self) -> Optional[Checkpoint]:
        entries = self.list_checkpoints()
        return self.fetch(entries[-1]) if entries else None

    def delete(self, uri: str) -> None:
        if not _is_uri(uri):
            shutil.rmtree(uri, ignore_errors=True)
            return
        fs, p = resolve_filesystem(uri)
        # Object-store shaped: per-key removal when the backing fs
        # supports deletion.
        if hasattr(fs, "delete"):
            for k in fs.listdir(p):
                fs.delete(k)
