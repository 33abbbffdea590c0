"""Checkpoints: a directory, and trees of tensors saved into it
(counterpart of ``ray_tpu/train/checkpoint.py``).

A ``Checkpoint`` is a directory. A tree saves in the reference's flat
form only (orbax is a JAX library): ``leaves.npz``, whose entry ``i`` is
the tree's ``i``-th leaf, and a pickled structure. The structure is made
of plain Python containers (dict, list, tuple, None) with a slot for each
leaf, and the leaves come in the order ``jax.tree.flatten`` gives (dict
keys sorted, None holding no leaf), so entry ``i`` lines up with the
reference's flat form of the same tree.

Leaves are torch tensors, numpy arrays and Python numbers, and come back
as what they were: a tensor on the ``device`` given to ``load_pytree``, a
numpy array, a number of its own type. A tensor whose dtype numpy lacks
(bfloat16) is stored as its raw bits, an integer view of the same width,
with its dtype named in the structure, and comes back bit for bit.
``to_uri`` and ``from_uri`` move a checkpoint to and from a storage URI
(``memory://``, ``file://`` or a local path) through ``train/storage.py``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import shutil
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device

_LEAVES, _STRUCTURE = "leaves.npz", "structure.pkl"
# Raw-bit views for tensor dtypes that numpy has no type for.
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_NUMBERS = (bool, int, float)


class Checkpoint:
    def __init__(self, path: str):
        self.path = os.path.abspath(path)

    # ------------------------------------------------------------- creation
    @staticmethod
    def from_directory(path: str) -> "Checkpoint":
        return Checkpoint(path)

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        with open(os.path.join(d, "data.pkl"), "wb") as f:
            pickle.dump(data, f)
        return Checkpoint(d)

    @staticmethod
    def from_pytree(tree: Any, path: Optional[str] = None) -> "Checkpoint":
        d = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(d, exist_ok=True)
        save_pytree(tree, os.path.join(d, "pytree"))
        return Checkpoint(d)

    # ------------------------------------------------------------ accessors
    def as_directory(self) -> str:
        return self.path

    def to_dict(self) -> Dict[str, Any]:
        with open(os.path.join(self.path, "data.pkl"), "rb") as f:
            return pickle.load(f)

    def to_pytree(self, device="cuda") -> Any:
        return load_pytree(os.path.join(self.path, "pytree"), device)

    def copy_to(self, dest: str) -> "Checkpoint":
        if os.path.abspath(dest) != self.path:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return Checkpoint(dest)

    # ----------------------------------------------------------- URI plane
    def to_uri(self, uri: str) -> str:
        """Upload this checkpoint to a storage URI through the filesystem
        registry."""
        from ray_tpu_torch.train.storage import upload_dir

        return upload_dir(self.path, uri)

    @staticmethod
    def from_uri(uri: str) -> "Checkpoint":
        """Materialize a stored checkpoint locally from its URI."""
        from ray_tpu_torch.train.storage import download_dir

        return Checkpoint(download_dir(uri))

    def __repr__(self):
        return f"Checkpoint({self.path})"


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """A leaf's slot in a saved structure: its index in ``leaves.npz`` and
    what to rebuild ("tensor" with its dtype name, "ndarray", "scalar" for
    a numpy scalar, or a Python number's type name)."""

    index: int
    kind: str
    dtype: Optional[str] = None


def _flatten(tree, out: List[np.ndarray]):
    """The structure of ``tree`` with its leaves appended to ``out`` as
    numpy arrays, in ``jax.tree.flatten``'s order."""
    if tree is None:
        return None
    if type(tree) is dict:
        return {k: _flatten(tree[k], out) for k in sorted(tree)}
    if type(tree) in (list, tuple):
        return type(tree)(_flatten(x, out) for x in tree)
    index = len(out)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().contiguous().cpu()
        name = str(t.dtype).removeprefix("torch.")
        try:
            out.append(t.numpy())
        except TypeError:   # no numpy dtype: store the raw bits
            out.append(t.view(_BITS[t.element_size()]).numpy())
        return _Leaf(index, "tensor", name)
    if isinstance(tree, np.ndarray):
        out.append(tree)
        return _Leaf(index, "ndarray")
    if isinstance(tree, np.generic):
        out.append(np.asarray(tree))
        return _Leaf(index, "scalar")
    if type(tree) in _NUMBERS:
        out.append(np.asarray(tree))
        return _Leaf(index, type(tree).__name__)
    raise TypeError(f"cannot save a {type(tree).__name__}: a tree is made "
                    f"of dicts, lists, tuples and None over tensors, numpy "
                    f"arrays and numbers")


def _unflatten(structure, data, device):
    if structure is None:
        return None
    if isinstance(structure, dict):
        return {k: _unflatten(v, data, device) for k, v in structure.items()}
    if isinstance(structure, (list, tuple)):
        return type(structure)(_unflatten(x, data, device)
                               for x in structure)
    a = data[str(structure.index)]
    kind = structure.kind
    if kind == "tensor":
        dtype = getattr(torch, structure.dtype)
        t = torch.from_numpy(a)
        if t.dtype != dtype:
            t = t.view(dtype)
        return t.to(device)
    if kind == "ndarray":
        return a
    if kind == "scalar":
        return a[()]
    return {t.__name__: t for t in _NUMBERS}[kind](a)


def save_pytree(tree: Any, path: str) -> None:
    """Saves ``tree`` into the directory ``path``: ``leaves.npz`` and the
    pickled structure."""
    os.makedirs(path, exist_ok=True)
    leaves: List[np.ndarray] = []
    structure = _flatten(tree, leaves)
    np.savez(os.path.join(path, _LEAVES),
             **{str(i): a for i, a in enumerate(leaves)})
    with open(os.path.join(path, _STRUCTURE), "wb") as f:
        pickle.dump(structure, f)


def load_pytree(path: str, device="cuda") -> Any:
    """The tree that ``save_pytree`` saved into ``path``, its tensors on
    ``device``."""
    dev = resolve_device(device)
    with open(os.path.join(path, _STRUCTURE), "rb") as f:
        structure = pickle.load(f)
    with np.load(os.path.join(path, _LEAVES)) as data:
        return _unflatten(structure, data, dev)
