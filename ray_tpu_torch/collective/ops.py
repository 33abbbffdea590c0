"""Collectives over a mesh axis, one controller (counterpart of
``ray_tpu/collective/ops.py``).

The reference's collectives are ``jax.lax`` operations inside
``shard_map``: one program per shard, each holding its own value. Here
the one process holds every shard's tensor: each function takes a list
of per-shard tensors and a ``Mesh`` with an axis name, or a tuple of
names whose shards are ordered row-major, as ``lax`` orders them, and
returns the list of per-shard results. The list holds either the shards
of one group along the axis (as many as the axis has) or every shard of
the mesh, in the order of ``mesh.devices.flat``; then the op runs on
each group of shards that share the other coordinates, as ``lax`` does
inside a ``shard_map`` over the whole mesh. Result ``j`` lives on shard
``j``'s device (the device of ``xs[j]``) in a buffer of its own, moved
there with ``.to(device, copy=True)``: on one device a copy, across GPUs
a peer copy. The reductions run on a group's first shard's device in
shard order.

Every op is built of differentiable tensor operations (``.to``, sums,
``cat``, ``chunk``), so under autograd its backward is the transpose
that ``jax`` gives its ``lax`` counterpart: ``allreduce``'s is an
``allreduce`` of the cotangents delivered to every member, ``permute``'s
the inverse permutation and ``all_to_all``'s the inverse exchange
(``tests/test_torch_parallel.py`` holds each against ``jax.grad``).

``permute`` and ``send_recv`` keep ``ppermute``'s rule: a shard that
receives nothing holds zeros.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch.parallel.mesh import Mesh

AxisName = Union[str, Sequence[str]]


def axis_size(mesh: Mesh, axis: AxisName) -> int:
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in names:
        if a not in mesh.shape:
            raise ValueError(
                f"mesh has no axis {a!r}; axes: {mesh.axis_names}")
    return math.prod(mesh.shape[a] for a in names)


def axis_index(mesh: Mesh, axis: str) -> List[torch.Tensor]:
    """Each shard's position along ``axis``, an int32 scalar on its
    device."""
    return [torch.tensor(i, dtype=torch.int32, device=d)
            for i, d in enumerate(mesh.axis_devices(axis))]


def _names(axis: AxisName) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_indices(mesh: Mesh, axis: AxisName) -> List[int]:
    """Every shard's position along ``axis`` (a tuple of names: row-major
    over them), in the order of ``mesh.devices.flat``: what
    ``lax.axis_index`` gives each shard of a ``shard_map`` over the whole
    mesh."""
    axis_size(mesh, axis)
    coords = np.indices(mesh.devices.shape).reshape(mesh.devices.ndim, -1)
    index = np.zeros(mesh.size, dtype=np.int64)
    for a in _names(axis):
        k = mesh.axis_names.index(a)
        index = index * mesh.devices.shape[k] + coords[k]
    return index.tolist()


def groups(mesh: Mesh, axis: AxisName) -> List[List[int]]:
    """The groups of shards along ``axis``: for each combination of the
    other axes' coordinates, the flat indices (into ``mesh.devices.flat``)
    of its shards, ordered as ``axis_indices`` orders them."""
    axis_size(mesh, axis)
    ks = [mesh.axis_names.index(a) for a in _names(axis)]
    others = [k for k in range(mesh.devices.ndim) if k not in ks]
    flat = np.arange(mesh.size).reshape(mesh.devices.shape)
    n = math.prod(mesh.devices.shape[k] for k in ks)
    return flat.transpose(others + ks).reshape(-1, n).tolist()


def _per_group(xs: Sequence[torch.Tensor], mesh: Mesh, axis: AxisName,
               op: Callable[[List[torch.Tensor]], List[torch.Tensor]]
               ) -> List[torch.Tensor]:
    """``op`` on the shards of one group (``xs`` as long as the axis), or
    on every group of the mesh (``xs`` as long as the mesh)."""
    n = axis_size(mesh, axis)
    if len(xs) == n:
        return op(list(xs))
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} shard tensors for axis {axis!r} of "
                         f"size {n} (or a mesh of {mesh.size})")
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for g in groups(mesh, axis):
        for j, r in zip(g, op([xs[j] for j in g])):
            out[j] = r
    return out


def _deliver(values: Sequence[torch.Tensor], xs: Sequence[torch.Tensor]
             ) -> List[torch.Tensor]:
    """values[j] copied onto shard j's device, into a buffer of its own."""
    return [v.to(x.device, copy=True) for v, x in zip(values, xs)]


def _on_first(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    dev = xs[0].device
    return [x.to(dev) for x in xs]


def allreduce(xs, mesh: Mesh, axis: AxisName, op: str = "sum"
              ) -> List[torch.Tensor]:
    if op not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unsupported reduce op {op!r}")

    def reduce(g):
        parts = _on_first(g)
        acc = parts[0]
        for x in parts[1:]:
            if op in ("sum", "mean"):
                acc = acc + x
            elif op == "max":
                acc = torch.maximum(acc, x)
            else:
                acc = torch.minimum(acc, x)
        if op == "mean":
            acc = acc / len(g)
        return _deliver([acc] * len(g), g)

    return _per_group(xs, mesh, axis, reduce)


def allgather(xs, mesh: Mesh, axis: AxisName, *, tiled: bool = True,
              gather_axis: int = 0) -> List[torch.Tensor]:
    """Every shard gets every shard's tensor: concatenated along
    ``gather_axis`` (tiled) or stacked on a new axis there."""
    def gather(g):
        parts = _on_first(g)
        joined = (torch.cat(parts, dim=gather_axis) if tiled
                  else torch.stack(parts, dim=gather_axis))
        return _deliver([joined] * len(g), g)

    return _per_group(xs, mesh, axis, gather)


def reducescatter(xs, mesh: Mesh, axis: AxisName, *, scatter_axis: int = 0,
                  tiled: bool = True) -> List[torch.Tensor]:
    """The sum, split along ``scatter_axis``: shard j gets block j (tiled),
    or index j of an axis of size n, which it drops (not tiled)."""
    def scatter(g):
        n = len(g)
        total = allreduce(g, mesh, axis)[0]
        size = total.shape[scatter_axis]
        if tiled:
            if size % n:
                raise ValueError(f"scatter axis of size {size} does not "
                                 f"divide {n} shards")
            pieces = torch.chunk(total, n, dim=scatter_axis)
        else:
            if size != n:
                raise ValueError(f"untiled scatter axis of size {size} "
                                 f"needs {n} (the axis size)")
            pieces = total.unbind(scatter_axis)
        return _deliver(pieces, g)

    return _per_group(xs, mesh, axis, scatter)


def broadcast(xs, mesh: Mesh, axis: str, root: int = 0
              ) -> List[torch.Tensor]:
    """Every shard gets the root shard's value."""
    return _per_group(xs, mesh, axis,
                      lambda g: _deliver([g[root]] * len(g), g))


def permute(xs, mesh: Mesh, axis: str, perm: Sequence[Tuple[int, int]]
            ) -> List[torch.Tensor]:
    """Shard dst gets shard src's value for each (src, dst) pair; a shard
    that receives nothing holds zeros (``ppermute``)."""
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"permutation {perm} repeats a source or a "
                         f"destination")
    sent = dict((d, s) for s, d in perm)
    return _per_group(xs, mesh, axis, lambda g: [
        g[sent[j]].to(x.device, copy=True) if j in sent
        else torch.zeros_like(x) for j, x in enumerate(g)])


def all_to_all(xs, mesh: Mesh, axis: str, split_axis: int, concat_axis: int,
               *, tiled: bool = True) -> List[torch.Tensor]:
    """Shard j gets block j of every shard's ``split_axis``, in shard
    order: concatenated along ``concat_axis`` (tiled), or, for a split
    axis of size n, which each piece drops, stacked on a new axis at
    ``concat_axis`` (not tiled)."""
    def exchange(g):
        n = len(g)
        parts = _on_first(g)
        if tiled:
            blocks = [torch.chunk(x, n, dim=split_axis) for x in parts]
            if any(len(b) != n or b[0].shape != b[-1].shape
                   for b in blocks):
                raise ValueError(f"split axis {split_axis} does not divide "
                                 f"{n} shards")
            out = [torch.cat([b[j] for b in blocks], dim=concat_axis)
                   for j in range(n)]
        else:
            if any(x.shape[split_axis] != n for x in parts):
                raise ValueError(f"untiled split axis needs size {n}")
            out = [torch.stack([x.select(split_axis, j) for x in parts],
                               dim=concat_axis) for j in range(n)]
        return _deliver(out, g)

    return _per_group(xs, mesh, axis, exchange)


def send_recv(xs, mesh: Mesh, axis: str, src: int, dst: int
              ) -> List[torch.Tensor]:
    """Point to point: dst receives src's value; everyone else holds
    zeros (``ppermute``'s rule)."""
    return permute(xs, mesh, axis, [(src, dst)])
