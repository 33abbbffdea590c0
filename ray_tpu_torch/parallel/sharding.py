"""Logical-axis sharding rules (counterpart of
``ray_tpu/parallel/sharding.py``, copied and trimmed).

Model code names its array axes logically ("embed", "mlp", "heads", ...)
and a ``ShardingRules`` table maps each logical name to a mesh axis. A
spec is a plain tuple with one entry per array dimension: a mesh axis
name, a tuple of names, or None (replicated); it stands for the
reference's ``PartitionSpec``, and a spec shorter than the array leaves
the trailing dimensions whole. The reference hands specs to GSPMD, which
places the shards and inserts the collectives; here ``shard_params``
cuts each leaf into per-shard tensors on the shards' devices, and the
model code calls ``ray_tpu_torch.collective`` itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ray_tpu_torch.parallel.mesh import Mesh

MeshAxis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxis, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Map from logical array-axis names to mesh axis (or None =
    replicate). The defaults are the Megatron recipe of the reference:
    batch over (dp, fsdp), sequence over sp, embed replicated, attention
    heads, KV heads, the MLP's hidden width and the vocabulary on tp,
    2-D weights' other axis on fsdp (ZeRO-3), experts over ep and the
    stacked-layer axis over pp."""

    batch: MeshAxis = ("dp", "fsdp")
    sequence: MeshAxis = "sp"
    embed: MeshAxis = None
    mlp: MeshAxis = "tp"
    heads: MeshAxis = "tp"
    kv_heads: MeshAxis = "tp"
    head_dim: MeshAxis = None
    vocab: MeshAxis = "tp"
    expert: MeshAxis = "ep"
    stage: MeshAxis = "pp"
    fsdp_shard: MeshAxis = "fsdp"  # axis that ZeRO-shards 2D weights

    def spec(self, *logical: Optional[str]) -> Spec:
        """The spec of an array whose axes have these logical names."""
        return tuple(None if name is None else getattr(self, name)
                     for name in logical)


def kv_cache_specs(rules: Optional[ShardingRules] = None) -> Dict[str, Spec]:
    """Specs of the paged KV pool ``{"k", "v"}`` (``[L, num_blocks,
    block_size, n_kv_heads, head_dim]``): sharded along ``n_kv_heads``, so
    each shard's pool holds the KV heads of its attention heads. Block
    ids stay global (the host block manager does not see the mesh)."""
    r = rules or ShardingRules()
    spec = (None, None, None, r.kv_heads, None)
    return {"k": spec, "v": spec}


def _block(mesh: Mesh, coord: Tuple[int, ...], entry: MeshAxis
           ) -> Tuple[int, int]:
    """(index, count) of the block that the device at ``coord`` holds of a
    dimension sharded over ``entry``'s axes (row-major over them)."""
    names = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    index, count = 0, 1
    for a in names:
        if a not in mesh.axis_names:
            raise ValueError(
                f"mesh has no axis {a!r}; axes: {mesh.axis_names}")
        k = mesh.axis_names.index(a)
        index = index * mesh.devices.shape[k] + coord[k]
        count *= mesh.devices.shape[k]
    return index, count


def shard_tensor(x: torch.Tensor, mesh: Mesh, spec: Spec
                 ) -> List[torch.Tensor]:
    """``x`` cut by ``spec``: one tensor per device of this process in the
    mesh (every device of a one-process mesh), in the order of
    ``mesh.devices.flat``, each a contiguous copy of its block on its
    device."""
    return _cut(x, mesh, spec, rows=None)


def data_rows(mesh: Mesh, entry: MeshAxis = ("dp", "fsdp")
              ) -> Tuple[int, int]:
    """(index, count) of this process's rows of a batch cut over
    ``entry``'s axes: each process feeds the blocks its shards hold, the
    mesh's processes hold ``count`` distinct sets of blocks, and this
    process's set is the ``index``-th in process order. Processes that
    differ only along other axes (``tp``, ``sp``, ``ep`` or ``pp`` across
    processes) hold the same set, so they feed the same rows; where only
    ``dp`` or ``fsdp`` crosses processes every process holds its own set
    and this is (process index, process count)."""
    owner = mesh.processes.reshape(-1)
    held: Dict[int, set] = {}
    for flat in range(mesh.size):
        coord = np.unravel_index(flat, mesh.devices.shape)
        held.setdefault(int(owner[flat]), set()).add(
            _block(mesh, coord, entry)[0])
    sets = []
    for p in sorted(held):
        if held[p] not in sets:
            sets.append(held[p])
    return sets.index(held[mesh.process]), len(sets)


def shard_host_local(x: torch.Tensor, mesh: Mesh, spec: Spec
                     ) -> List[torch.Tensor]:
    """``shard_tensor`` of a global array of which ``x`` holds only this
    process's rows (dimension 0), as
    ``distributed.host_local_batch_slice(..., mesh=mesh)`` gives them:
    the rows of the blocks (over ``spec[0]``'s axes) that this process's
    shards hold, the ``data_rows`` slice of equal slices in process
    order. Each of this process's shards takes its block of the global
    array from ``x``; a block that lies outside this process's rows
    raises. With one process it is ``shard_tensor``."""
    index, count = data_rows(mesh, spec[0] if spec else None)
    return _cut(x, mesh, spec,
                rows=(index * x.shape[0], x.shape[0] * count))


def _cut(x, mesh, spec, rows):
    """This process's blocks of ``x`` by ``spec``; ``rows`` is None (``x``
    is the whole array) or (start, total) of the rows of the global
    array that ``x`` holds."""
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{x.dim()}-d array")
    out = []
    for flat in mesh.local_indices:
        coord = np.unravel_index(flat, mesh.devices.shape)
        index = []
        for dim, entry in enumerate(spec):
            i, n = _block(mesh, coord, entry)
            start, size = (rows if dim == 0 and rows is not None
                           else (0, x.shape[dim]))
            if size % n:
                raise ValueError(
                    f"dimension {dim} of size {size} does not divide "
                    f"{n} shards (spec {spec})")
            step = size // n
            lo = i * step - start
            if not 0 <= lo <= x.shape[dim] - step:
                raise ValueError(
                    f"shard {flat}'s rows [{i * step}, {(i + 1) * step}) "
                    f"are not among this process's rows [{start}, "
                    f"{start + x.shape[0]})")
            index.append(slice(lo, lo + step))
        out.append(x[tuple(index)].to(
            device=mesh.devices[coord], copy=True,
            memory_format=torch.contiguous_format))
    return out


def shard_params(params: Any, mesh: Mesh, spec_tree: Any) -> List[Any]:
    """Cut a parameter tree by a matching tree of specs (a model's
    ``param_specs()``): the list of per-shard trees, one per device of
    this process in the mesh, in the order of ``mesh.devices.flat``."""
    def cut(tree, specs):
        if isinstance(tree, dict):
            return {k: cut(tree[k], specs[k]) for k in tree}
        return shard_tensor(tree, mesh, specs)

    def pick(tree, j):
        if isinstance(tree, dict):
            return {k: pick(v, j) for k, v in tree.items()}
        return tree[j]

    pieces = cut(params, spec_tree)
    return [pick(pieces, j) for j in range(mesh.local_size)]
