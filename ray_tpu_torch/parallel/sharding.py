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
    """``x`` cut by ``spec``: one tensor per device of the mesh, in the
    order of ``mesh.devices.flat``, each a contiguous copy of its block on
    its device."""
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{x.dim()}-d array")
    out = []
    for coord in np.ndindex(*mesh.devices.shape):
        index = []
        for dim, entry in enumerate(spec):
            i, n = _block(mesh, coord, entry)
            size = x.shape[dim]
            if size % n:
                raise ValueError(
                    f"dimension {dim} of size {size} does not divide "
                    f"{n} shards (spec {spec})")
            step = size // n
            index.append(slice(i * step, (i + 1) * step))
        out.append(x[tuple(index)].to(
            device=mesh.devices[coord], copy=True,
            memory_format=torch.contiguous_format))
    return out


def shard_params(params: Any, mesh: Mesh, spec_tree: Any) -> List[Any]:
    """Cut a parameter tree by a matching tree of specs (a model's
    ``param_specs()``): the list of per-shard trees, one per device of the
    mesh in the order of ``mesh.devices.flat``."""
    def cut(tree, specs):
        if isinstance(tree, dict):
            return {k: cut(tree[k], specs[k]) for k in tree}
        return shard_tensor(tree, mesh, specs)

    def pick(tree, j):
        if isinstance(tree, dict):
            return {k: pick(v, j) for k, v in tree.items()}
        return tree[j]

    pieces = cut(params, spec_tree)
    return [pick(pieces, j) for j in range(mesh.size)]
