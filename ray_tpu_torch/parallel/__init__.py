"""The parallel layer of the PyTorch/CUDA port (counterpart of
``ray_tpu/parallel``): a one-controller device mesh with the standard
axes (mesh.py) and logical sharding rules that cut parameter trees into
per-shard tensors (sharding.py). Ring attention, Ulysses, MoE dispatch,
the pipeline and the multi-host mesh wait for the multi-axis training
step (ROADMAP A.2, A.4).
"""

from ray_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    MeshConfig,
    get_mesh,
    make_mesh,
    mesh_context,
    mesh_shape,
    visible_devices,
)
from ray_tpu_torch.parallel.sharding import (
    ShardingRules,
    kv_cache_specs,
    shard_params,
)

__all__ = [
    "AXES",
    "Mesh",
    "MeshConfig",
    "ShardingRules",
    "get_mesh",
    "kv_cache_specs",
    "make_mesh",
    "mesh_context",
    "mesh_shape",
    "shard_params",
    "visible_devices",
]
