"""The parallel layer of the PyTorch/CUDA port (counterpart of
``ray_tpu/parallel``): a one-controller device mesh with the standard
axes (mesh.py), logical sharding rules that cut parameter trees into
per-shard tensors (sharding.py), and the strategies of the multi-axis
training step over per-shard tensor lists: ring attention
(ring_attention.py) and Ulysses (ulysses.py) over sp, MoE dispatch and
combine over ep (moe.py) and the GPipe pipeline over pp (pipeline.py).
The reference's multi-host bootstrap (``distributed.py``) waits for
transport across hosts (ROADMAP A.7).
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
    shard_tensor,
)
from ray_tpu_torch.parallel.ring_attention import ring_attention
from ray_tpu_torch.parallel.ulysses import ulysses_attention
from ray_tpu_torch.parallel.moe import (
    load_balancing_loss,
    moe_dispatch_combine,
    top1_router,
)
from ray_tpu_torch.parallel.pipeline import pipeline_spmd

__all__ = [
    "AXES",
    "Mesh",
    "MeshConfig",
    "ShardingRules",
    "get_mesh",
    "kv_cache_specs",
    "load_balancing_loss",
    "make_mesh",
    "mesh_context",
    "mesh_shape",
    "moe_dispatch_combine",
    "pipeline_spmd",
    "ring_attention",
    "shard_params",
    "shard_tensor",
    "top1_router",
    "ulysses_attention",
    "visible_devices",
]
