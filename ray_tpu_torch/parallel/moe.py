"""Expert parallelism: MoE token dispatch and combine over the ``ep``
axis (counterpart of ``ray_tpu/parallel/moe.py``).

Top-1 router -> capacity-bucketed dense dispatch -> ``all_to_all`` to the
expert's shard -> expert MLP -> ``all_to_all`` back -> weighted combine.
Tokens over an expert's capacity are dropped: they combine to zeros and
pass through the residual (switch-transformer semantics).

One controller drives every shard: ``xs`` and ``router_logits`` are
per-shard lists over a mesh (one group along the axis, or every shard of
the mesh in the order of ``mesh.devices.flat``), and ``expert_fn`` maps
the list of per-shard dispatched buffers to the list of expert outputs
(it may hold collectives of its own, a tensor-parallel sum). Types follow
the reference's: the f32 gate times the expert output in the model's
type gives f32, as ``jnp`` promotes it.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ray_tpu_torch.collective import ops as cops
from ray_tpu_torch.parallel.mesh import Mesh


def top1_router(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [T, E] -> (expert_idx [T], gate [T])."""
    idx = torch.argmax(logits, dim=-1)
    gate = torch.softmax(logits, dim=-1)[
        torch.arange(logits.shape[0], device=logits.device), idx]
    return idx, gate


def _dispatch(x, logits, E, cap):
    """One shard's routing and dense dispatch buffer [E, cap, D]."""
    T, D = x.shape
    idx, gate = top1_router(logits)
    # Position of each token within its expert's capacity bucket.
    onehot = F.one_hot(idx, E).to(torch.int32)               # [T, E]
    pos = torch.cumsum(onehot, dim=0) * onehot                # 1-based
    pos_in_expert = torch.sum(pos, dim=-1) - 1                # [T]
    keep = pos_in_expert < cap
    gate = gate.masked_fill(~keep, 0.0)
    safe_pos = torch.clamp(pos_in_expert, 0, cap - 1).long()
    # Dropped tokens add zeros at the clipped slot.
    disp = torch.zeros((E, cap, D), dtype=x.dtype, device=x.device)
    disp = disp.index_put((idx, safe_pos), x.masked_fill(~keep[:, None], 0),
                          accumulate=True)
    return disp, (idx, safe_pos, keep, gate)


def moe_dispatch_combine(
    xs: Sequence[torch.Tensor],
    router_logits: Sequence[torch.Tensor],
    expert_fn: Callable[[List[torch.Tensor]], List[torch.Tensor]],
    *,
    mesh: Mesh,
    num_experts: int,
    capacity_factor: float = 1.25,
    axis_name: str = "ep",
) -> List[torch.Tensor]:
    """xs per-shard [T, D]; router_logits per-shard [T, E_global].
    ``expert_fn`` maps the per-shard [E_local, C_total, D] buffers to
    per-shard [E_local, C_total, D] (the expert MLP over each shard's
    experts). Returns the per-shard [T, D] combined outputs."""
    n = cops.axis_size(mesh, axis_name)
    T, D = xs[0].shape
    E = num_experts
    if E % n:
        raise ValueError(f"experts {E} not divisible by {axis_name} size {n}")
    e_local = E // n
    cap = max(1, int(capacity_factor * T / E))

    routed = [_dispatch(x, lg, E, cap) for x, lg in zip(xs, router_logits)]
    # all_to_all: every shard sends its [e_local, cap, D] slab for each
    # peer; the leading axis becomes the source shard.
    disp = cops.all_to_all([d.reshape(n, e_local, cap, D) for d, _ in routed],
                           mesh, axis_name, split_axis=0, concat_axis=0,
                           tiled=True)
    # Merge source shards into the capacity axis: [e_local, n*cap, D].
    disp = [d.reshape(n, e_local, cap, D).permute(1, 0, 2, 3)
            .reshape(e_local, n * cap, D) for d in disp]

    outs = expert_fn(disp)                           # [e_local, n*cap, D]

    # Inverse route: split capacity back per source, all_to_all home.
    outs = [o.reshape(e_local, n, cap, D).permute(1, 0, 2, 3)
            .reshape(n, e_local, cap, D) for o in outs]
    outs = cops.all_to_all(outs, mesh, axis_name, split_axis=0,
                           concat_axis=0, tiled=True)
    combined = []
    for o, (_, (idx, safe_pos, keep, gate)) in zip(outs, routed):
        c = o.reshape(E, cap, D)[idx, safe_pos] * gate[:, None]
        combined.append(c.masked_fill(~keep[:, None], 0.0))
    return combined


def load_balancing_loss(router_logits: torch.Tensor,
                        expert_idx: torch.Tensor,
                        num_experts: int) -> torch.Tensor:
    """Switch-transformer auxiliary loss: E * <fraction routed> . <router
    prob>."""
    probs = torch.softmax(router_logits, dim=-1)
    frac = torch.mean(F.one_hot(expert_idx, num_experts).to(probs.dtype),
                      dim=0)
    return num_experts * torch.sum(frac * torch.mean(probs, dim=0))
