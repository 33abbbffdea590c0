"""TorchTrainer, prepare_model and prepare_data_loader (counterpart of
``ray_tpu/train/torch.py``).

The reference wraps nothing in torch DDP: data-parallel gradient
averaging rides the worker group's actor-plane collective group.
``prepare_model`` broadcasts rank 0's parameters and attaches
post-accumulate-grad hooks that, once per backward pass, run ONE fused
allreduce (mean) over the flattened gradients. Here the collective is
the port's (``collective/collective.py``) and works on the parameters'
own device: a CUDA gradient goes through the rendezvous as a device copy,
with no round trip through numpy. The trainer runs each loop with
autograd's multithreading off, so the hooks and the allreduce run on the
rank's own thread.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.collective import collective
from ray_tpu_torch.train.session import get_context
from ray_tpu_torch.train.trainer import DataParallelTrainer


class TorchTrainer(DataParallelTrainer):
    """Reference-shaped entry point: ``train_loop_per_worker`` is a
    plain torch loop using ``prepare_model``/``prepare_data_loader``;
    scaling, failure recovery, checkpoints and reporting are the shared
    worker-group machinery."""


def prepare_model(model):
    """DDP-equivalent: broadcast rank 0's initial parameters to every
    rank, then average gradients across the group after each backward
    pass. Returns the SAME module (hook-instrumented), so optimizers
    built on its parameters keep working."""
    ctx = get_context()
    world = ctx.get_world_size()
    if world <= 1:
        return model
    group = ctx.collective_group

    # 1. Parameter sync: everyone adopts rank 0's init.
    with torch.no_grad():
        flat = torch.cat([p.detach().reshape(-1)
                          for p in model.parameters()])
        synced = collective.broadcast(flat, src_rank=0, group_name=group)
        offset = 0
        for p in model.parameters():
            n = p.numel()
            p.copy_(synced[offset:offset + n].view_as(p))
            offset += n

    # 2. Gradient averaging: one fused allreduce per backward pass.
    # Completion is tracked PER BACKWARD PASS, not by counting hook
    # arrivals: the first hook to fire queues an autograd engine
    # callback that runs once the whole backward graph finishes. A
    # counter (len(params) arrivals) desyncs permanently the first time
    # any parameter receives no grad (frozen layer, unused branch,
    # conditional model path). The engine callback runs exactly once per
    # backward however many hooked params took part (params with no grad
    # contribute zeros to the fused mean, as DDP's
    # find_unused_parameters=True).
    #
    # Limitation (as in DDP): if a rank runs a backward in which NO hooked
    # parameter receives a grad, that rank skips its allreduce while the
    # others block in theirs. Keep at least one shared parameter on every
    # backward path.
    params = [p for p in model.parameters() if p.requires_grad]
    state = {"queued": False}

    def _sync_all():
        with torch.no_grad():
            grads = [(p.grad if p.grad is not None
                      else torch.zeros_like(p)).reshape(-1)
                     for p in params]
            mean = collective.allreduce(torch.cat(grads), group_name=group,
                                        op="mean")
            off = 0
            for p in params:
                n = p.numel()
                g = mean[off:off + n].view_as(p)
                if p.grad is None:
                    p.grad = g.clone()
                else:
                    p.grad.copy_(g)
                off += n

    def _finalize():
        # Dedupe guard INSIDE the callback, not the hook: every hook
        # queues a callback, only the first to run syncs. A failed
        # backward drops its queued callbacks without running them;
        # gating the QUEUEING on the flag would then disable syncing
        # forever, gating the SYNC recovers on the next backward.
        if state["queued"]:
            state["queued"] = False
            _sync_all()

    def _hook(_param):
        state["queued"] = True
        torch.autograd.Variable._execution_engine.queue_callback(_finalize)

    for p in params:
        p.register_post_accumulate_grad_hook(_hook)
    model._ray_tpu_sync_gradients = _sync_all  # manual escape hatch
    return model


def prepare_data_loader(loader):
    """Shard a DataLoader across the worker group: rebuilds it with a
    rank-aware DistributedSampler (no torch.distributed init needed:
    replicas and rank are passed explicitly)."""
    import torch.utils.data as tud

    ctx = get_context()
    world = ctx.get_world_size()
    if world <= 1:
        return loader
    sampler = tud.distributed.DistributedSampler(
        loader.dataset, num_replicas=world,
        rank=ctx.get_world_rank(), shuffle=False)
    return tud.DataLoader(
        loader.dataset, batch_size=loader.batch_size, sampler=sampler,
        num_workers=0, collate_fn=loader.collate_fn,
        drop_last=loader.drop_last)
