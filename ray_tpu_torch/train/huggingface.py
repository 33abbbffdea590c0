"""TransformersTrainer: fine-tune a PyTorch ``transformers`` model over
dataset shards (counterpart of ``ray_tpu/train/huggingface.py``).

The reference fine-tunes a Flax model with one jitted optax step; here
the per-worker loop runs the PyTorch model of the same config on
``device`` (the card unless the caller names another), moves every
batch there, and takes one autograd step and one optimizer step per
batch. With more than one worker the model goes through
``prepare_model`` (``train/torch.py``): rank 0's initial parameters are
broadcast (the reference's Flax models start equal from their seed; a
PyTorch model built from a config draws from torch's global generator,
which concurrent ranks share), and each backward pass averages the
gradients over the worker group in ONE fused allreduce (mean) through
the actor-plane collective group, on the gradients' own device. The
ranks first agree on the least step count.

Three choices follow the reference's numbers:

- **Dropout off.** The reference calls the Flax model with its default
  ``train=False``, so its fine-tuning runs without dropout; the loop runs
  the model in ``eval()`` mode to match (ROADMAP C.17).
- **The default optimizer is ``optax.adamw(lr)``'s**: AdamW with betas
  (0.9, 0.999), eps 1e-8 and weight decay 1e-4 on every parameter,
  ``lr = config.get("lr", 5e-5)``. ``optimizer`` is a callable that takes
  the parameters and returns a ``torch.optim.Optimizer``.
- **The default loss** is the reference's: cross-entropy over integer
  labels, or the mean squared error where ``logits.ndim == labels.ndim``.

``transformers`` is imported inside the loop only. It picks its
frameworks at its first import and, where ``flax`` is installed, imports
JAX even for a PyTorch model; unless it is loaded already (or the caller
set ``USE_TORCH`` / ``USE_TF`` / ``USE_FLAX``), the loop selects PyTorch
alone first.

``bert_state_dict_from_flax`` carries a Flax BERT's parameter tree into
the ``state_dict`` of the PyTorch model of the same config, without
``transformers``' own Flax loader (which imports flax and JAX).
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.trainer import DataParallelTrainer

# model_init runs under this lock: ranks on the thread plane would
# otherwise interleave their draws from torch's global generator.
_INIT_LOCK = threading.Lock()

# optax.adamw's defaults.
ADAMW_BETAS, ADAMW_EPS, ADAMW_WEIGHT_DECAY = (0.9, 0.999), 1e-8, 1e-4


def _select_torch_framework():
    """Make ``transformers`` load PyTorch alone (module docstring)."""
    if "transformers" not in sys.modules:
        for key, value in (("USE_TORCH", "1"), ("USE_TF", "0"),
                           ("USE_FLAX", "0")):
            os.environ.setdefault(key, value)
    import transformers  # noqa: F401


def _default_loss(logits, labels):
    if logits.ndim == labels.ndim:  # regression
        return torch.mean((logits - labels) ** 2)
    return F.cross_entropy(logits, labels.long())


def default_optimizer(lr: float = 5e-5) -> Callable:
    """``optax.adamw(lr)`` as a torch optimizer factory."""
    return lambda params: torch.optim.AdamW(
        params, lr=lr, betas=ADAMW_BETAS, eps=ADAMW_EPS,
        weight_decay=ADAMW_WEIGHT_DECAY)


def _train_step(model, opt, lf, batch, dev):
    """One step on ``batch`` (a dict of arrays holding ``labels``): the
    loss, its gradients (averaged over the group by ``prepare_model``'s
    hooks), then the optimizer's update. Returns the loss before the
    update."""
    batch = {k: torch.as_tensor(np.asarray(v)).to(dev)
             for k, v in batch.items()}
    labels = batch.pop("labels")
    loss = lf(model(**batch).logits, labels)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    return loss.detach()


def _make_transformers_loop(model_init: Callable[[], Any], optimizer,
                            loss_fn, num_epochs: int, batch_size: int,
                            report_every: int, device):
    def loop(config: Optional[Dict[str, Any]] = None):
        config = config or {}
        from ray_tpu_torch import train
        from ray_tpu_torch.collective import collective
        from ray_tpu_torch.device import resolve_device
        from ray_tpu_torch.train.torch import prepare_model

        _select_torch_framework()
        ctx = train.get_context()
        world, rank = ctx.get_world_size(), ctx.get_world_rank()
        group = ctx.collective_group
        dev = resolve_device(device)
        with _INIT_LOCK:
            model = model_init()
        model.to(dev)
        model.eval()   # dropout off: the reference's train=False
        model = prepare_model(model)
        opt = (optimizer or default_optimizer(config.get("lr", 5e-5)))(
            [p for p in model.parameters() if p.requires_grad])
        lf = loss_fn or _default_loss
        ds = train.get_dataset_shard("train")

        def batches():
            for _ in range(num_epochs):
                yield from ds.iter_batches(batch_size=batch_size)

        if world > 1:
            # Ranks must agree on the step count or the per-step
            # allreduce deadlocks on uneven shards: the group's least
            # local batch count (drop-tail DP).
            local_steps = sum(1 for _ in batches())
            n_steps = int(collective.allreduce(
                torch.tensor(local_steps), group_name=group, op="min"))
        else:
            n_steps = None   # exhaust the iterator

        step_idx = 0
        last_loss = float("nan")
        for batch in batches():
            if n_steps is not None and step_idx >= n_steps:
                break
            last_loss = float(_train_step(model, opt, lf, batch, dev))
            step_idx += 1
            if step_idx % report_every == 0:
                train.report({"loss": last_loss, "step": step_idx,
                              "rank": rank})
        train.report({"loss": last_loss, "step": step_idx, "rank": rank,
                      "done": True})

    return loop


class TransformersTrainer(DataParallelTrainer):
    """Fine-tune a PyTorch transformers model over dataset shards.

    ``datasets={"train": ds}`` must yield batches holding the model's
    input arrays plus ``labels``. ``model_init()`` builds the model (on
    any device: the loop moves it to ``device``).
    """

    def __init__(self, *, model_init: Callable[[], Any],
                 optimizer: Optional[Callable] = None,
                 loss_fn: Optional[Callable] = None,
                 num_epochs: int = 1,
                 batch_size: int = 8,
                 report_every: int = 10,
                 train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 device="cuda"):
        super().__init__(
            _make_transformers_loop(model_init, optimizer, loss_fn,
                                    num_epochs, batch_size, report_every,
                                    device),
            train_loop_config=train_loop_config or {},
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets)


def bert_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the PyTorch BERT model (any head: the
    pooler and the classifier included) whose config the Flax model's
    parameter tree ``params`` (numpy or JAX arrays) belongs to.

    Module paths join with "."; a Dense ``kernel`` [in, out] becomes
    ``weight`` [out, in], a LayerNorm ``scale`` and an embedding's
    ``embedding`` become ``weight``, a ``bias`` stays ``bias``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            name = f"{prefix}.{key}" if prefix else str(key)
            if hasattr(value, "items"):
                walk(value, name)
                continue
            arr = np.asarray(value)
            head, _, leaf = name.rpartition(".")
            if leaf == "kernel":
                name, arr = f"{head}.weight", arr.T
            elif leaf in ("scale", "embedding"):
                name = f"{head}.weight"
            out[name] = torch.from_numpy(np.ascontiguousarray(arr).copy())

    walk(params, "")
    return out
