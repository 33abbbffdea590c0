"""DQN learner (counterpart of ``ray_tpu/rl/dqn.py``): double-DQN targets,
Huber loss, replay training with a periodic hard target sync.

It shares the PPO ``EnvRunner`` unchanged: the Q-network lives in the
same ``{"pi": ..., "vf": ...}`` tree, so the runner's categorical sampling
over ``policy_logits`` is Boltzmann exploration over Q-values. Rollouts
feed a numpy ``ReplayBuffer``; each ``update`` samples
``train_steps_per_iter`` minibatches with the learner's numpy generator
and runs all their gradient steps as one device program (``train_many``:
a CUDA graph on the card, eager on the CPU) over the stacked minibatches,
with the target network frozen within it. Parameters, target and Adam
state are the program's static buffers, updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rl._graph import GraphProgram
from ray_tpu_torch.rl.ppo import (
    Rollout,
    _Adam,
    clone_params,
    copy_params_,
    init_policy,
    leaves,
    policy_logits,
)
from ray_tpu_torch.rl.replay import ReplayBuffer


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    hidden: Tuple[int, ...] = (64, 64)
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_capacity: int = 50_000
    batch_size: int = 128
    train_steps_per_iter: int = 32
    target_update_freq: int = 100  # gradient steps between hard syncs
    min_buffer_size: int = 500


def huber_loss(pred, target, delta: float = 1.0):
    """``optax.huber_loss``, elementwise."""
    abs_err = (pred - target).abs()
    quadratic = torch.minimum(abs_err, torch.full_like(abs_err, delta))
    return 0.5 * quadratic**2 + delta * (abs_err - quadratic)


def dqn_loss(params, target_params, batch, gamma: float):
    """The reference's double-DQN loss: online argmax, target evaluation,
    no gradient through the target."""
    q = policy_logits(params, batch["obs"])                  # [B, A]
    q_sa = q.gather(-1, batch["actions"][:, None].long())[:, 0]
    with torch.no_grad():
        best = torch.argmax(policy_logits(params, batch["next_obs"]), -1)
        q_next = policy_logits(target_params, batch["next_obs"]).gather(
            -1, best[:, None])[:, 0]
        target = batch["rewards"] + gamma * (1.0 - batch["dones"]) * q_next
    return torch.mean(huber_loss(q_sa, target))


class DQNLearner:
    """Learner-interface parity with PPOLearner: get_weights() feeds the
    shared EnvRunner, update(rollout) consumes its samples."""

    def __init__(self, env, config: DQNConfig = DQNConfig(), seed: int = 0,
                 device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        init = torch.Generator(device=self.device).manual_seed(seed)
        self.params = clone_params(init_policy(
            init, env.obs_dim, env.num_actions, config.hidden), True)
        self.target_params = clone_params(self.params)
        self._leaves = leaves(self.params)
        self._opt = _Adam(self._leaves, config.lr)
        self._buffer = ReplayBuffer(config.buffer_capacity)
        self._rng = np.random.default_rng(seed + 13)
        self._steps = 0
        self._batches: Optional[Dict[str, torch.Tensor]] = None
        self._program: Optional[GraphProgram] = None

    def train_many(self, batches: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Every gradient step over ``batches`` (each ``[K, B, ...]``) in
        order, the target fixed; returns the mean loss. The body of the
        device program."""
        losses = []
        for i in range(batches["actions"].shape[0]):
            batch = {k: v[i] for k, v in batches.items()}
            with torch.enable_grad():
                loss = dqn_loss(self.params, self.target_params, batch,
                                self.config.gamma)
                # The value tower is unused: zero gradients, as jax.grad
                # gives (Adam then leaves it in place).
                grads = torch.autograd.grad(loss, self._leaves,
                                            materialize_grads=True)
            self._opt.step(self._leaves, grads)
            losses.append(loss.detach())
        return torch.stack(losses).mean()

    def get_weights(self):
        return self.params

    def set_weights(self, params):
        copy_params_(self.params, params)

    def update(self, rollout: Rollout, key=None) -> float:
        obs = rollout.obs.cpu().numpy()            # [T, N, D]
        self._buffer.add_rollout(
            obs[:-1], rollout.actions.cpu().numpy()[:-1],
            rollout.rewards.cpu().numpy()[:-1],
            rollout.dones.cpu().numpy()[:-1], obs[1:])
        if len(self._buffer) < self.config.min_buffer_size:
            return float("nan")
        return self.train_from_buffer()

    def train_from_buffer(self) -> float:
        """One iteration of gradient steps from the current buffer, its
        minibatches sampled with the learner's numpy generator."""
        if len(self._buffer) == 0:
            return float("nan")
        k = self.config.train_steps_per_iter
        samples = [self._buffer.sample(self.config.batch_size, self._rng)
                   for _ in range(k)]
        batches = {key: torch.from_numpy(np.stack([s[key] for s in samples]))
                   for key in samples[0]}
        if self._program is None:
            self._batches = {key: torch.empty_like(v, device=self.device)
                             for key, v in batches.items()}
            self._program = GraphProgram(
                lambda: self.train_many(self._batches), self.device,
                state=self._leaves + self._opt.state())
        for key, v in batches.items():
            self._batches[key].copy_(v)
        loss = float(self._program())
        self._steps += k
        # Hard target sync at iteration granularity (the target stays
        # frozen within an iteration, as in the reference).
        if self._steps // self.config.target_update_freq > (
                self._steps - k) // self.config.target_update_freq:
            copy_params_(self.target_params, self.params)
        return loss
