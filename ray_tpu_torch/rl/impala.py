"""IMPALA's learner (counterpart of ``ray_tpu/rl/impala.py``): the
V-trace targets and the learner update, the update one device program (a
CUDA graph on the card, eager on the CPU).

The reference's learner is an asynchronous actor loop: env-runner actors
keep one sample in flight each while the learner runs the V-trace update
on whichever rollout lands first. That loop (``IMPALA.__init__``'s
runners, ``train`` and ``stop``) runs on the runtime's actors, ``wait``,
``get`` and ``kill``, and is not ported onto the port's runtime yet
(ROADMAP A.5): here
``IMPALA`` owns the parameters and the optimizer, ``update(rollout)`` is
the learner step the reference's loop runs on each rollout, and ``train``
and ``stop`` raise.

Parameters keep the reference's policy tree and are updated in place (the
graph's static buffers). The optimizer is the reference's
``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr))``, written
out as PPO's ``_Adam``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rl._graph import GraphProgram
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env import TorchEnv
from ray_tpu_torch.rl.ppo import (
    Rollout,
    _Adam,
    clone_params,
    copy_params_,
    init_policy,
    leaves,
    policy_logits,
    value_fn,
)

_NEEDS_RUNTIME = ("IMPALA's asynchronous actor loop on the port's "
                  "runtime (actors, wait, get, kill) is not ported yet: "
                  "ROADMAP A.5")


@dataclasses.dataclass(frozen=True)
class IMPALAConfig:
    hidden: Tuple[int, ...] = (64, 64)
    lr: float = 5e-3
    gamma: float = 0.99
    rho_clip: float = 1.0     # V-trace importance-weight clip (rho-bar)
    c_clip: float = 1.0       # V-trace trace-cutting clip (c-bar)
    vf_coef: float = 0.5
    entropy_coef: float = 0.01
    max_grad_norm: float = 0.5


def vtrace(behavior_logp, target_logp, rewards, dones, values, v_boot,
           gamma, rho_clip, c_clip):
    """V-trace targets and policy-gradient advantages over a ``[T, N]``
    rollout (arXiv:1802.01561): ``(vs, pg_adv, rho)``, ``vs`` and
    ``pg_adv`` detached as the reference's ``stop_gradient`` does. The
    reference's reverse ``lax.scan`` is a loop over T of tensor ops with
    no host sync, so it runs inside a CUDA graph. ``dones`` may be bool."""
    rho = torch.exp(target_logp - behavior_logp)
    rho_bar = torch.clamp(rho, max=rho_clip)
    c_bar = torch.clamp(rho, max=c_clip)
    discounts = gamma * (1.0 - dones.to(rewards.dtype))
    v_next = torch.cat([values[1:], v_boot[None]], 0)
    deltas = rho_bar * (rewards + discounts * v_next - values)
    acc = torch.zeros_like(v_boot)
    corrections = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        acc = deltas[t] + discounts[t] * c_bar[t] * acc
        corrections[t] = acc
    vs = values + torch.stack(corrections)
    vs_next = torch.cat([vs[1:], v_boot[None]], 0)
    pg_adv = rho_bar * (rewards + discounts * vs_next - values)
    return vs.detach(), pg_adv.detach(), rho


def impala_loss(params, rollout: Rollout, cfg: IMPALAConfig):
    """The reference's ``loss_fn``: the V-trace policy loss, the value
    loss toward ``vs`` and the entropy bonus. The bootstrap value is the
    behaviour policy's on obs_T, ``rollout.values[-1]``, as the
    reference takes it."""
    T, N = rollout.actions.shape
    obs = rollout.obs.reshape(T * N, -1)
    logits = policy_logits(params, obs).reshape(T, N, -1)
    logp_all = torch.log_softmax(logits, -1)
    logp = logp_all.gather(-1, rollout.actions[..., None].long())[..., 0]
    values = value_fn(params, obs).reshape(T, N)
    vs, pg_adv, _ = vtrace(
        rollout.log_probs, logp, rollout.rewards, rollout.dones, values,
        rollout.values[-1], cfg.gamma, cfg.rho_clip, cfg.c_clip)
    policy_loss = -torch.mean(logp * pg_adv)
    vf_loss = 0.5 * torch.mean((vs - values) ** 2)
    entropy = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, -1))
    return (policy_loss + cfg.vf_coef * vf_loss
            - cfg.entropy_coef * entropy)


class IMPALA:
    """IMPALA's learner: the parameters, the optimizer and the V-trace
    update as one device program per rollout shape. ``num_envs`` and
    ``rollout_len`` give ``steps_per_sample``, the transitions of one
    runner's sample; ``num_runners`` is the reference's and starts no
    runner here (the runners wait for A.5)."""

    def __init__(self, env: TorchEnv, config: IMPALAConfig = IMPALAConfig(),
                 *, num_runners: int = 2, num_envs: int = 32,
                 rollout_len: int = 64, seed: int = 0, device="cuda"):
        self.env = env
        self.config = config
        self.device = resolve_device(device)
        init = torch.Generator(device=self.device).manual_seed(seed)
        self.params = clone_params(init_policy(
            init, env.obs_dim, env.num_actions, config.hidden), True)
        self._leaves = leaves(self.params)
        self._opt = _Adam(self._leaves, config.lr, config.max_grad_norm)
        self.steps_per_sample = num_envs * rollout_len
        # Rollout shapes -> (static rollout, GraphProgram).
        self._programs: Dict[tuple, tuple] = {}
        self.stats: Dict[str, float] = {}

    def _update(self, rollout: Rollout) -> torch.Tensor:
        with torch.enable_grad():
            loss = impala_loss(self.params, rollout, self.config)
            grads = torch.autograd.grad(loss, self._leaves)
        self._opt.step(self._leaves, grads)
        return loss.detach()

    def _program(self, rollout: Rollout):
        shapes = tuple(tuple(t.shape) for t in rollout)
        entry = self._programs.get(shapes)
        if entry is None:
            static = Rollout(*(torch.empty_like(t, device=self.device)
                               for t in rollout))
            program = GraphProgram(
                lambda: self._update(static), self.device,
                state=self._leaves + self._opt.state())
            entry = self._programs[shapes] = (static, program)
        return entry

    def update(self, rollout: Rollout) -> float:
        """One learner step on ``rollout`` (the step the reference's loop
        runs on each landed sample); returns the loss before the step."""
        static, program = self._program(rollout)
        with torch.no_grad():
            for dst, src in zip(static, rollout):
                dst.copy_(src)
        return float(program())

    def get_weights(self):
        return self.params

    def set_weights(self, params) -> None:
        copy_params_(self.params, params)

    def evaluate(self, num_episodes: int = 8) -> Dict[str, float]:
        """Greedy episodes of the current policy, through ``Algorithm``'s
        evaluate with a PPO learner holding these weights (as the
        reference does)."""
        algo = Algorithm(AlgorithmConfig("PPO", device=self.device)
                         .environment(env_factory=lambda: self.env))
        algo.learner.set_weights(self.params)
        return algo.evaluate(num_episodes)

    def train(self, num_updates: int = 50) -> Dict[str, float]:
        raise NotImplementedError(_NEEDS_RUNTIME)

    def stop(self) -> None:
        raise NotImplementedError(_NEEDS_RUNTIME)
