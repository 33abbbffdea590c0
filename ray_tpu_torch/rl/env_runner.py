"""EnvRunner: vectorised rollout collection (counterpart of
``ray_tpu/rl/env_runner.py``).

The reference fuses N envs, the policy forward and the value bootstrap
into one jitted ``lax.scan`` over T steps. Here the T steps are a Python
loop over batched tensor ops, run as one device program
(``GraphProgram``): on the card the whole rollout is one captured CUDA
graph, replayed per ``sample``; on the CPU it runs eagerly. The runner
keeps its own copy of the policy in the program's static buffers and
copies fresh weights in before each call.

Randomness: a rollout draws its actions' Gumbel noise and its reset
uniforms from the runner's generator; ``make_rollout_fn(...).with_draws``
takes them as arguments instead, so a test can pass the reference's.
Actions are ``argmax(logits + Gumbel)``, the reference's
``jax.random.categorical``.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rl._graph import GraphProgram
from ray_tpu_torch.rl.env import TorchEnv
from ray_tpu_torch.rl.ppo import (
    Rollout,
    clone_params,
    copy_params_,
    policy_logits,
    value_fn,
)

_TINY = torch.finfo(torch.float32).tiny


def gumbel(u: torch.Tensor) -> torch.Tensor:
    """Gumbel noise from uniforms in [0, 1), as ``jax.random.gumbel``
    maps its uniforms on [tiny, 1)."""
    return -torch.log(-torch.log(u.clamp_min(_TINY)))


def sample_actions(logits: torch.Tensor, noise: torch.Tensor):
    """(action, its log-probability) of ``argmax(logits + noise)``."""
    action = torch.argmax(logits + noise, -1)
    logp = torch.log_softmax(logits, -1).gather(-1, action[:, None])[:, 0]
    return action, logp


def make_rollout_fn(env: TorchEnv, rollout_len: int):
    """(params, env_state, obs, gen) -> (Rollout, env_state, obs) over
    ``[N, ...]`` env state and obs; ``.with_draws(params, env_state, obs,
    noise [T, N, A], reset_u [T, N, draw_dim])`` is the same rollout with
    its draws given."""
    n_logits = max(env.num_actions, 1)

    @torch.no_grad()
    def with_draws(params, state, obs, noise, reset_u):
        outs = []
        for t in range(rollout_len):
            action, logp = sample_actions(policy_logits(params, obs),
                                          noise[t])
            value = value_fn(params, obs)
            state, obs_next, reward, done = env.step(state, action,
                                                     reset_u[t])
            outs.append((obs, action, logp, reward, done, value))
            obs = obs_next
        obs_b, actions, logps, rewards, dones, values = (
            torch.stack(x) for x in zip(*outs))
        values = torch.cat([values, value_fn(params, obs)[None]], 0)
        return (Rollout(obs_b, actions, logps, rewards, dones, values),
                state, obs)

    def rollout(params, state, obs, gen):
        n = obs.shape[0]
        noise = gumbel(torch.rand((rollout_len, n, n_logits), generator=gen,
                                  device=gen.device))
        reset_u = torch.rand((rollout_len, n, env.draw_dim), generator=gen,
                             device=gen.device)
        return with_draws(params, state, obs, noise, reset_u)

    rollout.with_draws = with_draws
    return rollout


class _EnvRunnerImpl:
    def __init__(self, env: TorchEnv, num_envs: int, rollout_len: int,
                 seed: int = 0, device="cuda"):
        self.env = env
        self.num_envs = num_envs
        self.rollout_len = rollout_len
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        state, obs = env.reset(env.draws(self.generator, num_envs))
        # Distinct buffers: CartPole's obs is its state tensor.
        self.state = tuple(t.clone() for t in state)
        self.obs = obs.clone()
        self._rollout = make_rollout_fn(env, rollout_len)
        self._params = None
        self._program = GraphProgram(
            self._run, self.device, state=[*self.state, self.obs],
            generators=[self.generator])

    def _run(self):
        rollout, state, obs = self._rollout(self._params, self.state,
                                            self.obs, self.generator)
        for buf, new in zip(self.state, state):
            buf.copy_(new)
        self.obs.copy_(obs)
        return rollout

    def sample(self, params) -> Rollout:
        if self._params is None:
            self._params = clone_params(params)
        else:
            copy_params_(self._params, params)
        return Rollout(*(t.clone() for t in self._program()))

    def steps_per_sample(self) -> int:
        return self.num_envs * self.rollout_len


class EnvRunner:
    """A local runner: each rollout is one CUDA graph on the card, eager
    on the CPU."""

    def __init__(self, env: TorchEnv, num_envs: int = 64,
                 rollout_len: int = 128, seed: int = 0, device="cuda"):
        self._impl = _EnvRunnerImpl(env, num_envs, rollout_len, seed, device)

    def sample(self, params) -> Rollout:
        return self._impl.sample(params)

    def steps_per_sample(self) -> int:
        return self._impl.steps_per_sample()

    @staticmethod
    def as_actor(env: TorchEnv, num_envs: int = 64, rollout_len: int = 128,
                 seed: int = 0):
        raise NotImplementedError(
            "remote env runners need the port's runtime (actors), which is "
            "not ported yet: ROADMAP A.5")
