"""Algorithm orchestration (counterpart of ``ray_tpu/rl/algorithm.py``):
``AlgorithmConfig`` (chained setters) and ``Algorithm`` for PPO and DQN
over a local ``EnvRunner``. Remote runners and IMPALA need the port's
runtime (actors), which is not ported yet (ROADMAP A.5), and raise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rl.dqn import DQNConfig, DQNLearner
from ray_tpu_torch.rl.env import CartPole, Pendulum, TorchEnv
from ray_tpu_torch.rl.env_runner import EnvRunner
from ray_tpu_torch.rl.ppo import PPOConfig, PPOLearner, policy_logits

_ENVS = {"CartPole-v1": CartPole, "Pendulum-v1": Pendulum}
_NEEDS_RUNTIME = ("needs the port's runtime (actors and remote tasks), "
                  "which is not ported yet: ROADMAP A.5")


class AlgorithmConfig:
    """Chained setters:
    config.environment(...).env_runners(...).training(...). ``device``
    places the learner and the runner (default the card)."""

    def __init__(self, algo: str = "PPO", device="cuda"):
        self.algo = algo
        self.device = device
        self.env_name = "CartPole-v1"
        self.env_factory = None
        self.num_env_runners = 0
        self.num_envs_per_runner = 64
        self.rollout_len = 128
        self.train_config = DQNConfig() if algo == "DQN" else PPOConfig()
        self.seed = 0

    def environment(self, env: str = None, *, env_factory=None
                    ) -> "AlgorithmConfig":
        if env is not None:
            self.env_name = env
        if env_factory is not None:
            self.env_factory = env_factory
        return self

    def env_runners(self, *, num_env_runners: int = 0,
                    num_envs_per_env_runner: int = 64,
                    rollout_fragment_length: int = 128
                    ) -> "AlgorithmConfig":
        self.num_env_runners = num_env_runners
        self.num_envs_per_runner = num_envs_per_env_runner
        self.rollout_len = rollout_fragment_length
        return self

    def training(self, **kw) -> "AlgorithmConfig":
        self.train_config = dataclasses.replace(self.train_config, **kw)
        return self

    def debugging(self, *, seed: int = 0) -> "AlgorithmConfig":
        self.seed = seed
        return self

    def build(self):
        if self.algo == "IMPALA":
            raise NotImplementedError(f"IMPALA {_NEEDS_RUNTIME}")
        return Algorithm(self)

    # reference alias
    build_algo = build


class Algorithm:
    """PPO or DQN training over a local env runner."""

    def __init__(self, config: AlgorithmConfig):
        if config.algo not in ("PPO", "DQN"):
            raise NotImplementedError(
                f"algorithm {config.algo!r}; PPO (on-policy) and DQN "
                f"(off-policy replay) are implemented natively")
        if config.num_env_runners > 0:
            raise NotImplementedError(f"remote env runners {_NEEDS_RUNTIME}")
        self.config = config
        self.device = resolve_device(config.device)
        factory = config.env_factory or _ENVS.get(config.env_name)
        if factory is None:
            raise ValueError(
                f"unknown env {config.env_name!r}; pass env_factory or one "
                f"of {list(_ENVS)}")
        self.env: TorchEnv = factory()
        learner = DQNLearner if config.algo == "DQN" else PPOLearner
        self.learner = learner(self.env, config.train_config, config.seed,
                               device=self.device)
        self._runners = [EnvRunner(
            self.env, config.num_envs_per_runner, config.rollout_len,
            seed=config.seed, device=self.device)]
        self._iter = 0

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        params = self.learner.get_weights()
        rollouts = [r.sample(params) for r in self._runners]
        sample_time = time.perf_counter() - t0

        losses = []
        total_steps = 0
        ep_return = []
        for ro in rollouts:
            losses.append(self.learner.update(ro))
            total_steps += ro.actions.numel()
            # Mean episode length proxy: 1/done-rate (auto-reset envs).
            done_rate = float(ro.dones.float().mean())
            if done_rate > 0:
                ep_return.append(1.0 / done_rate)
        self._iter += 1
        wall = time.perf_counter() - t0
        return {
            "training_iteration": self._iter,
            "loss": float(np.mean(losses)),
            "num_env_steps_sampled": total_steps,
            "env_steps_per_sec": total_steps / wall,
            "sample_time_s": sample_time,
            "episode_len_mean": float(np.mean(ep_return)) if ep_return
            else float("nan"),
            "time_total_s": wall,
        }

    @torch.no_grad()
    def evaluate(self, num_episodes: int = 8) -> Dict[str, float]:
        """Greedy policy evaluation: mean undiscounted return. The
        episodes run side by side; each env's return stops growing at its
        first done, so each equals one episode's, and every episode ends
        within ``max_episode_steps``."""
        env = self.env
        params = self.learner.get_weights()
        gen = torch.Generator(device=self.device).manual_seed(123)
        state, obs = env.reset(env.draws(gen, num_episodes))
        ret = torch.zeros(num_episodes, device=self.device)
        done = torch.zeros(num_episodes, device=self.device)
        for i in range(env.max_episode_steps):
            action = torch.argmax(policy_logits(params, obs), -1)
            state, obs, r, d = env.step(state, action,
                                        env.draws(gen, num_episodes))
            ret = ret + r * (1.0 - done)
            done = torch.maximum(done, d.float())
            if i % 32 == 31 and bool(done.all()):
                break
        return {"episode_return_mean": float(ret.mean())}

    def get_policy_weights(self):
        return self.learner.get_weights()

    def stop(self):
        self._runners = []
