"""Multi-agent RL (counterpart of ``ray_tpu/rl/multi_agent.py``).

A ``MultiAgentTorchEnv`` steps all agents of N parallel copies of a joint
env at once, over ``[N, ...]`` tensors. The rollout (every agent's policy
forward, the joint step, the loop over T) is one device program, a CUDA
graph on the card. Training is independent PPO per policy: agents mapped
to one policy pool their trajectories into one update batch (the
reference's shared-policy semantics).
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rl._graph import GraphProgram
from ray_tpu_torch.rl.env_runner import gumbel, sample_actions
from ray_tpu_torch.rl.ppo import (
    PPOConfig,
    PPOLearner,
    Rollout,
    clone_params,
    copy_params_,
    policy_logits,
    value_fn,
)


@dataclasses.dataclass(frozen=True)
class MultiAgentTorchEnv:
    """Simultaneous-move multi-agent env over batched tensors.

    reset(u) -> (state, obs: {agent: [N, obs_dim]})
    step(state, actions: {agent: [N]}, u)
        -> (state, obs, rewards: {agent: [N]}, done: [N])
    ``u`` is ``[N, draw_dim]`` uniforms in [0, 1)."""

    agents: Tuple[str, ...]
    reset: Callable
    step: Callable
    obs_dims: Dict[str, int]
    num_actions: Dict[str, int]
    max_episode_steps: int
    draw_dim: int = 0


def CoordinationGame(num_actions: int = 4,
                     episode_len: int = 32) -> MultiAgentTorchEnv:
    """Two-player repeated coordination game: both agents earn +1 when
    they pick the same action, 0 otherwise. Observations are the one-hot
    previous joint action (zeros at an episode's start); it draws
    nothing."""
    agents = ("a0", "a1")
    obs_dim = 2 * num_actions

    def reset(u):
        n = u.shape[0]
        state = (torch.zeros(n, dtype=torch.int32, device=u.device),
                 -torch.ones(n, dtype=torch.int32, device=u.device),
                 -torch.ones(n, dtype=torch.int32, device=u.device))
        o = torch.zeros((n, obs_dim), device=u.device)
        return state, {"a0": o, "a1": o}

    def step(state, actions, u):
        t, _, _ = state
        a0, a1 = actions["a0"], actions["a1"]
        r = (a0 == a1).float()
        t2 = t + 1
        done = t2 >= episode_len
        t_next = torch.where(done, torch.zeros_like(t2), t2)
        o = torch.cat([torch.nn.functional.one_hot(a0.long(), num_actions),
                       torch.nn.functional.one_hot(a1.long(), num_actions)],
                      -1).float()
        o = torch.where(done[:, None], torch.zeros_like(o), o)
        state2 = (t_next, a0.to(torch.int32), a1.to(torch.int32))
        return state2, {"a0": o, "a1": o}, {"a0": r, "a1": r}, done

    return MultiAgentTorchEnv(
        agents=agents, reset=reset, step=step,
        obs_dims={a: obs_dim for a in agents},
        num_actions={a: num_actions for a in agents},
        max_episode_steps=episode_len)


def make_multi_rollout_fn(env: MultiAgentTorchEnv, rollout_len: int,
                          policy_of: Dict[str, str]):
    """(params_by_policy, state, obs, gen) -> ({agent: Rollout}, state,
    obs); ``.with_draws(params_by_policy, state, obs, noise, reset_u)``
    takes each agent's Gumbel noise ``{agent: [T, N, A]}`` and the reset
    uniforms ``[T, N, draw_dim]`` as arguments."""

    @torch.no_grad()
    def with_draws(params_by_policy, state, obs, noise, reset_u):
        steps = []
        for t in range(rollout_len):
            actions, logps, values = {}, {}, {}
            for ag in env.agents:
                p = params_by_policy[policy_of[ag]]
                actions[ag], logps[ag] = sample_actions(
                    policy_logits(p, obs[ag]), noise[ag][t])
                values[ag] = value_fn(p, obs[ag])
            state, obs_next, rewards, done = env.step(state, actions,
                                                      reset_u[t])
            steps.append((obs, actions, logps, rewards, done, values))
            obs = obs_next
        dones = torch.stack([s[4] for s in steps])
        rollouts = {}
        for ag in env.agents:
            obs_b, actions, logps, rewards, values = (
                torch.stack([s[i][ag] for s in steps])
                for i in (0, 1, 2, 3, 5))
            v_last = value_fn(params_by_policy[policy_of[ag]], obs[ag])
            rollouts[ag] = Rollout(obs_b, actions, logps, rewards, dones,
                                   torch.cat([values, v_last[None]], 0))
        return rollouts, state, obs

    def rollout(params_by_policy, state, obs, gen):
        n = obs[env.agents[0]].shape[0]
        noise = {ag: gumbel(torch.rand(
            (rollout_len, n, env.num_actions[ag]), generator=gen,
            device=gen.device)) for ag in env.agents}
        reset_u = torch.rand((rollout_len, n, env.draw_dim), generator=gen,
                             device=gen.device)
        return with_draws(params_by_policy, state, obs, noise, reset_u)

    rollout.with_draws = with_draws
    return rollout


class MultiAgentEnvRunner:
    """Vectorised multi-agent rollout collection: N parallel copies of the
    joint env, all agents stepped inside one device program (a CUDA
    graph on the card, as for ``EnvRunner``)."""

    def __init__(self, env: MultiAgentTorchEnv, num_envs: int = 32,
                 rollout_len: int = 64,
                 policy_of: Optional[Dict[str, str]] = None, seed: int = 0,
                 device="cuda"):
        self.env = env
        self.num_envs = num_envs
        self.rollout_len = rollout_len
        self.policy_of = policy_of or {a: a for a in env.agents}
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(
            seed)
        state, obs = env.reset(torch.rand(
            (num_envs, env.draw_dim), generator=self.generator,
            device=self.device))
        self._state = tuple(t.clone() for t in state)
        self._obs = {ag: o.clone() for ag, o in obs.items()}
        self._rollout = make_multi_rollout_fn(env, rollout_len,
                                              self.policy_of)
        self._params: Optional[Dict[str, Any]] = None
        self._program = GraphProgram(
            self._run, self.device,
            state=[*self._state, *self._obs.values()],
            generators=[self.generator])

    def _run(self):
        rollouts, state, obs = self._rollout(self._params, self._state,
                                             self._obs, self.generator)
        for buf, new in zip(self._state, state):
            buf.copy_(new)
        for ag, o in obs.items():
            self._obs[ag].copy_(o)
        return rollouts

    def sample(self, params_by_policy) -> Dict[str, Rollout]:
        if self._params is None:
            self._params = {pid: clone_params(p)
                            for pid, p in params_by_policy.items()}
        else:
            for pid, p in params_by_policy.items():
                copy_params_(self._params[pid], p)
        return {ag: Rollout(*(t.clone() for t in ro))
                for ag, ro in self._program().items()}

    def steps_per_sample(self) -> int:
        return self.num_envs * self.rollout_len * len(self.env.agents)


def _concat_rollouts(rollouts: List[Rollout]) -> Rollout:
    if len(rollouts) == 1:
        return rollouts[0]
    return Rollout(*[torch.cat(parts, 1) for parts in zip(*rollouts)])


class MultiAgentPPO:
    """Independent PPO over a policy mapping: one PPO learner per policy
    id; agents sharing a policy pool their trajectories into one update
    batch."""

    def __init__(self, env: MultiAgentTorchEnv,
                 policy_of: Optional[Dict[str, str]] = None,
                 config: PPOConfig = PPOConfig(), num_envs: int = 32,
                 rollout_len: int = 64, seed: int = 0, device="cuda"):
        self.env = env
        self.policy_of = policy_of or {a: a for a in env.agents}
        self.runner = MultiAgentEnvRunner(
            env, num_envs=num_envs, rollout_len=rollout_len,
            policy_of=self.policy_of, seed=seed, device=device)
        self.learners: Dict[str, PPOLearner] = {}
        for i, pid in enumerate(sorted(set(self.policy_of.values()))):
            # Any agent mapped to this policy defines its spaces.
            ag = next(a for a, p in self.policy_of.items() if p == pid)
            shim = SimpleNamespace(obs_dim=env.obs_dims[ag],
                                   num_actions=env.num_actions[ag])
            self.learners[pid] = PPOLearner(shim, config=config,
                                            seed=seed + i, device=device)

    def weights(self) -> Dict[str, Any]:
        return {pid: lr.get_weights() for pid, lr in self.learners.items()}

    def train(self) -> Dict[str, Any]:
        rollouts = self.runner.sample(self.weights())
        losses = {}
        for pid, learner in self.learners.items():
            mine = [rollouts[a] for a, p in self.policy_of.items()
                    if p == pid]
            losses[pid] = learner.update(_concat_rollouts(mine))
        mean_reward = float(torch.stack(
            [r.rewards.mean() for r in rollouts.values()]).mean())
        return {"mean_step_reward": mean_reward, "losses": losses,
                "env_steps": self.runner.steps_per_sample()}
