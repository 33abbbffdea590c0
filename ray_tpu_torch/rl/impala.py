"""IMPALA (counterpart of ``ray_tpu/rl/impala.py``): env-runner actors
stream rollouts into a learner that updates while collection goes on,
with V-trace importance correction for the policy lag.

Each runner actor's whole vectorised rollout is one device program (a
CUDA graph on the card, on the actor's own stream: ``rl/env_runner.py``);
the learner's V-trace update is one device program (a graph on the
calling thread's stream). Asynchrony is the scheduling layer between
them, on the one-process runtime's actors, ``wait``, ``get`` and
``kill``: one sample stays in flight PER RUNNER at all times. When a
rollout lands, its runner is re-armed with the freshest weights BEFORE
the learner consumes it, so collection overlaps the update, and
``train()`` measures that overlap falsifiably: a sample submitted
before the update and still not ready after it.

Parameters keep the reference's policy tree and are updated in place
(the graph's static buffers); a runner gets a host copy, as the
reference's ``jax.device_get``. The optimizer is the reference's
``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr))``, written
out as PPO's ``_Adam``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Tuple

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rl._graph import GraphProgram, device_work
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env import TorchEnv
from ray_tpu_torch.rl.env_runner import EnvRunner
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

# Bound on the wait for the next landed sample.
WAIT_TIMEOUT_S = 120.0


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
    """Asynchronous actor-learner: ``num_runners`` runner actors (runner
    ``i`` seeded ``seed + i``), each sampling ``num_envs`` x
    ``rollout_len`` transitions, and the learner's parameters, optimizer
    and V-trace update (one device program per rollout shape).
    Construction starts the runtime (``init(ignore_reinit_error=True)``)
    and the runners; ``stop()`` kills them."""

    def __init__(self, env: TorchEnv, config: IMPALAConfig = IMPALAConfig(),
                 *, num_runners: int = 2, num_envs: int = 32,
                 rollout_len: int = 64, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        ray_tpu_torch.init(ignore_reinit_error=True)
        self.env = env
        self.config = config
        init = torch.Generator(device=self.device).manual_seed(seed)
        self.params = clone_params(init_policy(
            init, env.obs_dim, env.num_actions, config.hidden), True)
        self._leaves = leaves(self.params)
        self._opt = _Adam(self._leaves, config.lr, config.max_grad_norm)
        self._runners = [
            EnvRunner.as_actor(env, num_envs, rollout_len, seed=seed + i,
                               device=self.device)
            for i in range(num_runners)]
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
        with torch.no_grad(), device_work():
            for dst, src in zip(static, rollout):
                dst.copy_(src)
        loss = program()
        with device_work():
            return float(loss)

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

    # ------------------------------------------------------------- training
    def _host_params(self):
        with device_work():
            return clone_params(self.params, device="cpu")

    def train(self, num_updates: int = 50) -> Dict[str, float]:
        """Run the asynchronous loop for ``num_updates`` learner steps.
        Returns the stats, the measured collection/update overlap
        among them."""
        t_start = time.perf_counter()
        host_params = self._host_params()
        inflight = {}
        submit_ts = {}
        for i, r in enumerate(self._runners):
            ref = r.sample.remote(host_params)
            inflight[ref] = i
            submit_ts[ref] = time.perf_counter()
        losses = []
        update_wall = 0.0
        overlap_s = 0.0
        done_rates = []
        updates = 0
        while updates < num_updates:
            ready, _ = ray_tpu_torch.wait(list(inflight), num_returns=1,
                                          timeout=WAIT_TIMEOUT_S)
            if not ready:
                raise TimeoutError("env runners stalled")
            ref = ready[0]
            idx = inflight.pop(ref)
            submit_ts.pop(ref, None)
            rollout = ray_tpu_torch.get(ref, timeout=WAIT_TIMEOUT_S)
            # Re-arm the runner FIRST: its next rollout collects while
            # the learner runs the update below.
            host_params = self._host_params()
            ref2 = self._runners[idx].sample.remote(host_params)
            inflight[ref2] = idx
            submit_ts[ref2] = time.perf_counter()
            pre_update = list(submit_ts)
            t0 = time.perf_counter()
            loss = self.update(rollout)  # reads the loss: a host sync
            t1 = time.perf_counter()
            update_wall += t1 - t0
            # Overlap (falsifiable): a sample submitted before the update
            # and STILL not ready after it was being collected for the
            # update's whole duration. Serialised collection earns none.
            if pre_update:
                _, not_ready = ray_tpu_torch.wait(
                    pre_update, num_returns=len(pre_update), timeout=0)
                if not_ready:
                    overlap_s += t1 - t0
            losses.append(loss)
            done_rates.append(float(rollout.dones.float().mean()))
            updates += 1
        wall = time.perf_counter() - t_start
        self.stats = {
            "updates": updates,
            "loss": float(np.mean(losses[-10:])),
            "env_steps": updates * self.steps_per_sample,
            "env_steps_per_sec": updates * self.steps_per_sample / wall,
            "update_wall_s": update_wall,
            "collection_update_overlap_s": overlap_s,
            "total_wall_s": wall,
            "episode_len_mean": (1.0 / np.mean(done_rates[-10:])
                                 if np.mean(done_rates[-10:]) > 0
                                 else float("nan")),
        }
        return dict(self.stats)

    def stop(self) -> None:
        runners, self._runners = self._runners, []
        for r in runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:  # noqa: BLE001 — runtime already down
                pass
