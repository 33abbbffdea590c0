"""Environments as batched tensor programs (counterpart of
``ray_tpu/rl/env.py``).

The reference writes an environment as a pair of pure functions over one
env's explicit state and vectorises them with ``vmap``; here the same
functions are written over ``[N, ...]`` tensors, so N envs step as one
batch of tensor ops. Randomness enters only as arguments: ``reset(u)``
and ``step(state, action, u)`` take ``u``, ``[N, draw_dim]`` uniforms in
[0, 1) (``draws(gen, n)``), which they map onto the reference's reset
distribution. A test passes the reference's own uniforms
(``jax.random.uniform(key, ...)``) and gets its states. A step that ends
an episode resets that env from its row of ``u`` (vectorised-env
semantics); the obs it returns is then the new episode's first.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TorchEnv:
    """reset(u) -> (state, obs); step(state, action, u) -> (state, obs,
    reward, done), all batched over the first dimension. ``u`` is
    ``[N, draw_dim]`` uniforms in [0, 1)."""

    reset: Callable[[torch.Tensor], Tuple[Any, torch.Tensor]]
    step: Callable[[Any, torch.Tensor, torch.Tensor],
                   Tuple[Any, torch.Tensor, torch.Tensor, torch.Tensor]]
    obs_dim: int
    num_actions: int  # 0 => continuous
    max_episode_steps: int
    draw_dim: int     # uniforms per env per reset

    def draws(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """``[n, draw_dim]`` uniforms in [0, 1) from ``gen``, on its
        device."""
        return torch.rand((n, self.draw_dim), generator=gen,
                          device=gen.device)


def _uniform(u, lo, hi):
    """``jax.random.uniform``'s map of [0, 1) onto [lo, hi), with the
    bounds rounded to f32 first, as it rounds them."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    return torch.clamp_min(u * float(hi32 - lo32) + float(lo32), float(lo32))


def CartPole(max_episode_steps: int = 500) -> TorchEnv:
    """CartPole-v1 dynamics (the reference's constants)."""
    gravity = 9.8
    masscart, masspole = 1.0, 0.1
    total_mass = masscart + masspole
    length = 0.5
    polemass_length = masspole * length
    force_mag = 10.0
    tau = 0.02
    theta_lim = 12 * 2 * math.pi / 360
    x_lim = 2.4

    def reset(u):
        s = _uniform(u, -0.05, 0.05)
        t = torch.zeros(u.shape[0], dtype=torch.int32, device=u.device)
        return (s, t), s

    def step(state, action, u):
        s, t = state
        x, x_dot, theta, theta_dot = s.unbind(-1)
        force = torch.where(action == 1, force_mag, -force_mag)
        costheta, sintheta = torch.cos(theta), torch.sin(theta)
        temp = (force + polemass_length * theta_dot**2 * sintheta
                ) / total_mass
        thetaacc = (gravity * sintheta - costheta * temp) / (
            length * (4.0 / 3.0 - masspole * costheta**2 / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + tau * x_dot
        x_dot = x_dot + tau * xacc
        theta = theta + tau * theta_dot
        theta_dot = theta_dot + tau * thetaacc
        s2 = torch.stack([x, x_dot, theta, theta_dot], -1)
        t2 = t + 1
        done = ((x.abs() > x_lim) | (theta.abs() > theta_lim)
                | (t2 >= max_episode_steps))
        (s_reset, t_reset), _ = reset(u)
        s_next = torch.where(done[:, None], s_reset, s2)
        t_next = torch.where(done, t_reset, t2)
        return (s_next, t_next), s_next, torch.ones_like(x), done

    return TorchEnv(reset=reset, step=step, obs_dim=4, num_actions=2,
                    max_episode_steps=max_episode_steps, draw_dim=4)


def Pendulum(max_episode_steps: int = 200) -> TorchEnv:
    """Pendulum-v1 dynamics (continuous torque control). ``u[:, 0]``
    draws the angle and ``u[:, 1]`` the angular velocity (the reference's
    two split keys, in order)."""
    max_speed, max_torque = 8.0, 2.0
    dt, g, m, l = 0.05, 10.0, 1.0, 1.0

    def obs_of(s):
        th, thdot = s.unbind(-1)
        return torch.stack([torch.cos(th), torch.sin(th), thdot], -1)

    def reset(u):
        th = _uniform(u[:, 0], -math.pi, math.pi)
        thdot = _uniform(u[:, 1], -1.0, 1.0)
        s = torch.stack([th, thdot], -1)
        t = torch.zeros(u.shape[0], dtype=torch.int32, device=u.device)
        return (s, t), obs_of(s)

    def step(state, action, u):
        s, t = state
        th, thdot = s.unbind(-1)
        uc = torch.clamp(action.reshape(-1).to(th.dtype), -max_torque,
                         max_torque)
        # The reference's % is a floor modulo: torch.remainder, not fmod.
        angle = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
        cost = angle**2 + 0.1 * thdot**2 + 0.001 * uc**2
        thdot2 = torch.clamp(
            thdot + (3 * g / (2 * l) * torch.sin(th)
                     + 3.0 / (m * l**2) * uc) * dt,
            -max_speed, max_speed)
        th2 = th + thdot2 * dt
        s2 = torch.stack([th2, thdot2], -1)
        t2 = t + 1
        done = t2 >= max_episode_steps
        (s_reset, t_reset), _ = reset(u)
        s_next = torch.where(done[:, None], s_reset, s2)
        t_next = torch.where(done, t_reset, t2)
        return (s_next, t_next), obs_of(s_next), -cost, done

    return TorchEnv(reset=reset, step=step, obs_dim=3, num_actions=0,
                    max_episode_steps=max_episode_steps, draw_dim=2)


def gym_adapter(env_name: str, **kw) -> TorchEnv:
    """Wrap a gymnasium env id when the dynamics are not tensor-native
    (the reference raises too)."""
    raise NotImplementedError(
        "gymnasium adapter lands with the host-executor escape hatch; use "
        "tensor-native envs (CartPole/Pendulum) or implement TorchEnv "
        "directly")
