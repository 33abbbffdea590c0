"""RL rollout benchmark (counterpart of ``ray_tpu/rl/bench.py``:
BASELINE.json config #5, PPO rollout collection, CartPole-v1, 64
vectorised envs)."""

from __future__ import annotations

import time

import torch

from ray_tpu_torch.device import resolve_device


def rollout_throughput(num_envs: int = 64, rollout_len: int = 512,
                       n_iters: int = 5, device="cuda") -> dict:
    """Env steps per second of ``EnvRunner.sample`` after one warm-up
    sample (which captures the CUDA graph on the card)."""
    from ray_tpu_torch.rl.env import CartPole
    from ray_tpu_torch.rl.env_runner import EnvRunner
    from ray_tpu_torch.rl.ppo import PPOLearner

    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    env = CartPole()
    learner = PPOLearner(env, device=dev)
    runner = EnvRunner(env, num_envs=num_envs, rollout_len=rollout_len,
                       device=dev)
    params = learner.get_weights()
    runner.sample(params)
    sync()
    t0 = time.perf_counter()
    for _ in range(n_iters):
        runner.sample(params)
    sync()
    dt = (time.perf_counter() - t0) / n_iters
    return {
        "suite": "rl_rollout",
        "env_steps_per_sec": runner.steps_per_sample() / dt,
        "num_envs": num_envs,
        "rollout_len": rollout_len,
        "wall_s_per_rollout": dt,
        "device": str(dev),
    }
