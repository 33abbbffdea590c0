"""Replay buffer (counterpart of ``ray_tpu/rl/replay.py``, copied and
trimmed to what DQN uses).

A flat numpy ring over transitions, filled from ``[T, N]`` rollout arrays
and sampled uniformly with ``rng.integers``, as the reference does, so the
same buffer and numpy generator give the same minibatches in both.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    def __init__(self, capacity: int = 50_000):
        self.capacity = int(capacity)
        self._store: Optional[Dict[str, np.ndarray]] = None
        self._next = 0
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def add_rollout(self, obs, actions, rewards, dones, next_obs):
        """Flatten [T, N, ...] rollout arrays into transitions and append.
        """
        obs, next_obs = np.asarray(obs), np.asarray(next_obs)
        batch = {
            "obs": obs.reshape(-1, obs.shape[-1]),
            "actions": np.asarray(actions).reshape(-1),
            "rewards": np.asarray(rewards).reshape(-1),
            "dones": np.asarray(dones).reshape(-1).astype(np.float32),
            "next_obs": next_obs.reshape(-1, next_obs.shape[-1]),
        }
        n = len(batch["actions"])
        if self._store is None:
            self._store = {
                k: np.zeros((self.capacity,) + v.shape[1:], v.dtype)
                for k, v in batch.items()
            }
        for start in range(0, n, self.capacity):
            chunk = {k: v[start:start + self.capacity]
                     for k, v in batch.items()}
            m = len(chunk["actions"])
            end = self._next + m
            if end <= self.capacity:
                for k, v in chunk.items():
                    self._store[k][self._next:end] = v
            else:
                split = self.capacity - self._next
                for k, v in chunk.items():
                    self._store[k][self._next:] = v[:split]
                    self._store[k][:m - split] = v[split:]
            self._next = end % self.capacity
            self._size = min(self._size + m, self.capacity)

    def sample(self, batch_size: int,
               rng: np.random.Generator) -> Dict[str, np.ndarray]:
        if self._size == 0:
            raise ValueError("replay buffer is empty")
        idx = rng.integers(0, self._size, size=batch_size)
        return {k: v[idx] for k, v in self._store.items()}
