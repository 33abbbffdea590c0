"""Offline RL: replay data as Datasets (counterpart of
``ray_tpu/rl/offline.py``).

Transitions move through ``ray_tpu_torch.data`` Datasets: export a live
ReplayBuffer to a Dataset (and so to TFRecords through the Data write
path), or train a DQN purely from a Dataset with no environment
interaction, on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ray_tpu_torch.rl.dqn import DQNConfig, DQNLearner
from ray_tpu_torch.rl.replay import ReplayBuffer


def buffer_to_dataset(buffer: ReplayBuffer, *, parallelism: int = 4):
    """Snapshot a replay buffer's transitions as a Dataset (columns:
    obs/actions/rewards/dones/next_obs; vector observations flatten to
    fixed-width columns obs_0..obs_{D-1})."""
    import ray_tpu_torch.data as rdata

    if len(buffer) == 0:
        raise ValueError("replay buffer is empty")
    store = {k: v[:len(buffer)] for k, v in buffer._store.items()}
    cols = {}
    for k, v in store.items():
        if v.ndim == 1:
            cols[k] = v
        else:
            for d in range(v.shape[1]):
                cols[f"{k}_{d}"] = v[:, d]
    return rdata.from_columns(cols, parallelism=parallelism)


def dataset_to_buffer(ds, *, capacity: Optional[int] = None
                      ) -> ReplayBuffer:
    """Load a transitions Dataset (the buffer_to_dataset layout) back
    into a ReplayBuffer. Float columns come back as float32, the width
    the learner computes in (a TFRecord round trip reads its f32 floats
    as float64; the values are unchanged)."""
    df_cols = {}
    for block in ds.iter_blocks():
        for k, v in block.items():
            df_cols.setdefault(k, []).append(np.asarray(v))
    cols = {}
    for k, v in df_cols.items():
        col = np.concatenate(v)
        cols[k] = col.astype(np.float32) if col.dtype.kind == "f" else col
    n = len(next(iter(cols.values())))

    def _vec(prefix):
        d = 0
        while f"{prefix}_{d}" in cols:
            d += 1
        if d:
            return np.stack([cols[f"{prefix}_{i}"] for i in range(d)],
                            axis=1)
        return cols[prefix]

    buf = ReplayBuffer(capacity or n)
    # add_rollout expects [T, N, ...]; feed one [n, 1, ...] batch.
    buf.add_rollout(
        _vec("obs")[:, None], cols["actions"][:, None],
        cols["rewards"][:, None], cols["dones"][:, None],
        _vec("next_obs")[:, None])
    return buf


def train_dqn_offline(env, dataset, *, config: DQNConfig = DQNConfig(),
                      num_iterations: int = 50, seed: int = 0,
                      device="cuda") -> DQNLearner:
    """Train a DQN purely from a fixed transitions Dataset, with no
    environment interaction (the offline path). Each iteration is one
    ``train_from_buffer``: a CUDA graph on the card, eager on the CPU."""
    learner = DQNLearner(env, config, seed, device=device)
    learner._buffer = dataset_to_buffer(dataset)
    for _ in range(num_iterations):
        learner.train_from_buffer()
    return learner
