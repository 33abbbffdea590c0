"""ray_tpu_torch.rl: reinforcement learning (counterpart of
``ray_tpu.rl``).

Environments are batched tensor programs (``TorchEnv``); an EnvRunner's
whole vectorised rollout (env step, policy forward, value bootstrap), the
PPO update and DQN's ``train_many`` each run as one device program: one
CUDA graph per call on the card, eager on the CPU. ``Algorithm`` trains
PPO or DQN over a local runner or over runner actors of the one-process
runtime (``EnvRunner.as_actor``, each on a CUDA stream of its own);
``MultiAgentPPO`` runs independent PPO over a policy mapping; ``IMPALA``
is the asynchronous actor-learner, runner actors streaming rollouts into
its V-trace update (one device program). ``offline.py`` moves replay
buffers to and from Datasets and trains a DQN from a Dataset alone.
"""

from ray_tpu_torch.rl.env import CartPole, Pendulum, TorchEnv, gym_adapter
from ray_tpu_torch.rl.ppo import (
    PPOConfig,
    PPOLearner,
    Rollout,
    policy_params_from_jax,
)
from ray_tpu_torch.rl.dqn import DQNConfig, DQNLearner
from ray_tpu_torch.rl.replay import ReplayBuffer
from ray_tpu_torch.rl.offline import (
    buffer_to_dataset,
    dataset_to_buffer,
    train_dqn_offline,
)
from ray_tpu_torch.rl.algorithm import Algorithm, AlgorithmConfig
from ray_tpu_torch.rl.env_runner import EnvRunner
from ray_tpu_torch.rl.impala import IMPALA, IMPALAConfig, vtrace
from ray_tpu_torch.rl.multi_agent import (
    CoordinationGame,
    MultiAgentEnvRunner,
    MultiAgentPPO,
    MultiAgentTorchEnv,
)

__all__ = [
    "Algorithm",
    "AlgorithmConfig",
    "CartPole",
    "CoordinationGame",
    "DQNConfig",
    "DQNLearner",
    "EnvRunner",
    "IMPALA",
    "IMPALAConfig",
    "MultiAgentEnvRunner",
    "MultiAgentPPO",
    "MultiAgentTorchEnv",
    "PPOConfig",
    "PPOLearner",
    "Pendulum",
    "ReplayBuffer",
    "Rollout",
    "TorchEnv",
    "buffer_to_dataset",
    "dataset_to_buffer",
    "gym_adapter",
    "policy_params_from_jax",
    "train_dqn_offline",
    "vtrace",
]
