"""ray_tpu_torch.rl: reinforcement learning (counterpart of
``ray_tpu.rl``).

Environments are batched tensor programs (``TorchEnv``); an EnvRunner's
whole vectorised rollout (env step, policy forward, value bootstrap), the
PPO update and DQN's ``train_many`` each run as one device program: one
CUDA graph per call on the card, eager on the CPU. ``Algorithm`` trains
PPO or DQN over a local runner; ``MultiAgentPPO`` runs independent PPO
over a policy mapping; ``IMPALA`` is IMPALA's V-trace learner, its update
one device program. Remote runners and IMPALA's asynchronous loop wait
for the runtime (ROADMAP A.5), ``offline.py`` for the Data layer.
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
    "gym_adapter",
    "policy_params_from_jax",
    "vtrace",
]
