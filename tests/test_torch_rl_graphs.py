"""The RL slice's device programs on the card: each CUDA graph against the
same program run eagerly from the same state and generator state.

Every test is marked ``cuda`` and skips without a card. The file imports
no JAX, so it runs on a machine that has only PyTorch:
``python -m pytest tests/test_torch_rl_graphs.py -m cuda``. A graph replays
the kernels that the eager run launches, on the same inputs, so results
agree to GRAPH_TOL (room for a library that picks another algorithm under
capture); integers and booleans agree exactly.
"""

import pytest
import torch

from ray_tpu_torch import rl
from ray_tpu_torch.rl import multi_agent as ma
from ray_tpu_torch.rl.ppo import Rollout, leaves

GRAPH_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_rollouts_equal(a, b):
    for name, x, y in zip(Rollout._fields, a, b):
        if x.dtype.is_floating_point:
            assert (x - y).abs().max().item() <= GRAPH_TOL, name
        else:
            assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("env_name", ["CartPole", "Pendulum"])
def test_rollout_graph_equals_eager(cuda_device, env_name):
    env = getattr(rl, env_name)()
    params = rl.PPOLearner(env, device=cuda_device).get_weights()
    eager, graphed = (rl.EnvRunner(env, 16, 64, seed=1, device=cuda_device)
                      for _ in range(2))
    eager._impl._program.graph = False   # the twin: the same program, eager
    for _ in range(3):   # capture, then replays that carry the env state
        _assert_rollouts_equal(eager.sample(params), graphed.sample(params))
    assert graphed._impl._program.replays == 3
    assert torch.equal(eager._impl.generator.get_state(),
                       graphed._impl.generator.get_state())


@pytest.mark.cuda
def test_ppo_update_graph_equals_eager(cuda_device):
    env = rl.CartPole()
    runner = rl.EnvRunner(env, 16, 32, device=cuda_device)
    graphed, eager = (rl.PPOLearner(env, seed=2, device=cuda_device)
                      for _ in range(2))
    for _ in range(2):
        ro = runner.sample(graphed.get_weights())
        loss_g = graphed.update(ro)
        loss_e = float(eager._update(ro, eager._draw_perms(
            ro.actions.numel())))
        assert abs(loss_g - loss_e) <= GRAPH_TOL
        for x, y in zip(leaves(graphed.params), leaves(eager.params)):
            assert (x - y).abs().max().item() <= GRAPH_TOL


@pytest.mark.cuda
def test_impala_update_graph_equals_eager(cuda_device):
    env = rl.CartPole()
    runner = rl.EnvRunner(env, 32, 64, device=cuda_device)
    graphed, eager = (rl.IMPALA(env, seed=2, device=cuda_device)
                      for _ in range(2))
    for _ in range(2):
        ro = runner.sample(graphed.get_weights())
        loss_g = graphed.update(ro)
        loss_e = float(eager._update(ro))
        assert abs(loss_g - loss_e) <= GRAPH_TOL
        for x, y in zip(leaves(graphed.params), leaves(eager.params)):
            assert (x - y).abs().max().item() <= GRAPH_TOL
    (_, program), = graphed._programs.values()
    assert program.replays == 2


@pytest.mark.cuda
def test_dqn_train_many_graph_equals_eager(cuda_device):
    env = rl.CartPole()
    cfg = rl.DQNConfig(batch_size=32, train_steps_per_iter=4,
                       min_buffer_size=64)
    graphed = rl.DQNLearner(env, cfg, seed=3, device=cuda_device)
    eager = rl.DQNLearner(env, cfg, seed=3, device=cuda_device)
    ro = rl.EnvRunner(env, 8, 16, device=cuda_device).sample(
        graphed.get_weights())
    graphed.update(ro)
    # The twin: the same buffer and numpy generator. Its first iteration
    # captures a graph too; from the second on its program runs eagerly.
    eager._buffer.add_rollout(
        ro.obs.cpu().numpy()[:-1], ro.actions.cpu().numpy()[:-1],
        ro.rewards.cpu().numpy()[:-1], ro.dones.cpu().numpy()[:-1],
        ro.obs.cpu().numpy()[1:])
    eager.train_from_buffer()
    eager._program.graph = False
    for _ in range(2):
        assert abs(graphed.train_from_buffer()
                   - eager.train_from_buffer()) <= GRAPH_TOL
    for x, y in zip(leaves(graphed.params), leaves(eager.params)):
        assert (x - y).abs().max().item() <= GRAPH_TOL


@pytest.mark.cuda
def test_multi_agent_rollout_graph_equals_eager(cuda_device):
    env = ma.CoordinationGame(num_actions=3, episode_len=8)
    algo = ma.MultiAgentPPO(env, num_envs=8, rollout_len=16,
                            device=cuda_device)
    eager = ma.MultiAgentEnvRunner(env, 8, 16, seed=0, device=cuda_device)
    eager._program.graph = False
    for _ in range(2):
        a = algo.runner.sample(algo.weights())
        b = eager.sample(algo.weights())
        for ag in env.agents:
            _assert_rollouts_equal(a[ag], b[ag])
    assert algo.train()["env_steps"] == 8 * 16 * 2
