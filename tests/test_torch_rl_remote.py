"""RL's remote runners and IMPALA's asynchronous loop on the port's
one-process runtime (``ray_tpu_torch.rl``), on the CPU.

- Runner actors (``EnvRunner.as_actor``) against local runners of the
  same seeds, and ``Algorithm`` with ``num_env_runners=2`` against the
  same loop written out over local runners: equal exactly (the same
  eager CPU ops in the same order).
- IMPALA's loop against the reference's (``ray_tpu.rl.impala``, on
  ``ray_tpu.init(worker_mode="thread")``): each with ONE runner whose
  actor replays a fixed list of rollouts made from a numpy seed, so the
  learner updates on them in their order. Both start from the reference's
  ``init_policy``; every parameter must end within ``UPDATE_ATOL`` of the
  reference's, with Adam's own bound for the elements whose reference
  gradient lies under ``ADAM_FLOOR`` (as in ``test_torch_rl_impala.py``,
  whose helpers this file uses). The losses agree within ``ATOL`` and
  the ``stats`` keys are the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.rl import env as jenv
from ray_tpu.rl import impala as jimpala
from ray_tpu.rl import ppo as jppo
from ray_tpu_torch import rl as trl
from ray_tpu_torch.rl import env as tenv
from ray_tpu_torch.rl import impala as timpala
from ray_tpu_torch.rl import ppo as tppo
from test_torch_rl_impala import (
    ADAM_FLOOR,
    ATOL,
    CPU,
    UPDATE_ATOL,
    N,
    T,
    _closure,
    _jax_params,
    _reference,
    _rollout,
    _t,
)

torch.set_num_threads(1)

TIMEOUT = 60.0
REPLAYED = 3


@pytest.fixture(autouse=True)
def _runtimes_down():
    """Every test leaves both runtimes down (a runtime left up would
    change later files in the same worker)."""
    ray_tpu_torch.shutdown()
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def _host(params):
    return tppo.clone_params(params, device="cpu")


def _assert_rollouts_equal(a, b):
    for name, x, y in zip(tppo.Rollout._fields, a, b):
        assert x.device.type == "cpu", name
        assert torch.equal(x, y), name


def test_runner_actors_equal_local_runners():
    env = tenv.CartPole()
    learner = trl.PPOLearner(env, seed=1, device=CPU)
    actors = [trl.EnvRunner.as_actor(env, 4, 8, seed=7 + i, device=CPU)
              for i in range(2)]
    local = [trl.EnvRunner(env, 4, 8, seed=7 + i, device=CPU)
             for i in range(2)]
    params = learner.get_weights()
    for _ in range(2):
        remote = ray_tpu_torch.get(
            [a.sample.remote(_host(params)) for a in actors],
            timeout=TIMEOUT)
        for got, runner in zip(remote, local):
            _assert_rollouts_equal(got, runner.sample(params))
    assert ray_tpu_torch.get(actors[0].steps_per_sample.remote(),
                             timeout=TIMEOUT) == 32
    # Device-side params are taken as well as host ones.
    got = ray_tpu_torch.get(actors[1].sample.remote(params), timeout=TIMEOUT)
    _assert_rollouts_equal(got, local[1].sample(params))


@pytest.mark.parametrize("algo", ["PPO", "DQN"])
def test_algorithm_with_remote_runners_equals_the_loop_over_local_ones(
        algo):
    cfg = (trl.AlgorithmConfig(algo, device=CPU)
           .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                        rollout_fragment_length=8)
           .debugging(seed=3))
    if algo == "DQN":
        cfg = cfg.training(min_buffer_size=40, batch_size=16,
                           train_steps_per_iter=2)
    built = cfg.build()
    try:
        assert len(built._runners) == 2
        results = [built.train() for _ in range(2)]
    finally:
        built.stop()
    assert built._runners == []
    # The same loop over local runners seeded 3 and 4: every rollout
    # first, then an update on each in order.
    env = tenv.CartPole()
    learner_cls = trl.DQNLearner if algo == "DQN" else trl.PPOLearner
    learner = learner_cls(env, cfg.train_config, 3, device=CPU)
    local = [trl.EnvRunner(env, 4, 8, seed=3 + i, device=CPU)
             for i in range(2)]
    losses = []
    for _ in range(2):
        params = learner.get_weights()
        rollouts = [r.sample(params) for r in local]
        losses.append([learner.update(ro) for ro in rollouts])
    for a, b in zip(tppo.leaves(built.learner.get_weights()),
                    tppo.leaves(learner.get_weights())):
        assert torch.equal(a, b)
    for res, want in zip(results, losses):
        np.testing.assert_array_equal(res["loss"], np.mean(want))
        assert res["num_env_steps_sampled"] == 2 * 32
    if algo == "DQN":
        assert np.isnan(results[0]["loss"])      # below min_buffer_size
        assert np.isfinite(results[1]["loss"])


def _replay_actor(remote, rollouts):
    """A runner actor of ``remote``'s runtime that returns ``rollouts``
    in order, whatever the weights."""

    @remote
    class Replay:
        def __init__(self):
            self.rollouts = rollouts
            self.calls = 0

        def sample(self, params):
            ro = self.rollouts[self.calls % len(self.rollouts)]
            self.calls += 1
            return ro

    return Replay.remote()


def test_impala_loop_on_replayed_rollouts_matches_reference():
    jp, tp = _jax_params()
    rng = np.random.default_rng(21)
    rollouts = [_rollout(rng, jp) for _ in range(REPLAYED)]
    cfg = jimpala.IMPALAConfig()

    ray_tpu.init(num_cpus=4, worker_mode="thread", ignore_reinit_error=True)
    ref = jimpala.IMPALA(jenv.CartPole(), cfg, num_runners=1, num_envs=N,
                         rollout_len=T, seed=0)
    port = timpala.IMPALA(tenv.CartPole(), timpala.IMPALAConfig(),
                          num_runners=1, num_envs=N, rollout_len=T, seed=0,
                          device=CPU)
    try:
        ref.params = jp
        ref._opt_state = ref._opt.init(jp)
        port.set_weights(tp)
        for side, rt, ros in (
                (ref, ray_tpu, [jppo.Rollout(*x) for x in rollouts]),
                (port, ray_tpu_torch,
                 [tppo.Rollout(*(_t(a) for a in x)) for x in rollouts])):
            for r in side._runners:
                rt.kill(r)
            side._runners = [_replay_actor(rt.remote, ros)]
        want = ref.train(num_updates=REPLAYED)
        got = port.train(num_updates=REPLAYED)
    finally:
        ref.stop()
        port.stop()
    assert port._runners == []
    assert sorted(got) == sorted(want)
    for key in ("updates", "env_steps"):
        assert got[key] == want[key] == (
            REPLAYED if key == "updates" else REPLAYED * N * T)
    np.testing.assert_allclose(got["loss"], want["loss"], atol=ATOL)
    np.testing.assert_allclose(got["episode_len_mean"],
                               want["episode_len_mean"], rtol=1e-6)
    for key in ("env_steps_per_sec", "update_wall_s", "total_wall_s",
                "collection_update_overlap_s"):
        assert got[key] >= 0 and np.isfinite(got[key]), key
    # The reference's trajectory over the same rollouts, for the elements
    # whose gradient is under ADAM_FLOOR in some step (Adam's bound).
    _, update = _reference(cfg)
    grad_fn = jax.jit(jax.grad(_closure(update)["loss_fn"]))
    p, state = jp, ref._opt.init(jp)
    near_zero = [np.zeros(t.shape, bool) for t in tppo.leaves(tp)]
    for x in rollouts:
        jro = jppo.Rollout(*(jnp.asarray(a) for a in x))
        for mask, g in zip(near_zero, tppo.leaves(jax.tree_util.tree_map(
                np.asarray, grad_fn(p, jro)))):
            mask |= np.abs(g) < ADAM_FLOOR
        p, state, _ = update(p, state, jro)
    ref_leaves = tppo.leaves(jax.tree_util.tree_map(np.asarray, ref.params))
    for a, b in zip(ref_leaves, tppo.leaves(jax.tree_util.tree_map(
            np.asarray, p))):
        np.testing.assert_array_equal(a, b)   # the loop is that trajectory
    for a, b, mask in zip(tppo.leaves(port.get_weights()), ref_leaves,
                          near_zero):
        diff = np.abs(a.detach().numpy() - b)
        assert diff[~mask].max() <= UPDATE_ATOL
        assert (diff[mask] <= 2 * cfg.lr * REPLAYED).all()
    assert sum(m.sum() for m in near_zero) < 0.01 * sum(
        m.size for m in near_zero)


def test_impala_built_from_config_trains_and_stops():
    algo = (trl.AlgorithmConfig("IMPALA", device=CPU)
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4,
                         rollout_fragment_length=8)
            .debugging(seed=2).build())
    try:
        assert isinstance(algo, timpala.IMPALA)
        assert isinstance(algo.config, timpala.IMPALAConfig)
        assert len(algo._runners) == 2 and algo.steps_per_sample == 32
        stats = algo.train(num_updates=4)
    finally:
        algo.stop()
    assert stats["updates"] == 4 and stats["env_steps"] == 4 * 32
    assert np.isfinite(stats["loss"])
    assert stats["collection_update_overlap_s"] >= 0
    assert stats["collection_update_overlap_s"] <= stats["update_wall_s"]
    assert algo._runners == [] and algo.stats == stats
    # A second stop is harmless.
    algo.stop()

