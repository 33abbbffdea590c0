"""The port's RL slice (``ray_tpu_torch.rl``) against the JAX reference
(``ray_tpu.rl``) on the CPU.

Parameters are the reference's (``init_policy`` / the learners' own),
carried across by ``policy_params_from_jax``; inputs come from a numpy
seed; where the reference draws, the test computes the reference's own
draws from its keys (``jax.random.gumbel`` for the categorical actions,
``jax.random.uniform`` for the resets, ``jax.random.permutation`` for the
minibatches) and passes them to the port's inner forms. Tolerances:

- f32 forwards (env steps, the policy, GAE, the loss): ATOL 1e-6 on O(1)
  values, 1e-5 where a value is a sum over a rollout or a batch (the same
  arithmetic in another summation order, or libm's sin/cos/exp against
  XLA's, a few ulps);
- integer and boolean results (actions, dones, replay samples): exact;
- one PPO update or three DQN iterations (16 and 12 Adam steps): each
  parameter within UPDATE_ATOL = 1e-5. Adam divides by sqrt(v), so a
  gradient element near zero whose sign rounds differently could move a
  parameter by up to 2 * lr; none does at these seeds, and the check would
  show one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl import dqn as jdqn
from ray_tpu.rl import env as jenv
from ray_tpu.rl import env_runner as jrunner
from ray_tpu.rl import multi_agent as jma
from ray_tpu.rl import ppo as jppo
from ray_tpu.rl.replay import ReplayBuffer as JReplayBuffer
from ray_tpu_torch import rl as trl
from ray_tpu_torch.rl import bench as tbench
from ray_tpu_torch.rl import dqn as tdqn
from ray_tpu_torch.rl import env as tenv
from ray_tpu_torch.rl import env_runner as trunner
from ray_tpu_torch.rl import multi_agent as tma
from ray_tpu_torch.rl import ppo as tppo

torch.set_num_threads(1)

ATOL = 1e-6
SUM_ATOL = 1e-5
UPDATE_ATOL = 1e-5
CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


def _closure(fn):
    """The free variables of a jitted reference function (its inner
    ``loss_fn``, which the reference does not export)."""
    fn = getattr(fn, "__wrapped__", fn)
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _jax_params(seed=0, obs_dim=4, num_actions=2, hidden=(64, 64)):
    jp = jppo.init_policy(jax.random.PRNGKey(seed), obs_dim, num_actions,
                          hidden)
    return jp, tppo.policy_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device=CPU)


def _assert_params(tp, jp, atol):
    ref = jax.tree_util.tree_map(np.asarray, jp)
    for tower in ("pi", "vf"):
        for i, lyr in enumerate(ref[tower]):
            for k, r in lyr.items():
                np.testing.assert_allclose(
                    tp[tower][i][k].detach().numpy(), r, atol=atol,
                    err_msg=f"{tower}[{i}].{k}")


def _reset_uniforms(keys, draw_dim):
    """The uniforms behind the reference's reset(key) for each key:
    CartPole draws its 4 from the key itself, Pendulum one from each half
    of split(key)."""
    if draw_dim == 4:
        return jax.vmap(lambda k: jax.random.uniform(k, (4,)))(keys)
    return jax.vmap(lambda k: jnp.stack(
        [jax.random.uniform(s, ()) for s in jax.random.split(k)]))(keys)


# ---------------------------------------------------------------- envs


def _cartpole_states(rng, n):
    s = np.stack([rng.uniform(-2.6, 2.6, n), rng.normal(0, 1, n),
                  rng.uniform(-0.25, 0.25, n), rng.normal(0, 1, n)],
                 -1).astype(np.float32)
    t = rng.integers(490, 500, n).astype(np.int32)
    return s, t


@pytest.mark.parametrize("name", ["CartPole", "Pendulum"])
def test_env_step_and_reset_match_reference(name):
    """Steps over states that cross every termination (cart and pole
    limits, the step limit) with the reference's reset draws passed in;
    the auto-reset rows take the reset state."""
    rng = np.random.default_rng(0)
    n = 256
    jv, tv = getattr(jenv, name)(), getattr(tenv, name)()
    if name == "CartPole":
        s, t = _cartpole_states(rng, n)
        action = rng.integers(0, 2, n).astype(np.int32)
    else:
        s = np.stack([rng.uniform(-10, 10, n), rng.uniform(-8, 8, n)],
                     -1).astype(np.float32)
        t = rng.integers(190, 200, n).astype(np.int32)
        action = rng.uniform(-3, 3, (n, 1)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    u = np.asarray(_reset_uniforms(keys, tv.draw_dim))
    (js, jt), jobs, jr, jd = jax.jit(jax.vmap(jv.step))(
        (jnp.asarray(s), jnp.asarray(t)), jnp.asarray(action), keys)
    (ts, tt), tobs, tr, td = tv.step((_t(s), _t(t)), _t(action), _t(u))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert 0 < td.sum() < n   # some rows end, some do not
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SUM_ATOL)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=SUM_ATOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=SUM_ATOL)
    (js0, jt0), jo0 = jax.vmap(jv.reset)(keys)
    (ts0, tt0), to0 = tv.reset(_t(u))
    np.testing.assert_allclose(ts0.numpy(), np.asarray(js0), atol=ATOL)
    np.testing.assert_allclose(to0.numpy(), np.asarray(jo0), atol=ATOL)
    np.testing.assert_array_equal(tt0.numpy(), np.asarray(jt0))


def test_cartpole_termination_kinds():
    """Each termination on its own: the cart, the pole and the step
    limit end an episode; a state inside every limit does not."""
    env = tenv.CartPole()
    s = torch.tensor([[2.45, 0, 0, 0], [0, 0, 0.22, 0], [0, 0, 0, 0],
                      [0, 0, 0, 0]])
    t = torch.tensor([0, 0, 499, 0], dtype=torch.int32)
    u = torch.full((4, 4), 0.5)
    (s2, t2), _, _, done = env.step((s, t), torch.ones(4, dtype=torch.long),
                                    u)
    assert done.tolist() == [True, True, True, False]
    assert t2.tolist() == [0, 0, 0, 1]
    assert torch.equal(s2[:3], torch.zeros(3, 4))   # reset at u = 0.5


def test_gym_adapter_raises():
    with pytest.raises(NotImplementedError):
        tenv.gym_adapter("CartPole-v1")


# -------------------------------------------------------- policy, GAE


def test_policy_and_value_match_reference():
    jp, tp = _jax_params(0, 4, 2)
    obs = np.random.default_rng(1).normal(size=(32, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tppo.policy_logits(tp, _t(obs)).numpy(),
        np.asarray(jppo.policy_logits(jp, jnp.asarray(obs))), atol=ATOL)
    np.testing.assert_allclose(
        tppo.value_fn(tp, _t(obs)).numpy(),
        np.asarray(jppo.value_fn(jp, jnp.asarray(obs))), atol=ATOL)
    # Pendulum's 1-logit policy, mirrored.
    jp1, tp1 = _jax_params(2, 3, 0, (16,))
    assert tp1["pi"][-1]["w"].shape == (16, 1)


def test_policy_params_from_jax_refuses_bad_trees():
    jp, _ = _jax_params(0, 4, 2, (8,))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    with pytest.raises(KeyError):
        tppo.policy_params_from_jax({"pi": tree["pi"]}, device=CPU)
    with pytest.raises(KeyError):
        tppo.policy_params_from_jax({**tree, "q": tree["pi"]}, device=CPU)
    bad = {"pi": [dict(tree["pi"][0], extra=tree["pi"][0]["b"]),
                  tree["pi"][1]], "vf": tree["vf"]}
    with pytest.raises(KeyError):
        tppo.policy_params_from_jax(bad, device=CPU)
    bad = {"pi": [tree["pi"][0], dict(tree["pi"][1],
                                      w=tree["pi"][1]["w"][:4])],
           "vf": tree["vf"]}
    with pytest.raises(ValueError):
        tppo.policy_params_from_jax(bad, device=CPU)
    learner = tppo.PPOLearner(tenv.CartPole(), tppo.PPOConfig(hidden=(16,)),
                              device=CPU)
    with pytest.raises(ValueError):
        learner.set_weights(tppo.policy_params_from_jax(tree, device=CPU))


def test_gae_matches_reference():
    rng = np.random.default_rng(2)
    T, N = 24, 6
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    dones = rng.random((T, N)) < 0.2
    values = rng.normal(size=(T + 1, N)).astype(np.float32)
    ja, jt = jppo.gae_advantages(jnp.asarray(rewards), jnp.asarray(dones),
                                 jnp.asarray(values), 0.99, 0.95)
    ta, tt = tppo.gae_advantages(_t(rewards), _t(dones), _t(values), 0.99,
                                 0.95)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=SUM_ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=SUM_ATOL)


# ----------------------------------------------------------------- PPO


def _ppo_batch(rng, jp, B):
    obs = rng.normal(size=(B, 4)).astype(np.float32)
    actions = rng.integers(0, 2, B).astype(np.int32)
    logp = np.asarray(jax.nn.log_softmax(jppo.policy_logits(
        jp, jnp.asarray(obs))))[np.arange(B), actions]
    old_logp = (logp + rng.normal(0, 0.3, B)).astype(np.float32)
    advs = rng.normal(size=B).astype(np.float32)
    targets = rng.normal(size=B).astype(np.float32)
    return obs, actions, old_logp, advs, targets


def test_ppo_loss_and_gradients_match_reference():
    cfg = jppo.PPOConfig()
    jl = jppo.PPOLearner(jenv.CartPole(), cfg, seed=0)
    loss_fn = _closure(jl._update)["loss_fn"]
    jp = jl.params
    tp = tppo.clone_params(tppo.policy_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device=CPU), True)
    batch = _ppo_batch(np.random.default_rng(3), jp, 64)
    (jtotal, jaux), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(
        jp, tuple(jnp.asarray(x) for x in batch))
    total, aux = tppo.ppo_loss(tp, tuple(_t(x) for x in batch),
                               tppo.PPOConfig())
    grads = torch.autograd.grad(total, tppo.leaves(tp))
    np.testing.assert_allclose(total.item(), float(jtotal), atol=ATOL)
    for a, b in zip(aux, jaux):
        np.testing.assert_allclose(a.item(), float(b), atol=ATOL)
    for g, r in zip(grads, tppo.leaves(jax.tree_util.tree_map(
            np.asarray, jgrads))):
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL)


def _random_rollout(rng, jp, T, N):
    obs = rng.normal(size=(T, N, 4)).astype(np.float32)
    logits = np.asarray(jppo.policy_logits(jp, jnp.asarray(obs)))
    actions = rng.integers(0, 2, (T, N)).astype(np.int32)
    logp = np.take_along_axis(np.asarray(jax.nn.log_softmax(logits)),
                              actions[..., None], -1)[..., 0]
    rewards = np.ones((T, N), np.float32)
    dones = rng.random((T, N)) < 0.1
    values = rng.normal(size=(T + 1, N)).astype(np.float32)
    return (obs, actions, logp.astype(np.float32), rewards, dones, values)


def test_ppo_learner_update_matches_reference():
    """One whole update (4 epochs x 4 minibatches, global-norm clip and
    Adam) with the reference's permutations passed in."""
    cfg = jppo.PPOConfig()
    jl = jppo.PPOLearner(jenv.CartPole(), cfg, seed=0)
    tl = tppo.PPOLearner(tenv.CartPole(), tppo.PPOConfig(), device=CPU)
    tl.set_weights(tppo.policy_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jl.params), device=CPU))
    T, N = 16, 8
    ro = _random_rollout(np.random.default_rng(4), jl.params, T, N)
    key = jax.random.PRNGKey(5)
    perms = np.stack([np.asarray(jax.random.permutation(k, T * N))
                      for k in jax.random.split(key, cfg.num_epochs)])
    jloss = jl.update(jppo.Rollout(*(jnp.asarray(x) for x in ro)), key)
    tloss = tl.update(tppo.Rollout(*(_t(x) for x in ro)), perms)
    np.testing.assert_allclose(tloss, jloss, atol=SUM_ATOL)
    _assert_params(tl.params, jl.params, UPDATE_ATOL)
    # The learner's own draws: a permutation per epoch, a finite loss.
    assert np.isfinite(tl.update(tppo.Rollout(*(_t(x) for x in ro))))
    assert sorted(tl._draw_perms(T * N)[0].tolist()) == list(range(T * N))


# -------------------------------------------------------------- rollout


@pytest.mark.parametrize("name", ["CartPole", "Pendulum"])
def test_rollout_matches_reference_with_its_draws(name):
    """The reference's jitted rollout and the port's with the reference's
    Gumbel noise and reset uniforms: obs, actions, rewards, dones,
    log-probs and values; long enough that episodes end and auto-reset
    (CartPole; Pendulum's step limit is cut to 20)."""
    T, N = 48, 8
    jv = getattr(jenv, name)(**({} if name == "CartPole"
                                else {"max_episode_steps": 20}))
    tv = getattr(tenv, name)(**({} if name == "CartPole"
                                else {"max_episode_steps": 20}))
    jp, tp = _jax_params(0, tv.obs_dim, tv.num_actions)
    keys0 = jax.random.split(jax.random.PRNGKey(7), N)
    state, obs = jax.vmap(jv.reset)(keys0)
    key = jax.random.PRNGKey(8)
    ro, (js, jt), jobs = jrunner.make_rollout_fn(jv, T)(jp, state, obs, key)
    noise, reset_u = [], []
    for k in jax.random.split(key, T):
        k_act, k_env = jax.random.split(k)
        noise.append(jax.random.gumbel(k_act, (N, max(tv.num_actions, 1))))
        reset_u.append(_reset_uniforms(jax.random.split(k_env, N),
                                       tv.draw_dim))
    tstate, tobs = tv.reset(_t(_reset_uniforms(keys0, tv.draw_dim)))
    tro, (ts, tt), tobs_last = trunner.make_rollout_fn(tv, T).with_draws(
        tp, tstate, tobs, _t(np.stack(noise)), _t(np.stack(reset_u)))
    np.testing.assert_array_equal(tro.actions.numpy(), np.asarray(ro.actions))
    np.testing.assert_array_equal(tro.dones.numpy(), np.asarray(ro.dones))
    assert tro.dones.any()
    for f in ("obs", "log_probs", "rewards", "values"):
        np.testing.assert_allclose(getattr(tro, f).numpy(),
                                   np.asarray(getattr(ro, f)),
                                   atol=SUM_ATOL, err_msg=f)
    np.testing.assert_allclose(tobs_last.numpy(), np.asarray(jobs),
                               atol=SUM_ATOL)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_env_runner_shapes_and_draws():
    """The runner's own draws (CPU, eager): shapes as the reference's,
    and a runner re-seeded alike gives the same rollout."""
    env = tenv.CartPole()
    learner = tppo.PPOLearner(env, device=CPU)
    a, b = (trl.EnvRunner(env, num_envs=8, rollout_len=16, seed=3,
                          device=CPU) for _ in range(2))
    ro = a.sample(learner.get_weights())
    assert ro.obs.shape == (16, 8, 4) and ro.values.shape == (17, 8)
    assert ro.actions.shape == (16, 8) and ro.dones.dtype == torch.bool
    ro_b = b.sample(learner.get_weights())
    for x, y in zip(ro, ro_b):
        assert torch.equal(x, y)
    # Runner state carries over: the next rollout starts at the last obs.
    ro2 = a.sample(learner.get_weights())
    assert not torch.equal(ro2.obs[0], ro.obs[0])
    assert a.steps_per_sample() == 128


# ------------------------------------------------------- replay, DQN


def test_replay_buffer_matches_reference_exactly():
    rng = np.random.default_rng(9)
    jb, tb = JReplayBuffer(100), trl.ReplayBuffer(100)
    for i in range(5):   # wraps the ring more than twice
        obs = rng.random((10, 8, 4)).astype(np.float32)
        acts = rng.integers(0, 2, (10, 8))
        rews = rng.random((10, 8)).astype(np.float32)
        dones = rng.random((10, 8)) < 0.1
        for b in (jb, tb):
            b.add_rollout(obs[:-1], acts[:-1], rews[:-1], dones[:-1],
                          obs[1:])
        assert len(jb) == len(tb) == min(72 * (i + 1), 100)
    for seed in (0, 1):
        js = jb.sample(32, np.random.default_rng(seed))
        ts = tb.sample(32, np.random.default_rng(seed))
        assert js.keys() == ts.keys()
        for k in js:
            np.testing.assert_array_equal(ts[k], js[k])
    with pytest.raises(ValueError):
        trl.ReplayBuffer(4).sample(1, np.random.default_rng(0))


def test_dqn_train_from_buffer_matches_reference():
    """Three iterations of 4 double-DQN steps from the same buffer and
    numpy seed; the target syncs after the second (step 8 crosses 6) and
    the third (step 12)."""
    cfg = dict(batch_size=16, train_steps_per_iter=4, target_update_freq=6,
               min_buffer_size=100)
    jl = jdqn.DQNLearner(jenv.CartPole(), jdqn.DQNConfig(**cfg), seed=0)
    tl = tdqn.DQNLearner(tenv.CartPole(), tdqn.DQNConfig(**cfg), seed=0,
                         device=CPU)
    ref = jax.tree_util.tree_map(np.asarray, jl.params)
    tl.set_weights(tppo.policy_params_from_jax(ref, device=CPU))
    tppo.copy_params_(tl.target_params,
                      tppo.policy_params_from_jax(ref, device=CPU))
    ro = _random_rollout(np.random.default_rng(10), jl.params, 12, 8)
    assert np.isnan(jl.update(jppo.Rollout(*(jnp.asarray(x) for x in ro))))
    assert np.isnan(tl.update(tppo.Rollout(*(_t(x) for x in ro))))
    ro = _random_rollout(np.random.default_rng(11), jl.params, 12, 8)
    jloss = jl.update(jppo.Rollout(*(jnp.asarray(x) for x in ro)))
    tloss = tl.update(tppo.Rollout(*(_t(x) for x in ro)))
    np.testing.assert_allclose(tloss, jloss, atol=SUM_ATOL)
    for _ in range(2):
        np.testing.assert_allclose(tl.train_from_buffer(),
                                   jl.train_from_buffer(), atol=SUM_ATOL)
        _assert_params(tl.params, jl.params, UPDATE_ATOL)
        _assert_params(tl.target_params, jl.target_params, UPDATE_ATOL)
    assert tl._steps == jl._steps == 12


def test_dqn_loss_and_gradients_match_reference():
    jl = jdqn.DQNLearner(jenv.CartPole(), jdqn.DQNConfig(), seed=1)
    loss_fn = _closure(jl._train_many)["loss_fn"]
    jp, _ = _jax_params(1)
    jt, _ = _jax_params(2)
    tp = tppo.clone_params(tppo.policy_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device=CPU), True)
    tt = tppo.policy_params_from_jax(jax.tree_util.tree_map(np.asarray, jt),
                                     device=CPU)
    rng = np.random.default_rng(12)
    batch = {"obs": rng.normal(size=(64, 4)).astype(np.float32),
             "actions": rng.integers(0, 2, 64).astype(np.int32),
             # Rewards spread so that some errors pass Huber's delta of 1.
             "rewards": rng.normal(0, 2, 64).astype(np.float32),
             "dones": (rng.random(64) < 0.2).astype(np.float32),
             "next_obs": rng.normal(size=(64, 4)).astype(np.float32)}
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jp, jt, {k: jnp.asarray(v) for k, v in batch.items()})
    loss = tdqn.dqn_loss(tp, tt, {k: _t(v) for k, v in batch.items()}, 0.99)
    grads = torch.autograd.grad(loss, tppo.leaves(tp), materialize_grads=True)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL)
    for g, r in zip(grads, tppo.leaves(jax.tree_util.tree_map(
            np.asarray, jgrads))):
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL)


# -------------------------------------------------------- multi-agent


def test_coordination_game_step_matches_reference():
    rng = np.random.default_rng(13)
    n, K = 64, 3
    jv, tv = jma.CoordinationGame(K, 8), tma.CoordinationGame(K, 8)
    t = rng.integers(0, 8, n).astype(np.int32)
    last = rng.integers(-1, K, (2, n)).astype(np.int32)
    a0, a1 = (rng.integers(0, K, n).astype(np.int32) for _ in range(2))
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    (jt, j0, j1), jobs, jr, jd = jax.vmap(jv.step)(
        (jnp.asarray(t), jnp.asarray(last[0]), jnp.asarray(last[1])),
        {"a0": jnp.asarray(a0), "a1": jnp.asarray(a1)}, keys)
    (tt, t0, t1), tobs, tr, td = tv.step(
        (_t(t), _t(last[0]), _t(last[1])), {"a0": _t(a0), "a1": _t(a1)},
        torch.zeros((n, 0)))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert td.any() and not td.all()
    for got, want in ((tt, jt), (t0, j0), (t1, j1)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for ag in ("a0", "a1"):
        np.testing.assert_array_equal(tobs[ag].numpy(), np.asarray(jobs[ag]))
        np.testing.assert_array_equal(tr[ag].numpy(), np.asarray(jr[ag]))
    (_, _, _), jo = jax.vmap(jv.reset)(keys)
    (_, _, _), to = tv.reset(torch.zeros((n, 0)))
    np.testing.assert_array_equal(to["a0"].numpy(), np.asarray(jo["a0"]))


def test_multi_agent_rollout_matches_reference_with_its_draws():
    T, N, K = 12, 4, 3
    jv, tv = jma.CoordinationGame(K, 5), tma.CoordinationGame(K, 5)
    policy_of = {"a0": "p0", "a1": "p1"}
    jps = {pid: _jax_params(i, 2 * K, K, (16,)) for i, pid in
           enumerate(("p0", "p1"))}
    keys0 = jax.random.split(jax.random.PRNGKey(0), N)
    state, obs = jax.vmap(jv.reset)(keys0)
    key = jax.random.PRNGKey(3)
    ro, _, _ = jma.make_multi_rollout_fn(jv, T, policy_of)(
        {p: v[0] for p, v in jps.items()}, state, obs, key)
    noise = {"a0": [], "a1": []}
    for k in jax.random.split(key, T):
        akeys = jax.random.split(jax.random.split(k)[0], 2)
        for i, ag in enumerate(("a0", "a1")):
            noise[ag].append(jax.random.gumbel(akeys[i], (N, K)))
    tstate, tobs = tv.reset(torch.zeros((N, 0)))
    tro, _, _ = tma.make_multi_rollout_fn(tv, T, policy_of).with_draws(
        {p: v[1] for p, v in jps.items()}, tstate, tobs,
        {ag: _t(np.stack(v)) for ag, v in noise.items()},
        torch.zeros((T, N, 0)))
    for ag in ("a0", "a1"):
        np.testing.assert_array_equal(tro[ag].actions.numpy(),
                                      np.asarray(ro[ag].actions))
        np.testing.assert_array_equal(tro[ag].dones.numpy(),
                                      np.asarray(ro[ag].dones))
        for f in ("obs", "log_probs", "rewards", "values"):
            np.testing.assert_allclose(getattr(tro[ag], f).numpy(),
                                       np.asarray(getattr(ro[ag], f)),
                                       atol=SUM_ATOL, err_msg=f)


def test_multi_agent_runner_shapes_and_shared_policy():
    env = tma.CoordinationGame(num_actions=3, episode_len=8)
    algo = tma.MultiAgentPPO(env, num_envs=4, rollout_len=8, device=CPU)
    ro = algo.runner.sample(algo.weights())
    assert set(ro) == {"a0", "a1"}
    for r in ro.values():
        assert r.obs.shape == (8, 4, 6) and r.actions.shape == (8, 4)
        assert r.values.shape == (9, 4)
    shared = tma.MultiAgentPPO(env, policy_of={"a0": "s", "a1": "s"},
                               num_envs=8, rollout_len=8, device=CPU)
    assert list(shared.learners) == ["s"]
    out = shared.train()
    assert set(out["losses"]) == {"s"} and np.isfinite(out["losses"]["s"])
    assert out["env_steps"] == 8 * 8 * 2


# -------------------------------------------------- algorithm, errors


def test_ppo_improves_on_cartpole():
    """tests/test_rl.py's learning check, on the port: the done-rate
    proxy of episode length rises past 1.5x over 9 iterations."""
    algo = (trl.AlgorithmConfig("PPO", device=CPU)
            .environment("CartPole-v1")
            .env_runners(num_envs_per_env_runner=32,
                         rollout_fragment_length=64)
            .training(lr=3e-3, num_epochs=4)
            .debugging(seed=0)
            .build())
    first = algo.train()
    for _ in range(8):
        last = algo.train()
    assert last["episode_len_mean"] > first["episode_len_mean"] * 1.5, (
        first, last)
    assert last["num_env_steps_sampled"] == 32 * 64
    assert last["training_iteration"] == 9
    ret = algo.evaluate(num_episodes=4)["episode_return_mean"]
    assert 1 <= ret <= 500


def test_dqn_algorithm_and_evaluate_run():
    algo = (trl.AlgorithmConfig("DQN", device=CPU)
            .env_runners(num_envs_per_env_runner=8,
                         rollout_fragment_length=16)
            .training(min_buffer_size=150, batch_size=16,
                      train_steps_per_iter=4)
            .build())
    assert np.isnan(algo.train()["loss"])     # below min_buffer_size
    assert np.isfinite(algo.train()["loss"])
    pend = (trl.AlgorithmConfig("PPO", device=CPU).environment("Pendulum-v1")
            .env_runners(num_envs_per_env_runner=4,
                         rollout_fragment_length=8).build())
    assert np.isfinite(pend.train()["loss"])
    # Greedy Pendulum episodes last exactly max_episode_steps.
    assert pend.evaluate(num_episodes=2)["episode_return_mean"] < 0


def test_bench_rollout_throughput_runs():
    out = tbench.rollout_throughput(num_envs=4, rollout_len=8, n_iters=1,
                                       device=CPU)
    assert out["env_steps_per_sec"] > 0 and out["num_envs"] == 4


def test_remote_runners_and_impala_raise():
    # Remote runners and IMPALA run on the runtime now
    # (tests/test_torch_rl_remote.py); an algorithm the reference lacks
    # raises in both.
    with pytest.raises(NotImplementedError):
        trl.AlgorithmConfig("SAC", device=CPU).build()
