"""The port's IMPALA learner (``ray_tpu_torch.rl.impala``) against the JAX
reference (``ray_tpu.rl.impala``) on the CPU.

The reference's ``IMPALA.__init__`` starts a runtime and two env-runner
actors, so no test here constructs it or calls ``ray_tpu.init``: the
reference's update is built on an instance made without ``__init__``,
given only the config and the optimizer that ``__init__`` would give it.
Parameters come from the reference's ``init_policy``, carried across by
``policy_params_from_jax``; rollouts from a numpy seed, off-policy, with
importance ratios above both clips and episodes ending inside them.
Tolerances:

- ``vtrace`` and the loss in f32: ATOL 1e-5 (sums over a T-step reverse
  scan and over a T x N batch, in another summation order);
- gradients of the loss: 1e-6 (O(0.1) values);
- one and two updates (global-norm clip and Adam): each parameter within
  UPDATE_ATOL = 1e-5, but for the few elements whose reference gradient
  lies below ADAM_FLOOR = 1e-7 in some step. Adam's first step moves a
  parameter by lr * g / (|g| + eps), whose slope in g is
  lr * eps / (|g| + eps)**2: the two sides' gradients differ by the
  rounding of their f32 sums (~2e-9 here, sums of O(1e-3) terms that
  cancel), which moves a parameter by more than 1e-5 only where |g| is
  under ~1e-7. There Adam's own bound holds instead: a step moves a
  parameter by at most 2 * lr. Such elements must stay under 1% of the
  parameters (they are ~0.1% at these seeds), so the check keeps its
  teeth.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rl import impala as jimpala
from ray_tpu.rl import ppo as jppo
from ray_tpu_torch import rl as trl
from ray_tpu_torch.rl import env as tenv
from ray_tpu_torch.rl import impala as timpala
from ray_tpu_torch.rl import ppo as tppo

torch.set_num_threads(1)

ATOL = 1e-5
GRAD_ATOL = 1e-6
UPDATE_ATOL = 1e-5
ADAM_FLOOR = 1e-7
CPU = "cpu"
T, N = 16, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _reference(cfg):
    """The reference's jitted update and a fresh optax state maker, from
    an IMPALA made without ``__init__`` (which would start a runtime)."""
    ref = object.__new__(jimpala.IMPALA)
    ref.config = cfg
    ref._opt = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                           optax.adam(cfg.lr))
    return ref, ref._make_update()


def _closure(fn):
    """The free variables of a jitted reference function (its inner
    ``loss_fn``, which the reference does not export)."""
    fn = getattr(fn, "__wrapped__", fn)
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _jax_params(seed=0, hidden=(64, 64)):
    jp = jppo.init_policy(jax.random.PRNGKey(seed), 4, 2, hidden)
    return jp, tppo.policy_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device=CPU)


def _vtrace_inputs(rng):
    behavior = np.log(rng.uniform(0.05, 0.95, (T, N))).astype(np.float32)
    target = np.log(rng.uniform(0.05, 0.95, (T, N))).astype(np.float32)
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    dones = rng.random((T, N)) < 0.15
    values = rng.normal(size=(T, N)).astype(np.float32)
    v_boot = rng.normal(size=N).astype(np.float32)
    return behavior, target, rewards, dones, values, v_boot


@pytest.mark.parametrize("rho_clip,c_clip", [(1.0, 1.0), (1.5, 0.8)])
def test_vtrace_matches_reference(rho_clip, c_clip):
    inputs = _vtrace_inputs(np.random.default_rng(11))
    behavior, target, _, dones = inputs[:4]
    rho = np.exp(target - behavior)
    assert (rho > max(rho_clip, c_clip)).mean() > 0.2
    assert dones.any() and not dones.all()
    jout = jimpala.vtrace(*(jnp.asarray(x) for x in inputs), 0.99,
                          rho_clip, c_clip)
    tout = timpala.vtrace(*(_t(x) for x in inputs), 0.99, rho_clip, c_clip)
    for name, a, b in zip(("vs", "pg_adv", "rho"), tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=name)


def test_vtrace_stops_gradients_as_the_reference():
    inputs = [_t(x) for x in _vtrace_inputs(np.random.default_rng(12))]
    target, values = inputs[1].requires_grad_(), inputs[4].requires_grad_()
    vs, pg_adv, rho = timpala.vtrace(*inputs, 0.99, 1.0, 1.0)
    assert not vs.requires_grad and not pg_adv.requires_grad
    assert rho.requires_grad
    # Float dones give the same targets as bool ones.
    vs_f = timpala.vtrace(*inputs[:3], inputs[3].float(), *inputs[4:],
                          0.99, 1.0, 1.0)[0]
    assert torch.equal(vs, vs_f)


def _rollout(rng, jp):
    """A CartPole-shaped rollout whose behaviour log-probs are not the
    policy's: rho = pi / mu spreads over both sides of the clips."""
    obs = rng.normal(size=(T, N, 4)).astype(np.float32)
    actions = rng.integers(0, 2, (T, N)).astype(np.int32)
    behavior = np.log(rng.uniform(0.1, 0.9, (T, N))).astype(np.float32)
    rewards = np.ones((T, N), np.float32)
    dones = rng.random((T, N)) < 0.1
    values = rng.normal(size=(T + 1, N)).astype(np.float32)
    logits = np.asarray(jppo.policy_logits(jp, jnp.asarray(obs)))
    target = np.take_along_axis(np.asarray(jax.nn.log_softmax(logits)),
                                actions[..., None], -1)[..., 0]
    assert (np.exp(target - behavior) > 1.0).mean() > 0.2
    return obs, actions, behavior, rewards, dones, values


def test_loss_and_gradients_match_reference():
    loss_fn = _closure(_reference(jimpala.IMPALAConfig())[1])["loss_fn"]
    jp, tp = _jax_params()
    tp = tppo.clone_params(tp, True)
    ro = _rollout(np.random.default_rng(13), jp)
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jp, jppo.Rollout(*(jnp.asarray(x) for x in ro)))
    loss = timpala.impala_loss(tp, tppo.Rollout(*(_t(x) for x in ro)),
                               timpala.IMPALAConfig())
    grads = torch.autograd.grad(loss, tppo.leaves(tp))
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL)
    for g, r in zip(grads, tppo.leaves(jax.tree_util.tree_map(
            np.asarray, jgrads))):
        np.testing.assert_allclose(g.numpy(), r, atol=GRAD_ATOL)


@pytest.mark.parametrize("updates", [1, 2])
def test_updates_match_reference(updates):
    """``updates`` learner steps on fresh rollouts: the loss before each
    and every parameter after the last, against the reference's jitted
    update and optax state."""
    cfg = jimpala.IMPALAConfig()
    ref, update = _reference(cfg)
    grad_fn = jax.jit(jax.grad(_closure(update)["loss_fn"]))
    jp, tp = _jax_params()
    opt_state = ref._opt.init(jp)
    learner = timpala.IMPALA(tenv.CartPole(), timpala.IMPALAConfig(),
                             device=CPU)
    learner.set_weights(tp)
    rng = np.random.default_rng(14)
    near_zero = [np.zeros(t.shape, bool) for t in tppo.leaves(tp)]
    for _ in range(updates):
        ro = _rollout(rng, jp)
        jro = jppo.Rollout(*(jnp.asarray(x) for x in ro))
        for mask, g in zip(near_zero, tppo.leaves(jax.tree_util.tree_map(
                np.asarray, grad_fn(jp, jro)))):
            mask |= np.abs(g) < ADAM_FLOOR
        jp, opt_state, jloss = update(jp, opt_state, jro)
        tloss = learner.update(tppo.Rollout(*(_t(x) for x in ro)))
        np.testing.assert_allclose(tloss, float(jloss), atol=ATOL)
    ref_leaves = tppo.leaves(jax.tree_util.tree_map(np.asarray, jp))
    for a, b, mask in zip(tppo.leaves(learner.get_weights()), ref_leaves,
                          near_zero):
        diff = np.abs(a.detach().numpy() - b)
        assert diff[~mask].max() <= UPDATE_ATOL
        assert (diff[mask] <= 2 * cfg.lr * updates).all()
    assert sum(m.sum() for m in near_zero) < 0.01 * sum(
        m.size for m in near_zero)
    # One program for the one rollout shape, reused by every update.
    assert len(learner._programs) == 1


def test_clip_by_global_norm_is_active():
    """The update's gradients exceed max_grad_norm at this seed, so the
    clip of the twins above is exercised, not bypassed."""
    jp, tp = _jax_params()
    tp = tppo.clone_params(tp, True)
    ro = _rollout(np.random.default_rng(14), jp)
    loss = timpala.impala_loss(tp, tppo.Rollout(*(_t(x) for x in ro)),
                               timpala.IMPALAConfig())
    grads = torch.autograd.grad(loss, tppo.leaves(tp))
    norm = torch.sqrt(sum((g * g).sum() for g in grads)).item()
    assert norm > timpala.IMPALAConfig().max_grad_norm


def test_learner_on_runner_rollouts_and_evaluate():
    env = tenv.CartPole()
    learner = trl.IMPALA(env, num_envs=4, rollout_len=8, seed=3,
                         device=CPU)
    assert learner.steps_per_sample == 32
    runner = trl.EnvRunner(env, 4, 8, seed=3, device=CPU)
    before = [t.detach().clone() for t in tppo.leaves(learner.params)]
    losses = [learner.update(runner.sample(learner.get_weights()))
              for _ in range(3)]
    assert all(np.isfinite(losses))
    assert any(not torch.equal(a, b) for a, b in zip(
        before, tppo.leaves(learner.params)))
    ret = learner.evaluate(num_episodes=2)["episode_return_mean"]
    assert 0 < ret <= env.max_episode_steps


def test_config_and_exports_mirror_reference():
    assert (dataclasses.asdict(trl.IMPALAConfig())
            == dataclasses.asdict(jimpala.IMPALAConfig()))
    assert trl.vtrace is timpala.vtrace and trl.IMPALA is timpala.IMPALA
    seeded = [timpala.IMPALA(tenv.CartPole(), seed=5, device=CPU)
              for _ in range(2)]
    for a, b in zip(*(tppo.leaves(s.params) for s in seeded)):
        assert torch.equal(a, b)


def test_async_loop_raises_until_the_runtime_is_ported():
    learner = timpala.IMPALA(tenv.CartPole(), device=CPU)
    with pytest.raises(NotImplementedError, match="A.5"):
        learner.train()
    with pytest.raises(NotImplementedError, match="A.5"):
        learner.stop()
    with pytest.raises(NotImplementedError, match="A.5"):
        trl.AlgorithmConfig("IMPALA", device=CPU).build()


def test_defaults_to_the_card_and_refuses_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timpala.IMPALA(tenv.CartPole())
