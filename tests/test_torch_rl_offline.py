"""Twins of the reference's offline RL (``ray_tpu/rl/offline.py``,
``tests/test_rl_async.py:113-135``) on the CPU.

The buffer <-> Dataset round trip is the reference test itself, run on
each side. The first ``train_dqn_offline`` iteration from the same
buffer starts both learners at the reference's parameters (carried
across by ``policy_params_from_jax``) and samples the same minibatches
(the learners' numpy generators are seeded alike); its mean loss matches
the reference's within SUM_ATOL = 1e-5 and every parameter after its
Adam steps within UPDATE_ATOL = 1e-5, the f32 bounds of
``tests/test_torch_rl.py`` (a mean over 4 steps of O(1) Huber losses; an
Adam step moves a parameter by at most lr). The transitions' TFRecord
round trip comes back bit for bit after the float32 cast that
``dataset_to_buffer`` applies.
"""

import jax
import numpy as np
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu.rl import DQNConfig as JDQNConfig
from ray_tpu.rl import ReplayBuffer as JReplayBuffer
from ray_tpu.rl import buffer_to_dataset as j_to_ds
from ray_tpu.rl import dataset_to_buffer as j_to_buf
from ray_tpu.rl import env as jenv
from ray_tpu.rl import train_dqn_offline as j_train
from ray_tpu_torch import rl as trl
from ray_tpu_torch.rl import ppo as tppo

SUM_ATOL = 1e-5
UPDATE_ATOL = 1e-5
CPU = "cpu"

SIDES = {"reference": (JReplayBuffer, j_to_ds, j_to_buf),
         "port": (trl.ReplayBuffer, trl.buffer_to_dataset,
                  trl.dataset_to_buffer)}


@pytest.fixture
def runtimes():
    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()
    ray_tpu.init(num_cpus=4, worker_mode="thread", ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4)
    try:
        yield
    finally:
        for rt in (ray_tpu, ray_tpu_torch):
            rt.shutdown()


def _rollout(seed, T=6, N=5, D=4):
    rng = np.random.default_rng(seed)
    obs = rng.random((T, N, D)).astype(np.float32)
    acts = rng.integers(0, 2, (T, N))
    rews = rng.random((T, N)).astype(np.float32)
    dones = (rng.random((T, N)) < 0.2).astype(np.float32)
    return obs[:-1], acts[:-1], rews[:-1], dones[:-1], obs[1:]


@pytest.mark.parametrize("side", sorted(SIDES))
def test_dataset_buffer_roundtrip(runtimes, side):
    ReplayBuffer, buffer_to_dataset, dataset_to_buffer = SIDES[side]
    buf = ReplayBuffer(capacity=200)
    obs = np.random.rand(6, 5, 4).astype(np.float32)
    acts = np.random.randint(0, 2, (6, 5))
    rews = np.random.rand(6, 5).astype(np.float32)
    dones = np.zeros((6, 5), np.float32)
    buf.add_rollout(obs[:-1], acts[:-1], rews[:-1], dones[:-1], obs[1:])
    ds = buffer_to_dataset(buf)
    back = dataset_to_buffer(ds)
    assert len(back) == len(buf) == 25
    a, b = buf._store, back._store
    order_a = np.lexsort(a["obs"][:25].T)
    order_b = np.lexsort(b["obs"][:25].T)
    assert np.allclose(a["obs"][:25][order_a], b["obs"][:25][order_b])
    assert np.allclose(a["rewards"][:25][order_a],
                       b["rewards"][:25][order_b])


def test_buffer_to_dataset_equals_reference(runtimes):
    """The same buffer gives the same columns, rows and blocks on both
    sides, and each side's load gives back the same store."""
    bufs = [SIDES[s][0](capacity=100) for s in ("reference", "port")]
    for b in bufs:
        b.add_rollout(*_rollout(3))
    jds, tds = j_to_ds(bufs[0]), trl.buffer_to_dataset(bufs[1])
    assert [sorted(b) for b in jds.iter_blocks()] == \
        [sorted(b) for b in tds.iter_blocks()]
    for jb, tb in zip(jds.iter_blocks(), tds.iter_blocks()):
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    jback, tback = j_to_buf(jds), trl.dataset_to_buffer(tds)
    assert len(jback) == len(tback) == 25
    for k in jback._store:
        np.testing.assert_array_equal(tback._store[k][:25],
                                      jback._store[k][:25])
    with pytest.raises(ValueError, match="empty"):
        trl.buffer_to_dataset(trl.ReplayBuffer(4))


def test_transitions_tfrecord_roundtrip(runtimes, tmp_path):
    """buffer -> Dataset -> TFRecords -> Dataset -> buffer gives the
    buffer back bit for bit, in order, in float32."""
    buf = trl.ReplayBuffer(capacity=100)
    buf.add_rollout(*_rollout(4))
    trl.buffer_to_dataset(buf).write_tfrecords(str(tmp_path / "tr"))
    back = trl.dataset_to_buffer(
        ray_tpu_torch.data.read_tfrecords(str(tmp_path / "tr")))
    assert len(back) == len(buf)
    for k, v in buf._store.items():
        got = back._store[k][:len(buf)]
        assert got.dtype == (np.float32 if v.dtype.kind == "f" else v.dtype)
        np.testing.assert_array_equal(got, v[:len(buf)])


def test_first_offline_iteration_matches_reference(runtimes):
    cfg = dict(batch_size=16, train_steps_per_iter=4, target_update_freq=6)
    jbuf, tbuf = JReplayBuffer(200), trl.ReplayBuffer(200)
    for seed in (5, 6):
        for b in (jbuf, tbuf):
            b.add_rollout(*_rollout(seed, T=9, N=8))
    jl = j_train(jenv.CartPole(), j_to_ds(jbuf), config=JDQNConfig(**cfg),
                 num_iterations=0, seed=7)
    tl = trl.train_dqn_offline(trl.CartPole(), trl.buffer_to_dataset(tbuf),
                               config=trl.DQNConfig(**cfg),
                               num_iterations=0, seed=7, device=CPU)
    for k in jl._buffer._store:
        np.testing.assert_array_equal(tl._buffer._store[k],
                                      jl._buffer._store[k])
    ref = jax.tree_util.tree_map(np.asarray, jl.params)
    tl.set_weights(tppo.policy_params_from_jax(ref, device=CPU))
    tppo.copy_params_(tl.target_params,
                      tppo.policy_params_from_jax(ref, device=CPU))
    jloss, tloss = jl.train_from_buffer(), tl.train_from_buffer()
    np.testing.assert_allclose(tloss, jloss, atol=SUM_ATOL)
    got = jax.tree_util.tree_map(np.asarray, jl.params)
    for tower in ("pi", "vf"):
        for i, lyr in enumerate(got[tower]):
            for k, r in lyr.items():
                np.testing.assert_allclose(
                    tl.params[tower][i][k].detach().numpy(), r,
                    atol=UPDATE_ATOL, err_msg=f"{tower}[{i}].{k}")
    assert tl._steps == jl._steps == 4


def test_train_dqn_offline_runs_on_the_cpu(runtimes):
    buf = trl.ReplayBuffer(capacity=100)
    buf.add_rollout(*_rollout(8, T=9, N=8))
    learner = trl.train_dqn_offline(
        trl.CartPole(), trl.buffer_to_dataset(buf),
        config=trl.DQNConfig(batch_size=8, train_steps_per_iter=2,
                             target_update_freq=3),
        num_iterations=3, seed=1, device=CPU)
    assert learner._steps == 6 and len(learner._buffer) == 64
    assert learner.device.type == "cpu"
    assert np.isfinite(learner.train_from_buffer())
