"""Twins of the reference's Train orchestration: the worker-group trainer
(``tests/test_train_tune.py:31-150``), restore from a storage URI and
async saves (``tests/test_checkpoint_storage.py:77-125``), TorchTrainer's
data parallelism (``tests/test_train_torch.py``) and the flagship's
training step through both trainers, on the CPU.

Both runtimes run in one process (the reference on
``ray_tpu.init(worker_mode="thread")``). Each case runs the same loop
through the reference's ``JaxTrainer`` and the port's
``DataParallelTrainer`` (or each side's ``TorchTrainer``), and the metric
histories, ranks, stored checkpoint counts and error type names must be
equal; float results are held within the tolerances stated where they
are used. Every wait is bounded; nothing asserts on wall time.
"""

import dataclasses
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.data as jdata
import ray_tpu.models as jm
import ray_tpu.train as jtrain
import ray_tpu.train.torch as jtorch
import ray_tpu_torch
import ray_tpu_torch.data as tdata
import ray_tpu_torch.train as ttrain
import ray_tpu_torch.train.torch as ttorch
from ray_tpu import collective as jcol
from ray_tpu.data.filesystem import MemoryFilesystem as JMem
from ray_tpu.models import transformer as jt
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu_torch import models as tm
from ray_tpu_torch.collective import collective as tcol
from ray_tpu_torch.data.filesystem import MemoryFilesystem as TMem
from ray_tpu_torch.models import transformer as tt

# The suite runs in several worker processes on one machine: one intra-op
# thread per process keeps these tests from starving the timing-sensitive
# tests that run beside them (as tests/test_torch_train.py does).
torch.set_num_threads(1)

REF = types.SimpleNamespace(
    name="ref", rt=ray_tpu, train=jtrain, col=jcol, data=jdata,
    Trainer=jtrain.JaxTrainer, TorchTrainer=jtrain.TorchTrainer,
    prepare_model=jtorch.prepare_model,
    prepare_data_loader=jtorch.prepare_data_loader,
    Store=jtrain.CheckpointStore)
PORT = types.SimpleNamespace(
    name="port", rt=ray_tpu_torch, train=ttrain, col=tcol, data=tdata,
    Trainer=ttrain.DataParallelTrainer, TorchTrainer=ttrain.TorchTrainer,
    prepare_model=ttorch.prepare_model,
    prepare_data_loader=ttorch.prepare_data_loader,
    Store=ttrain.CheckpointStore)
SIDES = {"ref": REF, "port": PORT}


@pytest.fixture
def runtimes():
    for rt in (ray_tpu, ray_tpu_torch):
        rt.shutdown()
    ray_tpu.init(num_cpus=4, worker_mode="thread", ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4)
    for mem in (JMem, TMem):
        mem.clear()
    try:
        yield
    finally:
        for mem in (JMem, TMem):
            mem.clear()
        for rt in (ray_tpu, ray_tpu_torch):
            rt.shutdown()


def _both(case):
    """The case's outcome through each side; they must be equal."""
    out = {}
    for name, side in SIDES.items():
        try:
            out[name] = ("ok", case(side))
        except Exception as exc:  # noqa: BLE001 — the error is the outcome
            out[name] = ("err", type(exc).__name__)
    assert out["port"] == out["ref"]
    return out["ref"]


# ------------------------------------------------------ the worker group
def test_trainer_ranks_and_report(runtimes):
    def case(s):
        def loop():
            ctx = s.train.get_context()
            s.col.init_collective_group(4, ctx.get_world_rank(),
                                        group_name="t_ranks")
            ranks = s.col.allgather(np.asarray([ctx.get_world_rank()]),
                                    group_name="t_ranks")
            if ctx.get_world_rank() == 0:
                s.train.report({
                    "ranks": sorted(int(r[0]) for r in ranks),
                    "world_size": ctx.get_world_size(), "loss": 1.0})

        result = s.Trainer(
            loop, scaling_config=s.train.ScalingConfig(num_workers=4)).fit()
        s.col.destroy_collective_group("t_ranks")
        return result.metrics, result.metrics_history

    (_, (metrics, _)) = _both(case)
    assert metrics == {"ranks": [0, 1, 2, 3], "world_size": 4, "loss": 1.0}


def test_trainer_collective_between_workers(runtimes):
    def case(s):
        def loop():
            ctx = s.train.get_context()
            s.col.init_collective_group(4, ctx.get_world_rank(),
                                        group_name="t_all")
            out = s.col.allreduce(np.asarray([float(ctx.get_world_rank())]),
                                  group_name="t_all")
            s.train.report({"sum": float(out[0])})

        result = s.Trainer(
            loop, scaling_config=s.train.ScalingConfig(num_workers=4)).fit()
        s.col.destroy_collective_group("t_all")
        return result.metrics

    assert _both(case) == ("ok", {"sum": 6.0})


def test_trainer_group_collective_is_joined_before_the_loop(runtimes):
    """The trainer joins every worker to the run's group, named by
    ``collective_group``, before the loop runs."""
    def case(s):
        def loop():
            ctx = s.train.get_context()
            total = s.col.allreduce(np.asarray([ctx.get_world_rank() + 1.0]),
                                    group_name=ctx.collective_group)
            s.train.report({"total": float(total[0]),
                            "prefix": ctx.collective_group.split("-")[0]})

        return s.Trainer(loop, scaling_config=s.train.ScalingConfig(
            num_workers=3)).fit().metrics

    assert _both(case) == ("ok", {"total": 6.0, "prefix": "train"})


def test_trainer_checkpoint_and_storage(runtimes, tmp_path):
    def case(s):
        def loop():
            ctx = s.train.get_context()
            for step in range(3):
                ckpt = s.train.Checkpoint.from_dict({"step": step})
                if ctx.get_world_rank() == 0:
                    s.train.report({"step": step}, checkpoint=ckpt)
                else:
                    s.train.report({"step": step})

        root = tmp_path / s.name
        result = s.Trainer(
            loop, scaling_config=s.train.ScalingConfig(num_workers=2),
            run_config=s.train.RunConfig(name="ckpt_run",
                                         storage_path=str(root))).fit()
        stored = s.Store(str(root / "ckpt_run")).list_checkpoints()
        return (result.metrics_history, result.checkpoint.to_dict(),
                result.checkpoint.path.startswith(str(root / "ckpt_run")),
                len(stored), result.path == str(root / "ckpt_run"))

    assert _both(case) == ("ok", (
        [{"step": 0}, {"step": 1}, {"step": 2}], {"step": 2}, True, 3, True))


def test_trainer_failure_restart_from_checkpoint(runtimes, tmp_path):
    def case(s):
        attempts_file = tmp_path / f"attempts_{s.name}"
        attempts_file.write_text("")

        def loop(config):
            start = 0
            ckpt = s.train.get_checkpoint()
            if ckpt is not None:
                start = ckpt.to_dict()["step"] + 1
            prior = attempts_file.read_text().splitlines()
            attempts_file.write_text("\n".join(prior + [str(start)]))
            for step in range(start, 4):
                s.train.report({"step": step, "x": config["x"]},
                               checkpoint=s.train.Checkpoint.from_dict(
                                   {"step": step}))
                if step == 1 and not prior:
                    raise RuntimeError("injected worker failure")

        result = s.Trainer(
            loop, train_loop_config={"x": 1},
            scaling_config=s.train.ScalingConfig(num_workers=1),
            run_config=s.train.RunConfig(
                failure_config=s.train.FailureConfig(max_failures=1))).fit()
        return (result.metrics_history,
                attempts_file.read_text().splitlines())

    _, (history, attempts) = _both(case)
    # The history holds the attempt that finished (as in the reference);
    # the restart resumed past step 1's checkpoint.
    assert [m["step"] for m in history] == [2, 3]
    assert attempts == ["0", "2"]


@pytest.mark.parametrize("max_failures", [0, 1])
def test_trainer_failure_exhausted(runtimes, max_failures):
    def case(s):
        calls = []

        def loop():
            calls.append(1)
            raise ValueError("always fails")

        try:
            s.Trainer(loop, scaling_config=s.train.ScalingConfig(
                num_workers=1), run_config=s.train.RunConfig(
                failure_config=s.train.FailureConfig(
                    max_failures=max_failures))).fit()
        except Exception as exc:  # noqa: BLE001 — compared by type name
            return (type(exc).__name__, type(exc.__cause__).__name__,
                    len(calls))
        return None

    _, (err, _, attempts) = _both(case)
    assert (err, attempts) == ("TrainingFailedError", max_failures + 1)


def test_trainer_dataset_sharding(runtimes):
    def case(s):
        def loop():
            ctx = s.train.get_context()
            shard = s.train.get_dataset_shard("train")
            s.col.init_collective_group(4, ctx.get_world_rank(),
                                        group_name="t_shard")
            counts = s.col.allgather(np.asarray([shard.count()]),
                                     group_name="t_shard")
            firsts = s.col.allgather(
                np.asarray([shard.take(1)[0]["id"]]), group_name="t_shard")
            if ctx.get_world_rank() == 0:
                s.train.report({"rows": [int(c[0]) for c in counts],
                                "firsts": [int(f[0]) for f in firsts]})

        result = s.Trainer(
            loop, scaling_config=s.train.ScalingConfig(num_workers=4),
            datasets={"train": s.data.range(100)}).fit()
        s.col.destroy_collective_group("t_shard")
        return result.metrics

    assert _both(case) == ("ok", {"rows": [25, 25, 25, 25],
                                  "firsts": [0, 25, 50, 75]})


def test_trainer_callbacks_log_the_result_stream(runtimes, tmp_path):
    def case(s):
        log_dir = tmp_path / s.name

        def loop():
            for step in range(3):
                s.train.report({"step": step, "loss": 1.0 / (step + 1)})

        s.Trainer(loop, run_config=s.train.RunConfig(callbacks=[
            s.train.JsonLoggerCallback(str(log_dir)),
            s.train.CSVLoggerCallback(str(log_dir))])).fit()
        return ((log_dir / "result.json").read_text(),
                (log_dir / "progress.csv").read_text())

    _, (json_lines, csv_text) = _both(case)
    assert len(json_lines.splitlines()) == 3
    assert csv_text.splitlines()[0] == "loss,step"


# --------------------------------------------- storage URIs and restore
def _resume_loop(config):
    """A module-level loop, so that stdlib pickle stores it in
    ``trainer.pkl`` (the port has no cloudpickle) and ``restore`` finds it
    without being handed it."""
    train = SIDES[config["side"]].train
    prev = train.get_checkpoint()
    start = prev.to_dict()["step"] if prev is not None else 0
    for s in (1, 2):
        step = start + s
        train.report({"step": step, "resumed_from": start},
                     checkpoint=train.Checkpoint.from_dict({"step": step}))


def test_trainer_restore_from_uri(runtimes):
    def case(s):
        uri_root = "memory://trains"
        result = s.Trainer(
            _resume_loop, train_loop_config={"side": s.name},
            scaling_config=s.train.ScalingConfig(num_workers=1),
            run_config=s.train.RunConfig(name="run1",
                                         storage_path=uri_root)).fit()
        restored = s.Trainer.restore(f"{uri_root}/run1")
        resumed_from = restored._restore_from.to_dict()
        result2 = restored.fit()
        listed = s.Store(f"{uri_root}/run1").list_checkpoints()
        return (result.metrics, result2.metrics, resumed_from, len(listed),
                restored._loop is _resume_loop)

    assert _both(case) == ("ok", (
        {"step": 2, "resumed_from": 0}, {"step": 4, "resumed_from": 2},
        {"step": 2}, 4, True))


def test_restore_without_state_needs_the_loop(runtimes):
    def case(s):
        with pytest.raises(ValueError):
            s.Trainer.restore("memory://nowhere/run")
        restored = s.Trainer.restore(
            "memory://nowhere/run", train_loop_per_worker=_resume_loop,
            train_loop_config={"side": s.name})
        rc = restored._run_config
        return (restored._restore_from, rc.name, rc.storage_path,
                restored.fit().metrics)

    assert _both(case) == ("ok", (
        None, "run", "memory://nowhere", {"step": 2, "resumed_from": 0}))


@pytest.mark.parametrize("keep", [None, 2])
def test_trainer_async_save_with_retention(runtimes, keep):
    def case(s):
        def loop():
            for step in (1, 2, 3):
                s.train.report({"step": step},
                               checkpoint=s.train.Checkpoint.from_dict(
                                   {"step": step}))

        result = s.Trainer(loop, run_config=s.train.RunConfig(
            name="arun", storage_path="memory://bucket",
            checkpoint_config=s.train.CheckpointConfig(
                num_to_keep=keep, async_save=True))).fit()
        store = s.Store("memory://bucket/arun")
        listed = store.list_checkpoints()
        latest = store.latest()
        try:
            return (result.metrics, len(listed), latest.to_dict(),
                    result.checkpoint.to_dict())
        finally:
            shutil.rmtree(latest.path)

    assert _both(case) == ("ok", (
        {"step": 3}, keep or 3, {"step": 3}, {"step": 3}))


# ----------------------------------------------- TorchTrainer (DP on CPU)
W_TRUE = np.asarray([1.0, -2.0, 3.0, 0.5], dtype=np.float32)
# Both sides run the same torch model from the same seeds and average the
# same two f32 gradient vectors (numpy's mean of two against torch's):
# after 40 SGD steps the parameters agree to a few f32 ulps of their
# size (~3), far below the distance a missing sync would leave.
DP_PARAM_ATOL = 1e-5


def _regression_loop(s, model_of):
    def loop():
        import torch.nn as nn

        ctx = s.train.get_context()
        # Divergent inits from a per-rank numpy seed (torch's global
        # generator is shared by the ranks' threads).
        rng = np.random.default_rng(100 + ctx.get_world_rank())
        model = model_of(nn)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(torch.from_numpy(
                    rng.normal(size=p.shape).astype(np.float32)))
        model = s.prepare_model(model)
        opt = torch.optim.SGD(model.parameters(), lr=0.1)
        # Rank-dependent data: only gradient averaging keeps the
        # replicas in lockstep.
        rng = np.random.default_rng(ctx.get_world_rank())
        x = rng.normal(size=(256, 4)).astype(np.float32)
        y = x @ W_TRUE + 0.01 * rng.normal(size=256).astype(np.float32)
        xt, yt = torch.from_numpy(x), torch.from_numpy(y[:, None])
        losses = []
        for _ in range(40):
            opt.zero_grad()
            loss = nn.functional.mse_loss(model(xt), yt)
            loss.backward()
            opt.step()
            losses.append(loss.item())
        flat = torch.cat([p.detach().reshape(-1)
                          for p in model.parameters()])
        digests = s.col.allgather(flat.numpy().copy(),
                                  group_name=ctx.collective_group)
        s.train.report({
            "first_loss": losses[0], "last_loss": losses[-1],
            "param_digest": [float(v) for v in flat],
            "ranks_equal": bool(np.array_equal(np.asarray(digests[0]),
                                               np.asarray(digests[1])))})

    return loop


@pytest.mark.parametrize("model", ["linear", "unused_branch"])
def test_torch_trainer_dp_learns_and_stays_synced(runtimes, model):
    def model_of(nn):
        if model == "linear":
            return nn.Linear(4, 1)

        class TwoHead(nn.Module):
            def __init__(self):
                super().__init__()
                self.used = nn.Linear(4, 1)
                self.unused = nn.Linear(4, 1)  # requires_grad, no grad

            def forward(self, x):
                return self.used(x)

        return TwoHead()

    got = {}
    for name, s in SIDES.items():
        got[name] = s.TorchTrainer(
            _regression_loop(s, model_of),
            scaling_config=s.train.ScalingConfig(num_workers=2)).fit().metrics
    ref, port = got["ref"], got["port"]
    assert port["ranks_equal"] and ref["ranks_equal"]
    np.testing.assert_allclose(port["param_digest"], ref["param_digest"],
                               rtol=0, atol=DP_PARAM_ATOL)
    assert port["last_loss"] < port["first_loss"] / 5
    np.testing.assert_allclose(port["param_digest"][:4], W_TRUE, atol=0.15)


def test_prepare_data_loader_shards_per_rank(runtimes):
    def case(s):
        def loop():
            import torch.utils.data as tud

            ctx = s.train.get_context()
            loader = s.prepare_data_loader(tud.DataLoader(
                tud.TensorDataset(torch.arange(20)), batch_size=5))
            seen = []
            for (batch,) in loader:
                seen.extend(batch.tolist())
            all_seen = s.col.allgather(np.asarray(sorted(seen)),
                                       group_name=ctx.collective_group)
            if ctx.get_world_rank() == 0:
                s.train.report({"count": len(seen),
                                "seen": [np.asarray(a).tolist()
                                         for a in all_seen]})

        return s.TorchTrainer(loop, scaling_config=s.train.ScalingConfig(
            num_workers=2)).fit().metrics

    _, metrics = _both(case)
    assert metrics["count"] == 10
    assert sorted(sum(metrics["seen"], [])) == list(range(20))


# ----------------------------------------------- the flagship, 3 steps
FLAGSHIP = jm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                                n_heads=4, n_kv_heads=2, d_ff=48,
                                dtype=jnp.float32)
B, S, STEPS, LR = 2, 16, 3, 3e-4
# As tests/test_torch_train.py's LOSS_RTOL: the same f32 math in another
# summation order.
LOSS_RTOL = 1e-6


def _flagship_loop_ref(config):
    import optax

    cfg, jp = config["cfg"], config["params"]
    mesh = make_mesh(MeshConfig(dp=1), devices=jax.devices("cpu")[:1])
    step, pspec, _ = jt.make_spmd_train_step(cfg, mesh, jp,
                                             optimizer=optax.adamw(LR))
    params = jt.shard_params_for_step(jp, mesh, pspec)
    opt_state = optax.adamw(LR).init(params)
    shard = jtrain.get_dataset_shard("train")
    for batch in shard.iter_jax_batches(batch_size=B):
        tokens = batch["tokens"]
        params, opt_state, loss = step(params, opt_state, tokens[:, :-1],
                                       tokens[:, 1:])
        jtrain.report({"loss": float(loss)})


def _flagship_loop_port(config):
    cfg, params = config["cfg"], config["params"]
    step = tm.make_train_step(cfg, params, lr=LR)
    shard = ttrain.get_dataset_shard("train")
    for batch in shard.iter_torch_batches(batch_size=B, device="cpu"):
        tokens = batch["tokens"]
        loss = step(tokens[:, :-1], tokens[:, 1:])
        ttrain.report({"loss": loss.item()})


def test_flagship_trains_through_both_trainers(runtimes):
    fields = {f.name: getattr(FLAGSHIP, f.name)
              for f in dataclasses.fields(FLAGSHIP)}
    tcfg = tt.TransformerConfig(**{**fields, "dtype": torch.float32})
    jp = jm.init_params(FLAGSHIP, jax.random.PRNGKey(0))
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                            device="cpu")
    tokens = np.random.default_rng(5).integers(
        0, FLAGSHIP.vocab_size, (STEPS * B, S + 1)).astype(np.int64)
    ref = jtrain.JaxTrainer(
        _flagship_loop_ref,
        train_loop_config={"cfg": FLAGSHIP, "params": jp},
        datasets={"train": jdata.from_columns({"tokens": tokens},
                                              parallelism=2)}).fit()
    port = ttrain.DataParallelTrainer(
        _flagship_loop_port,
        train_loop_config={"cfg": tcfg, "params": tp},
        datasets={"train": tdata.from_columns({"tokens": tokens},
                                              parallelism=2)}).fit()
    ref_losses = [m["loss"] for m in ref.metrics_history]
    port_losses = [m["loss"] for m in port.metrics_history]
    assert len(port_losses) == len(ref_losses) == STEPS
    np.testing.assert_allclose(port_losses, ref_losses, rtol=LOSS_RTOL)
