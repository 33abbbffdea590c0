"""Twins of the reference's Tune (``ray_tpu/tune``) on the CPU: search
spaces, schedulers and searchers fed the same inputs on both sides, and
the Tuner's trial controller (``tests/test_train_tune.py:153-220``,
``tests/test_tune_search.py:69-140``) run through each side's runtime.

Both runtimes run in one process (the reference on
``ray_tpu.init(worker_mode="thread")``). Variants, scheduler decisions
and TPE suggestions draw from ``random.Random(seed)`` on both sides, so
they must be equal value for value. A Tuner's outcome depends on the
order in which concurrent trials reach a rung; each Tuner case therefore
runs once with one trial at a time, where configs, the reports consumed
per config and the best config must be equal, and once at the
reference test's concurrency, where both sides must show what the
reference test asserts. The flagship's trials compare per-step losses
within ``LOSS_RTOL``. Every ``fit`` runs under a bound.
"""

import dataclasses
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.models as jm
import ray_tpu_torch
from ray_tpu import tune as jtune
from ray_tpu.models import transformer as jt
from ray_tpu.parallel.mesh import MeshConfig, make_mesh
from ray_tpu.train import Checkpoint as JCheckpoint
from ray_tpu.tune import search_space as jspace
from ray_tpu_torch import models as tm
from ray_tpu_torch import tune as ttune
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.train import Checkpoint as TCheckpoint
from ray_tpu_torch.tune import search_space as tspace

torch.set_num_threads(1)

FIT_TIMEOUT_S = 120.0
SIDES = {"ref": (jtune, JCheckpoint), "port": (ttune, TCheckpoint)}


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


def _fit(tuner):
    """``tuner.fit()`` under FIT_TIMEOUT_S."""
    out = {}

    def body():
        try:
            out["grid"] = tuner.fit()
        except BaseException as exc:  # noqa: BLE001 — re-raised below
            out["error"] = exc

    th = threading.Thread(target=body, daemon=True)
    th.start()
    th.join(FIT_TIMEOUT_S)
    assert not th.is_alive(), "Tuner.fit did not finish within its bound"
    if "error" in out:
        raise out["error"]
    return out["grid"]


# ------------------------------------------------------------ search spaces
def _spaces(t):
    return {
        "grid": {"a": t.grid_search([1, 2, 3]),
                 "b": t.grid_search(["x", "y"]), "c": 7},
        "random": {"lr": t.loguniform(1e-5, 1e-1), "u": t.uniform(-2, 3),
                   "n": t.randint(4, 64), "q": t.qrandint(0, 100, 8),
                   "g": t.randn(1.0, 0.5), "act": t.choice(
                       ["relu", "gelu", "silu"])},
        "mixed": {"a": t.grid_search([0.1, 0.2]), "lr": t.loguniform(
            1e-4, 1e-2), "width": t.choice([32, 64]), "k": "const"},
    }


@pytest.mark.parametrize("seed", [0, 1, 17])
@pytest.mark.parametrize("space", ["grid", "random", "mixed"])
@pytest.mark.parametrize("num_samples", [1, 3])
def test_generate_variants_equal(space, seed, num_samples):
    ref = jspace.generate_variants(_spaces(jtune)[space], num_samples,
                                   seed=seed)
    port = tspace.generate_variants(_spaces(ttune)[space], num_samples,
                                    seed=seed)
    assert port == ref
    assert len(ref) >= num_samples


# --------------------------------------------------------------- schedulers
def _stream(n_trials=6, steps=12, seed=3):
    """One fixed result stream: trials interleaved round-robin, each
    trial's score a noisy curve whose slope depends on the trial (not in
    the trials' order)."""
    rng = np.random.default_rng(seed)
    slopes = [3, 1, 5, 2, 6, 4]
    out = []
    for step in range(steps):
        for t in range(n_trials):
            score = slopes[t] * 0.3 * math.log(step + 2) + float(
                rng.normal(0, 0.2))
            out.append((f"t{t}", {"score": score, "step": step}))
    return out


def _decisions(make, mode, register=False, exploit=False):
    sched = make()
    out = []
    if register:
        for t in range(6):
            sched.register(f"t{t}", {"lr": 0.1 * (t + 1), "w": t})
    for tid, result in _stream():
        if mode == "min":
            result = {**result, "score": -result["score"]}
        d = sched.on_result(tid, result)
        e = sched.maybe_exploit(tid) if exploit else None
        out.append((tid, d, e))
    return out


@pytest.mark.parametrize("mode", ["max", "min"])
@pytest.mark.parametrize("kind", ["asha", "hyperband", "median", "pbt",
                                  "fifo"])
def test_scheduler_decisions_equal(kind, mode):
    def make(t):
        return {
            "asha": lambda: t.ASHAScheduler(
                metric="score", mode=mode, max_t=10, grace_period=1,
                reduction_factor=2),
            "hyperband": lambda: t.HyperBandScheduler(
                metric="score", mode=mode, max_t=10, grace_period=1,
                reduction_factor=2, brackets=3),
            "median": lambda: t.MedianStoppingRule(
                metric="score", mode=mode, grace_period=3),
            "pbt": lambda: t.PopulationBasedTraining(
                metric="score", mode=mode, perturbation_interval=3,
                hyperparam_mutations={"lr": [0.01, 0.1, 1.0], "w": 1.0},
                quantile_fraction=0.34, seed=11),
            "fifo": lambda: t.FIFOScheduler(),
        }[kind]

    register = kind in ("hyperband", "pbt")
    exploit = kind == "pbt"
    ref = _decisions(make(jtune), mode, register, exploit)
    port = _decisions(make(ttune), mode, register, exploit)
    assert port == ref
    decided = [d for _, d, _ in ref]
    if kind in ("asha", "median", "hyperband"):
        assert "STOP" in decided
    if kind == "pbt":
        assert any(e is not None for _, _, e in ref)


def test_hyperband_brackets_equal():
    for t in (jtune, ttune):
        hb = t.HyperBandScheduler(max_t=64, grace_period=1,
                                  reduction_factor=4, brackets=3)
        assert [b.grace for b in hb._brackets] == [1, 4, 16]
        assert [b.rungs for b in hb._brackets] == [[1, 4, 16], [4, 16],
                                                   [16]]


# ------------------------------------------------------------------ search
def _tpe_run(t, space_of, seed, n=40, target=2.5):
    s = t.TPESearcher(metric="score", mode="max", n_startup=8,
                      n_candidates=24, seed=seed)
    s.set_search_space(space_of(t))
    out = []
    for i in range(n):
        cfg = s.suggest(f"t{i}")
        x = cfg.get("x", 0.0)
        score = -(x - target) ** 2 - abs(math.log(cfg.get("lr", 1e-3))
                                         + 6.0) + (
            1.0 if cfg.get("act") == "gelu" else 0.0) - 0.01 * abs(
            cfg.get("n", 16) - 20)
        s.on_trial_complete(f"t{i}", {"score": score})
        out.append(cfg)
    return out


TPE_SPACES = {
    "uniform": lambda t: {"x": t.uniform(-10.0, 10.0)},
    "log_int": lambda t: {"lr": t.loguniform(1e-5, 1e-1),
                          "n": t.randint(8, 40)},
    "categorical": lambda t: {"x": t.uniform(0.0, 5.0),
                              "act": t.choice(["relu", "gelu", "silu"]),
                              "b": t.grid_search([1, 2]), "c": "const"},
}


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("space", sorted(TPE_SPACES))
def test_tpe_suggestions_equal(space, seed):
    ref = _tpe_run(jtune, TPE_SPACES[space], seed)
    port = _tpe_run(ttune, TPE_SPACES[space], seed)
    assert port == ref


def test_basic_variant_generator_equal():
    out = {}
    for name, (t, _) in SIDES.items():
        g = t.BasicVariantGenerator(num_samples=2, seed=5)
        g.set_search_space({"a": t.grid_search([1, 2, 3]),
                            "u": t.uniform(0, 1)})
        total = g.total_trials(1)
        out[name] = (total, [g.suggest(f"t{i}") for i in range(total + 1)])
    assert out["port"] == out["ref"]
    assert out["ref"][0] == 6 and out["ref"][1][-1] is None


def test_report_outside_trial_raises():
    for t, _ in SIDES.values():
        with pytest.raises(RuntimeError, match="outside a trial"):
            t.report({"score": 1.0})


# ------------------------------------------------------------------- Tuner
def _history(grid, key):
    return sorted((r.config[key], len(r.metrics_history)) for r in grid)


def _both(case):
    out = {name: case(t, ckpt) for name, (t, ckpt) in SIDES.items()}
    assert out["port"] == out["ref"]
    return out["ref"]


def test_tuner_grid_and_best(runtimes):
    def case(t, _):
        def trainable(config):
            return {"score": config["a"] * 10 + config["b"]}

        grid = _fit(t.Tuner(
            trainable,
            param_space={"a": t.grid_search([1, 2, 3]),
                         "b": t.uniform(0, 0.5)},
            tune_config=t.TuneConfig(metric="score", mode="max")))
        best = grid.get_best_result()
        return (len(grid), sorted((r.config["a"], r.config["b"])
                                  for r in grid), best.config["a"],
                best.metrics)

    n, _, best_a, _ = _both(case)
    assert n == 3 and best_a == 3


@pytest.mark.parametrize("concurrency", [1, 3])
def test_tuner_asha_stops_bad_trials_early(runtimes, concurrency):
    def case(t, _):
        def trainable(config):
            for i in range(32):
                t.report({"score": config["slope"] * (i + 1)})

        grid = _fit(t.Tuner(
            trainable,
            param_space={"slope": t.grid_search(
                [50.0, 20.0, 10.0, 0.05, 0.02, 0.01])},
            tune_config=t.TuneConfig(
                metric="score", mode="max",
                max_concurrent_trials=concurrency,
                scheduler=t.ASHAScheduler(metric="score", max_t=32,
                                          grace_period=2,
                                          reduction_factor=2))))
        iters = dict(_history(grid, "slope"))
        # What the reference test asserts, on each side.
        assert min(iters.values()) < 32 and iters[50.0] == 32
        return iters if concurrency == 1 else sorted(iters)

    _both(case)


@pytest.mark.parametrize("concurrency", [1, 3])
def test_tuner_asha_prefers_good(runtimes, concurrency):
    def case(t, _):
        def trainable(config):
            for i in range(16):
                t.report({"score": config["slope"] * (i + 1)})

        grid = _fit(t.Tuner(
            trainable,
            param_space={"slope": t.grid_search(
                [0.1, 0.2, 0.5, 1.0, 2.0, 5.0])},
            tune_config=t.TuneConfig(
                metric="score", mode="max",
                max_concurrent_trials=concurrency,
                scheduler=t.ASHAScheduler(metric="score", max_t=16,
                                          grace_period=2,
                                          reduction_factor=2))))
        best = grid.get_best_result().config["slope"]
        return (best, _history(grid, "slope") if concurrency == 1 else None)

    assert _both(case)[0] == 5.0


def test_tuner_trial_error_isolated(runtimes):
    def case(t, _):
        def trainable(config):
            if config["x"] == 1:
                raise RuntimeError("boom")
            return {"score": config["x"]}

        grid = _fit(t.Tuner(
            trainable, param_space={"x": t.grid_search([0, 1, 2])},
            tune_config=t.TuneConfig(metric="score", mode="max")))
        errs = [(r.config["x"], "RuntimeError" in r.error, "boom" in r.error)
                for r in grid if r.error]
        return errs, grid.get_best_result().config["x"]

    assert _both(case) == ([(1, True, True)], 2)


@pytest.mark.parametrize("concurrency", [1, 2])
def test_tuner_with_tpe_search_alg(runtimes, concurrency):
    def case(t, _):
        def objective(config):
            t.report(score=-(config["lr"] - 0.1) ** 2
                     - (config["width"] - 32) ** 2 / 1024.0)

        grid = _fit(t.Tuner(
            objective,
            param_space={"lr": t.uniform(0.0, 1.0),
                         "width": t.randint(8, 128)},
            tune_config=t.TuneConfig(
                metric="score", mode="max", num_samples=30,
                max_concurrent_trials=concurrency,
                search_alg=t.TPESearcher(metric="score", n_startup=8,
                                         seed=0))))
        best = grid.get_best_result()
        assert abs(best.config["lr"] - 0.1) < 0.25, best.config
        assert all(r.config for r in grid)
        if concurrency > 1:
            return len(grid)
        return [r.config for r in grid], best.config

    _both(case)


def test_tuner_basic_variant_searcher_expands_grid(runtimes):
    def case(t, _):
        def trainable(config):
            t.report(score=config["a"])

        grid = _fit(t.Tuner(
            trainable,
            param_space={"a": t.grid_search([1, 2, 3, 4])},
            tune_config=t.TuneConfig(
                metric="score", mode="max", num_samples=1,
                search_alg=t.BasicVariantGenerator(num_samples=1))))
        return sorted(r.config["a"] for r in grid if r.config)

    assert _both(case) == [1, 2, 3, 4]


@pytest.mark.parametrize("concurrency", [1, 4])
def test_tuner_hyperband_end_to_end(runtimes, concurrency):
    def case(t, _):
        def trainable(config):
            for step in range(8):
                t.report(score=config["a"] * (step + 1))

        grid = _fit(t.Tuner(
            trainable,
            param_space={"a": t.grid_search([1, 2, 3, 4])},
            tune_config=t.TuneConfig(
                metric="score", mode="max", num_samples=1,
                max_concurrent_trials=concurrency,
                scheduler=t.HyperBandScheduler(
                    metric="score", max_t=8, grace_period=1,
                    reduction_factor=2, brackets=2))))
        return (grid.get_best_result().config["a"],
                _history(grid, "a") if concurrency == 1 else None)

    assert _both(case)[0] == 4


def test_tuner_pbt_updates_configs(runtimes):
    """PBT's exploit rewrites a trial's config in the controller; with one
    trial at a time the rewrites are the same on both sides."""
    def case(t, _):
        def trainable(config):
            for step in range(6):
                t.report(score=config["lr"] * (step + 1))

        grid = _fit(t.Tuner(
            trainable,
            param_space={"lr": t.grid_search([2.0, 1.0, 0.5, 0.1])},
            tune_config=t.TuneConfig(
                metric="score", mode="max", max_concurrent_trials=1,
                scheduler=t.PopulationBasedTraining(
                    metric="score", perturbation_interval=2,
                    hyperparam_mutations={"lr": [0.3, 3.0]}, seed=2))))
        return [(r.trial_id, r.config, r.metrics_history) for r in grid]

    out = _both(case)
    assert [c["lr"] for _, c, _ in out] != [2.0, 1.0, 0.5, 0.1]


def test_tuner_checkpoint_and_keyword_reports(runtimes):
    def case(t, Checkpoint):
        def trainable(config):
            t.report(score=1.0)
            t.report({"score": 2.0 * config["a"]},
                     checkpoint=Checkpoint.from_dict({"a": config["a"]}))

        grid = _fit(t.Tuner(
            trainable, param_space={"a": t.grid_search([1, 2])},
            tune_config=t.TuneConfig(metric="score", mode="max")))
        best = grid.get_best_result()
        return ([r.metrics_history for r in grid], best.config,
                best.checkpoint.to_dict(), best.last_result)

    assert _both(case)[2] == {"a": 2}


# ---------------------------------------------- the flagship, tuned (f32)
FLAGSHIP = jm.TransformerConfig(vocab_size=64, d_model=64, n_layers=2,
                                n_heads=4, n_kv_heads=2, d_ff=96,
                                dtype=jnp.float32)
B, S, MAX_T = 2, 16, 4
LRS = [3e-3, 1e-3, 3e-4]
# As tests/test_torch_trainer.py's LOSS_RTOL (after tests/test_torch_train
# .py): the same f32 math in another summation order.
LOSS_RTOL = 1e-6


def test_flagship_tuned_through_both_tuners(runtimes):
    """ASHA over three learning rates, one trial at a time: the same
    trials are cut at the same rung, and every reported loss agrees."""
    import optax

    fields = {f.name: getattr(FLAGSHIP, f.name)
              for f in dataclasses.fields(FLAGSHIP)}
    tcfg = tt.TransformerConfig(**{**fields, "dtype": torch.float32})
    jp = jm.init_params(FLAGSHIP, jax.random.PRNGKey(0))
    jp_np = jax.tree_util.tree_map(np.asarray, jp)
    tokens = np.random.default_rng(9).integers(
        0, FLAGSHIP.vocab_size, (MAX_T * B, S + 1)).astype(np.int64)
    mesh = make_mesh(MeshConfig(dp=1), devices=jax.devices("cpu")[:1])

    def ref_trainable(config):
        opt = optax.adamw(config["lr"])
        step, pspec, _ = jt.make_spmd_train_step(FLAGSHIP, mesh, jp,
                                                 optimizer=opt)
        params = jt.shard_params_for_step(jp, mesh, pspec)
        opt_state = opt.init(params)
        for i in range(MAX_T):
            batch = jnp.asarray(tokens[i * B:(i + 1) * B])
            params, opt_state, loss = step(params, opt_state, batch[:, :-1],
                                           batch[:, 1:])
            jtune.report({"loss": float(loss)})

    def port_trainable(config):
        params = tm.params_from_jax(jp_np, tcfg, device="cpu")
        step = tm.make_train_step(tcfg, params, lr=config["lr"])
        for i in range(MAX_T):
            batch = torch.from_numpy(tokens[i * B:(i + 1) * B])
            ttune.report({"loss": step(batch[:, :-1], batch[:, 1:]).item()})

    out = {}
    for name, (t, _), trainable in (("ref", SIDES["ref"], ref_trainable),
                                    ("port", SIDES["port"], port_trainable)):
        grid = _fit(t.Tuner(
            trainable, param_space={"lr": t.grid_search(LRS)},
            tune_config=t.TuneConfig(
                metric="loss", mode="min", max_concurrent_trials=1,
                scheduler=t.ASHAScheduler(metric="loss", mode="min",
                                          max_t=MAX_T, grace_period=2,
                                          reduction_factor=2))))
        out[name] = ({r.config["lr"]: [m["loss"] for m in r.metrics_history]
                      for r in grid},
                     grid.get_best_result().config["lr"])
    ref, port = out["ref"], out["port"]
    assert port[1] == ref[1]
    assert {lr: len(v) for lr, v in port[0].items()} == {
        lr: len(v) for lr, v in ref[0].items()}
    assert min(len(v) for v in ref[0].values()) < MAX_T  # ASHA cut one
    for lr in LRS:
        np.testing.assert_allclose(port[0][lr], ref[0][lr], rtol=LOSS_RTOL)


def test_public_names_match_the_reference():
    assert sorted(ttune.__all__) == sorted(jtune.__all__)
    assert all(hasattr(ttune, n) for n in jtune.__all__)
