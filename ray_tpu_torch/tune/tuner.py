"""Tuner and trial controller (counterpart of ``ray_tpu/tune/tuner.py``).

Trials run as tasks on the one-process runtime, each in an executor
thread, which holds the trial's session (``_local.tune_session``).
Reports and stop decisions pass through the worker's internal KV under
``tune|<run>|rep|<trial>|<seq>`` keys, as in the reference. A trial's
``report()`` blocks until the controller acks its sequence number, so
the scheduler decides in step with the trials' progress: ASHA cuts a
trial at the report that reaches a rung, never a step later.
"""

from __future__ import annotations

import pickle
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private.log import get_logger
from ray_tpu_torch._private.worker import auto_init, global_worker
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.tune.schedulers import STOP, FIFOScheduler
from ray_tpu_torch.tune.search_space import generate_variants

log = get_logger(__name__)

_local = threading.local()


class _TrialStopped(Exception):
    pass


class _TuneSession:
    def __init__(self, run_id: str, trial_id: str):
        self.run_id = run_id
        self.trial_id = trial_id
        self.seq = 0


def _rep_key(run: str, tid: str, seq: int) -> bytes:
    return f"tune|{run}|rep|{tid}|{seq}".encode()


def _ack_key(run: str, tid: str) -> bytes:
    return f"tune|{run}|ack|{tid}".encode()


def _stop_key(run: str, tid: str) -> bytes:
    return f"tune|{run}|stop|{tid}".encode()


def report(metrics: Optional[Dict[str, Any]] = None,
           checkpoint: Optional[Checkpoint] = None, **kw) -> None:
    """Inside a trainable: stream metrics (a dict, or keywords as in
    ``tune.report(score=1.0)``). Blocks until the controller acks, then
    raises to unwind the trainable when the scheduler stopped the
    trial."""
    metrics = {**(dict(metrics) if metrics else {}), **kw}
    sess = getattr(_local, "tune_session", None)
    if sess is None:
        raise RuntimeError("tune.report() called outside a trial")
    w = auto_init()
    seq = sess.seq
    sess.seq = seq + 1
    w.kv_put(_rep_key(sess.run_id, sess.trial_id, seq),
             pickle.dumps((dict(metrics), checkpoint), protocol=5))
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        raw = w.kv_get(_ack_key(sess.run_id, sess.trial_id))
        if raw is not None and int(raw) > seq:
            break
        time.sleep(0.005)
    if w.kv_get(_stop_key(sess.run_id, sess.trial_id)) is not None:
        raise _TrialStopped()


def _trial_main(trainable, run_id: str, trial_id: str,
                config: Dict[str, Any]) -> str:
    """The trial's task body: the session lives in the executor thread
    that runs it, for the trial's length."""
    _local.tune_session = _TuneSession(run_id, trial_id)
    try:
        out = trainable(config)
        if isinstance(out, dict):
            try:
                report(out)
            except _TrialStopped:
                pass
        return "COMPLETED"
    except _TrialStopped:
        return "EARLY_STOPPED"
    finally:
        _local.tune_session = None


@dataclass
class TuneConfig:
    metric: str = "score"
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 4
    scheduler: Any = None
    # A Searcher (tune.search) suggests each trial's config when the
    # trial is submitted, informed by the trials completed so far. None
    # keeps the grid/random variant expansion.
    search_alg: Any = None
    seed: int = 0


@dataclass
class TrialResult:
    trial_id: str
    config: Dict[str, Any]
    metrics: Dict[str, Any] = field(default_factory=dict)
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[str] = None

    @property
    def last_result(self):
        return self.metrics


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric: str, mode: str):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __iter__(self):
        return iter(self._results)

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i):
        return self._results[i]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        scored = [r for r in self._results if metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        return (max if mode == "max" else min)(
            scored, key=lambda r: r.metrics[metric])

    def get_dataframe(self):
        """A pandas DataFrame of the trials (raises ImportError where
        pandas is not installed)."""
        import pandas as pd

        return pd.DataFrame([
            {"trial_id": r.trial_id, **r.config, **r.metrics}
            for r in self._results
        ])


class Tuner:
    def __init__(self, trainable: Callable[[Dict[str, Any]], Any], *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config=None):
        self._trainable = trainable
        self._param_space = param_space or {}
        self._tune_config = tune_config or TuneConfig()
        self._run_config = run_config

    def fit(self) -> ResultGrid:
        ray_tpu_torch.init(ignore_reinit_error=True)
        tc = self._tune_config
        scheduler = tc.scheduler or FIFOScheduler()
        search_alg = tc.search_alg
        if search_alg is not None:
            search_alg.set_search_space(self._param_space)
            # Configs are suggested lazily at submit time; ids are fixed
            # now. A searcher that expands the space itself (the grid)
            # gives its own trial count, so no variant is cut.
            n_trials = tc.num_samples
            if hasattr(search_alg, "total_trials"):
                n_trials = int(search_alg.total_trials(tc.num_samples))
            trials = {
                f"trial_{i:05d}": TrialResult(f"trial_{i:05d}", {})
                for i in range(n_trials)
            }
        else:
            variants = generate_variants(
                self._param_space, tc.num_samples, seed=tc.seed)
            trials = {
                f"trial_{i:05d}": TrialResult(f"trial_{i:05d}", cfg)
                for i, cfg in enumerate(variants)
            }
        if hasattr(scheduler, "register") and search_alg is None:
            for tid, tr in trials.items():
                scheduler.register(tid, tr.config)

        run_id = f"tune-{id(self)}-{time.monotonic_ns()}"
        trainable = self._trainable

        @ray_tpu_torch.remote
        def run_trial(trial_id, config):
            return _trial_main(trainable, run_id, trial_id, config)

        worker = global_worker()
        next_seq: Dict[str, int] = {tid: 0 for tid in trials}

        def _drain():
            """Consume the KV's reports in order, feed the scheduler,
            ack."""
            progressed = True
            while progressed:
                progressed = False
                for tid in trials:
                    raw = worker.kv_get(_rep_key(run_id, tid, next_seq[tid]))
                    if raw is None:
                        continue
                    worker.kv_del(_rep_key(run_id, tid, next_seq[tid]))
                    next_seq[tid] += 1
                    progressed = True
                    metrics, ckpt = pickle.loads(raw)
                    trials[tid].metrics = metrics
                    trials[tid].metrics_history.append(metrics)
                    if ckpt is not None:
                        trials[tid].checkpoint = ckpt
                    # A checkpoint-only report carries no metric: no
                    # decision (the schedulers index the metric).
                    if metrics and scheduler.on_result(
                            tid, metrics) == STOP:
                        worker.kv_put(_stop_key(run_id, tid), b"1")
                    if hasattr(scheduler, "maybe_exploit"):
                        new_cfg = scheduler.maybe_exploit(tid)
                        if new_cfg is not None:
                            trials[tid].config.update(new_cfg)
                    worker.kv_put(_ack_key(run_id, tid),
                                  str(next_seq[tid]).encode())

        pending = list(trials.items())
        running: Dict[Any, str] = {}
        final_status: Dict[str, str] = {}
        while pending or running:
            while pending and len(running) < tc.max_concurrent_trials:
                tid, trial = pending.pop(0)
                if search_alg is not None:
                    cfg = search_alg.suggest(tid)
                    if cfg is None:  # the searcher's space is exhausted
                        final_status[tid] = "SKIPPED"
                        continue
                    trial.config = dict(cfg)
                    if hasattr(scheduler, "register"):
                        scheduler.register(tid, trial.config)
                ref = run_trial.remote(tid, trial.config)
                running[ref] = tid
            _drain()
            done, _ = ray_tpu_torch.wait(
                list(running), num_returns=1, timeout=0.05)
            for ref in done:
                tid = running.pop(ref)
                try:
                    final_status[tid] = ray_tpu_torch.get(ref)
                except Exception as exc:  # noqa: BLE001 — trial failure
                    trials[tid].error = repr(exc)
                    final_status[tid] = "ERRORED"
                if search_alg is not None:
                    try:
                        search_alg.on_trial_complete(
                            tid, trials[tid].metrics)
                    except Exception as exc:  # noqa: BLE001 — searcher bug
                        log.warning("search algorithm failed on trial "
                                    "%s completion: %r", tid, exc)
        _drain()  # reports that raced with completion
        for key in worker.kv_keys(f"tune|{run_id}|".encode()):
            worker.kv_del(key)
        return ResultGrid(list(trials.values()), tc.metric, tc.mode)
