"""DataParallelTrainer: worker-group training with failure recovery
(counterpart of ``ray_tpu/train/trainer.py``, whose ``JaxTrainer`` the
reference also exports as ``DataParallelTrainer``).

N worker actors of the one-process runtime run ``train_loop_per_worker``;
each gets a session (rank, world size, dataset shards), joins an
actor-plane collective group, streams ``report()`` metrics, and the
trainer restarts the whole group from the latest checkpoint up to
``FailureConfig.max_failures`` times. Reported checkpoints persist to
``RunConfig.storage_path`` (a local directory or a storage URI), and
``restore(path)`` resumes a run from its latest stored checkpoint.

Workers are threads of the process that owns the card; a loop places its
own tensors. Each worker runs its loop with autograd's multithreading off,
so a backward pass, its gradient hooks and their collective run on the
worker's own thread: the collective tells ranks apart by thread, and
ranks on one card would otherwise share the device's one autograd thread,
where one rank's blocking rendezvous would stall the other's backward.
"""

from __future__ import annotations

import os
import pickle
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

import ray_tpu_torch as rt
from ray_tpu_torch._private.log import get_logger
from ray_tpu_torch._private.serialization import dumps_by_value
from ray_tpu_torch._private.worker import global_worker
from ray_tpu_torch.collective import collective
from ray_tpu_torch.data.filesystem import resolve_filesystem
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.session import (
    TrainContext,
    _group_name,
    _report_key,
    _set_context,
)
from ray_tpu_torch.train.storage import CheckpointStore

log = get_logger(__name__)


class TrainingFailedError(RuntimeError):
    pass


@dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    error: Optional[BaseException] = None
    path: Optional[str] = None


class DataParallelTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable[..., None],
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        self._loop = train_loop_per_worker
        self._loop_config = train_loop_config or {}
        self._scaling = scaling_config or ScalingConfig()
        self._run_config = run_config or RunConfig()
        self._datasets = datasets or {}
        self._restore_from: Optional[Checkpoint] = None
        self._ckpt_store: Optional[CheckpointStore] = None  # lazy

    # ------------------------------------------------------------------ fit
    def fit(self) -> Result:
        rt.init(ignore_reinit_error=True)
        self._save_trainer_state()
        failures_allowed = self._run_config.failure_config.max_failures
        latest_ckpt: Optional[Checkpoint] = self._restore_from
        history: List[Dict[str, Any]] = []
        attempt = 0
        result = None
        while result is None:
            try:
                metrics, ckpt, hist = self._run_attempt(latest_ckpt)
                history.extend(hist)
                result = Result(metrics=metrics, checkpoint=ckpt,
                                metrics_history=history,
                                path=self._storage_dir())
            except Exception as exc:  # noqa: BLE001 — group failure boundary
                attempt += 1
                # Carry forward any checkpoint reported before the failure.
                latest_ckpt = getattr(exc, "_latest_checkpoint",
                                      latest_ckpt)
                if attempt > failures_allowed:
                    raise TrainingFailedError(
                        f"training failed after {attempt - 1} restart(s): "
                        f"{exc!r}") from exc
        if self._ckpt_store is not None:
            store, self._ckpt_store = self._ckpt_store, None
            # Drain the background uploads before declaring the run
            # complete (async_save keeps them off the step loop). An upload
            # error is IO, not training: the local checkpoint stays valid,
            # so it is logged and the run stands (as in the reference).
            try:
                store.wait(timeout=120)
            except Exception as exc:  # noqa: BLE001
                log.warning("checkpoint upload failed: %r", exc)
            # Retention runs AFTER uploads land so async_save honours
            # num_to_keep too (per-persist pruning covers the sync path).
            keep = self._run_config.checkpoint_config.num_to_keep
            if keep:
                try:
                    for stale in store.list_checkpoints()[:-keep]:
                        store.delete(stale)
                except Exception as exc:  # noqa: BLE001 — best effort
                    log.warning("checkpoint retention failed: %r", exc)
            store.close()
        # Callbacks close OUTSIDE the retry boundary: a logger bug must
        # not discard a completed training run (per-record on_result
        # already streamed live from _run_attempt's drain loop).
        for cb in self._run_config.callbacks:
            try:
                cb.on_end(result)
            except Exception as exc:  # noqa: BLE001 — logger bug
                log.warning("train callback %r failed at the end: %r",
                            cb, exc)
        return result

    def _storage_dir(self) -> Optional[str]:
        rc = self._run_config
        if rc.storage_path is None:
            return None
        if "://" in rc.storage_path:  # remote storage URI
            return f"{rc.storage_path.rstrip('/')}/{rc.name or 'train_run'}"
        d = os.path.join(rc.storage_path, rc.name or "train_run")
        os.makedirs(d, exist_ok=True)
        return d

    def _store(self) -> Optional[CheckpointStore]:
        """Lazy CheckpointStore over the run's storage root (local dir
        or remote URI)."""
        if self._ckpt_store is None:
            root = self._storage_dir()
            if root is None:
                return None
            self._ckpt_store = CheckpointStore(root)
        return self._ckpt_store

    def _save_trainer_state(self):
        """Persist enough to rebuild this trainer (loop and configs) so
        ``restore(uri)`` works from storage alone (``trainer.pkl`` in the
        run directory). ``cloudpickle`` where it imports, as the
        reference pickles it, so a loop that is a closure is stored by
        value; else stdlib pickle, where a loop pickles by its import path
        and a loop that will not pickle leaves no state."""
        root = self._storage_dir()
        if root is None:
            return
        try:
            # Dump INSIDE the guard: an unpicklable loop must not fail
            # fit(); restore() then requires an explicit loop argument.
            state = dumps_by_value({
                "loop": self._loop,
                "loop_config": self._loop_config,
                "scaling": self._scaling,
                "run_config": self._run_config,
            })
            fs, p = resolve_filesystem(root)
            fs.makedirs(p)
            with fs.open(p.rstrip("/") + "/trainer.pkl", "wb") as f:
                f.write(state)
        except Exception:  # noqa: BLE001 — unpicklable loop / fs error
            pass

    # -------------------------------------------------------------- attempt
    def _run_attempt(self, restore_from: Optional[Checkpoint]):
        n = self._scaling.total_workers
        run_id = f"run-{id(self)}-{time.monotonic_ns()}"
        group_name = _group_name(run_id)

        # Shard datasets per worker (Dataset.split) once per attempt.
        shards_per_worker: List[Dict[str, Any]] = [dict() for _ in range(n)]
        for name, ds in self._datasets.items():
            if hasattr(ds, "split"):
                for rank, shard in enumerate(ds.split(n)):
                    shards_per_worker[rank][name] = shard
            else:
                for rank in range(n):
                    shards_per_worker[rank][name] = ds

        loop = self._loop
        loop_config = self._loop_config
        trial_name = self._run_config.name or "train"

        @rt.remote
        class TrainWorker:
            def run(self, rank):
                collective.init_collective_group(
                    n, rank, group_name=group_name)
                ctx = TrainContext(
                    world_rank=rank, world_size=n, run_id=run_id,
                    dataset_shards=shards_per_worker[rank],
                    latest_checkpoint=restore_from, trial_name=trial_name)
                _set_context(ctx)
                try:
                    with torch.autograd.set_multithreading_enabled(False):
                        if loop_config:
                            loop(loop_config)
                        else:
                            loop()
                finally:
                    _set_context(None)
                return rank

        # resources_per_worker and SPREAD are accepted and reserve nothing
        # on the one-process runtime, as actors of the reference's process.
        worker_opts: Dict[str, Any] = {"scheduling_strategy": "SPREAD"}
        if self._scaling.resources_per_worker:
            worker_opts["resources"] = dict(
                self._scaling.resources_per_worker)
        workers = [TrainWorker.options(**worker_opts).remote()
                   for _ in range(n)]
        run_refs = [w.run.remote(i) for i, w in enumerate(workers)]

        # Drain rank-0 reports from the KV channel while the group runs
        # (the trainer's result stream follows the rank-0 worker; other
        # ranks' reports are synchronization only).
        worker = global_worker()
        next_seq = [0] * n
        history: List[Dict[str, Any]] = []
        latest_metrics: Dict[str, Any] = {}
        latest_ckpt = restore_from

        def _drain():
            nonlocal latest_metrics, latest_ckpt
            for rank in range(n):
                while True:
                    raw = worker.kv_get(
                        _report_key(run_id, rank, next_seq[rank]))
                    if raw is None:
                        break
                    worker.kv_del(
                        _report_key(run_id, rank, next_seq[rank]))
                    next_seq[rank] += 1
                    if rank != 0:
                        continue  # non-rank-0 reports: consumed, discarded
                    metrics, ckpt = pickle.loads(raw)
                    history.append(metrics)
                    latest_metrics = metrics
                    for cb in self._run_config.callbacks:
                        try:  # live stream; a logger bug must not fail
                            cb.on_result(metrics)  # the training group
                        except Exception as exc:  # noqa: BLE001
                            log.warning("train callback %r failed on a "
                                        "result: %r", cb, exc)
                    if ckpt is not None:
                        latest_ckpt = self._persist(ckpt)

        pending = list(run_refs)
        try:
            while pending:
                _drain()
                done, pending = rt.wait(
                    pending, num_returns=len(pending), timeout=0.05)
                if done:
                    rt.get(done)  # surface worker errors
        except Exception as exc:
            _drain()  # reports that raced with the failure carry the
            # checkpoint the restart must resume from
            exc._latest_checkpoint = latest_ckpt
            raise
        finally:
            _drain()  # reports that raced with completion
            collective.destroy_collective_group(group_name)
            for key in worker.kv_keys(f"train|{run_id}|".encode()):
                worker.kv_del(key)
            for w_handle in workers:
                rt.kill(w_handle)
        return latest_metrics, latest_ckpt, history

    def _persist(self, ckpt: Checkpoint) -> Checkpoint:
        store = self._store()
        if store is None:
            return ckpt
        # Wall-clock, zero-padded: lexicographic order == creation order
        # even across process restarts.
        name = f"checkpoint_{time.time_ns():020d}"
        cc = self._run_config.checkpoint_config
        if cc.async_save:
            # Upload off the drain loop; the LOCAL checkpoint, which the
            # worker wrote whole before reporting it, stays authoritative
            # for restarts until the upload lands.
            store.persist_async(ckpt, name)
            out = ckpt
        else:
            dest = store.persist(ckpt, name)
            out = Checkpoint(dest) if not store.remote else ckpt
        keep = cc.num_to_keep
        if keep and not cc.async_save:
            for stale in store.list_checkpoints()[:-keep]:
                store.delete(stale)
        return out

    @classmethod
    def restore(cls, path: str, train_loop_per_worker=None,
                **overrides) -> "DataParallelTrainer":
        """Rebuild a trainer from its storage root (local dir or URI):
        the persisted trainer state supplies loop and configs (explicit
        arguments override), and training resumes from the LATEST stored
        checkpoint."""
        state = {}
        try:
            fs, p = resolve_filesystem(path)
            with fs.open(p.rstrip("/") + "/trainer.pkl", "rb") as f:
                state = pickle.loads(f.read())
        except Exception:  # noqa: BLE001 — no persisted state
            if train_loop_per_worker is None:
                raise ValueError(
                    f"no trainer state at {path!r}; pass "
                    f"train_loop_per_worker explicitly") from None
        run_config = overrides.pop("run_config", None) \
            or state.get("run_config")
        if run_config is None:
            # No persisted state: derive storage from the restore path
            # itself so the resumed run KEEPS persisting checkpoints to
            # the root it was restored from.
            clean = path.rstrip("/")
            if "://" in clean:
                root, _, name = clean.rpartition("/")
            else:
                root, name = os.path.split(clean)
            run_config = RunConfig(name=name or None,
                                   storage_path=root or None)
        trainer = cls(
            train_loop_per_worker or state.get("loop"),
            train_loop_config=overrides.pop(
                "train_loop_config", state.get("loop_config")),
            scaling_config=overrides.pop(
                "scaling_config", state.get("scaling")),
            run_config=run_config,
            **overrides,
        )
        # The storage root IS `path`; resume from its latest checkpoint.
        store = CheckpointStore(path)
        try:
            trainer._restore_from = store.latest()
        finally:
            store.close()
        return trainer
