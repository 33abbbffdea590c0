"""Durable workflow API (counterpart of ``ray_tpu/workflow/api.py``):
``@workflow.step``, ``run``/``run_async``/``resume``/``resume_all`` and
introspection.

``@workflow.step`` wraps a function so that ``.bind()`` (alias
``.step()``) builds a lazy DAG node, as ``ray_tpu_torch.dag`` does, with
per-step durability options. ``run(dag, workflow_id=...)`` persists the
DAG, then executes it step by step as tasks on the runtime, committing
each step's output to a ``WorkflowStorage`` before its dependents run.
``resume(workflow_id)`` replays the journal of a workflow whose driver
died: committed steps load from storage, only the rest runs.
"""

from __future__ import annotations

import functools
import importlib
import os
import pickle
import sys
import threading
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from ray_tpu_torch.dag.dag_node import DAGNode
from ray_tpu_torch.workflow.storage import (
    FAILED,
    RUNNING,
    SUCCESS,
    WorkflowStorage,
)

_STEP_OPTION_KEYS = frozenset({
    "name", "max_retries", "retry_exceptions", "backoff_s",
    "catch_exceptions", "num_cpus", "num_tpus", "num_gpus", "resources",
})

_global_storage: Optional[WorkflowStorage] = None
_storage_lock = threading.Lock()


def init(storage: Optional[Union[str, WorkflowStorage]] = None) -> None:
    """Set the process-global workflow storage root (a local directory
    or a ``scheme://`` URI). The first run or resume that names none
    sets the default root."""
    global _global_storage
    with _storage_lock:
        if storage is None or isinstance(storage, str):
            _global_storage = WorkflowStorage(storage or _default_root())
        else:
            _global_storage = storage


def _default_root() -> str:
    from ray_tpu_torch._private.config import GlobalConfig

    return GlobalConfig.workflow_storage or os.path.join(
        os.path.expanduser("~"), ".ray_tpu_torch", "workflows")


def _ensure_storage(
        storage: Optional[Union[str, WorkflowStorage]]) -> WorkflowStorage:
    if isinstance(storage, WorkflowStorage):
        return storage
    if isinstance(storage, str):
        return WorkflowStorage(storage)
    with _storage_lock:
        global _global_storage
        if _global_storage is None:
            _global_storage = WorkflowStorage(_default_root())
        return _global_storage


class _StepFnRef:
    """A module-level ``@workflow.step`` function as pickle stores it: the
    module attribute of its name holds the wrapper, so pickle's lookup by
    name would refuse the function itself; the wrapper is found again by
    name and unwrapped at load."""

    def __init__(self, module: str, qualname: str):
        self.module = module
        self.qualname = qualname

    def resolve(self) -> Callable:
        obj = importlib.import_module(self.module)
        for part in self.qualname.split("."):
            obj = getattr(obj, part)
        return obj._fn


def _fn_state(fn: Callable):
    """``fn`` as a StepNode pickles it: a ``_StepFnRef`` when its name
    leads to the ``@workflow.step`` wrapper of it, else ``fn`` itself
    (stdlib pickle stores a module-level function by name and refuses a
    local one)."""
    obj = sys.modules.get(getattr(fn, "__module__", None) or "")
    for part in getattr(fn, "__qualname__", "").split("."):
        obj = getattr(obj, part, None)
    if isinstance(obj, WorkflowStepFunction) and obj._fn is fn:
        return _StepFnRef(fn.__module__, fn.__qualname__)
    return fn


class StepNode(DAGNode):
    """A bound workflow step: a plain function and its durability
    options. Not a FunctionNode: the executor submits it itself, after
    checking the journal, and the node pickles (the DAG is persisted at
    ``run``) with the raw function, not a live RemoteFunction."""

    def __init__(self, fn: Callable, options: Dict[str, Any],
                 args: Tuple, kwargs: Dict[str, Any]):
        super().__init__(args, kwargs)
        self._fn = fn
        self._step_options = dict(options)

    @property
    def step_name(self) -> str:
        return self._step_options.get("name") or getattr(
            self._fn, "__name__", "step")

    def __getstate__(self):
        return dict(self.__dict__, _fn=_fn_state(self._fn))

    def __setstate__(self, state):
        fn = state["_fn"]
        state["_fn"] = fn.resolve() if isinstance(fn, _StepFnRef) else fn
        self.__dict__.update(state)

    def _fn_pickles(self) -> bool:
        """Whether pickle can store this step's function."""
        try:
            pickle.dumps(_fn_state(self._fn), protocol=5)
        except Exception:  # noqa: BLE001 — pickle's refusals vary in type
            return False
        return True

    def _execute_one(self, cache, input_values):
        raise TypeError(
            "StepNode cannot execute outside a workflow; use "
            "workflow.run(dag, workflow_id=...)")


class WorkflowStepFunction:
    """The ``@workflow.step`` wrapper: ``.bind()`` builds DAG nodes,
    ``.options()`` layers per-step options."""

    def __init__(self, fn: Callable, options: Dict[str, Any]):
        for k in options:
            if k not in _STEP_OPTION_KEYS:
                raise ValueError(f"unknown @workflow.step option {k!r}")
        self._fn = fn
        self._options = options
        functools.update_wrapper(self, fn)

    def options(self, **options) -> "WorkflowStepFunction":
        merged = dict(self._options)
        merged.update(options)
        return WorkflowStepFunction(self._fn, merged)

    def bind(self, *args, **kwargs) -> StepNode:
        return StepNode(self._fn, self._options, args, kwargs)

    # The classic spelling: ``f.step(...)`` is ``f.bind(...)``.
    step = bind

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"workflow step {self.__name__!r} cannot be called directly; "
            f"use {self.__name__}.bind() inside a workflow DAG.")


def step(fn: Optional[Callable] = None, **options):
    """``@workflow.step`` / ``@workflow.step(max_retries=3, ...)``.

    Options: ``name``, ``max_retries`` (re-executions on failure),
    ``retry_exceptions`` (True or a tuple of exception types),
    ``backoff_s`` (the base of the exponential retry backoff, capped at
    30 s), ``catch_exceptions`` (the step's output becomes ``(result,
    None)`` or ``(None, exception)``), and task resources (``num_cpus``,
    ``num_gpus``, ``num_tpus``, ``resources``).
    """
    if fn is not None:
        if not callable(fn):
            raise TypeError(f"@workflow.step target must be callable: {fn}")
        return WorkflowStepFunction(fn, options)

    def _wrap(f):
        return WorkflowStepFunction(f, options)

    return _wrap


# ------------------------------------------------------------------ verbs
def run(dag: DAGNode, *, workflow_id: Optional[str] = None,
        storage: Optional[Union[str, WorkflowStorage]] = None) -> Any:
    """Execute a step DAG durably; returns the final step's output.

    Running a completed ``workflow_id`` again returns the stored result
    and executes nothing; running an interrupted one resumes it.
    """
    from ray_tpu_torch.workflow.executor import WorkflowExecutor

    store = _ensure_storage(storage)
    workflow_id = workflow_id or f"workflow-{uuid.uuid4().hex[:12]}"
    rec = store.get_status(workflow_id)
    if rec is not None and rec.get("status") == SUCCESS \
            and store.has_result(workflow_id):
        return store.load_result(workflow_id)
    if not isinstance(dag, DAGNode):
        raise TypeError(
            f"workflow.run expects a DAG of workflow steps, got {dag!r}")
    # The DAG first: resume() rebuilds the plan from storage alone.
    store.save_dag(workflow_id, dag)
    store.set_status(workflow_id, RUNNING)
    return WorkflowExecutor(store, workflow_id).execute(dag)


def run_async(dag: DAGNode, *, workflow_id: Optional[str] = None,
              storage: Optional[Union[str, WorkflowStorage]] = None):
    """``run`` on a thread of its own; returns a
    ``concurrent.futures.Future`` of the final output."""
    import concurrent.futures

    workflow_id = workflow_id or f"workflow-{uuid.uuid4().hex[:12]}"
    pool = concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix=f"workflow-{workflow_id[:8]}")
    fut = pool.submit(run, dag, workflow_id=workflow_id, storage=storage)
    pool.shutdown(wait=False)
    return fut


def resume(workflow_id: str,
           storage: Optional[Union[str, WorkflowStorage]] = None) -> Any:
    """Resume an interrupted workflow from its journal: the persisted DAG
    is replayed, committed steps load from storage (never re-execute),
    and only the rest runs."""
    from ray_tpu_torch.workflow.executor import WorkflowExecutor

    store = _ensure_storage(storage)
    rec = store.get_status(workflow_id)
    if rec is None:
        raise ValueError(
            f"no workflow {workflow_id!r} under {store.root!r}")
    if rec.get("status") == SUCCESS and store.has_result(workflow_id):
        return store.load_result(workflow_id)
    dag = store.load_dag(workflow_id)
    store.set_status(workflow_id, RUNNING)
    return WorkflowExecutor(store, workflow_id).execute(dag)


def resume_all(storage: Optional[Union[str, WorkflowStorage]] = None,
               include_failed: bool = False) -> Dict[str, Any]:
    """Resume every interrupted workflow (status RUNNING: its driver
    died) under the root. Returns ``{workflow_id: result}``; a workflow
    that fails again gives its exception instead."""
    store = _ensure_storage(storage)
    results: Dict[str, Any] = {}
    wanted = {RUNNING} | ({FAILED} if include_failed else set())
    for rec in store.list_workflows():
        if rec.get("status") not in wanted:
            continue
        wid = rec["workflow_id"]
        try:
            results[wid] = resume(wid, storage=store)
        except Exception as exc:  # noqa: BLE001 — the sweep goes on
            results[wid] = exc
    return results


# -------------------------------------------------------- introspection
def get_status(workflow_id: str,
               storage: Optional[Union[str, WorkflowStorage]] = None
               ) -> Optional[str]:
    rec = _ensure_storage(storage).get_status(workflow_id)
    return rec.get("status") if rec else None


def get_metadata(workflow_id: str,
                 storage: Optional[Union[str, WorkflowStorage]] = None
                 ) -> dict:
    """The status record with each step's commit marker (attempts,
    duration, token)."""
    from ray_tpu_torch.workflow.executor import step_ids_for

    store = _ensure_storage(storage)
    rec = store.get_status(workflow_id)
    if rec is None:
        raise ValueError(
            f"no workflow {workflow_id!r} under {store.root!r}")
    steps = {}
    try:
        dag = store.load_dag(workflow_id)
        for sid, _node in step_ids_for(dag):
            steps[sid] = store.step_commit_record(workflow_id, sid)
    except ValueError:
        pass  # no DAG at hand: the status record alone
    return dict(rec, steps=steps)


def get_output(workflow_id: str,
               storage: Optional[Union[str, WorkflowStorage]] = None
               ) -> Any:
    """The stored final output of a completed workflow."""
    store = _ensure_storage(storage)
    if store.has_result(workflow_id):
        return store.load_result(workflow_id)
    rec = store.get_status(workflow_id)
    if rec is None:
        raise ValueError(
            f"no workflow {workflow_id!r} under {store.root!r}")
    raise RuntimeError(
        f"workflow {workflow_id!r} has no stored output (status "
        f"{rec.get('status')!r}); resume() it to completion first")


def list_all(status_filter: Optional[str] = None,
             storage: Optional[Union[str, WorkflowStorage]] = None
             ) -> List[Tuple[str, str]]:
    """``[(workflow_id, status)]`` for every workflow under the root."""
    out = []
    for rec in _ensure_storage(storage).list_workflows():
        st = rec.get("status", RUNNING)
        if status_filter is None or st == status_filter:
            out.append((rec["workflow_id"], st))
    return out


def delete(workflow_id: str,
           storage: Optional[Union[str, WorkflowStorage]] = None) -> None:
    _ensure_storage(storage).delete_workflow(workflow_id)


__all__ = [
    "FAILED", "RUNNING", "SUCCESS", "StepNode", "WorkflowStepFunction",
    "delete", "get_metadata", "get_output", "get_status", "init",
    "list_all", "resume", "resume_all", "run", "run_async", "step",
]
