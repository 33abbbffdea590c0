"""Workflow executor (counterpart of ``ray_tpu/workflow/executor.py``):
drives a step DAG as tasks on the runtime, committing each step exactly
once.

Execution walks the DAG in a deterministic topological order. The
journal is read first for each step: a committed step never runs
again, and its stored output stands in, loaded only when a step that
runs consumes it. A step that has not committed runs as an ordinary
task, its upstream values passed as ObjectRefs, and its result commits
before any dependent runs.

Failure policy is per step: ``max_retries`` re-executions, filtered by
``retry_exceptions``, with an exponential ``backoff_s`` capped at 30 s;
then either ``catch_exceptions`` (the committed output becomes a
``(result, error)`` pair) or the workflow fails.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import ray_tpu_torch
from ray_tpu_torch._private import tracing
from ray_tpu_torch._private.worker import ObjectRef
from ray_tpu_torch.dag.dag_node import DAGNode, InputNode, MultiOutputNode
from ray_tpu_torch.remote_function import RemoteFunction
from ray_tpu_torch.workflow.api import StepNode
from ray_tpu_torch.workflow.storage import (
    FAILED,
    SUCCESS,
    WorkflowStorage,
)

_BACKOFF_CAP_S = 30.0


def step_ids_for(dag: DAGNode) -> List[Tuple[str, DAGNode]]:
    """Deterministic ``(step_id, node)`` pairs: the node's position in
    the DAG's topological order and its step name. The walk is a fixed
    structural one and the DAG is persisted at the first run, so a
    resume in a fresh process assigns the same ids."""
    out = []
    for idx, node in enumerate(dag.topological_order()):
        if isinstance(node, InputNode):
            raise TypeError(
                "workflows are self-contained: InputNode is not allowed "
                "in a workflow DAG — bind concrete arguments instead")
        if isinstance(node, StepNode):
            out.append((f"{idx:04d}_{node.step_name}", node))
        elif isinstance(node, MultiOutputNode):
            out.append((f"{idx:04d}_multi_output", node))
        else:
            raise TypeError(
                f"workflow DAGs are built from @workflow.step functions; "
                f"got {type(node).__name__} — wrap the function with "
                f"@workflow.step")
    return out


class _Committed:
    """Lazy stand-in for a committed step's stored output."""

    __slots__ = ("step_id",)

    def __init__(self, step_id: str):
        self.step_id = step_id


class WorkflowExecutor:
    def __init__(self, storage: WorkflowStorage, workflow_id: str):
        self.storage = storage
        self.workflow_id = workflow_id
        self.steps_executed = 0
        self.steps_skipped = 0

    # ------------------------------------------------------------ helpers
    def _materialize(self, cache: Dict[int, Any], node: DAGNode):
        """An upstream entry as a task argument: a committed stand-in
        loads from storage when first needed and is put into the object
        store once."""
        val = cache[id(node)]
        if isinstance(val, _Committed):
            val = ray_tpu_torch.put(self.storage.load_step_output(
                self.workflow_id, val.step_id))
            cache[id(node)] = val
        return val

    def _resolve_args(self, cache: Dict[int, Any], node: DAGNode):
        args = tuple(
            self._materialize(cache, a) if isinstance(a, DAGNode) else a
            for a in node._bound_args)
        kwargs = {
            k: self._materialize(cache, v) if isinstance(v, DAGNode) else v
            for k, v in node._bound_kwargs.items()}
        return args, kwargs

    @staticmethod
    def _retryable(exc: BaseException, retry_exceptions) -> bool:
        if retry_exceptions is True:
            return isinstance(exc, Exception)
        if not retry_exceptions:
            return False
        return isinstance(exc, tuple(retry_exceptions) if isinstance(
            retry_exceptions, (list, tuple)) else retry_exceptions)

    def _run_step(self, step_id: str, node: StepNode,
                  cache: Dict[int, Any]) -> Any:
        """Run one step as a task under its retry, backoff and catch
        policy; returns the value to commit."""
        opts = node._step_options
        task_opts: Dict[str, Any] = {
            "name": f"workflow:{self.workflow_id}:{step_id}",
            # The executor owns retries (attempts counted in the marker,
            # the backoff); the scheduler must not retry underneath.
            "max_retries": 0,
        }
        for k in ("num_cpus", "num_gpus", "resources"):
            if opts.get(k) is not None:
                task_opts[k] = opts[k]
        if opts.get("num_tpus"):
            task_opts["resources"] = {**(opts.get("resources") or {}),
                                      "TPU": opts["num_tpus"]}
        fn = RemoteFunction(node._fn, task_opts)
        args, kwargs = self._resolve_args(cache, node)
        max_retries = int(opts.get("max_retries", 0) or 0)
        retry_exceptions = opts.get("retry_exceptions", True)
        backoff_s = float(opts.get("backoff_s", 0.1) or 0.0)
        attempts = 0
        while True:
            attempts += 1
            try:
                # One span per attempt; the task inherits it as its
                # ambient context.
                with tracing.start_span(
                        "workflow.step", workflow=self.workflow_id,
                        step=step_id, attempt=attempts):
                    value = ray_tpu_torch.get(fn.remote(*args, **kwargs))
                self._last_attempts = attempts
                if opts.get("catch_exceptions"):
                    return (value, None)
                return value
            except Exception as exc:  # noqa: BLE001 — the step's boundary
                if attempts <= max_retries and \
                        self._retryable(exc, retry_exceptions):
                    if backoff_s > 0:
                        time.sleep(min(
                            backoff_s * (2 ** (attempts - 1)),
                            _BACKOFF_CAP_S))
                    continue
                self._last_attempts = attempts
                if opts.get("catch_exceptions"):
                    # Commit the original exception, not the task-error
                    # wrapper: the wrapper's derived type does not
                    # pickle, the cause does.
                    cause = getattr(exc, "cause", None)
                    return (None, cause if isinstance(
                        cause, BaseException) else exc)
                raise

    # ------------------------------------------------------------ execute
    def execute(self, dag: DAGNode) -> Any:
        assigned = step_ids_for(dag)
        cache: Dict[int, Any] = {}
        try:
            for step_id, node in assigned:
                if self.storage.step_commit_record(
                        self.workflow_id, step_id) is not None:
                    cache[id(node)] = _Committed(step_id)
                    self.steps_skipped += 1
                    continue
                t0 = time.monotonic()
                if isinstance(node, MultiOutputNode):
                    value = [
                        self._value_of(cache, a)
                        for a in node._bound_args]
                    self._last_attempts = 1
                else:
                    value = self._run_step(step_id, node, cache)
                won, marker = self.storage.commit_step(
                    self.workflow_id, step_id, value, meta={
                        "attempts": self._last_attempts,
                        "duration_s": round(time.monotonic() - t0, 6),
                        "name": getattr(node, "step_name",
                                        "multi_output"),
                    })
                if won:
                    cache[id(node)] = ray_tpu_torch.put(value)
                else:
                    # A racing resume committed first: its output is the
                    # step's (exactly once).
                    cache[id(node)] = _Committed(step_id)
                self.steps_executed += 1
        except Exception as exc:
            self.storage.set_status(self.workflow_id, FAILED,
                                    error=repr(exc))
            raise
        final = self._value_of(cache, dag)
        self.storage.save_result(self.workflow_id, final)
        self.storage.set_status(self.workflow_id, SUCCESS)
        return final

    def _value_of(self, cache: Dict[int, Any], node: DAGNode) -> Any:
        """A node's value: a committed output loaded, a live ref
        resolved."""
        val = cache[id(node)]
        if isinstance(val, _Committed):
            return self.storage.load_step_output(
                self.workflow_id, val.step_id)
        if isinstance(val, ObjectRef):
            return ray_tpu_torch.get(val)
        return val
