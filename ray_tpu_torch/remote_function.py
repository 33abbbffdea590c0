"""``remote`` for tasks and actors (counterpart of
``ray_tpu/remote_function.py``).

``@remote`` wraps a function into a ``RemoteFunction`` whose
``.remote(...)`` submits a task to the one-process runtime and returns
ObjectRef(s) (an ``ObjectRefGenerator`` with
``num_returns="streaming"``); ``.options(...)`` overrides per-call
options (num_returns, num_cpus, num_gpus, resources, max_retries,
retry_exceptions, name, scheduling_strategy, runtime_env: a
``RuntimeEnv`` or a plain dict, coerced at submit). On a class ``@remote``
gives an ``ActorClass``. A function can also be bound into a DAG
(``.bind()``) and compiled with ``experimental_compile(backend="torch")``;
``_function`` is the plain function the compiled executor runs.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch._private.config import GlobalConfig
from ray_tpu_torch._private.ids import ObjectID
from ray_tpu_torch._private.scheduler import TaskSpec
from ray_tpu_torch.runtime_env import coerce_runtime_env as _coerce_env

_OPTION_KEYS = frozenset({
    "num_returns", "num_cpus", "num_gpus", "resources", "max_retries",
    "retry_exceptions", "name", "scheduling_strategy", "runtime_env",
})


def _normalize_resources(opts: Dict[str, Any]) -> Dict[str, float]:
    resources = dict(opts.get("resources") or {})
    num_cpus = opts.get("num_cpus")
    resources["CPU"] = float(1 if num_cpus is None else num_cpus)
    if opts.get("num_gpus"):
        resources["GPU"] = float(opts["num_gpus"])
    return {k: v for k, v in resources.items() if v}


class RemoteFunction:
    def __init__(self, function: Callable,
                 options: Optional[Dict[str, Any]] = None):
        options = dict(options or {})
        for k in options:
            if k not in _OPTION_KEYS:
                raise ValueError(f"unknown @remote option {k!r}")
        self._function = function
        self._options = options
        functools.update_wrapper(self, function)

    def options(self, **options) -> "RemoteFunction":
        merged = dict(self._options)
        merged.update(options)
        return RemoteFunction(self._function, merged)

    def remote(self, *args, **kwargs):
        from ray_tpu_torch._private.streaming import stream_end_id
        from ray_tpu_torch._private.worker import (
            ObjectRefGenerator,
            auto_init,
        )

        worker = auto_init()
        opts = self._options
        num_returns = opts.get("num_returns", 1)
        streaming = num_returns == "streaming"
        if not streaming and not isinstance(num_returns, int):
            raise ValueError(
                f'num_returns must be an int or "streaming", '
                f'got {num_returns!r}')
        task_id = worker.next_task_id()
        if streaming:
            # Item refs materialize as the task yields; the one static
            # return is the END MARKER (total yield count / task error).
            return_ids = [stream_end_id(task_id)]
        else:
            # num_returns=0 still gets one hidden completion marker object
            # so dependents and ref release have something to hang off.
            return_ids = [
                ObjectID.for_task_return(task_id, i)
                for i in range(max(num_returns, 1))
            ]
        max_retries = opts.get("max_retries")
        if max_retries is None:
            max_retries = GlobalConfig.task_max_retries
        spec = TaskSpec(
            task_id=task_id,
            function=self._function,
            args=args,
            kwargs=kwargs,
            num_returns=1 if streaming else num_returns,
            return_ids=return_ids,
            name=opts.get("name") or getattr(
                self._function, "__name__", "task"),
            resources=_normalize_resources(opts),
            max_retries=max_retries,
            retry_exceptions=bool(opts.get("retry_exceptions", False)),
            scheduling_strategy=opts.get("scheduling_strategy"),
            runtime_env=_coerce_env(opts.get("runtime_env")),
            streaming=streaming,
            backpressure=(GlobalConfig.generator_backpressure_items
                          if streaming else 0),
        )
        if streaming:
            # The generator registers the stream before the task can run.
            gen = ObjectRefGenerator(task_id, worker)
            worker.submit_task(spec)
            return gen
        refs = worker.submit_task(spec)
        if num_returns == 0:
            return None
        return refs[0] if num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self.__name__!r} cannot be called directly; "
            f"use {self.__name__}.remote()."
        )

    def bind(self, *args, **kwargs):
        """DAG authoring: create a lazy FunctionNode (see ray_tpu_torch.dag)."""
        from ray_tpu_torch.dag.dag_node import FunctionNode

        return FunctionNode(self, args, kwargs)


def remote(*args, **options):
    """``@remote`` / ``@remote(num_cpus=...)`` for functions and classes."""
    from ray_tpu_torch.actor import ActorClass

    def _make(target):
        if isinstance(target, type):
            return ActorClass(target, options)
        if callable(target):
            return RemoteFunction(target, options)
        raise TypeError(f"@remote target must be function or class: {target}")

    if len(args) == 1 and not options and (
        callable(args[0]) or isinstance(args[0], type)
    ):
        return _make(args[0])
    if args:
        raise TypeError("@remote options must be keyword arguments")
    return _make


def method(**options):
    """``@method(num_returns=...)`` decorator for actor methods."""

    def _wrap(fn):
        fn.__ray_tpu_method_options__ = options
        return fn

    return _wrap
