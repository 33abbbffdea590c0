"""A bind-only ``remote`` decorator for authoring DAGs (counterpart of
``ray_tpu``'s ``@ray_tpu.remote`` on a function).

The port has no runtime yet (ROADMAP A.5): a decorated function can only
be bound into a DAG (``.bind()``) and compiled with
``experimental_compile(backend="torch")``; ``.remote()`` raises.
"""

from __future__ import annotations

import functools
from typing import Any, Callable


class RemoteFunction:
    """A function wrapped for DAG authoring: ``bind`` builds a
    ``FunctionNode``; ``_function`` is the plain function the compiled
    executor runs."""

    def __init__(self, function: Callable[..., Any]):
        self._function = function
        functools.update_wrapper(self, function)

    def bind(self, *args, **kwargs):
        from ray_tpu_torch.dag.dag_node import FunctionNode

        return FunctionNode(self, args, kwargs)

    def remote(self, *args, **kwargs):
        raise NotImplementedError(
            "ray_tpu_torch has no task runtime yet (ROADMAP A.5): bind the "
            "function into a DAG and compile it with "
            "experimental_compile(backend='torch')")


def remote(function: Callable[..., Any]) -> RemoteFunction:
    """Decorate a function for DAG authoring (``f.bind(...)``)."""
    return RemoteFunction(function)
