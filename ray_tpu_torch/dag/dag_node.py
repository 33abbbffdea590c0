"""Lazy DAG authoring: ``bind()`` graphs of tasks (counterpart of
``ray_tpu/dag/dag_node.py``, copied and trimmed).

A DAG is built by ``.bind()`` calls on ``ray_tpu_torch.remote`` functions
and compiled with ``experimental_compile(backend="torch")`` to the wave
executor of ``dag/torch_executor.py``. What needs a task runtime and
channels (ROADMAP A.5) is not ported: the interpreted ``execute``, the
actor-loop backend (``backend="actor"``) and the actor nodes
(``ClassNode``, ``ClassMethodNode``) raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

_NEEDS_RUNTIME = ("needs the task runtime and channels, not ported yet "
                  "(ROADMAP A.5); compile with "
                  "experimental_compile(backend='torch')")


class DAGNode:
    """Base: a lazy computation with upstream dependencies."""

    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs

    def _upstream(self) -> List["DAGNode"]:
        deps = [a for a in self._bound_args if isinstance(a, DAGNode)]
        deps += [
            v for v in self._bound_kwargs.values() if isinstance(v, DAGNode)
        ]
        return deps

    def topological_order(self) -> List["DAGNode"]:
        """All transitive nodes, dependencies before dependents.

        Iterative DFS — compiled chains can be thousands of nodes deep.
        """
        order: List[DAGNode] = []
        seen = set()
        stack: List[Tuple[DAGNode, bool]] = [(self, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for dep in reversed(node._upstream()):
                if id(dep) not in seen:
                    stack.append((dep, False))
        return order

    def execute(self, *input_values) -> Any:
        """Interpreted execution submits tasks to the runtime."""
        raise NotImplementedError(f"interpreted DAG execute {_NEEDS_RUNTIME}")

    def experimental_compile(self, backend: str = "actor", **options):
        """Compile the static DAG.

        backend="torch": lower to the wave executor over a device-resident
                         task/object table (the counterpart of the
                         reference's ``backend="jax"``).
        backend="actor": per-actor execution loops over channels; not
                         ported (raises).
        """
        if backend == "torch":
            from ray_tpu_torch.dag.torch_executor import compile_torch_dag

            return compile_torch_dag(self, **options)
        if backend == "actor":
            raise NotImplementedError(f"backend='actor' {_NEEDS_RUNTIME}")
        raise ValueError(f"unknown compile backend {backend!r}")


class InputNode(DAGNode):
    """The DAG's runtime input; context manager per the reference API."""

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return InputAttributeNode(self, item)

    def __getitem__(self, key):
        return InputAttributeNode(self, key)


class InputAttributeNode(DAGNode):
    """Projection of a structured DAG input (inp.x / inp[0])."""

    def __init__(self, input_node: InputNode, key):
        super().__init__((input_node,), {})
        self._key = key


class FunctionNode(DAGNode):
    """A bound remote function call."""

    def __init__(self, remote_function, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_function = remote_function

    @property
    def function(self):
        return self._remote_function._function


class ClassNode(DAGNode):
    """A bound actor construction: needs the actor runtime."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"actor DAG nodes {_NEEDS_RUNTIME}")


class ClassMethodNode(DAGNode):
    """A bound actor-method call: needs the actor runtime."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"actor DAG nodes {_NEEDS_RUNTIME}")


class MultiOutputNode(DAGNode):
    """Groups several leaves into one DAG with a list output."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})


def reduce_tree(remote_function, nodes: List[DAGNode], arity: int = 8
                ) -> DAGNode:
    """Build a balanced k-ary reduction tree from a binary/k-ary op.

    Fan-in of N leaves becomes ceil(log_k N) levels of k-ary combines, so
    no single task of a wide fan-in takes N args (the compiled executor
    caps args per task at ``max_args``).
    """
    level = list(nodes)
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level), arity):
            group = level[i : i + arity]
            if len(group) == 1:
                nxt.append(group[0])
            else:
                nxt.append(remote_function.bind(*group))
        level = nxt
    return level[0]
