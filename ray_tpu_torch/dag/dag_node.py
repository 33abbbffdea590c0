"""Lazy DAG authoring: ``bind()`` graphs of tasks and actor methods
(counterpart of ``ray_tpu/dag/dag_node.py``).

A DAG is built by ``.bind()`` calls on ``ray_tpu_torch.remote`` functions,
actor classes and actor methods. ``execute()`` walks it submitting tasks
and actor calls to the one-process runtime (the interpreted path);
``experimental_compile`` lowers it to a static executor: the actor-loop
backend over channels (``backend="actor"``, ``dag/compiled_dag.py``) or
the device-resident wave executor (``backend="torch"``,
``dag/torch_executor.py``, the counterpart of the reference's
``backend="jax"``).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple


class DAGNode:
    """Base: a lazy computation with upstream dependencies."""

    def __init__(self, args: Tuple, kwargs: Dict[str, Any]):
        self._bound_args = args
        self._bound_kwargs = kwargs
        self._transport_hint: str = "auto"

    def with_tensor_transport(self, transport: str = "shm") -> "DAGNode":
        """Hint this node's OUTPUT edge transport for the actor backend
        (the reference's ``with_type_hint(TorchTensorType(transport=
        ...))``).

        - ``"driver"``: the channel plane of this process (values pass
          by reference).
        - ``"device"``: this stage is a device program; the compiler
          fuses contiguous device-hinted stages into ONE stage and keeps
          their edges live tensors, by reference (the mixed DAG).
        - ``"auto"`` (default): the channel plane of this process.
        - ``"shm"``: the reference's shared-memory plane, which needs
          process-backed actor stages; every actor of the port is a
          thread, so compiling such a DAG raises ``ValueError``.
        """
        if transport not in ("shm", "driver", "auto", "device"):
            raise ValueError(f"unknown transport {transport!r}")
        self._transport_hint = transport
        return self

    # ---------------------------------------------------------------- deps
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

    # ------------------------------------------------------------- execute
    def execute(self, *input_values) -> Any:
        """Interpreted execution: submit as tasks and actor calls, return
        an ObjectRef (or the raw input value for an InputNode)."""
        cache: Dict[int, Any] = {}
        for node in self.topological_order():
            cache[id(node)] = node._execute_one(cache, input_values)
        return cache[id(self)]

    def _execute_one(self, cache: Dict[int, Any], input_values) -> Any:
        raise NotImplementedError

    def _resolve_bound(self, cache: Dict[int, Any]):
        args = tuple(
            cache[id(a)] if isinstance(a, DAGNode) else a
            for a in self._bound_args
        )
        kwargs = {
            k: cache[id(v)] if isinstance(v, DAGNode) else v
            for k, v in self._bound_kwargs.items()
        }
        return args, kwargs

    # ------------------------------------------------------------- compile
    def experimental_compile(self, backend: str = "actor", **options):
        """Compile the static DAG.

        backend="torch": lower to the wave executor over a device-resident
                         task/object table (the counterpart of the
                         reference's ``backend="jax"``).
        backend="actor": per-actor execution loops connected by channels
                         (the reference's aDAG semantics).
        """
        if backend == "torch":
            from ray_tpu_torch.dag.torch_executor import compile_torch_dag

            return compile_torch_dag(self, **options)
        if backend == "actor":
            from ray_tpu_torch.dag.compiled_dag import CompiledDAG

            return CompiledDAG(self, **options)
        raise ValueError(f"unknown compile backend {backend!r}")


class InputNode(DAGNode):
    """The DAG's runtime input; context manager per the reference API."""

    def __init__(self):
        super().__init__((), {})

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def _execute_one(self, cache, input_values):
        if len(input_values) == 0:
            raise ValueError("DAG with an InputNode requires an input value")
        if len(input_values) == 1:
            return input_values[0]
        return input_values

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

    def _execute_one(self, cache, input_values):
        base = cache[id(self._bound_args[0])]
        if isinstance(self._key, str):
            if isinstance(base, dict):
                return base[self._key]
            return getattr(base, self._key)
        return base[self._key]


class FunctionNode(DAGNode):
    """A bound remote function call."""

    def __init__(self, remote_function, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_function = remote_function

    def _execute_one(self, cache, input_values):
        args, kwargs = self._resolve_bound(cache)
        return self._remote_function.remote(*args, **kwargs)

    @property
    def function(self):
        return self._remote_function._function


class ClassNode(DAGNode):
    """A bound actor construction."""

    def __init__(self, actor_class, args, kwargs):
        super().__init__(args, kwargs)
        self._actor_class = actor_class
        self._lock = threading.Lock()
        self._handle = None

    def _get_or_create_actor(self, cache):
        with self._lock:
            if self._handle is None:
                args, kwargs = self._resolve_bound(cache)
                self._handle = self._actor_class.remote(*args, **kwargs)
            return self._handle

    def _execute_one(self, cache, input_values):
        return self._get_or_create_actor(cache)

    def __getattr__(self, item):
        if item.startswith("_"):
            raise AttributeError(item)
        return _UnboundClassMethod(self, item)


class _UnboundClassMethod:
    def __init__(self, class_node: ClassNode, method_name: str):
        self._class_node = class_node
        self._method_name = method_name

    def bind(self, *args, **kwargs) -> "ClassMethodNode":
        node = ClassMethodNode.__new__(ClassMethodNode)
        DAGNode.__init__(node, args, kwargs)
        node._actor_method = None
        node._class_node = self._class_node
        node._method_name = self._method_name
        return node


class ClassMethodNode(DAGNode):
    """A bound actor-method call (on a live handle or a ClassNode)."""

    def __init__(self, actor_method, args, kwargs):
        super().__init__(args, kwargs)
        self._actor_method = actor_method  # ActorMethod on a live handle
        self._class_node: Optional[ClassNode] = None
        self._method_name: Optional[str] = None

    def _upstream(self):
        deps = super()._upstream()
        if self._class_node is not None:
            deps.append(self._class_node)
        return deps

    def _execute_one(self, cache, input_values):
        args, kwargs = self._resolve_bound(cache)
        return self._bound_method(cache).remote(*args, **kwargs)

    def _bound_method(self, cache=None):
        if self._actor_method is not None:
            return self._actor_method
        handle = self._class_node._get_or_create_actor(cache or {})
        return getattr(handle, self._method_name)


class MultiOutputNode(DAGNode):
    """Groups several leaves into one DAG with a list output."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(tuple(outputs), {})

    def _execute_one(self, cache, input_values):
        return [cache[id(a)] for a in self._bound_args]


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
