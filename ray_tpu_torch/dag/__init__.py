"""DAG authoring and the compiled wave executor of the PyTorch/CUDA port
(counterpart of ``ray_tpu/dag``).

See dag_node.py (authoring) and torch_executor.py (the device-resident
wave executor, ``experimental_compile(backend="torch")``, on one device
or, with ``mesh=``, sharded over a mesh axis). The actor-loop
backend and interpreted execution wait for the runtime (ROADMAP A.5).
"""

from ray_tpu_torch.dag.dag_node import (
    ClassMethodNode,
    ClassNode,
    DAGNode,
    FunctionNode,
    InputAttributeNode,
    InputNode,
    MultiOutputNode,
    reduce_tree,
)
from ray_tpu_torch.dag.torch_executor import (
    CompiledTorchDAG,
    ShardedTorchDAG,
    TorchDAGRef,
    compile_torch_dag,
)

__all__ = [
    "ClassMethodNode",
    "ClassNode",
    "CompiledTorchDAG",
    "DAGNode",
    "FunctionNode",
    "InputAttributeNode",
    "InputNode",
    "MultiOutputNode",
    "ShardedTorchDAG",
    "TorchDAGRef",
    "compile_torch_dag",
    "reduce_tree",
]
