"""ray_tpu_torch.serve: model serving (counterpart of ``ray_tpu/serve``).

The controller reconciles deployments to target replica counts; replicas
are the port's actors; a router picks a replica per request with
power-of-two-choices on queue length, priority admission and, for LLM
deployments, cached-prefix overlap; ``DeploymentHandle``s compose
deployments and stream (``handle.options(stream=True)``). HTTP ingress
is the stdlib proxy of ``serve/http.py`` (``start_proxy``/``stop_proxy``),
which also drives ASGI apps bound with ``@serve.ingress``; gRPC ingress
(``start_grpc_proxy``/``stop_grpc_proxy``, ``serve/grpc.py``) serves any
``/<pkg.Service>/<Method>`` through generic unary handlers where ``grpc``
imports. ``@serve.batch`` coalesces concurrent calls into one batched
call, ``@serve.multiplexed`` keeps a per-replica LRU of loaded models,
and ``deploy_config`` deploys from a config dict or file.
"""

from ray_tpu_torch.serve.api import (
    Application,
    Deployment,
    batch,
    delete,
    deploy_config,
    deployment,
    get_deployment_handle,
    ingress,
    multiplexed,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.handle import (
    DeploymentHandle,
    DeploymentResponse,
    DeploymentResponseGenerator,
)
from ray_tpu_torch.serve.grpc import start_grpc_proxy, stop_grpc_proxy
from ray_tpu_torch.serve.http import start_proxy, stop_proxy

__all__ = [
    "Application",
    "Deployment",
    "DeploymentHandle",
    "DeploymentResponse",
    "DeploymentResponseGenerator",
    "batch",
    "delete",
    "deploy_config",
    "deployment",
    "get_deployment_handle",
    "ingress",
    "multiplexed",
    "run",
    "shutdown",
    "start",
    "start_grpc_proxy",
    "start_proxy",
    "status",
    "stop_grpc_proxy",
    "stop_proxy",
]
