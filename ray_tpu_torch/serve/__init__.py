"""ray_tpu_torch.serve: model serving (counterpart of ``ray_tpu/serve``).

The controller reconciles deployments to target replica counts; replicas
are the port's actors; a router picks a replica per request with
power-of-two-choices on queue length, priority admission and, for LLM
deployments, cached-prefix overlap; ``DeploymentHandle``s compose
deployments and stream (``handle.options(stream=True)``). HTTP ingress
is the stdlib proxy of ``serve/http.py`` (``start_proxy``/``stop_proxy``).
Not ported yet: ``batch``, ``multiplexed``, ``ingress``,
``deploy_config`` and the gRPC proxy.
"""

from ray_tpu_torch.serve.api import (
    Application,
    Deployment,
    delete,
    deployment,
    get_deployment_handle,
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
from ray_tpu_torch.serve.http import start_proxy, stop_proxy

__all__ = [
    "Application",
    "Deployment",
    "DeploymentHandle",
    "DeploymentResponse",
    "DeploymentResponseGenerator",
    "delete",
    "deployment",
    "get_deployment_handle",
    "run",
    "shutdown",
    "start",
    "start_proxy",
    "status",
    "stop_proxy",
]
