"""Public serve API (counterpart of ``ray_tpu/serve/api.py``):
``@serve.deployment``, ``.bind()`` applications, ``serve.run``,
``start``, ``status``, ``delete``, ``shutdown`` and
``get_deployment_handle``. Not ported yet: ``batch``, ``multiplexed``,
the ASGI ``ingress`` and ``deploy_config`` (which reads YAML).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.controller import (
    AutoscalingConfig,
    get_or_create_controller,
    shutdown_controller,
)
from ray_tpu_torch.serve.handle import DeploymentHandle


class Application:
    """A bound deployment graph root (result of Deployment.bind)."""

    def __init__(self, deployment: "Deployment", args, kwargs):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs


class Deployment:
    def __init__(self, cls_or_fn, name: str, num_replicas: int = 1,
                 autoscaling_config: Optional[dict] = None,
                 max_ongoing_requests: Optional[int] = None,
                 ray_actor_options: Optional[dict] = None,
                 **_opts):
        self._target = cls_or_fn
        self.name = name
        self.num_replicas = num_replicas
        self.autoscaling_config = autoscaling_config
        # Priority admission + load shedding: total in-flight bound
        # across the deployment's replicas (None = unlimited). Requests
        # past their priority class's nested threshold are refused with
        # a typed RequestSheddedError (HTTP: 503 + Retry-After).
        self.max_ongoing_requests = max_ongoing_requests
        # Per-replica actor options (the replica actor's options).
        self.ray_actor_options = dict(ray_actor_options or {})

    def options(self, **opts) -> "Deployment":
        merged = dict(
            name=self.name, num_replicas=self.num_replicas,
            autoscaling_config=self.autoscaling_config,
            max_ongoing_requests=self.max_ongoing_requests,
            ray_actor_options=self.ray_actor_options)
        merged.update(opts)
        return Deployment(self._target, **merged)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)


def deployment(_cls=None, *, name: Optional[str] = None,
               num_replicas: int = 1,
               autoscaling_config: Optional[dict] = None,
               max_ongoing_requests: Optional[int] = None,
               ray_actor_options: Optional[dict] = None, **opts):
    """@serve.deployment decorator for classes or functions."""

    def wrap(cls):
        target = cls
        if not isinstance(cls, type):
            # Function deployment: wrap into a callable class.
            fn = cls

            class _FnDeployment:
                def __call__(self, *a, **k):
                    return fn(*a, **k)

            _FnDeployment.__name__ = getattr(fn, "__name__", "fn")
            target = _FnDeployment
        return Deployment(
            target, name or getattr(cls, "__name__", "deployment"),
            num_replicas=num_replicas,
            autoscaling_config=autoscaling_config,
            max_ongoing_requests=max_ongoing_requests,
            ray_actor_options=ray_actor_options, **opts)

    return wrap(_cls) if _cls is not None else wrap


def _deploy_app(app: Application) -> DeploymentHandle:
    """Deploy an application graph: bound handle args resolve depth-first
    (deployment composition)."""
    controller = get_or_create_controller()

    def resolve(value):
        if isinstance(value, Application):
            return _deploy_app(value)
        return value

    args = tuple(resolve(a) for a in app.args)
    kwargs = {k: resolve(v) for k, v in app.kwargs.items()}
    d = app.deployment
    auto = None
    if d.autoscaling_config:
        auto = AutoscalingConfig(**d.autoscaling_config)
    controller.deploy(d.name, d._target, args, kwargs,
                      num_replicas=d.num_replicas, autoscaling=auto,
                      max_ongoing_requests=d.max_ongoing_requests,
                      ray_actor_options=d.ray_actor_options)
    return DeploymentHandle(d.name, controller)


def run(app: Application, *, name: str = "default", route_prefix: str = "/",
        blocking: bool = False) -> DeploymentHandle:
    ray_tpu_torch.init(ignore_reinit_error=True)
    return _deploy_app(app)


def start(detached: bool = False, **_opts):
    ray_tpu_torch.init(ignore_reinit_error=True)
    get_or_create_controller()


def status() -> Dict[str, Any]:
    return get_or_create_controller().status()


def delete(name: str):
    get_or_create_controller().delete(name)


def shutdown():
    """Stop the controller's loops and every deployment's replicas."""
    shutdown_controller()


def get_deployment_handle(name: str, app_name: str = "default"
                          ) -> DeploymentHandle:
    return DeploymentHandle(name, get_or_create_controller())
