"""Public serve API (counterpart of ``ray_tpu/serve/api.py``):
``@serve.deployment``, ``.bind()`` applications, ``serve.run``,
``deploy_config``, ``start``, ``status``, ``delete``, ``shutdown``,
``get_deployment_handle``, the ASGI ``ingress`` and the ``@serve.batch``
and ``@serve.multiplexed`` decorators.

``deploy_config`` reads a dict, or a YAML file where ``yaml`` imports and
a JSON file otherwise. An ingress
replica's ASGI loop thread is stopped and joined when the replica goes
away. ``multiplexed`` runs an async loader with
``asyncio.get_event_loop()``, as the reference does: on Python 3.12 that
raises ``RuntimeError`` in a replica's executor thread, which has no
loop (ROADMAP C.12).
"""

from __future__ import annotations

import asyncio
import functools
import threading
import time
from collections import OrderedDict
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


def deploy_config(config, *, start_http: bool = False) -> Dict[str, Any]:
    """Config-file deploy (`serve deploy config.yaml`, the declarative
    config schema, subset): a dict, YAML, or JSON
    file with ``applications: [{import_path: "module:app", name: ...,
    deployments: [{name, num_replicas, autoscaling_config}]}]``.
    ``import_path`` resolves to an Application (or a Deployment, which is
    bound with no args); per-deployment overrides apply before deploy.
    Returns {app_name: handle}."""
    import importlib
    import json as _json

    if isinstance(config, dict):
        cfg = config
    else:
        with open(config) as f:
            text = f.read()
        try:
            import yaml

            cfg = yaml.safe_load(text)
        except ImportError:
            cfg = _json.loads(text)
    handles: Dict[str, Any] = {}
    for app_cfg in cfg.get("applications", []):
        mod_name, _, attr = app_cfg["import_path"].partition(":")
        target = getattr(importlib.import_module(mod_name), attr)
        app = target.bind() if isinstance(target, Deployment) else target
        if not isinstance(app, Application):
            raise TypeError(
                f"{app_cfg['import_path']} is not an Application or "
                f"Deployment")
        overrides = {d["name"]: d for d in app_cfg.get("deployments", [])}
        o = overrides.get(app.deployment.name)
        if o:
            opts = {k: v for k, v in o.items() if k != "name"}
            app = Application(app.deployment.options(**opts),
                              app.args, app.kwargs)
        handles[app_cfg.get("name", app.deployment.name)] = run(app)
    if start_http:
        from ray_tpu_torch.serve.http import start_proxy

        http_cfg = cfg.get("http_options", {})
        start_proxy(host=http_cfg.get("host", "127.0.0.1"),
                    port=int(http_cfg.get("port", 8000)))
    return handles


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


def ingress(asgi_app=None):
    """ASGI ingress (``@serve.ingress(app)``). Works with ANY ASGI-3
    application (FastAPI, Starlette, or a plain callable); the contract
    is the protocol itself. The decorator injects a ``__serve_asgi__``
    replica method that drives the app for one HTTP request; the proxy
    routes ``/<deployment>/<subpath>`` through it with
    ``path=/<subpath>``. ``__serve_asgi_stop__``, which the controller
    calls when it stops a replica, stops and joins the app's loop
    thread."""

    def wrap(cls):
        cls.__serve_ingress__ = asgi_app

        def __serve_asgi__(self, request: dict) -> dict:
            app = type(self).__serve_ingress__
            if app is None:
                raise ValueError("no ASGI app bound to this deployment")
            runner = getattr(self, "_serve_asgi_runner", None)
            if runner is None:
                runner = _AsgiRunner(app)
                self._serve_asgi_runner = runner
            return runner.handle(request)

        def __serve_asgi_stop__(self) -> None:
            runner = self.__dict__.pop("_serve_asgi_runner", None)
            if runner is not None:
                runner.stop()

        cls.__serve_asgi__ = __serve_asgi__
        cls.__serve_asgi_stop__ = __serve_asgi_stop__
        return cls

    return wrap


class _AsgiRunner:
    """Per-replica ASGI host: one persistent event loop thread for the
    app (not a fresh asyncio.run per request) with the lifespan protocol
    driven ONCE at startup — FastAPI/Starlette startup handlers (DB
    pools, model loads) run before the first request, as under uvicorn.
    Apps that do not speak lifespan are tolerated (the spec allows
    rejecting it)."""

    def __init__(self, app):
        self.app = app
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop_main, daemon=True, name="serve-asgi-loop")
        self._thread.start()

        started = threading.Event()
        state: dict = {}

        async def lifespan():
            scope = {"type": "lifespan", "asgi": {"version": "3.0"},
                     "state": state}
            incoming = [{"type": "lifespan.startup"}]

            async def receive():
                if incoming:
                    return incoming.pop(0)
                # Block until shutdown (never, for replica lifetime).
                return await asyncio.get_event_loop().create_future()

            async def send(msg):
                if msg["type"] in ("lifespan.startup.complete",
                                   "lifespan.startup.failed"):
                    started.set()

            try:
                await self.app(scope, receive, send)
            except BaseException:  # noqa: BLE001 — app rejects lifespan
                started.set()

        asyncio.run_coroutine_threadsafe(lifespan(), self.loop)
        started.wait(timeout=30)
        self._state = state

    def _loop_main(self):
        asyncio.set_event_loop(self.loop)
        self.loop.run_forever()

    def stop(self, timeout: float = 5.0) -> None:
        """Cancel the app's pending tasks (its parked lifespan), stop the
        loop and join its thread (bounded), then close the loop."""

        def _cancel_and_stop():
            for task in asyncio.all_tasks(self.loop):
                task.cancel()
            self.loop.call_soon(self.loop.stop)

        if self.loop.is_closed():
            return
        self.loop.call_soon_threadsafe(_cancel_and_stop)
        self._thread.join(timeout)
        if not self._thread.is_alive():
            self.loop.close()

    def handle(self, request: dict) -> dict:
        body = request.get("body", b"")
        incoming = [{"type": "http.request", "body": body,
                     "more_body": False}]
        out = {"status": 500, "headers": [], "body": b""}

        async def receive():
            if incoming:
                return incoming.pop(0)
            return {"type": "http.disconnect"}

        async def send(msg):
            if msg["type"] == "http.response.start":
                out["status"] = int(msg["status"])
                out["headers"] = [
                    (bytes(k).decode("latin1"), bytes(v).decode("latin1"))
                    for k, v in msg.get("headers", [])]
            elif msg["type"] == "http.response.body":
                out["body"] = out["body"] + bytes(msg.get("body", b""))

        scope = {
            "type": "http", "asgi": {"version": "3.0"},
            "http_version": "1.1",
            "method": request.get("method", "GET"),
            "path": request.get("path", "/"),
            "raw_path": request.get("path", "/").encode(),
            "query_string": request.get("query_string", b""),
            "headers": [(k.lower().encode("latin1"), v.encode("latin1"))
                        for k, v in request.get("headers", [])],
            "client": None, "server": None, "scheme": "http",
            "state": dict(self._state),
        }
        fut = asyncio.run_coroutine_threadsafe(
            self.app(scope, receive, send), self.loop)
        fut.result(timeout=30)
        return out


# --------------------------------------------------- decorator local state
# Per-process registry for decorator state that must not travel with the
# pickled wrapper (locks, queues, caches). Keyed by a uuid token baked into
# the wrapper closure; each process materializes its own instance on first
# call.
_decorator_states: Dict[str, Any] = {}
_decorator_states_lock = threading.Lock()


def _decorator_state(token: str, factory):
    with _decorator_states_lock:
        st = _decorator_states.get(token)
        if st is None:
            st = _decorator_states[token] = factory()
        return st


# ----------------------------------------------------------------- batching
def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """Dynamic request batching.

    Decorate a method taking a LIST of inputs and returning a LIST of
    outputs; concurrent callers are coalesced up to max_batch_size or until
    the wait timeout — the mechanism that keeps the card on large
    batches. Thread-safe (replica actors run with max_concurrency>1).
    The first caller of a batch leads it: it waits up to the timeout for
    the batch to fill, then drains everything queued in max_batch_size
    chunks; a wrong result count raises ValueError, and one error reaches
    every caller of that batch.
    """

    def wrap(fn):
        # Decorator state (lock + queue) is created lazily PER PROCESS via
        # a token-keyed registry: the wrapper must stay picklable by value,
        # and a captured _thread.lock is not.
        import uuid as _uuid

        token = _uuid.uuid4().hex

        def _state():
            return _decorator_state(
                token, lambda: {"lock": threading.Lock(), "pending": []})

        def flush(batch_items):
            args = [it[0] for it in batch_items]
            try:
                results = fn(batch_items[0][3], args) if batch_items[0][3] \
                    is not None else fn(args)
                if len(results) != len(args):
                    raise ValueError(
                        f"batched fn returned {len(results)} results for "
                        f"{len(args)} inputs")
                for it, res in zip(batch_items, results):
                    it[2]["value"] = res
                    it[1].set()
            except BaseException as exc:  # noqa: BLE001
                for it in batch_items:
                    it[2]["error"] = exc
                    it[1].set()

        @functools.wraps(fn)
        def wrapper(*call_args):
            # Support bound methods: (self, item) or plain (item,).
            if len(call_args) == 2:
                self_obj, arg = call_args
            else:
                self_obj, arg = None, call_args[0]
            event = threading.Event()
            slot: Dict[str, Any] = {}
            st = _state()
            lock, pending = st["lock"], st["pending"]
            with lock:
                pending.append((arg, event, slot, self_obj))
                is_leader = len(pending) == 1
            if is_leader:
                deadline = time.monotonic() + batch_wait_timeout_s
                while time.monotonic() < deadline:
                    with lock:
                        if len(pending) >= max_batch_size:
                            break
                    time.sleep(batch_wait_timeout_s / 10)
                # Drain everything queued (in max_batch_size chunks) before
                # abdicating: callers that joined after this leader's first
                # batch filled would otherwise wait with no one flushing.
                while True:
                    with lock:
                        batch_items = pending[:max_batch_size]
                        del pending[:len(batch_items)]
                    if not batch_items:
                        break
                    flush(batch_items)
            event.wait(timeout=30)
            if "error" in slot:
                raise slot["error"]
            return slot["value"]

        wrapper.__wrapped__ = fn
        return wrapper

    return wrap(_fn) if _fn is not None else wrap


# -------------------------------------------------------------- multiplexing
def multiplexed(_fn=None, *, max_num_models_per_replica: int = 3):
    """Per-replica LRU model cache.

    Decorate an async or sync model-loader method keyed by model_id; the
    wrapper evicts least-recently-used models beyond the cap.
    """

    def wrap(fn):
        import uuid as _uuid

        token = _uuid.uuid4().hex

        @functools.wraps(fn)
        def wrapper(self_or_id, model_id=None):
            st = _decorator_state(
                token,
                lambda: {"lock": threading.Lock(), "cache": OrderedDict()})
            lock, cache = st["lock"], st["cache"]
            if model_id is None:
                self_obj, mid = None, self_or_id
            else:
                self_obj, mid = self_or_id, model_id
            with lock:
                if mid in cache:
                    cache.move_to_end(mid)
                    return cache[mid]
            model = fn(mid) if self_obj is None else fn(self_obj, mid)
            if asyncio.iscoroutine(model):
                model = asyncio.get_event_loop().run_until_complete(model)
            with lock:
                cache[mid] = model
                cache.move_to_end(mid)
                while len(cache) > max_num_models_per_replica:
                    cache.popitem(last=False)
            return model

        wrapper.__wrapped__ = fn
        return wrapper

    return wrap(_fn) if _fn is not None else wrap
