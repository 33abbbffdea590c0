"""gRPC ingress proxy (counterpart of ``ray_tpu/serve/grpc.py``).

Generic-handler design, no protoc step: the proxy registers a
``grpc.GenericRpcHandler`` that accepts ANY unary-unary method of the
form ``/<package.Service>/<Method>``; the first metadata entry
``application`` (reference parity) or the service name's last path
segment selects the deployment, the gRPC method name selects the
replica method, and the request/response payloads are raw bytes the
user frames however they like (JSON by convention — the test uses it).
Routing rides the same pow-2 ReplicaSet as handle and HTTP calls.

``grpc`` is imported only when a proxy starts: where it is missing,
``start_grpc_proxy`` raises
``ModuleNotFoundError`` (an ``ImportError``) naming ``grpc``, and nothing
else in ``serve`` needs it.
"""

from __future__ import annotations

import json
import threading
from concurrent import futures
from typing import Optional

from ray_tpu_torch.serve.controller import get_or_create_controller
from ray_tpu_torch.serve.handle import DeploymentHandle


class _GenericHandler:
    """grpc.GenericRpcHandler: serves every method name dynamically."""

    def __init__(self):
        import grpc

        self._grpc = grpc

    def service(self, handler_call_details):
        grpc = self._grpc
        # /package.Service/Method -> (deployment?, method)
        _, _, rest = handler_call_details.method.partition("/")
        service, _, method = rest.partition("/")
        meta = dict(handler_call_details.invocation_metadata or ())
        deployment = meta.get("application") or service.split(".")[-1]

        def unary_unary(request: bytes, context):
            controller = get_or_create_controller()
            try:
                handle = DeploymentHandle(deployment, controller)
                payload = json.loads(request) if request else {}
                args = payload.get("args", [])
                kwargs = payload.get("kwargs", {})
                target = "__call__" if method in ("Call", "__call__") \
                    else method
                out = handle.options(target).remote(
                    *args, **kwargs).result(timeout=60)
                return json.dumps({"result": out}).encode()
            except KeyError:
                context.set_code(grpc.StatusCode.NOT_FOUND)
                context.set_details(
                    f"no deployment named {deployment!r}")
                return b""
            except Exception as exc:  # noqa: BLE001 — app error boundary
                context.set_code(grpc.StatusCode.INTERNAL)
                context.set_details(f"{type(exc).__name__}: {exc}")
                return b""

        return grpc.unary_unary_rpc_method_handler(
            unary_unary,
            request_deserializer=lambda b: b,
            response_serializer=lambda b: b)


class GRPCProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 9000):
        import grpc

        self._pool = futures.ThreadPoolExecutor(
            max_workers=16, thread_name_prefix="serve-grpc")
        self._server = grpc.server(self._pool)
        self._server.add_generic_rpc_handlers((_GenericHandler(),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        self._server.start()

    def shutdown(self):
        """Stop the server (its in-flight calls get 0.5 s), then join
        the handler pool's threads."""
        self._server.stop(grace=0.5).wait(5.0)
        self._pool.shutdown(wait=True, cancel_futures=True)


_proxy: Optional[GRPCProxy] = None
_lock = threading.Lock()


def start_grpc_proxy(host: str = "127.0.0.1",
                     port: int = 9000) -> GRPCProxy:
    global _proxy
    with _lock:
        if _proxy is None:
            _proxy = GRPCProxy(host, port)
        return _proxy


def stop_grpc_proxy():
    global _proxy
    with _lock:
        if _proxy is not None:
            _proxy.shutdown()
            _proxy = None
