"""HTTP ingress proxy (counterpart of ``ray_tpu/serve/http.py``): a
stdlib ``ThreadingHTTPServer``, no new dependencies.

``POST /<deployment>`` routes the JSON body to the deployment's handle
through the same router as handle calls and answers ``{"result": ...}``;
``?stream=1`` streams the response with chunked transfer, one JSON line
per generator item, as the replica yields; a request refused by priority
admission answers 503 with ``Retry-After``. The priority class comes
from the ``X-Request-Priority`` header or ``?priority=``. Not ported:
the ASGI ingress path and the tracing hooks. ``stop_proxy`` shuts the
server down and joins its thread.
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ray_tpu_torch.exceptions import RequestSheddedError
from ray_tpu_torch.serve.controller import get_or_create_controller
from ray_tpu_torch.serve.handle import DeploymentHandle

_RESULT_TIMEOUT_S = 30.0


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *args):  # silence per-request stderr noise
        pass

    def _route(self):
        from urllib.parse import parse_qs, urlparse

        parsed = urlparse(self.path)
        name = parsed.path.strip("/").split("/")[0]
        if not name:
            self.send_response(404)
            self.end_headers()
            self.wfile.write(b'{"error": "no deployment in path"}')
            return
        length = int(self.headers.get("Content-Length", 0) or 0)
        body = self.rfile.read(length) if length else b""
        controller = get_or_create_controller()
        qs = parse_qs(parsed.query)
        stream = qs.get("stream", ["0"])[0] in ("1", "true")
        try:
            priority = int(self.headers.get(
                "X-Request-Priority", qs.get("priority", ["0"])[0]))
        except (TypeError, ValueError):
            priority = 0
        try:
            arg = json.loads(body) if body else None
            handle = DeploymentHandle(name, controller, priority=priority)
            if stream:
                gen = (handle.options(stream=True).remote(arg)
                       if arg is not None
                       else handle.options(stream=True).remote())
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for item in gen:
                        chunk = (json.dumps(item) + "\n").encode()
                        self.wfile.write(
                            f"{len(chunk):X}\r\n".encode() + chunk
                            + b"\r\n")
                except Exception as exc:  # noqa: BLE001 — mid-stream error
                    # Headers are already on the wire: the error rides the
                    # chunked framing, then the stream terminates cleanly.
                    chunk = (json.dumps({"error": repr(exc)})
                             + "\n").encode()
                    self.wfile.write(
                        f"{len(chunk):X}\r\n".encode() + chunk + b"\r\n")
                finally:
                    # Client disconnect / mid-stream error: cancel the
                    # replica's generator and release its in-flight slot.
                    try:
                        gen.close()
                    except Exception:  # noqa: BLE001
                        pass
                self.wfile.write(b"0\r\n\r\n")
                return
            result = (handle.remote(arg) if arg is not None
                      else handle.remote()).result(timeout=_RESULT_TIMEOUT_S)
            payload = json.dumps({"result": result}).encode()
            self.send_response(200)
        except KeyError:
            payload = json.dumps({"error": f"no deployment {name!r}"}
                                 ).encode()
            self.send_response(404)
        except RequestSheddedError as exc:
            # Shed by the admission policy (choose() raises before any
            # replica is touched, so for streams too this lands before
            # headers went out): 503 + Retry-After.
            payload = json.dumps({
                "error": str(exc), "shed": True,
                "priority": exc.priority,
                "retry_after_s": exc.retry_after_s,
            }).encode()
            self.send_response(503)
            self.send_header("Retry-After",
                             str(max(1, math.ceil(exc.retry_after_s))))
        except Exception as exc:  # noqa: BLE001 — request error boundary
            payload = json.dumps({"error": repr(exc)}).encode()
            self.send_response(500)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    do_GET = _route
    do_POST = _route


class HTTPProxy:
    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="serve-http-proxy")
        self._thread.start()

    def shutdown(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)


_proxy: Optional[HTTPProxy] = None
_proxy_lock = threading.Lock()


def start_proxy(host: str = "127.0.0.1", port: int = 8000) -> HTTPProxy:
    """Start the proxy (``port=0`` picks a free port: read ``.port``)."""
    global _proxy
    with _proxy_lock:
        if _proxy is None:
            _proxy = HTTPProxy(host, port)
        return _proxy


def stop_proxy():
    global _proxy
    with _proxy_lock:
        proxy, _proxy = _proxy, None
    if proxy is not None:
        proxy.shutdown()
