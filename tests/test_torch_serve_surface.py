"""Twins of Serve's remaining surface on the CPU: ``@serve.batch``,
``@serve.multiplexed``, the ASGI ``@serve.ingress``, ``deploy_config``
and the gRPC proxy, the reference's Serve on its thread plane
(``ray_tpu.init(num_cpus=4, worker_mode="thread")``) beside the port's
(``ray_tpu_torch.init(num_cpus=4)``); outcomes (values, statuses, error
type names) must be equal.

Cases come from ``tests/test_serve.py:116``, ``:133``, ``:498``, ``:518``
and ``:567`` and ``tests/test_serve_grpc.py:32`` and ``:57``; the gRPC
cases skip inside their own functions where ``grpc`` does not import, so
the file still runs there. ``deploy_config``'s ``import_path`` names the
module-level apps below. Every wait is bounded. The port joins its
replicas' ``serve-asgi-loop`` threads when it stops them; the reference's
run until the process ends, so the fixture stops them and waits
(bounded) for every one.
"""

import importlib
import json
import sys
import threading
import time
import urllib.request

import pytest

import ray_tpu
import ray_tpu.serve as jserve
import ray_tpu_torch
import ray_tpu_torch.serve as tserve

T = 30.0

SIDES = ((ray_tpu, jserve), (ray_tpu_torch, tserve))


@jserve.deployment
class RefEcho:
    def __call__(self, x):
        return f"echo:{x}"


@tserve.deployment
class PortEcho:
    def __call__(self, x):
        return f"echo:{x}"


ref_app = RefEcho.bind()
port_app = PortEcho.bind()
APPS = {jserve: "ref_app", tserve: "port_app"}


def _threads(prefix):
    return [t for t in threading.enumerate() if t.name.startswith(prefix)]


def _stop_all():
    for rt, serve in SIDES:
        serve.stop_grpc_proxy()
        try:
            serve.shutdown()
        finally:
            rt.shutdown()
    # The port stops and joins its replicas' ASGI loops; the reference's
    # run until the process ends, so stop them here (each thread's target
    # is its runner's loop method) and join every one, bounded.
    deadline = time.monotonic() + T
    for t in _threads("serve-asgi-loop"):
        runner = getattr(t, "_target", None)
        runner = getattr(runner, "__self__", None)
        if runner is not None and not runner.loop.is_closed():
            runner.loop.call_soon_threadsafe(runner.loop.stop)
        t.join(max(deadline - time.monotonic(), 0.0))


@pytest.fixture
def serving():
    _stop_all()
    ray_tpu.init(num_cpus=4, worker_mode="thread", ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4)
    try:
        yield
    finally:
        _stop_all()
    assert _threads("serve-asgi-loop") == []


def _outcome(case, rt, serve):
    try:
        return ("ok", case(rt, serve))
    except Exception as exc:  # noqa: BLE001 — the error is the outcome
        return ("err", type(exc).__name__)


def _twin(case):
    ref = _outcome(case, *SIDES[0])
    port = _outcome(case, *SIDES[1])
    assert port == ref
    return ref


# ------------------------------------------------------------------ batch
def test_batching_coalesces(serving):
    """``tests/test_serve.py:116``: 16 concurrent calls coalesce; each
    item reports its batch's size."""

    def case(rt, serve):
        @serve.deployment
        class Model:
            @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
            def __call__(self, xs):
                return [(x * 2, len(xs)) for x in xs]

        handle = serve.run(Model.bind())
        responses = [handle.remote(i) for i in range(16)]
        results = sorted(r.result(timeout=T) for r in responses)
        return ([v for v, _ in results],
                max(b for _, b in results) > 1,
                max(b for _, b in results) <= 8)

    assert _twin(case) == ("ok", ([i * 2 for i in range(16)], True, True))


def test_batch_leader_drains_in_chunks_and_errors_reach_every_caller():
    """Off the runtime: the leader waits for the batch to fill, then
    drains everything queued in ``max_batch_size`` chunks; a wrong result
    count raises ValueError in every caller of that batch, and so does
    the batched function's own error."""

    def case(rt, serve):
        sizes = []

        @serve.batch(max_batch_size=3, batch_wait_timeout_s=0.2)
        def double(xs):
            sizes.append(len(xs))
            return [x * 2 for x in xs]

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.1)
        def short(xs):
            return xs[:-1]

        @serve.batch(max_batch_size=4, batch_wait_timeout_s=0.1)
        def boom(xs):
            raise KeyError("bad batch")

        def run(fn, n):
            out = [None] * n

            def call(i):
                try:
                    out[i] = ("ok", fn(i))
                except Exception as exc:  # noqa: BLE001
                    out[i] = ("err", type(exc).__name__)

            threads = [threading.Thread(target=call, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(T)
            return out

        doubled = run(double, 7)
        return (doubled, sum(sizes), max(sizes) <= 3, run(short, 3),
                run(boom, 2))

    ref = case(None, jserve)
    port = case(None, tserve)
    assert port == ref
    assert ref[0] == [("ok", 2 * i) for i in range(7)]
    assert ref[1:3] == (7, True)
    assert ref[3] == [("err", "ValueError")] * 3
    assert ref[4] == [("err", "KeyError")] * 2


# ------------------------------------------------------------ multiplexed
def test_multiplexed_lru():
    """``tests/test_serve.py:133``: the per-replica LRU keeps at most two
    models; a third evicts the least recently used."""

    def case(rt, serve):
        loads = []

        @serve.multiplexed(max_num_models_per_replica=2)
        def load_model(model_id):
            loads.append(model_id)
            return f"model-{model_id}"

        got = [load_model("a"), load_model("a")]
        load_model("b")
        load_model("c")
        load_model("a")
        return got, loads

    assert case(None, tserve) == case(None, jserve) == (
        ["model-a", "model-a"], ["a", "b", "c", "a"])


def test_multiplexed_method_in_a_replica(serving):
    """A sync loader method in a replica: cached per replica, and the
    LRU bound holds across calls through the handle."""

    def case(rt, serve):
        @serve.deployment
        class Models:
            def __init__(self):
                self.loads = []

            @serve.multiplexed(max_num_models_per_replica=2)
            def get_model(self, model_id):
                self.loads.append(model_id)
                return f"model-{model_id}"

            def __call__(self, model_id):
                return self.get_model(model_id)

            def loaded(self):
                return list(self.loads)

        h = serve.run(Models.bind())
        out = [h.remote(m).result(timeout=T) for m in "aabca"]
        return out, h.loaded.remote().result(timeout=T)

    assert _twin(case) == ("ok", (["model-a", "model-a", "model-b",
                                   "model-c", "model-a"],
                                  ["a", "b", "c", "a"]))


def test_multiplexed_async_loader_in_a_replica(serving):
    """An async loader called from a replica's executor thread: both
    sides run it with ``asyncio.get_event_loop()``, which on Python 3.12
    raises RuntimeError in a thread with no loop (ROADMAP C.12); the
    handle raises the same error type on both sides."""

    def case(rt, serve):
        @serve.deployment
        class AsyncModels:
            @serve.multiplexed(max_num_models_per_replica=2)
            async def get_model(self, model_id):
                return f"model-{model_id}"

            def __call__(self, model_id):
                return self.get_model(model_id)

        return serve.run(AsyncModels.bind()).remote("a").result(timeout=T)

    out = _twin(case)
    if sys.version_info >= (3, 12):
        assert out == ("err", "RayTaskError(RuntimeError)")


# ---------------------------------------------------------- deploy_config
def _config(serve, path):
    name = "RefEcho" if serve is jserve else "PortEcho"
    path.write_text(json.dumps({"applications": [{
        "name": "echo_app",
        "import_path": f"test_torch_serve_surface:{APPS[serve]}",
        "deployments": [{"name": name, "num_replicas": 2}],
    }]}))
    return str(path), name


def test_config_file_deploy(serving, tmp_path):
    """``tests/test_serve.py:498``: a config file deploys the
    module-level app with its per-deployment override (YAML parses the
    JSON file where ``yaml`` imports, as here)."""

    def case(rt, serve):
        path, name = _config(serve, tmp_path / f"{APPS[serve]}.json")
        handles = serve.deploy_config(path)
        return (sorted(handles),
                handles["echo_app"].remote("hi").result(timeout=T),
                serve.status()[name]["target_replicas"])

    assert _twin(case) == ("ok", (["echo_app"], "echo:hi", 2))


def test_config_deploy_without_yaml_reads_json(serving, tmp_path,
                                               monkeypatch):
    """Where ``yaml`` does not import (hidden here) a config file is read
    as JSON; a dict deploys directly, its app named after the
    deployment; an import_path that names neither an Application nor a
    Deployment raises TypeError."""
    monkeypatch.setitem(sys.modules, "yaml", None)

    def case(rt, serve):
        path, name = _config(serve, tmp_path / f"{APPS[serve]}.json")
        from_file = serve.deploy_config(path)
        direct = serve.deploy_config({"applications": [{
            "import_path": f"test_torch_serve_surface:{APPS[serve]}"}]})
        out = (sorted(from_file), sorted(direct) == [name],
               direct[name].remote(3).result(timeout=T))
        try:
            serve.deploy_config({"applications": [{
                "import_path": "test_torch_serve_surface:T"}]})
        except TypeError:
            return out + ("TypeError",)
        return out

    assert _twin(case) == ("ok", (["echo_app"], True, "echo:3",
                                  "TypeError"))


# ----------------------------------------------------------------- ingress
async def _echo_app(scope, receive, send):
    assert scope["type"] == "http"
    msg = await receive()
    body = msg.get("body", b"")
    reply = json.dumps({
        "path": scope["path"],
        "method": scope["method"],
        "query": scope["query_string"].decode(),
        "echo": body.decode() if body else None,
    }).encode()
    await send({"type": "http.response.start", "status": 201,
                "headers": [(b"content-type", b"application/json"),
                            (b"x-served-by", b"asgi")]})
    await send({"type": "http.response.body", "body": reply})


async def _lifespan_app(scope, receive, send):
    if scope["type"] == "lifespan":
        msg = await receive()
        assert msg["type"] == "lifespan.startup"
        scope["state"]["ready"] = "yes"
        await send({"type": "lifespan.startup.complete"})
        await receive()  # parks until the replica goes away
        return
    reply = json.dumps({
        "path": scope["path"],
        "method": scope["method"],
        "ready": scope["state"].get("ready"),
    }).encode()
    await send({"type": "http.response.start", "status": 200,
                "headers": [(b"content-type", b"application/json")]})
    await send({"type": "http.response.body", "body": reply})


def _http(port, path, method="GET", data=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data, method=method)
    with urllib.request.urlopen(req, timeout=T) as resp:
        return resp.status, dict(resp.headers), json.loads(resp.read())


def _proxy_module(serve):
    return importlib.import_module(serve.__name__ + ".http")


def test_asgi_ingress(serving):
    """``tests/test_serve.py:518``: the proxy maps
    ``/<deployment>/<subpath>`` to ``path=/<subpath>`` inside the
    replica's ASGI app, with the app's status and headers."""

    def case(rt, serve):
        @serve.deployment
        @serve.ingress(_echo_app)
        class Api:
            pass

        serve.run(Api.bind(), name="asgi_api")
        http = _proxy_module(serve)
        proxy = http.start_proxy(port=0)
        try:
            status, headers, out = _http(
                proxy.port, "/Api/users/7?verbose=1", "POST",
                b'{"hello": 1}')
        finally:
            http.stop_proxy()
        return status, headers["x-served-by"], out

    assert _twin(case) == ("ok", (201, "asgi", {
        "path": "/users/7", "method": "POST", "query": "verbose=1",
        "echo": '{"hello": 1}'}))


def test_asgi_ingress_lifespan_methods_and_encoding(serving):
    """``tests/test_serve.py:567``: lifespan startup runs once before
    requests, other methods reach the app, percent-encoded paths arrive
    decoded, a trailing slash survives. Deleting the deployment stops
    the port's ASGI loop thread and joins it."""

    def case(rt, serve):
        @serve.deployment
        @serve.ingress(_lifespan_app)
        class Api2:
            pass

        serve.run(Api2.bind(), name="asgi_api2")
        http = _proxy_module(serve)
        proxy = http.start_proxy(port=0)
        try:
            got = [_http(proxy.port, "/Api2/items/a%20b", "DELETE")[2],
                   _http(proxy.port, "/Api2/items/", "PUT", b"")[2]]
        finally:
            http.stop_proxy()
        return got

    assert _twin(case) == ("ok", [
        {"method": "DELETE", "path": "/items/a b", "ready": "yes"},
        {"method": "PUT", "path": "/items/", "ready": "yes"}])
    loops = _threads("serve-asgi-loop")
    jserve.delete("Api2")
    assert _threads("serve-asgi-loop") == loops   # the reference's stays
    tserve.delete("Api2")
    # The port's delete stopped its replica's loop and joined it.
    assert len(loops) - len(_threads("serve-asgi-loop")) == 1


def test_asgi_runner_stop_joins_its_loop():
    """``_AsgiRunner.stop`` cancels the parked lifespan, stops the loop
    and joins the thread; a second stop is a no-op."""
    from ray_tpu_torch.serve.api import _AsgiRunner

    runner = _AsgiRunner(_lifespan_app)
    out = runner.handle({"method": "GET", "path": "/x"})
    assert json.loads(out["body"]) == {"method": "GET", "path": "/x",
                                       "ready": "yes"}
    assert runner._thread.is_alive()
    runner.stop()
    assert not runner._thread.is_alive() and runner.loop.is_closed()
    runner.stop()


def test_ingress_is_recognised_by_the_controller(serving):
    def case(rt, serve):
        @serve.deployment
        @serve.ingress(_echo_app)
        class Api3:
            pass

        @serve.deployment
        class Plain:
            def __call__(self):
                return 1

        serve.run(Api3.bind())
        serve.run(Plain.bind())
        ctl = importlib.import_module(
            serve.__name__ + ".controller").get_or_create_controller()
        return ctl.is_ingress("Api3"), ctl.is_ingress("Plain"), \
            ctl.is_ingress("Missing")

    assert _twin(case) == ("ok", (True, False, False))


# -------------------------------------------------------------------- gRPC
def _grpc_call(grpc, channel, method, payload, metadata=()):
    stub = channel.unary_unary(
        method, request_serializer=lambda b: b,
        response_deserializer=lambda b: b)
    return stub(json.dumps(payload).encode(), metadata=metadata, timeout=60)


def test_grpc_ingress_routes_to_deployment(serving):
    """``tests/test_serve_grpc.py:32``."""
    grpc = pytest.importorskip("grpc")

    def case(rt, serve):
        @serve.deployment(num_replicas=2)
        class Adder:
            def __call__(self, a, b):
                return a + b

            def scale(self, x, k=2):
                return x * k

        serve.run(Adder.bind())
        proxy = serve.start_grpc_proxy(port=0)
        try:
            with grpc.insecure_channel(f"127.0.0.1:{proxy.port}") as ch:
                return [json.loads(_grpc_call(grpc, ch, *c))["result"]
                        for c in (
                            ("/user.Adder/Call", {"args": [3, 4]}),
                            ("/user.Adder/scale",
                             {"args": [5], "kwargs": {"k": 10}}),
                            ("/anything.Ignored/Call", {"args": [1, 1]},
                             (("application", "Adder"),)))]
        finally:
            serve.stop_grpc_proxy()

    assert _twin(case) == ("ok", [7, 50, 2])


def test_grpc_ingress_unknown_deployment_is_not_found(serving):
    """``tests/test_serve_grpc.py:57``."""
    grpc = pytest.importorskip("grpc")

    def case(rt, serve):
        proxy = serve.start_grpc_proxy(port=0)
        try:
            with grpc.insecure_channel(f"127.0.0.1:{proxy.port}") as ch:
                try:
                    _grpc_call(grpc, ch, "/user.Nope/Call", {})
                except grpc.RpcError as err:
                    return err.code().name
        finally:
            serve.stop_grpc_proxy()

    assert _twin(case) == ("ok", "NOT_FOUND")


def test_grpc_proxy_stop_joins_its_threads(serving):
    """The port's ``stop_grpc_proxy`` stops the server and joins its
    handler pool: no ``serve-grpc`` thread it started outlives it."""
    grpc = pytest.importorskip("grpc")
    before = set(_threads("serve-grpc"))
    proxy = tserve.start_grpc_proxy(port=0)
    with grpc.insecure_channel(f"127.0.0.1:{proxy.port}") as ch:
        with pytest.raises(grpc.RpcError):
            _grpc_call(grpc, ch, "/user.Nope/Call", {})
    assert set(_threads("serve-grpc")) - before
    tserve.stop_grpc_proxy()
    assert set(_threads("serve-grpc")) - before == set()


def test_grpc_proxy_without_grpc_raises_naming_it(serving, monkeypatch):
    """Where ``grpc`` does not import (hidden here), starting the proxy
    raises ImportError naming it, and the rest of serve works."""
    monkeypatch.setitem(sys.modules, "grpc", None)

    def case(rt, serve):
        try:
            serve.start_grpc_proxy(port=0)
        except ImportError as exc:
            named = "grpc" in str(exc)

        @serve.deployment
        def one():
            return 1

        return named, serve.run(one.bind()).remote().result(timeout=T)

    assert _twin(case) == ("ok", (True, 1))


def test_serve_exports_the_reference_surface():
    for name in ("batch", "multiplexed", "ingress", "deploy_config",
                 "start_grpc_proxy", "stop_grpc_proxy"):
        assert name in tserve.__all__ and callable(getattr(tserve, name))
    assert set(jserve.__all__) <= set(tserve.__all__)
