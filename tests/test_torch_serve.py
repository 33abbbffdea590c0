"""Twins of Serve: the reference's own Serve behaviours (``tests/
test_serve.py``) through both Serve layers, the reference's on its thread
plane (``ray_tpu.init(num_cpus=4, worker_mode="thread")``) and the
port's (``ray_tpu_torch.init(num_cpus=4)``), give the same results; and
the router (``ReplicaSet.choose`` / ``plan_prefix``) makes the same
choices on the same digests.

Every wait is bounded (``result(timeout=)``, an ``Event`` with a
timeout); nothing asserts on wall-clock time.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu
import ray_tpu.serve as jserve
import ray_tpu_torch
import ray_tpu_torch.serve as tserve
from ray_tpu.llm.kv_cache import chain_digests as j_chain_digests
from ray_tpu.serve.router import ReplicaSet as JReplicaSet
from ray_tpu_torch.llm.kv_cache import chain_digests as t_chain_digests
from ray_tpu_torch.serve.router import ReplicaSet as TReplicaSet

T = 30.0

SIDES = ((ray_tpu, jserve), (ray_tpu_torch, tserve))


@pytest.fixture
def serving():
    for rt, serve in SIDES:
        serve.shutdown()
        rt.shutdown()
    ray_tpu.init(num_cpus=4, worker_mode="thread", ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4)
    try:
        yield
    finally:
        for rt, serve in SIDES:
            try:
                serve.shutdown()
            finally:
                rt.shutdown()


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


def _class_deployment(rt, serve):
    @serve.deployment
    class Doubler:
        def __call__(self, x):
            return x * 2

    handle = serve.run(Doubler.bind())
    return [handle.remote(i).result(timeout=T) for i in (21, -3)]


def _function_deployment(rt, serve):
    @serve.deployment
    def greet(name):
        return f"hello {name}"

    return serve.run(greet.bind()).remote("gpu").result(timeout=T)


def _method_calls_init_args(rt, serve):
    @serve.deployment
    class Counter:
        def __init__(self, start, step=1):
            self.n = start
            self.step = step

        def incr(self, k):
            self.n += k * self.step
            return self.n

        def read(self):
            return self.n

    handle = serve.run(Counter.bind(10, step=3))
    first = handle.incr.remote(5).result(timeout=T)
    second = handle.options("incr").remote(1).result(timeout=T)
    return first, second, handle.read.remote().result(timeout=T)


def _composition(rt, serve):
    @serve.deployment
    class Embed:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class Pipeline:
        def __init__(self, embed):
            self.embed = embed

        def __call__(self, x):
            inner = self.embed.remote(x)      # DeploymentResponse chains
            return self.embed.remote(inner).result(timeout=T) * 10

    handle = serve.run(Pipeline.bind(Embed.bind()))
    return [handle.remote(i).result(timeout=T) for i in (1, 5)]


def _stream(rt, serve):
    @serve.deployment
    class Tokens:
        def __call__(self, n):
            for i in range(n):
                yield {"i": i, "sq": i * i}

    handle = serve.run(Tokens.bind())
    gen = handle.options(stream=True).remote(4)
    items = list(gen)
    early = handle.options(stream=True).remote(100)
    first = next(early)
    early.close()
    return items, first


def _stream_error(rt, serve):
    @serve.deployment
    class Bad:
        def __call__(self):
            yield 1
            raise ValueError("mid-stream")

    gen = serve.run(Bad.bind()).options(stream=True).remote()
    out = [next(gen)]
    try:
        next(gen)
    except ValueError as exc:
        out.append(type(exc).__name__)
    return out


def _shedding(rt, serve):
    release = threading.Event()
    entered = threading.Event()

    @serve.deployment(max_ongoing_requests=1)
    class Slow:
        def __call__(self, x):
            entered.set()
            release.wait(T)
            return x

    handle = serve.run(Slow.bind())
    first = handle.remote(1)
    try:
        assert entered.wait(T)
        try:
            handle.remote(2)
            shed = None
        except rt.exceptions.RequestSheddedError as exc:
            shed = (type(exc).__name__, exc.priority)
    finally:
        release.set()
    value = first.result(timeout=T)
    # The slot is free again: the next request is admitted.
    again = handle.remote(3).result(timeout=T)
    adm = serve.status()["Slow"]["admission"]
    return shed, value, again, adm["shed_total"], adm["max_ongoing_requests"]


def _status_and_delete(rt, serve):
    @serve.deployment(num_replicas=2)
    class Svc:
        def __call__(self):
            return "ok"

    handle = serve.run(Svc.bind())
    out = [handle.remote().result(timeout=T) for _ in range(4)]
    st = serve.status()["Svc"]
    serve.delete("Svc")
    return out, st["replicas"], st["target_replicas"], st["requests"], \
        sorted(serve.status())


def _poll(predicate):
    deadline = time.monotonic() + T
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.05)
    return False


def _scale_to_zero_and_wake(rt, serve):
    @serve.deployment(num_replicas=1, autoscaling_config={
        "min_replicas": 0, "max_replicas": 2, "upscale_delay_s": 0.1,
        "downscale_delay_s": 0.1})
    class Lazy:
        def __call__(self, x):
            return x + 100

    handle = serve.run(Lazy.bind())
    first = handle.remote(1).result(timeout=T)
    # Idle past the downscale delay: the controller drops the replica.
    drained = _poll(lambda: serve.status()["Lazy"]["replicas"] == 0)
    # The next request wakes the deployment and is served.
    woken = handle.remote(2).result(timeout=T)
    st = serve.status()["Lazy"]
    reasons = [e["reason"] for e in st["scale_events"]]
    return first, drained, woken, st["wake_events"], "wake" in reasons


def _http(rt, serve):
    from importlib import import_module

    http = import_module(serve.__name__ + ".http")
    release = threading.Event()
    entered = threading.Event()

    @serve.deployment
    class Doubler:
        def __call__(self, x):
            return x * 2

    @serve.deployment(max_ongoing_requests=1)
    class Gate:
        def __call__(self, x):
            entered.set()
            release.wait(T)
            return x

    serve.run(Doubler.bind())
    gate = serve.run(Gate.bind())
    proxy = http.start_proxy(port=0)

    def post(path, body):
        req = urllib.request.Request(
            f"http://{proxy.host}:{proxy.port}{path}",
            data=json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=T) as resp:
                return resp.status, json.loads(resp.read()), None
        except urllib.error.HTTPError as exc:
            exc.read()
            return exc.code, None, exc.headers.get("Retry-After")

    try:
        ok = post("/Doubler", 21)
        missing = post("/NoSuch", 1)
        held = gate.remote(7)
        assert entered.wait(T)
        shed = post("/Gate", 8)
        release.set()
        held_value = held.result(timeout=T)
    finally:
        release.set()
        http.stop_proxy()
    return ok, missing[0], shed[0], shed[2], held_value


CASES = {
    "scale_to_zero_and_wake": _scale_to_zero_and_wake,
    "http": _http,
    "class_deployment": _class_deployment,
    "function_deployment": _function_deployment,
    "method_calls_init_args": _method_calls_init_args,
    "composition": _composition,
    "stream": _stream,
    "stream_error": _stream_error,
    "shedding": _shedding,
    "status_and_delete": _status_and_delete,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_serve_twin(serving, name):
    _twin(CASES[name])


def test_serve_twins_see_what_they_expect(serving):
    assert _twin(_composition) == ("ok", [30, 70])
    assert _twin(_shedding) == (
        "ok", (("RequestSheddedError", 0), 1, 3, 1, 1))
    assert _twin(_stream_error) == ("ok", [1, "RayTaskError(ValueError)"])
    assert _twin(_http) == ("ok", ((200, {"result": 42}, None), 404, 503,
                                   "1", 7))
    assert _twin(_scale_to_zero_and_wake) == ("ok", (101, True, 102, 1,
                                                     True))


# ------------------------------------------------------------------ router
BLOCK = 4
PROMPTS = [
    list(range(1, 17)),                  # 4 full blocks
    list(range(1, 9)) + [40, 41, 42, 43],  # shares 2 blocks with prompt 0
    [7] * 12,
    list(range(1, 17)) + [5, 6, 7, 8],   # prompt 0 plus one block
    [9, 9],                              # under one block: no digest
]


def _replica_sets(n):
    sets = []
    for cls in (JReplicaSet, TReplicaSet):
        rs = cls()
        replicas = [object() for _ in range(n)]
        rs.update(replicas)
        sets.append((rs, replicas))
    return sets


def test_chain_digests_equal_the_reference():
    for p in PROMPTS:
        assert t_chain_digests(p, BLOCK) == j_chain_digests(p, BLOCK)


def test_replica_set_power_of_two_choices_match():
    """No digests reported: both routers draw from random.Random(0), so
    the same sequence of chooses picks the same replicas."""
    picks = []
    for rs, replicas in _replica_sets(4):
        seq = []
        keys = []
        for i in range(24):
            key, r = rs.choose(prefix_tokens=PROMPTS[i % len(PROMPTS)])
            seq.append(replicas.index(r))
            keys.append(key)
            if i % 3 == 2:
                rs.release(keys.pop(0))
        picks.append((seq, rs.queue_lengths()))
    assert picks[1] == picks[0]


def test_replica_set_prefix_routing_and_plan_match():
    """Replicas 1 and 2 report the digests of prompts 0 and 2: both
    routers send each prompt to the same replica and plan the same
    cached-prefix overlap."""
    results = []
    for (rs, replicas), digests in zip(_replica_sets(3),
                                       (j_chain_digests, t_chain_digests)):
        rs.update_prefix_digest(id(replicas[1]), BLOCK,
                                digests(PROMPTS[0], BLOCK))
        rs.update_prefix_digest(id(replicas[2]), BLOCK,
                                digests(PROMPTS[2], BLOCK))
        plans = [rs.plan_prefix(p) for p in PROMPTS]
        chosen = []
        for p in PROMPTS:
            key, r = rs.choose(prefix_tokens=p)
            chosen.append(replicas.index(r))
            rs.release(key)
        results.append((plans, chosen, rs.prefix_routed,
                        rs.prefix_overlap_tokens))
    assert results[1] == results[0]
    plans, chosen, routed, overlap = results[1]
    assert plans == [16, 8, 12, 16, 0]
    assert chosen[:4] == [1, 1, 2, 1]
    assert routed == 4 and overlap == 16 + 8 + 12 + 16


def test_replica_set_admission_matches():
    """Priority admission: class fractions of max_ongoing_requests shed
    the worst classes first, with the same counters on both routers."""
    out = []
    for rs, _ in _replica_sets(2):
        rs.configure_admission(4)
        events = []
        for prio in (0, 3, 0, 2, 1, 0, 0, 3):
            try:
                rs.choose(priority=prio)
                events.append(("in", prio))
            except Exception as exc:  # noqa: BLE001 — typed shed
                events.append((type(exc).__name__, prio,
                               exc.retry_after_s))
        out.append((events, rs.admission_stats()))
    assert out[1] == out[0]
    assert out[1][1]["shed_total"] > 0
