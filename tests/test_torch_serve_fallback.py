"""Twins of Serve's KV-stream fallback: ``tests/test_serve.py:331``
(closing, or exhausting, a fallback stream leaves no
``serve|stream|<id>|*`` key behind: the cancel handshake between the
consumer's ``close`` and the replica's ``handle_stream``) and
``tests/test_llm.py:470`` (closing it releases the router's in-flight
slot, once). Each case runs on each side's runtime (the reference's on
``worker_mode="thread"``); the values and the error type names must be
equal.
"""

import importlib
import time
import uuid

import pytest

import ray_tpu
import ray_tpu_torch

SIDES = ("ray_tpu", "ray_tpu_torch")
T = 30.0


def _mods(pkg):
    return (importlib.import_module(pkg),
            importlib.import_module(f"{pkg}.serve"),
            importlib.import_module(f"{pkg}.serve.handle"),
            importlib.import_module(f"{pkg}.serve.router"))


@pytest.fixture
def serving():
    for pkg in SIDES:
        rt, serve, _, _ = _mods(pkg)
        serve.shutdown()
        rt.shutdown()
    ray_tpu.init(num_cpus=4, worker_mode="thread", ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4)
    try:
        yield
    finally:
        for pkg in SIDES:
            rt, serve, _, _ = _mods(pkg)
            try:
                serve.shutdown()
            finally:
                rt.shutdown()


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 — the outcome
        return ("err", type(exc).__name__)


def _twin(case):
    out = {pkg: _outcome(lambda pkg=pkg: case(*_mods(pkg)))
           for pkg in SIDES}
    assert out["ray_tpu_torch"] == out["ray_tpu"], out
    return out["ray_tpu"]


def test_kv_fallback_stream_close_sweeps_kv_keys(serving):
    def case(rt, serve, handle_mod, _):
        @serve.deployment
        class S:
            def __call__(self, n):
                for i in range(n):
                    time.sleep(0.02)
                    yield bytes(1000)

        serve.run(S.bind())
        ctrl = serve.api.get_or_create_controller()
        w = rt._private.worker.global_worker()

        def fallback_stream(n):
            rs = ctrl._replica_set("S")
            key, replica = rs.choose()
            stream_id = uuid.uuid4().hex
            ref = replica.handle_stream.remote("__call__", (n,), {},
                                               stream_id)
            return (handle_mod._KVStreamFallbackGenerator(
                ref, rs, key, stream_id),
                f"serve|stream|{stream_id}".encode())

        def swept(prefix):
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                if not w.kv_keys(prefix):
                    return True
                time.sleep(0.05)
            return False

        gen, prefix = fallback_stream(50)
        first = next(gen)
        gen.close()
        abandoned = swept(prefix)
        gen, prefix = fallback_stream(3)
        items = list(gen)
        return (first, abandoned, len(items), swept(prefix),
                sum(ctrl._replica_set("S").queue_lengths()))

    assert _twin(case) == ("ok", (bytes(1000), True, 3, True, 0))


def test_kv_fallback_stream_close_releases_slot(serving):
    class _StubRef:
        pass

    def case(rt, serve, handle_mod, router):
        rs = router.ReplicaSet()
        rs.update([object()])
        key, _ = rs.choose()
        before = rs.queue_lengths()
        gen = handle_mod._KVStreamFallbackGenerator(_StubRef(), rs, key,
                                                    "stream-x")
        gen.close()
        once = rs.queue_lengths()
        gen.close()
        return before, once, rs.queue_lengths()

    assert _twin(case) == ("ok", ([1], [0], [0]))
