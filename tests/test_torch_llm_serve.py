"""Twin of the reference's ``test_llm_app_streaming_cancellation_and_http``
(``tests/test_serve.py``): ``build_llm_app`` served through both Serve
layers from the same parameters (the reference's ``init_params``, and
``params_from_jax`` of them for the port), a tiny f32 model on the CPU.

Token streams through ``handle.options(stream=True)`` and through the
HTTP proxy's ``?stream=1`` are equal to the reference's, exactly; the
replicas' ``prefix_digest()`` reports are equal after the same requests;
a stream closed mid-generation frees every KV block on both. Every wait
is bounded.
"""

import dataclasses
import json
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu.llm as jllm
import ray_tpu.models as jm
import ray_tpu.serve as jserve
import ray_tpu_torch
import ray_tpu_torch.llm as tllm
import ray_tpu_torch.serve as tserve
from ray_tpu_torch import models as tm

T = 60.0
MODEL = jm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=48,
                             dtype=jnp.float32)
PORT_MODEL = tm.TransformerConfig(
    **{f.name: getattr(MODEL, f.name) for f in dataclasses.fields(MODEL)
       if f.name != "dtype"}, dtype=torch.float32)
ENGINE = dict(num_blocks=128, block_size=4, max_num_seqs=4)
PROMPTS = [[1, 2, 3], list(range(1, 14)), list(range(1, 14)) + [20, 21],
           [7] * 9]
NEW_TOKENS = 6


@pytest.fixture
def apps():
    """Both runtimes, each serving its LLM app from the same weights."""
    for rt, serve in ((ray_tpu, jserve), (ray_tpu_torch, tserve)):
        serve.shutdown()
        rt.shutdown()
    jp = jm.init_params(MODEL, jax.random.PRNGKey(0))
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                            PORT_MODEL, device="cpu")
    ray_tpu.init(num_cpus=4, worker_mode="thread", ignore_reinit_error=True)
    ray_tpu_torch.init(num_cpus=4)
    try:
        ref = jserve.run(jllm.build_llm_app(
            jllm.EngineConfig(model=MODEL, **ENGINE), params=jp))
        port = tserve.run(tllm.build_llm_app(
            tllm.EngineConfig(model=PORT_MODEL, device="cpu", **ENGINE),
            params=tp))
        yield ref, port
    finally:
        for rt, serve in ((ray_tpu, jserve), (ray_tpu_torch, tserve)):
            try:
                serve.shutdown()
            finally:
                rt.shutdown()


def _stream(handle, prompt, n=NEW_TOKENS):
    return list(handle.options(stream=True).remote(
        {"prompt": prompt, "max_new_tokens": n}))


def _http_stream(serve, prompt, n=NEW_TOKENS):
    from importlib import import_module

    http = import_module(serve.__name__ + ".http")
    proxy = http.start_proxy(port=0)
    try:
        url = f"http://{proxy.host}:{proxy.port}/llm?stream=1"
        req = urllib.request.Request(url, data=json.dumps(
            {"prompt": prompt, "max_new_tokens": n}).encode())
        with urllib.request.urlopen(req, timeout=T) as resp:
            return [json.loads(x) for x in resp.read().split() if x]
    finally:
        http.stop_proxy()


def _cancel_frees_blocks(handle):
    gen = handle.options(stream=True).remote(
        {"prompt": [5, 6, 7, 8], "max_new_tokens": 400})
    first = next(gen)
    busy = handle.stats.remote().result(timeout=T)["blocks_in_use"]
    gen.close()
    deadline = time.monotonic() + T
    while time.monotonic() < deadline:
        st = handle.stats.remote().result(timeout=T)
        if st["blocks_in_use"] == 0 and st["running"] == 0:
            break
        time.sleep(0.05)
    return first, busy, st["blocks_in_use"], st["running"]


def test_streams_http_cancellation_and_digests_match_the_reference(apps):
    ref, port = apps
    want = [_stream(ref, p) for p in PROMPTS]
    got = [_stream(port, p) for p in PROMPTS]
    assert got == want
    assert all(len(t) == NEW_TOKENS and all(isinstance(x, int) for x in t)
               for t in got)
    # Determinism across the serving stack: same request, same tokens.
    assert _stream(port, PROMPTS[0]) == want[0]

    # The replicas' cached-prefix reports after the same requests.
    ref_digest = ref.prefix_digest.remote().result(timeout=T)
    port_digest = port.prefix_digest.remote().result(timeout=T)
    assert port_digest == ref_digest
    assert port_digest["digests"]

    # A stream closed after its first token frees its blocks on both.
    ref_cancel = _cancel_frees_blocks(ref)
    port_cancel = _cancel_frees_blocks(port)
    assert port_cancel[0] == ref_cancel[0]
    for first, busy, left, running in (ref_cancel, port_cancel):
        assert busy > 0
        assert (left, running) == (0, 0), (
            "cancelled stream did not free its KV blocks")

    # Chunked HTTP gives the handle's tokens, on both.
    assert _http_stream(tserve, PROMPTS[1]) == want[1]
    assert _http_stream(jserve, PROMPTS[1]) == want[1]


def test_concurrent_streams_match_sequential(apps):
    ref, port = apps
    want = [_stream(ref, p) for p in PROMPTS]
    gens = [port.options(stream=True).remote(
        {"prompt": p, "max_new_tokens": NEW_TOKENS}) for p in PROMPTS]
    got = [list(g) for g in gens]
    assert got == want


def test_port_app_shutdown_stops_its_engine():
    """serve.shutdown calls the replica's shutdown(): the engine's step
    loop ends, and no thread of the app is left after the runtime's
    shutdown."""
    import threading

    ray_tpu_torch.shutdown()
    before = set(threading.enumerate())
    ray_tpu_torch.init(num_cpus=2)
    try:
        handle = tserve.run(tllm.build_llm_app(tllm.EngineConfig(
            model=PORT_MODEL, device="cpu", **ENGINE)))
        assert len(_stream(handle, PROMPTS[0])) == NEW_TOKENS
        engines = tllm.live_engines()
        assert engines
        tserve.shutdown()
        loop = engines[-1]._loop_thread
        assert loop is not None and not loop.is_alive()
    finally:
        ray_tpu_torch.shutdown()
    assert [t for t in threading.enumerate()
            if t not in before and t.is_alive()] == []
