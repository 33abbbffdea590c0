"""Parity of the PyTorch port's LLM engine (ray_tpu_torch.llm) with the JAX
reference engine (ray_tpu.llm), on the CPU.

Both engines serve the same f32 model (test_llm.py's MODEL, GQA) from the
same weights, converted through ``params_from_jax``, with the same engine
config. Greedy streams must be token-identical, and the block manager's
counters must agree.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.llm as jllm
import ray_tpu.models as jm
import ray_tpu_torch.llm as tllm
from ray_tpu_torch import models as tm

# The suite runs in several worker processes on one machine: one intra-op
# thread per process keeps these tests from starving the timing-sensitive
# engine tests that run beside them.
torch.set_num_threads(1)

MODEL = jm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=48,
                             dtype=jnp.float32)
PORT_MODEL = tm.TransformerConfig(
    **{f.name: getattr(MODEL, f.name) for f in dataclasses.fields(MODEL)
       if f.name != "dtype"}, dtype=torch.float32)
ENGINE = dict(num_blocks=48, block_size=4, max_num_seqs=4,
              prefill_token_budget=256, max_queued_requests=16)


@pytest.fixture(scope="module")
def params():
    jp = jm.init_params(MODEL, jax.random.PRNGKey(0))
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                            PORT_MODEL, device="cpu")
    return jp, tp


def _engines(params, **over):
    jp, tp = params
    cfg = dict(ENGINE, **over)
    je = jllm.InferenceEngine(jllm.EngineConfig(model=MODEL, **cfg),
                              params=jp)
    te = tllm.InferenceEngine(
        tllm.EngineConfig(model=PORT_MODEL, device="cpu", **cfg), params=tp)
    return je, te


def _poll(predicate, timeout_s=20.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def _drain(req, timeout_s=60.0):
    out = []
    while True:
        item = req.output_queue.get(timeout=timeout_s)
        if isinstance(item, tuple):
            return out
        out.append(item)


def test_concurrent_requests_match_sequential_and_reference(params):
    """Twin of test_concurrent_requests_match_sequential_greedy: the
    port's concurrent streams equal its sequential ones, and both equal
    the reference engine's."""
    prompts = [[1, 2, 3], [4, 5, 6, 7, 8], [9], [10, 11],
               [12, 13, 14, 15], [16, 17]]
    lens = [6, 9, 4, 8, 5, 7]
    je, te = _engines(params)
    reference = [list(je.generate(p, max_new_tokens=n))
                 for p, n in zip(prompts, lens)]
    je.shutdown()
    sequential = []
    for p, n in zip(prompts, lens):
        sequential.append(list(te.generate(p, max_new_tokens=n)))
        assert te.wait_idle(30)

    concurrent = [None] * len(prompts)

    def consume(i):
        concurrent[i] = list(te.generate(prompts[i], max_new_tokens=lens[i]))

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert sequential == reference
    assert concurrent == sequential
    st = te.stats()
    assert st["blocks_in_use"] == 0 and st["running"] == 0
    te.shutdown()


def test_fully_cached_prompt_copies_on_write_like_reference(params):
    """Twin of test_fully_cached_prompt_copies_on_write: the second
    request's whole prompt is cached, its last position writes into the
    shared tail block, which copies on write while the donor keeps
    decoding. Streams and counters match the reference engine."""
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]  # exactly 2 full blocks (bs 4)
    donor_tokens = 12
    results = {}
    for name, engine in zip(("jax", "torch"), _engines(params)):
        # Hold the step lock across the donor's prefill step and the second
        # submit, so the second request is admitted at the next step while
        # the donor still holds the shared blocks, however fast the engine
        # decodes. (The background loop blocks on the lock meanwhile.)
        with engine._lock:
            donor = engine.submit(prompt, max_new_tokens=donor_tokens)
            assert engine.step() and len(donor.out_tokens) == 1
            second = engine.submit(prompt, max_new_tokens=5)
        out2 = _drain(second)
        st = engine.stats()
        out1 = _drain(donor)
        assert _poll(lambda: engine.stats()["blocks_in_use"] == 0)
        results[name] = (out1, out2, st["cow_copies"],
                         st["prefill_tokens_saved"], st["prefix_cache_hits"])
        engine.shutdown()
    assert results["torch"] == results["jax"]
    out1, out2, cow, saved, _ = results["torch"]
    assert cow >= 1 and saved == len(prompt) - 1

    # The donor stream is the one an uncached engine produces.
    _, ref = _engines(params, enable_prefix_caching=False)
    assert list(ref.generate(prompt, max_new_tokens=donor_tokens)) == out1
    assert ref.wait_idle(30)
    assert list(ref.generate(prompt, max_new_tokens=5)) == out2
    ref.shutdown()


def test_chunked_prefill_small_budget_matches_reference(params):
    """Twin of test_chunked_prefill_bounds_batch_stall: a prompt four
    times the prefill budget runs as chunks across iterations while a
    short request keeps decoding; tokens equal the reference engine's
    and a one-shot prefill's."""
    budget = 8
    long_prompt = list(range(1, 33))
    results = {}
    stats = {}
    for name, engine in zip(("jax", "torch"), _engines(
            params, prefill_token_budget=budget, num_blocks=64)):
        # Under the step lock: the short request prefills and decodes once,
        # then the long one arrives while it still has 28 tokens to go, so
        # the long prompt's chunks are co-scheduled with its decodes however
        # fast the engine steps.
        with engine._lock:
            short = engine.submit([9, 8, 7], max_new_tokens=30)
            assert engine.step() and engine.step()
            assert len(short.out_tokens) == 2
            r_long = engine.submit(long_prompt, max_new_tokens=4)
        results[name] = (_drain(r_long), _drain(short))
        stats[name] = engine.stats()
        engine.shutdown()
    assert results["torch"] == results["jax"]
    st = stats["torch"]
    assert st["max_prefill_tokens_per_step"] <= budget
    assert st["prefill_chunks_scheduled"] >= 5
    assert st["coscheduled_steps"] >= 3

    _, one_shot = _engines(params, enable_prefix_caching=False)
    assert list(one_shot.generate(long_prompt, max_new_tokens=4)) == \
        results["torch"][0]
    one_shot.shutdown()


def test_seeded_sampling_matches_reference(params):
    """Host-side numpy sampling is unchanged, so a seeded temperature
    stream is the reference's (f32 logits agree to ~1e-6)."""
    je, te = _engines(params)
    kw = dict(max_new_tokens=8, temperature=0.8, seed=1234)
    want = list(je.generate([5, 6, 7], **kw))
    got = list(te.generate([5, 6, 7], **kw))
    je.shutdown()
    te.shutdown()
    assert got == want


@pytest.mark.parametrize("make", ["jax", "torch"])
def test_block_manager_allocate_free_accounting(make):
    """Twin of test_llm.py's block-manager test, run on both caches."""
    if make == "jax":
        cache = jllm.PagedKVCache(MODEL, num_blocks=9, block_size=4)
    else:
        cache = tllm.PagedKVCache(PORT_MODEL, num_blocks=9, block_size=4,
                                  device="cpu")
    assert cache.usable_blocks == 8  # block 0 is NULL
    assert cache.allocate(1, 10)     # 3 blocks
    assert cache.blocks_in_use == 3
    assert not cache.allocate(2, 40)  # 10 blocks > 5 free: parks
    assert cache.blocks_in_use == 3
    assert cache.ensure_slot(1, 12)  # grows to 4 blocks
    assert cache.blocks_in_use == 4
    table = cache.table(1)
    assert len(set(table)) == 4 and 0 not in table
    assert cache.free(1) == 4
    assert cache.blocks_in_use == 0
    assert cache.total_blocks_freed == 4
    assert cache.free(1) == 0  # idempotent


def test_cow_block_copy_moves_every_layer_in_place():
    cache = tllm.PagedKVCache(PORT_MODEL, num_blocks=6, block_size=4,
                              device="cpu")
    k_pool = cache.data["k"]
    k_pool[:, 2] = torch.randn(k_pool[:, 2].shape)
    cache.data["v"][:, 2] = 3.0
    cache._copy_block_data(2, 4)
    assert cache.data["k"] is k_pool  # updated in place, not replaced
    torch.testing.assert_close(k_pool[:, 4], k_pool[:, 2], atol=0, rtol=0)
    assert bool((cache.data["v"][:, 4] == 3.0).all())


def test_scheduler_waitqueue_bound():
    cache = tllm.PagedKVCache(PORT_MODEL, num_blocks=9, block_size=4,
                              device="cpu")
    sched = tllm.Scheduler(cache, max_queued_requests=2)
    sched.submit(tllm.Request([1], 4))
    sched.submit(tllm.Request([1], 4))
    with pytest.raises(tllm.EngineQueueFull):
        sched.submit(tllm.Request([1], 4))


@pytest.mark.parametrize("over", [dict(tp_size=2), dict(spec_k=2)])
def test_unported_engine_options_raise(params, over):
    with pytest.raises(NotImplementedError):
        tllm.InferenceEngine(tllm.EngineConfig(
            model=PORT_MODEL, device="cpu", **ENGINE, **over),
            params=params[1])


def test_hold_after_prefill_raises(params):
    _, te = _engines(params)
    with pytest.raises(NotImplementedError):
        te.submit([1, 2], max_new_tokens=2, hold_after_prefill=True)
    te.shutdown()
