"""Parity of the PyTorch port's KV shipping with the JAX reference, on the
CPU: aux pools on copy-on-write, ``export_blocks`` / ``graft_blocks``, and
the engine's hold/adopt protocol (the engine side of disaggregated
prefill/decode).

Both engines serve test_torch_engine.py's f32 GQA model from the same
weights (the draft's too), converted through ``params_from_jax``. Every
continuation must equal a colocated run of the same request, on the port
and on the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.llm as jllm
import ray_tpu.models as jm
import ray_tpu_torch.llm as tllm
from ray_tpu_torch import models as tm

# One intra-op thread per test process (the suite runs several workers).
torch.set_num_threads(1)

CACHE_ATOL = 1e-5   # tests/test_torch_transformer.py's limit

MODEL = jm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=48,
                             dtype=jnp.float32)
DRAFT = jm.draft_config(MODEL)
ENGINE = dict(num_blocks=48, block_size=4, max_num_seqs=4,
              prefill_token_budget=256, max_queued_requests=16)
PROMPT = [5, 6, 7, 8, 9, 10, 11]


def _port_cfg(cfg, dtype=torch.float32):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = dtype
    return tm.TransformerConfig(**fields)


PORT_MODEL = _port_cfg(MODEL)
PORT_DRAFT = _port_cfg(DRAFT)


def _convert(jp, cfg):
    return tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                              _port_cfg(cfg), device="cpu")


@pytest.fixture(scope="module")
def params():
    jp = jm.init_params(MODEL, jax.random.PRNGKey(0))
    jd = jm.init_params(DRAFT, jax.random.PRNGKey(1))
    return jp, _convert(jp, MODEL), jd, _convert(jd, DRAFT)


def _jax_engine(params, spec=False):
    jp, _, jd, _ = params
    kw = dict(spec_k=3, draft_model=DRAFT) if spec else {}
    return jllm.InferenceEngine(jllm.EngineConfig(model=MODEL, **ENGINE, **kw),
                                params=jp, draft_params=jd if spec else None)


def _port_engine(params, spec=False, **over):
    _, tp, _, td = params
    kw = dict(spec_k=3, draft_model=PORT_DRAFT) if spec else {}
    return tllm.InferenceEngine(
        tllm.EngineConfig(model=PORT_MODEL, device="cpu",
                          **dict(ENGINE, **over), **kw),
        params=tp, draft_params=td if spec else None)


def _drain_finished(req, timeout_s=60.0):
    out = []
    while True:
        item = req.output_queue.get(timeout=timeout_s)
        if isinstance(item, tuple):
            kind, payload = item
            assert kind == "__done__" and payload == "FINISHED", item
            return out
        out.append(item)


def _hold(engine, prompt, max_new_tokens=1):
    """Prefill ``prompt`` with hold_after_prefill; returns (request, its
    first token)."""
    held = engine.submit(prompt, max_new_tokens=max_new_tokens,
                         hold_after_prefill=True)
    out = _drain_finished(held)
    return held, out[0]


def _colocated(engine, prompt=PROMPT, n=8):
    out = list(engine.generate(prompt, max_new_tokens=n))
    engine.shutdown()
    return out


def _payload_from_jax(payload):
    """The reference's numpy payload as the port's CPU tensors."""
    out = dict(payload)
    for name in ("k", "v"):
        if name in payload:
            out[name] = torch.from_numpy(np.array(payload[name]))
    out["aux"] = {a: {n: torch.from_numpy(np.array(p[n])) for n in ("k", "v")}
                  for a, p in payload.get("aux", {}).items()}
    return out


def test_cow_block_copy_moves_aux_pool_in_place():
    """Twin of test_cow_block_copy_moves_every_layer_in_place with an aux
    pool of another config: the copy moves every pool, in place."""
    cache = tllm.PagedKVCache(PORT_MODEL, num_blocks=6, block_size=4,
                              device="cpu")
    cache.attach_aux("draft", PORT_DRAFT)
    with pytest.raises(ValueError):
        cache.attach_aux("draft", PORT_DRAFT)
    aux = cache.aux_data("draft")
    k_pool, ak_pool = cache.data["k"], aux["k"]
    assert tuple(ak_pool.shape) == (PORT_DRAFT.n_layers, 6, 4,
                                    PORT_DRAFT.n_kv_heads,
                                    PORT_DRAFT.head_dim)
    k_pool[:, 2] = torch.randn(k_pool[:, 2].shape)
    ak_pool[:, 2] = torch.randn(ak_pool[:, 2].shape)
    aux["v"][:, 2] = 5.0
    cache._copy_block_data(2, 4)
    assert cache.data["k"] is k_pool and cache.aux_data("draft")["k"] is \
        ak_pool
    torch.testing.assert_close(k_pool[:, 4], k_pool[:, 2], atol=0, rtol=0)
    torch.testing.assert_close(ak_pool[:, 4], ak_pool[:, 2], atol=0, rtol=0)
    assert bool((aux["v"][:, 4] == 5.0).all())
    assert cache.stats()["aux_pools"] == ["draft"]


def test_fully_cached_prompt_on_spec_engine_copies_aux_on_write(params):
    """A fully cached prompt on a spec engine copies its boundary block
    on write while the donor still holds it: the draft pool's copy equals
    the donor's block, and both streams equal the reference engine's."""
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]  # exactly 2 full blocks (bs 4)
    results = {}
    for name, engine in (("jax", _jax_engine(params, spec=True)),
                         ("torch", _port_engine(params, spec=True))):
        with engine._lock:
            donor = engine.submit(prompt, max_new_tokens=12)
            assert engine.step() and len(donor.out_tokens) == 1
            second = engine.submit(prompt, max_new_tokens=5)
            assert engine.step()
            if name == "torch":
                src = engine.cache.table(donor.seq_id)[1]
                dst = engine.cache.table(second.seq_id)[1]
                assert src != dst
                for pool in (engine.cache.data,
                             engine.cache.aux_data("draft")):
                    for n in ("k", "v"):
                        # Slots 0-2 were copied; slot 3 the second
                        # request wrote itself.
                        torch.testing.assert_close(
                            pool[n][:, dst, :3], pool[n][:, src, :3],
                            atol=0, rtol=0)
        out2 = _drain_finished(second)
        out1 = _drain_finished(donor)
        assert engine.wait_idle(30)
        st = engine.stats()
        results[name] = (out1, out2, st["cow_copies"])
        engine.shutdown()
    assert results["torch"] == results["jax"]
    assert results["torch"][2] >= 1


def test_export_payload_matches_reference(params):
    """After the same held prefill on a spec-armed engine of each side,
    the exported payload has the reference's keys and counts, and its
    K/V (flagship and draft pools) match at CACHE_ATOL."""
    payloads = {}
    for name, engine in (("jax", _jax_engine(params, spec=True)),
                         ("torch", _port_engine(params, spec=True))):
        held, first = _hold(engine, PROMPT)
        payloads[name] = (engine.cache.export_blocks(held.seq_id, 0),
                          engine.cache.export_blocks(held.seq_id, 1), first)
        assert engine.cache.stats()["blocks_exported"] == 2 + 1
        engine.shutdown()
    for want, got in zip(payloads["jax"][:2], payloads["torch"][:2]):
        assert set(got) == set(want)
        for key in ("start_block", "blocks", "block_size"):
            assert got[key] == want[key]
        assert set(got["aux"]) == set(want["aux"]) == {"draft"}
        for w, g in [(want, got), (want["aux"]["draft"],
                                   got["aux"]["draft"])]:
            for n in ("k", "v"):
                assert isinstance(g[n], torch.Tensor)
                assert g[n].device.type == "cpu"
                assert tuple(g[n].shape) == np.asarray(w[n]).shape
                np.testing.assert_allclose(g[n].numpy(), np.asarray(w[n]),
                                           atol=CACHE_ATOL)
    assert payloads["torch"][2] == payloads["jax"][2]


def test_hold_after_prefill_and_release_accounting(params):
    """Twin of test_llm.py's test of the same name: a held sequence keeps
    its KV past FINISHED; release_held frees it, idempotently, and
    shutdown sweeps whatever is still held. The first token equals the
    reference engine's."""
    je = _jax_engine(params)
    _, want_first = _hold(je, list(range(1, 9)))
    je.shutdown()
    engine = _port_engine(params)
    prompt = list(range(1, 9))
    req, first = _hold(engine, prompt)
    assert first == want_first
    assert engine.held_count() == 1
    assert engine.stats()["held_sequences"] == 1
    assert engine.cache.stats()["blocks_in_use"] > 0
    payload = engine.cache.export_blocks(req.seq_id, start_block=0)
    assert payload["blocks"] > 0
    assert engine.release_held(req.seq_id) > 0
    assert engine.release_held(req.seq_id) == 0  # idempotent
    assert engine.held_count() == 0
    assert engine.cache.stats()["blocks_in_use"] == 0
    _hold(engine, prompt)
    assert engine.held_count() == 1
    engine.shutdown()
    assert engine.held_count() == 0
    assert engine.cache.stats()["blocks_in_use"] == 0


def test_kv_export_graft_adopt_continuation_parity(params):
    """Twin of test_llm.py's test of the same name: prefill on engine A
    (held), export, adopt on engine B (graft + commit); B's tokens equal
    a colocated run, on the port and on the reference. Full ship, cached
    prefix adoption and tail-only ship; zero leaked blocks on both
    sides."""
    ref = _colocated(_port_engine(params))
    assert ref == _colocated(_jax_engine(params))
    pre, dec = _port_engine(params), _port_engine(params)

    held, first = _hold(pre, PROMPT)
    payload = pre.cache.export_blocks(held.seq_id, start_block=0)
    areq = dec.begin_adopted(PROMPT, max_new_tokens=8)
    assert areq is not None and areq.cached_prompt_tokens == 0
    assert dec.adopt_kv(areq, payload)
    blocks, nbytes = areq.kv_ship
    assert blocks == payload["blocks"]
    assert nbytes == 2 * payload["k"].numel() * 4
    dec.commit_adopted(areq, first)
    assert _drain_finished(areq) == ref
    decomp = dec.ttft_decomposition()
    assert decomp["transfer_p50_s"] is not None
    assert decomp["transfer_p50_s"] >= 0

    areq2 = dec.begin_adopted(PROMPT, max_new_tokens=8)
    assert areq2 is not None and areq2.cached_prompt_tokens > 0
    assert dec.adopt_kv(areq2, payload)
    dec.commit_adopted(areq2, first)
    assert _drain_finished(areq2) == ref

    held3, f3 = _hold(pre, PROMPT)
    areq3 = dec.begin_adopted(PROMPT, max_new_tokens=8)
    graft_from = areq3.cached_prompt_tokens // dec.cache.block_size
    assert graft_from > 0
    tail = pre.cache.export_blocks(held3.seq_id, start_block=graft_from)
    assert tail["blocks"] < payload["blocks"]
    pre.release_held(held3.seq_id)
    assert dec.adopt_kv(areq3, tail)
    dec.commit_adopted(areq3, f3)
    assert _drain_finished(areq3) == ref

    pre.release_held(held.seq_id)
    assert dec.wait_idle(30)
    assert pre.cache.stats()["blocks_in_use"] == 0
    assert dec.cache.stats()["blocks_in_use"] == 0
    assert pre.cache.stats()["blocks_exported"] > 0
    assert dec.cache.stats()["blocks_grafted"] > 0
    pre.shutdown()
    dec.shutdown()


def test_adopt_kv_refuses_stale_plan_and_aborts_clean(params):
    """Twin of test_llm.py's test of the same name: a payload exported
    past the decode side's cached boundary is refused, the caller aborts,
    and nothing leaks; a graft onto a shared block raises."""
    pre, dec = _port_engine(params), _port_engine(params)
    held, _ = _hold(pre, PROMPT)
    payload = pre.cache.export_blocks(held.seq_id, start_block=1)
    areq = dec.begin_adopted(PROMPT, max_new_tokens=8)
    assert areq is not None
    assert not dec.adopt_kv(areq, payload)
    dec.abort_adopted(areq)
    assert dec.cache.stats()["blocks_in_use"] == 0
    assert dec.stats()["running"] == 0
    # The prefill side's own held blocks are registered: a graft there
    # would corrupt the prefix cache, so it raises.
    with pytest.raises(ValueError, match="shared or registered"):
        pre.cache.graft_blocks(held.seq_id,
                               pre.cache.export_blocks(held.seq_id))
    pre.release_held(held.seq_id)
    assert pre.cache.stats()["blocks_in_use"] == 0
    pre.shutdown()
    dec.shutdown()


def test_graft_from_reference_export_continues_like_reference(params):
    """Across implementations: the reference engine prefills and exports,
    the test converts the numpy payload to CPU tensors, the port's engine
    adopts it, and its continuation equals the reference's colocated
    run."""
    ref = _colocated(_jax_engine(params))
    pre = _jax_engine(params)
    held, first = _hold(pre, PROMPT)
    payload = _payload_from_jax(
        pre.cache.export_blocks(held.seq_id, start_block=0))
    dec = _port_engine(params)
    areq = dec.begin_adopted(PROMPT, max_new_tokens=8)
    assert dec.adopt_kv(areq, payload)
    dec.commit_adopted(areq, first)
    assert _drain_finished(areq) == ref
    pre.release_held(held.seq_id)
    assert dec.wait_idle(30)
    assert dec.cache.stats()["blocks_in_use"] == 0
    pre.shutdown()
    dec.shutdown()


def test_spec_armed_ship_carries_draft_pool(params):
    """Full ship between spec-armed engines: the draft's aux pool ships
    too, and the adopted continuation (spec rounds on grafted KV) equals
    a colocated spec engine's, vanilla's and the reference's. The spec
    counters equal the colocated spec engine's."""
    colo = _port_engine(params, spec=True)
    ref = list(colo.generate(PROMPT, max_new_tokens=8))
    colo_spec = colo.stats()["spec"]
    colo.shutdown()
    assert ref == _colocated(_port_engine(params))
    assert ref == _colocated(_jax_engine(params, spec=True))
    pre, dec = _port_engine(params, spec=True), _port_engine(params,
                                                             spec=True)
    held, first = _hold(pre, PROMPT)
    payload = pre.cache.export_blocks(held.seq_id)
    assert set(payload["aux"]) == {"draft"}
    areq = dec.begin_adopted(PROMPT, max_new_tokens=8)
    assert dec.adopt_kv(areq, payload)
    d_k = payload["aux"]["draft"]["k"]
    assert areq.kv_ship[1] == 2 * (payload["k"].numel()
                                   + d_k.numel()) * 4
    table = dec.cache.table(areq.seq_id)[:payload["blocks"]]
    torch.testing.assert_close(dec.cache.aux_data("draft")["k"][:, table],
                               d_k, atol=0, rtol=0)
    dec.commit_adopted(areq, first)
    assert _drain_finished(areq) == ref
    spec = dec.stats()["spec"]
    for key in ("proposed", "accepted", "emitted", "rounds"):
        assert spec[key] == colo_spec[key], key
    pre.release_held(held.seq_id)
    assert dec.wait_idle(30)
    for e in (pre, dec):
        assert e.cache.stats()["blocks_in_use"] == 0
        e.shutdown()


def test_hold_request_finishing_in_a_spec_round_is_held(params):
    """A hold_after_prefill request whose budget ends inside a spec round
    is held, not freed, as on the reference."""
    results = {}
    for name, engine in (("jax", _jax_engine(params, spec=True)),
                         ("torch", _port_engine(params, spec=True))):
        held = engine.submit(PROMPT, max_new_tokens=6,
                             hold_after_prefill=True)
        out = _drain_finished(held)
        st = engine.stats()
        assert st["spec"]["rounds"] > 0
        results[name] = (out, engine.held_count(),
                         engine.cache.stats()["blocks_in_use"] > 0)
        assert engine.release_held(held.seq_id) > 0
        engine.shutdown()
    assert results["torch"] == results["jax"]
    assert results["torch"][1:] == (1, True)


def test_bf16_payload_ships_exactly():
    """bf16 has no numpy dtype: the payload carries bf16 CPU tensors, and
    a bf16 continuation after the graft equals the colocated bf16 run."""
    cfg = dataclasses.replace(PORT_MODEL, dtype=torch.bfloat16)
    p = tm.init_params(cfg, 0, device="cpu")

    def engine():
        return tllm.InferenceEngine(tllm.EngineConfig(
            model=cfg, device="cpu", **ENGINE), params=p)

    ref = _colocated(engine())
    pre, dec = engine(), engine()
    held, first = _hold(pre, PROMPT)
    payload = pre.cache.export_blocks(held.seq_id)
    assert payload["k"].dtype == torch.bfloat16
    areq = dec.begin_adopted(PROMPT, max_new_tokens=8)
    assert dec.adopt_kv(areq, payload)
    assert areq.kv_ship[1] == 2 * payload["k"].numel() * 2
    table = dec.cache.table(areq.seq_id)[:payload["blocks"]]
    torch.testing.assert_close(dec.cache.data["k"][:, table], payload["k"],
                               atol=0, rtol=0)
    dec.commit_adopted(areq, first)
    assert _drain_finished(areq) == ref
    pre.release_held(held.seq_id)
    assert dec.wait_idle(30)
    for e in (pre, dec):
        assert e.cache.stats()["blocks_in_use"] == 0
        e.shutdown()
