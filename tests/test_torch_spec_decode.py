"""Parity of the PyTorch port's speculative decoding with the JAX
reference, on the CPU: ``verify_step``, the draft helpers
(``draft_config``, ``shift_params``) and the engine's spec rounds.

Both engines serve the same f32 GQA model (test_torch_engine.py's) from
the same weights, the draft's included, converted through
``params_from_jax``: the port's default draft is drawn by its own
generator and so differs from the reference's. Greedy streams must be
token-identical to the reference engine's and to vanilla decode.
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

LOGIT_ATOL = 1e-4   # tests/test_torch_transformer.py's limits
CACHE_ATOL = 1e-5

MODEL = jm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=48,
                             dtype=jnp.float32)
ENGINE = dict(num_blocks=48, block_size=4, max_num_seqs=4,
              prefill_token_budget=256, max_queued_requests=16)


def _port_cfg(cfg, dtype=torch.float32):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = dtype
    return tm.TransformerConfig(**fields)


def _convert(jp, cfg):
    return tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                              _port_cfg(cfg), device="cpu")


PORT_MODEL = _port_cfg(MODEL)
DRAFT = jm.draft_config(MODEL)
PORT_DRAFT = _port_cfg(DRAFT)


@pytest.fixture(scope="module")
def params():
    """(jax flagship, port flagship, jax draft, port draft); the draft
    from PRNGKey(1), the reference engine's default (param_seed + 1)."""
    jp = jm.init_params(MODEL, jax.random.PRNGKey(0))
    jd = jm.init_params(DRAFT, jax.random.PRNGKey(1))
    return jp, _convert(jp, MODEL), jd, _convert(jd, DRAFT)


def _engines(params, spec_k=0, draft=True, **over):
    """A reference engine and a port engine with the same config; with
    spec_k > 0 and ``draft`` both are armed with the same draft."""
    jp, tp, jd, td = params
    cfg = dict(ENGINE, **over)
    jkw, tkw = {}, {}
    if spec_k and draft:
        jkw = dict(spec_k=spec_k, draft_model=DRAFT)
        tkw = dict(spec_k=spec_k, draft_model=PORT_DRAFT)
    elif spec_k:
        jkw = tkw = dict(spec_k=spec_k)
    je = jllm.InferenceEngine(jllm.EngineConfig(model=MODEL, **cfg, **jkw),
                              params=jp, draft_params=jd if jkw else None)
    te = tllm.InferenceEngine(
        tllm.EngineConfig(model=PORT_MODEL, device="cpu", **cfg, **tkw),
        params=tp, draft_params=td if tkw else None)
    return je, te


@pytest.mark.parametrize("kv_heads", [2, 4], ids=["gqa", "mha"])
def test_verify_step_matches_reference(kv_heads):
    """Two sequences prefilled to different lengths, then one verify
    call of C=5 tokens each (the padded batch row and columns that run
    past the second row's table included): logits at every position and
    the cache after the call match the reference's."""
    cfg = dataclasses.replace(MODEL, n_kv_heads=kv_heads)
    tcfg = _port_cfg(cfg)
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    tp = _convert(jp, cfg)
    rng = np.random.default_rng(4)
    lens = [9, 5]
    tables = np.zeros((4, 4), np.int32)
    tables[0, :4] = [5, 9, 1, 14]
    tables[1, :3] = [12, 3, 7]
    jcache = jm.init_kv_cache(cfg, 16, 4)
    tcache = tm.init_kv_cache(tcfg, 16, 4, device="cpu")
    toks = np.zeros((4, 16), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, 64, n)
    starts = np.zeros((4,), np.int32)
    chunk_lens = np.array(lens + [1, 1], np.int32)
    jl, jcache = jm.prefill_chunk(cfg, jp, jcache, jnp.asarray(toks),
                                  jnp.asarray(starts),
                                  jnp.asarray(chunk_lens),
                                  jnp.asarray(tables))
    _, tcache = tm.prefill_chunk(tcfg, tp, tcache, torch.from_numpy(toks),
                                 torch.from_numpy(starts),
                                 torch.from_numpy(chunk_lens),
                                 torch.from_numpy(tables))
    vtok = rng.integers(0, 64, (4, 5)).astype(np.int32)
    vstart = np.array([n - 1 for n in lens] + [0, 0], np.int32)
    jl, jcache = jm.verify_step(cfg, jp, jcache, jnp.asarray(vtok),
                                jnp.asarray(vstart), jnp.asarray(tables))
    tl, tcache = tm.verify_step(tcfg, tp, tcache, torch.from_numpy(vtok),
                                torch.from_numpy(vstart),
                                torch.from_numpy(tables))
    assert tl.shape == (4, 5, 64) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                               atol=LOGIT_ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name][:, 1:].numpy(),
                                   np.asarray(jcache[name])[:, 1:],
                                   atol=CACHE_ATOL)


def test_verify_step_logits_equal_sequential_decode():
    """verify_step's logit at position j equals decode_step's after
    feeding tokens 0..j one at a time (the port alone, f32)."""
    tp = _convert(jm.init_params(MODEL, jax.random.PRNGKey(0)), MODEL)
    prompt = [3, 17, 5, 9, 22, 40]
    table = torch.tensor([[7, 2, 11, 4]])
    ext = [8, 30, 1, 60]
    base = tm.init_kv_cache(PORT_MODEL, 16, 4, device="cpu")
    tm.prefill_chunk(PORT_MODEL, tp, base, torch.tensor([prompt]),
                     torch.tensor([0]), torch.tensor([len(prompt)]), table)
    seq = {n: t.clone() for n, t in base.items()}
    vl, _ = tm.verify_step(PORT_MODEL, tp, base,
                           torch.tensor([[prompt[-1]] + ext]),
                           torch.tensor([len(prompt) - 1]), table)
    for j, tok in enumerate([prompt[-1]] + ext):
        dl, seq = tm.decode_step(PORT_MODEL, tp, seq, torch.tensor([tok]),
                                 torch.tensor([len(prompt) - 1 + j]), table)
        np.testing.assert_allclose(vl[0, j].numpy(), dl[0].numpy(),
                                   atol=LOGIT_ATOL)


@pytest.mark.parametrize("overrides", [{}, {"n_layers": 3, "d_ff": 40}],
                         ids=["default", "overridden"])
def test_draft_config_matches_reference(overrides):
    for base in (MODEL, dataclasses.replace(MODEL, d_model=512, n_heads=8,
                                            n_kv_heads=8, n_layers=4)):
        want = jm.draft_config(base, **overrides)
        got = tm.draft_config(_port_cfg(base), **overrides)
        for f in dataclasses.fields(want):
            if f.name != "dtype":
                assert getattr(got, f.name) == getattr(want, f.name), f.name
        assert got.dtype == torch.float32


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32),
                                     (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_shift_params_equal_reference_leaf_for_leaf(jdt, tdt):
    cfg = jm.TransformerConfig(vocab_size=16, d_model=32, n_layers=2,
                               n_heads=4, n_kv_heads=2, d_ff=48, dtype=jdt)
    want = jax.tree_util.tree_leaves_with_path(jm.shift_params(cfg, shift=3))
    got = tm.shift_params(_port_cfg(cfg, tdt), shift=3, device="cpu")
    assert len(want) == 12
    for path, leaf in want:
        t = got
        for key in (p.key for p in path):
            t = t[key]
        ref = np.asarray(leaf.astype(jnp.float32))
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(t.float().numpy(), ref)
    with pytest.raises(ValueError):
        tm.shift_params(_port_cfg(dataclasses.replace(cfg, vocab_size=64)),
                        device="cpu")


def _run_buckets(engine, prompts, new_tokens):
    out = []
    for batch in (1, 2, 3):
        with engine._lock:
            reqs = [engine.submit(p, max_new_tokens=new_tokens)
                    for p in prompts[:batch]]
        assert engine.wait_idle(60)
        out.append([list(r.out_tokens) for r in reqs])
    return out


def test_spec_decode_greedy_parity_across_pow2_buckets(params):
    """Twin of test_llm.py's test of the same name: with a draft that
    mostly disagrees, every batch bucket (1, 2, 4 = pow2 pads of 1/2/3
    concurrent requests) gives vanilla's tokens; the port's streams and
    spec counters equal the reference engine's."""
    prompts = [[1 + (5 * i + j) % 60 for j in range(3 + 2 * i)]
               for i in range(3)]
    _, vanilla = _engines(params)
    refs = [list(vanilla.generate(p, max_new_tokens=10)) for p in prompts]
    vanilla.shutdown()
    je, te = _engines(params, spec_k=3)
    want = _run_buckets(je, prompts, 10)
    got = _run_buckets(te, prompts, 10)
    assert got == want
    for batch, streams in zip((1, 2, 3), got):
        assert streams == refs[:batch], f"diverged at batch {batch}"
    st = te.stats()["spec"]
    assert st == je.stats()["spec"]
    assert st["rounds"] > 0 and st["proposed"] > 0
    assert 0.0 <= st["acceptance_rate"] < 1.0  # random draft: low
    assert st["rounds"] <= st["emitted"] <= \
        st["accepted"] + st["rounds"] * len(prompts)
    assert st["fallback_rounds"] == 0
    je.shutdown()
    te.shutdown()


def _self_draft_engines(params, k):
    jp, tp, _, _ = params
    je = jllm.InferenceEngine(jllm.EngineConfig(
        model=MODEL, spec_k=k, draft_model=MODEL, **ENGINE), params=jp,
        draft_params=jp)
    te = tllm.InferenceEngine(tllm.EngineConfig(
        model=PORT_MODEL, spec_k=k, draft_model=PORT_MODEL, device="cpu",
        **ENGINE), params=tp, draft_params=tp)
    return je, te


def test_spec_decode_self_draft_matches_reference(params):
    """The flagship as its own draft: streams equal vanilla, and the
    acceptance counters equal the reference's. The draft's cache is
    written exactly where the reference writes it: after a fully accepted
    round the k-th proposal's slot stays unwritten in the draft's pool,
    which costs acceptance (not tokens) in both."""
    prompts = [[2, 9, 4, 33, 17], [50, 1, 8]]
    je, te = _self_draft_engines(params, 4)
    want = _run_buckets(je, prompts, 14)
    got = _run_buckets(te, prompts, 14)
    assert got == want
    _, vanilla = _engines(params)
    refs = [list(vanilla.generate(p, max_new_tokens=14)) for p in prompts]
    vanilla.shutdown()
    assert got[1] == refs
    assert te.stats()["spec"] == je.stats()["spec"]
    je.shutdown()
    te.shutdown()


def test_spec_decode_self_draft_first_round_accepts_everything(params):
    """A request's first spec round drafts from the prefill's cache,
    which a self-draft shares exactly: with k + 2 new tokens (one from
    the prefill, one round of k + 1) every proposal is accepted."""
    k = 4
    prompts = [[2, 9, 4, 33, 17], [50, 1, 8], [7] * 9]
    for engine in _self_draft_engines(params, k):
        with engine._lock:
            reqs = [engine.submit(p, max_new_tokens=k + 2) for p in prompts]
        assert engine.wait_idle(60)
        assert all(len(r.out_tokens) == k + 2 for r in reqs)
        st = engine.stats()["spec"]
        assert st["acceptance_rate"] == 1.0
        assert st["proposed"] == k * len(prompts)
        engine.shutdown()


def test_spec_decode_padded_verify_columns_never_touch_live_blocks(params):
    """k = 4 pads verify's 5 columns to 8, whose positions run past a
    row's table; the engine widens the tables so those columns land in
    the NULL block (block lookups clamp to the last column). Single
    requests whose tables are a power of two long at some round: a
    self-draft's streams equal vanilla's and the reference's."""
    prompts = [[(7 * j + 3) % 63 + 1 for j in range(n)]
               for n in (3, 5, 9, 11)]
    _, vanilla = _engines(params)
    refs = [list(vanilla.generate(p, max_new_tokens=12)) for p in prompts]
    vanilla.shutdown()
    je, te = _self_draft_engines(params, 4)
    for engine in (je, te):
        assert [list(engine.generate(p, max_new_tokens=12))
                for p in prompts] == refs
    assert te.stats()["spec"] == je.stats()["spec"]
    je.shutdown()
    te.shutdown()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_spec_decode_shift_pair_accepts_everything(dtype):
    """Twin of test_llm.py's test of the same name, in f32 and bf16: a
    draft and flagship that agree by construction accept every
    proposal, and each round emits k accepted + 1 bonus token."""
    cfg = tm.TransformerConfig(vocab_size=16, d_model=32, n_layers=2,
                               n_heads=4, n_kv_heads=2, d_ff=48, dtype=dtype)
    dcfg = tm.draft_config(cfg)
    k = 3
    spec = tllm.InferenceEngine(
        tllm.EngineConfig(model=cfg, num_blocks=48, block_size=4,
                          max_num_seqs=2, spec_k=k, draft_model=dcfg,
                          device="cpu"),
        params=tm.shift_params(cfg, shift=1, device="cpu"),
        draft_params=tm.shift_params(dcfg, shift=1, device="cpu"))
    # 1 token from the prefill, then 3 rounds of k + 1.
    out = list(spec.generate([3], max_new_tokens=1 + 3 * (k + 1)))
    assert out == [(3 + 1 + i) % 16 for i in range(1 + 3 * (k + 1))]
    st = spec.stats()["spec"]
    assert st["acceptance_rate"] == 1.0
    assert st["accepted"] == st["proposed"]
    assert st["rounds"] == 3 and st["emitted"] == 3 * (k + 1)
    assert st["fallback_rounds"] == 0
    spec.shutdown()


def test_spec_decode_fallback_to_vanilla(params):
    """Twin of test_llm.py's test of the same name: spec_k=0 or a missing
    draft disarm speculation (no 'spec' stats, no aux pool); a sampled
    request on an armed engine falls back per round, counted, and equals
    the vanilla engine's and the reference's seeded stream."""
    _, e0 = _engines(params, spec_k=0)
    _, e1 = _engines(params, spec_k=3, draft=False)
    for e in (e0, e1):
        assert "spec" not in e.stats()
        assert e.cache.stats()["aux_pools"] == []
    ref = list(e0.generate([2, 3, 4], max_new_tokens=6))
    assert list(e1.generate([2, 3, 4], max_new_tokens=6)) == ref
    e0.shutdown()
    e1.shutdown()

    kw = dict(max_new_tokens=8, temperature=0.7, seed=123)
    _, vanilla = _engines(params)
    want = list(vanilla.generate([7, 8, 9], **kw))
    vanilla.shutdown()
    je, te = _engines(params, spec_k=3)
    assert list(je.generate([7, 8, 9], **kw)) == want
    assert list(te.generate([7, 8, 9], **kw)) == want
    st = te.stats()["spec"]
    assert st["fallback_rounds"] > 0 and st["rounds"] == 0
    assert st == je.stats()["spec"]
    je.shutdown()
    te.shutdown()


def test_spec_decode_lookahead_oom_falls_back_counted(params):
    """A round whose k lookahead slots do not all allocate decodes
    vanilla (counted), and the stream still equals vanilla's."""
    _, vanilla = _engines(params, num_blocks=8)
    prompt = list(range(1, 21))      # 5 blocks of 4; the pool holds 7
    ref = list(vanilla.generate(prompt, max_new_tokens=7))
    vanilla.shutdown()
    _, spec = _engines(params, spec_k=4, num_blocks=8)
    assert list(spec.generate(prompt, max_new_tokens=7)) == ref
    st = spec.stats()["spec"]
    assert st["fallback_rounds"] > 0
    assert spec.cache.stats()["blocks_in_use"] == 0
    spec.shutdown()


def test_spec_engine_default_draft_is_seeded_and_armed():
    """Without draft parameters the engine draws the draft from
    param_seed + 1 with the port's own init_params, and the aux pool
    takes the cache dtype."""
    eng = tllm.InferenceEngine(tllm.EngineConfig(
        model=PORT_MODEL, spec_k=2, draft_model=PORT_DRAFT, device="cpu",
        cache_dtype=torch.bfloat16, **ENGINE))
    want = tm.init_params(PORT_DRAFT, 1, device="cpu")
    torch.testing.assert_close(eng.draft_params["layers"]["wq"],
                               want["layers"]["wq"], atol=0, rtol=0)
    aux = eng.cache.aux_data("draft")
    assert aux["k"].dtype == torch.bfloat16
    assert tuple(aux["k"].shape) == (PORT_DRAFT.n_layers, 48, 4,
                                     PORT_DRAFT.n_kv_heads,
                                     PORT_DRAFT.head_dim)
    assert eng.stats()["spec"]["k"] == 2
    eng.shutdown()
