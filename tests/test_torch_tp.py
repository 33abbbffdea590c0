"""Parity of the port's tensor-parallel serving (the engine's
``tp_size``, the ``mesh=`` paths of ``prefill_chunk`` / ``decode_step``,
``param_specs``, ``shard_params`` and the sharded KV pool) with the
reference's, on the CPU.

The reference shards over its 8-device CPU mesh (tests/conftest.py); the
port over virtual CPU shards (``RAY_TPU_TORCH_VIRTUAL_DEVICES=8``). Both
serve test_llm.py's f32 model from the same weights (converted through
``params_from_jax``): at tp 2 (and at tp 4 with ``n_kv_heads=4``, and for
an MoE config at tp 2) greedy streams must equal the reference's at tp 1
and tp 2, the sharded programs' logits must lie within the reference's own
limit (atol 1e-5) of the unsharded ones, each shard's parameter leaves
and KV pool must have the reference's per-shard shapes and values, and
the reference's refusals must raise the same exception types.
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
from ray_tpu_torch.models import transformer as tt
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsh

torch.set_num_threads(1)

MODEL = jm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=48,
                             dtype=jnp.float32)
MODEL_KV4 = dataclasses.replace(MODEL, n_kv_heads=4)
MOE = jm.TransformerConfig(
    vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=4,
    d_ff=64, num_experts=4, moe_every=2, capacity_factor=16.0,
    dtype=jnp.float32)
ENGINE = dict(num_blocks=48, block_size=4, max_num_seqs=4,
              prefill_token_budget=256, max_queued_requests=16,
              enable_prefix_caching=False)
PROMPTS = [[1, 2, 3, 4, 5], [6, 7], [8, 9, 10, 11, 12, 13]]
LOGIT_ATOL = 1e-5   # the reference's own limit (test_llm.py)


@pytest.fixture(autouse=True)
def _virtual_cpu_shards(monkeypatch):
    monkeypatch.setenv(tmesh.VIRTUAL_DEVICES_ENV, "8")


def _port_cfg(cfg):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return tm.TransformerConfig(**dict(fields, dtype=torch.float32))


_PARAMS = {}


def _params(cfg):
    """(reference params, port params) of ``cfg`` from PRNGKey(0)."""
    if cfg not in _PARAMS:
        jp = jm.init_params(cfg, jax.random.PRNGKey(0))
        tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                _port_cfg(cfg), device="cpu")
        _PARAMS[cfg] = (jp, tp)
    return _PARAMS[cfg]


def _jax_engine(cfg, tp, **over):
    return jllm.InferenceEngine(
        jllm.EngineConfig(model=cfg, tp_size=tp, **dict(ENGINE, **over)),
        params=_params(cfg)[0])


def _port_engine(cfg, tp, **over):
    return tllm.InferenceEngine(
        tllm.EngineConfig(model=_port_cfg(cfg), tp_size=tp, device="cpu",
                          **dict(ENGINE, **over)),
        params=_params(cfg)[1])


def _streams(engine):
    try:
        out = []
        for p in PROMPTS:
            out.append(list(engine.generate(p, max_new_tokens=10)))
            assert engine.wait_idle(60)
        return out
    finally:
        engine.shutdown()


_REFERENCE_STREAMS = {}


def _reference_streams(cfg, tp):
    if (cfg, tp) not in _REFERENCE_STREAMS:
        _REFERENCE_STREAMS[cfg, tp] = _streams(_jax_engine(cfg, tp))
    return _REFERENCE_STREAMS[cfg, tp]


@pytest.mark.parametrize("cfg,tp", [(MODEL, 2), (MODEL_KV4, 4), (MOE, 2)],
                         ids=["gqa-tp2", "mha-tp4", "moe-tp2"])
def test_tp_decode_matches_reference(cfg, tp):
    """Twin of test_tp_decode_matches_single_device: the port's tp streams
    equal the reference's at tp 1 and at tp 2, and the port's own tp 1."""
    port = _port_engine(cfg, tp)
    assert port.mesh is not None and port.mesh.shape["tp"] == tp
    assert port.stats()["tp_size"] == tp
    got = _streams(port)
    assert got == _reference_streams(cfg, 1)
    assert got == _reference_streams(cfg, 2)
    assert got == _streams(_port_engine(cfg, 1))


def _shard_tree(cfg, tp, params):
    mesh, rules = tllm.InferenceEngine._build_tp_mesh(tp, "cpu")
    return mesh, rules, tsh.shard_params(params, mesh,
                                         tm.param_specs(cfg, rules))


@pytest.mark.parametrize("cfg,tp", [(MODEL, 2), (MODEL_KV4, 4), (MOE, 2)],
                         ids=["gqa-tp2", "mha-tp4", "moe-tp2"])
def test_tp_prefill_and_decode_logits_close(cfg, tp):
    """Twin of test_tp_prefill_and_decode_logits_close: the sharded
    prefill_chunk, decode_step and verify_step agree with the unsharded
    programs and with the reference's within atol 1e-5; the argmax token
    the decode feeds on is the same."""
    pcfg = _port_cfg(cfg)
    jp, params = _params(cfg)
    mesh, rules, sharded = _shard_tree(pcfg, tp, params)
    prompt = [3, 17, 5, 9, 22, 11]
    table = np.zeros((1, 4), np.int32)
    table[0, :2] = [5, 9]
    toks = np.zeros((1, 8), np.int32)
    toks[0, :6] = prompt
    t = lambda a: torch.as_tensor(np.asarray(a))   # noqa: E731

    def run(p, cache, mesh_, rules_):
        lg, cache = tm.prefill_chunk(pcfg, p, cache, t(toks), t([0]),
                                     t([6]), t(table), mesh=mesh_,
                                     rules=rules_)
        tok = int(torch.argmax(lg[0]))
        lg2, cache = tm.decode_step(pcfg, p, cache, t([tok]), t([6]),
                                    t(table), mesh=mesh_, rules=rules_)
        lg3, cache = tm.verify_step(pcfg, p, cache, t([[tok, 7, 8]]),
                                    t([6]), t(table), mesh=mesh_,
                                    rules=rules_)
        return [x.numpy() for x in (lg[0], lg2[0], lg3[0])], cache

    base, _ = run(params, tm.init_kv_cache(pcfg, 16, 4, device="cpu"),
                  None, None)
    cache = tsh.shard_params(tm.init_kv_cache(pcfg, 16, 4, device="cpu"),
                             mesh, tsh.kv_cache_specs(rules))
    got, cache_out = run(sharded, cache, mesh, rules)
    assert cache_out is cache and len(cache) == tp
    for g, b in zip(got, base):
        np.testing.assert_allclose(g, b, atol=LOGIT_ATOL, rtol=0)
    # The reference's unsharded programs on the same inputs.
    jl, jcache = jm.prefill_chunk(
        cfg, jp, jm.init_kv_cache(cfg, 16, 4), jnp.asarray(toks),
        jnp.asarray([0]), jnp.asarray([6]), jnp.asarray(table))
    tok = int(np.argmax(np.asarray(jl[0])))
    assert tok == int(np.argmax(got[0]))
    jl2, _ = jm.decode_step(cfg, jp, jcache, jnp.asarray([tok]),
                            jnp.asarray([6]), jnp.asarray(table))
    np.testing.assert_allclose(got[0], np.asarray(jl[0]), atol=LOGIT_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got[1], np.asarray(jl2[0]), atol=LOGIT_ATOL,
                               rtol=0)
    # Each shard's pool holds only its KV heads, each the unsharded
    # pool's slice of them.
    _, full = run(params, tm.init_kv_cache(pcfg, 16, 4, device="cpu"),
                  None, None)
    w = pcfg.n_kv_heads // tp
    for j, c in enumerate(cache):
        for name in ("k", "v"):
            assert c[name].shape[3] == w
            np.testing.assert_allclose(
                c[name][:, 1:].numpy(),
                full[name][:, 1:, :, j * w:(j + 1) * w].numpy(),
                atol=LOGIT_ATOL, rtol=0)


def _by_device(jarr):
    return {s.device: np.asarray(s.data) for s in jarr.addressable_shards}


@pytest.mark.parametrize("cfg,tp", [(MODEL, 2), (MODEL_KV4, 4), (MOE, 2)],
                         ids=["gqa-tp2", "mha-tp4", "moe-tp2"])
def test_shard_leaves_and_pools_match_reference_shards(cfg, tp):
    """Each shard's parameter leaves and KV pools have the shape and the
    values of the reference engine's addressable shard on the same mesh
    position."""
    je = _jax_engine(cfg, tp)
    te = _port_engine(cfg, tp)
    try:
        jdevs = list(je.mesh.devices.flat)
        assert len(te.params) == len(jdevs) == tp

        def walk(jtree, path=()):
            if isinstance(jtree, dict):
                for k, v in jtree.items():
                    yield from walk(v, path + (k,))
            else:
                yield path, jtree

        n_leaves = 0
        for path, jleaf in walk(je.params):
            shards = _by_device(jleaf)
            for j, d in enumerate(jdevs):
                leaf = te.params[j]
                for k in path:
                    leaf = leaf[k]
                assert tuple(leaf.shape) == shards[d].shape, path
                np.testing.assert_array_equal(leaf.numpy(), shards[d])
            n_leaves += 1
        assert n_leaves == len(list(walk(tm.init_params(
            _port_cfg(cfg), 0, device="cpu"))))
        for name in ("k", "v"):
            shards = _by_device(je.cache.data[name])
            for j, d in enumerate(jdevs):
                assert tuple(te.cache.data[j][name].shape) == \
                    shards[d].shape
        one = _port_engine(cfg, 1)
        pool = one.cache.data["k"]
        assert sum(c["k"].numel() * c["k"].element_size()
                   for c in te.cache.data) == pool.numel() * \
            pool.element_size()
        one.shutdown()
    finally:
        je.shutdown()
        te.shutdown()


def test_param_specs_match_reference():
    from ray_tpu.parallel.sharding import ShardingRules as JRules

    for cfg in (MODEL, MOE):
        for rules in (None, (JRules(mlp="sp", heads="sp"),
                             tsh.ShardingRules(mlp="sp", heads="sp"))):
            jr, tr = rules or (None, None)
            jspec = jm.param_specs(cfg, jr)
            tspec = tm.param_specs(_port_cfg(cfg), tr)

            def flat(tree, path=()):
                if isinstance(tree, dict):
                    return sum((flat(v, path + (k,))
                                for k, v in tree.items()), [])
                return [(path, tuple(tree))]

            assert flat(tspec) == flat(jspec)
    from ray_tpu.parallel.sharding import kv_cache_specs
    assert {k: tuple(v) for k, v in kv_cache_specs().items()} == \
        tsh.kv_cache_specs()


def _raises_alike(make_jax, make_port):
    kinds = []
    for make in (make_jax, make_port):
        with pytest.raises(Exception) as info:
            make()
        kinds.append(type(info.value))
    assert kinds[0] is kinds[1] is ValueError, kinds
    return kinds


def test_reference_refusals_raise_alike():
    # Heads that do not divide tp.
    _raises_alike(lambda: _jax_engine(MODEL, 3),
                  lambda: _port_engine(MODEL, 3))
    # More shards than visible devices.
    _raises_alike(lambda: _jax_engine(MODEL, 16),
                  lambda: _port_engine(MODEL, 16))
    # Speculative decoding under tp.
    draft = dataclasses.replace(MODEL, n_layers=1)
    _raises_alike(lambda: _jax_engine(MODEL, 2, spec_k=2, draft_model=draft),
                  lambda: _port_engine(MODEL, 2, spec_k=2,
                                       draft_model=_port_cfg(draft)))
    # An aux pool under tp.
    je, te = _jax_engine(MODEL, 2), _port_engine(MODEL, 2)
    try:
        _raises_alike(lambda: je.cache.attach_aux("draft", MODEL),
                      lambda: te.cache.attach_aux("draft", _port_cfg(MODEL)))
    finally:
        je.shutdown()
        te.shutdown()


def test_tp_engine_refuses_without_enough_devices(monkeypatch):
    monkeypatch.delenv(tmesh.VIRTUAL_DEVICES_ENV)
    with pytest.raises(ValueError, match="exceeds 1 visible devices"):
        _port_engine(MODEL, 2)


def test_sharded_pool_copies_exports_and_grafts_every_shard():
    """COW, export and graft cover every shard's heads: an exported
    payload of a tp 2 engine carries all n_kv_heads, equal to a tp 1
    engine's, and grafts back into another tp 2 engine."""
    engines = {tp: _port_engine(MODEL, tp, enable_prefix_caching=True)
               for tp in (1, 2)}
    prompt = list(range(1, 11))
    payloads = {}
    try:
        for tp, e in engines.items():
            req = e.submit(prompt, max_new_tokens=1, hold_after_prefill=True)
            while not req.finished():
                e.step()
            payloads[tp] = e.cache.export_blocks(req.seq_id)
        for name in ("k", "v"):
            assert payloads[2][name].shape == payloads[1][name].shape
            torch.testing.assert_close(payloads[2][name], payloads[1][name],
                                       atol=LOGIT_ATOL, rtol=0)
        dst = _port_engine(MODEL, 2)
        try:
            assert dst.cache.allocate(99, len(prompt) + 1)
            dst.cache.graft_blocks(99, payloads[2])
            table = dst.cache.table(99)
            got = torch.cat([c["k"][:, table[:payloads[2]["blocks"]]]
                             for c in dst.cache.data], dim=3)
            torch.testing.assert_close(got, payloads[2]["k"], atol=0, rtol=0)
            # Copy on write reaches every shard.
            src, new = table[0], dst.cache._pop_block()
            dst.cache._copy_block_data(src, new)
            for c in dst.cache.data:
                torch.testing.assert_close(c["v"][:, new], c["v"][:, src],
                                           atol=0, rtol=0)
        finally:
            dst.shutdown()
    finally:
        for e in engines.values():
            e.shutdown()


def test_tp_program_refuses_a_mesh_it_cannot_shard():
    cfg = _port_cfg(MODEL)
    params = _params(MODEL)[1]
    mesh = tmesh.make_mesh(tmesh.MeshConfig(dp=2, tp=2),
                           devices=[torch.device("cpu")] * 4)
    sharded = tsh.shard_params(params, mesh, tm.param_specs(cfg))
    cache = tsh.shard_params(tm.init_kv_cache(cfg, 8, 4, device="cpu"), mesh,
                             tsh.kv_cache_specs())
    t = torch.zeros((1,), dtype=torch.long)
    table = torch.zeros((1, 2), dtype=torch.long)
    with pytest.raises(ValueError, match="must have size 1"):
        tm.decode_step(cfg, sharded, cache, t, t, table, mesh=mesh)
    with pytest.raises(ValueError, match="one mesh axis"):
        tt._Shards(mesh, tsh.ShardingRules(vocab=None), sharded,
                           cache)
