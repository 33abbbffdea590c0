"""Parity of the PyTorch port's flagship model (ray_tpu_torch.models) with
the JAX reference (ray_tpu.models), on the CPU.

Weights come from the reference's ``init_params`` and are converted
through ``params_from_jax``; both sides see the same tokens, block tables
and positions. f32 models compare at atol 1e-4 on logits and 1e-5 on
cache contents (same math, different summation order); greedy tokens
must be identical. Block 0 (the NULL block, where padded writes land in
an unspecified order) is never compared.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.models as jm
from ray_tpu.models import transformer as jt
from ray_tpu_torch import models as tm
from ray_tpu_torch.models import transformer as tt

# The suite runs in several worker processes on one machine: one intra-op
# thread per process keeps these tests from starving the timing-sensitive
# engine tests that run beside them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOGIT_ATOL = 1e-4
CACHE_ATOL = 1e-5

GQA = jm.TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4,
                           n_kv_heads=2, d_ff=48, dtype=jnp.float32)
MHA = dataclasses.replace(GQA, n_kv_heads=4)


def _port_cfg(cfg, dtype=torch.float32):
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["dtype"] = dtype
    return tt.TransformerConfig(**fields)


def _pair(cfg):
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                            _port_cfg(cfg), device="cpu")
    return jp, tp


@pytest.fixture(scope="module", params=["gqa", "mha"])
def model(request):
    cfg = {"gqa": GQA, "mha": MHA}[request.param]
    jp, tp = _pair(cfg)
    return cfg, _port_cfg(cfg), jp, tp


def _assert_cache_close(jcache, tcache):
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name][:, 1:].numpy(),
                                   np.asarray(jcache[name])[:, 1:],
                                   atol=CACHE_ATOL)


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    w = rng.standard_normal((16,)).astype(np.float32)
    pos = np.tile(np.arange(5), (2, 1)).astype(np.int32)
    # bf16: both cast to bf16 before the multiply by w, so they differ by
    # at most one bf16 rounding (relative 2**-8) of the f32 normalisation.
    for jdt, tdt, rtol in ((jnp.float32, torch.float32, 0.0),
                           (jnp.bfloat16, torch.bfloat16, 1e-2)):
        ref = jt.rms_norm(jnp.asarray(x, jdt), jnp.asarray(w))
        out = tt.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(w))
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=1e-6, rtol=rtol)
    ref = jt.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    out = tt.rope(torch.from_numpy(x), torch.from_numpy(pos).long(), 10000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_forward_matches_reference(model):
    cfg, tcfg, jp, tp = model
    toks = np.random.default_rng(1).integers(0, 64, (2, 9)).astype(np.int32)
    ref = jm.forward(cfg, jp, jnp.asarray(toks))
    out = tm.forward(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                               atol=LOGIT_ATOL)


def test_forward_bf16_matches_reference():
    """bf16 rounds at different places in the two frameworks (matmul
    output rounding, silu), so bf16 logits agree only to a few bf16
    ulps of their O(1) magnitude."""
    cfg = dataclasses.replace(GQA, dtype=jnp.bfloat16)
    jp = jm.init_params(cfg, jax.random.PRNGKey(0))
    tp = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                            _port_cfg(cfg, torch.bfloat16), device="cpu")
    toks = np.random.default_rng(2).integers(0, 64, (2, 9)).astype(np.int32)
    ref = jm.forward(cfg, jp, jnp.asarray(toks))
    out = tm.forward(_port_cfg(cfg, torch.bfloat16), tp,
                     torch.from_numpy(toks))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=0.1)


def test_prefill_and_decode_match_reference(model):
    """Twin of test_llm.py::test_prefill_and_decode_match_forward: paged
    prefill and six greedy decode steps against the reference, logits,
    tokens and cache contents after every call."""
    cfg, tcfg, jp, tp = model
    prompt = [3, 17, 5, 9, 22]
    table = np.zeros((1, 4), np.int32)
    table[0, :3] = [7, 2, 11]  # deliberately non-contiguous
    toks = np.zeros((1, 8), np.int32)
    toks[0, :5] = prompt
    jcache = jm.init_kv_cache(cfg, 16, 4)
    tcache = tm.init_kv_cache(tcfg, 16, 4, device="cpu")
    jl, jcache = jm.prefill_with_cache(cfg, jp, jcache, jnp.asarray(toks),
                                       jnp.asarray([5]), jnp.asarray(table))
    tl, tcache = tm.prefill_with_cache(
        tcfg, tp, tcache, torch.from_numpy(toks), torch.tensor([5]),
        torch.from_numpy(table))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL)
    _assert_cache_close(jcache, tcache)
    # The prefill equals the cacheless forward at the last prompt position.
    fwd = tm.forward(tcfg, tp, torch.tensor([prompt]))[0, -1]
    np.testing.assert_allclose(tl[0].numpy(), fwd.numpy(), atol=LOGIT_ATOL)

    jtok = ttok = int(np.argmax(np.asarray(jl[0])))
    assert int(torch.argmax(tl[0])) == ttok
    got, want = [ttok], [jtok]
    for pos in range(5, 10):
        jl, jcache = jm.decode_step(cfg, jp, jcache, jnp.asarray([jtok]),
                                    jnp.asarray([pos]), jnp.asarray(table))
        tl, tcache = tm.decode_step(tcfg, tp, tcache, torch.tensor([ttok]),
                                    torch.tensor([pos]),
                                    torch.from_numpy(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_ATOL)
        _assert_cache_close(jcache, tcache)
        jtok = int(np.argmax(np.asarray(jl[0])))
        ttok = int(torch.argmax(tl[0]))
        want.append(jtok)
        got.append(ttok)
    assert got == want


def test_prefill_chunk_matches_reference(model):
    """Two sequences prefilled in two chunks each (the second chunk
    attends the first through the paged cache), padded batch row and
    tails included."""
    cfg, tcfg, jp, tp = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 64, 11).tolist(), rng.integers(0, 64, 6).tolist()]
    tables = np.zeros((4, 4), np.int32)
    tables[0, :3] = [5, 9, 1]
    tables[1, :2] = [12, 3]
    jcache = jm.init_kv_cache(cfg, 16, 4)
    tcache = tm.init_kv_cache(tcfg, 16, 4, device="cpu")
    for start, C in ((0, 4), (4, 8)):
        toks = np.zeros((4, C), np.int32)
        starts = np.zeros((4,), np.int32)
        lens = np.ones((4,), np.int32)
        for i, p in enumerate(prompts):
            piece = p[start:start + C]
            toks[i, :len(piece)] = piece
            starts[i] = start
            lens[i] = max(len(piece), 1)
        jl, jcache = jm.prefill_chunk(cfg, jp, jcache, jnp.asarray(toks),
                                      jnp.asarray(starts), jnp.asarray(lens),
                                      jnp.asarray(tables))
        tl, tcache = tm.prefill_chunk(
            tcfg, tp, tcache, torch.from_numpy(toks),
            torch.from_numpy(starts), torch.from_numpy(lens),
            torch.from_numpy(tables))
        np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2],
                                   atol=LOGIT_ATOL)
        _assert_cache_close(jcache, tcache)
    # Chunked prefill of the first prompt ends on the same logits as a
    # one-shot prefill_with_cache.
    one = np.zeros((1, 16), np.int32)
    one[0, :11] = prompts[0]
    ol, _ = tm.prefill_with_cache(tcfg, tp,
                                  tm.init_kv_cache(tcfg, 16, 4, device="cpu"),
                                  torch.from_numpy(one), torch.tensor([11]),
                                  torch.from_numpy(tables[:1]))
    np.testing.assert_allclose(tl[0].numpy(), ol[0].numpy(), atol=LOGIT_ATOL)


def test_params_from_jax_maps_every_leaf_and_rejects_mismatch():
    jp, tp = _pair(GQA)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == 12
    for path, leaf in flat_j:
        keys = [p.key for p in path]
        t = tp
        for key in keys:
            t = t[key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    bad = jax.tree_util.tree_map(np.asarray, jp)
    bad["layers"]["wq"] = bad["layers"]["wq"][:, :, :8]
    with pytest.raises(ValueError):
        tm.params_from_jax(bad, _port_cfg(GQA), device="cpu")
    del bad["layers"]["wq"]
    with pytest.raises(KeyError):
        tm.params_from_jax(bad, _port_cfg(GQA), device="cpu")


def test_init_params_is_seeded_and_shaped_like_reference():
    tcfg = _port_cfg(GQA)
    a = tm.init_params(tcfg, seed=7, device="cpu")
    b = tm.init_params(tcfg, seed=7, device="cpu")
    c = tm.init_params(tcfg, seed=8, device="cpu")
    jp = jm.init_params(GQA, jax.random.PRNGKey(0))
    for name, leaf in jp["layers"].items():
        assert tuple(a["layers"][name].shape) == leaf.shape
        torch.testing.assert_close(a["layers"][name], b["layers"][name],
                                   atol=0, rtol=0)
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"][0, :, :8],
                           a["layers"]["wk"][0, :, :8])
    assert tuple(a["embed"].shape) == jp["embed"].shape


def test_moe_config_is_refused():
    tcfg = dataclasses.replace(_port_cfg(GQA), num_experts=4)
    with pytest.raises(NotImplementedError):
        tm.init_params(tcfg, 0, device="cpu")


def test_entry_points_default_to_cuda_and_refuse_to_fall_back(monkeypatch):
    """Without a card, an entry point not told device='cpu' raises; it
    never runs on the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from ray_tpu_torch.llm import EngineConfig, InferenceEngine

    tcfg = _port_cfg(GQA)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_params(tcfg, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_kv_cache(tcfg, 8, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.serving_params(tm.init_params(tcfg, 0, device="cpu"), tcfg)
    jp = jax.tree_util.tree_map(np.asarray,
                                jm.init_params(GQA, jax.random.PRNGKey(0)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.params_from_jax(jp, tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(EngineConfig(model=tcfg, num_blocks=8, block_size=4))


_PORT_FILES = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_source_imports_no_jax_and_no_ray_tpu(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", "ray_tpu"), (
                f"{path}: imports {name}")


def test_port_import_loads_no_jax_and_no_ray_tpu():
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch.ops, ray_tpu_torch.models\n"
        "import ray_tpu_torch.llm, ray_tpu_torch.ops._build, chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ray_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
