"""Parity of the PyTorch port's ops (ray_tpu_torch.ops) with the JAX
reference (ray_tpu.ops), on the CPU.

Inputs come from a numpy seed and go through both. The reference's Pallas
flash kernel runs in interpret mode, as tests/test_ops.py runs it; the port
runs its plain PyTorch version, which is what its wrapper takes for CPU
tensors; the flash backward is held against ``jax.vjp`` of the reference's
custom_vjp. The hand-written kernels are held against the plain versions
on the card by tests/test_torch_kernels.py and chip_smoke.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The suite runs in several worker processes on one machine: one intra-op
# thread per process keeps these tests from starving the timing-sensitive
# engine tests that run beside them.
torch.set_num_threads(1)

# The packages re-export functions under their modules' names, so the
# modules are looked up explicitly.
jax_fa = importlib.import_module("ray_tpu.ops.flash_attention")
jax_pa = importlib.import_module("ray_tpu.ops.paged_attention")
fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
pa = importlib.import_module("ray_tpu_torch.ops.paged_attention")

# f32: both sides accumulate in f32 and differ only in summation order.
F32_ATOL = 1e-5
# bf16: the reference and the port's plain version (``_dense_kernel``) both
# round the scaled q to bf16 and keep f32 scores; the reference's online
# softmax rounds p against its running maximum, a block at a time, the
# plain version against the row's; one bf16 ulp of an O(1) output is
# 2**-8 ~ 4e-3, so allow a few.
BF16_ATOL = 2e-2


def _qkv(seed, B, Hq, Hkv, Sq, Sk, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    return q, k, v


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_interpret(causal):
    B, H, S, D = 2, 2, 64, 16
    q, k, v = _qkv(0, B, H, H, S, S, D)
    ref = jax_fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, block_q=32,
                                 block_k=32, interpret=True)
    out = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=F32_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_grouped_matches_pallas_interpret(causal):
    B, Hq, Hkv, S, D = 2, 8, 2, 64, 16
    q, k, v = _qkv(1, B, Hq, Hkv, S, S, D)
    ref = jax_fa.flash_attention_grouped(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=16, block_k=16, interpret=True)
    out = fa.flash_attention_grouped(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=F32_ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_lse_matches_pallas_interpret(causal):
    """The LSE the training slice will need: the reference stores it
    sublane-broadcast [B, H, 8, Sq], the port [B, H, Sq]."""
    B, H, S, D = 1, 2, 128, 16
    q, k, v = _qkv(2, B, H, H, S, S, D)
    ref_o, ref_lse = jax_fa._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, D ** -0.5,
        64, 64, True)
    o, lse = fa._flash_forward(_t(q), _t(k), _t(v), causal)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(_np(o), np.asarray(ref_o), atol=F32_ATOL)
    np.testing.assert_allclose(_np(lse), np.asarray(ref_lse[:, :, 0]),
                               atol=F32_ATOL)


@pytest.mark.parametrize("grouped", [False, True])
def test_flash_attention_bf16_matches_pallas_interpret(grouped):
    B, Hq, S, D = 1, 4, 64, 16
    Hkv = 2 if grouped else Hq
    q, k, v = _qkv(3, B, Hq, Hkv, S, S, D)
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    fn = jax_fa.flash_attention_grouped if grouped else jax_fa.flash_attention
    ref = fn(*args, causal=True, block_q=32, block_k=32, interpret=True)
    tq, tk, tv = (_t(a, torch.bfloat16) for a in (q, k, v))
    port = fa.flash_attention_grouped if grouped else fa.flash_attention
    out = port(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(ref), atol=BF16_ATOL)


def test_flash_attention_ragged_shapes_match_reference_fallback():
    """Shapes the Pallas tiling refuses (S = 12, D = 8) take the
    reference's dense fallback; the port's plain version agrees."""
    B, Hq, Hkv, S, D = 1, 4, 2, 12, 8
    q, k, v = _qkv(4, B, Hq, Hkv, S, S, D)
    ref = jax_fa.flash_attention_grouped(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True)
    out = fa.flash_attention_grouped(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=F32_ATOL)


def test_flash_wrapper_uses_plain_version_on_cpu_without_launching():
    q, k, v = _qkv(5, 1, 2, 2, 16, 16, 8)
    before = fa.launches
    out = fa.flash_attention(_t(q), _t(k), _t(v))
    assert fa.launches == before
    # The plain version with the kernel's rounding points: the reference
    # reaches its Pallas kernel at these shapes, not _fallback.
    ref = fa._dense_kernel(_t(q), _t(k), _t(v), True, 8 ** -0.5)[0]
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_flash_wrapper_rejects_bad_shapes():
    q, k, v = _qkv(6, 1, 6, 4, 16, 16, 8)
    with pytest.raises(ValueError):
        fa.flash_attention_grouped(_t(q), _t(k), _t(v))
    q, k, v = _qkv(6, 1, 4, 2, 16, 16, 8)
    with pytest.raises(ValueError):
        fa.flash_attention(_t(q), _t(k), _t(v))


# Backward, f32: the same arithmetic in another summation order, held as
# max|port - ref| over the tensor's largest |ref|. bf16: the port's plain
# backward is given the reference's own O and LSE, so both round P and dS
# to bf16 at the same places; a rounding that flips on a summation-order
# difference moves a gradient by one bf16 ulp of a term, so the limit is
# 2**-8 of the tensor's largest element.
BWD_REL = {np.float32: 1e-5, jnp.bfloat16: 2.0 ** -8}


def _rel(ref, got):
    ref = np.asarray(ref, np.float32)
    return float(np.abs(ref - _np(got)).max() / np.abs(ref).max())


def _backward_launches():
    return (fa.launches, fa.dq_launches, fa.dkv_launches,
            fa.dq_wgmma_launches, fa.dkv_wgmma_launches,
            fa.dq_tiled_f32_launches, fa.dkv_tiled_f32_launches)


# D=64 is a width the tensor-core backward takes in bf16 on the card; on
# the CPU the backward is the plain version whatever the rule picks.
@pytest.mark.parametrize("D", [16, 64])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_backward_matches_pallas_interpret_vjp(causal, S, dtype, D):
    B, H = 1, 2
    q, k, v = _qkv(10 + S, B, H, H, S, S, D)
    do = np.random.default_rng(S).standard_normal(q.shape).astype(
        np.float32)
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in (q, k, v, do))
    _, vjp = jax.vjp(lambda q, k, v: jax_fa.flash_attention(
        q, k, v, causal=causal, block_q=128, block_k=128, interpret=True),
        jq, jk, jv)
    ref = vjp(jdo)
    tdt = torch.float32 if dtype is np.float32 else torch.bfloat16
    tq, tk, tv, tdo = (_t(a, tdt) for a in (q, k, v, do))
    if dtype is np.float32:
        o, lse = fa._flash_forward(tq, tk, tv, causal)
    else:
        ro, rlse = jax_fa._flash_forward(jq, jk, jv, causal, D ** -0.5,
                                         128, 128, True)
        o = _t(np.array(ro, np.float32), tdt)
        lse = _t(np.array(rlse[:, :, 0]))
    before = _backward_launches()
    grads = fa._flash_backward(tq, tk, tv, o, lse, tdo, causal, D ** -0.5)
    assert _backward_launches() == before
    for name, r, g in zip(("dq", "dk", "dv"), ref, grads):
        assert g.dtype == tdt
        assert _rel(r, g) <= BWD_REL[dtype], name


@pytest.mark.parametrize("S", [37, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_core_cpu_backward_matches_autograd_of_plain_forward(causal,
                                                                    S):
    B, H, D = 2, 3, 16
    q, k, v = _qkv(20 + S, B, H, H, S, S, D)
    do = _t(np.random.default_rng(S).standard_normal(q.shape).astype(
        np.float32))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    before = fa.launches, fa.dq_launches, fa.dkv_launches
    out = fa.flash_attention(*leaves, causal=causal)
    grads = torch.autograd.grad(out, leaves, do)
    assert (fa.launches, fa.dq_launches, fa.dkv_launches) == before
    ref_out = fa._dense_kernel(*leaves, causal, D ** -0.5)[0]
    ref = torch.autograd.grad(ref_out, leaves, do)
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)
    for r, g in zip(ref, grads):
        assert _rel(r.detach().numpy(), g) <= BWD_REL[np.float32]


def test_flash_attention_grouped_is_forward_only():
    q, k, v = (_t(a) for a in _qkv(7, 1, 4, 2, 16, 16, 8))
    with pytest.raises(NotImplementedError):
        fa.flash_attention_grouped(q.requires_grad_(), k, v)
    with torch.no_grad():
        fa.flash_attention_grouped(q, k, v)


def _paged_setup(seed, B, Hkv, Dh, bs, total_lens, n_blocks=16):
    rng = np.random.default_rng(seed)
    k_ctx = rng.standard_normal((B, 12, Hkv, Dh)).astype(np.float32)
    v_ctx = rng.standard_normal((B, 12, Hkv, Dh)).astype(np.float32)
    k_cache = np.zeros((n_blocks, bs, Hkv, Dh), np.float32)
    v_cache = np.zeros((n_blocks, bs, Hkv, Dh), np.float32)
    free = list(rng.permutation(np.arange(1, n_blocks)))
    tables = np.zeros((B, 3), np.int32)
    for b in range(B):
        n_blk = -(-int(total_lens[b]) // bs)
        blocks = [int(free.pop()) for _ in range(n_blk)]
        tables[b, :n_blk] = blocks
        for pos in range(int(total_lens[b])):
            k_cache[blocks[pos // bs], pos % bs] = k_ctx[b, pos]
            v_cache[blocks[pos // bs], pos % bs] = v_ctx[b, pos]
    return rng, k_cache, v_cache, tables


def test_paged_attention_decode_matches_reference():
    B, Hq, Hkv, Dh, bs = 3, 4, 2, 8, 4
    ctx_lens = np.array([5, 9, 2], np.int32)
    rng, kc, vc, tables = _paged_setup(7, B, Hkv, Dh, bs, ctx_lens)
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    ref = jax_pa.paged_attention_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(ctx_lens))
    out = pa.paged_attention_decode(
        _t(q), _t(kc), _t(vc), torch.from_numpy(tables),
        torch.from_numpy(ctx_lens))
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=F32_ATOL)


def test_paged_attention_prefill_matches_reference():
    B, C, Hq, Hkv, Dh, bs = 2, 4, 4, 2, 8, 4
    total_lens, starts = [10, 7], [6, 3]
    rng, kc, vc, tables = _paged_setup(8, B, Hkv, Dh, bs, total_lens)
    q = rng.standard_normal((B, C, Hq, Dh)).astype(np.float32)
    q_pos = np.array([[s + i for i in range(C)] for s in starts], np.int32)
    ref = jax_pa.paged_attention_prefill(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(q_pos))
    out = pa.paged_attention_prefill(
        _t(q), _t(kc), _t(vc), torch.from_numpy(tables),
        torch.from_numpy(q_pos))
    # Padded chunk tails are garbage by contract on both sides; they are
    # still the same garbage, so compare every row.
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=F32_ATOL)
