"""The wide flash kernels (head_dim above 256) on the CPU: the rule of
shapes that sends bf16 and f16 at every width to the tensor-core forward,
dQ and dK/dV kernels (``"wide_wgmma"``) and f32 at every width to the f32
CUDA-core forward, dQ and dK/dV kernels (``"wide_f32"``), and the plain
versions the card holds them against.

``_dense_kernel`` (the forward's rounding points) is held against the
reference's Pallas ``_attn_kernel`` in interpret mode (``_flash_forward``
for MHA, ``_flash_forward_grouped`` for one KV head), and
``_dense_backward`` against ``jax.vjp`` of the reference's
``flash_attention`` (its dQ and dK/dV Pallas kernels), at head_dim 264,
384 and 512, whose scales are no powers of two, in bf16 and f16, causal
and not, at S=128. On the CPU the wrappers run the plain versions and
launch nothing.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flash_any_dim import LSE_REL
from test_torch_flash_hd256_f16 import O_ATOL

torch.set_num_threads(1)

jax_fa = importlib.import_module("ray_tpu.ops.flash_attention")
fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

TORCH = {jnp.bfloat16: torch.bfloat16, jnp.float16: torch.float16}
DTYPES = [jnp.bfloat16, jnp.float16]
DTYPE_IDS = ["bf16", "f16"]
WIDE_DIMS = [264, 384, 512]
# Backward, max|port - ref| over the tensor's largest |ref|. Both round P
# and dS to the input type at the same places (the plain backward is given
# the reference forward's O and LSE); a rounding that flips on a
# summation-order difference moves a gradient by one ulp of a term, and a
# dK or dV element at these widths gathers terms of about its own size
# from up to 128 query rows, so two such flips can meet in one element:
# two ulps of the tensor's largest element (bf16 2**-7, f16 2**-10; the
# head_dim 256 tests allow one bf16 ulp, 2**-8, which head_dim 512 causal
# read 1.15 of).
BWD_REL = {jnp.bfloat16: 2.0 ** -7, jnp.float16: 2.0 ** -10}
B, HQ, S, BLOCK = 1, 2, 128, 32


def _inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, dtype) for a in arrays],
            [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _launches():
    return (fa.launches, fa.wide_wgmma_launches, fa.wide_launches,
            fa.wide_f32_launches, fa.dq_launches, fa.dkv_launches,
            fa.dkv_wide_wgmma_launches, fa.dkv_wide_f32_launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", [264, 384, 512, 1024, 1032, 2048])
def test_wide_rule_of_shapes(dtype, D):
    """Above 256: bf16 and f16 at every width take the tensor-core
    forward, dQ and dK/dV (wider than 1024 the forward streams Q's rows,
    which no longer fit a block's shared memory), f32 at every width the
    f32 CUDA-core forward, dQ and dK/dV (TF32 would break its limits); the
    CUDA-core wide kernels ("wide") are reached at none. Both backward
    kernels take the forward's variant."""
    fwd = "wide_f32" if dtype == torch.float32 else "wide_wgmma"
    assert fa._forward_variant(dtype, D) == fwd
    assert fa._attention_route(dtype, D) == fwd
    assert fa._attention_route(dtype, D, 8, 8) == fwd
    # dQ and dK/dV run the same variant's kernels (one rule).
    _, bwd_library, suffix = fa._LIBRARIES[fwd]
    for kind in ("dq", "dkv"):
        assert (bwd_library, f"flash_attention_bwd_{kind}{suffix}") \
            in fa._SIGNATURES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", [264, 384, 512, 1024, 1032, 2048])
def test_dq_follows_the_forward_variant(dtype, D):
    """dQ's variant is the forward's at every wide head_dim, and its
    entry point is that variant's own (no variant borrows another's dQ);
    a variant whose dK/dV reads delta gets it from that dQ."""
    variant = fa._forward_variant(dtype, D)
    _, library, suffix = fa._LIBRARIES[variant]
    key = (library, "flash_attention_bwd_dq" + suffix)
    assert key in fa._SIGNATURES
    assert (library, "flash_attention_bwd_dkv" + suffix) in fa._SIGNATURES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 256])
def test_backward_kernels_share_the_variant_up_to_256(dtype, D):
    want = "tiled_f32" if dtype == torch.float32 else "wgmma"
    assert fa._forward_variant(dtype, D) == want
    _, bwd_library, suffix = fa._LIBRARIES[want]
    for kind in ("dq", "dkv"):
        assert (bwd_library, f"flash_attention_bwd_{kind}{suffix}") \
            in fa._SIGNATURES


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("hkv", [1, HQ], ids=["gqa1", "mha"])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_kernel_matches_pallas_interpret_wide(dtype, D, hkv, causal):
    """O within O_ATOL, LSE per element within LSE_REL * (|lse| + 1) (MHA:
    the grouped launch returns O only); the CPU forward is this plain
    version exactly and launches nothing."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        D + 7 * hkv + causal,
        [(B, HQ, S, D), (B, hkv, S, D), (B, hkv, S, D)], dtype)
    o, lse = fa._dense_kernel(tq, tk, tv, causal, D ** -0.5)
    assert o.dtype == TORCH[dtype] and lse.dtype == torch.float32
    if hkv == HQ:
        ref_o, ref_lse = jax_fa._flash_forward(jq, jk, jv, causal, D ** -0.5,
                                               BLOCK, BLOCK, True)
        ref_lse = np.asarray(ref_lse[:, :, 0])
        err = np.abs(lse.numpy() - ref_lse) / (np.abs(ref_lse) + 1)
        assert err.max() <= LSE_REL, err.max()
    else:
        ref_o = jax_fa._flash_forward_grouped(jq, jk, jv, causal, D ** -0.5,
                                              BLOCK, BLOCK, True)
    np.testing.assert_allclose(_f32(o), _f32(ref_o), atol=O_ATOL[dtype])
    before = _launches()
    wo, wlse = fa._flash_forward(tq, tk, tv, causal)
    assert _launches() == before
    assert torch.equal(wo, o) and torch.equal(wlse, lse)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("causal", [True, False])
def test_dense_backward_matches_pallas_interpret_vjp_wide(dtype, D, causal):
    """dq, dk, dv of the plain backward against ``jax.vjp`` of the
    reference's ``flash_attention``, both from the reference forward's O
    and LSE, each within BWD_REL of the tensor's largest element."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(
        5 * D + causal, [(B, HQ, S, D)] * 4, dtype)
    _, vjp = jax.vjp(lambda q, k, v: jax_fa.flash_attention(
        q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK,
        interpret=True), jq, jk, jv)
    ref = vjp(jdo)
    ro, rlse = jax_fa._flash_forward(jq, jk, jv, causal, D ** -0.5, BLOCK,
                                     BLOCK, True)
    o = torch.from_numpy(np.array(_f32(ro))).to(TORCH[dtype])
    lse = torch.from_numpy(np.array(rlse[:, :, 0]))
    before = _launches()
    grads = fa._flash_backward(tq, tk, tv, o, lse, tdo, causal, D ** -0.5)
    assert _launches() == before
    for name, r, g in zip(("dq", "dk", "dv"), ref, grads):
        assert g.dtype == TORCH[dtype], name
        r32 = _f32(r)
        rel = np.abs(r32 - _f32(g)).max() / np.abs(r32).max()
        assert rel <= BWD_REL[dtype], (name, rel)
