"""The tensor-core flash kernels at every bf16/f16 head_dim up to 256, on
the CPU: the rule of shapes that sends them there, and the plain version
with the forward kernels' rounding points (``_dense_kernel``) that the card
holds all three forward kernels against.

The reference's ``_attn_kernel`` computes ``q * scale`` with a Python
float, which JAX's weak typing first rounds to q's dtype; the product is
rounded to that dtype and the scores are f32. ``_dense_kernel`` rounds at
those points, and is held here against the reference's Pallas kernel in
interpret mode (``_flash_forward`` for MHA, ``_flash_forward_grouped`` for
one KV head) at head dims the tensor cores now take padded (32, 80, 96)
and at 128, whose scale is no power of two. ``_dense`` (the reference's
``_fallback`` rounding: the product Q.K^T rounded to q's dtype, then
scaled and rounded again) reads over 1e-3 on LSE there in bf16, which a
test pins. On the CPU the wrappers run ``_dense_kernel`` where the
reference reaches its Pallas kernel, and ``_dense`` where it takes
``_fallback`` (a length under 8).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flash_hd256_f16 import O_ATOL

torch.set_num_threads(1)

jax_fa = importlib.import_module("ray_tpu.ops.flash_attention")
fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

TORCH = {jnp.bfloat16: torch.bfloat16, jnp.float16: torch.float16}
# LSE of _dense_kernel against the Pallas kernel, per element over
# |lse| + 1: both compute f32 scores from the same rounded q, so only the
# online softmax's summation order differs (f32 ulps; 4.8e-7 read here).
LSE_REL = 1e-5
# _dense's LSE against the same kernel in bf16, absolute: its scores are
# rounded to bf16 (2**-9 of their size) twice, which moves LSE by ~1e-2.
DENSE_LSE_FAULT = 1e-3
B, HQ, S, BLOCK = 1, 2, 128, 32


def _inputs(seed, hkv, D, dtype, sq=S, sk=S):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, HQ, sq, D), (B, hkv, sk, D), (B, hkv, sk, D))]
    return ([jnp.asarray(a, dtype) for a in arrays],
            [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _launches():
    return (fa.launches, fa.wgmma_launches, fa.tiled_f32_launches,
            fa.simt_launches, fa.wide_launches)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("D", [32, 80, 96, 128])
@pytest.mark.parametrize("hkv", [1, HQ], ids=["gqa1", "mha"])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_kernel_matches_pallas_interpret(dtype, D, hkv, causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(D + 7 * hkv + causal, hkv, D,
                                         dtype)
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
    # The CPU forward is this plain version, exactly, and launches nothing.
    before = _launches()
    wo, wlse = fa._flash_forward(tq, tk, tv, causal)
    assert _launches() == before
    assert torch.equal(wo, o) and torch.equal(wlse, lse)


@pytest.mark.parametrize("D", [80, 96, 128])
def test_dense_rounding_reads_the_fault_in_bf16(D):
    """C.5's fault, pinned: ``_dense``'s rounding (scores rounded to bf16)
    moves LSE by more than 1e-3 against the reference's kernel, which
    ``_dense_kernel`` meets to ~1e-7 on the same inputs."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(D, HQ, D, jnp.bfloat16)
    _, ref_lse = jax_fa._flash_forward(jq, jk, jv, True, D ** -0.5, BLOCK,
                                       BLOCK, True)
    ref_lse = np.asarray(ref_lse[:, :, 0])
    dense_lse = fa._dense(tq, tk, tv, True, D ** -0.5)[1].numpy()
    kernel_lse = fa._dense_kernel(tq, tk, tv, True, D ** -0.5)[1].numpy()
    assert np.abs(dense_lse - ref_lse).max() > DENSE_LSE_FAULT
    assert np.abs(kernel_lse - ref_lse).max() <= LSE_REL * (
        np.abs(ref_lse).max() + 1)


@pytest.mark.parametrize("D", list(range(8, 257, 8)))
def test_every_bf16_f16_head_dim_up_to_256_takes_the_tensor_cores(D):
    for dtype in (torch.bfloat16, torch.float16):
        assert fa._forward_variant(dtype, D) == "wgmma"
        assert fa._attention_route(dtype, D) == "wgmma"
    assert fa._forward_variant(torch.float32, D) == "tiled_f32"
    assert fa._attention_route(torch.float32, D) == "tiled_f32"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", [4, 12, 260, 264])
def test_other_head_dims_keep_their_routes(dtype, D):
    """No multiple of 8: the plain path; 264: the wide kernels, on the
    tensor cores in bf16 and f16, the f32 CUDA-core ones in f32."""
    want = ("plain" if D % 8 else "wide_f32" if dtype == torch.float32
            else "wide_wgmma")
    assert fa._attention_route(dtype, D) == want


@pytest.mark.parametrize("sq,sk", [(4, 16), (16, 5)])
def test_cpu_forward_takes_dense_where_the_reference_falls_back(sq, sk):
    """A length under 8: the reference's flash_attention takes
    ``_fallback`` (no Pallas call), so the CPU forward is ``_dense`` and
    equals the reference's result to bf16's few ulps."""
    D = 32
    (jq, jk, jv), (tq, tk, tv) = _inputs(sq * sk, HQ, D, jnp.bfloat16,
                                         sq=sq, sk=sk)
    o, lse = fa._flash_forward(tq, tk, tv, False)
    ro, rlse = fa._dense(tq, tk, tv, False, D ** -0.5)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    ref = jax_fa.flash_attention(jq, jk, jv, causal=False)
    np.testing.assert_allclose(_f32(o), _f32(ref),
                               atol=O_ATOL[jnp.bfloat16])
