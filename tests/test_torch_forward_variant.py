"""The flash kernels' rules of shapes (which forward and which backward
kernels a CUDA input takes) and the CPU path, which the rules do not touch:
a CPU tensor takes the plain version with the kernel's rounding points
(``_dense_kernel``), launches nothing, and agrees with the JAX reference's
Pallas kernel run in interpret mode (as tests/test_ops.py runs it; the
backward's match is in tests/test_torch_ops.py).

The kernels themselves are held against the plain version on the card by
tests/test_torch_kernels.py and chip_smoke.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax_fa = importlib.import_module("ray_tpu.ops.flash_attention")
fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

# bf16 against the reference: both round the scaled q to bf16 and keep f32
# scores; the reference's online softmax rounds p against its running
# maximum, a block at a time, the plain version against the row's; one
# bf16 ulp of an O(1) output is 2**-8 ~ 4e-3, so a few (as
# tests/test_torch_ops.py allows).
BF16_ATOL = 2e-2
# LSE is f32 of bf16 scores: a few ulps of scores of size ~|lse|.
LSE_ATOL = 3e-2


RULE = [(torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
        (torch.bfloat16, 32, "wgmma"), (torch.bfloat16, 40, "wgmma"),
        (torch.bfloat16, 96, "wgmma"), (torch.float32, 64, "tiled_f32"),
        (torch.float32, 128, "tiled_f32")]


@pytest.mark.parametrize("dtype,D,variant", RULE)
def test_forward_variant_rule(dtype, D, variant):
    """Tensor cores for bf16 at every multiple of 8 up to 256 (the kernel's
    instances of width 64, 128 and 256, zero-padded between them); f32
    stays on the CUDA cores, the tiled f32 kernels (TF32 would break its
    limit)."""
    assert fa._forward_variant(dtype, D) == variant


# The backward pair (dQ and dK/dV): the forward's rule; f32 up to 256
# takes the tiled f32 pair (CUDA cores, f32 products: its limit
# GRAD_ROW_TOL and the f32 gradient checks rest on them).
BACKWARD_RULE = [(dtype, D, "tiled_f32" if dtype == torch.float32 else v)
                 for dtype, D, v in RULE]


@pytest.mark.parametrize("dtype,D,variant", BACKWARD_RULE)
def test_backward_variant_rule(dtype, D, variant):
    """The backward pair (dQ and dK/dV) runs the kernels of the forward's
    variant, one rule for both directions: f32 the tiled f32 forward and
    pair, bf16 the tensor cores."""
    assert fa._forward_variant(dtype, D) == variant
    _, library, suffix = fa._LIBRARIES[variant]
    for kind in ("dq", "dkv"):
        assert (library, f"flash_attention_bwd_{kind}{suffix}") \
            in fa._SIGNATURES


def _counts():
    return (fa.launches, fa.wgmma_launches, fa.tiled_f32_launches,
            fa.simt_launches)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("grouped", [False, True])
def test_cpu_forward_takes_plain_version_at_wgmma_shapes(D, grouped):
    """bf16 at a head_dim the tensor-core kernel takes on the card: on the
    CPU the forward is the plain version with the kernel's rounding points
    (no launch counted) and agrees with the reference's Pallas kernel in
    interpret mode, O and LSE."""
    B, Hq, S = 1, 4, 64
    Hkv = 2 if grouped else Hq
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    before = _counts()
    o, lse = fa._flash_forward(tq, tk, tv, True)
    assert _counts() == before
    ro, rlse = fa._dense_kernel(tq, tk, tv, True, D ** -0.5)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)

    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    if grouped:
        ref = jax_fa._flash_forward_grouped(jq, jk, jv, True, D ** -0.5,
                                            32, 32, True)
        ref_lse = None   # the grouped launch returns O only
    else:
        ref, ref_lse = jax_fa._flash_forward(jq, jk, jv, True, D ** -0.5,
                                             32, 32, True)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=BF16_ATOL)
    if ref_lse is not None:
        np.testing.assert_allclose(lse.numpy(),
                                   np.asarray(ref_lse[:, :, 0]),
                                   atol=LSE_ATOL)
