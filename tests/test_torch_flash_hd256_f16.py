"""The plain versions that the card holds the tensor-core flash kernels
against at head_dim 256 and in float16 (``_dense_kernel``, which the CPU
forward runs at these shapes, and ``_dense_backward``), held against the
JAX reference's Pallas kernels run in interpret mode, on the CPU, as
tests/test_torch_ops.py holds them at the flagship's widths.

The cases are the shapes the tensor-core kernels took over from the
CUDA-core ones: head_dim 256 in bf16 and f16, and f16 at head_dim 64 and
128. They cover MHA, GQA with one KV head (Gemma-2B's attention: 8 query
heads over 1 KV head at head_dim 256), causal and not. On the CPU the
wrappers run the plain version and launch nothing.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax_fa = importlib.import_module("ray_tpu.ops.flash_attention")
fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

# (dtype, head_dim): the new tensor-core shapes.
SHAPES = [(jnp.bfloat16, 256), (jnp.float16, 64), (jnp.float16, 128),
          (jnp.float16, 256)]
IDS = ["bf16-256", "f16-64", "f16-128", "f16-256"]
TORCH = {jnp.bfloat16: torch.bfloat16, jnp.float16: torch.float16}

# Forward output, absolute. The reference and the plain version
# (``_dense_kernel``) both round q * scale to the input type, keep f32
# scores, round p before P.V and round O once; the reference rounds p
# against its running maximum, a block at a time, the plain version
# against the row's, so a p may round to a neighbour, and O (of size up to
# ~2) moves by a few ulps of itself: one bf16 ulp of an O(1) value is
# 2**-8, one f16 ulp 2**-11, and the limits allow about five (set when the
# plain version still rounded the scores to the input type, which moved
# them more).
O_ATOL = {jnp.bfloat16: 2e-2, jnp.float16: 2.5e-3}
# LSE is f32 of scores rounded as above: a few ulps of scores of the size
# of |lse| (up to ~6).
LSE_ATOL = {jnp.bfloat16: 3e-2, jnp.float16: 4e-3}
# Backward, max|port - ref| over the tensor's largest |ref|: the plain
# backward is given the reference's own O and LSE, so both round P and dS
# to the input type at the same places, and a rounding that flips on a
# summation-order difference moves a gradient by one ulp of a term (bf16
# 2**-8, f16 2**-11 of the tensor's largest element); the f16 limit
# allows two.
BWD_REL = {jnp.bfloat16: 2.0 ** -8, jnp.float16: 2.0 ** -10}


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
    return (fa.launches, fa.dq_launches, fa.dkv_launches)


@pytest.mark.parametrize("dtype,D", SHAPES, ids=IDS)
@pytest.mark.parametrize("causal", [True, False])
def test_dense_forward_matches_pallas_interpret(dtype, D, causal):
    """MHA: O and LSE of the plain forward against the reference's
    ``_flash_forward`` (two 32-row query blocks, two 32-key tiles)."""
    B, H, S = 1, 2, 64
    (jq, jk, jv), (tq, tk, tv) = _inputs(D + causal, [(B, H, S, D)] * 3,
                                         dtype)
    ref_o, ref_lse = jax_fa._flash_forward(jq, jk, jv, causal, D ** -0.5,
                                           32, 32, True)
    before = _launches()
    o, lse = fa._flash_forward(tq, tk, tv, causal)
    assert _launches() == before
    assert o.dtype == TORCH[dtype] and lse.dtype == torch.float32
    assert fa._forward_variant(o.dtype, D) == "wgmma"
    np.testing.assert_allclose(_f32(o), _f32(ref_o), atol=O_ATOL[dtype])
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse[:, :, 0]),
                               atol=LSE_ATOL[dtype])


@pytest.mark.parametrize("dtype,D", SHAPES, ids=IDS)
@pytest.mark.parametrize("causal", [True, False])
def test_grouped_forward_one_kv_head_matches_pallas_interpret(dtype, D,
                                                              causal):
    """GQA with one KV head (group 4): ``flash_attention_grouped`` on the
    CPU (the plain ``_dense_kernel`` arithmetic, K/V never expanded)
    against the reference's grouped Pallas launch."""
    B, Hq, Hkv, S = 1, 4, 1, 64
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        3 * D + causal, [(B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)],
        dtype)
    ref = jax_fa.flash_attention_grouped(jq, jk, jv, causal=causal,
                                         block_q=32, block_k=32,
                                         interpret=True)
    before = _launches()
    out = fa.flash_attention_grouped(tq, tk, tv, causal=causal)
    assert _launches() == before
    assert out.dtype == TORCH[dtype]
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=O_ATOL[dtype])
    # The wrapper's result is the plain grouped version's with the
    # kernel's rounding points, exactly.
    plain = fa._dense_kernel(tq, tk, tv, causal, D ** -0.5)[0]
    assert torch.equal(out, plain)


@pytest.mark.parametrize("dtype,D", SHAPES, ids=IDS)
@pytest.mark.parametrize("causal", [True, False])
def test_dense_backward_matches_pallas_interpret_vjp(dtype, D, causal):
    """dq, dk, dv of the plain backward against ``jax.vjp`` of the
    reference's ``flash_attention`` (its ``_flash_bwd_rule``: the dQ and
    dK/dV Pallas kernels), both from the reference forward's O and LSE, at
    S=128 (four 32-row blocks each way)."""
    B, H, S = 1, 2, 128
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(
        5 * D + causal, [(B, H, S, D)] * 4, dtype)
    _, vjp = jax.vjp(lambda q, k, v: jax_fa.flash_attention(
        q, k, v, causal=causal, block_q=32, block_k=32, interpret=True),
        jq, jk, jv)
    ref = vjp(jdo)
    ro, rlse = jax_fa._flash_forward(jq, jk, jv, causal, D ** -0.5, 32, 32,
                                     True)
    o = torch.from_numpy(np.array(_f32(ro))).to(TORCH[dtype])
    lse = torch.from_numpy(np.array(rlse[:, :, 0]))
    before = _launches()
    grads = fa._flash_backward(tq, tk, tv, o, lse, tdo, causal, D ** -0.5)
    assert _launches() == before
    assert fa._forward_variant(tq.dtype, D) == "wgmma"
    for name, r, g in zip(("dq", "dk", "dv"), ref, grads):
        assert g.dtype == TORCH[dtype], name
        r32 = _f32(r)
        rel = np.abs(r32 - _f32(g)).max() / np.abs(r32).max()
        assert rel <= BWD_REL[dtype], (name, rel)
