"""Parity of the PyTorch port's fused ops (ray_tpu_torch.ops.fused) with the
JAX reference (ray_tpu.ops.fused), on the CPU.

``rms_norm_fused`` is compared with the reference's Pallas kernel in
interpret mode at a shape its kernel tiles, and with the reference's
unfused formula at shapes where the reference takes it. The Triton kernel
is held against the plain version on the card by
tests/test_torch_kernels.py and chip_smoke.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

# The suite runs in several worker processes on one machine: one intra-op
# thread per process keeps these tests from starving the timing-sensitive
# engine tests that run beside them.
torch.set_num_threads(1)

jax_fused = importlib.import_module("ray_tpu.ops.fused")
fused = importlib.import_module("ray_tpu_torch.ops.fused")

# f32: the same formula, summed in another order. bf16: both compute in
# f32 and round once (kernel shapes) or twice (the unfused formula: the
# normalised x, then the product with w) at the same places, so a result
# may differ by one bf16 ulp (2**-8 to 2**-7 of the value) where the f32
# values round on either side of a boundary.
RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def _inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1.0 + 0.5 * rng.standard_normal(shape[-1:])).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return (jnp.asarray(x, jdt), jnp.asarray(w),
            torch.from_numpy(x).to(dtype), torch.from_numpy(w))


def _close(got, ref, dtype):
    ref = torch.from_numpy(np.array(jnp.asarray(ref, jnp.float32)))
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), ref, rtol=RTOL[dtype],
                               atol=RTOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(512, 64), (2, 256, 64)],
                         ids=["rows512", "batched"])
def test_rms_norm_fused_matches_pallas_interpret(shape, dtype):
    jx, jw, tx, tw = _inputs(0, shape, dtype)
    ref = jax_fused.rms_norm_fused(jx, jw, interpret=True)
    before = fused.launches
    out = fused.rms_norm_fused(tx, tw)
    assert fused.launches == before
    assert out.shape == tx.shape
    _close(out, ref, dtype)
    torch.testing.assert_close(out, fused._rms_plain(tx, tw, 1e-6), atol=0,
                               rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(300, 64), (16, 12)],
                         ids=["ragged_rows", "d_not_8"])
def test_rms_norm_fused_fallback_shapes_match_reference(shape, dtype):
    """Rows that are no multiple of the block, or D % 8: the reference's
    unfused formula, which casts before the multiply by w."""
    jx, jw, tx, tw = _inputs(1, shape, dtype)
    ref = jax_fused.rms_norm_fused(jx, jw, interpret=True)
    _close(fused.rms_norm_fused(tx, tw), ref, dtype)
    torch.testing.assert_close(fused.rms_norm_fused(tx, tw),
                               fused._rms_unfused(tx, tw, 1e-6),
                               atol=0, rtol=0)


def test_rms_norm_fused_rejects_mismatched_weight():
    with pytest.raises(ValueError):
        fused.rms_norm_fused(torch.ones(8, 16), torch.ones(8))


def test_softmax_cross_entropy_matches_reference():
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((4, 16, 32))).astype(np.float32)
    targets = rng.integers(0, 32, (4, 16)).astype(np.int32)
    ref = jax_fused.softmax_cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(targets))
    out = fused.softmax_cross_entropy(torch.from_numpy(logits),
                                      torch.from_numpy(targets))
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-6)
