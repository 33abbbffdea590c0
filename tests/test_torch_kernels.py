"""The port's hand-written kernels (CUDA C++ and Triton) against their
plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode). This file imports no JAX, so it runs on a machine that
has only PyTorch: ``python -m pytest tests/test_torch_kernels.py -m cuda``.
"""

import importlib

import numpy as np
import pytest
import torch

# The limits, each with its reason, are shared with chip_smoke.py.
from ray_tpu_torch.testing import (
    FWD_DIGESTS,
    GRAD_ROW_TOL,
    LSE_TOL,
    O_ROW_TOL,
    RMS_TOL,
    RMS_TOL_CAST_FIRST,
    delta_error,
    dense_dq_f64,
    digest_inputs,
    grad_row_error,
    seeded_qkv,
    tensor_digest,
)

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")
fused = importlib.import_module("ray_tpu_torch.ops.fused")


def _assert_close(o, lse, ro, rlse):
    d = (o.float() - ro.float()).abs().amax(-1)
    scale = ro.float().abs().amax(-1).clamp_min(1e-30)
    err_row = (d / scale).max().item()
    assert err_row <= O_ROW_TOL[o.dtype], err_row
    lim = LSE_TOL[o.dtype] * (rlse.abs() + 1)
    bad = ((lse - rlse).abs() > lim).sum().item()
    assert bad == 0, ((lse - rlse).abs() - lim).max().item()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


_qkv = seeded_qkv


# Head dims up to 256 in each dtype, through the kernel of the rule: f32
# on the tiled f32 kernel (CUDA cores), bf16 and f16 on the tensor-core
# one (a width between 64, 128 and 256 on the next instance up).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("Hq,Hkv,Sq,Sk,D", [
    (4, 4, 128, 128, 64), (8, 2, 200, 200, 64), (2, 1, 77, 131, 8),
    (4, 2, 64, 64, 128), (2, 2, 1, 50, 16), (4, 4, 130, 70, 40),
    (2, 2, 128, 128, 256), (4, 2, 77, 131, 200), (2, 1, 200, 200, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda_device, dtype, Hq, Hkv, Sq, Sk, D,
                                    causal):
    q, k, v = _qkv(0, 2, Hq, Hkv, Sq, Sk, D, dtype, cuda_device)
    before = fa.launches
    o, lse = fa._flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ro, rlse = fa._dense_kernel(q, k, v, causal, D ** -0.5)
    _assert_close(o, lse, ro, rlse)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda_device):
    """D=12 takes the plain route (no launch, one plain route counted)
    and equals it; f16 at head_dim 16 runs the tensor-core kernel (the
    64-wide instance, zero-padded); head_dim 264 (f32) launches
    the f32 wide kernel and equals the plain version; a dtype no kernel takes
    and a non-contiguous input still raise."""
    q, k, v = _qkv(1, 1, 2, 2, 16, 16, 12, torch.float32, cuda_device)
    before = fa.launches, fa.plain_routes
    out = fa.flash_attention(q, k, v)
    assert (fa.launches, fa.plain_routes) == (before[0], before[1] + 1)
    torch.testing.assert_close(out, fa._fallback(q, k, v, True, 12 ** -0.5),
                               atol=0, rtol=0)
    q, k, v = _qkv(1, 1, 2, 2, 16, 16, 16, torch.float32, cuda_device)
    before = fa.wgmma_launches
    out = fa.flash_attention(q.half(), k.half(), v.half())
    torch.cuda.synchronize()
    assert out.dtype == torch.float16 and fa.wgmma_launches == before + 1
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(2, 3), k, v)
    q, k, v = _qkv(1, 1, 2, 2, 16, 16, 264, torch.float32, cuda_device)
    before = fa.wide_f32_launches, fa.plain_routes
    out = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert (fa.wide_f32_launches, fa.plain_routes) == (before[0] + 1,
                                                       before[1])
    torch.testing.assert_close(
        out, fa._dense_kernel(q, k, v, True, 264 ** -0.5)[0], atol=1e-5,
        rtol=1e-4)
    q, k, v = _qkv(1, 1, 2, 1, 16, 16, 16, torch.float32, cuda_device)
    with pytest.raises(NotImplementedError):
        fa.flash_attention_grouped(q.requires_grad_(), k, v)


# The tensor-core forward (bf16 and f16) at its instances' widths 64, 128
# and 256 and at widths between them, which run the next instance up with
# TMA zero-filling the columns past D: 8 and 32 (a 64-column box wider than
# the tensor), 80 and 96 (Phi-2's and Phi-3-mini's heads), 136 (8 real
# columns in the third column block, the fourth wholly past D) and 200.
# MHA and GQA groups 2, 4 and 8 (one KV head, as Gemma-2B's attention),
# lengths that fill 128-row tiles, ragged ones, the training length and
# Sq != Sk (the reference's top-left causal mask).
WGMMA_TEST_DIMS = [8, 32, 64, 80, 96, 128, 136, 200, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", WGMMA_TEST_DIMS)
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2), (8, 2), (8, 1)])
@pytest.mark.parametrize("Sq,Sk", [(128, 128), (200, 200), (2048, 2048),
                                   (77, 131)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_kernel_matches_plain(cuda_device, dtype, D, Hq, Hkv,
                                          Sq, Sk, causal):
    q, k, v = _qkv(6, 2, Hq, Hkv, Sq, Sk, D, dtype, cuda_device)
    before = _forward_counts()
    o, lse = fa._flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    after = _forward_counts()
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == "wgmma") for n in after}
    assert o.dtype == dtype
    ro, rlse = fa._dense_kernel(q, k, v, causal, D ** -0.5)
    _assert_close(o, lse, ro, rlse)


def _forward_counts():
    return {"wgmma": fa.wgmma_launches, "tiled_f32": fa.tiled_f32_launches,
            "simt": fa.simt_launches, "wide": fa.wide_launches,
            "wide_wgmma": fa.wide_wgmma_launches,
            "wide_f32": fa.wide_f32_launches}


# Head dims 64 and 256 have power-of-two scales, where rounding q * scale
# to the input type is exact (on inputs that keep it inside f16's normal
# range): the forward gives, bit for bit, what it gave when it scaled the
# f32 scores (digests of that earlier forward's O and LSE, recorded on an
# H100, in ray_tpu_torch/testing.py).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bfloat16", "float16"])
@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_forward_power_of_two_scale_is_bit_identical(
        cuda_device, dtype, D, causal):
    q, k, v = digest_inputs(D, dtype, cuda_device)
    o, lse = fa._flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    key = f"{str(dtype).split('.')[1]}-D{D}-{'causal' if causal else 'full'}"
    assert tensor_digest(o, lse) == FWD_DIGESTS[key]


def _row_offsets(t, size=1.5):
    """t with each row (the last axis) moved by +size or -size in turn, so
    consecutive rows differ by 2 * size in every column."""
    sign = 1 - 2 * (torch.arange(t.shape[-2], device=t.device) % 2)
    return (t.float() + size * sign[:, None]).to(t.dtype).contiguous()


# Rows that differ by large offsets: a tensor map that read past column D
# into the next row (in place of TMA's zero fill) or a store that reached
# past column D would move every score of the row by ~D * 2.25 * scale, far
# outside the limits. The widths leave a box partly (8, 80, 136, 200) or,
# at 136, wholly past D.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", [8, 80, 136, 200])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_zero_fills_past_head_dim(cuda_device, dtype, D, causal):
    q, k, v = (_row_offsets(t) for t in _qkv(
        16, 2, 4, 2, 200, 200, D, dtype, cuda_device))
    o, lse = fa._flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    ro, rlse = fa._dense_kernel(q, k, v, causal, D ** -0.5)
    _assert_close(o, lse, ro, rlse)
    k, v = (torch.repeat_interleave(t, 2, dim=1) for t in (k, v))
    o, lse = fa._flash_forward(q, k, v, causal)
    do = _row_offsets(_qkv(17, 2, 4, 4, 200, 200, D, dtype,
                           cuda_device)[0])
    before = _backward_counts()
    grads = fa._flash_backward(q, k, v, o, lse, do, causal, D ** -0.5)
    torch.cuda.synchronize()
    got, want = _backward_launched(before, "wgmma")
    assert got == want
    ref = fa._dense_backward(q, k, v, o, lse, do, causal, D ** -0.5)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert bool(torch.isfinite(g).all()), name
        err = grad_row_error(g, r)
        assert err <= GRAD_ROW_TOL[dtype], (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,variant", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 40, "wgmma"),
    (torch.float32, 64, "tiled_f32"), (torch.float16, 64, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 264, "wide_f32"),
    (torch.bfloat16, 512, "wide_wgmma"), (torch.float16, 256, "wgmma"),
    (torch.float16, 200, "wgmma"), (torch.float32, 256, "tiled_f32"),
    (torch.float16, 1024, "wide_wgmma"), (torch.bfloat16, 1032, "wide_wgmma"),
    (torch.float16, 2048, "wide_wgmma")])
def test_flash_forward_launches_the_variant_of_its_rule(cuda_device, dtype,
                                                        D, variant):
    q, k, v = _qkv(7, 1, 2, 2, 96, 96, D, dtype, cuda_device)
    before = _forward_counts()
    fa._flash_forward(q, k, v, True)
    torch.cuda.synchronize()
    after = _forward_counts()
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == variant) for n in after}


# Head dims above 256 take the wide kernels (the head dimension of the
# output split across blocks): bf16 and f16 the tensor-core forward, dQ
# and dK/dV, f32 the f32 CUDA-core forward, dQ and dK/dV. 264 has a last
# chunk of 8 columns, 384 is no multiple of the tensor-core forward's
# 256-column chunk, 1024 the widest whose Q rows the tensor-core forward
# holds (K and V stream in dK/dV), 1032 and 2048 stream Q in the forward
# (1032: 8 real columns in the last 64-column box and the last chunk of
# O, dQ and dK/dV). MHA and GQA forward, ragged lengths, Sq != Sk.
WIDE_DIMS = [264, 384, 512, 1024, 1032, 2048]


def _wide_variant(dtype):
    return "wide_f32" if dtype == torch.float32 else "wide_wgmma"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("Hq,Hkv,Sq,Sk", [(4, 2, 77, 131), (2, 2, 130, 130)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wide_kernel_matches_plain(cuda_device, dtype, D, Hq, Hkv, Sq,
                                         Sk, causal):
    q, k, v = _qkv(13, 2, Hq, Hkv, Sq, Sk, D, dtype, cuda_device)
    before = _forward_counts()
    o, lse = fa._flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    after = _forward_counts()
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == _wide_variant(dtype)) for n in after}
    ro, rlse = fa._dense_kernel(q, k, v, causal, D ** -0.5)
    _assert_close(o, lse, ro, rlse)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("D", WIDE_DIMS)
@pytest.mark.parametrize("Sq,Sk", [(77, 131), (130, 130), (3, 50)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wide_backward_matches_plain(cuda_device, dtype, D, Sq, Sk,
                                           causal):
    q, k, v = _qkv(14, 2, 2, 2, Sq, Sk, D, dtype, cuda_device)
    do = _qkv(15, 2, 2, 2, Sq, Sq, D, dtype, cuda_device)[0]
    o, lse = fa._flash_forward(q, k, v, causal)
    before = _backward_counts()
    grads = fa._flash_backward(q, k, v, o, lse, do, causal, D ** -0.5)
    torch.cuda.synchronize()
    got, want = _backward_launched(before, _wide_variant(dtype))
    assert got == want
    ref = fa._dense_backward(q, k, v, o, lse, do, causal, D ** -0.5)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert g.dtype == dtype and bool(torch.isfinite(g).all()), name
        err = grad_row_error(g, r)
        assert err <= GRAD_ROW_TOL[dtype], (name, err)


# The tensor-core wide kernels at head_dim 4096 on a short length: 64
# boxes of the score reduction, 16 chunks of O and dQ and 32 of dK/dV,
# GQA over 2 KV heads in the forward.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wide_wgmma_at_4096_matches_plain(cuda_device, dtype, causal):
    D = 4096
    q, k, v = _qkv(16, 1, 4, 2, 40, 72, D, dtype, cuda_device)
    before = _forward_counts()
    o, lse = fa._flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    after = _forward_counts()
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == "wide_wgmma") for n in after}
    ro, rlse = fa._dense_kernel(q, k, v, causal, D ** -0.5)
    _assert_close(o, lse, ro, rlse)
    k, v = (torch.repeat_interleave(t, 2, dim=1) for t in (k, v))
    o, lse = fa._flash_forward(q, k, v, causal)
    do = _qkv(17, 1, 4, 4, 40, 40, D, dtype, cuda_device)[0]
    before = _backward_counts()
    grads = fa._flash_backward(q, k, v, o, lse, do, causal, D ** -0.5)
    torch.cuda.synchronize()
    got, want = _backward_launched(before, "wide_wgmma")
    assert got == want
    ref = fa._dense_backward(q, k, v, o, lse, do, causal, D ** -0.5)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert g.dtype == dtype and bool(torch.isfinite(g).all()), name
        err = grad_row_error(g, r)
        assert err <= GRAD_ROW_TOL[dtype], (name, err)


# The tensor-core wide kernels on rows offset by +-1.5 in turn (as
# test_flash_wgmma_zero_fills_past_head_dim): at D=264 the forward's second
# 256-column chunk holds 8 real columns and three boxes wholly past D, the
# dK/dV kernel's third 128-column chunk 8 real columns; a box that read
# past column D into the next row, or a store past it, would move every
# score of the row far outside the limits.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wide_wgmma_zero_fills_past_head_dim(cuda_device, dtype,
                                                   causal):
    D = 264
    q, k, v = (_row_offsets(t) for t in _qkv(
        18, 2, 4, 2, 200, 200, D, dtype, cuda_device))
    before = _forward_counts()
    o, lse = fa._flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.wide_wgmma_launches == before["wide_wgmma"] + 1
    ro, rlse = fa._dense_kernel(q, k, v, causal, D ** -0.5)
    _assert_close(o, lse, ro, rlse)
    k, v = (torch.repeat_interleave(t, 2, dim=1) for t in (k, v))
    o, lse = fa._flash_forward(q, k, v, causal)
    do = _row_offsets(_qkv(19, 2, 4, 4, 200, 200, D, dtype,
                           cuda_device)[0])
    before = _backward_counts()
    grads = fa._flash_backward(q, k, v, o, lse, do, causal, D ** -0.5)
    torch.cuda.synchronize()
    got, want = _backward_launched(before, "wide_wgmma")
    assert got == want
    ref = fa._dense_backward(q, k, v, o, lse, do, causal, D ** -0.5)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert bool(torch.isfinite(g).all()), name
        err = grad_row_error(g, r)
        assert err <= GRAD_ROW_TOL[dtype], (name, err)


# The f32 wide forward, dQ and dK/dV (the "wide_f32" variant; its dQ
# writes the delta the dK/dV kernel reads): 264
# (a last 32-column box of 8 columns, a second 256-column slice of O of 8),
# 384, 512 and 1032 (a third slice of 8 columns); GQA over 2 KV heads and
# one; ragged lengths, Sq > Sk and Sq < Sk; causal and not. The backward
# repeats K and V to the query heads, as flash_attention's caller does.
@pytest.mark.cuda
@pytest.mark.parametrize("D", [264, 384, 512, 1032])
@pytest.mark.parametrize("Hkv", [2, 1])
@pytest.mark.parametrize("Sq,Sk", [(77, 131), (130, 130), (200, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wide_f32_kernels_match_plain(cuda_device, D, Hkv, Sq, Sk,
                                            causal):
    q, k, v = _qkv(20, 2, 4, Hkv, Sq, Sk, D, torch.float32, cuda_device)
    before = _forward_counts()
    o, lse = fa._flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    after = _forward_counts()
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == "wide_f32") for n in after}
    ro, rlse = fa._dense_kernel(q, k, v, causal, D ** -0.5)
    _assert_close(o, lse, ro, rlse)
    k, v = (torch.repeat_interleave(t, 4 // Hkv, dim=1) for t in (k, v))
    o, lse = fa._flash_forward(q, k, v, causal)
    do = _qkv(21, 2, 4, 4, Sq, Sq, D, torch.float32, cuda_device)[0]
    before = _backward_counts()
    grads = fa._flash_backward(q, k, v, o, lse, do, causal, D ** -0.5)
    torch.cuda.synchronize()
    got, want = _backward_launched(before, "wide_f32")
    assert got == want
    ref = fa._dense_backward(q, k, v, o, lse, do, causal, D ** -0.5)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert g.dtype == torch.float32, name
        assert bool(torch.isfinite(g).all()), name
        err = grad_row_error(g, r)
        assert err <= GRAD_ROW_TOL[torch.float32], (name, err)


# The f32 wide kernels on rows offset by +-1.5 in turn (as
# test_flash_wgmma_zero_fills_past_head_dim): at D=264 the forward's last
# 32-column box holds 8 real columns and its second slice of O 8 of 256,
# dK/dV's third slice 8 of 128; a copy that read past column D into the
# next row, or a store past it, would move every score of the row far
# outside the limits. On these rows a dQ row sums terms that cancel to
# many times less than their size, and the f32 plain backward's dQ reads
# above GRAD_ROW_TOL against the same formula in float64 (ROADMAP C.9):
# dQ (the f32 wide dQ kernel's) is held against the float64 version, dK
# and dV against the f32 plain backward, as everywhere else.
@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wide_f32_zero_fills_past_head_dim(cuda_device, causal):
    D = 264
    q, k, v = (_row_offsets(t) for t in _qkv(
        22, 2, 4, 2, 200, 200, D, torch.float32, cuda_device))
    o, lse = fa._flash_forward(q, k, v, causal)
    ro, rlse = fa._dense_kernel(q, k, v, causal, D ** -0.5)
    _assert_close(o, lse, ro, rlse)
    k, v = (torch.repeat_interleave(t, 2, dim=1) for t in (k, v))
    o, lse = fa._flash_forward(q, k, v, causal)
    do = _row_offsets(_qkv(23, 2, 4, 4, 200, 200, D, torch.float32,
                           cuda_device)[0])
    before = _backward_counts()
    grads = fa._flash_backward(q, k, v, o, lse, do, causal, D ** -0.5)
    torch.cuda.synchronize()
    got, want = _backward_launched(before, "wide_f32")
    assert got == want
    ref = fa._dense_backward(q, k, v, o, lse, do, causal, D ** -0.5)
    ref = (dense_dq_f64(q, k, v, o, lse, do, causal, D ** -0.5), *ref[1:])
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert bool(torch.isfinite(g).all()), name
        err = grad_row_error(g, r)
        assert err <= GRAD_ROW_TOL[torch.float32], (name, err)


# The wide dQ kernels on their own (``_launch_dq``): the tensor-core one
# (bf16, f16: 264 has a second 256-column chunk of 8 columns, 384 a
# ragged one, 1024 streams Q and dO with K and V, 1032 a last chunk of 8
# columns, 2048 32 boxes) and the f32 one
# (264 and 1032: a last slice of 8 columns; 2048: eight slices), against
# the plain backward's dQ per row (f32: the same formula in float64, as
# ROADMAP C.9 proposes: at D=2048 the f32 plain dQ's causal first row, 0
# in exact arithmetic, holds more rounding noise than GRAD_ROW_TOL allows
# against either kernel, the old one included), their delta against
# rowsum(dO * O) in f32, and the CUDA-core wide dQ of
# flash_attention_wide.cu (the kernel they replace, called through its C
# entry point) on the same inputs. Ragged lengths, Sq > Sk and Sq < Sk,
# Sq = 3, causal and not.
WIDE_DQ_CASES = ([(dt, D) for dt in (torch.bfloat16, torch.float16)
                  for D in (264, 384, 512, 1024, 1032, 2048)]
                 + [(torch.float32, D) for D in (264, 512, 1024, 1032, 2048)])


def _cuda_core_dq(q, k, v, o, lse, do, causal):
    """The CUDA-core wide dQ kernel of flash_attention_wide.cu on any
    dtype, through its C entry point (no delta buffer); counts no
    launch."""
    B, H, Sq, D = q.shape
    dq = torch.empty_like(q)
    err = fa._kernel_fn("flash_attention_wide", "flash_attention_bwd_dq_wide")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), None, B * H, Sq,
        k.shape[2], D, D ** -0.5, int(causal), fa._DTYPE_CODE[q.dtype],
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return dq


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", WIDE_DQ_CASES)
@pytest.mark.parametrize("Sq,Sk", [(77, 131), (130, 130), (3, 50),
                                   (200, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wide_dq_kernels_match_plain(cuda_device, dtype, D, Sq, Sk,
                                           causal):
    variant = fa._forward_variant(dtype, D)
    assert variant == ("wide_f32" if dtype == torch.float32
                       else "wide_wgmma")
    q, k, v = _qkv(24, 2, 2, 2, Sq, Sk, D, dtype, cuda_device)
    do = _qkv(25, 2, 2, 2, Sq, Sq, D, dtype, cuda_device)[0]
    o, lse = fa._flash_forward(q, k, v, causal)
    before = _backward_counts()
    dq, delta = fa._launch_dq(q, k, v, o, lse, do, causal, D ** -0.5)
    torch.cuda.synchronize()
    got = {n: c - before[n] for n, c in _backward_counts().items()}
    assert got == {n: int(n == f"dq_{variant}") for n in got}
    if dtype == torch.float32:
        ref = dense_dq_f64(q, k, v, o, lse, do, causal, D ** -0.5)
    else:
        ref = fa._dense_backward(q, k, v, o, lse, do, causal, D ** -0.5)[0]
    assert dq.dtype == dtype and bool(torch.isfinite(dq).all())
    assert grad_row_error(dq, ref) <= GRAD_ROW_TOL[dtype]
    assert delta.shape == (2, 2, Sq) and delta.dtype == torch.float32
    assert delta_error(delta, do, o) <= 1.0
    old = _cuda_core_dq(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert grad_row_error(dq, old) <= GRAD_ROW_TOL[dtype]


@pytest.mark.cuda
def test_flash_wide_dq_kernels_refuse_what_they_do_not_take(cuda_device):
    """No delta buffer, a head_dim the kernel does not take, another
    dtype: cudaErrorInvalidValue (1), no launch."""
    for dtype, D, name, lib in (
            (torch.bfloat16, 512, "flash_attention_bwd_dq_wide_wgmma",
             "flash_attention_wide_wgmma"),
            (torch.float32, 512, "flash_attention_bwd_dq_wide_f32",
             "flash_attention_wide_f32")):
        q, k, v = _qkv(26, 1, 2, 2, 64, 64, D, dtype, cuda_device)
        lse = torch.zeros((1, 2, 64), device=cuda_device)
        dq = torch.empty_like(q)
        fn = fa._kernel_fn(lib, name)
        stream = torch.cuda.current_stream().cuda_stream
        p = [t.data_ptr() for t in (q, k, v, q, q, lse, dq)]
        code = fa._DTYPE_CODE[dtype]
        assert fn(*p, None, 2, 64, 64, D, 0.1, 1, code, stream) == 1
        assert fn(*p, lse.data_ptr(), 2, 64, 64, D, 0.1, 1,
                  1 - code if code else 2, stream) == 1
        if dtype == torch.bfloat16:
            assert fn(*p, lse.data_ptr(), 2, 64, 64, 256, 0.1, 1, code,
                      stream) == 1
            assert fn(*p, lse.data_ptr(), 2, 64, 64, 1036, 0.1, 1, code,
                      stream) == 1


@pytest.mark.cuda
def test_flash_wide_wgmma_forward_refuses_what_it_does_not_take(cuda_device):
    """Above head_dim 1024 (Q streams from the pre-pass's buffer) no
    work buffer, or a misaligned one; a head_dim no multiple of 8:
    cudaErrorInvalidValue (1), no launch. At 1024 (Q held) no buffer is
    needed."""
    fn = fa._kernel_fn("flash_attention_wide_wgmma",
                       "flash_attention_fwd_wide_wgmma")
    stream = torch.cuda.current_stream().cuda_stream
    for D in (1024, 1032):
        q, k, v = _qkv(27, 1, 2, 2, 64, 64, D, torch.bfloat16, cuda_device)
        o = torch.empty_like(q)
        lse = torch.empty((1, 2, 64), device=cuda_device)
        work = torch.empty(q.numel() + 8, dtype=q.dtype, device=cuda_device)
        p = [t.data_ptr() for t in (q, k, v, o, lse)]
        shape = (1, 2, 2, 64, 64)
        want = 1 if D > 1024 else 0
        assert fn(*p, None, *shape, D, D ** -0.5, 1, 1, stream) == want
        assert fn(*p, work.data_ptr() + 2, *shape, D, D ** -0.5, 1, 1,
                  stream) == 1
        assert fn(*p, work.data_ptr(), *shape, D - 4, D ** -0.5, 1, 1,
                  stream) == 1
    torch.cuda.synchronize()


# The f32 forward up to head_dim 256 ("tiled_f32": the forward template
# of flash_attention_wide_f32.cu at instances whose block covers all of
# D), through _flash_forward: the instances' widths (64, 128, 256) and
# widths between them (8: the 64-column instance, one 32-column box a
# quarter full; 96: the 128-column one, its last box wholly past D; 200:
# the 256-column one, the last box 8 columns in), MHA and GQA down to one
# KV head, lengths that fill the tiles, ragged ones, Sq < Sk and the
# training length, causal and not: O and LSE against the plain version
# with the kernels' rounding points; a dropped 64-key tile of V in the
# plain version must read above the limit.
TILED_F32_FWD_DIMS = [8, 64, 96, 128, 200, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("D", TILED_F32_FWD_DIMS)
@pytest.mark.parametrize("Hkv", [8, 4, 1])
@pytest.mark.parametrize("Sq,Sk", [(128, 128), (200, 200), (77, 131),
                                   (2048, 2048)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tiled_f32_forward_matches_plain(cuda_device, D, Hkv, Sq, Sk,
                                               causal):
    B = 1 if Sq == 2048 else 2
    scale = D ** -0.5
    q, k, v = _qkv(40, B, 8, Hkv, Sq, Sk, D, torch.float32, cuda_device)
    before = _forward_counts()
    o, lse = fa._flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    after = _forward_counts()
    assert {n: after[n] - before[n] for n in after} == {
        n: int(n == "tiled_f32") for n in after}
    assert o.dtype == torch.float32 and bool(torch.isfinite(o).all())
    ro, rlse = fa._dense_kernel(q, k, v, causal, scale)
    _assert_close(o, lse, ro, rlse)
    t0 = 64 * ((Sk // 2) // 64)
    v_fault = v.clone()
    v_fault[:, :, t0:t0 + 64] = 0
    fo = fa._dense_kernel(q, k, v_fault, causal, scale)[0]
    fault = ((fo - ro).abs().amax(-1)
             / ro.abs().amax(-1).clamp_min(1e-30)).max().item()
    assert fault > O_ROW_TOL[torch.float32], fault


# The tiled f32 forward on rows offset by +-1.5 in turn (as
# test_flash_wgmma_zero_fills_past_head_dim): a copy that read past column
# D into the next row, or a store past it, would move every score of the
# row far outside the limits. GQA over 2 KV heads.
@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 96, 200, 248])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tiled_f32_forward_zero_fills_past_head_dim(cuda_device, D,
                                                          causal):
    q, k, v = (_row_offsets(t) for t in _qkv(
        41, 2, 4, 2, 200, 200, D, torch.float32, cuda_device))
    before = fa.tiled_f32_launches
    o, lse = fa._flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.tiled_f32_launches == before + 1
    ro, rlse = fa._dense_kernel(q, k, v, causal, D ** -0.5)
    _assert_close(o, lse, ro, rlse)


def _f32_forward_entry(name, q, k, v, causal):
    """(O, LSE) of an f32 forward C entry point of the f32 library (or of
    flash_attention_fwd.cu's, for the earlier kernel), counting no
    launch."""
    B, Hq, Sq, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    lib = (fa._LIBRARIES["simt"][0] if name == "flash_attention_fwd"
           else fa._LIBRARIES["tiled_f32"][0])
    err = fa._kernel_fn(lib, name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), B, Hq, k.shape[1], Sq, k.shape[2], D, D ** -0.5,
        int(causal), 0, torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return o, lse


# At head_dim 256 the tiled forward is the wide instance's shape and
# order of operations with Q held in shared memory rather than streamed
# again for every key tile: the two entry points agree bit for bit.
@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tiled_f32_forward_at_256_equals_the_wide_instance(
        cuda_device, causal):
    q, k, v = _qkv(42, 2, 4, 2, 200, 131, 256, torch.float32, cuda_device)
    tiled = _f32_forward_entry("flash_attention_fwd_tiled_f32", q, k, v,
                               causal)
    wide = _f32_forward_entry("flash_attention_fwd_wide_f32", q, k, v,
                              causal)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(tiled, wide))


# The earlier f32 forward (flash_attention_fwd.cu, reached by no rule
# since the tiled one took f32) still holds against the plain version:
# chip_smoke.py times it beside the tiled one.
@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 200, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_simt_f32_forward_still_matches_plain(cuda_device, D, causal):
    q, k, v = _qkv(43, 2, 4, 2, 77, 131, D, torch.float32, cuda_device)
    o, lse = _f32_forward_entry("flash_attention_fwd", q, k, v, causal)
    torch.cuda.synchronize()
    _assert_close(o, lse, *fa._dense_kernel(q, k, v, causal, D ** -0.5))


@pytest.mark.cuda
def test_flash_tiled_f32_forward_refuses_what_it_does_not_take(cuda_device):
    """A head_dim above 256 or no multiple of 8, another dtype, a query
    head count that the KV heads do not divide: cudaErrorInvalidValue (1),
    no launch."""
    fn = fa._kernel_fn(fa._LIBRARIES["tiled_f32"][0],
                       "flash_attention_fwd_tiled_f32")
    stream = torch.cuda.current_stream().cuda_stream
    for D, code, hkv in ((264, 0, 2), (60, 0, 2), (64, 1, 2), (64, 0, 3)):
        q, k, v = _qkv(44, 1, 2, 2, 64, 64, max(D, 64), torch.float32,
                       cuda_device)
        lse = torch.empty((1, 2, 64), device=cuda_device)
        o = torch.empty_like(q)
        assert fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), 1, 2, hkv, 64, 64, D, 0.1, 1, code,
                  stream) == 1


# The f32 backward pair up to head_dim 256 ("tiled_f32": the dQ and dK/dV
# templates of flash_attention_wide_f32.cu at instances whose block covers
# all of D), through _launch_dq / _launch_dkv: the instances' widths (64,
# 128, 256) and widths between them (8 and 32: the 64-column instance, 8
# a 16-column box half past D; 96; 200 and 248: the 256-column one, a last
# 32-column box partly past D), lengths that fill the tiles, ragged ones,
# Sq < Sk and the training length, causal and not. dQ against the float64
# formula (ROADMAP C.9: the f32 plain dQ's own rounding is of the limit's
# size where dP - delta cancels), dK and dV against the plain backward,
# delta against rowsum(dO * O); a dropped 64-row tile of dO in the plain
# version must read above the limit.
TILED_F32_DIMS = [8, 32, 64, 96, 128, 200, 248, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("D", TILED_F32_DIMS)
@pytest.mark.parametrize("Sq,Sk", [(128, 128), (200, 200), (77, 131),
                                   (2048, 2048)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tiled_f32_backward_matches_plain(cuda_device, D, Sq, Sk,
                                                causal):
    B, H = (1, 2) if Sq == 2048 else (2, 2)
    scale = D ** -0.5
    q, k, v = _qkv(30, B, H, H, Sq, Sk, D, torch.float32, cuda_device)
    do = _qkv(31, B, H, H, Sq, Sq, D, torch.float32, cuda_device)[0]
    o, lse = fa._flash_forward(q, k, v, causal)
    before = _backward_counts()
    dq, delta = fa._launch_dq(q, k, v, o, lse, do, causal, scale)
    dk, dv = fa._launch_dkv(q, k, v, o, lse, do, delta, causal, scale)
    torch.cuda.synchronize()
    got, want = _backward_launched(before, "tiled_f32")
    assert got == want
    ref = fa._dense_backward(q, k, v, o, lse, do, causal, scale)
    oracle = (dense_dq_f64(q, k, v, o, lse, do, causal, scale), *ref[1:])
    tol = GRAD_ROW_TOL[torch.float32]
    for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), oracle):
        assert g.dtype == torch.float32, name
        assert bool(torch.isfinite(g).all()), name
        err = grad_row_error(g, r)
        assert err <= tol, (name, err)
    assert delta.shape == (B, H, Sq) and delta.dtype == torch.float32
    assert delta_error(delta, do, o) <= 1.0
    t0 = 64 * ((Sq // 2) // 64)
    do_fault = do.clone()
    do_fault[:, :, t0:t0 + 64] = 0
    fault = fa._dense_backward(q, k, v, o, lse, do_fault, causal, scale)
    assert max(grad_row_error(f, r) for f, r in zip(fault, ref)) > tol


# The tiled f32 pair on rows offset by +-1.5 in turn (as
# test_flash_wide_f32_zero_fills_past_head_dim): a copy that read past
# column D into the next row, or a store past it, would move every score
# of the row far outside the limits; a causal first row's dQ, 0 in exact
# arithmetic, is exactly 0 (its delta summed in dP's order).
@pytest.mark.cuda
@pytest.mark.parametrize("D", [8, 96, 200, 248])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_tiled_f32_zero_fills_past_head_dim(cuda_device, D, causal):
    scale = D ** -0.5
    q, k, v = (_row_offsets(t) for t in _qkv(
        32, 2, 4, 4, 200, 200, D, torch.float32, cuda_device))
    do = _row_offsets(_qkv(33, 2, 4, 4, 200, 200, D, torch.float32,
                           cuda_device)[0])
    o, lse = fa._flash_forward(q, k, v, causal)
    before = _backward_counts()
    dq, dk, dv = fa._flash_backward(q, k, v, o, lse, do, causal, scale)
    torch.cuda.synchronize()
    got, want = _backward_launched(before, "tiled_f32")
    assert got == want
    ref = fa._dense_backward(q, k, v, o, lse, do, causal, scale)
    ref = (dense_dq_f64(q, k, v, o, lse, do, causal, scale), *ref[1:])
    for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert bool(torch.isfinite(g).all()), name
        err = grad_row_error(g, r)
        assert err <= GRAD_ROW_TOL[torch.float32], (name, err)
    if causal:
        assert not dq[:, :, 0].any()


@pytest.mark.cuda
def test_flash_tiled_f32_kernels_refuse_what_they_do_not_take(cuda_device):
    """A head_dim above 256 or no multiple of 8, no delta buffer, another
    dtype: cudaErrorInvalidValue (1), no launch."""
    lib = fa._LIBRARIES["tiled_f32"][1]
    dq_fn = fa._kernel_fn(lib, "flash_attention_bwd_dq_tiled_f32")
    dkv_fn = fa._kernel_fn(lib, "flash_attention_bwd_dkv_tiled_f32")
    stream = torch.cuda.current_stream().cuda_stream
    for D, code, with_delta in ((264, 0, True), (60, 0, True),
                                (64, 0, False), (64, 1, True)):
        q, k, v = _qkv(34, 1, 2, 2, 64, 64, max(D, 64), torch.float32,
                       cuda_device)
        lse = torch.zeros((1, 2, 64), device=cuda_device)
        delta = lse.data_ptr() if with_delta else None
        out = torch.empty_like(q)
        assert dq_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q.data_ptr(),
                     q.data_ptr(), lse.data_ptr(), out.data_ptr(), delta, 2,
                     64, 64, D, 0.1, 1, code, stream) == 1
        assert dkv_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q.data_ptr(),
                      lse.data_ptr(), delta, out.data_ptr(), out.data_ptr(),
                      2, 64, 64, D, 0.1, 1, code, stream) == 1


# A query or key length under 8 takes the plain route on the card, as the
# reference's wrappers fall back there (ROADMAP C.7): no launch, one
# plain_routes a call, the plain version's result exactly; so does the
# model's attention on a 4-token prompt.
@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Sk", [(4, 16), (16, 5)])
def test_short_lengths_launch_nothing_on_the_card(cuda_device, Sq, Sk):
    from ray_tpu_torch.models import transformer as tt

    D = 64
    q, k, v = _qkv(20, 2, 4, 4, Sq, Sk, D, torch.bfloat16, cuda_device)
    counts = (_forward_counts(), _backward_counts(), fa.plain_routes)
    out = fa.flash_attention(q, k, v)
    grouped = fa.flash_attention_grouped(q, k[:, :2].contiguous(),
                                         v[:, :2].contiguous())
    torch.cuda.synchronize()
    assert (_forward_counts(), _backward_counts()) == counts[:2]
    assert fa.plain_routes == counts[2] + 2
    assert torch.equal(out, fa._dense(q, k, v, True, D ** -0.5)[0])
    assert torch.equal(grouped, fa._dense(
        q, k[:, :2], v[:, :2], True, D ** -0.5)[0])
    mq, mk, mv = (t[:, :, :4].transpose(1, 2) for t in (q, k, v))
    before = fa.plain_routes
    dense = tt._attention_dense(mq, mk, mv)
    assert fa.plain_routes == before + 1
    assert _forward_counts() == counts[0]
    assert torch.equal(dense, tt._attention_einsum(mq, mk, mv))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 256),
                                     (torch.float16, 256)])
def test_flash_wgmma_kernel_refuses_misaligned_or_strided_input(cuda_device,
                                                                dtype, D):
    q, k, v = _qkv(8, 1, 2, 2, 64, 64, D, dtype, cuda_device)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype,
                          device=cuda_device)[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16
    before = fa.launches
    with pytest.raises(ValueError):
        fa._flash_forward(shifted, k, v, True)
    with pytest.raises(ValueError):
        fa._flash_forward(q.transpose(2, 3), k, v, True)
    assert fa.launches == before


# Backward kernels against the plain backward (_dense_backward), per row
# of dq, dk and dv (GRAD_ROW_TOL); a dropped 64-row tile of dO reads ~1
# (chip_smoke.py checks that it is caught).
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
# Sq = 3 rather than the forward's single row: with one causal row, dq and
# dk are exactly 0 and every element is rounding noise, which a relative
# check cannot hold.
@pytest.mark.parametrize("H,Sq,Sk,D", [
    (4, 128, 128, 64), (4, 200, 200, 64), (2, 77, 131, 16),
    (2, 64, 64, 128), (2, 3, 50, 40), (2, 130, 70, 40),
    (2, 128, 128, 256), (2, 77, 131, 200), (2, 200, 200, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_kernels_match_plain(cuda_device, dtype, H, Sq, Sk,
                                            D, causal):
    q, k, v = _qkv(2, 2, H, H, Sq, Sk, D, dtype, cuda_device)
    do = _qkv(3, 2, H, H, Sq, Sq, D, dtype, cuda_device)[0]
    o, lse = fa._flash_forward(q, k, v, causal)
    before = fa.dq_launches, fa.dkv_launches
    grads = fa._flash_backward(q, k, v, o, lse, do, causal, D ** -0.5)
    torch.cuda.synchronize()
    assert (fa.dq_launches, fa.dkv_launches) == (before[0] + 1,
                                                 before[1] + 1)
    ref = fa._dense_backward(q, k, v, o, lse, do, causal, D ** -0.5)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert g.dtype == dtype and bool(torch.isfinite(g).all()), name
        err = grad_row_error(g, r)
        assert err <= GRAD_ROW_TOL[dtype], (name, err)


def _backward_counts():
    return {"dq_wgmma": fa.dq_wgmma_launches,
            "dkv_wgmma": fa.dkv_wgmma_launches,
            "dq_tiled_f32": fa.dq_tiled_f32_launches,
            "dkv_tiled_f32": fa.dkv_tiled_f32_launches,
            "dq_simt": fa.dq_simt_launches, "dkv_simt": fa.dkv_simt_launches,
            "dq_wide": fa.dq_wide_launches, "dkv_wide": fa.dkv_wide_launches,
            "dq_wide_wgmma": fa.dq_wide_wgmma_launches,
            "dkv_wide_wgmma": fa.dkv_wide_wgmma_launches,
            "dq_wide_f32": fa.dq_wide_f32_launches,
            "dkv_wide_f32": fa.dkv_wide_f32_launches}


def _backward_launched(before, variant):
    """Launches since `before`, and what the rule wants for the backward
    variant `variant`: one dQ and one dK/dV of it, none of the others."""
    got = {n: c - before[n] for n, c in _backward_counts().items()}
    want = {n: int(n in (f"dq_{variant}", f"dkv_{variant}")) for n in got}
    return got, want


# The tensor-core backward (bf16 and f16) at the forward's widths (at 136
# and 200 the dK/dV kernel's second warpgroup owns 8 and 72 real columns):
# lengths that fill 128-row tiles, ragged ones, the training length, Sq !=
# Sk (the reference's top-left causal mask) and a query count far below a
# tile.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("D", WGMMA_TEST_DIMS)
@pytest.mark.parametrize("Sq,Sk", [(128, 128), (200, 200), (2048, 2048),
                                   (77, 131), (3, 50)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_wgmma_backward_matches_plain(cuda_device, dtype, D, Sq, Sk,
                                            causal):
    q, k, v = _qkv(9, 2, 2, 2, Sq, Sk, D, dtype, cuda_device)
    do = _qkv(10, 2, 2, 2, Sq, Sq, D, dtype, cuda_device)[0]
    o, lse = fa._flash_forward(q, k, v, causal)
    before = _backward_counts()
    grads = fa._flash_backward(q, k, v, o, lse, do, causal, D ** -0.5)
    torch.cuda.synchronize()
    got, want = _backward_launched(before, "wgmma")
    assert got == want
    ref = fa._dense_backward(q, k, v, o, lse, do, causal, D ** -0.5)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert g.dtype == dtype, name
        assert bool(torch.isfinite(g).all()), name
        err = grad_row_error(g, r)
        assert err <= GRAD_ROW_TOL[dtype], (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,variant", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 40, "wgmma"),
    (torch.float32, 64, "tiled_f32"), (torch.float16, 64, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float16, 264, "wide_wgmma"),
    (torch.float32, 1024, "wide_f32"), (torch.float16, 128, "wgmma"),
    (torch.bfloat16, 200, "wgmma"), (torch.float32, 256, "tiled_f32"),
    (torch.bfloat16, 1024, "wide_wgmma"),
    (torch.bfloat16, 1032, "wide_wgmma"), (torch.float32, 264, "wide_f32"),
    (torch.float16, 2048, "wide_wgmma")])
def test_flash_backward_launches_the_variant_of_its_rule(cuda_device, dtype,
                                                         D, variant):
    q, k, v = _qkv(11, 1, 2, 2, 96, 96, D, dtype, cuda_device)
    o, lse = fa._flash_forward(q, k, v, True)
    before = _backward_counts()
    fa._flash_backward(q, k, v, o, lse, q, True, D ** -0.5)
    torch.cuda.synchronize()
    got, want = _backward_launched(before, variant)
    assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 256),
                                     (torch.float16, 256)])
def test_flash_wgmma_backward_refuses_misaligned_or_strided_input(
        cuda_device, dtype, D):
    q, k, v = _qkv(12, 1, 2, 2, 64, 64, D, dtype, cuda_device)
    o, lse = fa._flash_forward(q, k, v, True)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype,
                          device=cuda_device)[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16
    before = fa.dq_launches, fa.dkv_launches
    with pytest.raises(ValueError):
        fa._flash_backward(shifted, k, v, o, lse, q, True, 0.125)
    with pytest.raises(ValueError):
        fa._flash_backward(q, k.transpose(2, 3), v, o, lse, q, True, 0.125)
    # The tensor-core dK/dV kernel reads the dQ kernel's delta.
    with pytest.raises(ValueError):
        fa._launch_dkv(q, k, v, o, lse, q, None, True, 0.125)
    assert (fa.dq_launches, fa.dkv_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,variant", [(torch.float32, "tiled_f32"),
                                           (torch.bfloat16, "wgmma")])
def test_flash_attention_autograd_launches_backward_kernels(cuda_device,
                                                            dtype, variant):
    q, k, v = (t.requires_grad_() for t in _qkv(
        4, 2, 4, 4, 96, 96, 64, dtype, cuda_device))
    before = fa.launches, fa.dq_launches, fa.dkv_launches
    before_variants = _backward_counts()
    out = fa.flash_attention(q, k, v)
    out.square().sum().backward()
    torch.cuda.synchronize()
    after = fa.launches, fa.dq_launches, fa.dkv_launches
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    got, want = _backward_launched(before_variants, variant)
    assert got == want
    if dtype == torch.float32:
        ref = fa._dense_kernel(q, k, v, True, 64 ** -0.5)[0]
        ref_grads = torch.autograd.grad(ref.square().sum(), (q, k, v))
    else:
        # bf16: the plain backward from the kernel forward's O and LSE,
        # with autograd's dO of out.square().sum(), 2 * O (exact in bf16).
        with torch.no_grad():
            o, lse = fa._flash_forward(q, k, v, True)
            ref_grads = fa._dense_backward(q, k, v, o, lse, 2 * o, True,
                                           64 ** -0.5)
    for g, r in zip((q.grad, k.grad, v.grad), ref_grads):
        assert grad_row_error(g, r) <= GRAD_ROW_TOL[dtype]


# RMSNorm against the plain version of the formula that the reference's
# rule of shapes picks: (300, 64) has rows no multiple of its 256-row
# block and (16, 12) has D % 8, so both take the unfused formula, which
# the kernel computes under its CAST_FIRST flag.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8192, 512), (4, 128, 1376), (256, 64),
                                   (300, 64), (16, 12)])
def test_rms_norm_kernel_matches_plain(cuda_device, dtype, shape):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        device=cuda_device, dtype=dtype)
    w = torch.from_numpy((1 + 0.5 * rng.standard_normal(shape[-1:])).astype(
        np.float32)).to(cuda_device)
    before = fused.launches
    out = fused.rms_norm_fused(x, w)
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    if fused._casts_first(x.numel() // shape[-1], shape[-1]):
        ref, tol = fused._rms_unfused(x, w, 1e-6), RMS_TOL_CAST_FIRST[dtype]
    else:
        ref, tol = fused._rms_plain(x, w, 1e-6), RMS_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
