"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here is marked ``cuda`` and skips without a card (the kernels
have no CPU mode). This file imports no JAX, so it runs on a machine that
has only PyTorch: ``python -m pytest tests/test_torch_kernels.py -m cuda``.
"""

import importlib

import numpy as np
import pytest
import torch

fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

# O is held per row, as a fraction of the row's largest |O| (the size of
# an attention row shrinks as its keys grow, and so does its error). bf16:
# the plain version rounds each score twice and p once, the kernel rounds
# p from f32 scores, and both round O (relative ulp 2**-8 to 2**-7); 2**-5
# is 4 to 8 ulps of the row's largest element. LSE per element: bf16
# scores rounded by 2**-9 of their size move LSE by at most that, so the
# limit is 2**-8 * (|lse| + 1). f32 sums in another order (TF32 off).
O_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8}


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


def _qkv(seed, B, Hq, Hkv, Sq, Sk, D, dtype, device):
    rng = np.random.default_rng(seed)
    shapes = ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device=device, dtype=dtype) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,Sq,Sk,D", [
    (4, 4, 128, 128, 64), (8, 2, 200, 200, 64), (2, 1, 77, 131, 8),
    (4, 2, 64, 64, 128), (2, 2, 1, 50, 16), (4, 4, 130, 70, 40)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda_device, dtype, Hq, Hkv, Sq, Sk, D,
                                    causal):
    q, k, v = _qkv(0, 2, Hq, Hkv, Sq, Sk, D, dtype, cuda_device)
    before = fa.launches
    o, lse = fa._flash_forward(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ro, rlse = fa._dense(q, k, v, causal, D ** -0.5)
    _assert_close(o, lse, ro, rlse)


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda_device):
    q, k, v = _qkv(1, 1, 2, 2, 16, 16, 12, torch.float32, cuda_device)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v)
    q, k, v = _qkv(1, 1, 2, 2, 16, 16, 16, torch.float32, cuda_device)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(NotImplementedError):
        fa.flash_attention(q.requires_grad_(), k, v)
