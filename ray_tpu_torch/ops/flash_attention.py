"""Flash attention forward: a hand-written Hopper kernel and its plain
PyTorch version (counterpart of ``ray_tpu/ops/flash_attention.py``).

The kernel (``csrc/flash_attention_fwd.cu``) replaces the Pallas
``_attn_kernel`` in both of its launches: ``_flash_forward`` (MHA) and
``_flash_forward_grouped`` (GQA, K/V at ``n_kv_heads`` width). A wrapper
launches it for CUDA tensors and raises on what it does not take; it runs
the plain version only for tensors on the CPU.

Layouts are the reference's: q ``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Sk, D]``.
This module has no autograd: the backward kernels come with the training
port.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

# Kernel launches made by this module's wrappers (callers reset it to 0
# around the run they want to attribute).
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_argtypes_set = False


def _dense(q, k, v, causal, scale):
    """Grouped dense attention, the plain version of the kernel: scores in
    q's dtype, softmax in f32, p cast to q's dtype before P.V, -1e30
    masking. Returns (O [B, Hq, Sq, D], LSE [B, Hq, Sq] f32)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B, Hkv, group, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k) * scale
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype,
                                            device=s.device))
    s32 = s.float()
    lse = torch.logsumexp(s32, dim=-1)
    p = torch.softmax(s32, dim=-1).to(q.dtype)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v)
    return o.reshape(B, Hq, Sq, D), lse.reshape(B, Hq, Sq)


def _fallback(q, k, v, causal, scale):
    """Plain MHA attention (reference ``_fallback``)."""
    return _dense(q, k, v, causal, scale)[0]


def _fallback_grouped(q, k, v, causal, scale):
    """Plain GQA attention with K/V at n_kv_heads width (reference
    ``_fallback_grouped``)."""
    return _dense(q, k, v, causal, scale)[0]


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q [B,Hq,Sq,D] and k/v [B,Hkv,Sk,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Hq, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"n_heads {Hq} % n_kv_heads {k.shape[1]} != 0")


def _launch(q, k, v, causal, scale):
    global launches, _argtypes_set
    from ray_tpu_torch.ops._build import load_library

    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash attention kernel: q, k, v must lie on "
                             "one CUDA device")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODE:
            raise TypeError(f"flash attention kernel takes float32 or "
                            f"bfloat16 q/k/v of one dtype, got {q.dtype}, "
                            f"{k.dtype}, {v.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash attention kernel takes contiguous, "
                             "16-byte aligned q/k/v")
        if t.requires_grad:
            raise NotImplementedError(
                "flash attention backward is not ported yet: it comes with "
                "the training slice (FA2 dQ and dK/dV kernels)")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if D % 8 or D > 128:
        raise ValueError(f"flash attention kernel takes head_dim a multiple "
                         f"of 8 up to 128, got {D}")
    lib = load_library("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    if not _argtypes_set:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci,
                       ctypes.c_float, ci, ci, vp]
        fn.restype = ci
        _argtypes_set = True
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), B, Hq, Hkv, Sq, Sk, D, float(scale),
             int(bool(causal)), _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    launches += 1
    return o, lse


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O [B, Hq, Sq, D] in q's dtype, LSE [B, Hq, Sq] f32). The kernel on
    a CUDA tensor, the plain version on a CPU tensor."""
    _check_shapes(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _dense(q, k, v, causal, scale)
    return _launch(q, k, v, causal, scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v: [B, H, S, D] -> [B, H, S, D] (matched head counts)."""
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"flash_attention wants matched head counts, got "
                         f"{q.shape[1]} and {k.shape[1]}; use "
                         f"flash_attention_grouped")
    return _flash_forward(q, k, v, causal, scale)[0]


def flash_attention_grouped(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            scale: Optional[float] = None) -> torch.Tensor:
    """GQA: q [B, Hq, S, D], k/v [B, Hkv, S, D] (Hkv divides Hq) ->
    [B, Hq, S, D]. K/V are never repeat-expanded: the kernel maps each
    query head to its KV head."""
    return _flash_forward(q, k, v, causal, scale)[0]
