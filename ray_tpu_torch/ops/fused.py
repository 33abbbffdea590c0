"""Fused normalization and loss ops (counterpart of ``ray_tpu/ops/fused.py``).

``rms_norm_fused`` replaces the Pallas ``_rms_kernel`` with a Triton kernel
for Hopper: one program per block of rows, each row read once, normalised
and multiplied by ``w`` in f32, and cast once. A row reduction plus an
elementwise multiply leaves nothing for tensor cores or asynchronous copies
to do, so Triton's block model fits it. The kernel is bound by bytes (x
read once, the output written once); its design keeps every row in
registers between the read and the write, so it moves nothing else.

The reference keeps a rule of shapes: where its kernel does not tile, it
computes another formula, which casts before multiplying by ``w``. The
port computes the formula that rule picks on every device: the kernel
takes both (its ``CAST_FIRST`` flag), since its loads and stores are
masked on rows and columns and so it takes any shape. On a CUDA tensor
the wrapper launches the kernel, on a CPU tensor it runs the plain
version of the same formula. ``softmax_cross_entropy`` is plain PyTorch,
as its reference is plain JAX.
"""

from __future__ import annotations

import torch

# Kernel launches made by rms_norm_fused (callers reset it to 0 around the
# run they want to attribute).
launches = 0

# Rows per block of the reference's kernel (ray_tpu/ops/fused.py:37, its
# block_rows default, which no caller changes). It enters only the rule of
# shapes, never the tiling of the port's kernel.
_REF_BLOCK_ROWS = 256
# Rows per program: a [16, 512] f32 block is 32 KB of registers over the
# program's warps.
_BLOCK_ELEMS = 8192
_kernel = None


def _rms_plain(x, w, eps):
    """The kernel's arithmetic (reference ``_rms_kernel``): f32 throughout,
    one cast at the end."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _rms_unfused(x, w, eps):
    """The reference's formula for shapes its kernel does not tile: cast to
    x's dtype before multiplying by w (a different rounding)."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def _casts_first(rows: int, d: int) -> bool:
    """The reference's rule of shapes: its unfused formula where its
    kernel does not tile (``D % 8``, or rows no multiple of its block)."""
    return bool(d % 8 or rows % min(_REF_BLOCK_ROWS, rows))


def _build_kernel():
    global _kernel
    if _kernel is None:
        import triton
        import triton.language as tl

        @triton.jit
        def rms_kernel(x_ptr, w_ptr, o_ptr, rows, d, eps,
                       CAST_FIRST: tl.constexpr, BLOCK_ROWS: tl.constexpr,
                       BLOCK_D: tl.constexpr):
            r = (tl.program_id(0) * BLOCK_ROWS
                 + tl.arange(0, BLOCK_ROWS))[:, None]
            c = tl.arange(0, BLOCK_D)[None, :]
            mask = (r < rows) & (c < d)
            offs = r.to(tl.int64) * d + c
            x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
            var = tl.sum(x * x, axis=1) / d
            rstd = 1.0 / tl.sqrt(var + eps)
            w = tl.load(w_ptr + c, mask=c < d, other=0.0).to(tl.float32)
            out_ty = o_ptr.dtype.element_ty
            if CAST_FIRST:
                # _rms_unfused: the normalised x and w each rounded to the
                # output type, then their product rounded once (the exact
                # f32 product of two bf16 values, as PyTorch's bf16 multiply
                # rounds it).
                xn = (x * rstd[:, None]).to(out_ty).to(tl.float32)
                y = xn * w.to(out_ty).to(tl.float32)
            else:
                y = x * rstd[:, None] * w
            tl.store(o_ptr + offs, y.to(out_ty), mask=mask)

        _kernel = (triton, rms_kernel)
    return _kernel


def _launch(x2, w, eps, cast_first):
    global launches
    if not (x2.is_cuda and w.is_cuda and w.device == x2.device):
        raise ValueError("rms_norm_fused kernel: x and w must lie on one "
                         "CUDA device")
    if x2.dtype not in (torch.float32, torch.bfloat16) or w.dtype not in (
            torch.float32, torch.bfloat16):
        raise TypeError(f"rms_norm_fused kernel takes float32 or bfloat16, "
                        f"got {x2.dtype} and {w.dtype}")
    triton, kernel = _build_kernel()
    rows, d = x2.shape
    block_d = triton.next_power_of_2(d)
    block_rows = max(1, min(64, _BLOCK_ELEMS // block_d))
    out = torch.empty_like(x2)
    grid = (triton.cdiv(rows, block_rows),)
    kernel[grid](x2, w, out, rows, d, float(eps), CAST_FIRST=cast_first,
                 BLOCK_ROWS=block_rows, BLOCK_D=block_d,
                 num_warps=8 if block_d >= 2048 else 4)
    launches += 1
    return out


def rms_norm_fused(x: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis in one pass. x: [..., D], w: [D].

    The reference's rule of shapes picks the formula on every device:
    where its kernel does not tile (``D % 8``, or a row count that is no
    multiple of ``min(256, rows)``), the result is its unfused formula,
    which casts before multiplying by ``w``; every other shape gets the
    kernel's formula, f32 throughout and one cast. A CUDA tensor launches
    the kernel for either formula, a CPU tensor runs its plain version."""
    D = x.shape[-1]
    if w.shape != (D,):
        raise ValueError(f"w {tuple(w.shape)} does not match x's last axis "
                         f"{D}")
    if x.numel() == 0:
        return torch.empty_like(x)
    rows = x.numel() // D
    cast_first = _casts_first(rows, D)
    if x.device.type == "cpu":
        return (_rms_unfused if cast_first else _rms_plain)(x, w, eps)
    x2 = x.reshape(rows, D).contiguous()
    return _launch(x2, w.contiguous(), eps, cast_first).reshape(x.shape)


def softmax_cross_entropy(logits: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """Mean NLL over all positions. logits [..., V], targets [...] int."""
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True)
    shifted = logits - m.detach()
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    picked = torch.gather(shifted, -1, targets.long()[..., None])[..., 0]
    return torch.mean(lse - picked)
