"""Flash attention: hand-written Hopper kernels and their plain PyTorch
versions (counterpart of ``ray_tpu/ops/flash_attention.py``).

The forward replaces the Pallas ``_attn_kernel`` in both of its launches:
``_flash_forward`` (MHA) and ``_flash_forward_grouped`` (GQA, K/V at
``n_kv_heads`` width); the backward kernels, dQ and dK/dV, replace
``_attn_bwd_dq_kernel`` and ``_attn_bwd_dkv_kernel``, which
``_flash_bwd_rule`` launches. One rule of shapes (``_forward_variant``)
picks the variant of all three kernels. bf16 and f16 at every head_dim
that is a multiple of 8 up to 256 run on the tensor cores
(``"wgmma"``: ``csrc/flash_attention_fwd_wgmma.cu`` and ``csrc/flash_
attention_bwd_wgmma.cu``, TMA, wgmma, warp specialisation; instantiated
at head_dim 64, 128 and 256, a narrower head_dim running the next one up
with its columns past D zero-filled by TMA). f32 up to head_dim 256 runs
on the CUDA cores as ``"tiled_f32"``: the forward, dQ and dK/dV templates
of ``csrc/flash_attention_wide_f32.cu`` at instances whose block covers
all of D (register-tiled f32 FMAs fed by a cp.async ring), whose f32
arithmetic the f32 limits rest on. Above head_dim 256 the kernels split
the head dimension of their output across blocks: bf16 and f16 at every
multiple of 8 above 256 take the ``"wide_wgmma"`` kernels on the tensor
cores (``csrc/flash_attention_wide_wgmma.cu``: 256 columns of O, of dQ
and 128 of dK/dV a block, the score reduction streamed over D in
64-column TMA boxes; the forward's Q rows held in shared memory up to
head_dim 1024 and streamed with the K boxes above, from a copy of q *
scale that a pre-pass writes into a buffer this wrapper allocates); f32
at every multiple of 8 above 256 takes the ``"wide_f32"`` kernels on the
CUDA cores (the wide instances of the same templates: 256 columns of O,
512 of dQ and 256 of dK and dV a block). Every dQ kernel but ``"wide"``'s
writes delta = rowsum(dO * O) for its dK/dV kernel. The earlier kernels
stay, reached by no rule: ``"simt"``, the f32 kernels up to 256
(``csrc/flash_attention_fwd.cu`` and ``csrc/flash_attention_bwd.cu``),
and ``"wide"``, the CUDA-core kernels above 256 (``csrc/flash_attention_
wide.cu``, 64-column chunks of the output, any multiple of 8). No variant
gives way to another on an error: a wrapper launches its kernel for CUDA
tensors and raises on what it does not take; it runs a plain version only
for tensors on the CPU.

The forward kernels round where the reference's ``_attn_kernel`` does:
q * scale in q's dtype (the scale itself rounded to that dtype first, as
JAX's weak typing casts a Python float), scores in f32, p rounded before
P.V. ``_dense_kernel`` is the plain version with those rounding points;
``_dense`` rounds as the reference's ``_fallback`` does (the product Q.K^T
in q's dtype, then its scaling). On the CPU ``_flash_forward`` takes the
one the reference takes on those shapes (``_reference_runs_kernel``).

Which route a call takes is one rule, ``_attention_route``: a head_dim
that is no multiple of 8, or a query or key length under 8, takes the
plain path (``_fallback`` / ``_fallback_grouped``), as the reference does
on every device. Every other call takes a kernel. ``take_route`` applies
the rule and counts each plain route in ``plain_routes``; the model's
``_attention_dense`` uses it too.

Layouts are the reference's: q ``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Sk, D]``.
``flash_attention`` is differentiable through ``_FlashCore`` (the
reference's ``custom_vjp``); ``flash_attention_grouped`` is forward-only,
as in the reference.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

# Kernel launches made by this module's wrappers, one count per kernel
# (callers reset them to 0 around the run they want to attribute).
launches = 0        # forward, every variant
wgmma_launches = 0  # forward on the tensor cores (bf16/f16, D <= 256)
tiled_f32_launches = 0    # forward on the CUDA cores (f32, D <= 256)
simt_launches = 0   # the earlier f32 forward (D <= 256), reached by no
                    # rule: stays 0 on every path
wide_launches = 0   # forward with D above 256 on the CUDA cores (bf16/f16),
                    # reached by no rule: stays 0 on every path
wide_wgmma_launches = 0   # forward with D above 256 on the tensor cores
wide_f32_launches = 0     # forward with D above 256 in f32
dq_launches = 0     # backward dQ, every variant
dkv_launches = 0    # backward dK/dV, every variant
dq_wgmma_launches = 0   # backward on the tensor cores (bf16/f16, D <= 256)
dkv_wgmma_launches = 0
dq_tiled_f32_launches = 0     # backward on the CUDA cores (f32, D <= 256)
dkv_tiled_f32_launches = 0
dq_simt_launches = 0    # the earlier f32 pair (D <= 256), reached by no
dkv_simt_launches = 0   # rule: stays 0 on every path
dq_wide_launches = 0    # backward on the CUDA cores, bf16/f16 with D
dkv_wide_launches = 0   # above 256, reached by no rule: stays 0
dq_wide_wgmma_launches = 0    # backward with D above 256 on the tensor cores
dkv_wide_wgmma_launches = 0
dq_wide_f32_launches = 0      # backward with D above 256 in f32
dkv_wide_f32_launches = 0
plain_routes = 0    # calls that _attention_route sent to the plain path

SIMT_MAX_D = 256   # the widest head_dim of the "tiled_f32" and "wgmma" kernels
MIN_KERNEL_LEN = 8   # a shorter Sq or Sk takes the plain path (reference)
WGMMA_DTYPES = (torch.bfloat16, torch.float16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: (library, function) -> argtypes.
_SIGNATURES = {
    ("flash_attention_fwd", "flash_attention_fwd"):
        [_VP] * 5 + [_CI] * 6 + [_CF, _CI, _CI, _VP],
    ("flash_attention_fwd_wgmma", "flash_attention_fwd_wgmma"):
        [_VP] * 5 + [_CI] * 6 + [_CF, _CI, _CI, _VP],
    ("flash_attention_bwd", "flash_attention_bwd_dq"):
        [_VP] * 7 + [_CI] * 4 + [_CF, _CI, _CI, _VP],
    ("flash_attention_bwd", "flash_attention_bwd_dkv"):
        [_VP] * 8 + [_CI] * 4 + [_CF, _CI, _CI, _VP],
    ("flash_attention_bwd_wgmma", "flash_attention_bwd_dq_wgmma"):
        [_VP] * 8 + [_CI] * 4 + [_CF, _CI, _CI, _VP],
    ("flash_attention_bwd_wgmma", "flash_attention_bwd_dkv_wgmma"):
        [_VP] * 8 + [_CI] * 4 + [_CF, _CI, _CI, _VP],
    ("flash_attention_wide", "flash_attention_fwd_wide"):
        [_VP] * 5 + [_CI] * 6 + [_CF, _CI, _CI, _VP],
    ("flash_attention_wide", "flash_attention_bwd_dq_wide"):
        [_VP] * 8 + [_CI] * 4 + [_CF, _CI, _CI, _VP],
    ("flash_attention_wide", "flash_attention_bwd_dkv_wide"):
        [_VP] * 8 + [_CI] * 4 + [_CF, _CI, _CI, _VP],
    ("flash_attention_wide_wgmma", "flash_attention_fwd_wide_wgmma"):
        [_VP] * 6 + [_CI] * 6 + [_CF, _CI, _CI, _VP],
    ("flash_attention_wide_wgmma", "flash_attention_bwd_dq_wide_wgmma"):
        [_VP] * 8 + [_CI] * 4 + [_CF, _CI, _CI, _VP],
    ("flash_attention_wide_wgmma", "flash_attention_bwd_dkv_wide_wgmma"):
        [_VP] * 8 + [_CI] * 4 + [_CF, _CI, _CI, _VP],
    ("flash_attention_wide_f32", "flash_attention_fwd_wide_f32"):
        [_VP] * 5 + [_CI] * 6 + [_CF, _CI, _CI, _VP],
    ("flash_attention_wide_f32", "flash_attention_bwd_dq_wide_f32"):
        [_VP] * 8 + [_CI] * 4 + [_CF, _CI, _CI, _VP],
    ("flash_attention_wide_f32", "flash_attention_bwd_dkv_wide_f32"):
        [_VP] * 8 + [_CI] * 4 + [_CF, _CI, _CI, _VP],
    ("flash_attention_wide_f32", "flash_attention_fwd_tiled_f32"):
        [_VP] * 5 + [_CI] * 6 + [_CF, _CI, _CI, _VP],
    ("flash_attention_wide_f32", "flash_attention_bwd_dq_tiled_f32"):
        [_VP] * 8 + [_CI] * 4 + [_CF, _CI, _CI, _VP],
    ("flash_attention_wide_f32", "flash_attention_bwd_dkv_tiled_f32"):
        [_VP] * 8 + [_CI] * 4 + [_CF, _CI, _CI, _VP],
}
# Each variant's kernels: (forward library, backward library, suffix of
# their C entry points flash_attention_fwd, _bwd_dq and _bwd_dkv). The
# dK/dV kernels of _READS_DELTA read delta from the dQ kernel of their
# variant. "simt"'s and "wide"'s kernels are reached by no rule
# (chip_smoke.py still calls them).
_LIBRARIES = {"wgmma": ("flash_attention_fwd_wgmma",
                        "flash_attention_bwd_wgmma", "_wgmma"),
              "simt": ("flash_attention_fwd", "flash_attention_bwd", ""),
              "wide": ("flash_attention_wide", "flash_attention_wide",
                       "_wide"),
              "wide_wgmma": ("flash_attention_wide_wgmma",
                             "flash_attention_wide_wgmma", "_wide_wgmma"),
              "wide_f32": ("flash_attention_wide_f32",
                           "flash_attention_wide_f32", "_wide_f32"),
              "tiled_f32": ("flash_attention_wide_f32",
                            "flash_attention_wide_f32", "_tiled_f32")}
# dK/dV variants that take delta in place of O.
_READS_DELTA = ("wgmma", "wide_wgmma", "wide_f32", "tiled_f32")
_bound = {}


def _kernel_fn(library: str, name: str):
    """The C entry point ``name`` of kernel library ``library``, built and
    loaded at first use, with its argument types declared."""
    fn = _bound.get((library, name))
    if fn is None:
        from ray_tpu_torch.ops._build import load_library

        fn = getattr(load_library(library), name)
        fn.argtypes = _SIGNATURES[(library, name)]
        fn.restype = _CI
        _bound[(library, name)] = fn
    return fn


def neg_inf_like(s: torch.Tensor) -> torch.Tensor:
    """-1e30 in ``s``'s dtype as the reference's ``jnp.where(..., -1e30)``
    casts it: finite in f32 and bf16, -inf in f16 (whose range ends at
    65504). Picked on the host: one fill, no cast on the device."""
    fill = float("-inf") if s.dtype == torch.float16 else NEG_INF
    return torch.full((), fill, dtype=s.dtype, device=s.device)


def _mask_causal(s):
    """Scores [..., Sq, Sk] with key j > query i set to -1e30."""
    Sq, Sk = s.shape[-2:]
    keep = (torch.arange(Sq, device=s.device)[:, None]
            >= torch.arange(Sk, device=s.device)[None, :])
    return torch.where(keep, s, neg_inf_like(s))


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
        s = _mask_causal(s)
    s32 = s.float()
    lse = torch.logsumexp(s32, dim=-1)
    p = torch.softmax(s32, dim=-1).to(q.dtype)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v)
    return o.reshape(B, Hq, Sq, D), lse.reshape(B, Hq, Sq)


def _dense_kernel(q, k, v, causal, scale):
    """Grouped dense attention with the rounding points of the reference's
    ``_attn_kernel``, the plain version of the forward kernels: q * scale
    rounded to q's dtype T (the scale rounded to T first; f32 stays f32),
    scores of that and K in f32 with -1e30 masking, p = exp(s - m) with l
    summing the unrounded p, P.V on p rounded to T and accumulated in f32,
    O = acc / max(l, 1e-30) cast once, LSE = m + log(l). The reference's
    online softmax rounds p against its running maximum, one K/V block at
    a time; this takes the row's maximum at once. Returns (O [B, Hq, Sq,
    D], LSE [B, Hq, Sq] f32)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    T = q.dtype
    scale_t = torch.tensor(scale, dtype=T).float()
    qs = (q.float() * scale_t).to(T).float()
    qg = qs.reshape(B, Hkv, Hq // Hkv, Sq, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    if causal:
        s = _mask_causal(s)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1).clamp_min(1e-30)
    acc = torch.einsum("bhgqk,bhkd->bhgqd", p.to(T).float(), v.float())
    o = (acc / l[..., None]).to(T)
    lse = m[..., 0] + torch.log(l)
    return o.reshape(B, Hq, Sq, D), lse.reshape(B, Hq, Sq)


def _reference_runs_kernel(Sq: int, Sk: int, D: int) -> bool:
    """Whether the reference's ``flash_attention`` / ``flash_attention_
    grouped`` reach ``pl.pallas_call`` on these shapes rather than
    ``_fallback``: both lengths at least 8 and D a multiple of 8 (its
    block sizes always divide the lengths)."""
    return Sq >= MIN_KERNEL_LEN and Sk >= MIN_KERNEL_LEN and D % 8 == 0


def _fallback(q, k, v, causal, scale):
    """Plain MHA attention (reference ``_fallback``)."""
    return _dense(q, k, v, causal, scale)[0]


def _fallback_grouped(q, k, v, causal, scale):
    """Plain GQA attention with K/V at n_kv_heads width (reference
    ``_fallback_grouped``)."""
    return _dense(q, k, v, causal, scale)[0]


def _dense_backward(q, k, v, o, lse, do, causal, scale):
    """Plain flash backward, the reference ``_flash_bwd_rule``'s
    arithmetic with the scores materialised: P rebuilt as exp(s - LSE)
    from f32 scores, delta = rowsum(dO * O) in f32, dS = P * (dP - delta);
    P and dS are rounded to the input dtype before their products, which
    accumulate in f32. q/o/do [B, H, Sq, D], k/v [B, H, Sk, D], lse
    [B, H, Sq] f32. Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    do = do.to(q.dtype)
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhqd,bhkd->bhqk", q32, k32) * scale
    if causal:
        s = _mask_causal(s)
    p = torch.exp(s - lse[..., None])
    delta = (do32 * o.float()).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", do32, v32)
    ds = (p * (dp - delta[..., None])).to(q.dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k32) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q32) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(do.dtype).float(), do32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def _check_kernel_inputs(tensors, names):
    first = tensors[0]
    for t in tensors:
        if not t.is_cuda or t.device != first.device:
            raise ValueError(f"flash attention kernel: {names} must lie on "
                             f"one CUDA device")
        if t.dtype != first.dtype or t.dtype not in _DTYPE_CODE:
            raise TypeError(f"flash attention kernel takes float32, "
                            f"bfloat16 or float16 {names} of one dtype, got "
                            f"{[x.dtype for x in tensors]}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash attention kernel takes contiguous, "
                             f"16-byte aligned {names}")
    D = first.shape[-1]
    if D % 8:
        raise ValueError(f"flash attention kernel takes head_dim a multiple "
                         f"of 8, got {D}; _attention_route sends the rest "
                         f"to the plain path")


def _attention_route(dtype: torch.dtype, D: int, Sq: Optional[int] = None,
                     Sk: Optional[int] = None) -> str:
    """Where attention over head_dim ``D`` (and, where given, query and key
    lengths ``Sq`` and ``Sk``) goes: ``"plain"`` when D is no multiple of 8
    or a length is under ``MIN_KERNEL_LEN`` (the reference's own fallback
    rule: its Pallas kernel needs both), else the kernel variant of
    ``_forward_variant``. A dtype no kernel takes still gets a variant,
    and the kernel's wrapper raises ``TypeError`` on a CUDA tensor."""
    if D % 8 or any(n is not None and n < MIN_KERNEL_LEN for n in (Sq, Sk)):
        return "plain"
    return _forward_variant(dtype, D)


def take_route(dtype: torch.dtype, D: int, Sq: Optional[int] = None,
               Sk: Optional[int] = None) -> str:
    """``_attention_route``, counting each plain route in
    ``plain_routes``."""
    global plain_routes
    route = _attention_route(dtype, D, Sq, Sk)
    if route == "plain":
        plain_routes += 1
    return route


def _forward_variant(dtype: torch.dtype, D: int) -> str:
    """Which kernels, the forward and the backward's dQ and dK/dV alike,
    take a CUDA input: ``"wgmma"`` (tensor cores) for bf16 and f16 at
    every multiple of 8 up to ``SIMT_MAX_D`` (the kernels' template widths
    are 64, 128 and 256; a narrower head_dim runs the next one up,
    zero-padded); ``"wide_wgmma"`` (tensor cores, 256 columns of O per
    block, any width) for bf16 and f16 above it; ``"wide_f32"`` (CUDA
    cores, 256 columns of O per block, any width) for f32 above
    ``SIMT_MAX_D``; ``"tiled_f32"`` (CUDA cores, one block across all of
    D) for f32 up to ``SIMT_MAX_D``. No rule reaches ``"simt"`` or
    ``"wide"`` (the CUDA-core kernels that the tiled f32 and the
    tensor-core wide ones replaced). f32 stays off the
    tensor cores at every width because TF32 products would break its
    limits (``testing.O_ROW_TOL``, ``GRAD_ROW_TOL``). A head_dim that is no
    multiple of 8, or a dtype no kernel takes, gets a variant whose
    wrapper raises (``_attention_route`` sends such a head_dim to the
    plain path first)."""
    wgmma = dtype in WGMMA_DTYPES and D % 8 == 0
    if D > SIMT_MAX_D:
        return "wide_wgmma" if wgmma else "wide_f32"
    return "wgmma" if wgmma else "tiled_f32"


def _check_launch(name, err):
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + (f"CUDA error {err}" if err > 0 else
                              f"tensor map encoding, CUresult {-err}"))


def _launch(q, k, v, causal, scale):
    global launches, wgmma_launches, tiled_f32_launches, simt_launches
    global wide_launches, wide_wgmma_launches, wide_f32_launches
    _check_kernel_inputs((q, k, v), "q, k, v")
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    variant = _forward_variant(q.dtype, D)
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, Hq, Hkv, Sq, Sk, D, float(scale),
            int(bool(causal)))
    if variant == "wide_wgmma":
        # Room for q * scale rounded to q's dtype, which the kernel writes
        # and streams where Q's rows outgrow shared memory (D above 1024).
        work = torch.empty_like(q)
        args = (*args[:5], work.data_ptr(), *args[5:])
    library, _, suffix = _LIBRARIES[variant]
    name = "flash_attention_fwd" + suffix
    err = _kernel_fn(library, name)(*args, _DTYPE_CODE[q.dtype], stream)
    _check_launch(name, err)
    if variant == "wgmma":
        wgmma_launches += 1
    elif variant == "tiled_f32":
        tiled_f32_launches += 1
    elif variant == "wide_wgmma":
        wide_wgmma_launches += 1
    elif variant == "wide_f32":
        wide_f32_launches += 1
    elif variant == "wide":
        wide_launches += 1
    elif variant == "simt":
        simt_launches += 1
    else:
        raise RuntimeError(f"no launch count for the forward kernel of "
                           f"variant {variant!r}")
    launches += 1
    return o, lse


def _backward_args(q, k, v, o, lse, do, causal, scale):
    """dO cast to q's dtype, the checks, and the scalars shared by both
    backward kernels: (do, (B*H, Sq, Sk, D, scale, causal, dtype code),
    stream)."""
    do = do.to(q.dtype).contiguous()
    _check_kernel_inputs((q, k, v, o, do), "q, k, v, o, dO")
    if k.shape[1] != q.shape[1] or o.shape != q.shape or do.shape != q.shape:
        raise ValueError("flash attention backward wants matched head "
                         "counts and o/dO shaped like q")
    _check_rows_f32(lse, q, "LSE")
    B, H, Sq, D = q.shape
    scalars = (B * H, Sq, k.shape[2], D, float(scale), int(bool(causal)),
               _DTYPE_CODE[q.dtype])
    return do, scalars, torch.cuda.current_stream(q.device).cuda_stream


def _check_rows_f32(t, q, name):
    if not (isinstance(t, torch.Tensor) and t.is_cuda
            and t.dtype == torch.float32 and t.is_contiguous()
            and t.device == q.device and t.shape == q.shape[:3]):
        raise ValueError(f"flash attention backward takes a contiguous f32 "
                         f"{name} [B, H, Sq] on q's device")


def _launch_dq(q, k, v, o, lse, do, causal, scale):
    """dQ kernel (replaces ``_attn_bwd_dq_kernel``) -> (dq in q's dtype,
    delta). Where the dK/dV kernel is one of ``_READS_DELTA`` (every
    variant but ``"wide"`` and ``"simt"``) the dQ kernel also writes delta = rowsum(dO *
    O), [B, H, Sq] f32, which that dK/dV kernel reads; ``"wide"``'s and
    ``"simt"``'s dK/dV kernels compute delta themselves, and then delta is
    None."""
    global dq_launches, dq_wgmma_launches, dq_tiled_f32_launches
    global dq_simt_launches, dq_wide_launches, dq_wide_wgmma_launches
    global dq_wide_f32_launches
    do, scalars, stream = _backward_args(q, k, v, o, lse, do, causal, scale)
    dq = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr())
    D = q.shape[-1]
    variant = _forward_variant(q.dtype, D)
    _, library, suffix = _LIBRARIES[variant]
    name = "flash_attention_bwd_dq" + suffix
    delta = None
    if variant in _READS_DELTA:
        delta = torch.empty(q.shape[:3], dtype=torch.float32,
                            device=q.device)
    if variant == "simt":
        err = _kernel_fn(library, name)(*ptrs, *scalars, stream)
    else:
        # delta's buffer, or null: "wide"'s dQ kernel then writes none.
        err = _kernel_fn(library, name)(
            *ptrs, None if delta is None else delta.data_ptr(), *scalars,
            stream)
    _check_launch(name, err)
    if variant == "wgmma":
        dq_wgmma_launches += 1
    elif variant == "tiled_f32":
        dq_tiled_f32_launches += 1
    elif variant == "wide_wgmma":
        dq_wide_wgmma_launches += 1
    elif variant == "wide_f32":
        dq_wide_f32_launches += 1
    elif variant == "wide":
        dq_wide_launches += 1
    elif variant == "simt":
        dq_simt_launches += 1
    else:
        raise RuntimeError(f"no launch count for the dq kernel of "
                           f"variant {variant!r}")
    dq_launches += 1
    return dq, delta


def _launch_dkv(q, k, v, o, lse, do, delta, causal, scale):
    """dK/dV kernel (replaces ``_attn_bwd_dkv_kernel``) -> (dk, dv).
    ``delta`` is ``_launch_dq``'s second result: the variants of
    ``_READS_DELTA`` read it, ``"wide"`` computes delta from O itself."""
    global dkv_launches, dkv_wgmma_launches, dkv_tiled_f32_launches
    global dkv_simt_launches, dkv_wide_launches, dkv_wide_wgmma_launches
    global dkv_wide_f32_launches
    do, scalars, stream = _backward_args(q, k, v, o, lse, do, causal, scale)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    variant = _forward_variant(q.dtype, q.shape[-1])
    _, library, suffix = _LIBRARIES[variant]
    name = "flash_attention_bwd_dkv" + suffix
    if variant in _READS_DELTA:
        _check_rows_f32(delta, q, "delta")
        err = _kernel_fn(library, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *scalars, stream)
    else:
        err = _kernel_fn(library, name)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *scalars, stream)
    _check_launch(name, err)
    if variant == "wgmma":
        dkv_wgmma_launches += 1
    elif variant == "tiled_f32":
        dkv_tiled_f32_launches += 1
    elif variant == "wide_wgmma":
        dkv_wide_wgmma_launches += 1
    elif variant == "wide_f32":
        dkv_wide_f32_launches += 1
    elif variant == "wide":
        dkv_wide_launches += 1
    elif variant == "simt":
        dkv_simt_launches += 1
    else:
        raise RuntimeError(f"no launch count for the dkv kernel of "
                           f"variant {variant!r}")
    dkv_launches += 1
    return dk, dv


def _flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O [B, Hq, Sq, D] in q's dtype, LSE [B, Hq, Sq] f32). The kernel on
    a CUDA tensor (launched with q's card current, so a tensor on any card
    of a mesh launches there). On a CPU tensor the plain version of what
    the reference runs on these shapes: ``_dense_kernel`` where it reaches
    its Pallas kernel, ``_dense`` where it takes ``_fallback``."""
    _check_shapes(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        if _reference_runs_kernel(q.shape[2], k.shape[2], q.shape[3]):
            return _dense_kernel(q, k, v, causal, scale)
        return _dense(q, k, v, causal, scale)
    with torch.cuda.device(q.device):
        return _launch(q, k, v, causal, scale)


def _flash_backward(q, k, v, o, lse, do, causal, scale):
    """(dq, dk, dv): the backward kernels on CUDA tensors, the plain
    version on CPU tensors."""
    if q.device.type == "cpu":
        return _dense_backward(q, k, v, o, lse, do, causal, scale)
    with torch.cuda.device(q.device):
        dq, delta = _launch_dq(q, k, v, o, lse, do, causal, scale)
        return (dq, *_launch_dkv(q, k, v, o, lse, do, delta, causal, scale))


class _FlashCore(torch.autograd.Function):
    """Counterpart of the reference's ``_flash_core`` custom_vjp: the
    forward saves (q, k, v, O, LSE); the backward rebuilds P from LSE.
    Under activation checkpointing autograd saves the recomputed forward's
    O and LSE, so the backward never reads a stale buffer."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, o, lse, do, ctx.causal,
                                     ctx.scale)
        return dq, dk, dv, None, None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v: [B, H, S, D] -> [B, H, S, D] (matched head counts; GQA
    repeat-expands K/V first). Differentiable: the backward runs the dQ
    and dK/dV kernels of ``_forward_variant`` on CUDA tensors. A call
    that ``_attention_route`` sends to the plain path (head_dim no
    multiple of 8, or a length under 8) returns ``_fallback``,
    differentiable by autograd."""
    if k.shape[1] != q.shape[1]:
        raise ValueError(f"flash_attention wants matched head counts, got "
                         f"{q.shape[1]} and {k.shape[1]}; use "
                         f"flash_attention_grouped")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if take_route(q.dtype, q.shape[-1], q.shape[2], k.shape[2]) == "plain":
        return _fallback(q, k, v, causal, scale)
    if _wants_grad(q, k, v):
        return _FlashCore.apply(q, k, v, causal, scale)
    return _flash_forward(q, k, v, causal, scale)[0]


def flash_attention_grouped(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            scale: Optional[float] = None) -> torch.Tensor:
    """GQA: q [B, Hq, S, D], k/v [B, Hkv, S, D] (Hkv divides Hq) ->
    [B, Hq, S, D]. K/V are never repeat-expanded: the kernel maps each
    query head to its KV head. Forward-only, as in the reference (its
    backward kernels want matched head counts): a tensor that requires
    grad under grad mode raises. A call that ``_attention_route`` sends to
    the plain path returns ``_fallback_grouped``."""
    if _wants_grad(q, k, v):
        raise NotImplementedError(
            "flash_attention_grouped is forward-only; the differentiable "
            "path repeat-expands K/V and calls flash_attention")
    _check_shapes(q, k, v)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if take_route(q.dtype, q.shape[-1], q.shape[2], k.shape[2]) == "plain":
        return _fallback_grouped(q, k, v, causal, scale)
    return _flash_forward(q, k, v, causal, scale)[0]
