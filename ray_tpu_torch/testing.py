"""Tolerances that hold the port's kernels against their plain versions,
and the limits of ``chip_smoke.py``'s speculative-decoding and sharded
training checks.

``chip_smoke.py`` and ``tests/test_torch_kernels.py`` both check the
kernels on the card; they read their limits here so that the two cannot
drift apart. So does ``chip_smoke.py``'s sharded training step against
one device. Each limit stands beside its reason.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

# Flash forward, against the plain version with the kernels' rounding
# points (``_dense_kernel``). The error scale of attention output is the
# size of the row it belongs to (|O| of a row shrinks as its keys grow), so
# O is held per row: max|o - ro| over a row, over max|ro| of that row.
# bf16: both round q * scale to bf16 and keep f32 scores; the kernel rounds
# p against its running maximum, a tile at a time, the plain version
# against the row's, and both round O (relative ulp 2**-8 to 2**-7); a
# row's error sums many such roundings.
# The limit 2**-5 is 4 to 8 ulps of the row's largest element; a dropped
# 64-key tile reads 20x more. LSE is held per element: bf16 scores rounded
# by 2**-9 of their size move LSE by at most that, and the limit is
# 2**-8 * (|lse| + 1). f32 sums in another order (TF32 off). f16 rounds
# where bf16 does, with 3 more bits (relative ulp 2**-11 to 2**-10): the
# same 4 to 8 ulps are 2**-7 of a row, and LSE 2**-10 * (|lse| + 1).
O_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5,
             torch.float16: 2.0 ** -7}
LSE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8,
           torch.float16: 2.0 ** -10}

# Flash backward, per row of dq, dk and dv as a fraction of the row's
# largest element. A row whose exact gradient is 0 holds only rounding
# noise (causal query 0: dS = P * (dP - delta) with dP = delta, which the
# kernel sums in one order and so gets exactly 0), so a row's scale is
# floored at GRAD_ROW_FLOOR of the tensor's largest element. f32: another
# summation order (TF32 off); a dq row sums terms that cancel exactly
# (sum_j dS_ij = 0), so a row with a peaked softmax is many times smaller
# than its terms while the rounding of dP and delta stays at the terms'
# size: 1e-3. bf16: both compute P and dS in f32 and round them to bf16
# before the products, so they differ where a summation-order difference
# flips a rounding (rare) and in the final rounding of each gradient (one
# ulp, at most 2**-7 of the element); 2**-5 is 4 to 8 such ulps of the
# row's largest element; f16, the same count of its ulps, 2**-7. A dropped
# 64-row tile of dO zeroes those dq rows and reads ~1.
GRAD_ROW_TOL = {torch.float32: 1e-3, torch.bfloat16: 2.0 ** -5,
                torch.float16: 2.0 ** -7}
GRAD_ROW_FLOOR = 2.0 ** -8

# RMSNorm, per element |out - ref| <= tol * (|ref| + 1). The kernel's
# formula (f32 throughout, one cast): both compute in f32 (the kernel's
# sqrt and division may be approximate to a few ulps) and round once, so
# bf16 differs by at most one ulp, 2**-8 to 2**-7 of the value. The
# unfused formula of the reference's rule of shapes rounds twice in bf16:
# the normalised x may round to a neighbour (one ulp of it, up to 2**-7 of
# the product once multiplied by w) and the product's own rounding adds
# one ulp more, so 2**-6. In f32 both formulas round as the kernel's.
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
RMS_TOL_CAST_FIRST = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}

# The bf16 flagship's training loss through the kernels against the same
# loss through plain attention (chip_smoke.py), |loss - ref| / |ref|. The
# two differ only in attention, which rounds at other places (the plain
# attention of the model rounds each score to bf16 twice; the kernel rounds
# q * scale to bf16 once and keeps f32 scores, as the reference's kernel
# does): a few bf16 ulps per element, within O_ROW_TOL of a row. The loss
# is a mean over 8192 tokens of f32 log-softmax terms, so differences of
# either sign average out; to move the loss by one bf16 ulp of itself
# (2**-8) every token would have to move the same way by that much.
TRAIN_LOSS_TOL_BF16 = 2.0 ** -8

# Speculative decoding in bf16 (chip_smoke.py phase 6). A spec round's
# tokens are the argmaxes of verify_step's logits, whose GEMMs and
# attention run over [B*C] query rows where decode_step's run over [B]:
# the card may tile them differently and round differently, and the K/V
# each path writes differs the same way. So a bf16 spec stream equals
# vanilla's only up to a position where vanilla's top two logits are
# closer than the two paths' logits differ. The logits are bf16 values
# (the lm_head product rounds to bf16 before the f32 cast) of size up to
# ~6 for the random flagship, where one ulp is 2**-5; one path moves a
# logit by about one ulp (a half-ulp difference in the hidden state sums
# over 512 terms to a few thousandths, and the output rounding turns that
# into 0 or 1 ulp). Two logits that each move by up to two ulps swap only
# where their gap is below four ulps: 2**-3. chip_smoke.py measures the
# yardstick, the largest |verify - decode| logit difference on the same
# contexts in the same run, and prints it beside this limit. A divergence
# whose vanilla top-two gap is above the limit is a fault, not noise.
SPEC_TIE_TOL_BF16 = 2.0 ** -3

# A self-draft (the flagship as its own draft) in f32, one spec round per
# request (chip_smoke.py phase 6). The first round drafts from the
# prefill's cache, which the draft shares exactly, so in exact arithmetic
# every proposal is accepted; a proposal is rejected only where decode's
# and verify's f32 logits order a near-tie differently (gaps below ~1e-5,
# about one token in 1e4 for the random flagship), which costs at most k
# of the round's 8k proposals. A draft that reads another context (an aux
# pool not prefilled, copied or shipped) accepts next to nothing. Later
# rounds are not held to this: after a fully accepted round the draft's
# cache keeps the k-th proposal's slot unwritten, as the reference's does
# (ROADMAP section C), which costs acceptance, not tokens.
SPEC_SELF_ACCEPT_MIN_F32 = 0.75

# The manual multi-axis training step against one device (chip_smoke.py
# phase 11), f32 with TF32 off: one SGD step of make_spmd_train_step over
# 8 virtual shards against one SGD step of the one-device loss_fn's
# gradients. Per leaf and shard, max(|p - p_ref| - ulp(p_ref)) over the
# largest move max|p_ref - p0| of that block: each side rounds p0 plus
# its move to f32 once, so two moves that differ by far less than an ulp
# of the parameter can land one ulp apart (a norm weight of 1.0 moved by
# 1e-4 shows a one-ulp flip as 1.2e-3 of its move). The two compute the
# same sums in other orders: row-parallel products split over tp and
# summed across shards, gradients summed over shards and microbatches,
# ring attention's online merge over sp blocks against the kernel's
# tiles; each rounds at ~1e-7 of its terms, through 4 layers and sums
# over 16384 tokens. 1e-3 leaves room
# for leaves whose gradient sums cancel, as TRAIN_GRAD_TOL does for the
# kernels. A gradient sync that skips a replicated axis of size 2 moves
# each leaf by about half its update (0.5); a ring whose causal mask
# ignores each shard's sequence offset changes the attention of every
# query past the first block (order 1).
SPMD_UPDATE_TOL = 1e-3
# The loss of that step, |loss - ref| / |ref|: a mean of 16384 f32
# log-softmax terms, taken per shard and then across shards where one
# device takes it at once; the terms agree to ~1e-6 of themselves.
SPMD_LOSS_TOL = 1e-5


def delta_error(delta: torch.Tensor, do: torch.Tensor,
                o: torch.Tensor) -> float:
    """delta = rowsum(dO * O) of a dQ kernel against the same sum in f32,
    as a fraction of its limit, max over rows. Each side adds a row's D
    products in its own order (the products of bf16 or f16 values are
    exact in f32; an f32 kernel's fused multiply-add skips one rounding of
    each): two such f32 sums of D terms differ by at most 2 * D * 2**-24
    of the terms' absolute sum, which is the limit. A row summed over half
    its columns misses by a sum of D / 2 terms, hundreds of limits."""
    terms = do.float() * o.float()
    lim = 2 * terms.shape[-1] * 2.0 ** -24 * terms.abs().sum(-1)
    err = (delta - terms.sum(-1)).abs() / lim.clamp_min(1e-30)
    return err.max().item()


def grad_row_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Max over rows of max|got - ref| in the row, over the row's largest
    |ref| floored at GRAD_ROW_FLOOR of the tensor's largest |ref|."""
    ref = ref.float()
    d = (got.float() - ref).abs().amax(-1)
    floor = max(GRAD_ROW_FLOOR * ref.abs().max().item(), 1e-30)
    return (d / ref.abs().amax(-1).clamp_min(floor)).max().item()


def dense_dq_f64(q, k, v, o, lse, do, causal, scale) -> torch.Tensor:
    """dQ of the plain backward's formula in float64: P = exp(scale * S -
    LSE) from the given LSE (-1e30 masking, as the kernels mask), delta =
    rowsum(dO * O), dS = P * (dP - delta), dQ = scale * dS K. The f32 dQ
    kernels are held against it where dP - delta cancels (ROADMAP C.9):
    there the f32 plain backward's own rounding exceeds GRAD_ROW_TOL."""
    from ray_tpu_torch.ops.flash_attention import _mask_causal

    q, k, v, o, do = (t.double() for t in (q, k, v, o, do))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        s = _mask_causal(s)
    p = torch.exp(s - lse.double()[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    ds = p * (dp - (do * o).sum(-1)[..., None])
    return torch.einsum("bhqk,bhkd->bhqd", ds, k) * scale


def seeded_qkv(seed, B, Hq, Hkv, Sq, Sk, D, dtype, device):
    """q [B, Hq, Sq, D], k and v [B, Hkv, Sk, D] of standard normals drawn
    by numpy from ``seed`` (the same values on any machine), cast to
    ``dtype`` on ``device``."""
    rng = np.random.default_rng(seed)
    shapes = ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D))
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(device=device, dtype=dtype) for s in shapes]


def tensor_digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes, in order (16-bit types as int16)."""
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous().cpu()
        if t.element_size() == 2:
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    return h.hexdigest()


# The tensor-core forward where the scale is a power of two (head_dim 64:
# 1/8, 256: 1/16): there q * scale is exact in the input type unless the
# product falls below f16's normal range (2**-14), where it loses bits, as
# the reference's f16 product does; bf16 has f32's exponent range. On
# inputs whose q keeps every product normal, the forward that rounds Q
# before its products must give, bit for bit, what the forward that scaled
# the f32 scores gave. The inputs are digest_inputs(D, dtype), and each
# digest is tensor_digest(O, LSE) of that earlier forward on an H100
# (flash_ab.py --parent prints both designs' digests).
FWD_DIGEST_SEED = 21
FWD_DIGEST_SHAPE = (2, 4, 2, 200, 200)   # B, Hq, Hkv, Sq, Sk
FWD_DIGEST_MIN_Q = 2.0 ** -10   # |q| / 16 >= 2**-14: normal in f16
FWD_DIGESTS = {
    "bfloat16-D64-causal":
        "fe4216c18b47c4aa0cab5bd64e38bffc75a77e35bcef22c9da2c71191d143bd2",
    "bfloat16-D64-full":
        "659db610284da16a43f7925ec193884911bff136771218c77e98488d3d0ae417",
    "bfloat16-D256-causal":
        "b4a879cdaba616c9aadb2d329237db1acdbcffa848e535695a33ed335b69ff0f",
    "bfloat16-D256-full":
        "040847fc084169cecf985484e7997015ff8ed05ba569b76e0b853d130ab5aa5c",
    "float16-D64-causal":
        "90e342e140e91880323702b0c7ee67bf297f48bc2b9cfc1bd9d099bc625ccbb1",
    "float16-D64-full":
        "c6bca1bb0e96cd8c70399ef870fe639d0e010405bee1cd13d2be4af9afae60f4",
    "float16-D256-causal":
        "90dc59d24ee799d7215e2074095dd5f5391fc196cac65a173c43b4b2aa2e8109",
    "float16-D256-full":
        "5db730dd45fd08b5ca7b846144b7cb91fb05008dbc422a8d2ac1bd69f92fe1b8",
}


def digest_inputs(D, dtype, device, nudge=True):
    """seeded_qkv(FWD_DIGEST_SEED, *FWD_DIGEST_SHAPE, D, ...), with q moved
    away from zero to |q| >= FWD_DIGEST_MIN_Q when ``nudge`` (so that q *
    scale is exact in f16 at head_dim 64 and 256)."""
    q, k, v = seeded_qkv(FWD_DIGEST_SEED, *FWD_DIGEST_SHAPE, D,
                         torch.float32, device)
    if nudge:
        q = torch.copysign(q.abs().clamp_min(FWD_DIGEST_MIN_Q), q)
    return [t.to(dtype) for t in (q, k, v)]
