"""The plain versions that the card holds the f32 forward and backward
pair up to head_dim 256 against (``"tiled_f32"``,
``csrc/flash_attention_wide_f32.cu``; its rule of shapes is pinned in
tests/test_torch_flash_any_dim.py, test_torch_forward_variant.py and
test_torch_attention_routing.py), on the CPU.

``_dense_kernel`` in f32 (what the f32 forward runs on a CPU tensor) is
held against the reference's ``_flash_forward`` and
``_flash_forward_grouped`` (the Pallas ``_attn_kernel`` in interpret mode)
at head_dim 64, 128 and 256, MHA and GQA, causal and not.

``_dense_backward`` in f32 is held against ``jax.vjp`` of the reference's
``flash_attention`` (its ``_flash_bwd_rule``: the dQ and dK/dV Pallas
kernels in interpret mode) at head_dim 64, 128 and 256, on plain inputs
and on rows offset by +-1.5 in turn (where dP - delta cancels, ROADMAP
C.9: there dQ, the reference's too, is held against the float64 formula
within f32's rounding bound), causal and not, at S=128. On the CPU the
wrappers run the plain version and launch nothing.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu_torch.testing import dense_dq_f64

torch.set_num_threads(1)

jax_fa = importlib.import_module("ray_tpu.ops.flash_attention")
fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

B, H, S, BLOCK = 1, 2, 128, 32
# Backward, max|port - ref| over the tensor's largest |ref|, both f32 from
# the reference forward's O and LSE: the same formula in other summation
# orders (einsums against 32-row Pallas blocks), each rounding at ~1e-7 of
# its terms.
BWD_REL = 1e-5
# On rows offset by +-1.5 in turn dP - delta cancels two sums of D terms of
# size ~6 and a dQ row sums terms that cancel to many times less than
# their size (sum_j dS_ij = 0): there both f32 sides miss the float64
# formula by more than GRAD_ROW_TOL allows per row (ROADMAP C.9; the
# reference 1.7e-3 at D=256, causal), so dQ is held, element by element,
# to what f32 rounding can move it by (_dq_rounding_bound) against the
# float64 formula, the reference's dQ too.
U32 = 2.0 ** -24


def _launches():
    return (fa.launches, fa.dq_launches, fa.dkv_launches,
            fa.dq_tiled_f32_launches, fa.dkv_tiled_f32_launches)


def _row_offsets(a, size=1.5):
    """a with each row (the last axis) moved by +size or -size in turn."""
    sign = 1 - 2 * (np.arange(a.shape[-2]) % 2)
    return (a + size * sign[:, None]).astype(np.float32)


def _dq_rounding_bound(q, k, v, o, lse, do, causal, scale):
    """Per element of dQ, twice the first-order bound on what f32 rounding
    can move it by, in float64. S_ij, dP_ij and delta_i each sum D
    products (off by at most D u of their terms' absolute sums C_ij, A_ij
    and B_i, u = 2**-24); P = exp(scale S - LSE) carries S's error
    relatively, plus a few u of the exponential; dQ_ic = scale sum_j dS_ij
    K_jc sums Sk terms. So |err dQ_ic| <= scale u sum_j P_ij (D (A_ij +
    B_i) + (D scale C_ij + Sk + 4) |dP_ij - delta_i|) |K_jc|."""
    q, k, v, o, do = (t.double() for t in (q, k, v, o, do))
    D, Sk = q.shape[-1], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        s = fa._mask_causal(s)
    p = torch.exp(s - lse.double()[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    delta = (do * o).sum(-1)[..., None]
    a = torch.einsum("bhqd,bhkd->bhqk", do.abs(), v.abs())
    b = (do * o).abs().sum(-1)[..., None]
    c = torch.einsum("bhqd,bhkd->bhqk", q.abs(), k.abs())
    w = p * (D * (a + b) + (D * scale * c + Sk + 4) * (dp - delta).abs())
    return 2 * scale * U32 * torch.einsum("bhqk,bhkd->bhqd", w, k.abs())


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("offsets", [False, True], ids=["plain", "offset"])
@pytest.mark.parametrize("causal", [True, False])
def test_dense_backward_f32_matches_pallas_interpret_vjp(D, offsets, causal):
    """dq, dk, dv of the f32 plain backward against ``jax.vjp`` of the
    reference's ``flash_attention``, both from the reference forward's O
    and LSE; dQ also against the same formula in float64, which the card
    holds the tiled dQ kernel to."""
    rng = np.random.default_rng(7 * D + 2 * offsets + causal)
    q, k, v, do = (rng.standard_normal((B, H, S, D)).astype(np.float32)
                   for _ in range(4))
    if offsets:
        q, k, v, do = (_row_offsets(a) for a in (q, k, v, do))
    jq, jk, jv, jdo = (jnp.asarray(a) for a in (q, k, v, do))
    _, vjp = jax.vjp(lambda q, k, v: jax_fa.flash_attention(
        q, k, v, causal=causal, block_q=BLOCK, block_k=BLOCK,
        interpret=True), jq, jk, jv)
    ref = [np.asarray(r) for r in vjp(jdo)]
    ro, rlse = jax_fa._flash_forward(jq, jk, jv, causal, D ** -0.5, BLOCK,
                                     BLOCK, True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = torch.from_numpy(np.array(ro))
    lse = torch.from_numpy(np.array(rlse[:, :, 0]))
    before = _launches()
    grads = fa._flash_backward(tq, tk, tv, o, lse, tdo, causal, D ** -0.5)
    assert _launches() == before
    dq64 = dense_dq_f64(tq, tk, tv, o, lse, tdo, causal, D ** -0.5)
    bound = _dq_rounding_bound(tq, tk, tv, o, lse, tdo, causal, D ** -0.5)
    for name, r, g in zip(("dq", "dk", "dv"), ref, grads):
        assert g.dtype == torch.float32, name
        if name == "dq" and offsets:
            for side, x in (("plain", g), ("reference", torch.from_numpy(r))):
                over = ((x.double() - dq64).abs() / bound).max().item()
                assert over <= 1.0, (side, over)
        else:
            rel = np.abs(r - g.numpy()).max() / np.abs(r).max()
            assert rel <= BWD_REL, (name, rel)


# Forward, f32: the port's plain version with the kernels' rounding points
# (``_dense_kernel``: f32 scores, -1e30 masking, the row's maximum taken at
# once) against the reference's online softmax, one 32-key block at a
# time. Both are f32 throughout; they differ in summation order and in the
# running maximum that each p is taken against, each rounding at ~1e-7 of
# its terms: O as max|port - ref| over the largest |ref| within FWD_REL,
# LSE per element within FWD_REL * (|lse| + 1).
FWD_REL = 1e-5


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("grouped", [False, True], ids=["mha", "gqa"])
@pytest.mark.parametrize("Sq,Sk", [(128, 128), (64, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_f32_forward_matches_pallas_interpret(D, grouped, Sq, Sk, causal):
    """The f32 forward that the card runs as the tiled f32 kernel: on the
    CPU it is ``_dense_kernel`` (no launch counted), held against the
    reference's ``_flash_forward`` (MHA: O and LSE) and
    ``_flash_forward_grouped`` (GQA, 4 query heads over 2 KV heads: O) in
    Pallas interpret mode."""
    Hq, Hkv = (4, 2) if grouped else (H, H)
    rng = np.random.default_rng(11 * D + 3 * grouped + Sq + causal)
    q = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    before = _launches() + (fa.tiled_f32_launches, fa.simt_launches)
    o, lse = fa._flash_forward(tq, tk, tv, causal)
    assert _launches() + (fa.tiled_f32_launches, fa.simt_launches) == before
    assert fa._forward_variant(tq.dtype, D) == "tiled_f32"
    ro, rlse = fa._dense_kernel(tq, tk, tv, causal, D ** -0.5)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    if grouped:
        ref = jax_fa._flash_forward_grouped(jq, jk, jv, causal, D ** -0.5,
                                            BLOCK, BLOCK, True)
        ref_lse = None   # the grouped launch returns O only
    else:
        ref, ref_lse = jax_fa._flash_forward(jq, jk, jv, causal, D ** -0.5,
                                             BLOCK, BLOCK, True)
        ref_lse = np.asarray(ref_lse[:, :, 0])
    ref = np.asarray(ref)
    assert o.dtype == torch.float32
    rel = np.abs(o.numpy() - ref).max() / np.abs(ref).max()
    assert rel <= FWD_REL, rel
    if ref_lse is not None:
        err = np.abs(lse.numpy() - ref_lse) / (np.abs(ref_lse) + 1)
        assert err.max() <= FWD_REL, err.max()
