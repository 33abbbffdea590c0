// Flash-attention backward on Hopper's tensor cores (sm_90a): the FA2 split
// into a dQ kernel and a dK/dV kernel, each with TMA-fed tiles, wgmma
// products, one producer warp and two consumer warpgroups. bf16 inputs with
// head_dim 64 or 128; f32 and other widths keep the CUDA-core kernels of
// flash_attention_bwd.cu (the wrapper's rule of shapes).
//
// Replaces the Pallas TPU kernels `_attn_bwd_dq_kernel` and
// `_attn_bwd_dkv_kernel` of ray_tpu/ops/flash_attention.py, which
// `_flash_bwd_rule` launches, and computes what they compute, with their
// rounding points:
//   s  = scale * Q K^T in f32, causal-masked (masked P is exactly 0)
//   P  = exp(s - LSE) from the forward's LSE [B*H, Sq] f32
//   dP = dO V^T, delta = rowsum(dO * O) in f32, dS = P * (dP - delta)
//   dQ = scale * bf16(dS) K, dK = scale * bf16(dS)^T Q, dV = bf16(P)^T dO
// each product accumulated in f32 and cast once at the end.
//
// What bounds them on the H100. The dQ kernel does 6 * Sq * Sk * D
// operations per (batch, head) and the dK/dV kernel 8 * Sq * Sk * D (about
// half of each when causal) against Q, K, V, O, dO and LSE read once and
// the gradients written once. At B=4, H=8, S=2048, D=64, causal that is
// ~26 and ~34 GFLOP against ~50 MB, so both are bound by operations: 0.026
// and 0.035 ms at 989 TFLOP/s (chip_smoke.py's backward_bound). What the
// design does about it:
// - All four products of a tile run on wgmma. dQ kernel: S = Q K^T and
//   dP = dO V^T with both operands K-major in shared memory (as stored),
//   dQ += dS K with dS in registers and K read MN-major. dK/dV kernel, in
//   the transposed form: S^T = K Q^T and dP^T = V dO^T (K-major, as
//   stored), dV += bf16(P^T) dO and dK += bf16(dS^T) Q with the A operand
//   in registers and dO, Q read MN-major. An f32 accumulator packed to bf16
//   pairs is the next product's A operand as it lies (the layout note in
//   hopper_tma_wgmma.cuh), so P and dS never go through shared memory and
//   nothing is transposed.
// - One producer warp starts TMA copies into a ring of kStages slots, each
//   with a full and an empty mbarrier; the producer gives registers back
//   (setmaxnreg 24 / 240, as in the forward). Causal tiles that the mask
//   empties are never loaded, and a warpgroup skips the products of a
//   loaded tile that its own rows (or keys) cannot see.
// - dQ kernel: one CTA per (b*h, 128 query rows), 64 rows per consumer
//   warpgroup. Q and dO are loaded once; K and V tiles of 64 keys stream
//   through the ring. It computes delta from dO and O (as the reference
//   does) and writes it as a side output [B*H, Sq] f32 for the dK/dV
//   kernel, which runs after it on the same stream. The heaviest causal
//   tiles (the last rows) are scheduled first. A tile's dQ product stays in
//   flight while the next tile's S and dP are issued (in the dK/dV kernel
//   the same overlap of its dV and dK products measured slower on the
//   H100, so it waits for them).
// - dK/dV kernel: one CTA per (b*h, 128 keys), 64 keys per consumer
//   warpgroup. K and V are loaded once; Q and dO tiles of 64 rows stream
//   through the ring from the first tile that reaches the diagonal, with
//   the tile's LSE and delta, which the producer warp copies into the slot
//   (they are broadcast down the columns of S^T). The first key tiles,
//   which see the most query tiles, come first in the grid. Reading delta
//   rather than streaming O a second time saves a third of the streamed
//   bytes.
// - Registers: ptxas allocated the consumers under the launch cap of 168
//   registers a thread (384 threads, one CTA per SM), whatever setmaxnreg
//   grants at run time: with 128-wide tiles (S and dP at 64 f32 each) the
//   dQ accumulator was spilled on every tile. So the streamed tiles are
//   64 wide: a consumer thread holds S and dP (32 f32 each) and its
//   accumulators (dQ: D/2; dK and dV: D/2 each). That is 96 (dQ, D=64),
//   128 (dQ, D=128; dK/dV, D=64) and 192 (dK/dV, D=128, which spills its
//   excess).
// - Shared memory: dQ kernel 2 * 128 * D * 2 bytes (Q, dO) + kStages *
//   2 * 64 * D * 2 (K, V) = 80 KB at D=64, 160 KB at D=128; dK/dV kernel
//   2 * 128 * D * 2 (K, V) + kStages * (2 * 64 * D * 2 (Q, dO) + 2 * 64 * 4
//   (LSE, delta)) = 82 KB at D=64, 162 KB at D=128.
// - Ragged edges: 3-D tensor maps over [B*H, S, D] make TMA zero-fill rows
//   past the end without reading the next head; keys >= Sk (dQ kernel) and
//   query columns >= Sq (dK/dV kernel) get P = 0 explicitly, on the tiles
//   that can hold them, as does the causal diagonal; LSE and delta of
//   columns past Sq read as 0 and are never used. Gradients are staged in
//   shared memory and stored by TMA, which clips rows past the end.
// - Each CTA owns its output rows: no atomics, deterministic results.
//
// Launches on the caller's stream and allocates nothing.

#include "hopper_tma_wgmma.cuh"

namespace {

using namespace hopper;

constexpr int kStages = 3;                 // depth of the streamed ring
constexpr int kConsumerThreads = 256;      // 2 consumer warpgroups
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kThreads = kConsumerThreads + 128;  // + producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;

// A consumer warp is done with a ring slot: its lanes' reads of the slot
// have completed (wgmma waited on, shared loads consumed), so one arrival
// per warp releases it.
__device__ __forceinline__ void release_slot(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

__device__ __forceinline__ float dot_bf16x8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(pa[i]);
    const float2 y = __bfloat1622float2(pb[i]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

// ---- dQ -------------------------------------------------------------------

constexpr int kDqRows = 128;  // query rows per CTA
constexpr int kDqKeys = 64;   // keys per streamed K/V tile

template <int kD>
struct DqLayout {
  static constexpr int kColBlocks = kD / 64;  // 128-byte column blocks
  static constexpr int kQBytes = kDqRows * kD * 2;
  static constexpr int kKVBytes = kDqKeys * kD * 2;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQBytes;
  static constexpr int kK = kDO + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  // q_full (Q and dO), then kv_full, kv_empty for each stage.
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
  // Dynamic shared memory is only 16-byte aligned: ask for a swizzle atom
  // more and round the base up to 1024 bytes.
  static constexpr int kAlloc = kBytes + 1024;
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_dq,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ delta, int sq, int sk,
                          float scale, int causal) {
  using L = DqLayout<kD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_s = base + L::kQ;
  const uint32_t do_s = base + L::kDO;
  const uint32_t k_s = base + L::kK;
  const uint32_t v_s = base + L::kV;
  const uint32_t q_full = base + L::kBars;
  auto kv_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto kv_empty = [&](int s) { return q_full + 8 * (1 + kStages + s); };

  const int bh = blockIdx.x;
  // Heaviest causal tiles first: blockIdx.y 0 takes the last query rows.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;
  int n_kb = (sk + kDqKeys - 1) / kDqKeys;
  if (causal) n_kb = min(n_kb, (min(q0 + kDqRows, sq) - 1) / kDqKeys + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kv_full(s), 1);
      mbar_init(kv_empty(s), kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // Producer warpgroup: one thread starts every copy.
    regs_dealloc<24>();
    if (threadIdx.x == kConsumerThreads) {
      mbar_arrive_expect_tx(q_full, 2 * L::kQBytes);
      for (int c = 0; c < L::kColBlocks; ++c) {
        tma_load_3d(q_s + c * kDqRows * 128, &tm_q, q_full, 64 * c, q0, bh);
        tma_load_3d(do_s + c * kDqRows * 128, &tm_do, q_full, 64 * c, q0,
                    bh);
      }
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % kStages;
        mbar_wait(kv_empty(s), ((kb / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(kv_full(s), 2 * L::kKVBytes);
        for (int c = 0; c < L::kColBlocks; ++c) {
          tma_load_3d(k_s + s * L::kKVBytes + c * kDqKeys * 128, &tm_k,
                      kv_full(s), 64 * c, kb * kDqKeys, bh);
          tma_load_3d(v_s + s * L::kKVBytes + c * kDqKeys * 128, &tm_v,
                      kv_full(s), 64 * c, kb * kDqKeys, bh);
        }
      }
    }
    return;
  }

  // Consumer warpgroups: 64 query rows each.
  regs_alloc<240>();
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r_local = (tid / 32) * 16 + lane / 4;  // row in the warpgroup
  const int row0 = q0 + wg * 64 + r_local;         // and row0 + 8
  const int col_lane = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  const uint32_t q_wg = q_s + wg * 64 * 128;
  const uint32_t do_wg = do_s + wg * 64 * 128;

  // delta = rowsum(dO * O) and LSE (times log2 e) of this thread's two
  // rows; the four lanes of a row each sum a quarter of it.
  float dlt[2], lse2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    float part = 0.f;
    if (row < sq) {
      const size_t off = ((size_t)bh * sq + row) * kD + (lane % 4) * (kD / 4);
      const uint4* pd = reinterpret_cast<const uint4*>(dout + off);
      const uint4* po = reinterpret_cast<const uint4*>(o + off);
#pragma unroll
      for (int j = 0; j < kD / 32; ++j) part = dot_bf16x8(pd[j], po[j], part);
    }
    dlt[h] = quad_sum(part);
    lse2[h] = row < sq ? lse[(size_t)bh * sq + row] * kLog2e : 0.f;
    if (lane % 4 == 0 && row < sq) delta[(size_t)bh * sq + row] = dlt[h];
  }

  float dq[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dq[i] = 0.f;
  float sc[kDqKeys / 2];  // S, then P
  float dp[kDqKeys / 2];  // dP
  uint32_t ds[kDqKeys / 4];  // bf16(dS), the A operand of dQ += dS K
#pragma unroll
  for (int i = 0; i < kDqKeys / 2; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kDqKeys / 4; ++i) ds[i] = 0u;

  // dQ += dS K of a tile stays in flight until the next tile's S and dP
  // are issued; `pending` is that tile's ring slot, -1 when none.
  int pending = -1;
  mbar_wait(q_full, 0);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int s = kb % kStages;
    const uint32_t k_tile = k_s + s * L::kKVBytes;
    const uint32_t v_tile = v_s + s * L::kKVBytes;
    const int k0 = kb * kDqKeys;
    mbar_wait(kv_full(s), (kb / kStages) & 1);
    // Causal: the first warpgroup's rows see none of the CTA's last tile.
    if (causal && k0 > q0 + wg * 64 + 63) {
      release_slot(kv_empty(s), lane);
      continue;
    }

    // S = Q K^T and dP = dO V^T over the head dimension, 16 columns per
    // wgmma, both operands K-major.
    wgmma_fence();
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk / 4) * (kDqRows * 128) + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * (kDqKeys * 128) + (kk % 4) * 32;
      wgmma_m64n64k16_ss(sc, sw128_desc(q_wg + off, 16, 1024),
                         sw128_desc(k_tile + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk / 4) * (kDqRows * 128) + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * (kDqKeys * 128) + (kk % 4) * 32;
      wgmma_m64n64k16_ss(dp, sw128_desc(do_wg + off, 16, 1024),
                         sw128_desc(v_tile + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();

    // P = exp(scale * s - LSE) while dP is in flight; keys past Sk or
    // above the diagonal get 0 (only tiles that reach the diagonal or end
    // past Sk can hold them). The wait also completes the previous tile's
    // dQ product, which frees its slot and its dS registers.
    wgmma_wait<1>();
    fence_regs(sc);
    fence_regs(dq);
    fence_regs(ds);
    if (pending >= 0) release_slot(kv_empty(pending), lane);
    const bool edge = (causal && k0 + kDqKeys > q0) || k0 + kDqKeys > sk;
#pragma unroll
    for (int i = 0; i < kDqKeys / 2; ++i) {
      const int h = (i / 2) % 2;
      const float p = fast_exp2(fmaf(sc[i], scale_log2, -lse2[h]));
      const int key = k0 + 8 * (i / 4) + col_lane + (i % 2);
      sc[i] = edge && (key >= sk || (causal && key > row0 + 8 * h)) ? 0.f
                                                                     : p;
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS = P * (dP - delta), rounded to bf16 (the reference's rounding
    // point) as A fragments; dQ += dS K with K MN-major.
#pragma unroll
    for (int i = 0; i < kDqKeys / 4; ++i) {
      const float d = dlt[i % 2];
      ds[i] = pack_bf16x2(sc[2 * i] * (dp[2 * i] - d),
                          sc[2 * i + 1] * (dp[2 * i + 1] - d));
    }
    wgmma_fence();
    fence_regs(dq);
    fence_regs(ds);
#pragma unroll
    for (int t = 0; t < kDqKeys / 16; ++t) {
      const uint32_t a[4] = {ds[4 * t], ds[4 * t + 1], ds[4 * t + 2],
                             ds[4 * t + 3]};
      const uint64_t desc_k =
          sw128_desc(k_tile + t * 16 * 128, kDqKeys * 128, 1024);
      if constexpr (kD == 64) {
        wgmma_m64n64k16_rs(dq, a, desc_k);
      } else {
        wgmma_m64n128k16_rs(dq, a, desc_k);
      }
    }
    wgmma_commit();
    pending = s;
  }
  wgmma_wait<0>();
  fence_regs(dq);
  fence_regs(ds);
  if (pending >= 0) release_slot(kv_empty(pending), lane);

  // Epilogue: stage scale * dQ in this warpgroup's Q rows (its last wgmma
  // reading them has completed) and store them with TMA.
  const float mul[2] = {scale, scale};
  stage_acc_bf16<kD>(smem + L::kQ, kDqRows, wg, r_local, col_lane, dq, mul);
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (tid == 0 && q0 + wg * 64 < sq) {
    for (int c = 0; c < L::kColBlocks; ++c) {
      tma_store_3d(&tm_dq, q_wg + c * kDqRows * 128, 64 * c, q0 + wg * 64,
                   bh);
    }
    tma_store_commit_and_wait();
  }
}

// ---- dK / dV --------------------------------------------------------------

constexpr int kDkvKeys = 128;  // keys per CTA

constexpr int kBlockQ = 64;    // query rows per streamed Q/dO tile

template <int kD>
struct DkvLayout {
  static constexpr int kColBlocks = kD / 64;
  static constexpr int kKVBytes = kDkvKeys * kD * 2;
  static constexpr int kQBytes = kBlockQ * kD * 2;
  static constexpr int kStatBytes = 2 * kBlockQ * 4;  // LSE*log2e, delta
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;
  static constexpr int kDO = kQ + kStages * kQBytes;
  static constexpr int kStats = kDO + kStages * kQBytes;
  static constexpr int kBars = kStats + kStages * kStatBytes;
  // kv_full, then full, empty for each stage.
  static constexpr int kBytes = kBars + (1 + 2 * kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;
};

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_dk,
                           const __grid_constant__ CUtensorMap tm_dv,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, int sq, int sk,
                           float scale, int causal) {
  using L = DkvLayout<kD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t k_s = base + L::kK;
  const uint32_t v_s = base + L::kV;
  const uint32_t q_s = base + L::kQ;
  const uint32_t do_s = base + L::kDO;
  float* stats = reinterpret_cast<float*>(smem + L::kStats);
  const uint32_t kv_full = base + L::kBars;
  auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8 * (1 + kStages + s); };

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kDkvKeys;
  const int n_qb = (sq + kBlockQ - 1) / kBlockQ;
  // Causal: query tiles that end before this key tile starts are fully
  // masked (the reference's `ki * block_k // block_q`).
  const int qb0 = causal ? min(k0 / kBlockQ, n_qb) : 0;
  const int n_it = n_qb - qb0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes
      mbar_init(empty(s), kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // Producer: lane 0 of the first warp starts the copies; its 32 lanes
    // copy each tile's LSE and delta into the slot.
    regs_dealloc<24>();
    const int p_lane = threadIdx.x - kConsumerThreads;
    if (p_lane < 32) {
      if (p_lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * L::kKVBytes);
        for (int c = 0; c < L::kColBlocks; ++c) {
          tma_load_3d(k_s + c * kDkvKeys * 128, &tm_k, kv_full, 64 * c, k0,
                      bh);
          tma_load_3d(v_s + c * kDkvKeys * 128, &tm_v, kv_full, 64 * c, k0,
                      bh);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int q0 = (qb0 + it) * kBlockQ;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        float* st = stats + s * 2 * kBlockQ;
        for (int r = p_lane; r < kBlockQ; r += 32) {
          const bool ok = q0 + r < sq;
          const size_t at = (size_t)bh * sq + q0 + r;
          st[r] = ok ? lse[at] * kLog2e : 0.f;
          st[kBlockQ + r] = ok ? delta[at] : 0.f;
        }
        // Each lane's arrival releases its own stores to the consumers.
        if (p_lane == 0) {
          mbar_arrive_expect_tx(full(s), 2 * L::kQBytes);
          for (int c = 0; c < L::kColBlocks; ++c) {
            tma_load_3d(q_s + s * L::kQBytes + c * kBlockQ * 128, &tm_q,
                        full(s), 64 * c, q0, bh);
            tma_load_3d(do_s + s * L::kQBytes + c * kBlockQ * 128, &tm_do,
                        full(s), 64 * c, q0, bh);
          }
        } else {
          mbar_arrive(full(s));
        }
      }
    }
    return;
  }

  // Consumer warpgroups: 64 keys each.
  regs_alloc<240>();
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r_local = (tid / 32) * 16 + lane / 4;  // key row in the warpgroup
  const int key0 = k0 + wg * 64 + r_local;         // and key0 + 8
  const int col_lane = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_wg = k_s + wg * 64 * 128;
  const uint32_t v_wg = v_s + wg * 64 * 128;

  float dk[kD / 2], dv[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.f;
  float sc[kBlockQ / 2];  // S^T, then P^T
  float dp[kBlockQ / 2];  // dP^T
#pragma unroll
  for (int i = 0; i < kBlockQ / 2; ++i) sc[i] = dp[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int q0 = (qb0 + it) * kBlockQ;
    const uint32_t q_tile = q_s + s * L::kQBytes;
    const uint32_t do_tile = do_s + s * L::kQBytes;
    const float* st = stats + s * 2 * kBlockQ;
    mbar_wait(full(s), (it / kStages) & 1);
    // Causal: the second warpgroup's keys see none of the first tile.
    if (causal && q0 + kBlockQ <= k0 + wg * 64) {
      release_slot(empty(s), lane);
      continue;
    }

    // S^T = K Q^T and dP^T = V dO^T: A is this warpgroup's 64 key rows,
    // B the query tile, both K-major (the head dimension contiguous).
    wgmma_fence();
    fence_regs(sc);
    fence_regs(dp);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t aoff = (kk / 4) * (kDkvKeys * 128) + (kk % 4) * 32;
      const uint32_t boff = (kk / 4) * (kBlockQ * 128) + (kk % 4) * 32;
      wgmma_m64n64k16_ss(sc, sw128_desc(k_wg + aoff, 16, 1024),
                         sw128_desc(q_tile + boff, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t aoff = (kk / 4) * (kDkvKeys * 128) + (kk % 4) * 32;
      const uint32_t boff = (kk / 4) * (kBlockQ * 128) + (kk % 4) * 32;
      wgmma_m64n64k16_ss(dp, sw128_desc(v_wg + aoff, 16, 1024),
                         sw128_desc(do_tile + boff, 16, 1024), kk > 0);
    }
    wgmma_commit();

    // P^T = exp(scale * s - LSE[column]) while dP^T is in flight. Columns
    // past Sq, and keys above the diagonal, get 0; only the tiles that
    // overlap this CTA's keys or end past Sq can hold them.
    wgmma_wait<1>();
    fence_regs(sc);
    const bool edge =
        (causal && q0 < k0 + kDkvKeys) || q0 + kBlockQ > sq;
#pragma unroll
    for (int j = 0; j < kBlockQ / 8; ++j) {
      const float2 l2 =
          *reinterpret_cast<const float2*>(st + 8 * j + col_lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const int col = q0 + 8 * j + col_lane + (e % 2);
        const int key = key0 + 8 * (e / 2);
        const float p = fast_exp2(
            fmaf(sc[i], scale_log2, -(e % 2 ? l2.y : l2.x)));
        sc[i] = edge && (col >= sq || (causal && key > col)) ? 0.f : p;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // bf16(P^T) and bf16(dS^T) = bf16(P^T * (dP^T - delta[column])) as A
    // fragments; dV += P^T dO and dK += dS^T Q with dO and Q MN-major.
    uint32_t pp[kBlockQ / 4], ds[kBlockQ / 4];
#pragma unroll
    for (int i = 0; i < kBlockQ / 4; ++i) {
      const float2 d = *reinterpret_cast<const float2*>(
          st + kBlockQ + 8 * (i / 2) + col_lane);
      pp[i] = pack_bf16x2(sc[2 * i], sc[2 * i + 1]);
      ds[i] = pack_bf16x2(sc[2 * i] * (dp[2 * i] - d.x),
                          sc[2 * i + 1] * (dp[2 * i + 1] - d.y));
    }
    wgmma_fence();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pp);
    fence_regs(ds);
#pragma unroll
    for (int t = 0; t < kBlockQ / 16; ++t) {
      const uint32_t a[4] = {pp[4 * t], pp[4 * t + 1], pp[4 * t + 2],
                             pp[4 * t + 3]};
      const uint64_t desc_do =
          sw128_desc(do_tile + t * 16 * 128, kBlockQ * 128, 1024);
      if constexpr (kD == 64) {
        wgmma_m64n64k16_rs(dv, a, desc_do);
      } else {
        wgmma_m64n128k16_rs(dv, a, desc_do);
      }
    }
#pragma unroll
    for (int t = 0; t < kBlockQ / 16; ++t) {
      const uint32_t a[4] = {ds[4 * t], ds[4 * t + 1], ds[4 * t + 2],
                             ds[4 * t + 3]};
      const uint64_t desc_q =
          sw128_desc(q_tile + t * 16 * 128, kBlockQ * 128, 1024);
      if constexpr (kD == 64) {
        wgmma_m64n64k16_rs(dk, a, desc_q);
      } else {
        wgmma_m64n128k16_rs(dk, a, desc_q);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pp);
    fence_regs(ds);
    release_slot(empty(s), lane);
  }

  // Epilogue: stage scale * dK and dV in this warpgroup's K and V rows (its
  // last wgmma reading them has completed) and store them with TMA. A CTA
  // whose keys no query sees stores zeros.
  const float mul_dk[2] = {scale, scale}, mul_dv[2] = {1.f, 1.f};
  stage_acc_bf16<kD>(smem + L::kK, kDkvKeys, wg, r_local, col_lane, dk,
                     mul_dk);
  stage_acc_bf16<kD>(smem + L::kV, kDkvKeys, wg, r_local, col_lane, dv,
                     mul_dv);
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (tid == 0 && k0 + wg * 64 < sk) {
    for (int c = 0; c < L::kColBlocks; ++c) {
      tma_store_3d(&tm_dk, k_wg + c * kDkvKeys * 128, 64 * c, k0 + wg * 64,
                   bh);
      tma_store_3d(&tm_dv, v_wg + c * kDkvKeys * 128, 64 * c, k0 + wg * 64,
                   bh);
    }
    tma_store_commit_and_wait();
  }
}

// ---- host -----------------------------------------------------------------

template <int kD>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* dq, void* delta,
              int bh, int sq, int sk, float scale, int causal,
              cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  CUresult res = encode_bf16_3d(&tm_q, q, bh, sq, kD, kDqRows);
  if (res == CUDA_SUCCESS)
    res = encode_bf16_3d(&tm_k, k, bh, sk, kD, kDqKeys);
  if (res == CUDA_SUCCESS)
    res = encode_bf16_3d(&tm_v, v, bh, sk, kD, kDqKeys);
  if (res == CUDA_SUCCESS)
    res = encode_bf16_3d(&tm_do, dout, bh, sq, kD, kDqRows);
  if (res == CUDA_SUCCESS) res = encode_bf16_3d(&tm_dq, dq, bh, sq, kD, 64);
  if (res != CUDA_SUCCESS) return -(int)res;

  auto kernel = flash_bwd_dq_wgmma_kernel<kD>;
  const int smem = DqLayout<kD>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (sq + kDqRows - 1) / kDqRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dq, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta), sq, sk,
      scale, causal);
  return (int)cudaGetLastError();
}

template <int kD>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int bh, int sq, int sk, float scale,
               int causal, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv;
  CUresult res = encode_bf16_3d(&tm_q, q, bh, sq, kD, kBlockQ);
  if (res == CUDA_SUCCESS)
    res = encode_bf16_3d(&tm_k, k, bh, sk, kD, kDkvKeys);
  if (res == CUDA_SUCCESS)
    res = encode_bf16_3d(&tm_v, v, bh, sk, kD, kDkvKeys);
  if (res == CUDA_SUCCESS)
    res = encode_bf16_3d(&tm_do, dout, bh, sq, kD, kBlockQ);
  if (res == CUDA_SUCCESS) res = encode_bf16_3d(&tm_dk, dk, bh, sk, kD, 64);
  if (res == CUDA_SUCCESS) res = encode_bf16_3d(&tm_dv, dv, bh, sk, kD, 64);
  if (res != CUDA_SUCCESS) return -(int)res;

  auto kernel = flash_bwd_dkv_wgmma_kernel<kD>;
  const int smem = DkvLayout<kD>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (sk + kDkvKeys - 1) / kDkvKeys);
  kernel<<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), sq, sk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o, dout, dq [B*H, Sq, D]; k, v [B*H, Sk, D]: contiguous bf16 with
// 16-byte aligned bases; lse [B*H, Sq] f32 as the forward writes it; delta
// [B*H, Sq] f32, written (the dK/dV kernel reads it); D 64 or 128. Returns
// 0, a cudaError_t, or minus a CUresult when a tensor map cannot be
// encoded.
extern "C" int flash_attention_bwd_dq_wgmma(const void* q, const void* k,
                                            const void* v, const void* o,
                                            const void* dout,
                                            const void* lse, void* dq,
                                            void* delta, int bh, int sq,
                                            int sk, int d, float scale,
                                            int causal, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || (d != 64 && d != 128) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
       (uintptr_t)dout | (uintptr_t)dq) % 16 ||
      (sq + kDqRows - 1) / kDqRows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch_dq<64>(q, k, v, o, dout, lse, dq, delta, bh, sq,
                                 sk, scale, causal, s)
                 : launch_dq<128>(q, k, v, o, dout, lse, dq, delta, bh, sq,
                                  sk, scale, causal, s);
}

// As flash_attention_bwd_dq_wgmma; delta is the dQ kernel's side output,
// dk and dv [B*H, Sk, D] bf16.
extern "C" int flash_attention_bwd_dkv_wgmma(const void* q, const void* k,
                                             const void* v, const void* dout,
                                             const void* lse,
                                             const void* delta, void* dk,
                                             void* dv, int bh, int sq,
                                             int sk, int d, float scale,
                                             int causal, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || (d != 64 && d != 128) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
       (uintptr_t)dk | (uintptr_t)dv) % 16 ||
      (sk + kDkvKeys - 1) / kDkvKeys > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == 64 ? launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, bh, sq,
                                  sk, scale, causal, s)
                 : launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, bh,
                                   sq, sk, scale, causal, s);
}
