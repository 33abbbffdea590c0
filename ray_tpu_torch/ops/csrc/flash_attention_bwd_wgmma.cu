// Flash-attention backward on Hopper's tensor cores (sm_90a): the FA2 split
// into a dQ kernel and a dK/dV kernel, each with TMA-fed tiles, wgmma
// products, one producer warp and two consumer warpgroups. bf16 or f16
// inputs with head_dim any multiple of 8 up to 256, run by the instance of
// width kD = 64, 128 or 256 that holds it (below); f32 and head dims above
// 256 keep the CUDA-core kernels (flash_attention_bwd.cu,
// flash_attention_wide.cu) by the wrapper's rule of shapes.
//
// Replaces the Pallas TPU kernels `_attn_bwd_dq_kernel` and
// `_attn_bwd_dkv_kernel` of ray_tpu/ops/flash_attention.py, which
// `_flash_bwd_rule` launches, and computes what they compute, with their
// rounding points (T is the input type, bf16 or f16):
//   s  = scale * Q K^T in f32, causal-masked (masked P is exactly 0)
//   P  = exp(s - LSE) from the forward's LSE [B*H, Sq] f32
//   dP = dO V^T, delta = rowsum(dO * O) in f32, dS = P * (dP - delta)
//   dQ = scale * T(dS) K, dK = scale * T(dS)^T Q, dV = T(P)^T dO
// each product accumulated in f32 and cast once at the end.
//
// What bounds them on the H100. The dQ kernel does 6 * Sq * Sk * D
// operations per (batch, head) and the dK/dV kernel 8 * Sq * Sk * D (about
// half of each when causal) against Q, K, V, O, dO and LSE read once and
// the gradients written once. At B=4, H=8, S=2048, causal that is ~26 and
// ~34 GFLOP at D=64 (~103 and ~138 at D=256) against ~50 MB (~200 MB), so
// both are bound by operations: 0.026 and 0.035 ms at D=64, 0.104 and
// 0.139 ms at D=256, at 989 TFLOP/s (chip_smoke.py's backward_bound). What
// the design does about it:
// - All four products of a tile run on wgmma. dQ kernel: S = Q K^T and
//   dP = dO V^T with both operands K-major in shared memory (as stored),
//   dQ += dS K with dS in registers and K read MN-major. dK/dV kernel, in
//   the transposed form: S^T = K Q^T and dP^T = V dO^T (K-major, as
//   stored), dV += T(P^T) dO and dK += T(dS^T) Q with the A operand in
//   registers and dO, Q read MN-major. An f32 accumulator packed to pairs
//   of T is the next product's A operand as it lies (the layout note in
//   hopper_tma_wgmma.cuh), so P and dS never go through shared memory and
//   nothing is transposed.
// - One producer warp starts TMA copies into a ring of kStages = 3 slots,
//   each with a full and an empty mbarrier. Causal tiles that the mask
//   empties are never loaded, and a warpgroup skips the products of a
//   loaded tile that its own rows (or keys) cannot see.
// - dQ kernel: one CTA per (b*h, 128 query rows), 64 rows per consumer
//   warpgroup. Q and dO are loaded once; K and V tiles stream through the
//   ring (64 keys, 32 at D=256). It computes delta from dO and O (as the
//   reference does) and writes it as a side output [B*H, Sq] f32 for the
//   dK/dV kernel, which runs after it on the same stream. The heaviest
//   causal tiles (the last rows) are scheduled first. A tile's dQ product
//   stays in flight while the next tile's S and dP are issued (in the dK/dV
//   kernel the same overlap of its dV and dK products measured slower on
//   the H100, so it waits for them).
// - dK/dV kernel: K and V are loaded once; Q and dO tiles stream through
//   the ring from the first tile that reaches the diagonal, with the tile's
//   LSE and delta, which the producer warp copies into the slot (they are
//   broadcast down the columns of S^T). Reading delta rather than streaming
//   O a second time saves a third of the streamed bytes. Up to D=128 a CTA
//   takes 128 keys, 64 per consumer warpgroup, and streams 64-row tiles. At
//   D=256 a warpgroup's dK and dV for 64 keys would be 2 * 128 f32 a
//   thread, over the 255 a thread can hold before S^T and dP^T: so the two
//   warpgroups take the same 64 keys and each owns 128 of D's columns of
//   dK and dV (128 f32 a thread), and each computes the tile's S^T and
//   dP^T itself (the 64 x 32 products over all of D). That repeats S^T and
//   dP^T, half of the kernel's operations, so the kernel does 1.5x the
//   work; sharing them through shared memory instead would cost two
//   barriers a tile and 16-32 KB of a budget that the ring needs. The
//   first key tiles, which see the most query tiles, come first in the
//   grid.
// - Registers: ptxas compiles the consumers under the launch cap of 168
//   registers a thread: the block's nine warps (two consumer warpgroups,
//   one producer warp: 288 threads) put three warps on one of the SM's
//   four register-file quarters (16384 / 96), and setmaxnreg does not
//   raise what ptxas allocates (a 384-thread build with setmaxnreg 24 /
//   240, as the first version had, compiles to the same 168). One producer
//   warp rather than a warpgroup made the dK/dV kernel 13-14% faster at
//   D=64 and D=128 on the H100 (its spills fell from 24 to 0 and from 440
//   to 292 bytes); flash_ab.py rebuilds and times both layouts. A consumer thread holds S and dP (kTile / 2 f32 each,
//   kTile the streamed tile's width) and its accumulators: dQ D/2; dK and
//   dV D/2 each (D/4 each at D=256). At D=256 the streamed tiles are 32
//   wide, and still dQ 128 + S 16 + dP 16 (and its dS in flight) spill
//   216 bytes, dK 64 + dV 64 + S^T 16 + dP^T 16 with their addressing
//   92; 64-wide tiles would add 32 registers to each.
// - Shared memory: dQ kernel 2 * 128 * D * 2 bytes (Q, dO) + kStages * 2 *
//   kKeys * D * 2 (K, V) = 80 KB at D=64, 160 KB at D=128, 224 KB at D=256
//   (32-key tiles: 64-key tiles would need 320 KB); dK/dV kernel 2 * kKeys
//   * D * 2 (K, V) + kStages * (2 * kBlockQ * D * 2 (Q, dO) + 2 * kBlockQ *
//   4 (LSE, delta)) = 82 KB at D=64, 162 KB at D=128 and D=256.
// - Ragged edges: 3-D tensor maps over [B*H, S, D] make TMA zero-fill rows
//   past the end without reading the next head; keys >= Sk (dQ kernel) and
//   query columns >= Sq (dK/dV kernel) get P = 0 explicitly, on the tiles
//   that can hold them, as does the causal diagonal; LSE and delta of
//   columns past Sq read as 0 and are never used. Gradients are staged in
//   shared memory and stored by TMA, which clips rows past the end.
// - Head dims between the instances: a head_dim D (a multiple of 8) runs
//   the instance of the next width kD up, with tensor maps over the real D,
//   so TMA zero-fills every column past D (a 64-column box partly or
//   wholly past D included, its full bytes counted toward the barrier).
//   Zero columns of Q, K, V and dO add nothing to S, dP or the gradients'
//   products, and the gradients' columns past D come out 0 and are not
//   stored: the TMA store clips at D, and a box wholly past D is not
//   issued. At kD = 256 the second dK/dV warpgroup's half then holds D -
//   128 real columns. The dQ kernel reads O and dO for delta itself, D
//   columns a row.
// - Each CTA owns its output rows: no atomics, deterministic results.
//
// Launches on the caller's stream and allocates nothing.

#include "hopper_tma_wgmma.cuh"

namespace {

using namespace hopper;

constexpr int kStages = 3;                 // depth of the streamed ring
constexpr int kConsumerThreads = 256;      // 2 consumer warpgroups
constexpr int kConsumerWarps = kConsumerThreads / 32;
constexpr int kThreads = kConsumerThreads + 32;  // + producer warp
constexpr float kLog2e = 1.4426950408889634f;

// A consumer warp is done with a ring slot: its lanes' reads of the slot
// have completed (wgmma waited on, shared loads consumed), so one arrival
// per warp releases it.
__device__ __forceinline__ void release_slot(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// acc + the dot product of 8 values of T in a and 8 in b.
template <typename T>
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const uint32_t pa[4] = {a.x, a.y, a.z, a.w};
  const uint32_t pb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = to_float2<T>(pa[i]);
    const float2 y = to_float2<T>(pb[i]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

// ---- dQ -------------------------------------------------------------------

constexpr int kDqRows = 128;  // query rows per CTA

template <int kD>
struct DqLayout {
  static constexpr int kKeys = kD == 256 ? 32 : 64;  // keys per K/V tile
  static constexpr int kColBlocks = kD / 64;  // 128-byte column blocks
  static constexpr int kQBytes = kDqRows * kD * 2;
  static constexpr int kKVBytes = kKeys * kD * 2;
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
  static_assert(kAlloc <= 232448, "over the 227 KB a block may use");
};

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_dq,
                          const T* __restrict__ o,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          float* __restrict__ delta, int sq, int sk,
                          int d, float scale, int causal) {
  using L = DqLayout<kD>;
  constexpr int kKeys = L::kKeys;
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
  int n_kb = (sk + kKeys - 1) / kKeys;
  if (causal) n_kb = min(n_kb, (min(q0 + kDqRows, sq) - 1) / kKeys + 1);

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
    // Producer warp: one thread starts every copy.
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
          tma_load_3d(k_s + s * L::kKVBytes + c * kKeys * 128, &tm_k,
                      kv_full(s), 64 * c, kb * kKeys, bh);
          tma_load_3d(v_s + s * L::kKVBytes + c * kKeys * 128, &tm_v,
                      kv_full(s), 64 * c, kb * kKeys, bh);
        }
      }
    }
    return;
  }

  // Consumer warpgroups: 64 query rows each.
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
  // rows; the four lanes of a row each sum a quarter of kD's 8-value
  // chunks, those that lie within the row's d columns.
  float dlt[2], lse2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    float part = 0.f;
    if (row < sq) {
      const size_t off = ((size_t)bh * sq + row) * d;
      const uint4* pd = reinterpret_cast<const uint4*>(dout + off);
      const uint4* po = reinterpret_cast<const uint4*>(o + off);
      const int chunk0 = (lane % 4) * (kD / 32);
#pragma unroll
      for (int j = 0; j < kD / 32; ++j) {
        if (8 * (chunk0 + j) < d) {
          part = dot8<T>(pd[chunk0 + j], po[chunk0 + j], part);
        }
      }
    }
    dlt[h] = quad_sum(part);
    lse2[h] = row < sq ? lse[(size_t)bh * sq + row] * kLog2e : 0.f;
    if (lane % 4 == 0 && row < sq) delta[(size_t)bh * sq + row] = dlt[h];
  }

  float dq[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) dq[i] = 0.f;
  float sc[kKeys / 2];  // S, then P
  float dp[kKeys / 2];  // dP
  uint32_t ds[kKeys / 4];  // T(dS), the A operand of dQ += dS K
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) sc[i] = dp[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kKeys / 4; ++i) ds[i] = 0u;

  // dQ += dS K of a tile stays in flight until the next tile's S and dP
  // are issued; `pending` is that tile's ring slot, -1 when none.
  int pending = -1;
  mbar_wait(q_full, 0);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int s = kb % kStages;
    const uint32_t k_tile = k_s + s * L::kKVBytes;
    const uint32_t v_tile = v_s + s * L::kKVBytes;
    const int k0 = kb * kKeys;
    mbar_wait(kv_full(s), (kb / kStages) & 1);
    // Causal: the first warpgroup's rows see none of the CTA's last tiles.
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
      const uint32_t koff = (kk / 4) * (kKeys * 128) + (kk % 4) * 32;
      wgmma_ss<T, kKeys>(sc, sw128_desc(q_wg + off, 16, 1024),
                         sw128_desc(k_tile + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk / 4) * (kDqRows * 128) + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * (kKeys * 128) + (kk % 4) * 32;
      wgmma_ss<T, kKeys>(dp, sw128_desc(do_wg + off, 16, 1024),
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
    const bool edge = (causal && k0 + kKeys > q0) || k0 + kKeys > sk;
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const int h = (i / 2) % 2;
      const float p = fast_exp2(fmaf(sc[i], scale_log2, -lse2[h]));
      const int key = k0 + 8 * (i / 4) + col_lane + (i % 2);
      sc[i] = edge && (key >= sk || (causal && key > row0 + 8 * h)) ? 0.f
                                                                     : p;
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS = P * (dP - delta), rounded to T (the reference's rounding
    // point) as A fragments; dQ += dS K with K MN-major.
#pragma unroll
    for (int i = 0; i < kKeys / 4; ++i) {
      const float d = dlt[i % 2];
      ds[i] = pack2<T>(sc[2 * i] * (dp[2 * i] - d),
                       sc[2 * i + 1] * (dp[2 * i + 1] - d));
    }
    wgmma_fence();
    fence_regs(dq);
    fence_regs(ds);
#pragma unroll
    for (int t = 0; t < kKeys / 16; ++t) {
      const uint32_t a[4] = {ds[4 * t], ds[4 * t + 1], ds[4 * t + 2],
                             ds[4 * t + 3]};
      wgmma_rs<T, kD>(
          dq, a, sw128_desc(k_tile + t * 16 * 128, kKeys * 128, 1024));
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
  stage_acc<T, kD>(smem + L::kQ, kDqRows * 128, wg * 64, r_local, col_lane,
                   dq, mul);
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (tid == 0 && q0 + wg * 64 < sq) {
    for (int c = 0; c < L::kColBlocks && 64 * c < d; ++c) {
      tma_store_3d(&tm_dq, q_wg + c * kDqRows * 128, 64 * c, q0 + wg * 64,
                   bh);
    }
    tma_store_commit_and_wait();
  }
}

// ---- dK / dV --------------------------------------------------------------

template <int kD>
struct DkvLayout {
  // At D=256 both consumer warpgroups take the CTA's 64 keys and each owns
  // half of D's columns of dK and dV; below it each takes 64 of the CTA's
  // 128 keys and owns every column.
  static constexpr bool kSplitD = kD == 256;
  static constexpr int kKeys = kSplitD ? 64 : 128;    // keys per CTA
  static constexpr int kBlockQ = kSplitD ? 32 : 64;   // rows per Q/dO tile
  static constexpr int kCols = kSplitD ? kD / 2 : kD; // dK/dV columns a group
  static constexpr int kColBlocks = kD / 64;
  static constexpr int kKVBytes = kKeys * kD * 2;
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
  static_assert(kAlloc <= 232448, "over the 227 KB a block may use");
};

template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_dk,
                           const __grid_constant__ CUtensorMap tm_dv,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, int sq, int sk,
                           int d, float scale, int causal) {
  using L = DkvLayout<kD>;
  constexpr int kBlockQ = L::kBlockQ;
  constexpr int kCols = L::kCols;
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
  const int k0 = blockIdx.y * L::kKeys;
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
    // Producer warp: lane 0 starts the copies; the 32 lanes copy each
    // tile's LSE and delta into the slot.
    const int p_lane = threadIdx.x - kConsumerThreads;
    if (p_lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::kKVBytes);
      for (int c = 0; c < L::kColBlocks; ++c) {
        tma_load_3d(k_s + c * L::kKeys * 128, &tm_k, kv_full, 64 * c, k0,
                    bh);
        tma_load_3d(v_s + c * L::kKeys * 128, &tm_v, kv_full, 64 * c, k0,
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
    return;
  }

  // Consumer warpgroups: 64 keys each, and kCols columns of dK and dV
  // starting at col0.
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r_local = (tid / 32) * 16 + lane / 4;  // key row in the warpgroup
  const int key_row = L::kSplitD ? 0 : wg * 64;    // the group's first key
  const int key_base = k0 + key_row;
  const int key0 = key_base + r_local;             // and key0 + 8
  const int col0 = L::kSplitD ? wg * kCols : 0;
  const int col_lane = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;
  const uint32_t k_wg = k_s + key_row * 128;
  const uint32_t v_wg = v_s + key_row * 128;
  const uint32_t col_off = (col0 / 64) * (kBlockQ * 128);

  float dk[kCols / 2], dv[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) dk[i] = dv[i] = 0.f;
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
    if (causal && q0 + kBlockQ <= key_base) {
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
      const uint32_t aoff = (kk / 4) * (L::kKeys * 128) + (kk % 4) * 32;
      const uint32_t boff = (kk / 4) * (kBlockQ * 128) + (kk % 4) * 32;
      wgmma_ss<T, kBlockQ>(sc, sw128_desc(k_wg + aoff, 16, 1024),
                           sw128_desc(q_tile + boff, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t aoff = (kk / 4) * (L::kKeys * 128) + (kk % 4) * 32;
      const uint32_t boff = (kk / 4) * (kBlockQ * 128) + (kk % 4) * 32;
      wgmma_ss<T, kBlockQ>(dp, sw128_desc(v_wg + aoff, 16, 1024),
                           sw128_desc(do_tile + boff, 16, 1024), kk > 0);
    }
    wgmma_commit();

    // P^T = exp(scale * s - LSE[column]) while dP^T is in flight. Columns
    // past Sq, and keys above the diagonal, get 0; only the tiles that
    // overlap this CTA's keys or end past Sq can hold them.
    wgmma_wait<1>();
    fence_regs(sc);
    const bool edge =
        (causal && q0 < k0 + L::kKeys) || q0 + kBlockQ > sq;
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

    // T(P^T) and T(dS^T) = T(P^T * (dP^T - delta[column])) as A
    // fragments; dV += P^T dO and dK += dS^T Q over this group's columns,
    // with dO and Q MN-major.
    uint32_t pp[kBlockQ / 4], ds[kBlockQ / 4];
#pragma unroll
    for (int i = 0; i < kBlockQ / 4; ++i) {
      const float2 d = *reinterpret_cast<const float2*>(
          st + kBlockQ + 8 * (i / 2) + col_lane);
      pp[i] = pack2<T>(sc[2 * i], sc[2 * i + 1]);
      ds[i] = pack2<T>(sc[2 * i] * (dp[2 * i] - d.x),
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
      wgmma_rs<T, kCols>(dv, a,
                         sw128_desc(do_tile + col_off + t * 16 * 128,
                                    kBlockQ * 128, 1024));
    }
#pragma unroll
    for (int t = 0; t < kBlockQ / 16; ++t) {
      const uint32_t a[4] = {ds[4 * t], ds[4 * t + 1], ds[4 * t + 2],
                             ds[4 * t + 3]};
      wgmma_rs<T, kCols>(dk, a,
                         sw128_desc(q_tile + col_off + t * 16 * 128,
                                    kBlockQ * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pp);
    fence_regs(ds);
    release_slot(empty(s), lane);
  }

  // Epilogue: stage scale * dK and dV in this warpgroup's part of the K and
  // V tiles and store them with TMA. A CTA whose keys no query sees stores
  // zeros. At D=256 both groups read every row and column of K and V, so
  // neither overwrites them before both are done.
  if constexpr (L::kSplitD) named_barrier_sync(3, kConsumerThreads);
  const float mul_dk[2] = {scale, scale}, mul_dv[2] = {1.f, 1.f};
  const int blk0 = col0 / 64;  // the group's first 64-column block
  const int blk_bytes = L::kKeys * 128;
  stage_acc<T, kCols>(smem + L::kK + blk0 * blk_bytes, blk_bytes, key_row,
                      r_local, col_lane, dk, mul_dk);
  stage_acc<T, kCols>(smem + L::kV + blk0 * blk_bytes, blk_bytes, key_row,
                      r_local, col_lane, dv, mul_dv);
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (tid == 0 && key_base < sk) {
    for (int c = blk0; c < blk0 + kCols / 64 && 64 * c < d; ++c) {
      tma_store_3d(&tm_dk, k_wg + c * blk_bytes, 64 * c, key_base, bh);
      tma_store_3d(&tm_dv, v_wg + c * blk_bytes, 64 * c, key_base, bh);
    }
    tma_store_commit_and_wait();
  }
}

// ---- host -----------------------------------------------------------------

template <typename T, int kD>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* dq, void* delta,
              int bh, int sq, int sk, int d, float scale, int causal,
              cudaStream_t stream) {
  using L = DqLayout<kD>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  CUresult res = encode_3d<T>(&tm_q, q, bh, sq, d, kDqRows);
  if (res == CUDA_SUCCESS)
    res = encode_3d<T>(&tm_k, k, bh, sk, d, L::kKeys);
  if (res == CUDA_SUCCESS)
    res = encode_3d<T>(&tm_v, v, bh, sk, d, L::kKeys);
  if (res == CUDA_SUCCESS)
    res = encode_3d<T>(&tm_do, dout, bh, sq, d, kDqRows);
  if (res == CUDA_SUCCESS) res = encode_3d<T>(&tm_dq, dq, bh, sq, d, 64);
  if (res != CUDA_SUCCESS) return -(int)res;

  auto kernel = flash_bwd_dq_wgmma_kernel<T, kD>;
  const int smem = L::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (sq + kDqRows - 1) / kDqRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dq, static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), sq, sk, d, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int kD>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int bh, int sq, int sk, int d,
               float scale, int causal, cudaStream_t stream) {
  using L = DkvLayout<kD>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv;
  CUresult res = encode_3d<T>(&tm_q, q, bh, sq, d, L::kBlockQ);
  if (res == CUDA_SUCCESS)
    res = encode_3d<T>(&tm_k, k, bh, sk, d, L::kKeys);
  if (res == CUDA_SUCCESS)
    res = encode_3d<T>(&tm_v, v, bh, sk, d, L::kKeys);
  if (res == CUDA_SUCCESS)
    res = encode_3d<T>(&tm_do, dout, bh, sq, d, L::kBlockQ);
  if (res == CUDA_SUCCESS) res = encode_3d<T>(&tm_dk, dk, bh, sk, d, 64);
  if (res == CUDA_SUCCESS) res = encode_3d<T>(&tm_dv, dv, bh, sk, d, 64);
  if (res != CUDA_SUCCESS) return -(int)res;

  auto kernel = flash_bwd_dkv_wgmma_kernel<T, kD>;
  const int smem = L::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (sk + L::kKeys - 1) / L::kKeys);
  kernel<<<grid, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), sq, sk, d, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dq(int d, const void* q, const void* k, const void* v,
                const void* o, const void* dout, const void* lse, void* dq,
                void* delta, int bh, int sq, int sk, float scale, int causal,
                cudaStream_t s) {
  if (d <= 64)
    return launch_dq<T, 64>(q, k, v, o, dout, lse, dq, delta, bh, sq, sk,
                            d, scale, causal, s);
  if (d <= 128)
    return launch_dq<T, 128>(q, k, v, o, dout, lse, dq, delta, bh, sq, sk,
                             d, scale, causal, s);
  return launch_dq<T, 256>(q, k, v, o, dout, lse, dq, delta, bh, sq, sk,
                           d, scale, causal, s);
}

template <typename T>
int dispatch_dkv(int d, const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int bh, int sq, int sk, float scale,
                 int causal, cudaStream_t s) {
  if (d <= 64)
    return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                             d, scale, causal, s);
  if (d <= 128)
    return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                              d, scale, causal, s);
  return launch_dkv<T, 256>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                            d, scale, causal, s);
}

bool bad_shape(int bh, int sq, int sk, int d, int dtype) {
  return bh < 1 || sq < 1 || sk < 1 || d < 8 || d > 256 || d % 8 != 0 ||
         (dtype != 1 && dtype != 2);
}

}  // namespace

// q, o, dout, dq [B*H, Sq, D]; k, v [B*H, Sk, D]: contiguous, of one type
// (dtype 1: bf16, 2: f16), with 16-byte aligned bases; lse [B*H, Sq] f32
// as the forward writes it; delta [B*H, Sq] f32, written (the dK/dV kernel
// reads it); D a multiple of 8 up to 256. Returns 0, a cudaError_t, or
// minus a CUresult when a tensor map cannot be encoded.
extern "C" int flash_attention_bwd_dq_wgmma(const void* q, const void* k,
                                            const void* v, const void* o,
                                            const void* dout,
                                            const void* lse, void* dq,
                                            void* delta, int bh, int sq,
                                            int sk, int d, float scale,
                                            int causal, int dtype,
                                            void* stream) {
  if (bad_shape(bh, sq, sk, d, dtype) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
       (uintptr_t)dout | (uintptr_t)dq) % 16 ||
      (sq + kDqRows - 1) / kDqRows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 2 ? dispatch_dq<__half>(d, q, k, v, o, dout, lse, dq,
                                          delta, bh, sq, sk, scale, causal, s)
                    : dispatch_dq<__nv_bfloat16>(d, q, k, v, o, dout, lse, dq,
                                                 delta, bh, sq, sk, scale,
                                                 causal, s);
}

// As flash_attention_bwd_dq_wgmma; delta is the dQ kernel's side output,
// dk and dv [B*H, Sk, D] of the inputs' type.
extern "C" int flash_attention_bwd_dkv_wgmma(const void* q, const void* k,
                                             const void* v, const void* dout,
                                             const void* lse,
                                             const void* delta, void* dk,
                                             void* dv, int bh, int sq,
                                             int sk, int d, float scale,
                                             int causal, int dtype,
                                             void* stream) {
  if (bad_shape(bh, sq, sk, d, dtype) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
       (uintptr_t)dk | (uintptr_t)dv) % 16 ||
      (sk + 63) / 64 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 2 ? dispatch_dkv<__half>(d, q, k, v, dout, lse, delta, dk,
                                           dv, bh, sq, sk, scale, causal, s)
                    : dispatch_dkv<__nv_bfloat16>(d, q, k, v, dout, lse,
                                                  delta, dk, dv, bh, sq, sk,
                                                  scale, causal, s);
}
