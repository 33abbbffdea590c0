// Flash attention for head dims above 256 on Hopper's tensor cores
// (sm_90a): the forward (MHA and GQA), dQ and dK/dV, bf16 or f16, head_dim
// any multiple of 8 above 256, with TMA-fed tiles, wgmma products, one
// producer warp and consumer warpgroups. The wrapper's rule of shapes
// sends bf16 and f16 at those head dims here, all three kernels; f32 goes
// to flash_attention_wide_f32.cu. This dQ kernel writes the delta that
// this dK/dV kernel reads.
//
// Replaces, for those head dims, the Pallas TPU kernels of
// ray_tpu/ops/flash_attention.py: `_attn_kernel` as `_flash_forward` (MHA)
// and `_flash_forward_grouped` (GQA, K/V at n_kv_heads width) launch it,
// and `_attn_bwd_dq_kernel` and `_attn_bwd_dkv_kernel` as
// `_flash_bwd_rule` launches them. The
// rounding points are theirs and the narrower tensor-core kernels'
// (flash_attention_fwd_wgmma.cu, flash_attention_bwd_wgmma.cu): Q * scale
// rounded to the input type T (the scale rounded to T first) before the
// forward's Q K^T; scores in f32; P (and dS) rounded to T before their
// products; f32 accumulation; finite -1e30 masking; l clamped at 1e-30; the
// backward's scores scaled in f32 and P rebuilt from the forward's LSE.
//
// What bounds them on the H100. The forward does 4 * Sq * Sk * D
// operations per (batch, head), dQ 6 * Sq * Sk * D and dK/dV 8 * Sq * Sk *
// D (about half of each when causal): at B=4, H=8, S=2048, D=512, causal
// that is ~137, ~206 and ~275 GFLOP against ~70 to ~200 MB moved, so all
// three are bound by operations (0.139, 0.209 and 0.278 ms at 989
// TFLOP/s). What they reach is set by another count: the bytes their CTAs
// copy by TMA from L2 into shared memory, each box again for every tile
// and chunk that reads it. Above D = 1024, where Q (forward), Q and dO
// (dQ) or K and V (dK/dV) stream, that is 26 to 425 GB at D = 1032 and
// 2048, copied at 3.2 to 5.1 TB/s on an H100 (flash_ab.py --wide prints
// the count beside each time; PERF.md).
//
// What stops the narrower tensor-core kernels at 256. A warpgroup that
// owns 64 rows of an output D columns wide holds D / 2 f32 a thread; ptxas
// caps a consumer of a 288-thread block at 168 registers (setmaxnreg does
// not lift it), so no CTA holds a whole row of O or dK/dV at D = 512. And
// a block has 227 KB of shared memory: 128 query rows of Q at D = 512 take
// 128 KB, one 64-key K tile 64 KB.
//
// Design, all three kernels:
// - Grid z splits the output's head dimension into chunks (256 columns of
//   O and of dQ, 128 of dK and dV), as the CUDA-core wide kernels split it
//   into 64. Each CTA reduces the scores (and dP) over all of D and writes
//   its chunk, so the reduction is repeated once per chunk: at D = 512 the
//   forward does 1.5x the real work, dQ (2 * 2 + 1) / 3 = 1.67x and dK/dV
//   2.5x, against 4.5x and more for the CUDA-core kernels.
// - The reduction over D streams 64-column boxes (one 128-byte swizzle row
//   of T) through a TMA ring; a box is read by 4 wgmma of depth 16.
// - No consumer spills: a spilled accumulator makes ptxas serialize the
//   wgmma around it. Phase 1 of chip_smoke.py prints ptxas's registers and
//   spills per instantiation. A forward with two consumer warpgroups (168
//   registers a thread) and a dK/dV kernel with 256-column chunks both
//   spilled, and both ran slower than this layout on the H100.
// - A ragged last chunk (D = 264: 8 real columns) or a box past D is
//   zero-filled by TMA over tensor maps at the real D, counted in full
//   bytes toward its barrier; zero columns add nothing, and the stores
//   clip at D (a store box wholly past D is not issued).
// - Ragged rows: 3-D tensor maps over [B*H, S, D] zero-fill rows past the
//   end without reading the next head; masked scores are -1e30 (forward)
//   or P = 0 (backward); the TMA stores clip rows past the end.
// - Each CTA owns its outputs: no atomics, deterministic results.
//
// Forward (flash_fwd_wide_wgmma_kernel<T, kResident>): a CTA owns 64 query
// rows of one (b, h) and one 256-column chunk of O, in one consumer
// warpgroup (128 f32 of O a thread; 160 threads, so ptxas may give a
// thread up to 255 registers, and it uses 202 without spilling) and a
// producer warp. K streams as 64-key x 64-column boxes through a ring of
// kFwdKStages slots, and V as 64-key x 256-column tiles of the chunk
// through a ring of kFwdVStages. Up to D = 1024 (kFwdResidentMaxD) Q's
// rows stay in shared memory over all of D (64 KB at D = 512, 128 KB at
// D = 1024), scaled and rounded there once. Above it they no longer fit
// beside the rings, so Q streams too: each K slot also holds the Q box of
// the CTA's rows that meets its K box, read again for every key tile (from
// L2: the CTA's rows stay hot there). A streamed box cannot be scaled
// where it lands without a barrier per box, so a pre-pass
// (wide_q_scale_kernel) writes q * scale rounded to T once into a buffer
// the caller gives (one more read and write of Q), which the boxes then
// stream from. Per key tile S = Q K^T accumulates over D's boxes, then the
// online softmax, then O += P V with P in registers. The last query rows
// (the heaviest causal tiles) are scheduled first. LSE is written by the
// CTAs of chunk 0.
//
// dK/dV (flash_bwd_dkv_wide_wgmma_kernel<T, kResident>): a CTA owns 64 keys
// of one (b, h) and one 128-column chunk of dK and dV; each of its two
// consumer warpgroups owns 64 of the chunk's columns (dK and dV: 32 f32
// each a thread). Query tiles of 32 rows stream from the first one that
// reaches the diagonal. The two reductions of a tile, S^T = K Q^T and dP^T
// = V dO^T, are split between the warpgroups (the first computes S^T and
// P^T = exp(scale * S^T - LSE), the second dP^T) and exchanged through
// shared memory, double-buffered with one named barrier a tile, so neither
// is computed twice in a CTA (the head_dim 256 dK/dV kernel computes both
// in each warpgroup). Then each warpgroup forms T(P^T) and T(dS^T) =
// T(P^T * (dP^T - delta)) and adds dV += P^T dO and dK += dS^T Q over its
// columns, A in registers, dO and Q MN-major from the ring. A tile's Q and
// dO boxes (32 rows x 64 columns each, one ring slot) arrive in an order
// that puts the chunk's own boxes last: the slots of the other boxes are
// released once their reduction is done, so the next tile's first boxes
// load while the chunk's boxes are still held for the products. Up to D =
// 512 K and V for the CTA's 64 keys stay in shared memory (kResident, 128
// KB at D = 512); above it they stream with the Q and dO boxes in the same
// slots, read again for every query tile. delta = rowsum(dO * O) [B*H,
// Sq] f32 is the dQ kernel's side output (below), which runs first on the
// same stream: streaming O a second time here would add a third to the
// streamed bytes. The producer warp copies a tile's LSE and delta into a
// two-slot ring.
//
// dQ (flash_bwd_dq_wide_wgmma_kernel<T, kResident>): dK/dV turned around.
// A CTA owns 64 query rows of one (b, h) and one 256-column chunk of dQ;
// each of its two consumer warpgroups owns 128 of the chunk's columns (64
// f32 a thread, the budget dK/dV spends on dK and dV). Key tiles of 32
// keys stream up to the CTA's last row when causal (the heaviest causal
// CTAs first). The two reductions of a tile, S = Q K^T and dP = dO V^T,
// are split between the warpgroups (the first computes S and P =
// exp(scale * S - LSE), the second dP) and exchanged through shared
// memory, double-buffered with one named barrier a tile. Then each forms
// T(dS) = T(P * (dP - delta)) and adds dQ += dS K over its columns, A in
// registers, K's chunk boxes MN-major from the ring; a tile's K and V
// boxes (32 keys x 64 columns each, one ring slot) arrive with the
// chunk's last, so the other slots free early. Up to D = 512 Q and dO for
// the CTA's 64 rows stay in shared memory (kResident, 128 KB at D = 512);
// above it they stream with the K and V boxes in the same slots. delta =
// rowsum(dO * O) of the CTA's rows is summed from device memory once,
// before the key loop, half of D's columns by each warpgroup; the CTAs of
// chunk 0 write it [B*H, Sq] f32 for dK/dV. The CTA's dQ is staged in the
// ring and stored with TMA.
//
// Launches on the caller's stream and allocates nothing.

#include <algorithm>

#include "hopper_tma_wgmma.cuh"

namespace {

using namespace hopper;

constexpr int kChunk = 256;                // columns of O per forward CTA
constexpr int kChunkBoxes = kChunk / 64;   // 64-column boxes of a chunk
constexpr int kBox = 64 * 128;             // 64 rows x 64 columns of T
constexpr int kSmemLimit = 232448;         // 227 KB a block may use
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// A consumer warp is done with a ring slot: its lanes' reads of the slot
// have completed (wgmma waited on, shared loads consumed), so one arrival
// per warp releases it.
__device__ __forceinline__ void release_slot(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Ring slot and phase parity of the n-th use of a ring of kStages slots.
template <int kStages>
__device__ __forceinline__ int slot_of(int n) {
  return n % kStages;
}
template <int kStages>
__device__ __forceinline__ uint32_t parity_of(int n) {
  return (n / kStages) & 1;
}

// ---- forward --------------------------------------------------------------

constexpr int kFwdRows = 64;      // query rows per CTA: one warpgroup
constexpr int kFwdKeys = 64;      // keys per K/V tile
constexpr int kFwdKStages = 4;    // K boxes in flight
constexpr int kFwdVStages = 2;    // V tiles in flight
constexpr int kFwdConsumers = 128;
constexpr int kFwdThreads = kFwdConsumers + 32;  // + producer warp
constexpr int kFwdVBytes = kFwdKeys * kChunk * 2;  // a V tile of the chunk

// Q's rows stay in shared memory up to this head_dim; above it they stream.
constexpr int kFwdResidentMaxD = 1024;

// Barriers in the first 1024 bytes: q_full, then k_full and k_empty per K
// slot, then v_full and v_empty per V slot; then the K ring, the V ring
// and, when Q is held, Q's D / 64 boxes.
template <bool kResident>
struct FwdLayout {
  // A K ring slot: a K box and, when Q streams, the Q box it meets.
  static constexpr int kSlot = (kResident ? 1 : 2) * kBox;
  static constexpr int kK = 1024;
  static constexpr int kV = kK + kFwdKStages * kSlot;
  static constexpr int kQ = kV + kFwdVStages * kFwdVBytes;
  // Dynamic shared memory is only 16-byte aligned: a swizzle atom more
  // lets the base be rounded up to 1024 bytes.
  static constexpr int alloc(int n_boxes) {
    return kQ + (kResident ? n_boxes * kBox : 0) + 1024;
  }
};
static_assert(FwdLayout<true>::alloc(kFwdResidentMaxD / 64) <= kSmemLimit &&
                  FwdLayout<false>::alloc(0) <= kSmemLimit,
              "over the 227 KB a block may use");
// Where Q streams, the epilogue stages the CTA's O chunk in the V ring.
static_assert(kFwdVStages * kFwdVBytes >= kChunkBoxes * kBox,
              "the V ring holds the CTA's O chunk");

// The streamed forward's pre-pass: out = q * scale rounded to T, the scale
// rounded to T first (the held rows' arithmetic, scale4), over n groups of
// eight values.
template <typename T>
__global__ void __launch_bounds__(256)
wide_q_scale_kernel(const uint4* __restrict__ q, uint4* __restrict__ out,
                    size_t n, float scale) {
  const float scale_t = round_to<T>(scale);
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    out[i] = scale4<T>(q[i], scale_t);
  }
}

// tm_q: the rows as they are where Q is held (kResident), the pre-pass's
// scaled rows where it streams.
template <typename T, bool kResident>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_o,
                            float* __restrict__ lse, int hq, int hkv, int sq,
                            int sk, int d, float scale, int causal) {
  using L = FwdLayout<kResident>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_full = base;
  auto k_full = [&](int s) { return base + 8 * (1 + s); };
  auto k_empty = [&](int s) { return base + 8 * (1 + kFwdKStages + s); };
  auto v_full = [&](int s) { return base + 8 * (1 + 2 * kFwdKStages + s); };
  auto v_empty = [&](int s) {
    return base + 8 * (1 + 2 * kFwdKStages + kFwdVStages + s);
  };
  const uint32_t k_s = base + L::kK;
  const uint32_t v_s = base + L::kV;
  const uint32_t q_s = base + L::kQ;

  const int n_boxes = (d + 63) / 64;
  const int bh = blockIdx.x;  // b * hq + h
  const int b = bh / hq;
  const int kv_bh = b * hkv + (bh - b * hq) / (hq / hkv);
  // Heaviest causal tiles first: blockIdx.y 0 takes the last query rows.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdRows;
  const int c0 = blockIdx.z * kChunk;
  int n_kb = (sk + kFwdKeys - 1) / kFwdKeys;
  if (causal) n_kb = min(n_kb, (min(q0 + kFwdRows, sq) - 1) / kFwdKeys + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdKStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(k_empty(s), kFwdConsumers / 32);
    }
    for (int s = 0; s < kFwdVStages; ++s) {
      mbar_init(v_full(s), 1);
      mbar_init(v_empty(s), kFwdConsumers / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kFwdConsumers) {
    // Producer warp: one thread starts every copy. Per key tile, D's K
    // boxes in order (each with its Q box where Q streams), then the
    // chunk's V tile.
    if (threadIdx.x == kFwdConsumers) {
      if (kResident) {
        mbar_arrive_expect_tx(q_full, n_boxes * kBox);
        for (int c = 0; c < n_boxes; ++c) {
          tma_load_3d(q_s + c * kBox, &tm_q, q_full, 64 * c, q0, bh);
        }
      }
      int kn = 0;
      for (int kb = 0; kb < n_kb; ++kb) {
        for (int c = 0; c < n_boxes; ++c, ++kn) {
          const int s = slot_of<kFwdKStages>(kn);
          const uint32_t slot = k_s + s * L::kSlot;
          mbar_wait(k_empty(s), parity_of<kFwdKStages>(kn) ^ 1);
          mbar_arrive_expect_tx(k_full(s), L::kSlot);
          tma_load_3d(slot, &tm_k, k_full(s), 64 * c, kb * kFwdKeys, kv_bh);
          if (!kResident) {
            tma_load_3d(slot + kBox, &tm_q, k_full(s), 64 * c, q0, bh);
          }
        }
        const int s = slot_of<kFwdVStages>(kb);
        mbar_wait(v_empty(s), parity_of<kFwdVStages>(kb) ^ 1);
        mbar_arrive_expect_tx(v_full(s), kFwdVBytes);
        for (int j = 0; j < kChunkBoxes; ++j) {
          tma_load_3d(v_s + s * kFwdVBytes + j * kBox, &tm_v, v_full(s),
                      c0 + 64 * j, kb * kFwdKeys, kv_bh);
        }
      }
    }
    return;
  }

  // The consumer warpgroup: 64 query rows, the chunk's 256 columns of O.
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r_local = (tid / 32) * 16 + lane / 4;  // row in the CTA
  const int row0 = q0 + r_local;                   // and row0 + 8
  const int col_lane = 2 * (lane % 4);

  float o[kChunk / 2];
#pragma unroll
  for (int i = 0; i < kChunk / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of raw scores per row
  float l[2] = {0.f, 0.f};          // this thread's share of the row sum
  float sc[kFwdKeys / 2];           // scores, then p, of one key tile
#pragma unroll
  for (int i = 0; i < kFwdKeys / 2; ++i) sc[i] = 0.f;

  // Held Q times the scale rounded to T, rounded to T in place over all of
  // D (elementwise, so the swizzle does not matter).
  if (kResident) {
    mbar_wait(q_full, 0);
    const float scale_t = round_to<T>(scale);
    uint4* rows = reinterpret_cast<uint4*>(smem + L::kQ);
    for (int i = tid; i < n_boxes * 64 * 8; i += kFwdConsumers) {
      rows[i] = scale4<T>(rows[i], scale_t);
    }
    fence_proxy_async();
    named_barrier_sync(1, kFwdConsumers);
  }

  int kn = 0;  // K boxes consumed, as the producer counts them
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kFwdKeys;
    const int vslot = slot_of<kFwdVStages>(kb);
    const uint32_t v_tile = v_s + vslot * kFwdVBytes;

    // S = Q K^T over D's boxes; a box's slot is released once the next
    // box's products are issued and its own have completed.
    wgmma_fence();
    fence_regs(sc);
    int pending = -1;
    for (int c = 0; c < n_boxes; ++c, ++kn) {
      const int s = slot_of<kFwdKStages>(kn);
      const uint32_t slot = k_s + s * L::kSlot;
      const uint32_t qbox = kResident ? q_s + c * kBox : slot + kBox;
      mbar_wait(k_full(s), parity_of<kFwdKStages>(kn));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss<T, kFwdKeys>(sc, sw128_desc(qbox + kk * 32, 16, 1024),
                              sw128_desc(slot + kk * 32, 16, 1024),
                              c > 0 || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (pending >= 0) release_slot(k_empty(pending), lane);
      pending = s;
    }
    wgmma_wait<0>();
    fence_regs(sc);
    release_slot(k_empty(pending), lane);

    // Only a tile that ends past Sk, or reaches past the CTA's first row,
    // can hold keys past Sk or past the causal diagonal.
    if ((causal && k0 + kFwdKeys - 1 > q0) || k0 + kFwdKeys > sk) {
#pragma unroll
      for (int i = 0; i < kFwdKeys / 2; ++i) {
        const int key = k0 + 8 * (i / 4) + col_lane + (i % 2);
        const int row = row0 + 8 * ((i / 2) % 2);
        if (key >= sk || (causal && key > row)) sc[i] = kNegInf;
      }
    }

    // Online softmax in f32: new row maxima, rescale factors, p.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kFwdKeys / 2; ++i) {
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    }
    float alpha[2], neg[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      alpha[h] = fast_exp2((m[h] - mx[h]) * kLog2e);
      neg[h] = -mx[h] * kLog2e;
      m[h] = mx[h];
    }
#pragma unroll
    for (int i = 0; i < kFwdKeys / 2; ++i) {
      const int h = (i / 2) % 2;
      sc[i] = fast_exp2(fmaf(sc[i], kLog2e, neg[h]));
      sum[h] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i) o[i] *= alpha[(i / 2) % 2];

    // P rounded to T (the reference's rounding point) as A fragments.
    uint32_t p[kFwdKeys / 4];
#pragma unroll
    for (int i = 0; i < kFwdKeys / 4; ++i) {
      p[i] = pack2<T>(sc[2 * i], sc[2 * i + 1]);
    }

    // O += P V over the chunk, 16 keys per wgmma; V is MN-major.
    mbar_wait(v_full(vslot), parity_of<kFwdVStages>(kb));
    wgmma_fence();
    fence_regs(o);
    fence_regs(p);
#pragma unroll
    for (int t = 0; t < kFwdKeys / 16; ++t) {
      const uint32_t a[4] = {p[4 * t], p[4 * t + 1], p[4 * t + 2],
                             p[4 * t + 3]};
      wgmma_rs<T, kChunk>(o, a,
                          sw128_desc(v_tile + t * 16 * 128, kBox, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    release_slot(v_empty(vslot), lane);
  }

  // Epilogue: O = acc / l; LSE = m + log(l) from the CTAs of chunk 0.
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = fmaxf(quad_sum(l[h]), 1e-30f);
    inv[h] = 1.f / lt;
    const int row = row0 + 8 * h;
    if (blockIdx.z == 0 && lane % 4 == 0 && row < sq) {
      lse[(size_t)bh * sq + row] = m[h] + logf(lt);
    }
  }
  // Stage O, in the swizzle the TMA store reads, in held Q's first four
  // boxes (a warp's rows of Q, which only its own completed wgmma read;
  // D > 256 gives Q at least five), or where Q streams in the V ring once
  // every warp's last products (reading all of a V tile's rows) are done.
  uint32_t o_s = q_s;
  if (!kResident) {
    o_s = v_s;
    named_barrier_sync(1, kFwdConsumers);
  }
  stage_acc<T, kChunk>(smem + (o_s - base), kBox, 0, r_local, col_lane, o,
                       inv);
  fence_proxy_async();
  named_barrier_sync(1, kFwdConsumers);
  if (tid == 0) {
    for (int j = 0; j < kChunkBoxes && c0 + 64 * j < d; ++j) {
      tma_store_3d(&tm_o, o_s + j * kBox, c0 + 64 * j, q0, bh);
    }
    tma_store_commit_and_wait();
  }
}

// ---- dK / dV --------------------------------------------------------------

constexpr int kDkvKeys = 64;         // keys per CTA, both warpgroups
constexpr int kDkvRows = 32;         // query rows per streamed tile
constexpr int kDkvStages = 8;        // ring slots: a tile's chunk boxes
                                     // held, the rest streaming
constexpr int kDkvConsumerThreads = 256;
constexpr int kDkvConsumerWarps = kDkvConsumerThreads / 32;
constexpr int kDkvThreads = kDkvConsumerThreads + 32;  // + producer warp
constexpr int kRowBox = kDkvRows * 128;  // 32 rows x 64 columns of T
constexpr int kDkvChunk = 128;           // dK/dV columns per CTA
constexpr int kDkvChunkBoxes = kDkvChunk / 64;
constexpr int kWgBoxes = kDkvChunkBoxes / 2;  // 64-column boxes a group owns
// The exchange of one tile: P^T then dP^T, 64 x 32 f32 each, in the
// accumulators' per-thread order.
constexpr int kXFloats = 2 * kDkvKeys * kDkvRows;

template <bool kResident>
struct DkvLayout {
  // A ring slot: the Q box, the dO box and, when K and V stream, their
  // boxes of the CTA's keys.
  static constexpr int kSlot = 2 * kRowBox + (kResident ? 0 : 2 * kBox);
  // D's boxes of K and V held at most; streamed, D is not bounded here.
  static constexpr int kMaxBoxes = 512 / 64;
  // Barriers in the first 512 bytes (kv_full; full and empty per ring
  // slot; stat_full and stat_empty per stats slot), the two stats slots
  // (LSE * log2 e and delta of 32 rows) in the next 512.
  static constexpr int kStats = 512;
  static constexpr int kX = 1024;                       // exchange, 2 tiles
  static constexpr int kRing = kX + 2 * kXFloats * 4;
  static constexpr int kKV = kRing + kDkvStages * kSlot;  // resident K, V
  static constexpr int alloc(int n_boxes) {
    return kKV + (kResident ? 2 * n_boxes * kBox : 0) + 1024;
  }
};
static_assert(DkvLayout<true>::alloc(DkvLayout<true>::kMaxBoxes) <=
                      kSmemLimit &&
                  DkvLayout<false>::alloc(0) <= kSmemLimit,
              "over the 227 KB a block may use");
// The epilogue stages the CTA's dK and dV (a box a warpgroup each) in the
// ring.
static_assert(kDkvStages * DkvLayout<true>::kSlot >=
                  2 * kDkvChunkBoxes * kBox,
              "the ring holds the CTA's dK and dV");

// The 64-column box of D that item j of a tile carries: first the boxes
// outside the chunk [cb0, cb0 + kChunkBoxes), in order, then the chunk's
// (a box at or past n_boxes lies wholly past D and arrives as zeros).
template <int kChunkBoxes>
__device__ __forceinline__ int item_box(int j, int n_other, int cb0) {
  if (j >= n_other) return cb0 + (j - n_other);
  return j < cb0 ? j : j + kChunkBoxes;
}

template <typename T, bool kResident>
__global__ void __launch_bounds__(kDkvThreads, 1)
flash_bwd_dkv_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_do,
                                const __grid_constant__ CUtensorMap tm_dk,
                                const __grid_constant__ CUtensorMap tm_dv,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta, int sq,
                                int sk, int d, float scale, int causal) {
  using L = DkvLayout<kResident>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t kv_full = base;
  auto full = [&](int s) { return base + 8 * (1 + s); };
  auto empty = [&](int s) { return base + 8 * (1 + kDkvStages + s); };
  auto stat_full = [&](int s) { return base + 8 * (1 + 2 * kDkvStages + s); };
  auto stat_empty = [&](int s) {
    return base + 8 * (3 + 2 * kDkvStages + s);
  };
  float* stats = reinterpret_cast<float*>(smem + L::kStats);
  float* xch = reinterpret_cast<float*>(smem + L::kX);
  const uint32_t ring = base + L::kRing;
  const uint32_t kv_s = base + L::kKV;

  const int n_boxes = (d + 63) / 64;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kDkvKeys;
  const int c0 = blockIdx.z * kDkvChunk;
  const int cb0 = c0 / 64;
  const int n_other = cb0 + max(0, n_boxes - cb0 - kDkvChunkBoxes);
  const int n_items = n_other + kDkvChunkBoxes;
  const int n_qb = (sq + kDkvRows - 1) / kDkvRows;
  // Causal: query tiles that end before this CTA's first key are fully
  // masked (the reference's `ki * block_k // block_q`).
  const int qb0 = causal ? min(k0 / kDkvRows, n_qb) : 0;
  const int n_it = n_qb - qb0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kDkvConsumerWarps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(stat_full(s), 32);  // the producer warp's lanes
      mbar_init(stat_empty(s), kDkvConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kDkvConsumerThreads) {
    // Producer warp: lane 0 starts the copies; the 32 lanes copy each
    // tile's LSE and delta into the stats ring.
    const int p_lane = threadIdx.x - kDkvConsumerThreads;
    if (kResident && p_lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * n_boxes * kBox);
      for (int c = 0; c < n_boxes; ++c) {
        tma_load_3d(kv_s + c * kBox, &tm_k, kv_full, 64 * c, k0, bh);
        tma_load_3d(kv_s + (n_boxes + c) * kBox, &tm_v, kv_full, 64 * c, k0,
                    bh);
      }
    }
    int n = 0;  // ring uses
    for (int it = 0; it < n_it; ++it) {
      const int q0 = (qb0 + it) * kDkvRows;
      const int ss = slot_of<2>(it);
      mbar_wait(stat_empty(ss), parity_of<2>(it) ^ 1);
      float* st = stats + ss * 2 * kDkvRows;
      {
        const int r = p_lane;  // 32 lanes, 32 rows
        const bool ok = q0 + r < sq;
        const size_t at = (size_t)bh * sq + q0 + r;
        st[r] = ok ? lse[at] * kLog2e : 0.f;
        st[kDkvRows + r] = ok ? delta[at] : 0.f;
      }
      // Each lane's arrival releases its own stores to the consumers.
      mbar_arrive(stat_full(ss));
      if (p_lane != 0) continue;
      for (int j = 0; j < n_items; ++j, ++n) {
        const int s = slot_of<kDkvStages>(n);
        const int c = item_box<kDkvChunkBoxes>(j, n_other, cb0);
        const uint32_t slot = ring + s * L::kSlot;
        mbar_wait(empty(s), parity_of<kDkvStages>(n) ^ 1);
        mbar_arrive_expect_tx(full(s), L::kSlot);
        tma_load_3d(slot, &tm_q, full(s), 64 * c, q0, bh);
        tma_load_3d(slot + kRowBox, &tm_do, full(s), 64 * c, q0, bh);
        if (!kResident) {
          tma_load_3d(slot + 2 * kRowBox, &tm_k, full(s), 64 * c, k0, bh);
          tma_load_3d(slot + 2 * kRowBox + kBox, &tm_v, full(s), 64 * c, k0,
                      bh);
        }
      }
    }
    return;
  }

  // Consumer warpgroups: the CTA's 64 keys each; the first reduces S^T
  // (K and Q), the second dP^T (V and dO); each owns kWgBoxes boxes of dK
  // and dV, in two 64-column boxes.
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r_local = (tid / 32) * 16 + lane / 4;  // key row in the CTA
  const int key0 = k0 + r_local;                   // and key0 + 8
  const int col_lane = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;

  float dk[kWgBoxes][32], dv[kWgBoxes][32];
#pragma unroll
  for (int h = 0; h < kWgBoxes; ++h) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[h][i] = dv[h][i] = 0.f;
  }
  float acc[kDkvRows / 2];  // S^T then P^T (group 0), dP^T (group 1)
#pragma unroll
  for (int i = 0; i < kDkvRows / 2; ++i) acc[i] = 0.f;

  if (kResident) mbar_wait(kv_full, 0);
  int n = 0;
  for (int it = 0; it < n_it; ++it) {
    const int q0 = (qb0 + it) * kDkvRows;

    // The reduction over D's boxes, 16 columns per wgmma: group 0 S^T = K
    // Q^T, group 1 dP^T = V dO^T, A the keys' rows and B the tile's, both
    // K-major. The slot of a box outside the chunk is released once the
    // next box's products are issued and its own have completed; the
    // chunk's four slots stay for the products.
    wgmma_fence();
    fence_regs(acc);
    int pending = -1;
    const int n_chunk0 = n + n_other;  // ring use of the chunk's first box
    for (int j = 0; j < n_items; ++j, ++n) {
      const int s = slot_of<kDkvStages>(n);
      const int c = item_box<kDkvChunkBoxes>(j, n_other, cb0);
      const uint32_t slot = ring + s * L::kSlot;
      mbar_wait(full(s), parity_of<kDkvStages>(n));
      if (c < n_boxes) {
        const uint32_t a = kResident ? kv_s + (wg * n_boxes + c) * kBox
                                     : slot + 2 * kRowBox + wg * kBox;
        const uint32_t bt = slot + wg * kRowBox;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss<T, kDkvRows>(acc, sw128_desc(a + kk * 32, 16, 1024),
                                sw128_desc(bt + kk * 32, 16, 1024),
                                j > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      if (pending >= 0) release_slot(empty(pending), lane);
      pending = j < n_other ? s : -1;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (pending >= 0) release_slot(empty(pending), lane);

    // Group 0: P^T = exp(scale * S^T - LSE[column]); columns past Sq, and
    // keys above the diagonal, get 0 (only tiles that overlap the CTA's
    // keys or end past Sq can hold them).
    const int ss = slot_of<2>(it);
    mbar_wait(stat_full(ss), parity_of<2>(it));
    const float* st = stats + ss * 2 * kDkvRows;
    if (wg == 0) {
      const bool edge =
          (causal && q0 < k0 + kDkvKeys) || q0 + kDkvRows > sq;
#pragma unroll
      for (int j = 0; j < kDkvRows / 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(st + 8 * j + col_lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const int col = q0 + 8 * j + col_lane + (e % 2);
          const int key = key0 + 8 * (e / 2);
          const float p =
              fast_exp2(fmaf(acc[i], scale_log2, -(e % 2 ? l2.y : l2.x)));
          acc[i] = edge && (col >= sq || (causal && key > col)) ? 0.f : p;
        }
      }
    }
    // Exchange: group 0 gives P^T, group 1 dP^T; a thread of one group
    // holds the same elements as the same thread of the other.
    float* x = xch + (it & 1) * kXFloats;
    float* mine = x + wg * (kXFloats / 2);
    const float* theirs = x + (1 - wg) * (kXFloats / 2);
#pragma unroll
    for (int i = 0; i < kDkvRows / 2; ++i) mine[i * 128 + tid] = acc[i];
    named_barrier_sync(3, kDkvConsumerThreads);

    // T(P^T) and T(dS^T) = T(P^T * (dP^T - delta[column])) as A fragments.
    uint32_t pp[kDkvRows / 4], ds[kDkvRows / 4];
#pragma unroll
    for (int i = 0; i < kDkvRows / 4; ++i) {
      const float2 dl = *reinterpret_cast<const float2*>(
          st + kDkvRows + 8 * (i / 2) + col_lane);
      float p0, p1, dp0, dp1;
      if (wg == 0) {
        p0 = acc[2 * i];
        p1 = acc[2 * i + 1];
        dp0 = theirs[(2 * i) * 128 + tid];
        dp1 = theirs[(2 * i + 1) * 128 + tid];
      } else {
        p0 = theirs[(2 * i) * 128 + tid];
        p1 = theirs[(2 * i + 1) * 128 + tid];
        dp0 = acc[2 * i];
        dp1 = acc[2 * i + 1];
      }
      pp[i] = pack2<T>(p0, p1);
      ds[i] = pack2<T>(p0 * (dp0 - dl.x), p1 * (dp1 - dl.y));
    }
    release_slot(stat_empty(ss), lane);

    // dV += P^T dO and dK += dS^T Q over this group's two boxes of the
    // chunk, with dO and Q MN-major in the chunk's slots.
    wgmma_fence();
    fence_regs(pp);
    fence_regs(ds);
#pragma unroll
    for (int h = 0; h < kWgBoxes; ++h) {
      fence_regs(dk[h]);
      fence_regs(dv[h]);
      const uint32_t slot =
          ring + slot_of<kDkvStages>(n_chunk0 + kWgBoxes * wg + h) * L::kSlot;
#pragma unroll
      for (int t = 0; t < kDkvRows / 16; ++t) {
        const uint32_t ap[4] = {pp[4 * t], pp[4 * t + 1], pp[4 * t + 2],
                                pp[4 * t + 3]};
        const uint32_t ad[4] = {ds[4 * t], ds[4 * t + 1], ds[4 * t + 2],
                                ds[4 * t + 3]};
        wgmma_rs<T, 64>(dv[h], ap,
                        sw128_desc(slot + kRowBox + t * 16 * 128, kRowBox,
                                   1024));
        wgmma_rs<T, 64>(dk[h], ad,
                        sw128_desc(slot + t * 16 * 128, kRowBox, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pp);
    fence_regs(ds);
#pragma unroll
    for (int h = 0; h < kWgBoxes; ++h) {
      fence_regs(dk[h]);
      fence_regs(dv[h]);
    }
    for (int t = 0; t < kDkvChunkBoxes; ++t) {
      release_slot(empty(slot_of<kDkvStages>(n_chunk0 + t)), lane);
    }
  }

  // Epilogue: stage scale * dK and dV in the ring (every slot consumed by
  // both groups first) and store them with TMA. A CTA whose keys no query
  // sees stores zeros.
  named_barrier_sync(3, kDkvConsumerThreads);
  const float mul_dk[2] = {scale, scale}, mul_dv[2] = {1.f, 1.f};
#pragma unroll
  for (int h = 0; h < kWgBoxes; ++h) {
    const int box = kWgBoxes * wg + h;  // dK's box; dV's kDkvChunkBoxes on
    stage_acc<T, 64>(smem + L::kRing + box * kBox, kBox, 0, r_local,
                     col_lane, dk[h], mul_dk);
    stage_acc<T, 64>(smem + L::kRing + (kDkvChunkBoxes + box) * kBox, kBox,
                     0, r_local, col_lane, dv[h], mul_dv);
  }
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (tid == 0 && k0 < sk) {
    for (int h = 0; h < kWgBoxes; ++h) {
      const int box = kWgBoxes * wg + h;
      if (c0 + 64 * box >= d) break;
      tma_store_3d(&tm_dk, ring + box * kBox, c0 + 64 * box, k0, bh);
      tma_store_3d(&tm_dv, ring + (kDkvChunkBoxes + box) * kBox,
                   c0 + 64 * box, k0, bh);
    }
    tma_store_commit_and_wait();
  }
}

// ---- dQ -------------------------------------------------------------------

constexpr int kDqRows = 64;          // query rows per CTA, both warpgroups
constexpr int kDqKeys = 32;          // keys per streamed tile
constexpr int kDqStages = 8;         // ring slots: a tile's chunk boxes
                                     // held, the rest streaming
constexpr int kDqConsumerThreads = 256;
constexpr int kDqConsumerWarps = kDqConsumerThreads / 32;
constexpr int kDqThreads = kDqConsumerThreads + 32;  // + producer warp
constexpr int kKeyBox = kDqKeys * 128;   // 32 keys x 64 columns of T
constexpr int kDqChunk = 256;            // dQ columns per CTA
constexpr int kDqChunkBoxes = kDqChunk / 64;
constexpr int kDqWgBoxes = kDqChunkBoxes / 2;  // 64-column boxes a group owns
// The exchange of one tile: P then dP, 64 x 32 f32 each, in the
// accumulators' per-thread order.
constexpr int kDqXFloats = 2 * kDqRows * kDqKeys;

template <bool kResident>
struct DqLayout {
  // A ring slot: the K box, the V box and, when Q and dO stream, their
  // boxes of the CTA's rows.
  static constexpr int kSlot = 2 * kKeyBox + (kResident ? 0 : 2 * kBox);
  // D's boxes of Q and dO held at most; streamed, D is not bounded here.
  static constexpr int kMaxBoxes = 512 / 64;
  // Barriers in the first 512 bytes (qo_full; full and empty per ring
  // slot), delta of the CTA's 64 rows (f32) in the next 512.
  static constexpr int kDelta = 512;
  static constexpr int kX = 1024;                       // exchange, 2 tiles
  static constexpr int kRing = kX + 2 * kDqXFloats * 4;
  static constexpr int kQO = kRing + kDqStages * kSlot;  // resident Q, dO
  static constexpr int alloc(int n_boxes) {
    return kQO + (kResident ? 2 * n_boxes * kBox : 0) + 1024;
  }
};
static_assert(DqLayout<true>::alloc(DqLayout<true>::kMaxBoxes) <=
                      kSmemLimit &&
                  DqLayout<false>::alloc(0) <= kSmemLimit,
              "over the 227 KB a block may use");
// The epilogue stages the CTA's dQ chunk (64 rows) in the ring, and a
// tile's chunk boxes stay in the ring for the products.
static_assert(kDqStages * DqLayout<true>::kSlot >= kDqChunkBoxes * kBox &&
                  kDqStages > kDqChunkBoxes,
              "the ring holds the CTA's dQ chunk and a tile's chunk boxes");

template <typename T, bool kResident>
__global__ void __launch_bounds__(kDqThreads, 1)
flash_bwd_dq_wide_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const __grid_constant__ CUtensorMap tm_o,
                               const __grid_constant__ CUtensorMap tm_dq,
                               const float* __restrict__ lse,
                               float* __restrict__ delta, int sq, int sk,
                               int d, float scale, int causal) {
  using L = DqLayout<kResident>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t qo_full = base;
  auto full = [&](int s) { return base + 8 * (1 + s); };
  auto empty = [&](int s) { return base + 8 * (1 + kDqStages + s); };
  float* delta_s = reinterpret_cast<float*>(smem + L::kDelta);
  float* xch = reinterpret_cast<float*>(smem + L::kX);
  const uint32_t ring = base + L::kRing;
  const uint32_t qo_s = base + L::kQO;  // Q's D / 64 boxes, then dO's

  const int n_boxes = (d + 63) / 64;
  const int bh = blockIdx.x;
  // Heaviest causal tiles first: blockIdx.y 0 takes the last query rows.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;
  const int c0 = blockIdx.z * kDqChunk;
  const int cb0 = c0 / 64;
  const int n_other = cb0 + max(0, n_boxes - cb0 - kDqChunkBoxes);
  const int n_items = n_other + kDqChunkBoxes;
  // Causal: key tiles past the CTA's last row are fully masked.
  int n_kt = (sk + kDqKeys - 1) / kDqKeys;
  if (causal) n_kt = min(n_kt, (min(q0 + kDqRows, sq) - 1) / kDqKeys + 1);

  if (threadIdx.x == 0) {
    mbar_init(qo_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kDqConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kDqConsumerThreads) {
    // Producer warp: one thread starts every copy. First D's boxes of O
    // (with dO's when it streams) for delta, then per key tile D's K and V
    // boxes; each in the order of item_box, those of the chunk last.
    if (threadIdx.x == kDqConsumerThreads) {
      if (kResident) {
        mbar_arrive_expect_tx(qo_full, 2 * n_boxes * kBox);
        for (int c = 0; c < n_boxes; ++c) {
          tma_load_3d(qo_s + c * kBox, &tm_q, qo_full, 64 * c, q0, bh);
          tma_load_3d(qo_s + (n_boxes + c) * kBox, &tm_do, qo_full, 64 * c,
                      q0, bh);
        }
      }
      int n = 0;  // ring uses
      for (int j = 0; j < n_items; ++j, ++n) {
        const int s = slot_of<kDqStages>(n);
        const int c = item_box<kDqChunkBoxes>(j, n_other, cb0);
        const uint32_t slot = ring + s * L::kSlot;
        mbar_wait(empty(s), parity_of<kDqStages>(n) ^ 1);
        mbar_arrive_expect_tx(full(s), (kResident ? 1 : 2) * kBox);
        tma_load_3d(slot, &tm_o, full(s), 64 * c, q0, bh);
        if (!kResident) {
          tma_load_3d(slot + 2 * kKeyBox + kBox, &tm_do, full(s), 64 * c,
                      q0, bh);
        }
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int k0 = kt * kDqKeys;
        for (int j = 0; j < n_items; ++j, ++n) {
          const int s = slot_of<kDqStages>(n);
          const int c = item_box<kDqChunkBoxes>(j, n_other, cb0);
          const uint32_t slot = ring + s * L::kSlot;
          mbar_wait(empty(s), parity_of<kDqStages>(n) ^ 1);
          mbar_arrive_expect_tx(full(s), L::kSlot);
          tma_load_3d(slot, &tm_k, full(s), 64 * c, k0, bh);
          tma_load_3d(slot + kKeyBox, &tm_v, full(s), 64 * c, k0, bh);
          if (!kResident) {
            tma_load_3d(slot + 2 * kKeyBox, &tm_q, full(s), 64 * c, q0, bh);
            tma_load_3d(slot + 2 * kKeyBox + kBox, &tm_do, full(s), 64 * c,
                        q0, bh);
          }
        }
      }
    }
    return;
  }

  // Consumer warpgroups: the CTA's 64 rows each; the first reduces S (Q
  // and K), the second dP (dO and V); each owns kDqWgBoxes boxes of the
  // chunk's dQ.
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int r_local = (tid / 32) * 16 + lane / 4;  // row in the CTA
  const int row0 = q0 + r_local;                   // and row0 + 8
  const int col_lane = 2 * (lane % 4);
  const float scale_log2 = scale * kLog2e;

  float acc[kDqKeys / 2];  // S then P (group 0), dP (group 1)
#pragma unroll
  for (int i = 0; i < kDqKeys / 2; ++i) acc[i] = 0.f;
  if (kResident) mbar_wait(qo_full, 0);

  // delta = rowsum(dO * O) of the CTA's rows, summed as dP is: dO O^T over
  // D's boxes in the key tiles' order, both groups at once (group wg takes
  // O's rows 32 * wg on as its 32 "keys"), and read off the diagonal. So
  // where O's row is a row of V (a causal first row, whose P is one key),
  // dP - delta is exactly 0 there, as the reference's is. O is read once;
  // the CTAs of chunk 0 write delta for the dK/dV kernel.
  int n = 0;  // ring uses, as the producer counts them
  {
    wgmma_fence();
    fence_regs(acc);
    int pending = -1;
    for (int j = 0; j < n_items; ++j, ++n) {
      const int s = slot_of<kDqStages>(n);
      const int c = item_box<kDqChunkBoxes>(j, n_other, cb0);
      const uint32_t slot = ring + s * L::kSlot;
      mbar_wait(full(s), parity_of<kDqStages>(n));
      if (c < n_boxes) {
        const uint32_t a = kResident ? qo_s + (n_boxes + c) * kBox
                                     : slot + 2 * kKeyBox + kBox;
        const uint32_t bt = slot + wg * kKeyBox;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss<T, kDqKeys>(acc, sw128_desc(a + kk * 32, 16, 1024),
                               sw128_desc(bt + kk * 32, 16, 1024),
                               j > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      if (pending >= 0) release_slot(empty(pending), lane);
      pending = s;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    release_slot(empty(pending), lane);
#pragma unroll
    for (int i = 0; i < kDqKeys / 2; ++i) {
      const int r = r_local + 8 * ((i / 2) % 2);
      if (r == kDqKeys * wg + 8 * (i / 4) + col_lane + (i % 2)) {
        delta_s[r] = acc[i];
      }
    }
  }
  named_barrier_sync(3, kDqConsumerThreads);
  float dlt[2], lse2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    dlt[h] = delta_s[r_local + 8 * h];
    lse2[h] = row < sq ? lse[(size_t)bh * sq + row] * kLog2e : 0.f;
    if (blockIdx.z == 0 && wg == 0 && lane % 4 == 0 && row < sq) {
      delta[(size_t)bh * sq + row] = dlt[h];
    }
  }

  float dq[kDqWgBoxes][32];
#pragma unroll
  for (int h = 0; h < kDqWgBoxes; ++h) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[h][i] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kDqKeys;

    // The reduction over D's boxes, 16 columns per wgmma: group 0 S = Q
    // K^T, group 1 dP = dO V^T, A the CTA's rows and B the tile's keys,
    // both K-major. The slot of a box outside the chunk is released once
    // the next box's products are issued and its own have completed; the
    // chunk's slots stay for the products.
    wgmma_fence();
    fence_regs(acc);
    int pending = -1;
    const int n_chunk0 = n + n_other;  // ring use of the chunk's first box
    for (int j = 0; j < n_items; ++j, ++n) {
      const int s = slot_of<kDqStages>(n);
      const int c = item_box<kDqChunkBoxes>(j, n_other, cb0);
      const uint32_t slot = ring + s * L::kSlot;
      mbar_wait(full(s), parity_of<kDqStages>(n));
      if (c < n_boxes) {
        const uint32_t a = kResident ? qo_s + (wg * n_boxes + c) * kBox
                                     : slot + 2 * kKeyBox + wg * kBox;
        const uint32_t bt = slot + wg * kKeyBox;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss<T, kDqKeys>(acc, sw128_desc(a + kk * 32, 16, 1024),
                               sw128_desc(bt + kk * 32, 16, 1024),
                               j > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      if (pending >= 0) release_slot(empty(pending), lane);
      pending = j < n_other ? s : -1;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (pending >= 0) release_slot(empty(pending), lane);

    // Group 0: P = exp(scale * S - LSE[row]); keys past Sk, and keys above
    // the diagonal, get 0 (only tiles that reach past the CTA's first row
    // or past Sk can hold them).
    if (wg == 0) {
      const bool edge = (causal && k0 + kDqKeys - 1 > q0) || k0 + kDqKeys > sk;
#pragma unroll
      for (int i = 0; i < kDqKeys / 2; ++i) {
        const int h = (i / 2) % 2;
        const int key = k0 + 8 * (i / 4) + col_lane + (i % 2);
        const float p = fast_exp2(fmaf(acc[i], scale_log2, -lse2[h]));
        acc[i] = edge && (key >= sk || (causal && key > row0 + 8 * h)) ? 0.f
                                                                       : p;
      }
    }
    // Exchange: group 0 gives P, group 1 dP; a thread of one group holds
    // the same elements as the same thread of the other.
    float* x = xch + (kt & 1) * kDqXFloats;
    float* mine = x + wg * (kDqXFloats / 2);
    const float* theirs = x + (1 - wg) * (kDqXFloats / 2);
#pragma unroll
    for (int i = 0; i < kDqKeys / 2; ++i) mine[i * 128 + tid] = acc[i];
    named_barrier_sync(3, kDqConsumerThreads);

    // T(dS) = T(P * (dP - delta[row])) as A fragments (pair i lies in row
    // row0 + 8 * (i % 2)).
    uint32_t ds[kDqKeys / 4];
#pragma unroll
    for (int i = 0; i < kDqKeys / 4; ++i) {
      float p0, p1, dp0, dp1;
      if (wg == 0) {
        p0 = acc[2 * i];
        p1 = acc[2 * i + 1];
        dp0 = theirs[(2 * i) * 128 + tid];
        dp1 = theirs[(2 * i + 1) * 128 + tid];
      } else {
        p0 = theirs[(2 * i) * 128 + tid];
        p1 = theirs[(2 * i + 1) * 128 + tid];
        dp0 = acc[2 * i];
        dp1 = acc[2 * i + 1];
      }
      const float dl = dlt[i % 2];
      ds[i] = pack2<T>(p0 * (dp0 - dl), p1 * (dp1 - dl));
    }

    // dQ += dS K over this group's boxes of the chunk, with K MN-major in
    // the chunk's slots.
    wgmma_fence();
    fence_regs(ds);
#pragma unroll
    for (int h = 0; h < kDqWgBoxes; ++h) {
      fence_regs(dq[h]);
      const uint32_t kbox =
          ring + slot_of<kDqStages>(n_chunk0 + kDqWgBoxes * wg + h) * L::kSlot;
#pragma unroll
      for (int t = 0; t < kDqKeys / 16; ++t) {
        const uint32_t a[4] = {ds[4 * t], ds[4 * t + 1], ds[4 * t + 2],
                               ds[4 * t + 3]};
        wgmma_rs<T, 64>(dq[h], a,
                        sw128_desc(kbox + t * 16 * 128, kKeyBox, 1024));
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(ds);
#pragma unroll
    for (int h = 0; h < kDqWgBoxes; ++h) fence_regs(dq[h]);
    for (int t = 0; t < kDqChunkBoxes; ++t) {
      release_slot(empty(slot_of<kDqStages>(n_chunk0 + t)), lane);
    }
  }

  // Epilogue: stage scale * dQ in the ring (every slot consumed by both
  // groups first) and store it with TMA; the store clips rows past Sq.
  named_barrier_sync(3, kDqConsumerThreads);
  const float mul[2] = {scale, scale};
#pragma unroll
  for (int h = 0; h < kDqWgBoxes; ++h) {
    const int box = kDqWgBoxes * wg + h;
    stage_acc<T, 64>(smem + L::kRing + box * kBox, kBox, 0, r_local,
                     col_lane, dq[h], mul);
  }
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (tid == 0) {
    for (int h = 0; h < kDqWgBoxes; ++h) {
      const int box = kDqWgBoxes * wg + h;
      if (c0 + 64 * box >= d) break;
      tma_store_3d(&tm_dq, ring + box * kBox, c0 + 64 * box, q0, bh);
    }
    tma_store_commit_and_wait();
  }
}

// ---- host -----------------------------------------------------------------

template <typename T, bool kResident>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, void* work, int batch, int hq, int hkv, int sq,
               int sk, int d, float scale, int causal, cudaStream_t stream) {
  if (!kResident) {
    // The streamed boxes arrive as they are: the pre-pass writes q * scale
    // rounded to T into work once, and the boxes stream from there.
    const size_t n = (size_t)batch * hq * sq * d / 8;
    const int blocks = (int)std::min<size_t>((n + 255) / 256, 132 * 16);
    wide_q_scale_kernel<T><<<blocks, 256, 0, stream>>>(
        static_cast<const uint4*>(q), static_cast<uint4*>(work), n, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    q = work;
  }
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  CUresult res = encode_3d<T>(&tm_q, q, batch * hq, sq, d, kFwdRows);
  if (res == CUDA_SUCCESS)
    res = encode_3d<T>(&tm_k, k, batch * hkv, sk, d, kFwdKeys);
  if (res == CUDA_SUCCESS)
    res = encode_3d<T>(&tm_v, v, batch * hkv, sk, d, kFwdKeys);
  if (res == CUDA_SUCCESS) res = encode_3d<T>(&tm_o, o, batch * hq, sq, d, 64);
  if (res != CUDA_SUCCESS) return -(int)res;

  auto kernel = flash_fwd_wide_wgmma_kernel<T, kResident>;
  const int smem = FwdLayout<kResident>::alloc((d + 63) / 64);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch * hq, (sq + kFwdRows - 1) / kFwdRows,
            (d + kChunk - 1) / kChunk);
  kernel<<<grid, kFwdThreads, smem, stream>>>(tm_q, tm_k, tm_v, tm_o,
                                              static_cast<float*>(lse), hq,
                                              hkv, sq, sk, d, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, void* work, int batch, int hq, int hkv, int sq,
                 int sk, int d, float scale, int causal, cudaStream_t s) {
  if (d <= kFwdResidentMaxD)
    return launch_fwd<T, true>(q, k, v, o, lse, work, batch, hq, hkv, sq, sk,
                               d, scale, causal, s);
  return launch_fwd<T, false>(q, k, v, o, lse, work, batch, hq, hkv, sq, sk,
                              d, scale, causal, s);
}

template <typename T, bool kResident>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int bh,
               int sq, int sk, int d, float scale, int causal,
               cudaStream_t stream) {
  using L = DkvLayout<kResident>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv;
  CUresult res = encode_3d<T>(&tm_q, q, bh, sq, d, kDkvRows);
  if (res == CUDA_SUCCESS) res = encode_3d<T>(&tm_k, k, bh, sk, d, kDkvKeys);
  if (res == CUDA_SUCCESS) res = encode_3d<T>(&tm_v, v, bh, sk, d, kDkvKeys);
  if (res == CUDA_SUCCESS)
    res = encode_3d<T>(&tm_do, dout, bh, sq, d, kDkvRows);
  if (res == CUDA_SUCCESS) res = encode_3d<T>(&tm_dk, dk, bh, sk, d, 64);
  if (res == CUDA_SUCCESS) res = encode_3d<T>(&tm_dv, dv, bh, sk, d, 64);
  if (res != CUDA_SUCCESS) return -(int)res;

  auto kernel = flash_bwd_dkv_wide_wgmma_kernel<T, kResident>;
  const int smem = L::alloc((d + 63) / 64);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (sk + kDkvKeys - 1) / kDkvKeys,
            (d + kDkvChunk - 1) / kDkvChunk);
  kernel<<<grid, kDkvThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), sq, sk, d, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int bh, int sq, int sk, int d,
                 float scale, int causal, cudaStream_t s) {
  if (d <= DkvLayout<true>::kMaxBoxes * 64)
    return launch_dkv<T, true>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                               d, scale, causal, s);
  return launch_dkv<T, false>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                              d, scale, causal, s);
}

template <typename T, bool kResident>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* dq, void* delta,
              int bh, int sq, int sk, int d, float scale, int causal,
              cudaStream_t stream) {
  using L = DqLayout<kResident>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_o, tm_dq;
  CUresult res = encode_3d<T>(&tm_q, q, bh, sq, d, kDqRows);
  if (res == CUDA_SUCCESS) res = encode_3d<T>(&tm_k, k, bh, sk, d, kDqKeys);
  if (res == CUDA_SUCCESS) res = encode_3d<T>(&tm_v, v, bh, sk, d, kDqKeys);
  if (res == CUDA_SUCCESS)
    res = encode_3d<T>(&tm_do, dout, bh, sq, d, kDqRows);
  if (res == CUDA_SUCCESS) res = encode_3d<T>(&tm_o, o, bh, sq, d, kDqRows);
  if (res == CUDA_SUCCESS) res = encode_3d<T>(&tm_dq, dq, bh, sq, d, 64);
  if (res != CUDA_SUCCESS) return -(int)res;

  auto kernel = flash_bwd_dq_wide_wgmma_kernel<T, kResident>;
  const int smem = L::alloc((d + 63) / 64);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh, (sq + kDqRows - 1) / kDqRows,
            (d + kDqChunk - 1) / kDqChunk);
  kernel<<<grid, kDqThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_o, tm_dq, static_cast<const float*>(lse),
      static_cast<float*>(delta), sq, sk, d, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dq(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* dq, void* delta,
                int bh, int sq, int sk, int d, float scale, int causal,
                cudaStream_t s) {
  if (d <= DqLayout<true>::kMaxBoxes * 64)
    return launch_dq<T, true>(q, k, v, o, dout, lse, dq, delta, bh, sq, sk,
                              d, scale, causal, s);
  return launch_dq<T, false>(q, k, v, o, dout, lse, dq, delta, bh, sq, sk, d,
                             scale, causal, s);
}

bool bad_dims(int d, int dtype) {
  return d <= 256 || d % 8 != 0 || (dtype != 1 && dtype != 2);
}

}  // namespace

// q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], o [B, Hq, Sq, D], all contiguous,
// of one type (dtype 1: bf16, 2: f16) with 16-byte aligned bases; lse
// [B, Hq, Sq] f32; work a buffer shaped and typed like q, 16-byte aligned,
// which the kernel fills with q * scale rounded to T where Q streams (D
// above 1024; below, it is not touched and may be null); D a multiple of 8
// above 256. Returns 0, a cudaError_t, or minus a CUresult when a tensor
// map cannot be encoded.
extern "C" int flash_attention_fwd_wide_wgmma(const void* q, const void* k,
                                              const void* v, void* o,
                                              void* lse, void* work,
                                              int batch, int hq, int hkv,
                                              int sq, int sk, int d,
                                              float scale, int causal,
                                              int dtype, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1 ||
      bad_dims(d, dtype) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
       (uintptr_t)work) % 16 ||
      (d > kFwdResidentMaxD && work == nullptr) || (sq + 63) / 64 > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 2
             ? dispatch_fwd<__half>(q, k, v, o, lse, work, batch, hq, hkv, sq,
                                    sk, d, scale, causal, s)
             : dispatch_fwd<__nv_bfloat16>(q, k, v, o, lse, work, batch, hq,
                                           hkv, sq, sk, d, scale, causal, s);
}

// q, o, dout, dq [B*H, Sq, D]; k, v [B*H, Sk, D]: contiguous, of one type
// (dtype 1: bf16, 2: f16), with 16-byte aligned bases; lse [B*H, Sq] f32 as
// the forward writes it; delta [B*H, Sq] f32, written with rowsum(dO * O)
// for the dK/dV kernel (not null); D a multiple of 8 above 256 (Q and dO
// held in shared memory up to 512, streamed above). The arguments of
// flash_attention_bwd_dq_wide.
extern "C" int flash_attention_bwd_dq_wide_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* delta, int bh, int sq,
    int sk, int d, float scale, int causal, int dtype, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || bad_dims(d, dtype) || lse == nullptr ||
      delta == nullptr ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
       (uintptr_t)dout | (uintptr_t)dq) % 16 ||
      (sq + kDqRows - 1) / kDqRows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 2 ? dispatch_dq<__half>(q, k, v, o, dout, lse, dq, delta,
                                          bh, sq, sk, d, scale, causal, s)
                    : dispatch_dq<__nv_bfloat16>(q, k, v, o, dout, lse, dq,
                                                 delta, bh, sq, sk, d, scale,
                                                 causal, s);
}

// q, dout [B*H, Sq, D]; k, v, dk, dv [B*H, Sk, D]: contiguous, of one type
// (dtype 1: bf16, 2: f16), with 16-byte aligned bases; lse [B*H, Sq] f32 as
// the forward writes it; delta [B*H, Sq] f32 = rowsum(dO * O), as the wide
// dQ kernel writes it; D a multiple of 8 above 256 (K and V held in shared
// memory up to 512, streamed above).
extern "C" int flash_attention_bwd_dkv_wide_wgmma(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
    int sk, int d, float scale, int causal, int dtype, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || bad_dims(d, dtype) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
       (uintptr_t)dk | (uintptr_t)dv) % 16 ||
      (sk + kDkvKeys - 1) / kDkvKeys > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 2 ? dispatch_dkv<__half>(q, k, v, dout, lse, delta, dk, dv,
                                           bh, sq, sk, d, scale, causal, s)
                    : dispatch_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta,
                                                  dk, dv, bh, sq, sk, d,
                                                  scale, causal, s);
}
