// Flash-attention forward on Hopper's tensor cores (sm_90a): TMA-fed tiles,
// wgmma products, one producer warp and two consumer warpgroups. bf16 or f16
// inputs with head_dim any multiple of 8 up to 256, run by the instance of
// width kD = 64, 128 or 256 that holds it (below); f32 and head dims above
// 256 keep the CUDA-core kernels (flash_attention_fwd.cu,
// flash_attention_wide.cu) by the wrapper's rule of shapes.
//
// Replaces the Pallas TPU kernel `_attn_kernel` of
// ray_tpu/ops/flash_attention.py as launched by `_flash_forward` (MHA) and
// `_flash_forward_grouped` (GQA, K/V kept at n_kv_heads width), and
// computes what it computes: O = softmax(T(scale * Q) K^T [causal-masked]) V
// with an online softmax in f32, LSE = m + log(l) of the scaled scores as
// [B, Hq, Sq] f32 (the backward kernels read it). Masking is finite
// (-1e30) and l is clamped at 1e-30, as in the reference.
//
// What bounds it on the H100. Per (batch, query head) it reads Q, K, V
// once and writes O and LSE once; the work is 4 * Sq * Sk * D operations
// (about half of it when causal). At B=4, H=8, S=2048, causal, that is ~17
// GFLOP at D=64 and ~69 GFLOP at D=256 against 8.5 / 34 MB moved, so the
// bound is operations (0.017 / 0.070 ms at 989 TFLOP/s); at the serving
// shape S=512, D=64 it is bytes (0.0025 ms at 3.35 TB/s), and 128 CTAs on
// 132 SMs leave the card one wave deep. What the design does about it:
// - Both products run on wgmma (the only path to the tensor-core rate):
//   S = Q K^T with Q and K read from shared memory (K-major, as K is
//   stored), O += P V as m64nDk16 with P in registers and V read MN-major
//   from shared memory (no transpose pass).
// - One producer warp starts TMA copies: Q once, then K and V tiles of
//   kBlockN keys through a ring of kStages slots, each with a full and an
//   empty mbarrier, so loads run ahead of the products. Causal tiles past
//   the diagonal are never loaded, and a warpgroup skips a loaded tile
//   that lies wholly above its rows.
// - Registers: each consumer thread holds O (D/2 f32), S (kBlockN/2 f32)
//   and P (kBlockN/4 pairs), under ptxas's launch cap of 168 registers a
//   thread: the block's nine warps (two consumer warpgroups, one producer
//   warp: 288 threads) put three warps on one of the SM's four register
//   file quarters (16384 / 96), and setmaxnreg does not raise what ptxas
//   allocates (a 384-thread build with setmaxnreg 24 / 240 compiles to the
//   same 168 and spills 320 bytes at D=256). One producer warp rather than
//   a warpgroup keeps the forward within a few percent of that layout and
//   makes the dK/dV kernel faster (flash_attention_bwd_wgmma.cu). At
//   D=256, O alone is 128 f32: with 64-key tiles ptxas spills 308 bytes a
//   thread; 32-key tiles spill 68 and measured 3-6% slower on the H100 (an
//   S product at N=32 reads more shared memory per operation), and
//   128-key tiles do not fit shared memory. flash_ab.py rebuilds and times
//   these variants.
// - Shared memory: Q (128 x D) plus kStages = 2 K and V tiles: 16 + 64 KB
//   at D=64 and 32 + 128 KB at D=128 (128-key tiles), 64 + 128 KB at D=256
//   (64-key tiles); 128-key tiles at D=256 would need 64 + 256 KB, over the
//   227 KB a block may use.
// - 3-D tensor maps over [B*H, S, D] with 128-byte swizzle: each 64-column
//   block of a row is one 128-byte swizzle row; a ragged tile is
//   zero-filled by the hardware and never reads the next head's rows;
//   zero-filled keys score 0 and are masked to -1e30.
// - Each CTA owns 128 query rows of one (b, h), 64 per consumer warpgroup;
//   the grid schedules the heaviest causal tiles (the last rows) first, so
//   the last wave is not one long tile.
// - The epilogue stages O (in T) in the warpgroup's Q rows in shared
//   memory and a TMA store writes it, clipping rows past Sq and columns
//   past D.
// - Head dims between the instances: a head_dim D (a multiple of 8) runs
//   the instance of the next width kD up. The tensor maps describe the
//   real D (a row stride of 2 D bytes, 16-byte aligned), so TMA fills
//   every column past D with zeros, a 64-column box that lies partly or
//   wholly past D included, and still counts the box's full bytes toward
//   the mbarrier. Zero columns add nothing to Q K^T or P V, and the store
//   clips O at D. The work is kD's: padding shows as distance from the
//   bound.
// Rounding points are the reference's: Q * scale rounded to T (the scale
// rounded to T first, as JAX's weak typing casts the Python float) in
// shared memory before the first product, scores in f32, p rounded to T
// before P.V while l sums the unrounded p, one cast of O. Where the scale
// is a power of two (D = 64, 256) the rounding is exact and the results
// are those of scaling the f32 scores, bit for bit.
//
// Launches on the caller's stream and allocates nothing.

#include "hopper_tma_wgmma.cuh"

namespace {

using namespace hopper;

constexpr int kBlockM = 128;     // query rows per CTA (2 consumer warpgroups)
constexpr int kStages = 2;       // K/V ring depth
constexpr int kConsumerThreads = 256;
constexpr int kThreads = kConsumerThreads + 32;  // + producer warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int kD>
struct Layout {
  static constexpr int kBlockN = kD == 256 ? 64 : 128;  // keys per K/V tile
  static constexpr int kColBlocks = kD / 64;  // 128-byte column blocks
  static constexpr int kQBytes = kBlockM * kD * 2;
  static constexpr int kKVBytes = kBlockN * kD * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  // q_full, then k_full, v_full, k_empty, v_empty for each stage.
  static constexpr int kBytes = kBars + (1 + 4 * kStages) * 8;
  // Dynamic shared memory is only 16-byte aligned: ask for a swizzle atom
  // more and round the base up to 1024 bytes.
  static constexpr int kAlloc = kBytes + 1024;
  static_assert(kAlloc <= 232448, "over the 227 KB a block may use");
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The accumulator's register layout (hopper_tma_wgmma.cuh) makes P, packed
// to pairs of T, the A operand of P.V with no shuffle: its k-step t is the
// pairs of values 8t..8t+7.
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_o,
                       float* __restrict__ lse, int hq, int hkv, int sq,
                       int sk, int d, float scale, int causal) {
  using L = Layout<kD>;
  constexpr int kBlockN = L::kBlockN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t q_s = base + L::kQ;
  const uint32_t k_s = base + L::kK;
  const uint32_t v_s = base + L::kV;
  const uint32_t q_full = base + L::kBars;
  auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return q_full + 8 * (1 + 3 * kStages + s); };

  const int bh = blockIdx.x;  // b * hq + h
  const int b = bh / hq;
  const int kv_bh = b * hkv + (bh - b * hq) / (hq / hkv);
  // Heaviest causal tiles first: blockIdx.y 0 takes the last query rows.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockM;
  int n_kb = (sk + kBlockN - 1) / kBlockN;
  if (causal) n_kb = min(n_kb, (min(q0 + kBlockM, sq) - 1) / kBlockN + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerThreads);
      mbar_init(v_empty(s), kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumerThreads) {
    // Producer warp: one thread starts every copy.
    if (threadIdx.x == kConsumerThreads) {
      mbar_arrive_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < L::kColBlocks; ++c) {
        tma_load_3d(q_s + c * kBlockM * 128, &tm_q, q_full, 64 * c, q0, bh);
      }
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % kStages;
        const uint32_t free_parity = ((kb / kStages) & 1) ^ 1;
        mbar_wait(k_empty(s), free_parity);
        mbar_arrive_expect_tx(k_full(s), L::kKVBytes);
        for (int c = 0; c < L::kColBlocks; ++c) {
          tma_load_3d(k_s + s * L::kKVBytes + c * kBlockN * 128, &tm_k,
                      k_full(s), 64 * c, kb * kBlockN, kv_bh);
        }
        mbar_wait(v_empty(s), free_parity);
        mbar_arrive_expect_tx(v_full(s), L::kKVBytes);
        for (int c = 0; c < L::kColBlocks; ++c) {
          tma_load_3d(v_s + s * L::kKVBytes + c * kBlockN * 128, &tm_v,
                      v_full(s), 64 * c, kb * kBlockN, kv_bh);
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
  const int wg_row0 = q0 + wg * 64;                // first row of the group
  const int row0 = wg_row0 + r_local;              // and row0 + 8
  const int col_lane = 2 * (lane % 4);
  const uint32_t q_wg = q_s + wg * 64 * 128;

  float o[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of raw scores per row
  float l[2] = {0.f, 0.f};          // this thread's share of the row sum
  float sc[kBlockN / 2];            // scores, then p, of one K/V tile
#pragma unroll
  for (int i = 0; i < kBlockN / 2; ++i) sc[i] = 0.f;

  mbar_wait(q_full, 0);
  // This warpgroup's 64 Q rows times the scale rounded to T, rounded to T
  // in place (elementwise, so the swizzle does not matter); then the async
  // proxy (wgmma) may read them.
  {
    const float scale_t = round_to<T>(scale);
#pragma unroll
    for (int c = 0; c < L::kColBlocks; ++c) {
      uint4* rows = reinterpret_cast<uint4*>(
          smem + L::kQ + c * kBlockM * 128 + wg * 64 * 128);
#pragma unroll
      for (int i = tid; i < 64 * 8; i += 128) {
        rows[i] = scale4<T>(rows[i], scale_t);
      }
    }
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);
  }
  for (int kb = 0; kb < n_kb; ++kb) {
    const int s = kb % kStages;
    const uint32_t full_parity = (kb / kStages) & 1;
    const uint32_t k_tile = k_s + s * L::kKVBytes;
    const uint32_t v_tile = v_s + s * L::kKVBytes;
    const int k0 = kb * kBlockN;

    mbar_wait(k_full(s), full_parity);
    // Causal, 64-key tiles: the CTA's last tile lies wholly above the first
    // group's rows. Its slot is released only after its data arrived, so
    // the arrival counts toward this use of the slot, not the one before.
    if (kBlockN < kBlockM && causal && k0 > wg_row0 + 63) {
      mbar_arrive(k_empty(s));
      mbar_wait(v_full(s), full_parity);
      mbar_arrive(v_empty(s));
      continue;
    }

    // S = Q K^T over the head dimension, 16 columns per wgmma.
    wgmma_fence();
    fence_regs(sc);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t off = (kk / 4) * (kBlockM * 128) + (kk % 4) * 32;
      const uint32_t koff = (kk / 4) * (kBlockN * 128) + (kk % 4) * 32;
      wgmma_ss<T, kBlockN>(sc, sw128_desc(q_wg + off, 16, 1024),
                           sw128_desc(k_tile + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(k_empty(s));

    // Only a tile that ends past Sk, or reaches past this group's first
    // row, can hold keys past Sk or past the causal diagonal: with 128-key
    // tiles that is the last one (the test as written measured ~7% faster
    // at D=64 than the general one on the H100).
    const bool edge =
        kBlockN == kBlockM
            ? kb == n_kb - 1 && (causal || sk % kBlockN != 0)
            : (causal && k0 + kBlockN - 1 > wg_row0) || k0 + kBlockN > sk;
    if (edge) {
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        const int key = k0 + 8 * (i / 4) + col_lane + (i % 2);
        const int row = row0 + 8 * ((i / 2) % 2);
        if (key >= sk || (causal && key > row)) sc[i] = kNegInf;
      }
    }

    // Online softmax in f32: new row maxima, rescale factors, p.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) {
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
    for (int i = 0; i < kBlockN / 2; ++i) {
      const int h = (i / 2) % 2;
      sc[i] = fast_exp2(fmaf(sc[i], kLog2e, neg[h]));
      sum[h] += sc[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] *= alpha[(i / 2) % 2];

    // P rounded to T (the reference's rounding point) as A fragments.
    uint32_t p[kBlockN / 4];
#pragma unroll
    for (int i = 0; i < kBlockN / 4; ++i) {
      p[i] = pack2<T>(sc[2 * i], sc[2 * i + 1]);
    }

    // O += P V, 16 keys per wgmma; V is MN-major (head dim contiguous).
    mbar_wait(v_full(s), full_parity);
    wgmma_fence();
    fence_regs(o);
    fence_regs(p);
#pragma unroll
    for (int t = 0; t < kBlockN / 16; ++t) {
      const uint32_t a[4] = {p[4 * t], p[4 * t + 1], p[4 * t + 2],
                             p[4 * t + 3]};
      wgmma_rs<T, kD>(
          o, a, sw128_desc(v_tile + t * 16 * 128, kBlockN * 128, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(p);
    mbar_arrive(v_empty(s));
  }

  // Epilogue: O = acc / l, LSE = m + log(l).
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lt = fmaxf(quad_sum(l[h]), 1e-30f);
    inv[h] = 1.f / lt;
    const int row = row0 + 8 * h;
    if (lane % 4 == 0 && row < sq) {
      lse[(size_t)bh * sq + row] = m[h] + logf(lt);
    }
  }
  // Stage O in this warpgroup's Q rows (its last wgmma reading them has
  // completed), in the swizzle the TMA store reads.
  stage_acc<T, kD>(smem + L::kQ, kBlockM * 128, wg * 64, r_local, col_lane,
                   o, inv);
  fence_proxy_async();
  named_barrier_sync(1 + wg, 128);
  if (tid == 0 && wg_row0 < sq) {
    for (int c = 0; c < L::kColBlocks && 64 * c < d; ++c) {
      tma_store_3d(&tm_o, q_wg + c * kBlockM * 128, 64 * c, wg_row0, bh);
    }
    tma_store_commit_and_wait();
  }
}

// Tensor maps over the real head_dim d (<= kD): TMA zero-fills the columns
// of the kD-wide tiles past d and the store clips O there.
template <typename T, int kD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int batch, int hq, int hkv, int sq, int sk, int d, float scale,
           int causal, cudaStream_t stream) {
  using L = Layout<kD>;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  CUresult res = encode_3d<T>(&tm_q, q, batch * hq, sq, d, kBlockM);
  if (res == CUDA_SUCCESS)
    res = encode_3d<T>(&tm_k, k, batch * hkv, sk, d, L::kBlockN);
  if (res == CUDA_SUCCESS)
    res = encode_3d<T>(&tm_v, v, batch * hkv, sk, d, L::kBlockN);
  if (res == CUDA_SUCCESS)
    res = encode_3d<T>(&tm_o, o, batch * hq, sq, d, 64);
  if (res != CUDA_SUCCESS) return -(int)res;

  auto kernel = flash_fwd_wgmma_kernel<T, kD>;
  const int smem = L::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch * hq, (sq + kBlockM - 1) / kBlockM);
  kernel<<<grid, kThreads, smem, stream>>>(tm_q, tm_k, tm_v, tm_o,
                                           static_cast<float*>(lse), hq, hkv,
                                           sq, sk, d, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, void* lse,
             int batch, int hq, int hkv, int sq, int sk, int d, float scale,
             int causal, cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d, scale,
                         causal, stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d, scale,
                          causal, stream);
  return launch<T, 256>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d, scale,
                        causal, stream);
}

}  // namespace

// q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], o [B, Hq, Sq, D], all contiguous,
// of one type (dtype 1: bf16, 2: f16) with 16-byte aligned bases; lse
// [B, Hq, Sq] f32; D a multiple of 8 up to 256. Returns 0, a cudaError_t,
// or minus a CUresult when a tensor map cannot be encoded.
extern "C" int flash_attention_fwd_wgmma(const void* q, const void* k,
                                         const void* v, void* o, void* lse,
                                         int batch, int hq, int hkv, int sq,
                                         int sk, int d, float scale,
                                         int causal, int dtype,
                                         void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 || sk < 1 ||
      d < 8 || d > 256 || d % 8 != 0 || (dtype != 1 && dtype != 2) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16 ||
      (sq + kBlockM - 1) / kBlockM > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 2
             ? launch_d<__half>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d,
                                scale, causal, s)
             : launch_d<__nv_bfloat16>(q, k, v, o, lse, batch, hq, hkv, sq,
                                       sk, d, scale, causal, s);
}
