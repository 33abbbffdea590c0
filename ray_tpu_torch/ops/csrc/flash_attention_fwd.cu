// Flash-attention forward for Hopper (sm_90a), one kernel for MHA and GQA.
//
// Replaces the Pallas TPU kernel `_attn_kernel` of
// ray_tpu/ops/flash_attention.py as launched by `_flash_forward` (MHA) and
// `_flash_forward_grouped` (GQA, K/V kept at n_kv_heads width). It computes
// the same thing: O = softmax(scale * Q K^T [causal-masked]) V with an
// online softmax in f32, and LSE = m + log(l) of the scaled scores. Masking
// is finite (-1e30) and l is clamped at 1e-30, so a fully masked row stays
// finite exactly as in the reference.
//
// What bounds it on the H100. Per (batch, query head) the kernel reads Q,
// K, V once from device memory and writes O and LSE once; the work is
// 4 * Sq * Sk * D operations (halved when causal). At the serving shapes
// (S = 2048, D = 64, bf16, causal) that is ~500 operations per byte moved,
// above the card's ~295 ops/byte ridge, so the work is bound by operations
// even on the tensor cores (989 TFLOP/s bf16). This first version does its
// dot products on the CUDA cores in f32 (67 TFLOP/s peak), about 15x below
// the tensor-core rate, and is limited in practice by its shared-memory
// reads (one float per FMA): moving Q.K^T and P.V onto wgmma with TMA-fed
// tiles is later work. The score matrix never leaves the SM, so bytes are
// read and written once.
//
// Design (not the TPU's blocks):
// - One CTA per (batch * query head, 64-row Q tile); the grid is fully
//   parallel. The TPU kernel keeps all of Sk x D per program in VMEM; here a
//   loop inside the CTA streams 64-row K/V tiles through shared memory
//   (converted to f32 once, on load), so shared memory stays at 2 * 64 * D
//   floats whatever the sequence length.
// - 4 threads own one query row, each a quarter of the head dimension: the
//   row's Q share and O accumulator live in registers, a dot product is a
//   partial sum plus two warp shuffles. The online softmax steps 16 keys at
//   a time, so scores need 16 registers, not 64, and two CTAs fit an SM.
// - The KV head is h / group, computed from blockIdx (replaces the BlockSpec
//   index map `(b // Hq) * Hkv + (b % Hq) // group`).
// - Causal K/V tiles past the diagonal are never loaded.
// - Ragged Sq / Sk are masked: rows past Sq are not stored, K/V rows past Sk
//   are zero-filled in shared memory and masked to -1e30.
// - LSE is written [B, Hq, Sq] (no TPU sublane broadcast).
// - As in the reference, p is rounded to the input type before P.V while l
//   sums the unrounded p. Q is scaled in f32 (the reference scales in the
//   input type), which is the one place bf16 results may differ.
//
// The kernel launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kSubK = 16;  // keys per online-softmax step
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockQ * kThreadsPerRow;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copies a kBlockK x d tile of T from device memory into shared memory as
// f32 (converted once here, not at every use), in 16-byte chunks, and
// zero-fills rows at or past rows_valid. d % 8 == 0 keeps every row a whole
// number of chunks for both bf16 and f32.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int rows_valid, int d) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks_per_row = d / kVec;
  const int total = kBlockK * chunks_per_row;
  for (int c = threadIdx.x; c < total; c += kThreads) {
    const int r = c / chunks_per_row;
    const int col = (c - r * chunks_per_row) * kVec;
    float* out = dst + r * d + col;
    if (r < rows_valid) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + (size_t)r * d + col);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = to_f(vals[e]);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = 0.f;
    }
  }
}

// Which head-dimension element a thread's i-th register holds. With the
// slice width known at compile time (kSlice > 0, a multiple of 4) the four
// threads of a row interleave 4-element chunks, so their float4 reads of a
// shared-memory row fall in distinct banks; otherwise each thread owns a
// contiguous run of ds elements.
template <int kSlice>
__device__ __forceinline__ int dim_of(int i, int slice, int ds) {
  if constexpr (kSlice > 0) {
    return (i / 4) * (4 * kThreadsPerRow) + slice * 4 + (i % 4);
  } else {
    return slice * ds + i;
  }
}

// Reads one thread's elements of a shared-memory row into registers.
template <int kSlice, int kMax>
__device__ __forceinline__ void read_slice(float (&dst)[kMax],
                                           const float* row, int slice,
                                           int ds) {
  if constexpr (kSlice > 0) {
#pragma unroll
    for (int i = 0; i < kSlice; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(
          row + dim_of<kSlice>(i, slice, ds));
      dst[i] = f.x;
      dst[i + 1] = f.y;
      dst[i + 2] = f.z;
      dst[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kMax; ++i) dst[i] = i < ds ? row[slice * ds + i] : 0.f;
  }
}

// kSlice: the per-thread share of the head dimension (D / 4) when known at
// compile time (a multiple of 4), else 0 and the runtime d / 4 (at most 32)
// is used.
template <typename T, int kSlice>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int hq, int hkv, int sq, int sk,
                 int d, float scale, int causal) {
  constexpr int kMax = kSlice > 0 ? kSlice : 32;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + kBlockK * d;

  const int bh = blockIdx.x;  // b * hq + h
  const int b = bh / hq;
  const int h = bh - b * hq;
  const int kv_row = b * hkv + h / (hq / hkv);
  const int q0 = blockIdx.y * kBlockQ;
  const int row = threadIdx.x / kThreadsPerRow;
  const int slice = threadIdx.x % kThreadsPerRow;
  const int ds = kSlice > 0 ? kSlice : d / kThreadsPerRow;
  const int qi = q0 + row;
  const bool row_valid = qi < sq;

  float qr[kMax];
  float acc[kMax];
  const T* qp = q + ((size_t)bh * sq + (row_valid ? qi : 0)) * d;
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    qr[i] = (i < ds && row_valid)
                ? to_f(qp[dim_of<kSlice>(i, slice, ds)]) * scale
                : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const T* kp = k + (size_t)kv_row * sk * d;
  const T* vp = v + (size_t)kv_row * sk * d;
  int n_kb = (sk + kBlockK - 1) / kBlockK;
  if (causal) {
    // Only K tiles up to the last query row of this tile contribute.
    const int last_q = min(q0 + kBlockQ, sq) - 1;
    n_kb = min(n_kb, last_q / kBlockK + 1);
  }

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBlockK;
    const int rows_valid = min(kBlockK, sk - k0);
    __syncthreads();  // every thread is done with the previous tile
    load_tile(ks, kp + (size_t)k0 * d, rows_valid, d);
    load_tile(vs, vp + (size_t)k0 * d, rows_valid, d);
    __syncthreads();

    for (int j0 = 0; j0 < kBlockK; j0 += kSubK) {
      float s[kSubK];
      float sub_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kSubK; ++j) {
        float kr[kMax];
        read_slice<kSlice, kMax>(kr, ks + (j0 + j) * d, slice, ds);
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kMax; ++i) part = fmaf(qr[i], kr[i], part);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        const int kj = k0 + j0 + j;
        const bool keep = kj < sk && (!causal || kj <= qi);
        s[j] = keep ? part : kNegInf;
        sub_max = fmaxf(sub_max, s[j]);
      }
      const float m_new = fmaxf(m, sub_max);
      const float alpha = __expf(m - m_new);
#pragma unroll
      for (int i = 0; i < kMax; ++i) acc[i] *= alpha;
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSubK; ++j) {
        const float p = __expf(s[j] - m_new);
        p_sum += p;
        const float p_rounded = to_f(from_f<T>(p));
        float vr[kMax];
        read_slice<kSlice, kMax>(vr, vs + (j0 + j) * d, slice, ds);
#pragma unroll
        for (int i = 0; i < kMax; ++i) acc[i] = fmaf(p_rounded, vr[i], acc[i]);
      }
      l = l * alpha + p_sum;
      m = m_new;
    }
  }

  if (row_valid) {
    const float l_safe = fmaxf(l, 1e-30f);
    const float inv_l = 1.f / l_safe;
    T* op = o + ((size_t)bh * sq + qi) * d;
#pragma unroll
    for (int i = 0; i < kMax; ++i) {
      if (i < ds) op[dim_of<kSlice>(i, slice, ds)] = from_f<T>(acc[i] * inv_l);
    }
    if (slice == 0) lse[(size_t)bh * sq + qi] = m + logf(l_safe);
  }
}

template <typename T, int kSlice>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int hq, int hkv, int sq, int sk,
                   int d, float scale, int causal, cudaStream_t stream) {
  const int smem = 2 * kBlockK * d * (int)sizeof(float);
  auto kernel = flash_fwd_kernel<T, kSlice>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(batch * hq, (sq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), hq, hkv, sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int batch, int hq, int hkv, int sq, int sk,
                     int d, float scale, int causal, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 16>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d, scale,
                           causal, stream);
    case 128:
      return launch<T, 32>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d, scale,
                           causal, stream);
    default:
      return launch<T, 0>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d, scale,
                          causal, stream);
  }
}

}  // namespace

// q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], o [B, Hq, Sq, D] (all contiguous,
// 16-byte aligned, one dtype), lse [B, Hq, Sq] f32.
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int batch, int hq, int hkv, int sq,
                                   int sk, int d, float scale, int causal,
                                   int dtype, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 || sq < 1 ||
      sk < 1 || d < 8 || d > 128 || d % 8 != 0 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 1 ? dispatch<__nv_bfloat16>(q, k, v, o, lse, batch, hq, hkv,
                                           sq, sk, d, scale, causal, s)
                 : dispatch<float>(q, k, v, o, lse, batch, hq, hkv, sq, sk,
                                   d, scale, causal, s);
  return (int)err;
}
