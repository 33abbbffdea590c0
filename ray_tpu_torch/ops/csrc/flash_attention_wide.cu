// Flash attention for head dims above 256 on Hopper (sm_90a), on the CUDA
// cores: the forward (MHA and GQA), dQ and dK/dV, in f32, bf16 and f16.
// The wrapper's rule of shapes sends here only bf16 and f16 above head_dim
// 1024, all three kernels. The forward, dQ and dK/dV of bf16 and f16 up to
// 1024 are flash_attention_wide_wgmma.cu's, of f32 at every width
// flash_attention_wide_f32.cu's (each of those dQ kernels writes the delta
// its dK/dV kernel reads). bf16 and f16 at the multiples of 8 up to 256
// take the tensor-core kernels, f32 there flash_attention_fwd.cu's forward
// and flash_attention_wide_f32.cu's tiled dQ and dK/dV. chip_smoke.py
// still calls this file's three kernels in every dtype through their C
// entry points, and times them beside the kernels that took their place.
//
// Replaces, for those head dims, the Pallas TPU kernels of
// ray_tpu/ops/flash_attention.py: `_attn_kernel` as `_flash_forward` (MHA)
// and `_flash_forward_grouped` (GQA) launch it, and `_attn_bwd_dq_kernel`
// and `_attn_bwd_dkv_kernel` as `_flash_bwd_rule` launches them. The
// arithmetic is theirs and the narrower kernels': the forward's Q times the
// scale rounded to the input type and rounded to it (as `_attn_kernel`
// scales its Q block), the backward's scores scaled in f32 (as the
// reference's backward kernels scale them), scores from the forward's LSE,
// finite -1e30 masking, p and dS rounded to the input type before their
// products, f32 accumulation.
//
// What stopped the narrower kernels at 256. They keep a quarter of a row
// per thread in registers (D / 4 floats per operand), and their shared
// memory holds two 64-row tiles of the full width: at D = 256 dK/dV already
// spills, and at D = 512 in f32 the two tiles alone (256 KB) exceed the
// 227 KB a block may have.
//
// Design: the head dimension of the output is split across blocks. Grid z
// picks a 64-column chunk of O, dQ or dK/dV; each block owns 64 rows of
// that chunk (4 threads a row, 16 columns each, the register footprint of
// the D = 64 kernels). Scores (and in the backward dP) need the full head
// dimension, so a block sweeps it in 64-column chunks for each 32-row tile
// it streams, through 8 KB of shared memory per operand, summing partial
// dot products in registers (32 scores a thread, 64 in the backward with
// dP), and then reloads only its own chunk for the product that writes its
// output. Registers and shared memory stay the same whatever D is, so
// there is no upper limit but the grid's: any multiple of 8 works. The
// price is recomputation: each of the D / 64 column blocks computes the
// scores again, so the work is about (D / 64 + 1) / 2 times the forward's
// (more in the backward), all on the CUDA cores in f32. These kernels are
// meant to be right; the flagship (head_dim 64) never runs them.
//
// What bounds them on the H100: operations, at the f32 rate outside the
// tensor cores (67 TFLOP/s), and in practice their shared-memory reads
// (one float per FMA, broadcast across the 8 rows of a warp).
//
// Other points:
// - Ragged Sq / Sk and a last chunk narrower than 64 columns (D = 264) are
//   zero-filled in shared memory and never stored; masked keys read -1e30.
// - GQA: query head h reads KV head h / (Hq / Hkv), as the narrower kernel.
// - Causal tiles past the diagonal are skipped: in the forward and dQ the
//   key tiles after the block's last query row, in dK/dV the query tiles
//   before its first key row.
// - Every block computes delta = rowsum(dO * O) over the full head
//   dimension itself, as the narrower CUDA-core kernels do; the dQ
//   kernel's blocks of chunk 0 also write it [B*H, Sq] f32 when given a
//   buffer, as the dQ kernels of the other wide libraries write it for
//   their dK/dV kernels, which read it rather than O.
// - LSE [B, Hq, Sq] f32 is written by the blocks of chunk 0.
//
// The kernels launch on the caller's stream and allocate nothing.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kCols = 64;                          // columns per chunk
constexpr int kColSlice = kCols / kThreadsPerRow;  // a thread's 16 columns
constexpr int kTile = 32;                          // rows streamed per tile
static_assert(kThreads / 8 == kTile, "dK/dV: 8 threads per row of delta");

// Copies rows [0, rows_valid) and columns [0, width) of a kTile x kCols
// chunk (row stride d in elements) into shared memory as f32, zero-filling
// the rest. width is a multiple of 8, so each 16-byte vector is whole.
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, const T* src,
                                           int rows_valid, int d,
                                           int width) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = kCols / kVec;
  for (int c = threadIdx.x; c < kTile * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c - r * kPerRow) * kVec;
    float* out = dst + r * kCols + col;
    if (r < rows_valid && col < width) {
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

// A thread's 16 columns of one chunk of a device-memory row (zeros past
// width or for a row that does not exist).
template <typename T>
__device__ __forceinline__ void load_part(float (&dst)[kColSlice],
                                          const T* row, bool valid,
                                          int slice, int width) {
#pragma unroll
  for (int i = 0; i < kColSlice; ++i) {
    const int e = dim_of<kColSlice>(i, slice, kColSlice);
    dst[i] = (valid && e < width) ? to_f(row[e]) : 0.f;
  }
}

// A thread's 16 columns of a shared-memory chunk row.
__device__ __forceinline__ void read_part(float (&dst)[kColSlice],
                                          const float* row, int slice) {
  read_slice<kColSlice, kColSlice>(dst, row, slice, kColSlice);
}

__device__ __forceinline__ float dot(const float (&a)[kColSlice],
                                     const float (&b)[kColSlice]) {
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < kColSlice; ++i) part = fmaf(a[i], b[i], part);
  return part;
}

template <typename T>
__device__ __forceinline__ void store_part(T* row,
                                           const float (&src)[kColSlice],
                                           float mul, int slice, int width) {
#pragma unroll
  for (int i = 0; i < kColSlice; ++i) {
    const int e = dim_of<kColSlice>(i, slice, kColSlice);
    if (e < width) row[e] = from_f<T>(src[i] * mul);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int hq, int hkv, int sq,
                      int sk, int d, float scale, int causal) {
  __shared__ __align__(16) float ks[kTile * kCols];
  __shared__ __align__(16) float vs[kTile * kCols];

  const int bh = blockIdx.x;  // b * hq + h
  const int b = bh / hq;
  const int kv_row = b * hkv + (bh - b * hq) / (hq / hkv);
  const int q0 = blockIdx.y * kBlockQ;
  const int c0 = blockIdx.z * kCols;
  const int c_width = min(kCols, d - c0);
  const int row = threadIdx.x / kThreadsPerRow;
  const int slice = threadIdx.x % kThreadsPerRow;
  const int qi = q0 + row;
  const bool row_valid = qi < sq;
  const T* qp = q + ((size_t)bh * sq + (row_valid ? qi : 0)) * d;
  const T* kp = k + (size_t)kv_row * sk * d;
  const T* vp = v + (size_t)kv_row * sk * d;

  float acc[kColSlice];
#pragma unroll
  for (int i = 0; i < kColSlice; ++i) acc[i] = 0.f;
  float m = kNegInf;
  float l = 0.f;
  const float scale_t = round_to<T>(scale);

  int n_kb = (sk + kTile - 1) / kTile;
  if (causal) n_kb = min(n_kb, (min(q0 + kBlockQ, sq) - 1) / kTile + 1);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kTile;
    const int rows_valid = min(kTile, sk - k0);
    float s[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) s[j] = 0.f;
    for (int col0 = 0; col0 < d; col0 += kCols) {
      const int width = min(kCols, d - col0);
      __syncthreads();  // every thread is done with the previous chunk
      load_chunk(ks, kp + (size_t)k0 * d + col0, rows_valid, d, width);
      __syncthreads();
      float qr[kColSlice];
      load_part(qr, qp + col0, row_valid, slice, width);
#pragma unroll
      for (int i = 0; i < kColSlice; ++i) {
        qr[i] = round_to<T>(qr[i] * scale_t);
      }
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        float kr[kColSlice];
        read_part(kr, ks + j * kCols, slice);
        s[j] += dot(qr, kr);
      }
    }
    float sub_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float sc = row_sum(s[j]);
      const int kj = k0 + j;
      s[j] = (kj < sk && (!causal || kj <= qi)) ? sc : kNegInf;
      sub_max = fmaxf(sub_max, s[j]);
    }
    const float m_new = fmaxf(m, sub_max);
    const float alpha = __expf(m - m_new);
#pragma unroll
    for (int i = 0; i < kColSlice; ++i) acc[i] *= alpha;
    __syncthreads();
    load_chunk(vs, vp + (size_t)k0 * d + c0, rows_valid, d, c_width);
    __syncthreads();
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float p = __expf(s[j] - m_new);
      p_sum += p;
      const float pr = round_to<T>(p);
      float vr[kColSlice];
      read_part(vr, vs + j * kCols, slice);
#pragma unroll
      for (int i = 0; i < kColSlice; ++i) acc[i] = fmaf(pr, vr[i], acc[i]);
    }
    l = l * alpha + p_sum;
    m = m_new;
  }

  if (row_valid) {
    const float l_safe = fmaxf(l, 1e-30f);
    store_part(o + ((size_t)bh * sq + qi) * d + c0, acc, 1.f / l_safe, slice,
               c_width);
    if (blockIdx.z == 0 && slice == 0) {
      lse[(size_t)bh * sq + qi] = m + logf(l_safe);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ o,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse, T* __restrict__ dq,
                         float* __restrict__ delta_out, int sq, int sk, int d,
                         float scale, int causal) {
  __shared__ __align__(16) float ks[kTile * kCols];
  __shared__ __align__(16) float vs[kTile * kCols];

  const int bh = blockIdx.x;  // b * heads + h
  const int q0 = blockIdx.y * kBlockQ;
  const int c0 = blockIdx.z * kCols;
  const int c_width = min(kCols, d - c0);
  const int row = threadIdx.x / kThreadsPerRow;
  const int slice = threadIdx.x % kThreadsPerRow;
  const int qi = q0 + row;
  const bool row_valid = qi < sq;
  const size_t row_off = ((size_t)bh * sq + (row_valid ? qi : 0)) * d;
  const T* kp = k + (size_t)bh * sk * d;
  const T* vp = v + (size_t)bh * sk * d;

  float delta = 0.f;
  for (int col0 = 0; col0 < d; col0 += kCols) {
    float dor[kColSlice];
    float orow[kColSlice];
    const int width = min(kCols, d - col0);
    load_part(dor, dout + row_off + col0, row_valid, slice, width);
    load_part(orow, o + row_off + col0, row_valid, slice, width);
    delta += dot(dor, orow);
  }
  delta = row_sum(delta);
  if (delta_out != nullptr && blockIdx.z == 0 && row_valid && slice == 0) {
    delta_out[(size_t)bh * sq + qi] = delta;
  }
  const float row_lse = row_valid ? lse[(size_t)bh * sq + qi] : 0.f;

  float acc[kColSlice];
#pragma unroll
  for (int i = 0; i < kColSlice; ++i) acc[i] = 0.f;

  int n_kb = (sk + kTile - 1) / kTile;
  if (causal) n_kb = min(n_kb, (min(q0 + kBlockQ, sq) - 1) / kTile + 1);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kTile;
    const int rows_valid = min(kTile, sk - k0);
    float s[kTile];
    float dp[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      s[j] = 0.f;
      dp[j] = 0.f;
    }
    for (int col0 = 0; col0 < d; col0 += kCols) {
      const int width = min(kCols, d - col0);
      __syncthreads();
      load_chunk(ks, kp + (size_t)k0 * d + col0, rows_valid, d, width);
      load_chunk(vs, vp + (size_t)k0 * d + col0, rows_valid, d, width);
      __syncthreads();
      float qr[kColSlice];
      float dor[kColSlice];
      load_part(qr, q + row_off + col0, row_valid, slice, width);
      load_part(dor, dout + row_off + col0, row_valid, slice, width);
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        float kr[kColSlice];
        float vr[kColSlice];
        read_part(kr, ks + j * kCols, slice);
        read_part(vr, vs + j * kCols, slice);
        s[j] += dot(qr, kr);
        dp[j] += dot(dor, vr);
      }
    }
    // s[j] becomes dS, rounded to T.
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const float sc = row_sum(s[j]) * scale;
      const float dpj = row_sum(dp[j]);
      const int kj = k0 + j;
      const bool keep = row_valid && kj < sk && (!causal || kj <= qi);
      const float p = keep ? __expf(sc - row_lse) : 0.f;
      s[j] = round_to<T>(p * (dpj - delta));
    }
    __syncthreads();
    load_chunk(ks, kp + (size_t)k0 * d + c0, rows_valid, d, c_width);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float kr[kColSlice];
      read_part(kr, ks + j * kCols, slice);
#pragma unroll
      for (int i = 0; i < kColSlice; ++i) acc[i] = fmaf(s[j], kr[i], acc[i]);
    }
  }

  if (row_valid) store_part(dq + row_off + c0, acc, scale, slice, c_width);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ o,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse, T* __restrict__ dk,
                          T* __restrict__ dv, int sq, int sk, int d,
                          float scale, int causal) {
  __shared__ __align__(16) float qs[kTile * kCols];
  __shared__ __align__(16) float dos[kTile * kCols];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int bh = blockIdx.x;  // b * heads + h
  const int k0 = blockIdx.y * kBlockK;
  const int c0 = blockIdx.z * kCols;
  const int c_width = min(kCols, d - c0);
  const int row = threadIdx.x / kThreadsPerRow;
  const int slice = threadIdx.x % kThreadsPerRow;
  const int kj = k0 + row;
  const bool key_valid = kj < sk;
  const size_t key_off = ((size_t)bh * sk + (key_valid ? kj : 0)) * d;
  const T* qp = q + (size_t)bh * sq * d;
  const T* dop = dout + (size_t)bh * sq * d;
  const T* op = o + (size_t)bh * sq * d;
  const float* lp = lse + (size_t)bh * sq;

  float dk_acc[kColSlice];
  float dv_acc[kColSlice];
#pragma unroll
  for (int i = 0; i < kColSlice; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  const int n_qb = (sq + kTile - 1) / kTile;
  // Causal: query tiles that end before this block's first key are masked.
  for (int qb = causal ? k0 / kTile : 0; qb < n_qb; ++qb) {
    const int q0 = qb * kTile;
    const int rows_valid = min(kTile, sq - q0);
    {
      // delta and LSE of the tile's rows, 8 threads a row (lanes of one
      // warp). The previous tile's last reads of them precede the
      // __syncthreads before its chunk reload.
      const int r = threadIdx.x / 8;
      const int part_id = threadIdx.x % 8;
      const int qrow = q0 + r;
      const bool valid = qrow < sq;
      float part = 0.f;
      if (valid) {
        for (int e = part_id; e < d; e += 8) {
          part = fmaf(to_f(dop[(size_t)qrow * d + e]),
                      to_f(op[(size_t)qrow * d + e]), part);
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      if (part_id == 0) {
        delta_s[r] = part;
        lse_s[r] = valid ? lp[qrow] : 0.f;
      }
    }
    float s[kTile];
    float dp[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      s[i] = 0.f;
      dp[i] = 0.f;
    }
    for (int col0 = 0; col0 < d; col0 += kCols) {
      const int width = min(kCols, d - col0);
      __syncthreads();
      load_chunk(qs, qp + (size_t)q0 * d + col0, rows_valid, d, width);
      load_chunk(dos, dop + (size_t)q0 * d + col0, rows_valid, d, width);
      __syncthreads();
      float kr[kColSlice];
      float vr[kColSlice];
      load_part(kr, k + key_off + col0, key_valid, slice, width);
      load_part(vr, v + key_off + col0, key_valid, slice, width);
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
        float qrr[kColSlice];
        float dorr[kColSlice];
        read_part(qrr, qs + i * kCols, slice);
        read_part(dorr, dos + i * kCols, slice);
        s[i] += dot(kr, qrr);
        dp[i] += dot(vr, dorr);
      }
    }
    // s[i] becomes round(P), dp[i] round(dS).
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      const float sc = row_sum(s[i]) * scale;
      const float dpi = row_sum(dp[i]);
      const int qi = q0 + i;
      const bool keep = key_valid && qi < sq && (!causal || kj <= qi);
      const float p = keep ? __expf(sc - lse_s[i]) : 0.f;
      s[i] = round_to<T>(p);
      dp[i] = round_to<T>(p * (dpi - delta_s[i]));
    }
    __syncthreads();
    load_chunk(qs, qp + (size_t)q0 * d + c0, rows_valid, d, c_width);
    load_chunk(dos, dop + (size_t)q0 * d + c0, rows_valid, d, c_width);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      float qrr[kColSlice];
      float dorr[kColSlice];
      read_part(qrr, qs + i * kCols, slice);
      read_part(dorr, dos + i * kCols, slice);
#pragma unroll
      for (int e = 0; e < kColSlice; ++e) {
        dv_acc[e] = fmaf(s[i], dorr[e], dv_acc[e]);
        dk_acc[e] = fmaf(dp[i], qrr[e], dk_acc[e]);
      }
    }
  }

  if (key_valid) {
    store_part(dk + key_off + c0, dk_acc, scale, slice, c_width);
    store_part(dv + key_off + c0, dv_acc, 1.f, slice, c_width);
  }
}

bool bad_shape(int bh, int sq, int sk, int d, int dtype) {
  return bh < 1 || sq < 1 || sk < 1 || d < 8 || d % 8 != 0 || dtype < 0 ||
         dtype > 2;
}

int n_chunks(int d) { return (d + kCols - 1) / kCols; }

template <typename T>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, int batch, int hq, int hkv, int sq, int sk, int d,
                float scale, int causal, cudaStream_t stream) {
  dim3 grid(batch * hq, (sq + kBlockQ - 1) / kBlockQ, n_chunks(d));
  flash_fwd_wide_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), hq, hkv, sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* dq, void* delta, int bh, int sq, int sk, int d,
                   float scale, int causal, cudaStream_t stream) {
  dim3 grid(bh, (sq + kBlockQ - 1) / kBlockQ, n_chunks(d));
  flash_bwd_dq_wide_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dq), static_cast<float*>(delta), sq, sk, d, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, const void* lse,
                    void* dk, void* dv, int bh, int sq, int sk, int d,
                    float scale, int causal, cudaStream_t stream) {
  dim3 grid(bh, (sk + kBlockK - 1) / kBlockK, n_chunks(d));
  flash_bwd_dkv_wide_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, d, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], o [B, Hq, Sq, D] (contiguous,
// 16-byte aligned, one dtype), lse [B, Hq, Sq] f32; D any multiple of 8.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t.
extern "C" int flash_attention_fwd_wide(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int batch, int hq, int hkv, int sq,
                                        int sk, int d, float scale,
                                        int causal, int dtype,
                                        void* stream) {
  if (bad_shape(batch * hq, sq, sk, d, dtype) || batch < 1 || hkv < 1 ||
      hq % hkv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return (int)fwd<__nv_bfloat16>(q, k, v, o, lse, batch, hq, hkv, sq,
                                     sk, d, scale, causal, s);
    case 2:
      return (int)fwd<__half>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d,
                              scale, causal, s);
    default:
      return (int)fwd<float>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d,
                             scale, causal, s);
  }
}

// q, o, dout, dq [B*H, Sq, D]; k, v [B*H, Sk, D] (contiguous, 16-byte
// aligned, one dtype; D any multiple of 8); lse [B*H, Sq] f32; delta null,
// or [B*H, Sq] f32 written with rowsum(dO * O).
extern "C" int flash_attention_bwd_dq_wide(const void* q, const void* k,
                                           const void* v, const void* o,
                                           const void* dout, const void* lse,
                                           void* dq, void* delta, int bh,
                                           int sq, int sk, int d, float scale,
                                           int causal, int dtype,
                                           void* stream) {
  if (bad_shape(bh, sq, sk, d, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return (int)bwd_dq<__nv_bfloat16>(q, k, v, o, dout, lse, dq, delta, bh,
                                        sq, sk, d, scale, causal, s);
    case 2:
      return (int)bwd_dq<__half>(q, k, v, o, dout, lse, dq, delta, bh, sq,
                                 sk, d, scale, causal, s);
    default:
      return (int)bwd_dq<float>(q, k, v, o, dout, lse, dq, delta, bh, sq,
                                sk, d, scale, causal, s);
  }
}

// As flash_attention_bwd_dq_wide; dk, dv [B*H, Sk, D] in the inputs' dtype.
extern "C" int flash_attention_bwd_dkv_wide(const void* q, const void* k,
                                            const void* v, const void* o,
                                            const void* dout,
                                            const void* lse, void* dk,
                                            void* dv, int bh, int sq, int sk,
                                            int d, float scale, int causal,
                                            int dtype, void* stream) {
  if (bad_shape(bh, sq, sk, d, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return (int)bwd_dkv<__nv_bfloat16>(q, k, v, o, dout, lse, dk, dv, bh,
                                         sq, sk, d, scale, causal, s);
    case 2:
      return (int)bwd_dkv<__half>(q, k, v, o, dout, lse, dk, dv, bh, sq, sk,
                                  d, scale, causal, s);
    default:
      return (int)bwd_dkv<float>(q, k, v, o, dout, lse, dk, dv, bh, sq, sk,
                                 d, scale, causal, s);
  }
}
