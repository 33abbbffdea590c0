// Flash-attention backward for Hopper (sm_90a): the FA2 split into a dQ
// kernel and a dK/dV kernel.
//
// No rule of shapes reaches these kernels any more: bf16 and f16 take
// flash_attention_bwd_wgmma.cu's, f32 up to head_dim 256 the tiled
// instances of flash_attention_wide_f32.cu. chip_smoke.py calls them
// through their C entry points, holds them against the plain backward and
// times them beside the kernels that took their place.
//
// Replaces the Pallas TPU kernels of ray_tpu/ops/flash_attention.py that
// `_flash_bwd_rule` launches: `_attn_bwd_dq_kernel` (dQ) and
// `_attn_bwd_dkv_kernel` (dK, dV). Both rebuild each probability tile from
// the forward's saved log-sum-exp, as the reference does:
//   s  = scale * Q K^T (f32, causal-masked)
//   P  = exp(s - LSE)                       (exactly 0 where masked)
//   dP = dO V^T,  delta = rowsum(dO * O),  dS = P * (dP - delta)
//   dQ = scale * round(dS) K,  dK = scale * round(dS)^T Q,
//   dV = round(P)^T dO
// where round() is the rounding to the input type that the reference
// applies before its products. Everything else accumulates in f32. delta
// is computed inside each kernel from dO and O, as in the reference.
//
// What bounds it on the H100. Per (batch, head) the pair reads Q, K, V, O,
// dO and LSE and writes dQ, dK, dV; the work is 6 * Sq * Sk * D operations
// for dQ and 8 * Sq * Sk * D for dK/dV (halved when causal). At the
// training shapes (S = 2048, D = 64, bf16, causal) that is several hundred
// operations per byte moved, above the card's ~295 ops/byte ridge, so the
// pair is bound by operations even on the tensor cores (989 TFLOP/s bf16).
// This first version does its products as f32 FMAs on the CUDA cores
// (67 TFLOP/s peak) and is limited in practice by its shared-memory reads
// (two floats per three or four FMAs); moving the four products onto wgmma
// is later work. No score or probability tile ever leaves the SM.
//
// Design (not the TPU's blocks):
// - dQ: one CTA per (batch * head, 64-row Q tile). A row's Q, dO and dQ
//   accumulator live in registers, 4 threads per row; a loop inside the
//   CTA streams 64-row K/V tiles through shared memory (f32, converted on
//   load). Causal K tiles past the diagonal are never loaded.
// - dK/dV: one CTA per (batch * head, 64-row K tile). A key row's K, V and
//   both accumulators live in registers; the loop streams Q and dO tiles,
//   with that tile's LSE and delta, through shared memory, from the first
//   Q tile that reaches the diagonal (the reference's
//   `ki * block_k // block_q`) to the end.
// - Each CTA owns its output rows, so there are no atomics and results are
//   deterministic. Shared memory holds only the two tiles in flight
//   (2 * 64 * D floats), whatever the sequence length: 128 KB at D = 256,
//   above the 48 KB default, so the launch raises the CTA's limit.
// - Head dims above 128 (up to 256) double every per-thread slice: dQ
//   keeps Q, dO and its accumulator (192 floats), dK/dV keeps K, V and
//   both accumulators (256 floats), beyond the 255 registers a thread may
//   have, so those instances spill to local memory (ptxas reports the
//   bytes). They are right and slow; the rule of shapes sends no main path
//   here.
// - Types: f32, bf16 and f16 (dtype codes 0, 1, 2), loaded and stored in
//   their own type with f32 arithmetic.
// - Ragged Sq / Sk: rows past the end are zero-filled in shared memory,
//   never stored, and masked with P = 0, so they contribute nothing.
// - LSE is [B, H, Sq] f32, as the forward kernel stores it.
//
// The kernels launch on the caller's stream and allocate nothing.

#include "flash_common.cuh"

namespace {

using namespace flash;

// kSlice: the per-thread share of the head dimension (D / 4) when known at
// compile time (a multiple of 4), else 0 and the runtime d / 4 is used.
// kMax: the size of the per-thread register arrays, at least d / 4. With
// D = 64 two CTAs fit an SM; wider rows take more registers.
template <typename T, int kSlice, int kMax>
__global__ void __launch_bounds__(kThreads, kMax == 16 ? 2 : 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, T* __restrict__ dq,
                    int sq, int sk, int d, float scale, int causal) {
  static_assert(kSlice == 0 || kSlice == kMax, "kSlice fixes kMax");
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = smem + kBlockK * d;

  const int bh = blockIdx.x;  // b * heads + h
  const int q0 = blockIdx.y * kBlockQ;
  const int row = threadIdx.x / kThreadsPerRow;
  const int slice = threadIdx.x % kThreadsPerRow;
  const int ds = kSlice > 0 ? kSlice : d / kThreadsPerRow;
  const int qi = q0 + row;
  const bool row_valid = qi < sq;
  const size_t row_off = ((size_t)bh * sq + (row_valid ? qi : 0)) * d;

  float qr[kMax];
  float dor[kMax];
  float acc[kMax];
  float delta;
  {
    float orow[kMax];
    load_slice<T, kSlice, kMax>(qr, q + row_off, row_valid, slice, ds);
    load_slice<T, kSlice, kMax>(dor, dout + row_off, row_valid, slice, ds);
    load_slice<T, kSlice, kMax>(orow, o + row_off, row_valid, slice, ds);
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < kMax; ++i) {
      part = fmaf(dor[i], orow[i], part);
      acc[i] = 0.f;
    }
    delta = row_sum(part);
  }
  const float row_lse = row_valid ? lse[(size_t)bh * sq + qi] : 0.f;

  const T* kp = k + (size_t)bh * sk * d;
  const T* vp = v + (size_t)bh * sk * d;
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

    for (int j = 0; j < kBlockK; ++j) {
      float kr[kMax];
      float vr[kMax];
      read_slice<kSlice, kMax>(kr, ks + j * d, slice, ds);
      read_slice<kSlice, kMax>(vr, vs + j * d, slice, ds);
      float s_part = 0.f;
      float dp_part = 0.f;
#pragma unroll
      for (int i = 0; i < kMax; ++i) {
        s_part = fmaf(qr[i], kr[i], s_part);
        dp_part = fmaf(dor[i], vr[i], dp_part);
      }
      const float s = row_sum(s_part) * scale;
      const float dp = row_sum(dp_part);
      const int kj = k0 + j;
      const bool keep = row_valid && kj < sk && (!causal || kj <= qi);
      const float p = keep ? __expf(s - row_lse) : 0.f;
      const float dsr = round_to<T>(p * (dp - delta));
#pragma unroll
      for (int i = 0; i < kMax; ++i) acc[i] = fmaf(dsr, kr[i], acc[i]);
    }
  }

  if (row_valid) {
    T* out = dq + row_off;
#pragma unroll
    for (int i = 0; i < kMax; ++i) {
      if (i < ds) out[dim_of<kSlice>(i, slice, ds)] = from_f<T>(acc[i] * scale);
    }
  }
}

template <typename T, int kSlice, int kMax>
__global__ void __launch_bounds__(kThreads, kMax == 16 ? 2 : 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ o,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse, T* __restrict__ dk,
                     T* __restrict__ dv, int sq, int sk, int d, float scale,
                     int causal) {
  static_assert(kSlice == 0 || kSlice == kMax, "kSlice fixes kMax");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = smem + kBlockQ * d;
  float* lse_s = smem + 2 * kBlockQ * d;
  float* delta_s = lse_s + kBlockQ;

  const int bh = blockIdx.x;  // b * heads + h
  const int k0 = blockIdx.y * kBlockK;
  const int row = threadIdx.x / kThreadsPerRow;
  const int slice = threadIdx.x % kThreadsPerRow;
  const int ds = kSlice > 0 ? kSlice : d / kThreadsPerRow;
  const int kj = k0 + row;
  const bool key_valid = kj < sk;
  const size_t key_off = ((size_t)bh * sk + (key_valid ? kj : 0)) * d;

  float kr[kMax];
  float vr[kMax];
  float dk_acc[kMax];
  float dv_acc[kMax];
  load_slice<T, kSlice, kMax>(kr, k + key_off, key_valid, slice, ds);
  load_slice<T, kSlice, kMax>(vr, v + key_off, key_valid, slice, ds);
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  const T* qp = q + (size_t)bh * sq * d;
  const T* dop = dout + (size_t)bh * sq * d;
  const T* op = o + (size_t)bh * sq * d;
  const float* lp = lse + (size_t)bh * sq;
  const int n_qb = (sq + kBlockQ - 1) / kBlockQ;
  // Causal: Q tiles that end before this K tile starts are fully masked.
  const int qb_start = causal ? k0 / kBlockQ : 0;

  for (int qb = qb_start; qb < n_qb; ++qb) {
    const int q0 = qb * kBlockQ;
    const int rows_valid = min(kBlockQ, sq - q0);
    __syncthreads();  // every thread is done with the previous tile
    load_tile(qs, qp + (size_t)q0 * d, rows_valid, d);
    load_tile(dos, dop + (size_t)q0 * d, rows_valid, d);
    {
      // delta and LSE of the tile's rows: thread (row, slice) sums its
      // share of dO * O for Q row q0 + row.
      const int qrow = q0 + row;
      const bool valid = qrow < sq;
      float dorow[kMax];
      float orow[kMax];
      load_slice<T, kSlice, kMax>(dorow, dop + (size_t)qrow * d, valid,
                                  slice, ds);
      load_slice<T, kSlice, kMax>(orow, op + (size_t)qrow * d, valid, slice,
                                  ds);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < kMax; ++i) part = fmaf(dorow[i], orow[i], part);
      part = row_sum(part);
      if (slice == 0) {
        delta_s[row] = part;
        lse_s[row] = valid ? lp[qrow] : 0.f;
      }
    }
    __syncthreads();

    for (int i_row = 0; i_row < kBlockQ; ++i_row) {
      float qrr[kMax];
      float dorr[kMax];
      read_slice<kSlice, kMax>(qrr, qs + i_row * d, slice, ds);
      read_slice<kSlice, kMax>(dorr, dos + i_row * d, slice, ds);
      float s_part = 0.f;
      float dp_part = 0.f;
#pragma unroll
      for (int i = 0; i < kMax; ++i) {
        s_part = fmaf(qrr[i], kr[i], s_part);
        dp_part = fmaf(dorr[i], vr[i], dp_part);
      }
      const float s = row_sum(s_part) * scale;
      const float dp = row_sum(dp_part);
      const int qi = q0 + i_row;
      const bool keep = key_valid && qi < sq && (!causal || kj <= qi);
      const float p = keep ? __expf(s - lse_s[i_row]) : 0.f;
      const float pr = round_to<T>(p);
      const float dsr = round_to<T>(p * (dp - delta_s[i_row]));
#pragma unroll
      for (int i = 0; i < kMax; ++i) {
        dv_acc[i] = fmaf(pr, dorr[i], dv_acc[i]);
        dk_acc[i] = fmaf(dsr, qrr[i], dk_acc[i]);
      }
    }
  }

  if (key_valid) {
    T* dko = dk + key_off;
    T* dvo = dv + key_off;
#pragma unroll
    for (int i = 0; i < kMax; ++i) {
      if (i < ds) {
        const int e = dim_of<kSlice>(i, slice, ds);
        dko[e] = from_f<T>(dk_acc[i] * scale);
        dvo[e] = from_f<T>(dv_acc[i]);
      }
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const void* lse;
  void* dq;
  void* dk;
  void* dv;
  int bh;
  int sq;
  int sk;
  int d;
  float scale;
  int causal;
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int kSlice, int kMax>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const int smem = 2 * kBlockK * a.d * (int)sizeof(float);
  auto kernel = flash_bwd_dq_kernel<T, kSlice, kMax>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.bh, (a.sq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<T*>(a.dq), a.sq, a.sk, a.d, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int kSlice, int kMax>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const int smem = (2 * kBlockQ * a.d + 2 * kBlockQ) * (int)sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, kSlice, kMax>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.bh, (a.sk + kBlockK - 1) / kBlockK);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.o),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk, a.d,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int kSlice, int kMax>
cudaError_t launch(bool dkv, const Args& a, cudaStream_t stream) {
  return dkv ? launch_dkv<T, kSlice, kMax>(a, stream)
             : launch_dq<T, kSlice, kMax>(a, stream);
}

template <typename T>
cudaError_t dispatch(bool dkv, const Args& a, cudaStream_t stream) {
  switch (a.d) {
    case 64:
      return launch<T, 16, 16>(dkv, a, stream);
    case 128:
      return launch<T, 32, 32>(dkv, a, stream);
    case 256:
      return launch<T, 64, 64>(dkv, a, stream);
    default:
      return a.d <= 128 ? launch<T, 0, 32>(dkv, a, stream)
                        : launch<T, 0, 64>(dkv, a, stream);
  }
}

int run(bool dkv, const Args& a, int dtype, void* stream) {
  if (a.bh < 1 || a.sq < 1 || a.sk < 1 || a.d < 8 || a.d > 256 ||
      a.d % 8 != 0 || dtype < 0 || dtype > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1:
      return (int)dispatch<__nv_bfloat16>(dkv, a, s);
    case 2:
      return (int)dispatch<__half>(dkv, a, s);
    default:
      return (int)dispatch<float>(dkv, a, s);
  }
}

}  // namespace

// q, o, dout, dq [B*H, Sq, D]; k, v [B*H, Sk, D] (all contiguous, 16-byte
// aligned, one dtype; D a multiple of 8 up to 256); lse [B*H, Sq] f32.
// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* dq, int bh, int sq, int sk,
                                      int d, float scale, int causal,
                                      int dtype, void* stream) {
  const Args a{q, k, v, o, dout, lse, dq, nullptr, nullptr,
               bh, sq, sk, d, scale, causal};
  return run(false, a, dtype, stream);
}

// As flash_attention_bwd_dq; dk, dv [B*H, Sk, D] in the inputs' dtype.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, const void* lse,
                                       void* dk, void* dv, int bh, int sq,
                                       int sk, int d, float scale,
                                       int causal, int dtype, void* stream) {
  const Args a{q, k, v, o, dout, lse, nullptr, dk, dv,
               bh, sq, sk, d, scale, causal};
  return run(true, a, dtype, stream);
}
