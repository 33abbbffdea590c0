// Tile helpers shared by the flash-attention kernels (forward and
// backward). Every kernel tiles 64 rows by the head dimension, with 4
// threads owning one row, each a quarter of the head dimension, and keeps
// the tile it streams in shared memory as f32, converted once on load.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreadsPerRow = 4;
constexpr int kThreads = kBlockQ * kThreadsPerRow;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and back: the rounding the reference applies to p and
// dS before their products.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Copies a 64 x d tile of T from device memory into shared memory as f32
// (converted once here, not at every use), in 16-byte chunks, and
// zero-fills rows at or past rows_valid. d % 8 == 0 keeps every row a whole
// number of chunks for f32 and for the 2-byte types.
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
// contiguous run of ds elements (ds <= kMax, the register array's size).
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

// Reads one thread's elements of a device-memory row of T into f32
// registers (zeros for a row that does not exist).
template <typename T, int kSlice, int kMax>
__device__ __forceinline__ void load_slice(float (&dst)[kMax], const T* row,
                                           bool valid, int slice, int ds) {
#pragma unroll
  for (int i = 0; i < kMax; ++i) {
    dst[i] = (i < ds && valid) ? to_f(row[dim_of<kSlice>(i, slice, ds)])
                               : 0.f;
  }
}

// Sum over the 4 threads of a row (adjacent lanes of one warp).
__device__ __forceinline__ float row_sum(float part) {
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  return part;
}

}  // namespace flash
