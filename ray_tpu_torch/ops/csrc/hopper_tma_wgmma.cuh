// Hopper (sm_90a) building blocks for kernels fed by the Tensor Memory
// Accelerator and computing on warpgroup tensor-core instructions: TMA
// tensor maps and copies, mbarriers, wgmma (bf16 or f16 operands, f32
// accumulators) and its shared-memory descriptors. Plain C++/PTX, no
// PyTorch or CUTLASS headers, so a kernel library built on it compiles in
// seconds.
//
// Layout convention: every shared-memory tile is stored as 128-byte rows
// (64 bf16 or f16 values) in the 128-byte swizzle that a TMA copy with
// CU_TENSOR_MAP_SWIZZLE_128B writes: the 16-byte chunk c of row r lands at
// chunk c ^ (r % 8). A tile wider than 64 columns is a sequence of such
// 64-column blocks. Every tile starts on a 1024-byte boundary (one
// swizzle atom: 8 rows of 128 bytes), which the descriptors below assume.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes initialised barriers visible to the async proxy (TMA) and to the
// other threads; follow with a block-wide barrier.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also tells the barrier how many bytes the TMA copies of
// this phase will deliver.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier's phase of the given parity has completed. A
// freshly initialised barrier counts the phase of parity 1 as completed,
// so a producer's first wait on an empty slot (parity 1) passes at once.
// A wait that never ends (a lost arrival) traps instead of hanging the
// card: no wait in these kernels legitimately lasts more than
// milliseconds, and 2^28 polls take seconds.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (polls == (1u << 28)) __trap();
  }
}

// ---- TMA ------------------------------------------------------------------

// Copies the box at (c0, c1, c2) (innermost first) of a 3-D tensor map into
// shared memory at dst; completion is counted in bytes on barrier bar.
// Elements outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Copies shared memory at src to the box at (c0, c1, c2) of a 3-D tensor
// map; elements outside the tensor are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  // The source shared memory may be released once the copy has read it.
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's ordinary shared-memory writes before later reads
// of the async proxy (a TMA store or a wgmma reading that memory).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier among `threads` threads (a multiple of 32) on barrier `id` (1..15;
// 0 is __syncthreads').
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor for a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (each in 16-byte units), layout
// type 1 (128-byte swizzle) in bits 62-63. K-major operands (the reduction
// dimension contiguous) use sbo = 1024 (8 rows of 128 bytes) and ignore lbo;
// MN-major operands use sbo = 1024 (8 rows of the reduction dimension) and
// lbo = the byte distance between 64-column blocks.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Orders register and shared-memory accesses before the wgmma that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps the compiler from moving accesses to registers that an
// asynchronous wgmma reads or writes across its start or its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ---- element types ---------------------------------------------------------

// The tensor-core kernels take bf16 (__nv_bfloat16) or f16 (__half): both
// 16-bit, with one shared-memory and register layout, so only the PTX type
// of a wgmma, of a conversion and of a tensor map depends on T.
template <typename T>
constexpr bool kF16 = std::is_same<T, __half>::value;

// Register layout of a wgmma f32 accumulator (64 x N over a warpgroup):
// warp w holds rows 16w..16w+15; lane l holds rows l/4 and l/4 + 8 of
// those; value i is column 8 * (i / 4) + 2 * (l % 4) + (i % 2) of row
// l/4 + 8 * ((i / 2) % 2). The 16-bit A operand of a register-A wgmma has
// the same pattern per 16 columns, so an accumulator packed to pairs feeds
// the next product directly: its k-step t is the pairs 8t..8t+7.

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Sum over the four lanes that share an accumulator row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Two f32 values rounded to T as one register (lo in the low half), the
// layout of a wgmma A operand in registers.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (kF16<T>) {
    asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  } else {
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  }
  return r;
}

// Two values of T (one 32-bit register) as f32.
template <typename T>
__device__ __forceinline__ float2 to_float2(uint32_t pair) {
  if constexpr (kF16<T>) {
    return __half22float2(*reinterpret_cast<const __half2*>(&pair));
  } else {
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&pair));
  }
}

// x rounded to T (to nearest even) and back to f32.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (kF16<T>) {
    return __half2float(__float2half_rn(x));
  } else {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
}

// Eight values of T times s, each product rounded to T: the product of
// two values of T is exact in f32, so this is T's own rounded product.
template <typename T>
__device__ __forceinline__ uint4 scale4(uint4 x, float s) {
  uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = to_float2<T>(w[i]);
    w[i] = pack2<T>(f.x * s, f.y * s);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Stages a warpgroup's 64 x kN f32 accumulator as T into rows row0 ..
// row0 + 63 (row0 a multiple of 8) of a shared-memory tile whose 64-column
// blocks lie block_bytes apart, in the swizzle a TMA store reads; the
// thread's two rows (r_local and r_local + 8) are multiplied by mul[0] and
// mul[1].
template <typename T, int kN>
__device__ __forceinline__ void stage_acc(uint8_t* tile, int block_bytes,
                                          int row0, int r_local,
                                          int col_lane,
                                          const float (&acc)[kN / 2],
                                          const float (&mul)[2]) {
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const int cb = j / 8;     // 64-column block
    const int chunk = j % 8;  // 16-byte chunk within the 128-byte row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_local + 8 * h;
      const int off = cb * block_bytes + (row0 + r) * 128 +
                      ((chunk ^ (r % 8)) * 16) + col_lane * 2;
      *reinterpret_cast<uint32_t*>(tile + off) = pack2<T>(
          acc[4 * j + 2 * h] * mul[h], acc[4 * j + 2 * h + 1] * mul[h]);
    }
  }
}

// ---- wgmma shapes ----------------------------------------------------------

// Operand lists of an accumulator of R f32 registers a thread: the names
// "%0, ..., %(R-1)" for the instruction and the "+f" constraints d[i].
#define HOPPER_R000 "%0, %1, %2, %3, %4, %5, %6, %7, " \
    "%8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_R016 "%16, %17, %18, %19, %20, %21, %22, %23, " \
    "%24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_R032 "%32, %33, %34, %35, %36, %37, %38, %39, " \
    "%40, %41, %42, %43, %44, %45, %46, %47"
#define HOPPER_R048 "%48, %49, %50, %51, %52, %53, %54, %55, " \
    "%56, %57, %58, %59, %60, %61, %62, %63"
#define HOPPER_R064 "%64, %65, %66, %67, %68, %69, %70, %71, " \
    "%72, %73, %74, %75, %76, %77, %78, %79"
#define HOPPER_R080 "%80, %81, %82, %83, %84, %85, %86, %87, " \
    "%88, %89, %90, %91, %92, %93, %94, %95"
#define HOPPER_R096 "%96, %97, %98, %99, %100, %101, %102, %103, " \
    "%104, %105, %106, %107, %108, %109, %110, %111"
#define HOPPER_R112 "%112, %113, %114, %115, %116, %117, %118, %119, " \
    "%120, %121, %122, %123, %124, %125, %126, %127"
#define HOPPER_REGS16 HOPPER_R000
#define HOPPER_REGS32 HOPPER_R000 ", " HOPPER_R016
#define HOPPER_REGS64 HOPPER_REGS32 ", " HOPPER_R032 ", " HOPPER_R048
#define HOPPER_REGS128 \
  HOPPER_REGS64 ", " HOPPER_R064 ", " HOPPER_R080 ", " HOPPER_R096 ", " \
  HOPPER_R112
#define HOPPER_F4(d, i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOPPER_F16(d, i) \
  HOPPER_F4(d, i), HOPPER_F4(d, i + 4), HOPPER_F4(d, i + 8), \
      HOPPER_F4(d, i + 12)
#define HOPPER_F32(d, i) HOPPER_F16(d, i), HOPPER_F16(d, i + 16)
#define HOPPER_F64(d, i) HOPPER_F32(d, i), HOPPER_F32(d, i + 32)
#define HOPPER_F128(d, i) HOPPER_F64(d, i), HOPPER_F64(d, i + 64)

// D[64 x N] (+)= A[64 x 16] * B[16 x N], A and B K-major in shared memory
// (descriptors desc_a, desc_b), accumulate == 0 overwriting D. REGS and
// OUTS name D's R = N / 2 registers; DA, DB and ACC are the operand
// numbers R, R + 1 and R + 2; TY is the PTX type of A and B.
#define HOPPER_WGMMA_SS(N, REGS, OUTS, DA, DB, ACC, TY)                     \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #ACC ", 0;\n"           \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY  \
               " {" REGS "}, %" #DA ", %" #DB ", p, 1, 1, 0, 0;\n}\n"       \
               : OUTS                                                      \
               : "l"(desc_a), "l"(desc_b), "r"(accumulate))

// D[64 x N] += A[64 x 16] * B[16 x N], A in registers (a[4], pairs in the
// accumulator's row/column pattern), B MN-major in shared memory (desc_b).
// A0 .. DB are the operand numbers R .. R + 4, ONE the number of R + 5.
#define HOPPER_WGMMA_RS(N, REGS, OUTS, A0, A1, A2, A3, DB, ONE, TY)         \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #ONE ", 0;\n"           \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY  \
               " {" REGS "}, {%" #A0 ", %" #A1 ", %" #A2 ", %" #A3 "}, %"   \
               #DB ", p, 1, 1, 1;\n}\n"                                     \
               : OUTS                                                      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),   \
                 "r"(1))

// D[64 x kN] (+)= A B with both operands in shared memory: the S-type
// products (Q K^T and the like).
template <typename T, int kN>
__device__ __forceinline__ void wgmma_ss(float (&d)[kN / 2], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  static_assert(kN == 32 || kN == 64 || kN == 128, "wgmma_ss width");
  if constexpr (kN == 32) {
    if constexpr (kF16<T>) {
      HOPPER_WGMMA_SS(32, HOPPER_REGS16, HOPPER_F16(d, 0), 16, 17, 18,
                      "f16");
    } else {
      HOPPER_WGMMA_SS(32, HOPPER_REGS16, HOPPER_F16(d, 0), 16, 17, 18,
                      "bf16");
    }
  } else if constexpr (kN == 64) {
    if constexpr (kF16<T>) {
      HOPPER_WGMMA_SS(64, HOPPER_REGS32, HOPPER_F32(d, 0), 32, 33, 34,
                      "f16");
    } else {
      HOPPER_WGMMA_SS(64, HOPPER_REGS32, HOPPER_F32(d, 0), 32, 33, 34,
                      "bf16");
    }
  } else {
    if constexpr (kF16<T>) {
      HOPPER_WGMMA_SS(128, HOPPER_REGS64, HOPPER_F64(d, 0), 64, 65, 66,
                      "f16");
    } else {
      HOPPER_WGMMA_SS(128, HOPPER_REGS64, HOPPER_F64(d, 0), 64, 65, 66,
                      "bf16");
    }
  }
}

// D[64 x kN] += A B with A in registers: the products that take P or dS
// as computed.
template <typename T, int kN>
__device__ __forceinline__ void wgmma_rs(float (&d)[kN / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  static_assert(kN == 64 || kN == 128 || kN == 256, "wgmma_rs width");
  if constexpr (kN == 64) {
    if constexpr (kF16<T>) {
      HOPPER_WGMMA_RS(64, HOPPER_REGS32, HOPPER_F32(d, 0), 32, 33, 34, 35,
                      36, 37, "f16");
    } else {
      HOPPER_WGMMA_RS(64, HOPPER_REGS32, HOPPER_F32(d, 0), 32, 33, 34, 35,
                      36, 37, "bf16");
    }
  } else if constexpr (kN == 128) {
    if constexpr (kF16<T>) {
      HOPPER_WGMMA_RS(128, HOPPER_REGS64, HOPPER_F64(d, 0), 64, 65, 66, 67,
                      68, 69, "f16");
    } else {
      HOPPER_WGMMA_RS(128, HOPPER_REGS64, HOPPER_F64(d, 0), 64, 65, 66, 67,
                      68, 69, "bf16");
    }
  } else {
    if constexpr (kF16<T>) {
      HOPPER_WGMMA_RS(256, HOPPER_REGS128, HOPPER_F128(d, 0), 128, 129, 130,
                      131, 132, 133, "f16");
    } else {
      HOPPER_WGMMA_RS(256, HOPPER_REGS128, HOPPER_F128(d, 0), 128, 129, 130,
                      131, 132, 133, "bf16");
    }
  }
}

// ---- host: tensor maps -----------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the CUDA runtime's
// entry-point query (no link against libcuda). Null if it is missing.
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (err != cudaSuccess || status != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A tensor map over a contiguous 16-bit array of T [outer, rows, cols]
// (cols a multiple of 8, so a row is a whole number of 16-byte chunks) with
// boxes of [1, box_rows, 64] in 128-byte swizzle. Rows past `rows` and
// columns past `cols` read as zeros and are not written, so a ragged edge
// never touches the next row or slice: a box that lies partly or wholly
// past `cols` (cols below 64, or a 64-column block past the head_dim)
// lands as a full box of zeros beyond the tensor, and counts its full
// bytes toward the barrier of its copy.
template <typename T>
inline CUresult encode_3d(CUtensorMap* map, const void* ptr, int outer,
                          int rows, int cols, int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map,
            kF16<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace hopper
