// Flash attention in float32 on Hopper (sm_90a), on the CUDA cores: the
// forward (MHA and GQA), dQ and dK/dV at every head_dim that is a multiple
// of 8. The wrapper's rule of shapes sends every f32 call here, all three
// kernels: above head_dim 256 "wide_f32" (the output's head dimension
// split into slices across blocks), up to 256 "tiled_f32" (instances of
// the same forward, dQ and dK/dV templates whose block covers all of D).
// Each dQ kernel also writes the delta = rowsum(dO * O) that the dK/dV
// kernel reads.
//
// Replaces, for those head dims in f32, the Pallas TPU kernels of
// ray_tpu/ops/flash_attention.py: `_attn_kernel` as `_flash_forward` (MHA)
// and `_flash_forward_grouped` (GQA, K/V at n_kv_heads width) launch it,
// and `_attn_bwd_dq_kernel` and `_attn_bwd_dkv_kernel` as
// `_flash_bwd_rule` launches them. The arithmetic is theirs: the forward's
// Q times the scale before Q K^T, f32 scores, the online softmax with
// finite -1e30 masking, l clamped at 1e-30, LSE = m + log(l); the
// backward's scores scaled in f32, P rebuilt as exp(scale * S - LSE), dS =
// P * (dP - delta), dQ = scale * sum dS K, dV = sum P^T dO and dK = scale
// * sum dS^T Q. Every product is an f32 FMA on the CUDA cores: no
// TF32 and no tensor-core instruction, whose rounding would break the f32
// limits (testing.O_ROW_TOL, LSE_TOL, GRAD_ROW_TOL).
//
// What bounds them on the H100: f32 operations at 67 TFLOP/s. The forward
// does 4 * Sq * Sk * D operations per (batch, head), dQ 6 * Sq * Sk * D and
// dK/dV 8 * Sq * Sk * D (about half of each when causal): at B=4, H=8,
// S=2048, D=512, causal that is ~137, ~206 and ~275 GFLOP against ~0.54 to
// ~0.81 GB moved, 2.05, 3.08 and 4.10 ms at the f32 rate against 0.16 to
// 0.24 ms at 3.35 TB/s; at D=64, 0.385 ms (dQ) and 0.513 ms (dK/dV)
// against 0.06 to 0.08 ms; the forward at D=64 0.257 ms, at 256 1.026 ms.
// The earlier f32 kernels up to 256 (flash_attention_fwd.cu and
// flash_attention_bwd.cu, 4 threads a row, each reading an operand float
// from shared memory per FMA, spilling above D=128) ran the backward pair
// at 25% (D=64) and 13% (D=256) of that rate and the forward at 18% and
// 17%; the tiled instances run the backward pair at 43% and 46% and the
// forward at 48% and 50% (flash_ab.py --f32 and chip_smoke.py on an H100
// SXM at 700 W).
//
// Design, all three kernels (256 threads, one block per SM), as the wide
// instances have it; the kernels are templates over their block's shape
// (FwdShape, DqShape, DkvShape), and the tiled instances below differ only
// in those shapes:
// - A block owns a wide slice of the output's columns: 256 columns of O
//   (64 rows x 256 columns, 64 f32 a thread), 512 of dQ (64 rows x 512
//   columns, 128 f32 a thread) or 256 of dK and of dV (64 keys x 256
//   columns each, 128 f32 a thread for both). The scores need all of D,
//   so each block reduces them over D itself and the reduction is
//   repeated once per slice: (D / 256 + 1) / 2 times the forward's
//   operations, (2 * D / 512 + 1) / 3 times dQ's and (2 * D / 256 + 2) / 4
//   times dK/dV's: 1.5x, 1x and 1.5x at D = 512, against 4.5x and more for
//   the 64-column slices of flash_attention_wide.cu. ptxas holds dK/dV's
//   128 accumulators, the
//   score tiles and the operands in 255 registers without a spill; with
//   128 columns (64 accumulators, 2.5x the work at D = 512) it took 238
//   and ran 1.7x slower (flash_ab.py --wide-f32).
// - Every product is register-tiled as a SIMT GEMM: a thread computes an
//   8 x 4 tile of the forward's scores (64 rows x 128 keys a tile) and an
//   8 x 8 tile of O; a 4 x 4 tile of S^T and of dP^T (64 keys x 64 query
//   rows) and an 8 x 8 tile of dK and of dV. The operands come from
//   shared memory as float4: 128 FMAs for 12 float4 loads in the forward's
//   scores, 64 for 4 in P V, 128 for 16 in dK/dV's reduction and 128 for
//   8 in its products. Box rows are padded to 36 floats so that the eight
//   rows a warp reads at one column fall in distinct banks; P (and dS) sit
//   in shared memory in the layout the products read, 8 consecutive keys
//   or query rows a thread, so a warp's reads of them are conflict-free.
// - The reduction over D streams 32-column boxes (Q and K, or K, V, Q and
//   dO) and the products stream V (32 keys x 256 columns) or Q and dO (16
//   rows x 256 columns) through a ring of three 16-byte cp.async stages,
//   two boxes ahead of the one being computed, with one __syncthreads a
//   box. The ring runs on across tiles, so the next tile's first boxes
//   load while the current tile's products run.
// - The forward scales Q in shared memory once per box, each thread the
//   16-byte pieces it copied itself (visible to it after cp.async's wait),
//   before the box's barrier. The softmax of a tile runs over P^T in
//   shared memory, four threads a query row; the rescale factor of each
//   row goes to shared memory for the threads that own O's rows.
// - dK/dV reads LSE and delta, never O: the dQ kernel writes delta as a
//   side output. A tile's LSE and delta are copied into the stage of its
//   last reduction box.
// - dQ is dK/dV turned around: a block owns 64 query rows x 512 columns of
//   dQ (an 8 x 16 tile a thread: no repeated reduction up to D = 512; with
//   256 columns, 1.67x the work at D = 512, it ran 1.7x slower,
//   flash_ab.py --wide-f32) and streams 64-key tiles up to its last row,
//   the reduction boxes holding Q, dO, K and V and the product boxes K's
//   16 keys x 512 columns. dS goes to shared memory as dS^T, 8 consecutive
//   query rows a thread for the product. Each 32-column box's partial dP
//   starts from 0 and joins the tile's sum once done (shorter rounding
//   chains: dP - delta cancels where dO and V are large, ROADMAP C.9); S
//   needs no such split, and without its partials the 128 accumulators
//   fit 254 registers with no spill. delta and LSE of the block's 64 rows
//   are read once, before the key loop, four threads a row; the blocks of
//   the first column slice write delta.
//
// The tiled instances (the f32 forward, dQ and dK/dV up to head_dim 256).
// A block covers all of D, so the score reduction is never repeated; each
// width
// runs the narrowest instance whose columns reach it, the columns past D
// zero-filled and never stored (the products' padding waste: D=8 8x,
// 32 2x, 96 1.33x, 200 1.28x, 248 1.03x; the reduction runs over the real
// D in whole boxes). A thread's tile of the output keeps 8 rows (O, dQ) or
// keys (dK/dV) of whole float4s, so at narrow D a block takes more rows
// or keys rather than fewer columns a thread:
// - forward: 128 rows x 64 columns (D <= 64: an 8 x 4 O tile a thread,
//   one 128-key V box a tile), 128 x 128 (D <= 128: 8 x 8) and 64 x 256
//   (D <= 256: the wide instance's shape, exactly the work, and its order
//   of operations, so its results bit for bit), each over 128-key tiles
//   (8 x 8 score tiles a thread at 128 rows, 8 x 4 at 64). Each copies
//   the block's Q into shared memory with the first box and scales it
//   there once, so that only K and V stream; the wide instance copies and
//   scales Q's box again for every key tile. The softmax takes 256 / rows
//   threads a query row.
// - dK/dV: 128 keys x 64 columns (D <= 64: 16-column boxes, since the
//   128-key K and V boxes and 128-key P and dS fill shared memory at 32;
//   8 x 4 S^T and dP^T tiles), 64 keys x 128 columns (D <= 128) and the
//   wide instance, 64 keys x 256 columns (D <= 256: exactly the work).
// - dQ: 128 rows x 64 and x 128 columns (8 x 4 S and dP tiles), 64 rows
//   x 256 columns. Each sums delta as dP is summed: per 32-column box a
//   chain of FMAs from 0, the pieces added in box order. Where O's row is
//   a key's V row (a causal first row: P = 1 on one key), dP - delta is
//   then exactly 0 and so is that row of dQ, as the exact formula has it.
// - The S and dP products of a reduction step load their operands in two
//   halves (Q and K, then dO and V), which keeps the 8-row tiles' operands
//   out of registers at once; each accumulator's chain of FMAs is the
//   wide instances' own.
// - Causal (the reference's top-left mask): dQ skips key tiles past its
//   block's last row and runs the last rows (the most tiles) first;
//   dK/dV skips query tiles before its first key and runs the first keys
//   first.
// - 256 threads and one block an SM, every instance: ptxas holds each in
//   238 to 255 registers without a spill. 128 keys x 128 columns of dK
//   and dV (128 f32 of them a thread) spilled 208 bytes and ran 15%
//   slower than 64 x 128; 64 rows x 128 columns of dQ ran 10% slower than
//   128 x 128, and 16-column boxes for dQ at D <= 64 8% slower than 32
//   (flash_ab.py --f32). The forward's 128 x 128 instances hold their 8 x
//   8 score tile in 255 registers; 64-key tiles ran 4-6% slower, 64 rows
//   at D <= 128 11-16% slower, Q streamed again for every key tile 1-4%
//   slower, and two blocks an SM at D <= 64 (128 registers) spilled and
//   ran 5-11% slower.
//
// Other points:
// - Any multiple of 8 (the wide instances: no upper limit): a box
//   narrower than 32 columns at the end of D (D = 264: 8 columns), a slice
//   wider than what is left of D (D = 264: 8 of 256) and rows past Sq or
//   Sk are zero-filled by cp.async (source size 0) and never stored.
// - GQA: query head h reads KV head h / (Hq / Hkv).
// - Causal (the reference's top-left mask): the forward skips key tiles
//   past the block's last query row, dK/dV query tiles before its first
//   key; masked scores read -1e30 (forward) or give P = 0 (dK/dV).
// - The forward schedules the last query rows (the heaviest causal
//   blocks) first; LSE [B, Hq, Sq] f32 is written by the blocks of the
//   first column slice. Each block owns its outputs: no atomics.
//
// Launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kBoxCols = 32;                 // columns of D per box
constexpr int kBoxStride = kBoxCols + 4;     // padded row of a box
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, or 16 zero bytes (valid false:
// the source is not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's copies of every group but the newest are done and visible
// to it.
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [row0, row0 + R) and columns [col0, col0 + W) of a [rows, d]
// row-major matrix into shared memory (row stride DS floats), zero-filling
// what lies past its last row or past column d. W and d are multiples of 4
// (d of 8), so a 16-byte piece is wholly in or out.
template <int R, int W, int DS>
__device__ __forceinline__ void load_box(float* dst, const float* mat,
                                         int row0, int rows, int col0,
                                         int d) {
  constexpr int kPieces = R * W / 4;
  static_assert(kPieces % kThreads == 0, "whole pieces per thread");
#pragma unroll
  for (int i = 0; i < kPieces / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / (W / 4);
    const int col = (c - r * (W / 4)) * 4;
    const bool valid = row0 + r < rows && col0 + col < d;
    cp_async16(dst + r * DS + col,
               valid ? mat + (size_t)(row0 + r) * d + col0 + col : mat,
               valid);
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void unpack8(float (&dst)[8], const float4& a,
                                        const float4& b) {
  dst[0] = a.x;
  dst[1] = a.y;
  dst[2] = a.z;
  dst[3] = a.w;
  dst[4] = b.x;
  dst[5] = b.y;
  dst[6] = b.z;
  dst[7] = b.w;
}

// ------------------------------------------------------------- forward
// A forward block: kRows query rows x kCols columns of O, kKeys keys a
// tile, each tile's V streamed in boxes of kVKeys keys x kCols columns.
// kHoldQ: the block's Q (all of D, which kCols must then reach) is copied
// into shared memory once and scaled once, and only K and V stream; else
// Q's box is copied and scaled beside K's for every key tile.
template <int kRows_, int kKeys_, int kCols_, int kVKeys_, bool kHoldQ_>
struct FwdShape {
  static constexpr int kRows = kRows_;
  static constexpr int kKeys = kKeys_;
  static constexpr int kCols = kCols_;
  static constexpr int kVKeys = kVKeys_;
  static constexpr bool kHoldQ = kHoldQ_;
  static constexpr int kVBoxes = kKeys / kVKeys;
  static constexpr int kTy = kRows / 8;        // S: rows ty + kTy i
  static constexpr int kTx = kThreads / kTy;   // S: keys tx + kTx j
  static constexpr int kKeyTiles = kKeys / kTx;    // a thread's keys of S
  static constexpr int kThreadCols = kCols / kTx;  // a thread's columns of O
  static constexpr int kParts = kThreads / kRows;  // softmax: threads a row
  static constexpr int kQBox = kRows * kBoxStride;
  static constexpr int kKBox = kKeys * kBoxStride;
  static constexpr int kVBox = kVKeys * kCols;
  static constexpr int kRBox = kHoldQ ? kKBox : kQBox + kKBox;
  static constexpr int kStage = kRBox > kVBox ? kRBox : kVBox;
  static constexpr int kPStride = kRows + 4;   // P^T: one row of kRows a key
  static constexpr int kHeldQ = kHoldQ ? kCols / kBoxCols * kQBox : 0;
  static constexpr int kSmemFloats =
      kStages * kStage + kKeys * kPStride + 2 * kRows + kHeldQ;
  static constexpr int kSmemBytes = kSmemFloats * 4;
  static_assert(kTy * kTx == kThreads && kTx % 8 == 0 && kKeys % kTx == 0 &&
                    kThreadCols % 4 == 0 && kKeys % kVKeys == 0 &&
                    kCols % kBoxCols == 0 && (kParts & (kParts - 1)) == 0,
                "thread tiles of whole float4s");
  static_assert(kSmemBytes <= 232448, "227 KB a block");
};

template <class Shape>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wide_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int hq, int hkv, int sq,
                          int sk, int d, int n_slices, float scale,
                          int causal) {
  constexpr int kRows = Shape::kRows;
  constexpr int kKeys = Shape::kKeys;
  constexpr int kCols = Shape::kCols;
  constexpr int kVKeys = Shape::kVKeys;
  constexpr int kVBoxes = Shape::kVBoxes;
  constexpr int kTy = Shape::kTy;
  constexpr int kTx = Shape::kTx;
  constexpr int kKeyTiles = Shape::kKeyTiles;
  constexpr int kThreadCols = Shape::kThreadCols;
  constexpr int kParts = Shape::kParts;
  constexpr int kQBox = Shape::kQBox;
  constexpr int kStage = Shape::kStage;
  constexpr int kPStride = Shape::kPStride;
  extern __shared__ __align__(16) float smem[];
  float* pt = smem + kStages * kStage;        // P^T [kKeys][kPStride]
  float* alpha_s = pt + kKeys * kPStride;     // per row: rescale of O
  float* inv_l_s = alpha_s + kRows;           // per row: 1 / l
  float* qh = inv_l_s + kRows;                // kHoldQ: Q's boxes over D

  const int bh = blockIdx.x / n_slices;       // b * hq + h
  const int slice = blockIdx.x - bh * n_slices;
  const int b = bh / hq;
  const int kv = b * hkv + (bh - b * hq) / (hq / hkv);
  // The last query rows (the most key tiles when causal) first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int c0 = slice * kCols;
  const float* qm = q + (size_t)bh * sq * d;
  const float* km = k + (size_t)kv * sk * d;
  const float* vm = v + (size_t)kv * sk * d;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // Scores: rows ty + kTy i, keys tx + kTx j. O: rows 8 ty + i, columns
  // 4 tx + 4 kTx j + e. A warp spans 4 values of ty and 8 of tx.
  const int ty = (warp / (kTx / 8)) * 4 + lane / 8;
  const int tx = (warp % (kTx / 8)) * 8 + lane % 8;
  // Softmax: kParts threads (adjacent lanes) a query row, keys part +
  // kParts e.
  const int srow = threadIdx.x / kParts;
  const int spart = threadIdx.x % kParts;
  const int sqi = q0 + srow;
  float m = kNegInf;
  float l = 0.f;

  float acc[8][kThreadCols];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int c = 0; c < kThreadCols; ++c) acc[i][c] = 0.f;
  }
  float s[8][kKeyTiles];

  int n_kb = (sk + kKeys - 1) / kKeys;
  if (causal) n_kb = min(n_kb, (min(q0 + kRows, sq) - 1) / kKeys + 1);
  const int n_sbox = (d + kBoxCols - 1) / kBoxCols;
  const int per_tile = n_sbox + kVBoxes;
  const int n_boxes = n_kb * per_tile;

  // Box `box` of the sequence (per key tile: n_sbox boxes of K, and of Q
  // unless held, over D, then kVBoxes boxes of V over the block's columns)
  // into its stage.
  auto issue = [&](int box) {
    float* st = smem + (box % kStages) * kStage;
    const int kb = box / per_tile;
    const int idx = box - kb * per_tile;
    if (idx < n_sbox) {
      if constexpr (!Shape::kHoldQ) {
        load_box<kRows, kBoxCols, kBoxStride>(st, qm, q0, sq,
                                              idx * kBoxCols, d);
      }
      load_box<kKeys, kBoxCols, kBoxStride>(st + Shape::kRBox - Shape::kKBox,
                                            km, kb * kKeys, sk,
                                            idx * kBoxCols, d);
    } else {
      load_box<kVKeys, kCols, kCols>(
          st, vm, kb * kKeys + (idx - n_sbox) * kVKeys, sk, c0, d);
    }
  };
  // Q * scale, each thread on the 16-byte pieces of a Q box it copied
  // (load_box's order), visible to it after cp.async's wait.
  auto scale_q = [&](float* box) {
#pragma unroll
    for (int i = 0; i < kRows * kBoxCols / 4 / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      float4* p = reinterpret_cast<float4*>(
          box + (c / (kBoxCols / 4)) * kBoxStride + (c % (kBoxCols / 4)) * 4);
      float4 x = *p;
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
      *p = x;
    }
  };

  if constexpr (Shape::kHoldQ) {
    // The block's Q, copied with the first box.
    for (int idx = 0; idx < n_sbox; ++idx) {
      load_box<kRows, kBoxCols, kBoxStride>(qh + idx * kQBox, qm, q0, sq,
                                            idx * kBoxCols, d);
    }
  }
  issue(0);
  cp_async_commit();
  if (n_boxes > 1) issue(1);
  cp_async_commit();
  for (int bx = 0; bx < n_boxes; ++bx) {
    const int kb = bx / per_tile;
    const int idx = bx - kb * per_tile;
    float* st = smem + (bx % kStages) * kStage;
    cp_async_wait_all_but_one();
    if constexpr (Shape::kHoldQ) {
      if (bx == 0) {
        for (int i = 0; i < n_sbox; ++i) scale_q(qh + i * kQBox);
      }
    } else {
      if (idx < n_sbox) scale_q(st);
    }
    // Box bx is visible to all; every thread is done with box bx - 1, whose
    // stage box bx + 2 now takes.
    __syncthreads();
    if (bx + 2 < n_boxes) issue(bx + 2);
    cp_async_commit();

    if (idx < n_sbox) {
      if (idx == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < kKeyTiles; ++j) s[i][j] = 0.f;
        }
      }
      const float* qs = Shape::kHoldQ ? qh + idx * kQBox : st;
      const float* ks = st + Shape::kRBox - Shape::kKBox;
#pragma unroll
      for (int kk = 0; kk < kBoxCols; kk += 4) {
        float4 a[8];
        float4 bk[kKeyTiles];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          a[i] = ld4(qs + (ty + kTy * i) * kBoxStride + kk);
        }
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
          bk[j] = ld4(ks + (tx + kTx * j) * kBoxStride + kk);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < kKeyTiles; ++j) {
            s[i][j] = dot4(a[i], bk[j], s[i][j]);
          }
        }
      }
      if (idx == n_sbox - 1) {
        // The tile's scores to P^T, then the online softmax over them.
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j < kKeyTiles; ++j) {
            pt[(tx + kTx * j) * kPStride + ty + kTy * i] = s[i][j];
          }
        }
        __syncthreads();
        const int k0 = kb * kKeys;
        float x[kKeys / kParts];
        float tile_max = kNegInf;
#pragma unroll
        for (int e = 0; e < kKeys / kParts; ++e) {
          const int key = spart + kParts * e;
          const int kj = k0 + key;
          const bool keep = kj < sk && (!causal || kj <= sqi);
          x[e] = keep ? pt[key * kPStride + srow] : kNegInf;
          tile_max = fmaxf(tile_max, x[e]);
        }
#pragma unroll
        for (int lanes = 1; lanes < kParts; lanes *= 2) {
          tile_max =
              fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, lanes));
        }
        const float m_new = fmaxf(m, tile_max);
        const float alpha = expf(m - m_new);
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < kKeys / kParts; ++e) {
          const float p = expf(x[e] - m_new);
          pt[(spart + kParts * e) * kPStride + srow] = p;
          sum += p;
        }
#pragma unroll
        for (int lanes = 1; lanes < kParts; lanes *= 2) {
          sum += __shfl_xor_sync(0xffffffffu, sum, lanes);
        }
        l = l * alpha + sum;
        m = m_new;
        if (spart == 0) alpha_s[srow] = alpha;
        // P and alpha are read after the next box's barrier.
      }
    } else {
      const int vb = idx - n_sbox;
      if (vb == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = alpha_s[8 * ty + i];
#pragma unroll
          for (int c = 0; c < kThreadCols; ++c) acc[i][c] *= a;
        }
      }
      const float* vs = st;
      const float* pb = pt + vb * kVKeys * kPStride + 8 * ty;
#pragma unroll 8
      for (int kk = 0; kk < kVKeys; ++kk) {
        float p[8];
        unpack8(p, ld4(pb + kk * kPStride), ld4(pb + kk * kPStride + 4));
#pragma unroll
        for (int j = 0; j < kThreadCols / 4; ++j) {
          const float4 vv = ld4(vs + kk * kCols + 4 * tx + 4 * kTx * j);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float* a = acc[i] + 4 * j;
            a[0] = fmaf(p[i], vv.x, a[0]);
            a[1] = fmaf(p[i], vv.y, a[1]);
            a[2] = fmaf(p[i], vv.z, a[2]);
            a[3] = fmaf(p[i], vv.w, a[3]);
          }
        }
      }
    }
  }

  if (spart == 0) {
    const float l_safe = fmaxf(l, 1e-30f);
    inv_l_s[srow] = 1.f / l_safe;
    if (slice == 0 && sqi < sq) lse[(size_t)bh * sq + sqi] = m + logf(l_safe);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + 8 * ty + i;
    if (row >= sq) continue;
    const float inv = inv_l_s[8 * ty + i];
    float* orow = o + ((size_t)bh * sq + row) * d;
#pragma unroll
    for (int j = 0; j < kThreadCols / 4; ++j) {
      const int col = c0 + 4 * tx + 4 * kTx * j;
      if (col < d) {
        const float* a = acc[i] + 4 * j;
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(a[0] * inv, a[1] * inv, a[2] * inv, a[3] * inv);
      }
    }
  }
}

// --------------------------------------------------------------- dK/dV
// The largest power of two p <= most with p <= limit.
constexpr int fit_pow2(int limit, int most) {
  return most <= limit ? most : fit_pow2(limit, most / 2);
}

// A dK/dV block: kKeys keys x kCols columns of dK and of dV, 64-row query
// tiles streamed over them, kBoxCols columns of D per reduction box.
template <int kKeys_, int kCols_, int kBoxCols_>
struct DkvShape {
  static constexpr int kKeys = kKeys_;
  static constexpr int kCols = kCols_;
  static constexpr int kBoxCols = kBoxCols_;
  static constexpr int kRows = 64;                 // query rows per tile
  static constexpr int kBoxStride = kBoxCols + 4;  // padded row of a box
  static constexpr int kKeyTiles = kKeys / 16;     // S^T: keys ry + 16 i
  static constexpr int kTy = kKeys / 8;            // dK, dV: 8 keys a thread
  static constexpr int kTx = kThreads / kTy;
  static constexpr int kThreadCols = kCols / kTx;  // a thread's columns
  static constexpr int kKBox = kKeys * kBoxStride;   // K or V
  static constexpr int kQBox = kRows * kBoxStride;   // Q or dO
  static constexpr int kRowVals = 2 * kKBox + 2 * kQBox;   // LSE, delta
  static constexpr int kStage = kRowVals + 2 * kRows;
  // Query rows per product box (Q and dO over the block's columns).
  static constexpr int kPRows = fit_pow2(kStage / (2 * kCols), kRows);
  static constexpr int kPBoxes = kRows / kPRows;
  static constexpr int kPStride = kKeys + 4;  // P, dS: a row of kKeys a query
  static constexpr int kSmemFloats = kStages * kStage + 2 * kRows * kPStride;
  static constexpr int kSmemBytes = kSmemFloats * 4;
  static_assert(kKeys % 16 == 0 && kTy * kTx == kThreads && kTx % 8 == 0 &&
                    kThreadCols % 4 == 0 && kBoxCols % 16 == 0,
                "thread tiles of whole float4s");
  static_assert(kSmemBytes <= 232448, "227 KB a block");
};

template <class Shape>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_wide_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int sq, int sk, int d, int n_slices,
                              float scale, int causal) {
  constexpr int kKeys = Shape::kKeys;
  constexpr int kRows = Shape::kRows;
  constexpr int kCols = Shape::kCols;
  constexpr int kBoxCols = Shape::kBoxCols;
  constexpr int kBoxStride = Shape::kBoxStride;
  constexpr int kKeyTiles = Shape::kKeyTiles;
  constexpr int kTx = Shape::kTx;
  constexpr int kThreadCols = Shape::kThreadCols;
  constexpr int kKBox = Shape::kKBox;
  constexpr int kQBox = Shape::kQBox;
  constexpr int kRowVals = Shape::kRowVals;
  constexpr int kStage = Shape::kStage;
  constexpr int kPRows = Shape::kPRows;
  constexpr int kPBoxes = Shape::kPBoxes;
  constexpr int kPStride = Shape::kPStride;
  extern __shared__ __align__(16) float smem[];
  float* ps = smem + kStages * kStage;    // P [kRows][kPStride]
  float* dss = ps + kRows * kPStride;     // dS [kRows][kPStride]

  const int bh = blockIdx.x / n_slices;
  const int slice = blockIdx.x - bh * n_slices;
  const int k0 = blockIdx.y * kKeys;
  const int c0 = slice * kCols;
  const float* qm = q + (size_t)bh * sq * d;
  const float* dom = dout + (size_t)bh * sq * d;
  const float* km = k + (size_t)bh * sk * d;
  const float* vm = v + (size_t)bh * sk * d;
  const float* lsem = lse + (size_t)bh * sq;
  const float* deltam = delta + (size_t)bh * sq;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // S^T and dP^T: keys ry + 16 i, query rows rx + 16 j (a warp: 4 x 8).
  const int ry = (warp / 2) * 4 + lane / 8;
  const int rx = (warp % 2) * 8 + lane % 8;
  // dK and dV: keys 8 ty + i, columns 4 tx + 4 kTx j + e (a warp: 4 x 8).
  const int ty = (warp / (kTx / 8)) * 4 + lane / 8;
  const int tx = (warp % (kTx / 8)) * 8 + lane % 8;

  float dk_acc[8][kThreadCols];
  float dv_acc[8][kThreadCols];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < kThreadCols; ++e) {
      dk_acc[i][e] = 0.f;
      dv_acc[i][e] = 0.f;
    }
  }
  float s[kKeyTiles][4];
  float dp[kKeyTiles][4];

  const int n_qb = (sq + kRows - 1) / kRows;
  // Causal: query tiles that end before this block's first key are masked.
  const int qb0 = causal ? min(k0 / kRows, n_qb) : 0;
  const int n_rbox = (d + kBoxCols - 1) / kBoxCols;
  const int per_tile = n_rbox + kPBoxes;
  const int n_boxes = (n_qb - qb0) * per_tile;

  // Per query tile: n_rbox boxes of K, V, Q and dO over D (the last with
  // the tile's LSE and delta), then kPBoxes boxes of Q and dO over the
  // block's columns.
  auto issue = [&](int box) {
    float* st = smem + (box % kStages) * kStage;
    const int tile = box / per_tile;
    const int idx = box - tile * per_tile;
    const int q0 = (qb0 + tile) * kRows;
    if (idx < n_rbox) {
      const int col0 = idx * kBoxCols;
      load_box<kKeys, kBoxCols, kBoxStride>(st, km, k0, sk, col0, d);
      load_box<kKeys, kBoxCols, kBoxStride>(st + kKBox, vm, k0, sk, col0, d);
      load_box<kRows, kBoxCols, kBoxStride>(st + 2 * kKBox, qm, q0, sq, col0,
                                            d);
      load_box<kRows, kBoxCols, kBoxStride>(st + 2 * kKBox + kQBox, dom, q0,
                                            sq, col0, d);
      if (idx == n_rbox - 1 && threadIdx.x < 2 * kRows) {
        const int r = threadIdx.x % kRows;
        const float* src = threadIdx.x < kRows ? lsem : deltam;
        const bool valid = q0 + r < sq;
        cp_async4(st + kRowVals + threadIdx.x, valid ? src + q0 + r : src,
                  valid);
      }
    } else {
      const int r0 = q0 + (idx - n_rbox) * kPRows;
      load_box<kPRows, kCols, kCols>(st, qm, r0, sq, c0, d);
      load_box<kPRows, kCols, kCols>(st + kPRows * kCols, dom, r0, sq, c0,
                                     d);
    }
  };

  if (n_boxes > 0) issue(0);
  cp_async_commit();
  if (n_boxes > 1) issue(1);
  cp_async_commit();
  for (int bx = 0; bx < n_boxes; ++bx) {
    const int tile = bx / per_tile;
    const int idx = bx - tile * per_tile;
    const int q0 = (qb0 + tile) * kRows;
    const float* st = smem + (bx % kStages) * kStage;
    cp_async_wait_all_but_one();
    // Box bx is visible to all; every thread is done with box bx - 1, whose
    // stage box bx + 2 now takes.
    __syncthreads();
    if (bx + 2 < n_boxes) issue(bx + 2);
    cp_async_commit();

    if (idx < n_rbox) {
      if (idx == 0) {
#pragma unroll
        for (int i = 0; i < kKeyTiles; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = 0.f;
            dp[i][j] = 0.f;
          }
        }
      }
      const float* ks = st;
      const float* vs = st + kKBox;
      const float* qs = st + 2 * kKBox;
      const float* ds = st + 2 * kKBox + kQBox;
#pragma unroll
      for (int kk = 0; kk < kBoxCols; kk += 4) {
        float4 kf[kKeyTiles];
        float4 qf[4];
#pragma unroll
        for (int i = 0; i < kKeyTiles; ++i) {
          kf[i] = ld4(ks + (ry + 16 * i) * kBoxStride + kk);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qf[j] = ld4(qs + (rx + 16 * j) * kBoxStride + kk);
        }
#pragma unroll
        for (int i = 0; i < kKeyTiles; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dot4(kf[i], qf[j], s[i][j]);
        }
        float4 vf[kKeyTiles];
        float4 df[4];
#pragma unroll
        for (int i = 0; i < kKeyTiles; ++i) {
          vf[i] = ld4(vs + (ry + 16 * i) * kBoxStride + kk);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          df[j] = ld4(ds + (rx + 16 * j) * kBoxStride + kk);
        }
#pragma unroll
        for (int i = 0; i < kKeyTiles; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dp[i][j] = dot4(vf[i], df[j], dp[i][j]);
          }
        }
      }
      if (idx == n_rbox - 1) {
        // P = exp(scale * S - LSE) and dS = P * (dP - delta) of the tile,
        // read after the next box's barrier.
        const float* lse_s = st + kRowVals;
        const float* delta_s = lse_s + kRows;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = rx + 16 * j;
          const int qi = q0 + row;
          const float row_lse = lse_s[row];
          const float row_delta = delta_s[row];
#pragma unroll
          for (int i = 0; i < kKeyTiles; ++i) {
            const int key = ry + 16 * i;
            const int kj = k0 + key;
            const bool keep = kj < sk && qi < sq && (!causal || kj <= qi);
            const float p = keep ? expf(s[i][j] * scale - row_lse) : 0.f;
            ps[row * kPStride + key] = p;
            dss[row * kPStride + key] = p * (dp[i][j] - row_delta);
          }
        }
      }
    } else {
      const int pb = idx - n_rbox;
      const float* qs = st;
      const float* ds = st + kPRows * kCols;
      const float* prow = ps + pb * kPRows * kPStride + 8 * ty;
      const float* dsrow = dss + pb * kPRows * kPStride + 8 * ty;
#pragma unroll 8
      for (int r = 0; r < kPRows; ++r) {
        float p[8];
        float dsv[8];
        unpack8(p, ld4(prow + r * kPStride), ld4(prow + r * kPStride + 4));
        unpack8(dsv, ld4(dsrow + r * kPStride),
                ld4(dsrow + r * kPStride + 4));
#pragma unroll
        for (int j = 0; j < kThreadCols / 4; ++j) {
          const float4 dov = ld4(ds + r * kCols + 4 * tx + 4 * kTx * j);
          const float4 qv = ld4(qs + r * kCols + 4 * tx + 4 * kTx * j);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float* a = dv_acc[i] + 4 * j;
            float* g = dk_acc[i] + 4 * j;
            a[0] = fmaf(p[i], dov.x, a[0]);
            a[1] = fmaf(p[i], dov.y, a[1]);
            a[2] = fmaf(p[i], dov.z, a[2]);
            a[3] = fmaf(p[i], dov.w, a[3]);
            g[0] = fmaf(dsv[i], qv.x, g[0]);
            g[1] = fmaf(dsv[i], qv.y, g[1]);
            g[2] = fmaf(dsv[i], qv.z, g[2]);
            g[3] = fmaf(dsv[i], qv.w, g[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int kj = k0 + 8 * ty + i;
    if (kj >= sk) continue;
#pragma unroll
    for (int j = 0; j < kThreadCols / 4; ++j) {
      const int col = c0 + 4 * tx + 4 * kTx * j;
      if (col >= d) continue;
      const size_t off = ((size_t)bh * sk + kj) * d + col;
      const float* g = dk_acc[i] + 4 * j;
      const float* a = dv_acc[i] + 4 * j;
      *reinterpret_cast<float4*>(dk + off) =
          make_float4(g[0] * scale, g[1] * scale, g[2] * scale, g[3] * scale);
      *reinterpret_cast<float4*>(dv + off) =
          make_float4(a[0], a[1], a[2], a[3]);
    }
  }
}

// ------------------------------------------------------------------ dQ
// A dQ block: kRows query rows x kCols columns of dQ, 64-key tiles
// streamed over them, kBoxCols columns of D per reduction box.
// kDeltaInDpOrder: delta = rowsum(dO * O) is summed as dP is, in the same
// per-box pieces and order, so that dP - delta is exactly 0 wherever O's
// row is the key's V row (a causal first row: its dQ is exactly 0); else
// four threads a row sum it in strides of 16 columns.
template <int kRows_, int kCols_, int kBoxCols_, bool kDeltaInDpOrder_>
struct DqShape {
  static constexpr int kRows = kRows_;
  static constexpr int kCols = kCols_;
  static constexpr int kBoxCols = kBoxCols_;
  static constexpr bool kDeltaInDpOrder = kDeltaInDpOrder_;
  static constexpr int kKeys = 64;                 // keys per tile
  static constexpr int kBoxStride = kBoxCols + 4;  // padded row of a box
  static constexpr int kRowTiles = kRows / 16;     // S: rows ry + 16 i
  static constexpr int kTy = kRows / 8;            // dQ: 8 rows a thread
  static constexpr int kTx = kThreads / kTy;
  static constexpr int kThreadCols = kCols / kTx;  // a thread's columns
  static constexpr int kQBox = kRows * kBoxStride;   // Q or dO
  static constexpr int kKBox = kKeys * kBoxStride;   // K or V
  static constexpr int kStage = 2 * kQBox + 2 * kKBox;
  // Keys per product box (K over the block's columns).
  static constexpr int kPKeys = fit_pow2(kStage / kCols, kKeys);
  static constexpr int kPBoxes = kKeys / kPKeys;
  static constexpr int kPStride = kRows + 4;  // dS^T: a row of kRows a key
  static constexpr int kSmemFloats =
      kStages * kStage + kKeys * kPStride + 2 * kRows;
  static constexpr int kSmemBytes = kSmemFloats * 4;
  static_assert(kRows % 16 == 0 && kTy * kTx == kThreads && kTx % 8 == 0 &&
                    kThreadCols % 4 == 0 && kBoxCols % 16 == 0,
                "thread tiles of whole float4s");
  static_assert(kDeltaInDpOrder || kRows * 4 == kThreads,
                "four threads a row sum delta");
  static_assert(kSmemBytes <= 232448, "227 KB a block");
};

template <class Shape>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wide_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ o,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             float* __restrict__ dq,
                             float* __restrict__ delta, int sq, int sk,
                             int d, int n_slices, float scale, int causal) {
  constexpr int kRows = Shape::kRows;
  constexpr int kKeys = Shape::kKeys;
  constexpr int kCols = Shape::kCols;
  constexpr int kBoxCols = Shape::kBoxCols;
  constexpr int kBoxStride = Shape::kBoxStride;
  constexpr int kRowTiles = Shape::kRowTiles;
  constexpr int kTx = Shape::kTx;
  constexpr int kThreadCols = Shape::kThreadCols;
  constexpr int kQBox = Shape::kQBox;
  constexpr int kKBox = Shape::kKBox;
  constexpr int kStage = Shape::kStage;
  constexpr int kPKeys = Shape::kPKeys;
  constexpr int kPBoxes = Shape::kPBoxes;
  constexpr int kPStride = Shape::kPStride;
  extern __shared__ __align__(16) float smem[];
  float* dss = smem + kStages * kStage;   // dS^T [kKeys][kPStride]
  float* lse_s = dss + kKeys * kPStride;  // per row of the block
  float* delta_s = lse_s + kRows;

  const int bh = blockIdx.x / n_slices;
  const int slice = blockIdx.x - bh * n_slices;
  // The last query rows (the most key tiles when causal) first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int c0 = slice * kCols;
  const float* qm = q + (size_t)bh * sq * d;
  const float* dom = dout + (size_t)bh * sq * d;
  const float* km = k + (size_t)bh * sk * d;
  const float* vm = v + (size_t)bh * sk * d;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // S and dP: query rows ry + 16 i, keys rx + 16 j (a warp: 4 x 8).
  const int ry = (warp / 2) * 4 + lane / 8;
  const int rx = (warp % 2) * 8 + lane % 8;
  // dQ: rows 8 ty + i, columns 4 tx + 4 kTx j + e (a warp: 4 x 8).
  const int ty = (warp / (kTx / 8)) * 4 + lane / 8;
  const int tx = (warp % (kTx / 8)) * 8 + lane % 8;

  // delta = rowsum(dO * O) and LSE of the block's rows, read once; the
  // blocks of the first slice write delta for the dK/dV kernel. Read after
  // the first box's barrier.
  if constexpr (Shape::kDeltaInDpOrder) {
    if (threadIdx.x < kRows) {
      const int r = threadIdx.x;
      const int qi = q0 + r;
      float sum = 0.f;
      if (qi < sq) {
        const float* dor = dom + (size_t)qi * d;
        const float* orow = o + ((size_t)bh * sq + qi) * d;
        for (int col0 = 0; col0 < d; col0 += kBoxCols) {
          // One box's piece, a chain over its columns as dP's partials.
          float piece = 0.f;
          const int end = min(col0 + kBoxCols, d);
          for (int col = col0; col < end; col += 4) {
            piece = dot4(ld4(dor + col), ld4(orow + col), piece);
          }
          sum += piece;
        }
      }
      delta_s[r] = sum;
      lse_s[r] = qi < sq ? lse[(size_t)bh * sq + qi] : 0.f;
      if (slice == 0 && qi < sq) delta[(size_t)bh * sq + qi] = sum;
    }
  } else {
    const int r = threadIdx.x / 4;
    const int part = threadIdx.x % 4;
    const int qi = q0 + r;
    float sum = 0.f;
    if (qi < sq) {
      const float* dor = dom + (size_t)qi * d;
      const float* orow = o + ((size_t)bh * sq + qi) * d;
      for (int col = 4 * part; col < d; col += 16) {
        sum += dot4(ld4(dor + col), ld4(orow + col), 0.f);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0) {
      delta_s[r] = sum;
      lse_s[r] = qi < sq ? lse[(size_t)bh * sq + qi] : 0.f;
      if (slice == 0 && qi < sq) delta[(size_t)bh * sq + qi] = sum;
    }
  }

  float acc[8][kThreadCols];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < kThreadCols; ++e) acc[i][e] = 0.f;
  }
  float s[kRowTiles][4];
  float dp[kRowTiles][4];

  // Causal: key tiles past this block's last query row are masked.
  int n_kt = (sk + kKeys - 1) / kKeys;
  if (causal) n_kt = min(n_kt, (min(q0 + kRows, sq) - 1) / kKeys + 1);
  const int n_rbox = (d + kBoxCols - 1) / kBoxCols;
  const int per_tile = n_rbox + kPBoxes;
  const int n_boxes = n_kt * per_tile;

  // Per key tile: n_rbox boxes of Q, dO, K and V over D, then kPBoxes
  // boxes of K over the block's columns.
  auto issue = [&](int box) {
    float* st = smem + (box % kStages) * kStage;
    const int tile = box / per_tile;
    const int idx = box - tile * per_tile;
    const int k0 = tile * kKeys;
    if (idx < n_rbox) {
      const int col0 = idx * kBoxCols;
      load_box<kRows, kBoxCols, kBoxStride>(st, qm, q0, sq, col0, d);
      load_box<kRows, kBoxCols, kBoxStride>(st + kQBox, dom, q0, sq, col0,
                                            d);
      load_box<kKeys, kBoxCols, kBoxStride>(st + 2 * kQBox, km, k0, sk, col0,
                                            d);
      load_box<kKeys, kBoxCols, kBoxStride>(st + 2 * kQBox + kKBox, vm, k0,
                                            sk, col0, d);
    } else {
      load_box<kPKeys, kCols, kCols>(st, km, k0 + (idx - n_rbox) * kPKeys,
                                     sk, c0, d);
    }
  };

  issue(0);
  cp_async_commit();
  if (n_boxes > 1) issue(1);
  cp_async_commit();
  for (int bx = 0; bx < n_boxes; ++bx) {
    const int tile = bx / per_tile;
    const int idx = bx - tile * per_tile;
    const int k0 = tile * kKeys;
    const float* st = smem + (bx % kStages) * kStage;
    cp_async_wait_all_but_one();
    // Box bx is visible to all; every thread is done with box bx - 1, whose
    // stage box bx + 2 now takes.
    __syncthreads();
    if (bx + 2 < n_boxes) issue(bx + 2);
    cp_async_commit();

    if (idx < n_rbox) {
      if (idx == 0) {
#pragma unroll
        for (int i = 0; i < kRowTiles; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = 0.f;
            dp[i][j] = 0.f;
          }
        }
      }
      // Each box's sums of dP start from 0 and are added to the tile's
      // once done: shorter chains of rounding than one chain over all of D
      // (dP - delta cancels where dO and V are large).
      float dpb[kRowTiles][4];
#pragma unroll
      for (int i = 0; i < kRowTiles; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) dpb[i][j] = 0.f;
      }
      const float* qs = st;
      const float* ds = st + kQBox;
      const float* ks = st + 2 * kQBox;
      const float* vs = st + 2 * kQBox + kKBox;
#pragma unroll
      for (int kk = 0; kk < kBoxCols; kk += 4) {
        float4 qf[kRowTiles];
        float4 kf[4];
#pragma unroll
        for (int i = 0; i < kRowTiles; ++i) {
          qf[i] = ld4(qs + (ry + 16 * i) * kBoxStride + kk);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kf[j] = ld4(ks + (rx + 16 * j) * kBoxStride + kk);
        }
#pragma unroll
        for (int i = 0; i < kRowTiles; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dot4(qf[i], kf[j], s[i][j]);
        }
        float4 df[kRowTiles];
        float4 vf[4];
#pragma unroll
        for (int i = 0; i < kRowTiles; ++i) {
          df[i] = ld4(ds + (ry + 16 * i) * kBoxStride + kk);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          vf[j] = ld4(vs + (rx + 16 * j) * kBoxStride + kk);
        }
#pragma unroll
        for (int i = 0; i < kRowTiles; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dpb[i][j] = dot4(df[i], vf[j], dpb[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRowTiles; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] += dpb[i][j];
      }
      if (idx == n_rbox - 1) {
        // dS = P * (dP - delta) with P = exp(scale * S - LSE), to dS^T in
        // shared memory, read after the next box's barrier.
#pragma unroll
        for (int i = 0; i < kRowTiles; ++i) {
          const int row = ry + 16 * i;
          const int qi = q0 + row;
          const float row_lse = lse_s[row];
          const float row_delta = delta_s[row];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = rx + 16 * j;
            const int kj = k0 + key;
            const bool keep = kj < sk && qi < sq && (!causal || kj <= qi);
            const float p = keep ? expf(s[i][j] * scale - row_lse) : 0.f;
            dss[key * kPStride + row] = p * (dp[i][j] - row_delta);
          }
        }
      }
    } else {
      const int pb = idx - n_rbox;
      const float* ks = st;
      const float* dsrow = dss + pb * kPKeys * kPStride + 8 * ty;
#pragma unroll 8
      for (int r = 0; r < kPKeys; ++r) {
        float dsv[8];
        unpack8(dsv, ld4(dsrow + r * kPStride), ld4(dsrow + r * kPStride + 4));
#pragma unroll
        for (int j = 0; j < kThreadCols / 4; ++j) {
          const float4 kv = ld4(ks + r * kCols + 4 * tx + 4 * kTx * j);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float* a = acc[i] + 4 * j;
            a[0] = fmaf(dsv[i], kv.x, a[0]);
            a[1] = fmaf(dsv[i], kv.y, a[1]);
            a[2] = fmaf(dsv[i], kv.z, a[2]);
            a[3] = fmaf(dsv[i], kv.w, a[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qi = q0 + 8 * ty + i;
    if (qi >= sq) continue;
#pragma unroll
    for (int j = 0; j < kThreadCols / 4; ++j) {
      const int col = c0 + 4 * tx + 4 * kTx * j;
      if (col >= d) continue;
      const float* a = acc[i] + 4 * j;
      *reinterpret_cast<float4*>(dq + ((size_t)bh * sq + qi) * d + col) =
          make_float4(a[0] * scale, a[1] * scale, a[2] * scale,
                      a[3] * scale);
    }
  }
}

// ----------------------------------------------------------- instances
// Above head_dim 256 ("wide_f32"): 64 keys x 256 columns of dK and dV,
// 64 rows x 512 columns of dQ a block, D split into slices of those
// columns. Up to 256 ("tiled_f32"): one block covers all of D, the
// narrowest instance whose columns reach D (the columns past D
// zero-filled and never stored); at narrow D a block takes more keys or
// rows, so that a thread's tile of the output keeps 8 rows of whole
// float4s. dQ at D <= 64 keeps 32 accumulators a thread: 64 take 256 rows
// a block, whose 256 floats of S, dP and dP's per-box partials a thread
// spill (364 bytes) and ran 1.6x slower on an H100 (flash_ab.py --f32,
// variant tiled_dq64_rows256).
using FwdWide = FwdShape<64, 128, 256, 32, false>;   // 64 f32 of O a thread
using FwdTiled64 = FwdShape<128, 128, 64, 128, true>;   // 32 a thread
using FwdTiled128 = FwdShape<128, 128, 128, 32, true>;  // 64 a thread
using FwdTiled256 = FwdShape<64, 128, 256, 32, true>;  // FwdWide, Q held
using DkvWide = DkvShape<64, 256, 32>;       // 128 f32 of dK, dV a thread
using DkvTiled64 = DkvShape<128, 64, 16>;    // 64 a thread, D <= 64
using DkvTiled128 = DkvShape<64, 128, 32>;   // 64 a thread, D <= 128
using DkvTiled256 = DkvWide;                 // D <= 256: the real work
using DqWide = DqShape<64, 512, 32, false>;  // 128 f32 of dQ a thread
using DqTiled64 = DqShape<128, 64, 32, true>;     // 32 a thread
using DqTiled128 = DqShape<128, 128, 32, true>;   // 64 a thread
using DqTiled256 = DqShape<64, 256, 32, true>;    // 64 a thread

bool misaligned(const void* p) { return (uintptr_t)p % 16 != 0; }

bool bad_bwd_shape(int bh, int sq, int sk, int d, int dtype, long long rows,
                   long long slices) {
  return dtype != 0 || bh < 1 || sq < 1 || sk < 1 || d < 8 || d % 8 != 0 ||
         rows > 65535 || bh * slices > 0x7fffffffLL;
}

template <class Shape>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int batch, int hq, int hkv, int sq, int sk, int d,
               float scale, int causal, int dtype, void* stream) {
  const int n_qb = (sq + Shape::kRows - 1) / Shape::kRows;
  const int n_slices = (d + Shape::kCols - 1) / Shape::kCols;
  if (dtype != 0 || batch < 1 || hq < 1 || hkv < 1 || hq % hkv != 0 ||
      sq < 1 || sk < 1 || d < 8 || d % 8 != 0 || n_qb > 65535 ||
      (Shape::kHoldQ && n_slices != 1) ||
      (long long)batch * hq * n_slices > 0x7fffffffLL || misaligned(q) ||
      misaligned(k) || misaligned(v) || misaligned(o)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_f32_kernel<Shape>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(batch * hq * n_slices, n_qb);
  flash_fwd_wide_f32_kernel<Shape>
      <<<grid, kThreads, Shape::kSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o),
          static_cast<float*>(lse), hq, hkv, sq, sk, d, n_slices, scale,
          causal);
  return (int)cudaGetLastError();
}

template <class Shape>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int bh, int sq, int sk, int d, float scale, int causal,
               int dtype, void* stream) {
  const int n_kb = (sk + Shape::kKeys - 1) / Shape::kKeys;
  const int n_slices = (d + Shape::kCols - 1) / Shape::kCols;
  if (bad_bwd_shape(bh, sq, sk, d, dtype, n_kb, n_slices) || misaligned(q) ||
      misaligned(k) || misaligned(v) || misaligned(dout) || misaligned(dk) ||
      misaligned(dv) || lse == nullptr || delta == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_wide_f32_kernel<Shape>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh * n_slices, n_kb);
  flash_bwd_dkv_wide_f32_kernel<Shape>
      <<<grid, kThreads, Shape::kSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<float*>(dk), static_cast<float*>(dv), sq, sk, d,
          n_slices, scale, causal);
  return (int)cudaGetLastError();
}

template <class Shape>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* dq, void* delta,
              int bh, int sq, int sk, int d, float scale, int causal,
              int dtype, void* stream) {
  const int n_qb = (sq + Shape::kRows - 1) / Shape::kRows;
  const int n_slices = (d + Shape::kCols - 1) / Shape::kCols;
  if (bad_bwd_shape(bh, sq, sk, d, dtype, n_qb, n_slices) || misaligned(q) ||
      misaligned(k) || misaligned(v) || misaligned(o) || misaligned(dout) ||
      misaligned(dq) || lse == nullptr || delta == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wide_f32_kernel<Shape>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bh * n_slices, n_qb);
  flash_bwd_dq_wide_f32_kernel<Shape>
      <<<grid, kThreads, Shape::kSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(o),
          static_cast<const float*>(dout), static_cast<const float*>(lse),
          static_cast<float*>(dq), static_cast<float*>(delta), sq, sk, d,
          n_slices, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Hq, Sq, D], k/v [B, Hkv, Sk, D], o [B, Hq, Sq, D] f32 (contiguous,
// 16-byte aligned), lse [B, Hq, Sq] f32; D any multiple of 8; dtype must
// be 0 (float32). The arguments of flash_attention_fwd_wide. Returns a
// cudaError_t.
extern "C" int flash_attention_fwd_wide_f32(const void* q, const void* k,
                                            const void* v, void* o,
                                            void* lse, int batch, int hq,
                                            int hkv, int sq, int sk, int d,
                                            float scale, int causal,
                                            int dtype, void* stream) {
  return launch_fwd<FwdWide>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d,
                             scale, causal, dtype, stream);
}

// q, dout [B*H, Sq, D], k, v, dk, dv [B*H, Sk, D] f32 (contiguous, 16-byte
// aligned; D any multiple of 8); lse and delta = rowsum(dO * O) [B*H, Sq]
// f32; dtype must be 0. The arguments of
// flash_attention_bwd_dkv_wide_wgmma. Every D runs the wide instance
// (256-column slices).
extern "C" int flash_attention_bwd_dkv_wide_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
    int sk, int d, float scale, int causal, int dtype, void* stream) {
  return launch_dkv<DkvWide>(q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
                             d, scale, causal, dtype, stream);
}

// q, o, dout, dq [B*H, Sq, D], k, v [B*H, Sk, D] f32 (contiguous, 16-byte
// aligned; D any multiple of 8); lse [B*H, Sq] f32 as the forward writes
// it; delta [B*H, Sq] f32, written with rowsum(dO * O) for the dK/dV kernel
// (not null); dtype must be 0. The arguments of flash_attention_bwd_dq_wide.
// Every D runs the wide instance (512-column slices).
extern "C" int flash_attention_bwd_dq_wide_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* delta, int bh, int sq,
    int sk, int d, float scale, int causal, int dtype, void* stream) {
  return launch_dq<DqWide>(q, k, v, o, dout, lse, dq, delta, bh, sq, sk, d,
                           scale, causal, dtype, stream);
}


// The arguments of flash_attention_bwd_dkv_wide_f32, D a multiple of 8 up
// to 256: the tiled instance whose columns reach D.
extern "C" int flash_attention_bwd_dkv_tiled_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
    int sk, int d, float scale, int causal, int dtype, void* stream) {
  if (d <= DkvTiled64::kCols) {
    return launch_dkv<DkvTiled64>(q, k, v, dout, lse, delta, dk, dv, bh, sq,
                                  sk, d, scale, causal, dtype, stream);
  }
  if (d <= DkvTiled128::kCols) {
    return launch_dkv<DkvTiled128>(q, k, v, dout, lse, delta, dk, dv, bh,
                                   sq, sk, d, scale, causal, dtype, stream);
  }
  if (d <= DkvTiled256::kCols) {
    return launch_dkv<DkvTiled256>(q, k, v, dout, lse, delta, dk, dv, bh,
                                   sq, sk, d, scale, causal, dtype, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The arguments of flash_attention_bwd_dq_wide_f32, D a multiple of 8 up to
// 256: the tiled instance whose columns reach D; delta is summed in dP's
// order.
extern "C" int flash_attention_bwd_dq_tiled_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* delta, int bh, int sq,
    int sk, int d, float scale, int causal, int dtype, void* stream) {
  if (d <= DqTiled64::kCols) {
    return launch_dq<DqTiled64>(q, k, v, o, dout, lse, dq, delta, bh, sq, sk,
                                d, scale, causal, dtype, stream);
  }
  if (d <= DqTiled128::kCols) {
    return launch_dq<DqTiled128>(q, k, v, o, dout, lse, dq, delta, bh, sq,
                                 sk, d, scale, causal, dtype, stream);
  }
  if (d <= DqTiled256::kCols) {
    return launch_dq<DqTiled256>(q, k, v, o, dout, lse, dq, delta, bh, sq,
                                 sk, d, scale, causal, dtype, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The arguments of flash_attention_fwd_wide_f32, D a multiple of 8 up to
// 256: the tiled instance whose columns reach D.
extern "C" int flash_attention_fwd_tiled_f32(const void* q, const void* k,
                                             const void* v, void* o,
                                             void* lse, int batch, int hq,
                                             int hkv, int sq, int sk, int d,
                                             float scale, int causal,
                                             int dtype, void* stream) {
  if (d <= FwdTiled64::kCols) {
    return launch_fwd<FwdTiled64>(q, k, v, o, lse, batch, hq, hkv, sq, sk, d,
                                  scale, causal, dtype, stream);
  }
  if (d <= FwdTiled128::kCols) {
    return launch_fwd<FwdTiled128>(q, k, v, o, lse, batch, hq, hkv, sq, sk,
                                   d, scale, causal, dtype, stream);
  }
  if (d <= FwdTiled256::kCols) {
    return launch_fwd<FwdTiled256>(q, k, v, o, lse, batch, hq, hkv, sq, sk,
                                   d, scale, causal, dtype, stream);
  }
  return (int)cudaErrorInvalidValue;
}
