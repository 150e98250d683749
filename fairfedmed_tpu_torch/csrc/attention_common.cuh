// Shared pieces of the fused attention kernels (attention_fwd.cu,
// attention_bwd.cu), which replace the two Pallas TPU kernels of
// fairfedmed_tpu/ops/attention.py (_fwd_kernel and _bwd_kernel).
//
// Layout: q, k, v, o and their gradients are [n, L, D] row-major, one
// (batch*head) slice of L rows per index of n.  q arrives already multiplied
// by dh^-0.5.  The optional additive mask is fp32 [L, L] and may hold -inf.
//
// Two families of kernels share this header:
//
// * Scalar fp32 kernels (fp32 inputs, and bf16 at head width 8 or 128): 256
//   threads as a 16 x 16 grid over a 64 x 64 tile of scores.  Thread (ty, tx)
//   owns query rows ty*4 + i (i < 4) and key columns tx + 16*j (j < 4); for
//   the [64, D] products it owns rows ty*4 + i and the D columns tx + 16*c.
//   The 16 threads that share a row sit in one half-warp, so row reductions
//   are four xor-shuffles.  They keep fp32 exact to rounding.
// * Tensor-core kernels (bf16 at head width 16, 32 or 64: every CLIP tower).
//   At CLIP's lengths attention does ~2 operations per byte, so they are
//   bound by memory traffic and latency, not by the tensor cores.  What they
//   do about it: every 64-row tile goes from device memory straight into
//   shared memory with cp.async (16-byte copies, rows past L zero-filled),
//   one commit group per tile, so the first product starts as soon as its
//   tile lands and the later tiles arrive behind it; a head's tiles stay
//   resident (L <= 256) or cycle through a ring of four; and every operand
//   fragment comes from a row-major tile through ldmatrix (.trans where the
//   product needs the tile transposed), so nothing is transposed by scalar
//   stores.  The products run on mma.sync.m16n8k16 (bf16 in, fp32
//   accumulate).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace ffm {

constexpr int kBlock = 64;      // rows of a query tile and of a key tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLdP = kBlock + 4;  // row stride of a [64, 64] score tile in
                                  // shared memory: two half-warps land on
                                  // disjoint banks

template <int D>
struct Tile {
  static constexpr int kLd = D + 1;  // odd stride: column reads are conflict-free
  static constexpr int kCols = (D + 15) / 16;
  static constexpr int kFloats = kBlock * kLd;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Copies rows [row0, row0 + 64) of one [L, D] slice into a padded fp32 tile;
// rows at or past L read as zero (the ragged tail is masked, never padded in
// device memory).
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0, int L) {
  for (int idx = threadIdx.x; idx < kBlock * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx - r * D;
    const int gr = row0 + r;
    dst[r * Tile<D>::kLd + c] = gr < L ? to_float(src[(size_t)gr * D + c]) : 0.f;
  }
}

// acc[i][j] = sum_d a[ty*4+i][d] * b[tx+16j][d] over two padded [64, D] tiles.
template <int D>
__device__ __forceinline__ void tile_dot_nt(const float* a, const float* b, int ty, int tx,
                                            float acc[4][4]) {
  constexpr int ld = Tile<D>::kLd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Reductions over the 16 threads of a half-warp (the threads sharing a row).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16 inputs, head width 16, 32 or 64).
//
// Each warp owns M = 2 tiles of 16 rows of a product (32 rows) and runs
// mma.sync.m16n8k16, so every B fragment it loads feeds both row tiles: half
// the ldmatrix traffic per product, twice the independent products per warp
// (the layout of FlashAttention-2).  In a warp, lane = 4*g + t:
//   A fragment (16x16): regs {row g, cols 2t..2t+1}, {row g+8, same},
//                       {row g, cols 8+2t..}, {row g+8, cols 8+2t..}
//   B fragment (16x8):  regs {k 2t..2t+1, col g}, {k 8+2t.., col g}
//   C fragment (16x8):  c0,c1 = row g, cols 2t, 2t+1; c2,c3 = row g+8
// so the C fragments of two adjacent 8-column tiles are the A fragment of a
// 16-deep product: P and dS feed the next product from registers.  They are
// split into a bf16 high part and a bf16 low part (two products), which keeps
// them at ~16 significant bits: the TPU kernel kept P in fp32.
//
// Tiles sit in shared memory as bf16, row-major [64][D+8].  The +8 padding
// (16 bytes) puts the eight 16-byte rows that one ldmatrix phase reads in
// eight different bank groups, so every fragment load is conflict-free, and
// keeps each row 16-byte aligned for cp.async.
// ---------------------------------------------------------------------------

// bf16 with a head width of 16, 32 or 64 runs on the tensor cores; fp32 (kept
// exact) and the other widths run the scalar kernels above.
template <typename T, int D>
constexpr bool kUseMma =
    std::is_same<T, __nv_bfloat16>::value && (D == 16 || D == 32 || D == 64);

constexpr int kWarpTiles = 2;  // 16-row tiles a warp owns: M above
constexpr int kRing = 4;  // 64-row tiles of one tensor resident at once: a
                          // whole head for L <= 256, else a ring

template <int D>
struct MmaTile {
  static constexpr int kLd = D + 8;    // row stride of a row-major [64][D] tile
  static constexpr int kK = D / 16;    // 16-deep steps over the head width
  static constexpr int kN = D / 8;     // 8-wide output tiles over the head width
  static constexpr int kElems = kBlock * kLd;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; copies zeros when !valid (then
// `src` is not read).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `pending` of this thread's commit groups are in flight
// (wait_group takes an immediate; a count past 7 waits for all, which is
// never too little).  The block still needs __syncthreads() to see the other
// threads' copies.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    case 7: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
  }
}

// Issues the copies of rows [row0, row0 + 64) of a bf16 [L, D] slice into a
// row-major tile; rows at or past L arrive as zeros.  All kThreadsN threads
// of the block take part; the caller commits the group.
template <int D, int kThreadsN>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* __restrict__ src, int row0,
                                                int L) {
  constexpr int chunks = D / 8;
  for (int idx = threadIdx.x; idx < kBlock * chunks; idx += kThreadsN) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    const bool valid = row0 + r < L;
    cp_async_16(dst + r * MmaTile<D>::kLd + c, valid ? src + (size_t)(row0 + r) * D + c : src,
                valid);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A fragment of rows [row0, row0+16) and columns [16kk, 16kk+16) of a
// row-major tile `s` (stride D+8).
template <int D>
__device__ __forceinline__ void frag_a(const __nv_bfloat16* s, int row0, int kk, int lane,
                                       uint32_t a[4]) {
  ldsm_x4(a, s + (row0 + (lane & 15)) * MmaTile<D>::kLd + 16 * kk + (lane >> 4) * 8);
}

// B fragments for a product with the tile transposed (B column n = tile row
// row0 + n): b[0..1] for columns row0..row0+7, b[2..3] for row0+8..row0+15,
// depth [16kk, 16kk+16) over the tile's columns.
template <int D>
__device__ __forceinline__ void frag_b_rows(const __nv_bfloat16* s, int row0, int kk, int lane,
                                            uint32_t b[4]) {
  ldsm_x4(b, s + (row0 + (lane & 7) + ((lane >> 4) << 3)) * MmaTile<D>::kLd + 16 * kk +
                 ((lane >> 3) & 1) * 8);
}

// B fragments for a product with the tile itself (B[k][n] = tile[k0 + k][n]),
// depth k0..k0+15 over the tile's rows: b[0..1] for columns 16c..16c+7,
// b[2..3] for 16c+8..16c+15.  ldmatrix.trans does the transpose.
template <int D>
__device__ __forceinline__ void frag_b_cols(const __nv_bfloat16* s, int k0, int c, int lane,
                                            uint32_t b[4]) {
  ldsm_x4_trans(b, s + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * MmaTile<D>::kLd + 16 * c +
                       (lane >> 4) * 8);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) -> bf16x2 high part and bf16x2 low part (x - high), x0 in the low
// 16 bits (the lower column).
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A fragments (high, low) of a 16-deep step taken from the C fragments of
// the two 8-column tiles c0, c1 that make up its depth.
__device__ __forceinline__ void acc_to_a(const float c0[4], const float c1[4], uint32_t hi[4],
                                         uint32_t lo[4]) {
  split_bf16x2(c0[0], c0[1], hi[0], lo[0]);
  split_bf16x2(c0[2], c0[3], hi[1], lo[1]);
  split_bf16x2(c1[0], c1[1], hi[2], lo[2]);
  split_bf16x2(c1[2], c1[3], hi[3], lo[3]);
}

// acc[m][nt] (nt < D/8) += A_m x tile[k0..k0+16, :] for the M row tiles of
// a warp, where A_m = hi[m] + lo[m] is a 16-deep fragment split in two bf16
// parts: each B fragment feeds 4 M products.
template <int D, int M>
__device__ __forceinline__ void mma_split_tile(const uint32_t hi[][4], const uint32_t lo[][4],
                                               const __nv_bfloat16* s, int k0, int lane,
                                               float acc[][MmaTile<D>::kN][4]) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    uint32_t b[4];
    frag_b_cols<D>(s, k0, c, lane, b);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      mma_bf16(acc[m][2 * c], hi[m], b[0], b[1]);
      mma_bf16(acc[m][2 * c + 1], hi[m], b[2], b[3]);
      mma_bf16(acc[m][2 * c], lo[m], b[0], b[1]);
      mma_bf16(acc[m][2 * c + 1], lo[m], b[2], b[3]);
    }
  }
}

// acc[m][2c..2c+1] = A_m (16 rows, all D columns, as kK fragments) x tile
// rows [row0, row0+16) transposed -- a 16 x 16 block of scores -- for the M
// row tiles of a warp: each B fragment feeds 2 M products.
template <int D, int M, int NT>
__device__ __forceinline__ void mma_scores(const uint32_t a[][MmaTile<D>::kK][4],
                                           const __nv_bfloat16* s, int row0, int c, int lane,
                                           float acc[][NT][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int i = 2 * c; i < 2 * c + 2; ++i)
      acc[m][i][0] = acc[m][i][1] = acc[m][i][2] = acc[m][i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < MmaTile<D>::kK; ++kk) {
    uint32_t b[4];
    frag_b_rows<D>(s, row0, kk, lane, b);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      mma_bf16(acc[m][2 * c], a[m][kk], b[0], b[1]);
      mma_bf16(acc[m][2 * c + 1], a[m][kk], b[2], b[3]);
    }
  }
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error ~2^-22, far inside bf16
// rounding); the softmax exponentials of the tensor-core kernels are
// exp(x) = 2^(x log2 e) with the scale folded into one FMA.  -inf gives 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stores a warp's [16, D] fp32 accumulator (rows row0.., C-fragment layout)
// as bf16 rows of a [L, D] slice; rows at or past L are skipped.
template <int D>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* dst, const float acc[][4],
                                                int row0, int L, int g, int t, float scale0,
                                                float scale1) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + g + 8 * half;
    if (row >= L) continue;
    const float sc = half ? scale1 : scale0;
#pragma unroll
    for (int nt = 0; nt < MmaTile<D>::kN; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * D + 8 * nt + 2 * t) =
          __floats2bfloat162_rn(acc[nt][2 * half] * sc, acc[nt][2 * half + 1] * sc);
    }
  }
}

// Fills out[0..5] for a kernel about to be launched with `blocks` blocks of
// `threads` threads and `smem` bytes of dynamic shared memory: blocks,
// threads, shared bytes per block (dynamic + static), resident blocks per
// SM, registers per thread, local (spilled) bytes per thread.
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, int blocks, int threads, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = blocks;
  out[1] = threads;
  out[2] = (int)(smem + attr.sharedSizeBytes);
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  return cudaSuccess;
}

}  // namespace ffm
