// Shared pieces of the fused attention kernels (attention_fwd.cu,
// attention_bwd.cu).
//
// Layout: q, k, v, o and their gradients are [n, L, D] row-major, one
// (batch*head) slice of L rows per index of n.  q arrives already multiplied
// by dh^-0.5.  The optional additive mask is fp32 [L, L] and may hold -inf.
//
// Every kernel runs 256 threads as a 16 x 16 grid over a 64 x 64 tile of
// scores: thread (ty, tx) owns query rows ty*4 + i (i < 4) and key columns
// tx + 16*j (j < 4).  For the [64, D] products it owns rows ty*4 + i and the
// D columns tx + 16*c (c < ceil(D/16)).  The 16 threads that share a row sit
// in one half-warp, so row reductions are four xor-shuffles.
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
// Tensor-core path (bf16 inputs, head width a multiple of 16).
//
// 128 threads = 4 warps; each warp owns 16 rows of a 64-row tile and runs
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  In a warp, lane = 4*g + t:
//   A fragment (16x16): regs {row g, cols 2t..2t+1}, {row g+8, same},
//                       {row g, cols 8+2t..}, {row g+8, cols 8+2t..}
//   B fragment (16x8):  regs {k 2t..2t+1, col g}, {k 8+2t.., col g}
//   C fragment (16x8):  c0,c1 = row g, cols 2t, 2t+1; c2,c3 = row g+8
// so the C fragments of two adjacent 8-column tiles are the A fragment of a
// 16-deep product: P and dS feed the next product from registers.  They are
// split into a bf16 high part and a bf16 low part (two products), which keeps
// them at ~16 significant bits: the TPU kernel kept P in fp32.
// Tiles sit in shared memory as bf16, row-major [64][D+8] or transposed
// [D][64+8]; the +8 padding makes the fragment loads conflict-free.
// ---------------------------------------------------------------------------

// bf16 with a head width of 16, 32 or 64 runs on the tensor cores; fp32 (kept
// exact) and the other widths run the scalar kernels above.
template <typename T, int D>
constexpr bool kUseMma =
    std::is_same<T, __nv_bfloat16>::value && (D == 16 || D == 32 || D == 64);

constexpr int kMmaThreads = 128;
constexpr int kLdT = kBlock + 8;  // row stride of a transposed [D][64] tile

template <int D>
struct MmaTile {
  static constexpr int kLd = D + 8;    // row stride of a row-major [64][D] tile
  static constexpr int kK = D / 16;    // 16-deep steps over the head width
  static constexpr int kN = D / 8;     // 8-wide output tiles over the head width
  static constexpr int kElems = kBlock * kLd;
  static constexpr int kElemsT = D * kLdT;
};

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// A fragments (high, low) of a 16-deep step over 16 keys taken from the C
// fragments of the two 8-key tiles c[2kk], c[2kk+1].
__device__ __forceinline__ void acc_to_a(const float c0[4], const float c1[4], uint32_t hi[4],
                                         uint32_t lo[4]) {
  split_bf16x2(c0[0], c0[1], hi[0], lo[0]);
  split_bf16x2(c0[2], c0[3], hi[1], lo[1]);
  split_bf16x2(c1[0], c1[1], hi[2], lo[2]);
  split_bf16x2(c1[2], c1[3], hi[3], lo[3]);
}

// A fragment for rows [row0, row0+16) and head columns [16kk, 16kk+16) of a
// row-major [64][D+8] tile.
template <int D>
__device__ __forceinline__ void load_a(const __nv_bfloat16* s, int row0, int kk, int g, int t,
                                       uint32_t a[4]) {
  constexpr int ld = MmaTile<D>::kLd;
  const __nv_bfloat16* p = s + (row0 + g) * ld + kk * 16 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// Copies rows [row0, row0+64) of a bf16 [L, D] slice into shared memory,
// row-major into `dst` and/or transposed into `dstT`; rows at or past L are
// zero.  16-byte loads (the wrapper checks the alignment).
template <int D>
__device__ __forceinline__ void load_rows_bf16(__nv_bfloat16* dst, __nv_bfloat16* dstT,
                                               const __nv_bfloat16* __restrict__ src, int row0,
                                               int L) {
  constexpr int chunks = D / 8;
  for (int idx = threadIdx.x; idx < kBlock * chunks; idx += kMmaThreads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    if (dst != nullptr) *reinterpret_cast<uint4*>(dst + r * MmaTile<D>::kLd + c) = val;
    if (dstT != nullptr) {
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int i = 0; i < 8; ++i) dstT[(c + i) * kLdT + r] = e[i];
    }
  }
}

// acc[j] (j < 8: keys 8j..8j+7 of the tile) = A rows x B, where the B
// operand's column n is row n of a row-major [64][D+8] tile `s` (so the
// product is A times the tile transposed).
template <int D>
__device__ __forceinline__ void mma_rows_nt(const uint32_t a[][4], const __nv_bfloat16* s, int g,
                                            int t, float acc[8][4]) {
  constexpr int ld = MmaTile<D>::kLd;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MmaTile<D>::kK; ++kk) {
      const __nv_bfloat16* p = s + (8 * j + g) * ld + kk * 16 + 2 * t;
      mma_bf16(acc[j], a[kk], ld32(p), ld32(p + 8));
    }
  }
}

// acc[nt] (nt < D/8) += A(16 rows x 64 keys, from c[8]) x B, where B is a
// transposed [D][64+8] tile `sT` (column n of B = row n of sT), with A split
// into high and low bf16 parts.
template <int D>
__device__ __forceinline__ void mma_acc_tn(const float c[8][4], const __nv_bfloat16* sT, int g,
                                           int t, float acc[][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], lo[4];
    acc_to_a(c[2 * kk], c[2 * kk + 1], hi, lo);
#pragma unroll
    for (int nt = 0; nt < MmaTile<D>::kN; ++nt) {
      const __nv_bfloat16* p = sT + (8 * nt + g) * kLdT + kk * 16 + 2 * t;
      const uint32_t b0 = ld32(p), b1 = ld32(p + 8);
      mma_bf16(acc[nt], hi, b0, b1);
      mma_bf16(acc[nt], lo, b0, b1);
    }
  }
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

}  // namespace ffm
