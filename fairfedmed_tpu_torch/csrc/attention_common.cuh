// Shared pieces of the fused attention kernels (attention_fwd.cu,
// attention_bwd.cu), which replace the two Pallas TPU kernels of
// fairfedmed_tpu/ops/attention.py (_fwd_kernel and _bwd_kernel), and of the
// wgmma unit check (wgmma_check.cu).
//
// Layout: q, k, v, o and their gradients are [n, L, D] row-major, one
// (batch*head) slice of L rows per index of n.  q arrives already multiplied
// by dh^-0.5.  The optional additive mask is fp32 [L, L], shared by every
// slice, and may hold -inf.
//
// Three families of kernels share this header:
//
// * Scalar fp32 kernels (fp32 inputs, and bf16 at head width 8 or 128): 256
//   threads as a 16 x 16 grid over a 64 x 64 tile of scores.  Thread (ty, tx)
//   owns query rows ty*4 + i (i < 4) and key columns tx + 16*j (j < 4); for
//   the [64, D] products it owns rows ty*4 + i and the D columns tx + 16*c.
//   The 16 threads that share a row sit in one half-warp, so row reductions
//   are four xor-shuffles.  They keep fp32 exact to rounding.
// * Packed short-row kernels (bf16, head width 16/32/64, L <= 64: the text
//   towers).  One warp owns 16 rows of a slice, and a block packs several
//   slices, so no warp is launched without rows and shared memory is sized
//   to L rounded up to 16.  Products on mma.sync.m16n8k16 with operands
//   from padded row-major tiles through ldmatrix.
// * Warpgroup kernels (bf16, head width 16/32/64, L > 64: the vision towers).
//   Each warpgroup owns a 64-row tile; products run on wgmma with B (and A,
//   where it is not a softmax output held in registers) read from shared
//   memory through matrix descriptors.  Tiles arrive by cp.async into
//   swizzled shared memory, each completing on an mbarrier.
//
// At CLIP's lengths attention does ~2 operations per byte, so every family
// is bound by memory traffic and latency, not by the tensor cores.  P and dS
// reach the tensor cores split into a bf16 high part and a bf16 low part
// (two products into one accumulator), which keeps them at ~16 significant
// bits: the TPU kernel kept P in fp32.
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
// Tensor-core pieces common to both bf16 families.
//
// mma.sync.m16n8k16 fragments, in a warp with lane = 4*g + t:
//   A fragment (16x16): regs {row g, cols 2t..2t+1}, {row g+8, same},
//                       {row g, cols 8+2t..}, {row g+8, cols 8+2t..}
//   B fragment (16x8):  regs {k 2t..2t+1, col g}, {k 8+2t.., col g}
//   C fragment (16x8):  c0,c1 = row g, cols 2t, 2t+1; c2,c3 = row g+8
// so the C fragments of two adjacent 8-column tiles are the A fragment of a
// 16-deep product: P and dS feed the next product from registers.  A wgmma
// m64nN accumulator is the same C layout per warp (warp w of the warpgroup
// holds rows 16w..16w+15, one C fragment per 8 columns), and its register A
// operand the same A layout, so both families share acc_to_a below.
// ---------------------------------------------------------------------------

// bf16 with a head width of 16, 32 or 64 runs on the tensor cores; fp32 (kept
// exact) and the other widths run the scalar kernels above.
template <typename T, int D>
constexpr bool kUseMma =
    std::is_same<T, __nv_bfloat16>::value && (D == 16 || D == 32 || D == 64);

constexpr int kPackedMaxL = 64;  // L at or below: the packed kernels

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared (address `dst` in the shared
// window); copies zeros when !valid (then `src` is not read).
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * D + 8 * nt + 2 * t) =
          __floats2bfloat162_rn(acc[nt][2 * half] * sc, acc[nt][2 * half + 1] * sc);
    }
  }
}

// rowsum(dO o O) of one row from device memory, over the D/8 consecutive
// threads that share the row (each takes 8 columns); every one of them gets
// the sum.
template <int D>
__device__ __forceinline__ float row_delta(const __nv_bfloat16* __restrict__ o,
                                           const __nv_bfloat16* __restrict__ dout, int c,
                                           bool valid) {
  float x = 0.f;
  if (valid) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(dout) + c);
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(o) + c);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(a2[i]), fb = __bfloat1622float2(b2[i]);
      x = fmaf(fa.x, fb.x, x);
      x = fmaf(fa.y, fb.y, x);
    }
  }
#pragma unroll
  for (int off = D / 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// Packed short-row kernels (L <= 64): mma.sync on padded row-major tiles.
//
// Tiles sit in shared memory as bf16, row-major [Lp][D+8] (Lp = L rounded up
// to 16).  The +8 padding (16 bytes) puts the eight 16-byte rows that one
// ldmatrix phase reads in eight different bank groups, so every fragment load
// is conflict-free, and keeps each row 16-byte aligned for cp.async.
// ---------------------------------------------------------------------------

template <int D>
struct MmaTile {
  static constexpr int kLd = D + 8;    // row stride of a row-major [rows][D] tile
  static constexpr int kK = D / 16;    // 16-deep steps over the head width
};

// Issues the copies of the first `rows` rows of a bf16 [L, D] slice into a
// padded row-major tile; rows at or past L arrive as zeros.  Thread `tid` of
// `nthreads` takes every nthreads-th 16-byte chunk; the caller commits.
template <int D>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* __restrict__ src, int rows,
                                                int L, int tid, int nthreads) {
  constexpr int chunks = D / 8;
  for (int idx = tid; idx < rows * chunks; idx += nthreads) {
    const int r = idx / chunks;
    const int c = (idx - r * chunks) * 8;
    const bool valid = r < L;
    cp_async_16(smem_addr(dst + r * MmaTile<D>::kLd + c), valid ? src + (size_t)r * D + c : src,
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

// acc[nt] (nt < D/8) += A x tile[k0..k0+16, :] for one 16-row tile, where
// A = hi + lo is a 16-deep fragment split in two bf16 parts.
template <int D>
__device__ __forceinline__ void mma_split_tile(const uint32_t hi[4], const uint32_t lo[4],
                                               const __nv_bfloat16* s, int k0, int lane,
                                               float acc[][4]) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    uint32_t b[4];
    frag_b_cols<D>(s, k0, c, lane, b);
    mma_bf16(acc[2 * c], hi, b[0], b[1]);
    mma_bf16(acc[2 * c + 1], hi, b[2], b[3]);
    mma_bf16(acc[2 * c], lo, b[0], b[1]);
    mma_bf16(acc[2 * c + 1], lo, b[2], b[3]);
  }
}

// acc[2c..2c+1] = A (16 rows, all D columns, as kK fragments) x tile rows
// [row0, row0+16) transposed: a 16 x 16 block of scores.
template <int D>
__device__ __forceinline__ void mma_scores(const uint32_t a[][4], const __nv_bfloat16* s,
                                           int row0, int c, int lane, float acc[][4]) {
#pragma unroll
  for (int i = 2 * c; i < 2 * c + 2; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < MmaTile<D>::kK; ++kk) {
    uint32_t b[4];
    frag_b_rows<D>(s, row0, kk, lane, b);
    mma_bf16(acc[2 * c], a[kk], b[0], b[1]);
    mma_bf16(acc[2 * c + 1], a[kk], b[2], b[3]);
  }
}

// ---------------------------------------------------------------------------
// Warpgroup kernels (L > 64): wgmma on swizzled tiles, mbarrier completion.
//
// A [64, D] bf16 tile is stored row-major with no padding (2D bytes a row)
// and the swizzle whose width is one row: 128 B at D = 64, 64 B at D = 32,
// 32 B at D = 16.  The 16-byte chunk c of the row at byte offset x (from a
// tile start aligned to 1024 bytes) lands at chunk c ^ ((x >> 7) & (D/8 - 1)),
// the hardware's Swizzle<log2(D/8), 4, 3>.  The same tile then serves as a
// K-major operand (S = Q K^T: rows are M or N, D is K) and as an MN-major
// one (O += P V: rows are K, D is N): one swizzle atom spans the whole head
// width, so a descriptor needs only the stride between 8-row groups, 16 D
// bytes, and a step of 16 along K is +32 bytes (K-major, inside the
// swizzled row) or +16 rows (MN-major).
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;  // rows of a warpgroup's tile (the wgmma M)

template <int D>
struct WgTile {
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kBytes = kWgRows * kRowBytes;
  static constexpr uint64_t kGroupBytes = 8 * kRowBytes;  // one 8-row group
  // descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kLayout = D == 64 ? 1 : D == 32 ? 2 : 3;
};

template <int D>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (D / 8 - 1)) << 4);
}

// Matrix descriptors (PTX "matrix descriptor"): start address >> 4 in bits
// 0-13, leading byte offset >> 4 in 16-29, stride byte offset >> 4 in 32-45,
// layout type in 62-63.  K-major: the stride byte offset steps 8 rows; the
// leading one is unused under a swizzle (1, as CUTLASS sets it).  MN-major:
// both step 8 rows along K (the stride offset is read; the leading one, the
// step between swizzle atoms along N, is unused with one atom).
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((WgTile<D>::kGroupBytes >> 4) << 32) | (WgTile<D>::kLayout << 62);
}

template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((WgTile<D>::kGroupBytes >> 4) << 16) |
         ((WgTile<D>::kGroupBytes >> 4) << 32) | (WgTile<D>::kLayout << 62);
}

// A step of 16 along K: +32 bytes in a K-major descriptor (the start address
// field counts 16-byte units).
constexpr uint64_t kDescK16 = 2;

// Issues the copies of rows [row0, row0 + 64) of a bf16 [L, D] slice into a
// swizzled tile at shared address `dst` (1024-byte aligned); rows at or past
// L arrive as zeros.  Thread `tid` of `nthreads` takes every nthreads-th
// 16-byte chunk.
template <int D>
__device__ __forceinline__ void load_tile_swizzled(uint32_t dst,
                                                   const __nv_bfloat16* __restrict__ src,
                                                   int row0, int L, int tid, int nthreads) {
  constexpr int chunks = D / 8;
  for (int idx = tid; idx < kWgRows * chunks; idx += nthreads) {
    const int r = idx / chunks;
    const bool valid = row0 + r < L;
    cp_async_16(dst + swizzle<D>(idx * 16),
                valid ? src + (size_t)(row0 + r) * D + (idx - r * chunks) * 8 : src, valid);
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The barrier's arrival of this thread, triggered once every cp.async the
// thread issued before it has landed (the count was set to the number of
// threads that arrive).
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the barrier has completed the phase of parity `parity`, then
// orders the landed data before this thread's wgmma reads (the async proxy).
// A barrier that never completes (a fault in the copies' accounting) traps
// after ~2^26 polls, seconds, rather than hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties an accumulator to this point of the program: the compiler may not
// move its reads or writes across it (after a wait, before a product).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d (+)= A B, A from shared memory (K-major descriptor da), B from shared
  // memory (descriptor db; TB = 1: MN-major).  accumulate = 0 overwrites d.
  template <int TB>
  __device__ __forceinline__ static void ss(float (&d)[2][4], uint64_t da, uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, %11;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
  }
  // d += A B, A from registers (the mma.sync A-fragment layout, warp w of
  // the warpgroup holding rows 16w..16w+15), B from shared memory.
  template <int TB>
  __device__ __forceinline__ static void rs(float (&d)[2][4], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};

template <>
struct Wgmma<32> {
  // d (+)= A B, A from shared memory (K-major descriptor da), B from shared
  // memory (descriptor db; TB = 1: MN-major).  accumulate = 0 overwrites d.
  template <int TB>
  __device__ __forceinline__ static void ss(float (&d)[4][4], uint64_t da, uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, %19;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
  }
  // d += A B, A from registers (the mma.sync A-fragment layout, warp w of
  // the warpgroup holding rows 16w..16w+15), B from shared memory.
  template <int TB>
  __device__ __forceinline__ static void rs(float (&d)[4][4], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};

template <>
struct Wgmma<48> {
  // d (+)= A B, A from shared memory (K-major descriptor da), B from shared
  // memory (descriptor db; TB = 1: MN-major).  accumulate = 0 overwrites d.
  template <int TB>
  __device__ __forceinline__ static void ss(float (&d)[6][4], uint64_t da, uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, %27;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
  }
  // d += A B, A from registers (the mma.sync A-fragment layout, warp w of
  // the warpgroup holding rows 16w..16w+15), B from shared memory.
  template <int TB>
  __device__ __forceinline__ static void rs(float (&d)[6][4], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23}, {%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  // d (+)= A B, A from shared memory (K-major descriptor da), B from shared
  // memory (descriptor db; TB = 1: MN-major).  accumulate = 0 overwrites d.
  template <int TB>
  __device__ __forceinline__ static void ss(float (&d)[8][4], uint64_t da, uint64_t db,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
  }
  // d += A B, A from registers (the mma.sync A-fragment layout, warp w of
  // the warpgroup holding rows 16w..16w+15), B from shared memory.
  template <int TB>
  __device__ __forceinline__ static void rs(float (&d)[8][4], const uint32_t (&a)[4],
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
  }
};


// ---------------------------------------------------------------------------
// Launch plans (host).  attention.py:launch_plan is the same arithmetic.
// ---------------------------------------------------------------------------

struct Plan {
  int packed;    // 1: the packed short-row kernel; 0: the warpgroup kernel
  int blocks;    // of each launch
  int threads;
  int smem;      // dynamic shared bytes
  int slices;    // (batch*head) slices per block (packed), 0 otherwise
  int groups;    // blocks per head (warpgroup kernels: groups of up to 4 tiles, or
                 // the backward's two phases), 0 otherwise
  int launches;  // kernel launches per call
};

// kind 0 = forward, 1 = backward; bf16 at d in {16, 32, 64}.
inline Plan make_plan(int kind, int n, int L, int d, int sms) {
  Plan p{};
  if (L <= kPackedMaxL) {
    const int lp = (L + 15) / 16 * 16;
    const int wps = lp / 16;  // warps per slice: 16 rows each
    int spb = 4 / wps;        // aim at 4 warps a block
    if (n / sms < spb) spb = n / sms;
    if (spb < 1) spb = 1;
    const int tile = lp * (d + 8) * 2;
    p.packed = 1;
    p.slices = spb;
    p.threads = 32 * wps * spb;
    p.blocks = (n + spb - 1) / spb;
    p.smem = kind == 0 ? spb * 3 * tile : spb * (4 * tile + 2 * lp * 4);
    p.launches = 1;
  } else {
    const int nt = (L + kWgRows - 1) / kWgRows;
    const int slots = nt < 4 ? nt : 4;  // warpgroups, and tiles of a tensor in shared memory
    const int groups = (nt + slots - 1) / slots;
    const int tile = kWgRows * d * 2;
    p.packed = 0;
    p.groups = groups;
    p.threads = 128 * slots;
    p.blocks = n * groups;
    if (kind == 0 && nt <= 4) {  // persistent blocks (as many as fit), two buffers
      if (p.blocks > sms * (4 / slots)) p.blocks = sms * (4 / slots);
      p.smem = 1024 + 2 * (3 * slots * tile + 8 * (1 + 2 * slots));
    } else {
      p.smem = kind == 0 ? 1024 + 3 * slots * tile + 8 * (1 + 2 * slots)
                         : 1024 + 4 * slots * tile + slots * kWgRows * 8 + 8 * 2 * slots;
    }
    if (kind == 1 && nt <= 4 && 2 * n <= sms) {  // few heads: a block per head and phase
      p.groups = 2;
      p.blocks = 2 * n;
    }
    p.launches = kind == 1 && nt > 4 ? 2 : 1;
  }
  return p;
}

// The SM count of the current device (cached per device).
inline int device_sms() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cache[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cache[dev] = sms > 0 ? sms : 132;
  }
  return cache[dev];
}

// Fills out[0..7] for a kernel about to be launched with plan `p`: blocks,
// threads, shared bytes per block (dynamic + static), resident blocks per
// SM, registers per thread, local (spilled) bytes per thread, slices per
// block, launches per call.
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, const Plan& p, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, p.threads, p.smem);
  if (err != cudaSuccess) return err;
  out[0] = p.blocks;
  out[1] = p.threads;
  out[2] = (int)(p.smem + attr.sharedSizeBytes);
  out[3] = per_sm;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  out[6] = p.slices;
  out[7] = p.launches;
  return cudaSuccess;
}

}  // namespace ffm
