// Fused attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel fairfedmed_tpu/ops/attention.py:_bwd_kernel
// (reached through _attend_bwd_impl).  Same math: with P = softmax(q K^T +
// mask) rebuilt in fp32 from the forward's log-sum-exp, dV = P^T dO,
// dP = dO V^T, dS = P o (dP - rowsum(dP o P)), dQ = dS K, dK = dS^T q, where
// rowsum(dP o P) = rowsum(dO o O) = delta.  The mask gets no gradient.
//
// Bound on the H100: the function reads q, k, v, o, dO (and the fp32 row
// log-sum-exp) and writes dq, dk, dv -- about 8 [n, L, D] tensors -- for
// 10 n L^2 D operations, again ~2 operations per byte at D = 64: memory-bound.
// Neither kernel uses atomics, so the gradients are deterministic.
//
// bf16 at head width 16/32/64 (the main path) runs attention_bwd_mma_kernel,
// one launch, one block of 8 warps per (batch*head).  The block copies the
// head's K and V tiles (one commit group), then its Q, dO and O tiles (one
// group per query tile) into shared memory with cp.async, and computes delta
// and stages lse for each query tile as it lands: no delta kernel, no delta
// in device memory.  Then two phases over the same resident tiles (L <= 256;
// 5 x 4 tiles of 64 rows, 182 KiB at D = 64):
//   1. warps own 32 key rows each; S^T = K Q^T and dP^T = V dO^T give P^T and
//      dS^T with keys as rows, which feed dV += P^T dO and dK += dS^T Q from
//      registers (split into bf16 high and low parts); dK, dV are stored;
//   2. warps own 32 query rows each; S and dP are recomputed from the same
//      tiles and dQ += dS K; dQ is stored.
// Each input is read from device memory once and each output written once.
// The phases are sequential, so the dK/dV accumulators are dead before dQ's
// are live.  Each B fragment a warp loads feeds its two 16-row tiles; the A
// operands of phase 1 are reloaded from shared memory per 16-query step
// rather than held, which keeps the registers under 255.  All B operands come
// from row-major tiles through ldmatrix (.trans for P^T dO, dS^T Q and dS K):
// nothing is transposed by scalar stores.  Measured on the H100, the kernel
// is bound by the latency of its dependent products rather than by its
// copies, so exp runs as 2^x on the special-function unit and only edge
// chunks, or a call with a mask, pay for the per-element checks.  At L > 256
// the same block takes 256 keys (phase 1) or 256 queries (phase 2) at a time
// and streams the other side's tiles through a ring of four, refilled as
// each is consumed.
//
// fp32 inputs and the other widths run the scalar kernels: a delta kernel,
// then one block per (batch*head, 64-key tile) for dK/dV and one per
// (batch*head, 64-query tile) for dQ, both recomputing S and dP, on the fp32
// CUDA cores.
#include "attention_common.cuh"

namespace ffm {

template <typename T, int D>
__global__ void attention_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                           float* __restrict__ delta, int rows) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const size_t base = (size_t)warp * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_float(o[base + c]), to_float(dout[base + c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[warp] = acc;
}

// P and dS for the thread's 4 x 4 entries of one (query tile m0, key tile n0)
// pair.  sQ/sK/sdO/sV hold the tiles; rows of the query tile at or past L and
// keys at or past L give P = dS = 0.
template <int D>
__device__ __forceinline__ void probs_and_dscores(const float* sQ, const float* sK,
                                                  const float* sdO, const float* sV,
                                                  const float* __restrict__ mask,
                                                  const float* __restrict__ lse,
                                                  const float* __restrict__ delta, int m0,
                                                  int n0, int L, int ty, int tx, float p[4][4],
                                                  float ds[4][4]) {
  float dp[4][4];
  tile_dot_nt<D>(sQ, sK, ty, tx, p);
  tile_dot_nt<D>(sdO, sV, ty, tx, dp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    const bool row_ok = row < L;
    const float lse_r = row_ok ? lse[row] : INFINITY;
    const float delta_r = row_ok ? delta[row] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      float pij = 0.f;
      if (row_ok && col < L) {
        const float s = mask != nullptr ? p[i][j] + mask[(size_t)row * L + col] : p[i][j];
        pij = expf(s - lse_r);
      }
      p[i][j] = pij;
      ds[i][j] = pij * (dp[i][j] - delta_r);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ mask,
                          const T* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int L) {
  extern __shared__ float smem[];
  constexpr int ld = Tile<D>::kLd;
  constexpr int ncol = Tile<D>::kCols;
  float* sK = smem;
  float* sV = sK + Tile<D>::kFloats;
  float* sQ = sV + Tile<D>::kFloats;
  float* sdO = sQ + Tile<D>::kFloats;
  float* sP = sdO + Tile<D>::kFloats;  // [64 queries, kLdP]
  float* sdS = sP + kBlock * kLdP;     // [64 queries, kLdP]

  const int bh = blockIdx.y;
  const int n0 = blockIdx.x * kBlock;
  const size_t base = (size_t)bh * L * D;
  const float* lse_h = lse + (size_t)bh * L;
  const float* delta_h = delta + (size_t)bh * L;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, D>(sK, k + base, n0, L);
  load_tile<T, D>(sV, v + base, n0, L);

  // thread owns keys n0 + ty*4 + i and head columns tx + 16*c
  float dk_acc[4][ncol], dv_acc[4][ncol];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < ncol; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  for (int m0 = 0; m0 < L; m0 += kBlock) {
    __syncthreads();
    load_tile<T, D>(sQ, q + base, m0, L);
    load_tile<T, D>(sdO, dout + base, m0, L);
    __syncthreads();

    float p[4][4], ds[4][4];
    probs_and_dscores<D>(sQ, sK, sdO, sV, mask, lse_h, delta_h, m0, n0, L, ty, tx, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sP[(ty * 4 + i) * kLdP + tx + 16 * j] = p[i][j];
        sdS[(ty * 4 + i) * kLdP + tx + 16 * j] = ds[i][j];
      }
    __syncthreads();

    const int mvalid = min(kBlock, L - m0);
    for (int r = 0; r < mvalid; ++r) {
      float pr[4], dsr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = sP[r * kLdP + ty * 4 + i];
        dsr[i] = sdS[r * kLdP + ty * 4 + i];
      }
#pragma unroll
      for (int c = 0; c < ncol; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float dov = sdO[r * ld + col];
          const float qv = sQ[r * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][c] = fmaf(pr[i], dov, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(dsr[i], qv, dk_acc[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = n0 + ty * 4 + i;
    if (row >= L) continue;
#pragma unroll
    for (int c = 0; c < ncol; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        store_as(dk + base + (size_t)row * D + col, dk_acc[i][c]);
        store_as(dv + base + (size_t)row * D + col, dv_acc[i][c]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ mask,
                        const T* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq, int L) {
  extern __shared__ float smem[];
  constexpr int ld = Tile<D>::kLd;
  constexpr int ncol = Tile<D>::kCols;
  float* sQ = smem;
  float* sdO = sQ + Tile<D>::kFloats;
  float* sK = sdO + Tile<D>::kFloats;
  float* sV = sK + Tile<D>::kFloats;
  float* sdS = sV + Tile<D>::kFloats;  // [64 queries, kLdP]

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlock;
  const size_t base = (size_t)bh * L * D;
  const float* lse_h = lse + (size_t)bh * L;
  const float* delta_h = delta + (size_t)bh * L;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, D>(sQ, q + base, m0, L);
  load_tile<T, D>(sdO, dout + base, m0, L);

  // thread owns queries m0 + ty*4 + i and head columns tx + 16*c
  float dq_acc[4][ncol];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < ncol; ++c) dq_acc[i][c] = 0.f;

  for (int n0 = 0; n0 < L; n0 += kBlock) {
    __syncthreads();
    load_tile<T, D>(sK, k + base, n0, L);
    load_tile<T, D>(sV, v + base, n0, L);
    __syncthreads();

    float p[4][4], ds[4][4];
    probs_and_dscores<D>(sQ, sK, sdO, sV, mask, lse_h, delta_h, m0, n0, L, ty, tx, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sdS[(ty * 4 + i) * kLdP + tx + 16 * j] = ds[i][j];
    __syncthreads();

    const int nvalid = min(kBlock, L - n0);
    for (int kk = 0; kk < nvalid; ++kk) {
      float dsr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsr[i] = sdS[(ty * 4 + i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < ncol; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float kv = sK[kk * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) dq_acc[i][c] = fmaf(dsr[i], kv, dq_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= L) continue;
#pragma unroll
    for (int c = 0; c < ncol; ++c) {
      const int col = tx + 16 * c;
      if (col < D) store_as(dq + base + (size_t)row * D + col, dq_acc[i][c]);
    }
  }
}

// Tensor-core backward (bf16, D in {16, 32, 64}); see the top of the file.
constexpr int kBwdWarps = 8;  // 32 rows each: kRing tiles of rows at once
constexpr int kBwdThreads = 32 * kBwdWarps;
static_assert(16 * kWarpTiles * kBwdWarps == kRing * kBlock,
              "a phase owns the rows of kRing tiles");

template <int D>
constexpr size_t bwd_mma_smem() {
  return (size_t)5 * kRing * MmaTile<D>::kElems * sizeof(__nv_bfloat16) +
         (size_t)2 * kRing * kBlock * sizeof(float);
}

// kRing tiles of each tensor, and lse / delta of the query tiles in q.
struct BwdSmem {
  __nv_bfloat16 *k, *v, *q, *dout, *o;
  float *lse, *delta;
};

// Issues the copies of query tile j (q, dO, O) into ring slot `slot`.
template <int D>
__device__ __forceinline__ void bwd_issue_rows(const BwdSmem& sm, const __nv_bfloat16* q,
                                               const __nv_bfloat16* dout,
                                               const __nv_bfloat16* o, int j, int slot, int L) {
  const int off = slot * MmaTile<D>::kElems;
  load_tile_async<D, kBwdThreads>(sm.q + off, q, j * kBlock, L);
  load_tile_async<D, kBwdThreads>(sm.dout + off, dout, j * kBlock, L);
  load_tile_async<D, kBwdThreads>(sm.o + off, o, j * kBlock, L);
}

// Issues the copies of key tile j (k, v) into ring slot `slot`.
template <int D>
__device__ __forceinline__ void bwd_issue_keys(const BwdSmem& sm, const __nv_bfloat16* k,
                                               const __nv_bfloat16* v, int j, int slot, int L) {
  const int off = slot * MmaTile<D>::kElems;
  load_tile_async<D, kBwdThreads>(sm.k + off, k, j * kBlock, L);
  load_tile_async<D, kBwdThreads>(sm.v + off, v, j * kBlock, L);
}

// lse (times log2 e, for exp2) and delta = rowsum(dO o O) of query tile j,
// which has landed in ring slot `slot`; rows at or past L get lse = +inf,
// delta = 0 (so P = 0).  D/8 threads per row, 8 columns each.
template <int D>
__device__ __forceinline__ void bwd_row_stats(const BwdSmem& sm, const float* __restrict__ lse,
                                              int j, int slot, int L) {
  constexpr int cpr = D / 8;
  constexpr int rows_per_pass = kBwdThreads / cpr;
  const int c = (threadIdx.x % cpr) * 8;
#pragma unroll
  for (int r0 = 0; r0 < kBlock; r0 += rows_per_pass) {
    const int r = r0 + threadIdx.x / cpr;
    float x = 0.f;
    if (r < kBlock) {
      const int off = slot * MmaTile<D>::kElems + r * MmaTile<D>::kLd + c;
      const uint4 a = *reinterpret_cast<const uint4*>(sm.dout + off);
      const uint4 b = *reinterpret_cast<const uint4*>(sm.o + off);
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
    for (int off = cpr / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (r < kBlock && threadIdx.x % cpr == 0) {
      const int row = j * kBlock + r;
      const bool ok = row < L;
      sm.lse[slot * kBlock + r] = ok ? lse[row] * kLog2e : INFINITY;
      sm.delta[slot * kBlock + r] = ok ? x : 0.f;
    }
  }
}

// Phase 1 for one warp and one landed query tile j (ring slot `slot`): the
// warp's 32 keys (from key0; tiles sK, sV at row wrow) against the tile's 64
// queries, 16 at a time.
template <int D>
__device__ __forceinline__ void bwd_keys_step(const BwdSmem& sm, const __nv_bfloat16* sK,
                                              const __nv_bfloat16* sV, int wrow, int key0, int j,
                                              int slot, const float* __restrict__ mask, int L,
                                              int lane, float dk_acc[][MmaTile<D>::kN][4],
                                              float dv_acc[][MmaTile<D>::kN][4]) {
  constexpr int M = kWarpTiles;
  const int g = lane >> 2, t = lane & 3;
  const int off = slot * MmaTile<D>::kElems;
  const __nv_bfloat16* sQ = sm.q + off;
  const __nv_bfloat16* sdO = sm.dout + off;
  const float* s_lse = sm.lse + slot * kBlock;
  const float* s_delta = sm.delta + slot * kBlock;
#pragma unroll 1
  for (int qc = 0; qc < 4; ++qc) {
    if (j * kBlock + 16 * qc >= L) break;
    float pt[M][2][4], dst[M][2][4];  // [key row][query col]: S^T, then P^T; dP^T, then dS^T
    {
      uint32_t a[M][MmaTile<D>::kK][4];  // K rows, then V rows (reloaded: saves registers)
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int kk = 0; kk < MmaTile<D>::kK; ++kk)
          frag_a<D>(sK, wrow + 16 * m, kk, lane, a[m][kk]);
      mma_scores<D, M, 2>(a, sQ, 16 * qc, 0, lane, pt);
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int kk = 0; kk < MmaTile<D>::kK; ++kk)
          frag_a<D>(sV, wrow + 16 * m, kk, lane, a[m][kk]);
      mma_scores<D, M, 2>(a, sdO, 16 * qc, 0, lane, dst);
    }
    // warp-uniform: only edge chunks and masked calls pay for the checks
    const bool inside = mask == nullptr && key0 + 16 * M <= L && j * kBlock + 16 * qc + 16 <= L;
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 16 * m + g + 8 * (e >> 1);
          const int qi = 16 * qc + 8 * i + 2 * t + (e & 1);  // query within the tile
          const int query = j * kBlock + qi;
          float x = pt[m][i][e];
          if (!inside) {
            if (key >= L || query >= L) {
              x = -INFINITY;
            } else if (mask != nullptr) {
              x += mask[(size_t)query * L + key];
            }
          }
          const float p = exp2_approx(fmaf(x, kLog2e, -s_lse[qi]));
          pt[m][i][e] = p;
          dst[m][i][e] = p * (dst[m][i][e] - s_delta[qi]);
        }
    uint32_t hi[M][4], lo[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m) acc_to_a(pt[m][0], pt[m][1], hi[m], lo[m]);
    mma_split_tile<D, M>(hi, lo, sdO, 16 * qc, lane, dv_acc);
#pragma unroll
    for (int m = 0; m < M; ++m) acc_to_a(dst[m][0], dst[m][1], hi[m], lo[m]);
    mma_split_tile<D, M>(hi, lo, sQ, 16 * qc, lane, dk_acc);
  }
}

// Phase 2 for one warp and one landed key tile j (tiles sK, sV): the warp's
// 32 queries (from row0; fragments qa, da) against the tile's 64 keys, 16 at
// a time.
template <int D>
__device__ __forceinline__ void bwd_queries_step(const __nv_bfloat16* sK,
                                                 const __nv_bfloat16* sV,
                                                 const uint32_t qa[][MmaTile<D>::kK][4],
                                                 const uint32_t da[][MmaTile<D>::kK][4],
                                                 const float lse_r[][2], const float delta_r[][2],
                                                 int row0, int j, const float* __restrict__ mask,
                                                 int L, int lane,
                                                 float dq_acc[][MmaTile<D>::kN][4]) {
  constexpr int M = kWarpTiles;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int kc = 0; kc < 4; ++kc) {
    const int k0 = j * kBlock + 16 * kc;
    if (k0 >= L) break;
    float s[M][2][4], ds[M][2][4];
    mma_scores<D, M, 2>(qa, sK, 16 * kc, 0, lane, s);
    mma_scores<D, M, 2>(da, sV, 16 * kc, 0, lane, ds);
    const bool inside = mask == nullptr && row0 + 16 * M <= L && k0 + 16 <= L;  // warp-uniform
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + 16 * m + g + 8 * (e >> 1);
          const int key = k0 + 8 * i + 2 * t + (e & 1);
          float x = s[m][i][e];
          if (!inside) {
            if (row >= L || key >= L) {
              x = -INFINITY;
            } else if (mask != nullptr) {
              x += mask[(size_t)row * L + key];
            }
          }
          const float p = exp2_approx(fmaf(x, kLog2e, -lse_r[m][e >> 1]));
          ds[m][i][e] = p * (ds[m][i][e] - delta_r[m][e >> 1]);
        }
    uint32_t hi[M][4], lo[M][4];
#pragma unroll
    for (int m = 0; m < M; ++m) acc_to_a(ds[m][0], ds[m][1], hi[m], lo[m]);
    mma_split_tile<D, M>(hi, lo, sK, 16 * kc, lane, dq_acc);
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
attention_bwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int L) {
  using bf16 = __nv_bfloat16;
  constexpr int M = kWarpTiles;
  constexpr int tile = MmaTile<D>::kElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem sm;
  sm.k = reinterpret_cast<bf16*>(smem_raw);
  sm.v = sm.k + kRing * tile;
  sm.q = sm.v + kRing * tile;
  sm.dout = sm.q + kRing * tile;
  sm.o = sm.dout + kRing * tile;
  sm.lse = reinterpret_cast<float*>(sm.o + kRing * tile);
  sm.delta = sm.lse + kRing * kBlock;

  const size_t base = (size_t)blockIdx.x * L * D;
  q += base;
  k += base;
  v += base;
  o += base;
  dout += base;
  lse += (size_t)blockIdx.x * L;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  constexpr int warps_per_tile = kBlock / (16 * M);
  const int wslot = warp / warps_per_tile;           // the slot (tile) whose rows the warp owns
  const int wrow = 16 * M * (warp % warps_per_tile);  // the warp's first row in that tile
  const int nt = (L + kBlock - 1) / kBlock;
  const bool resident = nt <= kRing;  // the whole head fits: every tile is copied once
  int issued = 0;                     // commit groups so far

  // Phase 1: dK and dV for kRing key tiles at a time; query tiles stream.
  for (int g0 = 0; g0 < nt; g0 += kRing) {
    __syncthreads();  // the previous group's readers are done with the slots
    for (int i = 0; i < min(kRing, nt - g0); ++i) bwd_issue_keys<D>(sm, k, v, g0 + i, i, L);
    cp_async_commit();
    const int first = ++issued;  // query tile j is group first + j + 1
    for (int j = 0; j < min(nt, kRing); ++j, ++issued) {
      bwd_issue_rows<D>(sm, q, dout, o, j, j, L);
      cp_async_commit();
    }
    const int key0 = (g0 + wslot) * kBlock + wrow;
    const bool active = key0 < L;  // warp-uniform
    float dk_acc[M][MmaTile<D>::kN][4], dv_acc[M][MmaTile<D>::kN][4];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int nt8 = 0; nt8 < MmaTile<D>::kN; ++nt8)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[m][nt8][e] = dv_acc[m][nt8][e] = 0.f;
    for (int j = 0; j < nt; ++j) {
      const int slot = j % kRing;
      cp_async_wait(issued - (first + j + 1));
      __syncthreads();
      bwd_row_stats<D>(sm, lse, j, slot, L);
      __syncthreads();
      if (active)
        bwd_keys_step<D>(sm, sm.k + wslot * tile, sm.v + wslot * tile, wrow, key0, j, slot, mask,
                         L, lane, dk_acc, dv_acc);
      if (j + kRing < nt) {
        __syncthreads();  // every warp is done with this slot
        bwd_issue_rows<D>(sm, q, dout, o, j + kRing, slot, L);
        cp_async_commit();
        ++issued;
      }
    }
    if (active) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        store_rows_bf16<D>(dk + base, dk_acc[m], key0 + 16 * m, L, g, t, 1.f, 1.f);
        store_rows_bf16<D>(dv + base, dv_acc[m], key0 + 16 * m, L, g, t, 1.f, 1.f);
      }
    }
  }

  // Phase 2: dQ for kRing query tiles at a time; key tiles stream.  When the
  // head is resident, the tiles and row statistics of phase 1 are all in
  // place (query tile j and key tile j in slot j) and nothing is copied.
  for (int g0 = 0; g0 < nt; g0 += kRing) {
    int first = issued;
    if (!resident) {
      __syncthreads();  // phase 1 / the previous group is done with the slots
      for (int i = 0; i < min(kRing, nt - g0); ++i) bwd_issue_rows<D>(sm, q, dout, o, g0 + i, i, L);
      cp_async_commit();
      first = ++issued;  // key tile j is group first + j + 1
      for (int j = 0; j < min(nt, kRing); ++j, ++issued) {
        bwd_issue_keys<D>(sm, k, v, j, j, L);
        cp_async_commit();
      }
      cp_async_wait(issued - first);
      __syncthreads();
      for (int i = 0; i < min(kRing, nt - g0); ++i) bwd_row_stats<D>(sm, lse, g0 + i, i, L);
      __syncthreads();
    }
    const int row0 = (g0 + wslot) * kBlock + wrow;
    const bool active = row0 < L;  // warp-uniform
    uint32_t qa[M][MmaTile<D>::kK][4], da[M][MmaTile<D>::kK][4];
    float lse_r[M][2], delta_r[M][2], dq_acc[M][MmaTile<D>::kN][4];
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int kk = 0; kk < MmaTile<D>::kK; ++kk) {
        frag_a<D>(sm.q + wslot * tile, wrow + 16 * m, kk, lane, qa[m][kk]);
        frag_a<D>(sm.dout + wslot * tile, wrow + 16 * m, kk, lane, da[m][kk]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lse_r[m][h] = sm.lse[wslot * kBlock + wrow + 16 * m + g + 8 * h];
        delta_r[m][h] = sm.delta[wslot * kBlock + wrow + 16 * m + g + 8 * h];
      }
#pragma unroll
      for (int nt8 = 0; nt8 < MmaTile<D>::kN; ++nt8)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq_acc[m][nt8][e] = 0.f;
    }
    for (int j = 0; j < nt; ++j) {
      const int slot = j % kRing;
      if (!resident) {
        cp_async_wait(issued - (first + j + 1));
        __syncthreads();
      }
      if (active)
        bwd_queries_step<D>(sm.k + slot * tile, sm.v + slot * tile, qa, da, lse_r, delta_r, row0,
                            j, mask, L, lane, dq_acc);
      if (!resident && j + kRing < nt) {
        __syncthreads();  // every warp is done with this slot
        bwd_issue_keys<D>(sm, k, v, j + kRing, slot, L);
        cp_async_commit();
        ++issued;
      }
    }
    if (active) {
#pragma unroll
      for (int m = 0; m < M; ++m)
        store_rows_bf16<D>(dq + base, dq_acc[m], row0 + 16 * m, L, g, t, 1.f, 1.f);
    }
  }
}

template <int D>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const void* mask,
                           const void* o, const void* dout, const void* lse, void* dq, void* dk,
                           void* dv, int n, int L, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  constexpr size_t smem = bwd_mma_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_bwd_mma_kernel<D><<<n, kBwdThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), L);
  return cudaGetLastError();
}

template <int D>
cudaError_t info_bwd_mma(int n, int L, int* out) {
  return kernel_info(attention_bwd_mma_kernel<D>, n, kBwdThreads, bwd_mma_smem<D>(), out);
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* mask,
                       const void* o, const void* dout, const void* lse, void* delta, void* dq,
                       void* dk, void* dv, int n, int L, cudaStream_t stream) {
  if constexpr (kUseMma<T, D>) {
    return launch_bwd_mma<D>(q, k, v, mask, o, dout, lse, dq, dk, dv, n, L, stream);
  } else {
    const int rows = n * L;
    const int warps_per_block = kThreads / 32;
    attention_bwd_delta_kernel<T, D><<<(rows + warps_per_block - 1) / warps_per_block, kThreads,
                                       0, stream>>>(static_cast<const T*>(o),
                                                    static_cast<const T*>(dout),
                                                    static_cast<float*>(delta), rows);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const dim3 grid((L + kBlock - 1) / kBlock, n);
    const size_t smem_kv = (4 * Tile<D>::kFloats + 2 * kBlock * kLdP) * sizeof(float);
    err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_kv);
    if (err != cudaSuccess) return err;
    attention_bwd_dkdv_kernel<T, D><<<grid, kThreads, smem_kv, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(mask), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dk),
        static_cast<T*>(dv), L);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const size_t smem_q = (4 * Tile<D>::kFloats + kBlock * kLdP) * sizeof(float);
    err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
    if (err != cudaSuccess) return err;
    attention_bwd_dq_kernel<T, D><<<grid, kThreads, smem_q, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(mask), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<T*>(dq), L);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v, const void* mask,
                         const void* o, const void* dout, const void* lse, void* delta, void* dq,
                         void* dk, void* dv, int n, int L, int d, cudaStream_t stream) {
  switch (d) {
    case 8: return launch_bwd<T, 8>(q, k, v, mask, o, dout, lse, delta, dq, dk, dv, n, L, stream);
    case 16: return launch_bwd<T, 16>(q, k, v, mask, o, dout, lse, delta, dq, dk, dv, n, L, stream);
    case 32: return launch_bwd<T, 32>(q, k, v, mask, o, dout, lse, delta, dq, dk, dv, n, L, stream);
    case 64: return launch_bwd<T, 64>(q, k, v, mask, o, dout, lse, delta, dq, dk, dv, n, L, stream);
    case 128:
      return launch_bwd<T, 128>(q, k, v, mask, o, dout, lse, delta, dq, dk, dv, n, L, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ffm

// dtype: 0 = float32, 1 = bfloat16.  mask may be null.  `delta` is fp32 [n, L]
// scratch for the scalar kernels (the tensor-core kernel keeps delta in
// shared memory and does not touch it).  Returns the CUDA error of the
// launches (0 on success); they are asynchronous on `stream`: one launch on
// the tensor-core path, three on the scalar one.
extern "C" int ffm_attention_bwd(const void* q, const void* k, const void* v, const void* mask,
                                 const void* o, const void* dout, const void* lse, void* delta,
                                 void* dq, void* dk, void* dv, int n, int L, int d, int dtype,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return ffm::dispatch_bwd<float>(q, k, v, mask, o, dout, lse, delta, dq, dk, dv, n, L, d, s);
  if (dtype == 1)
    return ffm::dispatch_bwd<__nv_bfloat16>(q, k, v, mask, o, dout, lse, delta, dq, dk, dv, n, L,
                                            d, s);
  return cudaErrorInvalidValue;
}

// The launch shape of the tensor-core backward (bf16, d in {16, 32, 64}) for
// an [n, L, d] call: out[0..5] as for ffm_attention_fwd_info.  Other types
// and widths return cudaErrorInvalidValue.
extern "C" int ffm_attention_bwd_info(int n, int L, int d, int dtype, void* out) {
  int* o = static_cast<int*>(out);
  if (dtype != 1) return cudaErrorInvalidValue;
  switch (d) {
    case 16: return ffm::info_bwd_mma<16>(n, L, o);
    case 32: return ffm::info_bwd_mma<32>(n, L, o);
    case 64: return ffm::info_bwd_mma<64>(n, L, o);
    default: return cudaErrorInvalidValue;
  }
}
