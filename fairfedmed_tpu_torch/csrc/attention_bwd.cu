// Fused attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel fairfedmed_tpu/ops/attention.py:_bwd_kernel
// (reached through _attend_bwd_impl).  Same math: with P = softmax(q K^T +
// mask) rebuilt in fp32 from the forward's log-sum-exp, dV = P^T dO,
// dP = dO V^T, dS = P o (dP - rowsum(dP o P)), dQ = dS K, dK = dS^T q, where
// rowsum(dP o P) = rowsum(dO o O) = delta, computed here.  The mask gets no
// gradient.
//
// Bound on the H100: the function reads q, k, v, o, dO (and the fp32 row
// log-sum-exp) and writes dq, dk, dv -- about 8 [n, L, D] tensors -- for
// 10 n L^2 D operations, again ~2 operations per byte at D = 64: memory-bound,
// and in practice bound by the latency of its dependent products.  No kernel
// uses atomics, so the gradients are deterministic.
//
// bf16 at head width 16/32/64 (the main path) runs one launch of one of two
// kernels, each in two phases over tiles resident in shared memory:
//   1. keys as rows: S^T = K Q^T and dP^T = V dO^T give P^T and dS^T, which
//      feed dV += P^T dO and dK += dS^T Q from registers (split into bf16
//      high and low parts); dK, dV are stored;
//   2. queries as rows: S and dP are recomputed, dQ += dS K; dQ is stored.
// * L <= 64 (the text towers): attention_bwd_packed_kernel.  One warp owns
//   16 rows of a (batch*head) slice in each phase, and a block packs several
//   slices (attention_common.cuh:make_plan), so no warp is launched without
//   rows and shared memory holds L rounded up to 16 rows of K, V, Q and dO
//   per slice, with delta computed from device memory as the tiles land.
//   mma.sync on padded tiles.
// * L > 64 (the vision towers): attention_bwd_wgmma_kernel, one block per
//   head with one warpgroup per 64-row tile (4 at L = 197: 16 warps in
//   flight per SM).  K, V, Q
//   and dO tiles go by cp.async into swizzled shared memory, each pair
//   completing on an mbarrier, while the block computes delta and lse for
//   every query row from device memory.  Every product runs on wgmma: in
//   phase 1, 16 queries at a time, S^T and dP^T with both operands K-major
//   from shared memory, then dV += P^T dO and dK += dS^T Q with A from
//   registers and B MN-major; in phase 2, 32 keys at a time, S, dP and
//   dQ += dS K the same way.  Steps that lie past L are skipped, and no
//   wgmma sits on a branch.  The narrow steps keep a warpgroup within 128
//   registers, so four warpgroups share an SM and overlap one another's
//   products and elementwise work.  Beyond L = 256 the two phases are two
//   launches (blocks per head and group of 4 tiles), each streaming the
//   other side's tiles through a ring of 4 slots.
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

// Packed short-row backward (bf16, D in {16, 32, 64}, L <= 64); see the top
// of the file.  Block b holds slices [b*spb, b*spb + spb) of n; warp w owns
// rows 16 (w % wps).. of slice w / wps (keys in phase 1, queries in phase 2),
// wps = ceil(L / 16).  Per slice, shared memory holds K, V, Q, dO as padded
// [lp][D+8] tiles, then lse (times log2 e) and delta for lp rows.
template <int D>
__global__ void __launch_bounds__(128, 3)
attention_bwd_packed_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                            const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                            __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                            __nv_bfloat16* __restrict__ dv, int n, int L, int spb) {
  using bf16 = __nv_bfloat16;
  constexpr int kK = MmaTile<D>::kK;
  constexpr int cpr = D / 8;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lp = (L + 15) & ~15;
  const int wps = lp >> 4;
  const int tile = lp * MmaTile<D>::kLd;                   // elements
  const int slice_bytes = 4 * tile * 2 + 2 * lp * 4;  // 4 tiles, lse, delta
  const int slice0 = blockIdx.x * spb;
  const int ns = min(spb, n - slice0);
  for (int s = 0; s < ns; ++s) {
    const size_t base = (size_t)(slice0 + s) * L * D;
    bf16* st = reinterpret_cast<bf16*>(smem_raw + s * slice_bytes);
    load_rows_async<D>(st, k + base, lp, L, threadIdx.x, blockDim.x);
    load_rows_async<D>(st + tile, v + base, lp, L, threadIdx.x, blockDim.x);
    load_rows_async<D>(st + 2 * tile, q + base, lp, L, threadIdx.x, blockDim.x);
    load_rows_async<D>(st + 3 * tile, dout + base, lp, L, threadIdx.x, blockDim.x);
  }
  cp_async_commit();
  // delta and lse of every row while the tiles land: D/8 threads a row; the
  // bound is rounded up to whole warps so every lane takes part in the
  // shuffles
  const int items = ns * lp * cpr;
  for (int idx = threadIdx.x; idx < (items + 31) / 32 * 32; idx += blockDim.x) {
    const int s = idx / (lp * cpr);
    const int r = idx / cpr - s * lp;
    const int c = idx % cpr;
    const bool valid = idx < items && r < L;
    const size_t row = (size_t)(slice0 + s) * L + r;
    const float x = row_delta<D>(o + row * D, dout + row * D, c, valid);
    if (idx < items && c == 0) {
      float* st = reinterpret_cast<float*>(smem_raw + s * slice_bytes + 4 * tile * 2);
      st[r] = valid ? lse[row] * kLog2e : INFINITY;
      st[lp + r] = valid ? x : 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s = warp / wps;
  if (s >= ns) return;  // only in the last block, when spb does not divide n
  const int row0 = (warp - s * wps) * 16;
  const bf16* sK = reinterpret_cast<const bf16*>(smem_raw + s * slice_bytes);
  const bf16* sV = sK + tile;
  const bf16* sQ = sV + tile;
  const bf16* sdO = sQ + tile;
  const float* s_lse = reinterpret_cast<const float*>(sdO + tile);
  const float* s_delta = s_lse + lp;
  const size_t base = (size_t)(slice0 + s) * L * D;

  // Phase 1: the warp's 16 keys against every query, 16 at a time.
  {
    uint32_t ka[kK][4], va[kK][4];
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      frag_a<D>(sK, row0, kk, lane, ka[kk]);
      frag_a<D>(sV, row0, kk, lane, va[kk]);
    }
    float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
    for (int qc = 0; qc < wps; ++qc) {
      float pt[2][4], dst[2][4];  // [key row][query col]: S^T then P^T; dP^T then dS^T
      mma_scores<D>(ka, sQ, 16 * qc, 0, lane, pt);
      mma_scores<D>(va, sdO, 16 * qc, 0, lane, dst);
      const bool inside = mask == nullptr && row0 + 16 <= L && 16 * qc + 16 <= L;  // warp-uniform
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = row0 + g + 8 * (e >> 1);
          const int qi = 16 * qc + 8 * i + 2 * t + (e & 1);
          float x = pt[i][e];
          if (!inside) {
            if (key >= L || qi >= L) {
              x = -INFINITY;
            } else if (mask != nullptr) {
              x += mask[(size_t)qi * L + key];
            }
          }
          const float p = exp2_approx(fmaf(x, kLog2e, -s_lse[qi]));
          pt[i][e] = p;
          dst[i][e] = p * (dst[i][e] - s_delta[qi]);
        }
      uint32_t hi[4], lo[4];
      acc_to_a(pt[0], pt[1], hi, lo);
      mma_split_tile<D>(hi, lo, sdO, 16 * qc, lane, dva);
      acc_to_a(dst[0], dst[1], hi, lo);
      mma_split_tile<D>(hi, lo, sQ, 16 * qc, lane, dka);
    }
    store_rows_bf16<D>(dk + base, dka, row0, L, g, t, 1.f, 1.f);
    store_rows_bf16<D>(dv + base, dva, row0, L, g, t, 1.f, 1.f);
  }

  // Phase 2: the warp's 16 queries against every key, 16 at a time.
  uint32_t qa[kK][4], da[kK][4];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    frag_a<D>(sQ, row0, kk, lane, qa[kk]);
    frag_a<D>(sdO, row0, kk, lane, da[kk]);
  }
  const float lse_r[2] = {s_lse[row0 + g], s_lse[row0 + g + 8]};
  const float delta_r[2] = {s_delta[row0 + g], s_delta[row0 + g + 8]};
  float dqa[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
  for (int kc = 0; kc < wps; ++kc) {
    float sc[2][4], ds[2][4];
    mma_scores<D>(qa, sK, 16 * kc, 0, lane, sc);
    mma_scores<D>(da, sV, 16 * kc, 0, lane, ds);
    const bool inside = mask == nullptr && row0 + 16 <= L && 16 * kc + 16 <= L;  // warp-uniform
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + 8 * (e >> 1);
        const int key = 16 * kc + 8 * i + 2 * t + (e & 1);
        float x = sc[i][e];
        if (!inside) {
          if (row >= L || key >= L) {
            x = -INFINITY;
          } else if (mask != nullptr) {
            x += mask[(size_t)row * L + key];
          }
        }
        const float p = exp2_approx(fmaf(x, kLog2e, -lse_r[e >> 1]));
        ds[i][e] = p * (ds[i][e] - delta_r[e >> 1]);
      }
    uint32_t hi[4], lo[4];
    acc_to_a(ds[0], ds[1], hi, lo);
    mma_split_tile<D>(hi, lo, sK, 16 * kc, lane, dqa);
  }
  store_rows_bf16<D>(dq + base, dqa, row0, L, g, t, 1.f, 1.f);
}

// lse (times log2 e) and delta = rowsum(dO o O) of query tile `tile` into
// s_lse[0..64), s_delta[0..64); rows at or past L get lse = +inf, delta = 0
// (so P = 0).  D/8 threads a row; 64 D/8 is a multiple of 32 and `nthreads`
// of 128, so whole warps take part in the shuffles.
template <int D>
__device__ __forceinline__ void tile_stats(const __nv_bfloat16* __restrict__ o,
                                           const __nv_bfloat16* __restrict__ dout,
                                           const float* __restrict__ lse, int tile, float* s_lse,
                                           float* s_delta, int L, int tid, int nthreads) {
  constexpr int cpr = D / 8;
  for (int idx = tid; idx < kWgRows * cpr; idx += nthreads) {
    const int r = idx / cpr;
    const int row = tile * kWgRows + r;
    const bool valid = row < L;
    const float x = row_delta<D>(o + (size_t)row * D, dout + (size_t)row * D, idx % cpr, valid);
    if (idx % cpr == 0) {
      s_lse[r] = valid ? lse[row] * kLog2e : INFINITY;
      s_delta[r] = valid ? x : 0.f;
    }
  }
}

// Phase 1 of the warpgroup backward for one query tile j (its slot's tiles
// sQ, sdO and statistics sl, sd): the
// warpgroup's 64 keys (key tile kt, operands dK, dV) against the tile's
// queries below L, NQ at a time: S^T = K Q^T and dP^T = V dO^T (both
// operands K-major from shared memory), P^T and dS^T, then dV += P^T dO and
// dK += dS^T Q (A from registers in bf16 high and low parts, B MN-major).
template <int D, int NQ>
__device__ __forceinline__ void bwd_keys_tile(float (&dka)[D / 8][4], float (&dva)[D / 8][4],
                                              uint64_t dK, uint64_t dV, uint32_t sQ,
                                              uint32_t sdO, const float* sl, const float* sd,
                                              int kt, int j, int key0, int g, int t,
                                              const float* __restrict__ mask, int L) {
  constexpr uint32_t RB = WgTile<D>::kRowBytes;
  constexpr int NS = NQ / 8;  // 8-query accumulator tiles
  const int chunks = min(kWgRows / NQ, (L - j * kWgRows + NQ - 1) / NQ);  // steps below L
  for (int qc = 0; qc < chunks; ++qc) {
    const uint32_t qoff = NQ * qc * RB;
    float st[NS][4], dpt[NS][4];  // [key row][query col]: S^T then P^T; dP^T then dS^T
    wgmma_fence();
    const uint64_t dQk = desc_kmajor<D>(sQ + qoff), dOk = desc_kmajor<D>(sdO + qoff);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<NQ>::template ss<0>(st, dK + kk * kDescK16, dQk + kk * kDescK16, kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<NQ>::template ss<0>(dpt, dV + kk * kDescK16, dOk + kk * kDescK16, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(st);
    fence_acc(dpt);
    // block-uniform: only edge steps and masked calls pay for the checks
    const bool inside =
        mask == nullptr && kt * kWgRows + kWgRows <= L && j * kWgRows + NQ * (qc + 1) <= L;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + g + 8 * (e >> 1);
        const int qi = NQ * qc + 8 * jj + 2 * t + (e & 1);  // query within the tile
        const int query = j * kWgRows + qi;
        float x = st[jj][e];
        if (!inside) {
          if (key >= L || query >= L) {
            x = -INFINITY;
          } else if (mask != nullptr) {
            x += mask[(size_t)query * L + key];
          }
        }
        const float p = exp2_approx(fmaf(x, kLog2e, -sl[qi]));
        st[jj][e] = p;
        dpt[jj][e] = p * (dpt[jj][e] - sd[qi]);
      }
    uint32_t ph[NQ / 16][4], pl[NQ / 16][4], dh[NQ / 16][4], dl[NQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < NQ / 16; ++kk) {
      acc_to_a(st[2 * kk], st[2 * kk + 1], ph[kk], pl[kk]);
      acc_to_a(dpt[2 * kk], dpt[2 * kk + 1], dh[kk], dl[kk]);
    }
    fence_acc(dva);
    fence_acc(dka);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NQ / 16; ++kk) {
      const uint32_t off = qoff + 16 * kk * RB;
      const uint64_t bdo = desc_mnmajor<D>(sdO + off), bq = desc_mnmajor<D>(sQ + off);
      Wgmma<D>::template rs<1>(dva, ph[kk], bdo);
      Wgmma<D>::template rs<1>(dva, pl[kk], bdo);
      Wgmma<D>::template rs<1>(dka, dh[kk], bq);
      Wgmma<D>::template rs<1>(dka, dl[kk], bq);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dva);
    fence_acc(dka);
  }
}

// Phase 2 of the warpgroup backward for one key tile j (its slot's tiles sK,
// sV): the
// warpgroup's 64 queries (query tile qt, operands dQk, dOk; row statistics
// lse_r, delta_r) against the tile's keys below L, NK at a time: S = Q K^T
// and dP = dO V^T, dS, then dQ += dS K (B MN-major).
template <int D, int NK>
__device__ __forceinline__ void bwd_queries_tile(float (&dqa)[D / 8][4], uint64_t dQk,
                                                 uint64_t dOk, uint32_t sK, uint32_t sV,
                                                 const float (&lse_r)[2],
                                                 const float (&delta_r)[2], int qt, int j,
                                                 int row0, int g, int t,
                                                 const float* __restrict__ mask, int L) {
  constexpr uint32_t RB = WgTile<D>::kRowBytes;
  constexpr int NS = NK / 8;
  const int chunks = min(kWgRows / NK, (L - j * kWgRows + NK - 1) / NK);  // steps below L
  for (int kc = 0; kc < chunks; ++kc) {
    const int kbase = j * kWgRows + NK * kc;
    const uint32_t koff = NK * kc * RB;
    float sc[NS][4], dp[NS][4];
    wgmma_fence();
    const uint64_t bk = desc_kmajor<D>(sK + koff), bv = desc_kmajor<D>(sV + koff);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<NK>::template ss<0>(sc, dQk + kk * kDescK16, bk + kk * kDescK16, kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<NK>::template ss<0>(dp, dOk + kk * kDescK16, bv + kk * kDescK16, kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    const bool inside = mask == nullptr && qt * kWgRows + kWgRows <= L && kbase + NK <= L;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + 8 * (e >> 1);
        const int key = kbase + 8 * jj + 2 * t + (e & 1);
        float x = sc[jj][e];
        if (!inside) {
          if (row >= L || key >= L) {
            x = -INFINITY;
          } else if (mask != nullptr) {
            x += mask[(size_t)row * L + key];
          }
        }
        const float p = exp2_approx(fmaf(x, kLog2e, -lse_r[e >> 1]));
        dp[jj][e] = p * (dp[jj][e] - delta_r[e >> 1]);
      }
    uint32_t hi[NK / 16][4], lo[NK / 16][4];
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) acc_to_a(dp[2 * kk], dp[2 * kk + 1], hi[kk], lo[kk]);
    fence_acc(dqa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      const uint64_t bkm = desc_mnmajor<D>(sK + koff + 16 * kk * RB);
      Wgmma<D>::template rs<1>(dqa, hi[kk], bkm);
      Wgmma<D>::template rs<1>(dqa, lo[kk], bkm);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(dqa);
  }
}

// Step widths of the warpgroup backward: 16 queries (phase 1, which holds
// the dK and dV accumulators) and 32 keys (phase 2), which keep a warpgroup
// within 128 registers, so four fit an SM.  Wider steps in two warpgroups of
// up to 255 registers ran slower on the H100 at [384, 197, 64]: the four
// warpgroups' overlap is worth more than the wider products.
constexpr int kBwdNQ = 16, kBwdNK = 32;

// Warpgroup backward (bf16, D in {16, 32, 64}, L > 64); see the top of the
// file.  MODE 0 (L <= 256): one block per head runs both phases over the
// whole head, resident, one warpgroup per tile; MODE 3, for calls of fewer
// heads than half the SMs, gives each head two such blocks (groups = 2),
// block 0 running phase 1 and block 1 phase 2 at the same time.  Beyond, MODE 1 runs phase 1
// (dK, dV) and MODE 2 phase 2 (dQ), each block owning one group of `slots`
// (4) tiles of one side (group b % groups of head b / groups), one a
// warpgroup, and streaming the other side's tiles
// through the slots.  Tile j of a tensor sits in slot j % slots; a streamed
// tile is that slot's (j / slots)-th fill.  A warpgroup whose own tile lies
// past L computes on zeros and stores nothing, so no wgmma sits on a branch.
// Shared memory (from a 1024-byte aligned base): K, V, Q, dO slots, then lse
// (times log2 e) and delta of the query tile in each slot, then the
// mbarriers (K and V of a slot; Q and dO of a slot).
template <int D, int MODE>
__global__ void __launch_bounds__(512, 1)
attention_bwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                           const __nv_bfloat16* __restrict__ o,
                           const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                           __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int L, int groups) {
  constexpr uint32_t TB = WgTile<D>::kBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int nt = (L + kWgRows - 1) / kWgRows;
  const int slots = blockDim.x >> 7;
  const uint32_t sK = base, sV = sK + slots * TB, sQ = sV + slots * TB, sdO = sQ + slots * TB;
  float* s_lse = reinterpret_cast<float*>(smem_raw + (sdO + slots * TB - raw));
  float* s_delta = s_lse + slots * kWgRows;
  const uint32_t kvbar = sdO + slots * TB + 2 * slots * kWgRows * 4, qbar = kvbar + 8 * slots;
  const int head = blockIdx.x / groups;
  const int grp = blockIdx.x - head * groups;
  const int kv0 = MODE == 1 ? grp * slots : 0;  // the K/V tiles loaded first
  const int q0 = MODE == 2 ? grp * slots : 0;   // the Q/dO tiles loaded first
  const size_t hb = (size_t)head * L * D;
  q += hb;
  k += hb;
  v += hb;
  o += hb;
  dout += hb;
  dq += hb;
  dk += hb;
  dv += hb;
  lse += (size_t)head * L;
  const int tid = threadIdx.x, nthr = blockDim.x;

  if (tid == 0) {
    for (int s = 0; s < slots; ++s) {
      mbar_init(kvbar + 8 * s, nthr);
      mbar_init(qbar + 8 * s, nthr);
    }
    mbar_init_fence();
  }
  __syncthreads();
  for (int w = 0; w < slots; ++w) {
    load_tile_swizzled<D>(sK + w * TB, k, (kv0 + w) * kWgRows, L, tid, nthr);
    load_tile_swizzled<D>(sV + w * TB, v, (kv0 + w) * kWgRows, L, tid, nthr);
    mbar_arrive_cp_async(kvbar + 8 * w);
    load_tile_swizzled<D>(sQ + w * TB, q, (q0 + w) * kWgRows, L, tid, nthr);
    load_tile_swizzled<D>(sdO + w * TB, dout, (q0 + w) * kWgRows, L, tid, nthr);
    mbar_arrive_cp_async(qbar + 8 * w);
  }
  for (int w = 0; w < slots; ++w)
    tile_stats<D>(o, dout, lse, q0 + w, s_lse + w * kWgRows, s_delta + w * kWgRows, L, tid, nthr);
  __syncthreads();

  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;  // in the warpgroup: rows 16*warp..
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // Phase 1, keys as rows: the warpgroup's key tile is in slot wg.
  auto keys_phase = [&]() {
    const int kt = kv0 + wg;
    const int key0 = kt * kWgRows + 16 * warp;
    const uint64_t dK = desc_kmajor<D>(sK + wg * TB), dV = desc_kmajor<D>(sV + wg * TB);
    float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;
    mbar_wait(kvbar + 8 * wg, 0);
    for (int j = 0; j < nt; ++j) {
      const int slot = j % slots;
      mbar_wait(qbar + 8 * slot, (j / slots) & 1);
      bwd_keys_tile<D, kBwdNQ>(dka, dva, dK, dV, sQ + slot * TB, sdO + slot * TB,
                               s_lse + slot * kWgRows, s_delta + slot * kWgRows, kt, j, key0, g,
                               t, mask, L);
      if (MODE == 1 && j + slots < nt) {  // block-uniform: refill with query tile j + slots
        __syncthreads();                  // every warpgroup is done with the slot
        load_tile_swizzled<D>(sQ + slot * TB, q, (j + slots) * kWgRows, L, tid, nthr);
        load_tile_swizzled<D>(sdO + slot * TB, dout, (j + slots) * kWgRows, L, tid, nthr);
        mbar_arrive_cp_async(qbar + 8 * slot);
        tile_stats<D>(o, dout, lse, j + slots, s_lse + slot * kWgRows,
                      s_delta + slot * kWgRows, L, tid, nthr);
        __syncthreads();  // the statistics are visible before the tile is used
      }
    }
    if (kt < nt) {
      store_rows_bf16<D>(dk, dka, key0, L, g, t, 1.f, 1.f);
      store_rows_bf16<D>(dv, dva, key0, L, g, t, 1.f, 1.f);
    }
  };

  // Phase 2, queries as rows: the warpgroup's query tile is in slot wg.
  auto queries_phase = [&]() {
    const int qt = q0 + wg;
    const int row0 = qt * kWgRows + 16 * warp;
    const uint64_t dQk = desc_kmajor<D>(sQ + wg * TB), dOk = desc_kmajor<D>(sdO + wg * TB);
    const float* sl = s_lse + wg * kWgRows + 16 * warp + g;
    const float* sd = s_delta + wg * kWgRows + 16 * warp + g;
    const float lse_r[2] = {sl[0], sl[8]};
    const float delta_r[2] = {sd[0], sd[8]};
    float dqa[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.f;
    mbar_wait(qbar + 8 * wg, 0);
    for (int j = 0; j < nt; ++j) {
      const int slot = j % slots;
      mbar_wait(kvbar + 8 * slot, (j / slots) & 1);
      bwd_queries_tile<D, kBwdNK>(dqa, dQk, dOk, sK + slot * TB, sV + slot * TB, lse_r,
                                  delta_r, qt, j, row0, g, t, mask, L);
      if (MODE == 2 && j + slots < nt) {  // block-uniform: refill with key tile j + slots
        __syncthreads();
        load_tile_swizzled<D>(sK + slot * TB, k, (j + slots) * kWgRows, L, tid, nthr);
        load_tile_swizzled<D>(sV + slot * TB, v, (j + slots) * kWgRows, L, tid, nthr);
        mbar_arrive_cp_async(kvbar + 8 * slot);
      }
    }
    if (qt < nt) store_rows_bf16<D>(dq, dqa, row0, L, g, t, 1.f, 1.f);
  };

  if constexpr (MODE == 0) {
    keys_phase();
    queries_phase();
  } else if constexpr (MODE == 1) {
    keys_phase();
  } else if constexpr (MODE == 2) {
    queries_phase();
  } else if (grp == 0) {  // MODE 3: the head's two blocks take a phase each
    keys_phase();
  } else {
    queries_phase();
  }
}

template <int D, int MODE>
cudaError_t launch_bwd_wgmma(const void* q, const void* k, const void* v, const void* mask,
                             const void* o, const void* dout, const void* lse, void* dq,
                             void* dk, void* dv, const Plan& p, int L, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_wgmma_kernel<D, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  attention_bwd_wgmma_kernel<D, MODE><<<p.blocks, p.threads, p.smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), L, p.groups);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const void* mask,
                           const void* o, const void* dout, const void* lse, void* dq, void* dk,
                           void* dv, int n, int L, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const Plan p = make_plan(1, n, L, D, device_sms());
  if (p.packed) {
    cudaError_t err = cudaFuncSetAttribute(attention_bwd_packed_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != cudaSuccess) return err;
    attention_bwd_packed_kernel<D><<<p.blocks, p.threads, p.smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const float*>(mask), static_cast<const bf16*>(o),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<bf16*>(dq),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), n, L, p.slices);
    return cudaGetLastError();
  }
  if (p.launches == 1)  // both phases in one launch, in one block or two per head
    return p.groups == 2 && L <= 4 * kWgRows
               ? launch_bwd_wgmma<D, 3>(q, k, v, mask, o, dout, lse, dq, dk, dv, p, L, stream)
               : launch_bwd_wgmma<D, 0>(q, k, v, mask, o, dout, lse, dq, dk, dv, p, L, stream);
  const cudaError_t err =
      launch_bwd_wgmma<D, 1>(q, k, v, mask, o, dout, lse, dq, dk, dv, p, L, stream);
  if (err != cudaSuccess) return err;
  return launch_bwd_wgmma<D, 2>(q, k, v, mask, o, dout, lse, dq, dk, dv, p, L, stream);
}

template <int D>
cudaError_t info_bwd_mma(int n, int L, int* out) {
  const Plan p = make_plan(1, n, L, D, device_sms());
  if (p.packed) return kernel_info(attention_bwd_packed_kernel<D>, p, out);
  if (p.launches == 2) return kernel_info(attention_bwd_wgmma_kernel<D, 1>, p, out);
  return p.groups == 2 ? kernel_info(attention_bwd_wgmma_kernel<D, 3>, p, out)
                       : kernel_info(attention_bwd_wgmma_kernel<D, 0>, p, out);
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
// scratch for the scalar kernels (the tensor-core kernels keep delta in
// shared memory and do not touch it).  Returns the CUDA error of the
// launches (0 on success); they are asynchronous on `stream`: one launch on
// the tensor-core path (two beyond L = 256), three on the scalar one.
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

// The launch of the tensor-core backward (bf16, d in {16, 32, 64}) for an
// [n, L, d] call: out[0..7] as for ffm_attention_fwd_info.  Other types
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
