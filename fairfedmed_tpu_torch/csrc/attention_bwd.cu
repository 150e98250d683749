// Fused attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel fairfedmed_tpu/ops/attention.py:_bwd_kernel
// (reached through _attend_bwd_impl).  Same math: with P = softmax(q K^T +
// mask) rebuilt in fp32, dV = P^T dO, dP = dO V^T, dS = P o (dP - rowsum(dP o
// P)), dQ = dS K, dK = dS^T q.  The mask gets no gradient.
//
// Bound on the H100: the function reads q, k, v, o, dO (and the fp32 row
// log-sum-exp) and writes dq, dk, dv -- about 8 [n, L, D] tensors -- for
// 10 n L^2 D operations, again ~2 operations per byte at D = 64: memory-bound.
// Design (no atomics, so the result is deterministic):
//   1. delta = rowsum(dO o O), which equals rowsum(dP o P), one warp per row;
//   2. one block per (batch*head, 64-key tile) walks all query tiles,
//      rebuilds P from the saved log-sum-exp and accumulates dK and dV for its
//      keys in registers;
//   3. one block per (batch*head, 64-query tile) walks all key tiles and
//      accumulates dQ for its rows.
// Passes 2 and 3 both recompute S and dP; that doubles those products but
// needs no cross-block reduction.  The [L, L] tiles live only in shared
// memory.  As in the forward, bf16 with a head width of 16, 32 or 64 runs the
// products on the tensor cores (P and dS split into bf16 high and low parts)
// and the rest on the fp32 CUDA cores.
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

// Tensor-core dK/dV pass (bf16, D in {16, 32, 64}): one block per
// (batch*head, 64-key tile), 4 warps each owning 16 keys.  The warp computes
// S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out with keys as rows
// and feed dV += P^T dO and dK += dS^T Q from registers (split high/low).
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dkdv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ mask,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                              int L) {
  __shared__ __align__(16) __nv_bfloat16 sQ[MmaTile<D>::kElems];    // K first, then Q tiles
  __shared__ __align__(16) __nv_bfloat16 sdO[MmaTile<D>::kElems];   // V first, then dO tiles
  __shared__ __align__(16) __nv_bfloat16 sQt[MmaTile<D>::kElemsT];
  __shared__ __align__(16) __nv_bfloat16 sdOt[MmaTile<D>::kElemsT];
  __shared__ float s_lse[kBlock], s_delta[kBlock];

  const int bh = blockIdx.y;
  const int n0 = blockIdx.x * kBlock;
  const size_t base = (size_t)bh * L * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;
  const int keys[2] = {n0 + wrow + g, n0 + wrow + g + 8};

  uint32_t ka[MmaTile<D>::kK][4], va[MmaTile<D>::kK][4];
  load_rows_bf16<D>(sQ, nullptr, k + base, n0, L);
  load_rows_bf16<D>(sdO, nullptr, v + base, n0, L);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < MmaTile<D>::kK; ++kk) {
    load_a<D>(sQ, wrow, kk, g, t, ka[kk]);
    load_a<D>(sdO, wrow, kk, g, t, va[kk]);
  }

  float dk_acc[MmaTile<D>::kN][4], dv_acc[MmaTile<D>::kN][4];
#pragma unroll
  for (int nt = 0; nt < MmaTile<D>::kN; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;

  for (int m0 = 0; m0 < L; m0 += kBlock) {
    __syncthreads();
    load_rows_bf16<D>(sQ, sQt, q + base, m0, L);
    load_rows_bf16<D>(sdO, sdOt, dout + base, m0, L);
    for (int r = threadIdx.x; r < kBlock; r += kMmaThreads) {
      const bool ok = m0 + r < L;
      s_lse[r] = ok ? lse[(size_t)bh * L + m0 + r] : INFINITY;
      s_delta[r] = ok ? delta[(size_t)bh * L + m0 + r] : 0.f;
    }
    __syncthreads();

    float pt[8][4], dst[8][4];  // [key row][query col] tiles: P^T, then dS^T
    mma_rows_nt<D>(ka, sQ, g, t, pt);
    mma_rows_nt<D>(va, sdO, g, t, dst);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = keys[e >> 1];
        const int qc = 8 * j + 2 * t + (e & 1);  // query within the tile
        const int query = m0 + qc;
        float p = 0.f;
        if (key < L && query < L) {
          const float s = mask != nullptr ? pt[j][e] + mask[(size_t)query * L + key] : pt[j][e];
          p = expf(s - s_lse[qc]);
        }
        pt[j][e] = p;
        dst[j][e] = p * (dst[j][e] - s_delta[qc]);
      }
    mma_acc_tn<D>(pt, sdOt, g, t, dv_acc);
    mma_acc_tn<D>(dst, sQt, g, t, dk_acc);
  }

  store_rows_bf16<D>(dk + base, dk_acc, n0 + wrow, L, g, t, 1.f, 1.f);
  store_rows_bf16<D>(dv + base, dv_acc, n0 + wrow, L, g, t, 1.f, 1.f);
}

// Tensor-core dQ pass (bf16, D in {16, 32, 64}): one block per (batch*head,
// 64-query tile), 4 warps each owning 16 queries; dQ += dS K from registers.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
attention_bwd_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            __nv_bfloat16* __restrict__ dq, int L) {
  __shared__ __align__(16) __nv_bfloat16 sK[MmaTile<D>::kElems];   // Q first, then K tiles
  __shared__ __align__(16) __nv_bfloat16 sV[MmaTile<D>::kElems];   // dO first, then V tiles
  __shared__ __align__(16) __nv_bfloat16 sKt[MmaTile<D>::kElemsT];

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlock;
  const size_t base = (size_t)bh * L * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;
  const int rows[2] = {m0 + wrow + g, m0 + wrow + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bool ok = rows[half] < L;
    lse_r[half] = ok ? lse[(size_t)bh * L + rows[half]] : INFINITY;
    delta_r[half] = ok ? delta[(size_t)bh * L + rows[half]] : 0.f;
  }

  uint32_t qa[MmaTile<D>::kK][4], doa[MmaTile<D>::kK][4];
  load_rows_bf16<D>(sK, nullptr, q + base, m0, L);
  load_rows_bf16<D>(sV, nullptr, dout + base, m0, L);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < MmaTile<D>::kK; ++kk) {
    load_a<D>(sK, wrow, kk, g, t, qa[kk]);
    load_a<D>(sV, wrow, kk, g, t, doa[kk]);
  }

  float dq_acc[MmaTile<D>::kN][4];
#pragma unroll
  for (int nt = 0; nt < MmaTile<D>::kN; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[nt][e] = 0.f;

  for (int n0 = 0; n0 < L; n0 += kBlock) {
    __syncthreads();
    load_rows_bf16<D>(sK, sKt, k + base, n0, L);
    load_rows_bf16<D>(sV, nullptr, v + base, n0, L);
    __syncthreads();

    float s[8][4], ds[8][4];
    mma_rows_nt<D>(qa, sK, g, t, s);
    mma_rows_nt<D>(doa, sV, g, t, ds);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int col = n0 + 8 * j + 2 * t + (e & 1);
        float p = 0.f;
        if (rows[half] < L && col < L) {
          const float x = mask != nullptr ? s[j][e] + mask[(size_t)rows[half] * L + col] : s[j][e];
          p = expf(x - lse_r[half]);
        }
        ds[j][e] = p * (ds[j][e] - delta_r[half]);
      }
    mma_acc_tn<D>(ds, sKt, g, t, dq_acc);
  }

  store_rows_bf16<D>(dq + base, dq_acc, m0 + wrow, L, g, t, 1.f, 1.f);
}

template <int D>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v, const void* mask,
                           const void* dout, const void* lse, const void* delta, void* dq,
                           void* dk, void* dv, int n, int L, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const dim3 grid((L + kBlock - 1) / kBlock, n);
  attention_bwd_dkdv_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), L);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_bwd_dq_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<bf16*>(dq), L);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* mask,
                       const void* o, const void* dout, const void* lse, void* delta, void* dq,
                       void* dk, void* dv, int n, int L, cudaStream_t stream) {
  const int rows = n * L;
  const int warps_per_block = kThreads / 32;
  attention_bwd_delta_kernel<T, D><<<(rows + warps_per_block - 1) / warps_per_block, kThreads, 0,
                                     stream>>>(static_cast<const T*>(o),
                                               static_cast<const T*>(dout),
                                               static_cast<float*>(delta), rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (kUseMma<T, D>) {
    return launch_bwd_mma<D>(q, k, v, mask, dout, lse, delta, dq, dk, dv, n, L, stream);
  } else {
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
// scratch.  Returns the CUDA error of the launches (0 on success); the three
// launches are asynchronous on `stream`.
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
