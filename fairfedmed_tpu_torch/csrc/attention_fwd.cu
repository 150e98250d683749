// Fused attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel fairfedmed_tpu/ops/attention.py:_fwd_kernel
// (reached through _attend_impl).  Same math: S = q K^T + mask (q arrives
// scaled), softmax over each row in fp32 with P kept in fp32, O = P V cast to
// the input type.  Unlike the TPU kernel it does not pad L to 128: the ragged
// tail of the last tile is masked here, and nothing is padded in device memory.
//
// Bound on the H100: at CLIP's lengths (L = 197 vision, <= 77 text, D = 64)
// the function moves 4 [n, L, D] tensors and does 4 n L^2 D operations, about
// 2 operations per byte -- far below the ~295 the tensor cores need, so the
// memory traffic (reading q, k, v and writing o once) is the bound, and with
// it the latency of getting each tile on chip.  Both kernels keep the [L, L]
// scores out of device memory (online softmax over 64-key tiles) and write
// only O and the per-row log-sum-exp (fp32) that the backward uses to
// rebuild P.
//
// bf16 at head width 16/32/64 (the main path) runs attention_fwd_mma_kernel:
// one block per (batch*head, 128 query rows), 4 warps of 32 rows each, so a
// head's K and V are read from device memory twice at L = 197 (once per
// 128-row block) rather than once per 64-row tile.  The block issues
// cp.async copies for its Q rows and then for every K/V tile of the head,
// one commit group per tile: at L <= 256 the whole head (4 x 64 keys) stays
// resident, a longer L cycles a ring of 4 tiles, refilled as each is
// consumed.  S = Q K^T takes K's B fragments from the row-major tile with
// ldmatrix; O += P V takes V's with ldmatrix.trans; each fragment feeds the
// warp's two 16-row tiles.  P is split into bf16 high and low parts
// (mma.sync).  Measured on the H100, the kernel is bound by the latency of
// its products, not by its copies (it takes about as long with the copies
// removed), so the design cuts work per product: key chunks past L are
// skipped, only the tail tile or a call with a mask pays for per-element
// checks, and exp runs as 2^x on the special-function unit.  fp32 inputs and
// the other widths run attention_fwd_kernel on the fp32 CUDA cores (4 x 4
// register tiles), which keeps fp32 exact to rounding.
#include "attention_common.cuh"

namespace ffm {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ mask, T* __restrict__ o, float* __restrict__ lse,
                     int L) {
  extern __shared__ float smem[];
  constexpr int ld = Tile<D>::kLd;
  constexpr int ncol = Tile<D>::kCols;
  float* sQ = smem;
  float* sK = sQ + Tile<D>::kFloats;
  float* sV = sK + Tile<D>::kFloats;
  float* sP = sV + Tile<D>::kFloats;  // [64, kLdP]

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlock;
  const size_t base = (size_t)bh * L * D;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<T, D>(sQ, q + base, m0, L);

  float m_i[4], l_i[4], acc[4][ncol];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < ncol; ++c) acc[i][c] = 0.f;
  }

  for (int n0 = 0; n0 < L; n0 += kBlock) {
    __syncthreads();  // the previous tile's readers are done with sK, sV, sP
    load_tile<T, D>(sK, k + base, n0, L);
    load_tile<T, D>(sV, v + base, n0, L);
    __syncthreads();

    float s[4][4];
    tile_dot_nt<D>(sQ, sK, ty, tx, s);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx + 16 * j;
        if (col >= L) {
          s[i][j] = -INFINITY;
        } else if (mask != nullptr && row < L) {
          s[i][j] += mask[(size_t)row * L + col];
        }
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max(mx));
      // a row whose keys so far are all masked (-inf) keeps m = -inf; take 0
      // as the reference then, so exp(-inf - ref) = 0 and never NaN
      const float ref = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_i[i] - ref);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - ref);
        sP[(ty * 4 + i) * kLdP + tx + 16 * j] = p;
        rs += p;
      }
      l_i[i] = l_i[i] * alpha + row_sum(rs);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < ncol; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    const int nvalid = min(kBlock, L - n0);
    for (int kk = 0; kk < nvalid; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sP[(ty * 4 + i) * kLdP + kk];
#pragma unroll
      for (int c = 0; c < ncol; ++c) {
        const int col = tx + 16 * c;
        if (col < D) {
          const float vv = sV[kk * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= L) continue;
    // a fully masked row (l = 0) writes zeros and lse = +inf, so the backward
    // rebuilds P = 0 for it
    const float inv = l_i[i] > 0.f ? 1.f / l_i[i] : 0.f;
#pragma unroll
    for (int c = 0; c < ncol; ++c) {
      const int col = tx + 16 * c;
      if (col < D) store_as(o + base + (size_t)row * D + col, acc[i][c] * inv);
    }
    if (tx == 0) lse[(size_t)bh * L + row] = l_i[i] > 0.f ? m_i[i] + logf(l_i[i]) : INFINITY;
  }
}

// Tensor-core forward (bf16, D in {16, 32, 64}); see the top of the file.
constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdRows = 16 * kWarpTiles * kFwdWarps;  // query rows per block: two tiles

template <int D>
constexpr size_t fwd_mma_smem() {
  return (size_t)(kFwdRows / kBlock + 2 * kRing) * MmaTile<D>::kElems * sizeof(__nv_bfloat16);
}

// Issues K/V tile j into ring slot j % kRing as one commit group.
template <int D>
__device__ __forceinline__ void fwd_load_kv(__nv_bfloat16* sK, __nv_bfloat16* sV,
                                            const __nv_bfloat16* k, const __nv_bfloat16* v, int j,
                                            int L) {
  const int off = (j % kRing) * MmaTile<D>::kElems;
  load_tile_async<D, kFwdThreads>(sK + off, k, j * kBlock, L);
  load_tile_async<D, kFwdThreads>(sV + off, v, j * kBlock, L);
  cp_async_commit();
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 2)
attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                         __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int L) {
  using bf16 = __nv_bfloat16;
  constexpr int M = kWarpTiles;
  constexpr int tile = MmaTile<D>::kElems;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // the block's query rows
  bf16* sK = sQ + (kFwdRows / kBlock) * tile;    // kRing K tiles
  bf16* sV = sK + kRing * tile;                  // kRing V tiles

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kFwdRows;
  const size_t base = (size_t)bh * L * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16 * M;  // the warp's first row in the block
  const int nt = (L + kBlock - 1) / kBlock;

  // commit groups: the query rows first, then K/V tile j as group j + 1
#pragma unroll
  for (int i = 0; i < kFwdRows / kBlock; ++i)
    load_tile_async<D, kFwdThreads>(sQ + i * tile, q + base, m0 + i * kBlock, L);
  cp_async_commit();
  int issued = 1;
  for (int j = 0; j < min(nt, kRing); ++j, ++issued)
    fwd_load_kv<D>(sK, sV, k + base, v + base, j, L);

  cp_async_wait(issued - 1);
  __syncthreads();
  const bool active = m0 + wrow < L;  // warp-uniform: the warp has a row below L
  uint32_t qa[M][MmaTile<D>::kK][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int kk = 0; kk < MmaTile<D>::kK; ++kk) frag_a<D>(sQ, wrow + 16 * m, kk, lane, qa[m][kk]);

  float oacc[M][MmaTile<D>::kN][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int nt8 = 0; nt8 < MmaTile<D>::kN; ++nt8)
      oacc[m][nt8][0] = oacc[m][nt8][1] = oacc[m][nt8][2] = oacc[m][nt8][3] = 0.f;
  float m_r[M][2], l_r[M][2];
#pragma unroll
  for (int m = 0; m < M; ++m) m_r[m][0] = m_r[m][1] = -INFINITY, l_r[m][0] = l_r[m][1] = 0.f;

  for (int j = 0; j < nt; ++j) {
    const int n0 = j * kBlock;
    const bf16* sKj = sK + (j % kRing) * tile;
    const bf16* sVj = sV + (j % kRing) * tile;
    cp_async_wait(issued - (j + 2));  // tile j is group j + 1
    __syncthreads();
    if (active) {
      float s[M][8][4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (n0 + 16 * c < L) mma_scores<D, M, 8>(qa, sKj, 16 * c, c, lane, s);
      if (mask != nullptr || n0 + kBlock > L) {  // block-uniform: the tail tile or a mask
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = m0 + wrow + 16 * m + g + 8 * (e >> 1);
              const int col = n0 + 8 * jj + 2 * t + (e & 1);
              float& x = s[m][jj][e];
              if (col >= L) {
                x = -INFINITY;
              } else if (mask != nullptr && row < L) {
                x += mask[(size_t)row * L + col];
              }
            }
      }
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float mx = -INFINITY;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            mx = fmaxf(mx, fmaxf(s[m][jj][2 * half], s[m][jj][2 * half + 1]));
          const float m_new = fmaxf(m_r[m][half], quad_max(mx));
          // a row whose keys so far are all masked (-inf) keeps m = -inf; take
          // 0 as the reference then, so exp(-inf - ref) = 0 and never NaN
          const float ref2 = (m_new == -INFINITY ? 0.f : m_new) * kLog2e;
          const float alpha = exp2_approx(fmaf(m_r[m][half], kLog2e, -ref2));
          float rs = 0.f;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int e = 2 * half; e < 2 * half + 2; ++e) {
              s[m][jj][e] = exp2_approx(fmaf(s[m][jj][e], kLog2e, -ref2));
              rs += s[m][jj][e];
            }
          l_r[m][half] = l_r[m][half] * alpha + quad_sum(rs);
          m_r[m][half] = m_new;
#pragma unroll
          for (int nt8 = 0; nt8 < MmaTile<D>::kN; ++nt8) {
            oacc[m][nt8][2 * half] *= alpha;
            oacc[m][nt8][2 * half + 1] *= alpha;
          }
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (n0 + 16 * kk >= L) continue;  // P = 0 for these keys
        uint32_t hi[M][4], lo[M][4];
#pragma unroll
        for (int m = 0; m < M; ++m) acc_to_a(s[m][2 * kk], s[m][2 * kk + 1], hi[m], lo[m]);
        mma_split_tile<D, M>(hi, lo, sVj, 16 * kk, lane, oacc);
      }
    }
    if (j + kRing < nt) {
      __syncthreads();  // every warp is done with this slot
      fwd_load_kv<D>(sK, sV, k + base, v + base, j + kRing, L);
      ++issued;
    }
  }

  if (!active) return;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int row0 = m0 + wrow + 16 * m;
    const float inv0 = l_r[m][0] > 0.f ? 1.f / l_r[m][0] : 0.f;
    const float inv1 = l_r[m][1] > 0.f ? 1.f / l_r[m][1] : 0.f;
    store_rows_bf16<D>(o + base, oacc[m], row0, L, g, t, inv0, inv1);
    if (t == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + g + 8 * half;
        if (row < L)
          lse[(size_t)bh * L + row] =
              l_r[m][half] > 0.f ? m_r[m][half] + logf(l_r[m][half]) : INFINITY;
      }
    }
  }
}

template <int D>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, const void* mask, void* o,
                           void* lse, int n, int L, cudaStream_t stream) {
  constexpr size_t smem = fwd_mma_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((L + kFwdRows - 1) / kFwdRows, n);
  attention_fwd_mma_kernel<D><<<grid, kFwdThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), L);
  return cudaGetLastError();
}

template <int D>
cudaError_t info_fwd_mma(int n, int L, int* out) {
  return kernel_info(attention_fwd_mma_kernel<D>, ((L + kFwdRows - 1) / kFwdRows) * n, kFwdThreads,
                     fwd_mma_smem<D>(), out);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                       void* lse, int n, int L, cudaStream_t stream) {
  if constexpr (kUseMma<T, D>) {
    return launch_fwd_mma<D>(q, k, v, mask, o, lse, n, L, stream);
  } else {
    const size_t smem = (3 * Tile<D>::kFloats + kBlock * kLdP) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((L + kBlock - 1) / kBlock, n);
    attention_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(mask), static_cast<T*>(o), static_cast<float*>(lse), L);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t dispatch_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                         void* lse, int n, int L, int d, cudaStream_t stream) {
  switch (d) {
    case 8: return launch_fwd<T, 8>(q, k, v, mask, o, lse, n, L, stream);
    case 16: return launch_fwd<T, 16>(q, k, v, mask, o, lse, n, L, stream);
    case 32: return launch_fwd<T, 32>(q, k, v, mask, o, lse, n, L, stream);
    case 64: return launch_fwd<T, 64>(q, k, v, mask, o, lse, n, L, stream);
    case 128: return launch_fwd<T, 128>(q, k, v, mask, o, lse, n, L, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace ffm

// dtype: 0 = float32, 1 = bfloat16.  mask may be null.  Returns the CUDA error
// of the launch (0 on success); the launch is asynchronous on `stream`.
extern "C" int ffm_attention_fwd(const void* q, const void* k, const void* v, const void* mask,
                                 void* o, void* lse, int n, int L, int d, int dtype,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return ffm::dispatch_fwd<float>(q, k, v, mask, o, lse, n, L, d, s);
  if (dtype == 1) return ffm::dispatch_fwd<__nv_bfloat16>(q, k, v, mask, o, lse, n, L, d, s);
  return cudaErrorInvalidValue;
}

// The launch shape of the tensor-core forward (bf16, d in {16, 32, 64}) for
// an [n, L, d] call: out[0..5] = blocks, threads per block, shared bytes per
// block, resident blocks per SM, registers per thread, local bytes per
// thread.  Other types and widths return cudaErrorInvalidValue.
extern "C" int ffm_attention_fwd_info(int n, int L, int d, int dtype, void* out) {
  int* o = static_cast<int*>(out);
  if (dtype != 1) return cudaErrorInvalidValue;
  switch (d) {
    case 16: return ffm::info_fwd_mma<16>(n, L, o);
    case 32: return ffm::info_fwd_mma<32>(n, L, o);
    case 64: return ffm::info_fwd_mma<64>(n, L, o);
    default: return cudaErrorInvalidValue;
  }
}
