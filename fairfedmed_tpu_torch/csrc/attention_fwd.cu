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
// memory traffic (reading q, k, v and writing o once) is the bound.  The
// design keeps the [L, L] scores out of device memory: one block per
// (batch*head, 64 query rows) streams 64-key tiles of K and V through shared
// memory with an online softmax, and writes only O and the per-row
// log-sum-exp (fp32) that the backward uses to rebuild P.  bf16 inputs with a
// head width of 16, 32 or 64 (the main path) run the products on the tensor
// cores (mma.sync, P split into bf16 high and low parts); fp32 inputs and the
// other widths run them on the fp32 CUDA cores (4 x 4 register tiles), which
// keeps fp32 exact to rounding.  Neither path double-buffers its loads yet.
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

// Tensor-core forward (bf16, D in {16, 32, 64}): 4 warps, each owning 16
// query rows; S = Q K^T and O += P V on mma.sync, P split high/low.
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
attention_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                         __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int L) {
  __shared__ __align__(16) __nv_bfloat16 sK[MmaTile<D>::kElems];   // Q first, then K tiles
  __shared__ __align__(16) __nv_bfloat16 sVt[MmaTile<D>::kElemsT];  // V tiles, transposed

  const int bh = blockIdx.y;
  const int m0 = blockIdx.x * kBlock;
  const size_t base = (size_t)bh * L * D;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = warp * 16;  // the warp's first row in the tile

  uint32_t qa[MmaTile<D>::kK][4];
  load_rows_bf16<D>(sK, nullptr, q + base, m0, L);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < MmaTile<D>::kK; ++kk) load_a<D>(sK, wrow, kk, g, t, qa[kk]);

  float oacc[MmaTile<D>::kN][4];
#pragma unroll
  for (int nt = 0; nt < MmaTile<D>::kN; ++nt) oacc[nt][0] = oacc[nt][1] = oacc[nt][2] = oacc[nt][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  const int rows[2] = {m0 + wrow + g, m0 + wrow + g + 8};

  for (int n0 = 0; n0 < L; n0 += kBlock) {
    __syncthreads();  // Q fragments loaded / previous tile's readers done
    load_rows_bf16<D>(sK, nullptr, k + base, n0, L);
    load_rows_bf16<D>(nullptr, sVt, v + base, n0, L);
    __syncthreads();

    float s[8][4];
    mma_rows_nt<D>(qa, sK, g, t, s);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = rows[half];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * j + 2 * t + e;
          float& x = s[j][2 * half + e];
          if (col >= L) {
            x = -INFINITY;
          } else if (mask != nullptr && row < L) {
            x += mask[(size_t)row * L + col];
          }
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m_r[half], quad_max(mx));
      const float ref = m_new == -INFINITY ? 0.f : m_new;  // see the scalar kernel
      const float alpha = expf(m_r[half] - ref);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * half + e];
          x = expf(x - ref);
          rs += x;
        }
      l_r[half] = l_r[half] * alpha + quad_sum(rs);
      m_r[half] = m_new;
#pragma unroll
      for (int nt = 0; nt < MmaTile<D>::kN; ++nt) {
        oacc[nt][2 * half] *= alpha;
        oacc[nt][2 * half + 1] *= alpha;
      }
    }
    mma_acc_tn<D>(s, sVt, g, t, oacc);
  }

  const float inv0 = l_r[0] > 0.f ? 1.f / l_r[0] : 0.f;
  const float inv1 = l_r[1] > 0.f ? 1.f / l_r[1] : 0.f;
  store_rows_bf16<D>(o + base, oacc, m0 + wrow, L, g, t, inv0, inv1);
  if (t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
      if (rows[half] < L)
        lse[(size_t)bh * L + rows[half]] =
            l_r[half] > 0.f ? m_r[half] + logf(l_r[half]) : INFINITY;
  }
}

template <int D>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, const void* mask, void* o,
                           void* lse, int n, int L, cudaStream_t stream) {
  const dim3 grid((L + kBlock - 1) / kBlock, n);
  attention_fwd_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), L);
  return cudaGetLastError();
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
