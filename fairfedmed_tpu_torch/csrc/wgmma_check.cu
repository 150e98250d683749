// A unit check of the warpgroup products the attention kernels issue, run on
// the card against torch.matmul before any kernel depends on them (plain C
// interface for ctypes).
//
// One warpgroup copies the operands from device memory into swizzled shared
// tiles with the kernels' own copy (load_tile_swizzled, completing on an
// mbarrier), issues one wgmma product with the kernels' descriptors and
// writes the fp32 accumulator out.  Modes, at head width D (the swizzle of
// the tiles: 128 B at D = 64, 64 B at 32, 32 B at 16):
//   0: C[64, 64] = A[64, D] B[64, D]^T, A and B from shared memory, both
//      K-major (S = Q K^T of the forward);
//   1: C[64, 32] = A[64, D] B[32:64, D]^T, the same with N = 32 at a row
//      offset of 32 (S^T, dP^T, S and dP of the backward);
//   2: C[64, D] = A[64, 64] B[64, D], A from registers (bf16), B MN-major
//      (O += P V), four 16-deep steps down B's rows;
//   3: C[64, D] = A[64, 32] B[32:64, D], A fp32 split into bf16 high and low
//      parts in registers (two products into one accumulator), B MN-major
//      at a row offset of 32 (dV += P^T dO, dK += dS^T Q, dQ += dS K);
//   4: C[64, 16] = A[64, D] B[16:32, D]^T, as 1 with N = 16 at a row offset
//      of 16 (S^T and dP^T of the backward's phase 1).
#include "attention_common.cuh"

namespace ffm {

template <int D, int MODE>
__global__ void __launch_bounds__(128)
wgmma_check_kernel(const void* __restrict__ a, const __nv_bfloat16* __restrict__ b,
                   float* __restrict__ c) {
  using bf16 = __nv_bfloat16;
  constexpr uint32_t TB = WgTile<D>::kBytes;
  constexpr uint32_t RB = WgTile<D>::kRowBytes;
  constexpr int N = MODE == 0 ? 64 : MODE == 1 ? 32 : MODE == 4 ? 16 : D;
  constexpr bool kSS = MODE <= 1 || MODE == 4;  // A from shared memory
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sA = base, sB = base + TB, bar = base + 2 * TB;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  if (tid == 0) {
    mbar_init(bar, 128);
    mbar_init_fence();
  }
  __syncthreads();
  load_tile_swizzled<D>(sB, b, 0, kWgRows, tid, 128);
  if (kSS) load_tile_swizzled<D>(sA, static_cast<const bf16*>(a), 0, kWgRows, tid, 128);
  mbar_arrive_cp_async(bar);
  mbar_wait(bar, 0);

  float acc[N / 8][4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int r0 = 16 * warp + g;  // the thread's rows r0 and r0 + 8
  if constexpr (kSS) {
    const uint64_t da = desc_kmajor<D>(sA), db = desc_kmajor<D>(sB + (N == 64 ? 0 : N * RB));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<N>::template ss<0>(acc, da + kk * kDescK16, db + kk * kDescK16, kk > 0);
  } else if constexpr (MODE == 2) {
    const bf16* A = static_cast<const bf16*>(a);  // [64, 64]
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c0 = 16 * kk + 2 * t;
      af[kk][0] = *reinterpret_cast<const uint32_t*>(A + r0 * 64 + c0);
      af[kk][1] = *reinterpret_cast<const uint32_t*>(A + (r0 + 8) * 64 + c0);
      af[kk][2] = *reinterpret_cast<const uint32_t*>(A + r0 * 64 + c0 + 8);
      af[kk][3] = *reinterpret_cast<const uint32_t*>(A + (r0 + 8) * 64 + c0 + 8);
    }
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<N>::template rs<1>(acc, af[kk], desc_mnmajor<D>(sB + 16 * kk * RB));
  } else {
    const float* A = static_cast<const float*>(a);  // [64, 32]
    uint32_t hi[2][4], lo[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      float c0[4], c1[4];  // the C fragments of columns 16kk.. and 16kk + 8..
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e >> 1);
        c0[e] = A[row * 32 + 16 * kk + 2 * t + (e & 1)];
        c1[e] = A[row * 32 + 16 * kk + 8 + 2 * t + (e & 1)];
      }
      acc_to_a(c0, c1, hi[kk], lo[kk]);
    }
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t db = desc_mnmajor<D>(sB + (32 + 16 * kk) * RB);
      Wgmma<N>::template rs<1>(acc, hi[kk], db);
      Wgmma<N>::template rs<1>(acc, lo[kk], db);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[(r0 + 8 * (e >> 1)) * N + 8 * j + 2 * t + (e & 1)] = acc[j][e];
}

template <int D>
cudaError_t launch_check(const void* a, const void* b, void* c, int mode, cudaStream_t stream) {
  const size_t smem = 1024 + 2 * WgTile<D>::kBytes + 8;
  const auto* bb = static_cast<const __nv_bfloat16*>(b);
  float* cc = static_cast<float*>(c);
  switch (mode) {
    case 0: wgmma_check_kernel<D, 0><<<1, 128, smem, stream>>>(a, bb, cc); break;
    case 1: wgmma_check_kernel<D, 1><<<1, 128, smem, stream>>>(a, bb, cc); break;
    case 2: wgmma_check_kernel<D, 2><<<1, 128, smem, stream>>>(a, bb, cc); break;
    case 3: wgmma_check_kernel<D, 3><<<1, 128, smem, stream>>>(a, bb, cc); break;
    case 4: wgmma_check_kernel<D, 4><<<1, 128, smem, stream>>>(a, bb, cc); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace ffm

// a: bf16 [64, d] (modes 0, 1, 4), bf16 [64, 64] (mode 2) or fp32 [64, 32]
// (mode 3); b: bf16 [64, d]; c: fp32 [64, N] (N = 64, 32, d, d, 16).  Returns
// the CUDA error of the launch (0 on success), asynchronous on `stream`.
extern "C" int ffm_wgmma_check(const void* a, const void* b, void* c, int d, int mode,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return ffm::launch_check<16>(a, b, c, mode, s);
    case 32: return ffm::launch_check<32>(a, b, c, mode, s);
    case 64: return ffm::launch_check<64>(a, b, c, mode, s);
    default: return cudaErrorInvalidValue;
  }
}
