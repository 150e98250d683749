// Rotary positions applied while a packed q/k/v projection is split into
// heads, forward and backward, for Hopper (sm_90a); plain C interface for
// ctypes (ops/rope.py).
//
// Replaces no TPU kernel: the JAX package has no rotary tower.  It was added
// for EVA02-CLIP's vision tower (models/eva_clip.py), whose attention rotates
// q and k of every token but the class token (2D RoPE, interleaved pairs)
// before the attention kernels, which take q scaled by dh^-0.5 and q, k, v as
// contiguous [B*H, L, dh] tensors.
//
// Bound on the H100: pure data movement, ~1 operation per byte.  The forward
// reads the [B, L, 3D] projection once and writes q, k, v once (2 x 3 B L D
// elements; at the training step's [32, 577, 3072] in bf16, 227 MB, 68 us
// at 3.35 TB/s); the backward the same in reverse.  The fp32 cos / sin
// tables ([L-1, dh], 148 KB each at L = 577) stay in L2.  So the design
// moves each element once, 16 bytes a thread for bf16 (8 elements, so a head
// of 64 is 8 threads and a warp reads 512 contiguous bytes of the packed
// row), in place of the ~10 passes a split, transposes, rotations, concats
// and a scale make in PyTorch operations.  Each thread computes in fp32 and
// rounds once to the output type.  Writes go to 128-byte head rows, each
// written whole by 8 neighbouring threads.  A grid-stride loop over
// (token, 8-element chunk) covers any B and L.
//
//   y = u cos + r(u) sin,   r(u)_{2i} = -u_{2i+1},  r(u)_{2i+1} = u_{2i}
//   du = dy cos + r^T(dy sin),   r^T(z)_{2i} = z_{2i+1},  r^T(z)_{2i+1} = -z_{2i}
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ffm {

constexpr int kRopeThreads = 256;
constexpr int kRopeMaxBlocks = 132 * 16;

__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float* x) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    x[2 * j] = f.x;
    x[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* x) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(x[2 * j], x[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Where chunk i (8 elements) of the packed [B, L, 3D] tensor lies: its
// token (b L + l), the part (0 q, 1 k, 2 v), and its place in the head
// tensor [B*H, L, dh].
struct Chunk {
  long long packed;  // element offset in [B, L, 3D]
  long long head;    // element offset in the part's [B*H, L, dh]
  int part;
  int l;
  int d0;
};

__device__ __forceinline__ Chunk locate(long long i, int L, int H, int dh) {
  const int d = H * dh;
  const int chunks = 3 * d / 8;
  const long long tok = i / chunks;
  const int e = static_cast<int>(i - tok * chunks) * 8;
  Chunk c;
  c.part = e / d;
  const int within = e - c.part * d;
  const int h = within / dh;
  c.d0 = within - h * dh;
  c.l = static_cast<int>(tok % L);
  const long long b = tok / L;
  c.packed = tok * 3 * d + e;
  c.head = ((b * H + h) * L + c.l) * dh + c.d0;
  return c;
}

template <typename T>
__global__ void __launch_bounds__(kRopeThreads)
rope_qkv_fwd(const T* __restrict__ qkv, const float* __restrict__ cos_t,
             const float* __restrict__ sin_t, T* __restrict__ q, T* __restrict__ k,
             T* __restrict__ v, int B, int L, int H, int dh) {
  const long long total = static_cast<long long>(B) * L * (3 * H * dh / 8);
  const float scale = rsqrtf(static_cast<float>(dh));
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const Chunk c = locate(i, L, H, dh);
    float x[8];
    load8(qkv + c.packed, x);
    if (c.part < 2 && c.l > 0) {
      float cs[8], sn[8];
      load8(cos_t + static_cast<long long>(c.l - 1) * dh + c.d0, cs);
      load8(sin_t + static_cast<long long>(c.l - 1) * dh + c.d0, sn);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const float u0 = x[j], u1 = x[j + 1];
        x[j] = u0 * cs[j] - u1 * sn[j];
        x[j + 1] = u1 * cs[j + 1] + u0 * sn[j + 1];
      }
    }
    if (c.part == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] *= scale;
    }
    T* out = c.part == 0 ? q : (c.part == 1 ? k : v);
    store8(out + c.head, x);
  }
}

template <typename T>
__global__ void __launch_bounds__(kRopeThreads)
rope_qkv_bwd(const T* __restrict__ dq, const T* __restrict__ dk, const T* __restrict__ dv,
             const float* __restrict__ cos_t, const float* __restrict__ sin_t,
             T* __restrict__ dqkv, int B, int L, int H, int dh) {
  const long long total = static_cast<long long>(B) * L * (3 * H * dh / 8);
  const float scale = rsqrtf(static_cast<float>(dh));
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const Chunk c = locate(i, L, H, dh);
    const T* in = c.part == 0 ? dq : (c.part == 1 ? dk : dv);
    float g[8];
    load8(in + c.head, g);
    if (c.part < 2 && c.l > 0) {
      float cs[8], sn[8];
      load8(cos_t + static_cast<long long>(c.l - 1) * dh + c.d0, cs);
      load8(sin_t + static_cast<long long>(c.l - 1) * dh + c.d0, sn);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const float g0 = g[j], g1 = g[j + 1];
        g[j] = g0 * cs[j] + g1 * sn[j + 1];
        g[j + 1] = g1 * cs[j + 1] - g0 * sn[j];
      }
    }
    if (c.part == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) g[j] *= scale;
    }
    store8(dqkv + c.packed, g);
  }
}

inline int blocks_for(int B, int L, int H, int dh) {
  const long long total = static_cast<long long>(B) * L * (3 * H * dh / 8);
  const long long blocks = (total + kRopeThreads - 1) / kRopeThreads;
  return static_cast<int>(blocks < kRopeMaxBlocks ? blocks : kRopeMaxBlocks);
}

inline bool valid(int B, int L, int H, int dh) {
  return B > 0 && L > 1 && H > 0 && dh > 0 && dh % 8 == 0;
}

template <typename T>
int launch_fwd(const void* qkv, const void* cos_t, const void* sin_t, void* q, void* k, void* v,
               int B, int L, int H, int dh, cudaStream_t s) {
  rope_qkv_fwd<T><<<blocks_for(B, L, H, dh), kRopeThreads, 0, s>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<T*>(q), static_cast<T*>(k),
      static_cast<T*>(v), B, L, H, dh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* dq, const void* dk, const void* dv, const void* cos_t,
               const void* sin_t, void* dqkv, int B, int L, int H, int dh, cudaStream_t s) {
  rope_qkv_bwd<T><<<blocks_for(B, L, H, dh), kRopeThreads, 0, s>>>(
      static_cast<const T*>(dq), static_cast<const T*>(dk), static_cast<const T*>(dv),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<T*>(dqkv), B, L, H, dh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ffm

// Forward: qkv [B, L, 3 H dh] -> q (scaled by dh^-0.5), k, v [B*H, L, dh];
// cos / sin fp32 [L-1, dh]; dtype 0 fp32, 1 bf16.  Asynchronous on
// `stream`; returns the launch's CUDA error (0 on success).
extern "C" int ffm_rope_qkv_fwd(const void* qkv, const void* cos_t, const void* sin_t, void* q,
                                void* k, void* v, int B, int L, int H, int dh, int dtype,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!ffm::valid(B, L, H, dh)) return cudaErrorInvalidValue;
  if (dtype == 0) return ffm::launch_fwd<float>(qkv, cos_t, sin_t, q, k, v, B, L, H, dh, s);
  if (dtype == 1)
    return ffm::launch_fwd<__nv_bfloat16>(qkv, cos_t, sin_t, q, k, v, B, L, H, dh, s);
  return cudaErrorInvalidValue;
}

// Backward: dq, dk, dv [B*H, L, dh] -> dqkv [B, L, 3 H dh].
extern "C" int ffm_rope_qkv_bwd(const void* dq, const void* dk, const void* dv,
                                const void* cos_t, const void* sin_t, void* dqkv, int B, int L,
                                int H, int dh, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!ffm::valid(B, L, H, dh)) return cudaErrorInvalidValue;
  if (dtype == 0) return ffm::launch_bwd<float>(dq, dk, dv, cos_t, sin_t, dqkv, B, L, H, dh, s);
  if (dtype == 1)
    return ffm::launch_bwd<__nv_bfloat16>(dq, dk, dv, cos_t, sin_t, dqkv, B, L, H, dh, s);
  return cudaErrorInvalidValue;
}
