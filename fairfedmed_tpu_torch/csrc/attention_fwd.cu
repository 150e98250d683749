// Fused attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the Pallas TPU kernel fairfedmed_tpu/ops/attention.py:_fwd_kernel
// (reached through _attend_impl).  Same math: S = q K^T + mask (q arrives
// scaled), softmax over each row in fp32 with P kept in fp32, O = P V cast to
// the input type, and the per-row log-sum-exp (fp32) that the backward uses
// to rebuild P.  Unlike the TPU kernel it does not pad L to 128: the ragged
// tail is masked here, and nothing is padded in device memory.
//
// Bound on the H100: at CLIP's lengths (L = 197 vision, <= 77 text, D = 64)
// the function moves 4 [n, L, D] tensors and does 4 n L^2 D operations, about
// 2 operations per byte -- far below the ~295 the tensor cores need, so the
// memory traffic (reading q, k, v and writing o once) is the bound, and with
// it the latency of getting each tile on chip and through the dependent
// products.  The [L, L] scores never leave the chip.
//
// bf16 at head width 16/32/64 (the main path) runs one of two kernels:
// * L <= 64 (the text towers): attention_fwd_packed_kernel.  One warp owns
//   16 query rows of a (batch*head) slice against all of its keys (one
//   tile, one softmax pass), and a block packs several slices (plan in
//   attention_common.cuh:make_plan), so no warp is launched without rows
//   and shared memory holds L rounded up to 16 rows of Q, K and V per slice
//   (cp.async into padded tiles, ldmatrix, mma.sync).
// * L > 64 (the vision towers): attention_fwd_wgmma_kernel.  A block holds
//   one warpgroup per 64-row query tile of a head (4 at L = 197, 256 / 197
//   rows computed), so the head's K and V are read from device memory once
//   and shared by every warpgroup.  Q, K and V tiles go by cp.async into
//   swizzled shared memory, each tile completing on its own mbarrier.  At
//   L <= 256 the blocks are persistent (one per SM at 4 tiles) and take
//   heads in turn with two buffers: the next head's tiles are issued before
//   this head's products, so the copies run under the compute.  A longer L
//   takes one block per head and group of 4 query tiles and cycles K and V
//   through a ring of 4 slots.  S = Q K^T (both operands from shared
//   memory, K-major) and O += P V (P from registers as bf16 high and low
//   parts, V MN-major) run on wgmma; the last key tile runs only its keys
//   below L rounded up to 16 (a template parameter: no wgmma on a branch).
//   The four warpgroups of an SM overlap one another's softmax and
//   products.  Issuing the next tile's S before this tile's softmax inside
//   a warpgroup was measured and dropped: the second score accumulator
//   pushed the warpgroup past its 128 registers (spills) and ran slower.
// fp32 inputs and the other widths run attention_fwd_kernel on the fp32 CUDA
// cores (4 x 4 register tiles), which keeps fp32 exact to rounding.
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

// The scores of a warp's 16 rows (C-fragment layout, NT 8-column tiles)
// with the mask added and keys at or past L set to -inf: `row` is the row of
// elements 0-1 (elements 2-3 are row + 8), `col` the column of element 0 of
// tile 0 (element e of tile j is col + 8j + (e & 1)).
template <int NT>
__device__ __forceinline__ void mask_scores(float (&s)[NT][4], int row, int col,
                                            const float* __restrict__ mask, int L) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + 8 * (e >> 1);
      const int c = col + 8 * j + (e & 1);
      if (c >= L) {
        s[j][e] = -INFINITY;
      } else if (mask != nullptr && r < L) {
        s[j][e] += mask[(size_t)r * L + c];
      }
    }
}

// One online-softmax step over a warp's 16 rows and 8 NS keys: updates the
// running max m and sum l of rows g and g + 8, turns s into P (relative to
// the new max) and rescales the output accumulator.
template <int NS, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[NS][4], float (&m)[2], float (&l)[2],
                                             float (&oacc)[NO][4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
    const float m_new = fmaxf(m[half], quad_max(mx));
    // a row whose keys so far are all masked (-inf) keeps m = -inf; take 0
    // as the reference then, so exp(-inf - ref) = 0 and never NaN
    const float ref2 = (m_new == -INFINITY ? 0.f : m_new) * kLog2e;
    const float alpha = exp2_approx(fmaf(m[half], kLog2e, -ref2));
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 2 * half; e < 2 * half + 2; ++e) {
        s[j][e] = exp2_approx(fmaf(s[j][e], kLog2e, -ref2));
        rs += s[j][e];
      }
    l[half] = l[half] * alpha + quad_sum(rs);
    m[half] = m_new;
    if (alpha != 1.f) {  // the row's max moved: rescale what was summed so far
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        oacc[j][2 * half] *= alpha;
        oacc[j][2 * half + 1] *= alpha;
      }
    }
  }
}

// O (scaled by 1/l) and the log-sum-exp of a warp's 16 rows from row0.
template <int D>
__device__ __forceinline__ void store_out(__nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                                          const float (&oacc)[D / 8][4], const float (&m)[2],
                                          const float (&l)[2], int row0, int L, int g, int t) {
  // a fully masked row (l = 0) writes zeros and lse = +inf, so the backward
  // rebuilds P = 0 for it
  store_rows_bf16<D>(o, oacc, row0, L, g, t, l[0] > 0.f ? 1.f / l[0] : 0.f,
                     l[1] > 0.f ? 1.f / l[1] : 0.f);
  if (t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + g + 8 * half;
      if (row < L) lse[row] = l[half] > 0.f ? m[half] + logf(l[half]) : INFINITY;
    }
  }
}

// Packed short-row forward (bf16, D in {16, 32, 64}, L <= 64); see the top
// of the file.  Block b holds slices [b*spb, b*spb + spb) of n; warp w owns
// rows 16 (w % wps).. of slice w / wps, wps = ceil(L / 16).
template <int D>
__global__ void __launch_bounds__(128, 4)
attention_fwd_packed_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                            __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int n, int L,
                            int spb) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  const int lp = (L + 15) & ~15;
  const int wps = lp >> 4;
  const int tile = lp * MmaTile<D>::kLd;
  const int slice0 = blockIdx.x * spb;
  const int ns = min(spb, n - slice0);
  for (int s = 0; s < ns; ++s) {
    const size_t base = (size_t)(slice0 + s) * L * D;
    bf16* st = sm + s * 3 * tile;
    load_rows_async<D>(st, q + base, lp, L, threadIdx.x, blockDim.x);
    load_rows_async<D>(st + tile, k + base, lp, L, threadIdx.x, blockDim.x);
    load_rows_async<D>(st + 2 * tile, v + base, lp, L, threadIdx.x, blockDim.x);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int s = warp / wps;
  if (s >= ns) return;  // only in the last block, when spb does not divide n
  const int row0 = (warp - s * wps) * 16;
  const bf16* sQ = sm + s * 3 * tile;
  const bf16* sK = sQ + tile;
  const bf16* sV = sK + tile;
  const size_t base = (size_t)(slice0 + s) * L * D;

  uint32_t qa[MmaTile<D>::kK][4];
#pragma unroll
  for (int kk = 0; kk < MmaTile<D>::kK; ++kk) frag_a<D>(sQ, row0, kk, lane, qa[kk]);
  float sc[8][4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (16 * c < lp) mma_scores<D>(qa, sK, 16 * c, c, lane, sc);
  mask_scores(sc, row0 + g, 2 * t, mask, L);  // also sets the columns past lp
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float oacc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  softmax_step(sc, m, l, oacc);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (16 * kk >= lp) break;
    uint32_t hi[4], lo[4];
    acc_to_a(sc[2 * kk], sc[2 * kk + 1], hi, lo);
    mma_split_tile<D>(hi, lo, sV, 16 * kk, lane, oacc);
  }
  store_out<D>(o + base, lse + (size_t)(slice0 + s) * L, oacc, m, l, row0, L, g, t);
}

// One key tile j of a warpgroup's forward over its first 16 NCH keys (all 64,
// or the last tile's keys below L rounded up to 16): S = Q K_j^T, the online
// softmax, then O += P V_j with P in bf16 high and low parts.  Keys past L
// inside those 16 NCH get P = 0 (and their V rows are zeros).  NCH is a
// template parameter, so no wgmma sits on a branch.
template <int D, int NCH>
__device__ __forceinline__ void fwd_tile(float (&oacc)[D / 8][4], float (&m)[2], float (&l)[2],
                                         uint64_t dq, uint32_t sK, uint32_t sV, uint32_t kbar,
                                         uint32_t vbar, int j, int slots, int fills,
                                         const float* __restrict__ mask, int L, int row,
                                         int col) {
  constexpr uint32_t TB = WgTile<D>::kBytes;
  const int slot = j % slots;
  const int parity = (fills + j / slots) & 1;
  float sc[2 * NCH][4];
  mbar_wait(kbar + 8 * slot, parity);
  wgmma_fence();
  const uint64_t dk = desc_kmajor<D>(sK + slot * TB);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<16 * NCH>::template ss<0>(sc, dq + kk * kDescK16, dk + kk * kDescK16, kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(sc);
  const int n0 = j * kWgRows;
  if (mask != nullptr || n0 + 16 * NCH > L)  // block-uniform: the tail tile or a mask
    mask_scores(sc, row, n0 + col, mask, L);
  softmax_step(sc, m, l, oacc);
  uint32_t hi[NCH][4], lo[NCH][4];
#pragma unroll
  for (int kk = 0; kk < NCH; ++kk) acc_to_a(sc[2 * kk], sc[2 * kk + 1], hi[kk], lo[kk]);
  mbar_wait(vbar + 8 * slot, parity);
  fence_acc(oacc);
  wgmma_fence();
  const uint64_t dv = desc_mnmajor<D>(sV + slot * TB);
#pragma unroll
  for (int kk = 0; kk < NCH; ++kk) {
    const uint64_t dvk = dv + ((16 * kk * WgTile<D>::kRowBytes) >> 4);
    Wgmma<D>::template rs<1>(oacc, hi[kk], dvk);
    Wgmma<D>::template rs<1>(oacc, lo[kk], dvk);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(oacc);
}

// Issues the copies of work item `item` (query group grp of head h, item =
// h * groups + grp) into one buffer: its `slots` query tiles and the first
// `slots` key and value tiles, each tile group arriving on its barrier.
template <int D>
__device__ __forceinline__ void fwd_issue(const __nv_bfloat16* __restrict__ q,
                                          const __nv_bfloat16* __restrict__ k,
                                          const __nv_bfloat16* __restrict__ v, int item,
                                          int groups, int L, int slots, uint32_t sQ, uint32_t sK,
                                          uint32_t sV, uint32_t qbar, uint32_t kbar,
                                          uint32_t vbar, int tid, int nthr) {
  constexpr uint32_t TB = WgTile<D>::kBytes;
  const int head = item / groups;
  const int q0 = (item - head * groups) * slots;
  const size_t hb = (size_t)head * L * D;
  for (int w = 0; w < slots; ++w)
    load_tile_swizzled<D>(sQ + w * TB, q + hb, (q0 + w) * kWgRows, L, tid, nthr);
  mbar_arrive_cp_async(qbar);
  for (int j = 0; j < slots; ++j) {
    load_tile_swizzled<D>(sK + j * TB, k + hb, j * kWgRows, L, tid, nthr);
    mbar_arrive_cp_async(kbar + 8 * j);
    load_tile_swizzled<D>(sV + j * TB, v + hb, j * kWgRows, L, tid, nthr);
    mbar_arrive_cp_async(vbar + 8 * j);
  }
}

// Warpgroup forward (bf16, D in {16, 32, 64}, L > 64); see the top of the
// file.  TAIL = 16-key steps of the last key tile below L, rounded up (1-4).  A work item is one head's group of `slots` query tiles (item =
// head * groups + grp; warpgroup w owns query tile grp*slots + w, and past
// the last tile computes on zeros and stores nothing).  At L <= 256 (one
// group, every tile resident) the blocks are persistent: block b takes items
// b, b + gridDim.x, ... and two buffers alternate, so the next item's tiles
// land while this one computes.  Beyond, each block takes one item and key
// tile j cycles through slot j % slots, filled for the (j / slots)-th time.
// Shared memory (from a 1024-byte aligned base): per buffer `slots` Q
// tiles, `slots` K and V slots; then per buffer the mbarriers (Q, K[slots],
// V[slots]).  (n is unused: the packed kernel's signature.)
template <int D, int TAIL>
__global__ void __launch_bounds__(512, 1)
attention_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                           __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int n, int L,
                           int groups) {
  constexpr uint32_t TB = WgTile<D>::kBytes;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int nt = (L + kWgRows - 1) / kWgRows;
  const int slots = blockDim.x >> 7;
  const bool resident = nt <= slots;  // one group: persistent blocks, two buffers
  const int items = n * groups;
  const uint32_t buf_bytes = 3 * slots * TB, bar_bytes = 8 * (1 + 2 * slots);
  const uint32_t bars = base + (resident ? 2 : 1) * buf_bytes;
  const int tid = threadIdx.x, nthr = blockDim.x;

  if (tid == 0) {
    for (uint32_t b = bars; b < bars + (resident ? 2 : 1) * bar_bytes; b += 8) mbar_init(b, nthr);
    mbar_init_fence();
  }
  __syncthreads();
  fwd_issue<D>(q, k, v, blockIdx.x, groups, L, slots, base, base + slots * TB,
               base + 2 * slots * TB, bars, bars + 8, bars + 8 + 8 * slots, tid, nthr);

  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;  // in the warpgroup: rows 16*warp..
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int it = 0, item = blockIdx.x; item < items; ++it, item += gridDim.x) {
    const int buf = resident ? it & 1 : 0;
    const uint32_t sQ = base + buf * buf_bytes, sK = sQ + slots * TB, sV = sK + slots * TB;
    const uint32_t qbar = bars + buf * bar_bytes, kbar = qbar + 8, vbar = kbar + 8 * slots;
    const int fills = resident ? it >> 1 : 0;  // earlier fills of this buffer's barriers
    if (resident && item + (int)gridDim.x < items) {  // the next item into the other buffer
      const uint32_t nQ = base + (buf ^ 1) * buf_bytes, nbar = bars + (buf ^ 1) * bar_bytes;
      fwd_issue<D>(q, k, v, item + gridDim.x, groups, L, slots, nQ, nQ + slots * TB,
                   nQ + 2 * slots * TB, nbar, nbar + 8, nbar + 8 + 8 * slots, tid, nthr);
    }
    const int head = item / groups;
    const int qt = (item - head * groups) * slots + wg;
    const size_t hb = (size_t)head * L * D;
    const int row0 = qt * kWgRows + 16 * warp;
    const uint64_t dq = desc_kmajor<D>(sQ + wg * TB);

    float oacc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    mbar_wait(qbar, fills & 1);
    for (int j = 0; j + 1 < nt; ++j) {
      fwd_tile<D, 4>(oacc, m, l, dq, sK, sV, kbar, vbar, j, slots, fills, mask, L, row0 + g,
                     2 * t);
      if (j + slots < nt) {  // block-uniform: refill this slot with key tile j + slots
        const int slot = j % slots;
        __syncthreads();  // every warpgroup is done with it
        load_tile_swizzled<D>(sK + slot * TB, k + hb, (j + slots) * kWgRows, L, tid, nthr);
        mbar_arrive_cp_async(kbar + 8 * slot);
        load_tile_swizzled<D>(sV + slot * TB, v + hb, (j + slots) * kWgRows, L, tid, nthr);
        mbar_arrive_cp_async(vbar + 8 * slot);
      }
    }
    fwd_tile<D, TAIL>(oacc, m, l, dq, sK, sV, kbar, vbar, nt - 1, slots, fills, mask, L, row0 + g,
                      2 * t);
    if (qt < nt) store_out<D>(o + hb, lse + (size_t)head * L, oacc, m, l, row0, L, g, t);
    __syncthreads();  // every warpgroup is done with this buffer before it is refilled
  }
}

// The forward kernel of plan `p` for [n, L] at head width D: the packed one,
// or the warpgroup one for L's last key tile.
template <int D>
auto fwd_kernel(const Plan& p, int L) {
  if (p.packed) return attention_fwd_packed_kernel<D>;
  switch (((L - 1) % kWgRows) / 16) {
    case 0: return attention_fwd_wgmma_kernel<D, 1>;
    case 1: return attention_fwd_wgmma_kernel<D, 2>;
    case 2: return attention_fwd_wgmma_kernel<D, 3>;
    default: return attention_fwd_wgmma_kernel<D, 4>;
  }
}

template <int D>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v, const void* mask, void* o,
                           void* lse, int n, int L, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const Plan p = make_plan(0, n, L, D, device_sms());
  const auto kernel = fwd_kernel<D>(p, L);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.blocks, p.threads, p.smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(mask), static_cast<bf16*>(o), static_cast<float*>(lse), n, L,
      p.packed ? p.slices : p.groups);  // slices per block, or query groups per head
  return cudaGetLastError();
}

template <int D>
cudaError_t info_fwd_mma(int n, int L, int* out) {
  const Plan p = make_plan(0, n, L, D, device_sms());
  return kernel_info(fwd_kernel<D>(p, L), p, out);
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

// The launch of the tensor-core forward (bf16, d in {16, 32, 64}) for an
// [n, L, d] call: out[0..7] = blocks, threads per block, shared bytes per
// block, resident blocks per SM, registers per thread, local bytes per
// thread, slices per block (packed kernel; 0 for the warpgroup kernel),
// launches per call.  Other types and widths return cudaErrorInvalidValue.
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
