// The split-KV ("flash-decoding") machinery shared by K1
// (decode_attention.cu: a dense (B, S, KV, D) buffer, slots [lo, hi)) and
// K3 (paged_decode_attention.cu: a page pool through a page table).  The
// two kernels differ only in where a tile's rows live and which slots a
// row attends; everything else is here.
//
// A block of kThreads attends one run of a (row, KV head)'s slots for the
// G = H / KV query heads of the group, tile by tile (up to kTile slots):
//   begin_run   q (times scale) into shared memory; running max, sum and
//               accumulator reset;
//   attend_tile stage the tile's K and V rows in shared memory as f32 with
//               the load unit LT (16, 8 or 4 bytes, or one element), each
//               code times its vector's scale when scales are given (int8);
//               each thread computes whole (query head, slot) dot products
//               (rows padded to D + 1 floats: no bank conflicts, no
//               shuffle); one warp per query head updates the running max
//               and sum (online softmax); threads owning (slot group, head,
//               dim) outputs add p x V;
//   end_run     the run's f32 partial (m, l, acc) to the workspace, or an
//               empty one (m = NEG_INF, l = 0) when the run attends nothing;
//   merge_last  the last block of the (row, KV head) to finish -- an atomic
//               ticket after a __threadfence -- reads the partials past L1,
//               merges them with the usual rescaling (empty partials weigh
//               0, so an empty row gives exact zeros), writes the output in
//               q's type and resets its ticket to 0.
// Shared memory holds one tile, so it depends on neither the context nor
// the page size.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace split_decode {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // slots staged at a time
constexpr int kMaxSplit = 64;  // runs per row (the merge holds 64 weights)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The block's shared memory (floats):
//   q_s[G * D] | k_s[kTile * (D + 1)] | v_s[kTile * (D + 1)] |
//   s_s[G * kTile] | acc_s[SG * G * D] | m_s[G] | l_s[G] | a_s[G] |
//   w_s[kMaxSplit * G]
// SG: slot groups of the p x V sums (kThreads / (G * D), at least 1).
struct Block {
  int G, D, GD, SG, tid, lane, warp;
  float *q_s, *k_s, *v_s, *s_s, *acc_s, *m_s, *l_s, *a_s, *w_s;

  __device__ Block(float* smem, int H, int KV, int D_) {
    G = H / KV;
    D = D_;
    GD = G * D;
    SG = max(1, kThreads / GD);
    tid = threadIdx.x;
    lane = tid & 31;
    warp = tid >> 5;
    q_s = smem;
    k_s = q_s + GD;
    v_s = k_s + kTile * (D + 1);
    s_s = v_s + kTile * (D + 1);
    acc_s = s_s + G * kTile;
    m_s = acc_s + SG * GD;
    l_s = m_s + G;
    a_s = l_s + G;
    w_s = a_s + G;
  }
};

// Host: the shared-memory bytes of one launch (the Python wrappers mirror
// it): at most ~149 KB (G 8, D 256), 20 KB at tconst-41m's G 1, D 36.
inline size_t smem_bytes(int H, int KV, int D) {
  const int G = H / KV;
  const int SG = kThreads / (G * D) > 1 ? kThreads / (G * D) : 1;
  return sizeof(float) * (size_t)(G * D + 2 * kTile * (D + 1) + G * kTile +
                                  SG * G * D + 3 * G + kMaxSplit * G);
}

template <typename T>
__device__ __forceinline__ void begin_run(const Block& bk,
                                          const T* __restrict__ q,
                                          size_t q_base, float scale) {
  for (int i = bk.tid; i < bk.GD; i += kThreads)
    bk.q_s[i] = to_f32(q[q_base + i]) * scale;
  for (int i = bk.tid; i < bk.SG * bk.GD; i += kThreads) bk.acc_s[i] = 0.f;
  if (bk.tid < bk.G) {
    bk.m_s[bk.tid] = kNegInf;
    bk.l_s[bk.tid] = 0.f;
  }
}

// One tile of n <= kTile slots whose K / V rows sit at element offsets
// (row0 + r * rstride) * D (r < n); ks / vs: per-row scales at index
// row0 + r * rstride, or nullptr.
template <typename KT, typename LT>
__device__ __forceinline__ void attend_tile(const Block& bk,
                                            const KT* __restrict__ k,
                                            const KT* __restrict__ v,
                                            const float* __restrict__ ks,
                                            const float* __restrict__ vs,
                                            size_t row0, size_t rstride,
                                            int n, float softcap) {
  const int G = bk.G, D = bk.D, tid = bk.tid;
  __syncthreads();  // the previous tile's k_s / v_s / s_s are done
  // stage: a thread loads the same unit of a K row and a V row together
  constexpr int kPer = sizeof(LT) / sizeof(KT);
  const int cpr = D / kPer;  // load units per row
  for (int i = tid; i < n * cpr; i += kThreads) {
    const int r = i / cpr;
    const int c = i - r * cpr;
    const size_t row = row0 + (size_t)r * rstride;
    const LT kraw = reinterpret_cast<const LT*>(k + row * D)[c];
    const LT vraw = reinterpret_cast<const LT*>(v + row * D)[c];
    const float ksc = ks ? ks[row] : 1.f;
    const float vsc = vs ? vs[row] : 1.f;
    const KT* ke = reinterpret_cast<const KT*>(&kraw);
    const KT* ve = reinterpret_cast<const KT*>(&vraw);
    float* ko = bk.k_s + r * (D + 1) + c * kPer;
    float* vo = bk.v_s + r * (D + 1) + c * kPer;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      ko[j] = to_f32(ke[j]) * ksc;
      vo[j] = to_f32(ve[j]) * vsc;
    }
  }
  __syncthreads();
  // scores: each thread owns whole (head, slot) dot products
  for (int i = tid; i < G * n; i += kThreads) {
    const int g = i / n;
    const int r = i - g * n;
    const float* qg = bk.q_s + g * D;
    const float* kr = bk.k_s + r * (D + 1);
    float x = 0.f;
    for (int d = 0; d < D; ++d) x += qg[d] * kr[d];
    if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
    bk.s_s[g * kTile + r] = x;
  }
  __syncthreads();
  // online-softmax update, one warp per query head
  for (int g = bk.warp; g < G; g += kWarps) {
    float* sg = bk.s_s + g * kTile;
    float mx = kNegInf;
    for (int r = bk.lane; r < n; r += 32) mx = fmaxf(mx, sg[r]);
    mx = warp_max(mx);
    const float m_old = bk.m_s[g];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int r = bk.lane; r < n; r += 32) {
      const float e = expf(sg[r] - m_new);
      sg[r] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (bk.lane == 0) {
      const float alpha = expf(m_old - m_new);
      bk.m_s[g] = m_new;
      bk.l_s[g] = bk.l_s[g] * alpha + sum;
      bk.a_s[g] = alpha;
    }
  }
  __syncthreads();
  // p x V: thread owns (slot group, head, dim) entries of acc_s
  for (int i = tid; i < bk.SG * bk.GD; i += kThreads) {
    const int sgi = i / bk.GD;
    const int o = i - sgi * bk.GD;
    const int g = o / D;
    const int d = o - g * D;
    const float* pg = bk.s_s + g * kTile;
    float x = 0.f;
    for (int r = sgi; r < n; r += bk.SG) x += pg[r] * bk.v_s[r * (D + 1) + d];
    bk.acc_s[i] = bk.acc_s[i] * bk.a_s[g] + x;
  }
}

// The run's partial (G rows of m, l, acc[D]) to my_part: after its tiles
// (attended), or empty.
__device__ __forceinline__ void end_run(const Block& bk, float* my_part,
                                        bool attended) {
  const int G = bk.G, D = bk.D, tid = bk.tid;
  if (!attended) {
    if (tid < G) {
      my_part[tid * (D + 2)] = kNegInf;
      my_part[tid * (D + 2) + 1] = 0.f;
    }
    return;
  }
  __syncthreads();
  for (int o = tid; o < bk.GD; o += kThreads) {
    float x = 0.f;
    for (int sg = 0; sg < bk.SG; ++sg) x += bk.acc_s[sg * bk.GD + o];
    const int g = o / D;
    my_part[g * (D + 2) + 2 + (o - g * D)] = x;
  }
  if (tid < G) {
    my_part[tid * (D + 2)] = bk.m_s[tid];
    my_part[tid * (D + 2) + 1] = bk.l_s[tid];
  }
}

// Called by every block of the grid after end_run.  row_part: the
// (n_split, G, D + 2) partials of this (row, KV head); ticket: its int32
// ticket (0 between calls); out: its G x D outputs.
template <typename T>
__device__ __forceinline__ void merge_last(const Block& bk,
                                           const float* row_part,
                                           int* ticket, T* __restrict__ out,
                                           int n_split) {
  __shared__ int last_s;
  const int G = bk.G, D = bk.D, tid = bk.tid;
  const int pstride = G * (D + 2);
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(ticket, 1) == n_split - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // M_g: the largest m of the nonempty partials (l > 0); w = exp(m - M_g)
  if (tid < G) {
    float M = kNegInf;
    for (int s = 0; s < n_split; ++s) {
      const float* ps = row_part + (size_t)s * pstride + tid * (D + 2);
      if (__ldcg(ps + 1) > 0.f) M = fmaxf(M, __ldcg(ps));
    }
    bk.m_s[tid] = M;
  }
  __syncthreads();
  for (int i = tid; i < n_split * G; i += kThreads) {
    const int s = i / G;
    const int g = i - s * G;
    const float* ps = row_part + (size_t)s * pstride + g * (D + 2);
    bk.w_s[i] = __ldcg(ps + 1) > 0.f ? expf(__ldcg(ps) - bk.m_s[g]) : 0.f;
  }
  __syncthreads();
  if (tid < G) {
    float L = 0.f;
    for (int s = 0; s < n_split; ++s)
      L += bk.w_s[s * G + tid] *
           __ldcg(row_part + (size_t)s * pstride + tid * (D + 2) + 1);
    bk.l_s[tid] = L;
  }
  __syncthreads();
  for (int o = tid; o < bk.GD; o += kThreads) {
    const int g = o / D;
    const int d = o - g * D;
    float x = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = bk.w_s[s * G + g];
      if (w != 0.f)
        x += w * __ldcg(row_part + (size_t)s * pstride + g * (D + 2) + 2 + d);
    }
    out[o] = from_f32<T>(x / (bk.l_s[g] + 1e-30f));
  }
  if (tid == 0) *ticket = 0;
}

// Host: raise a kernel's dynamic shared-memory limit above the default
// 48 KB once per instantiation and size (configured: that instantiation's
// static record of the size set).
template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t smem, size_t& configured) {
  if (smem <= configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) configured = smem;
  return err;
}

// Host: call f(LT{}) with the widest load unit (16, 8 or 4 bytes) that
// divides a K/V row of D elements of KT and the buffers' alignment; else
// f(KT{}), element loads.
template <typename KT, typename F>
cudaError_t with_load_unit(const void* k, const void* v, int D, F&& f) {
  const size_t row = (size_t)D * sizeof(KT);
  const uintptr_t al = reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v);
  if (row % 16 == 0 && al % 16 == 0) return f(uint4{});
  if (row % 8 == 0 && al % 8 == 0) return f(uint2{});
  if (row % 4 == 0 && al % 4 == 0) return f(uint32_t{});
  return f(KT{});
}

}  // namespace split_decode
