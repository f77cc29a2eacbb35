// K3: one-query decode attention over a shared page pool, for NVIDIA Hopper
// (sm_90a).  Built by repro_torch/kernels/_build.py with nvcc into a shared
// library with a plain C interface (loaded by ctypes).
//
// Replaces: src/repro/kernels/paged_decode_attention.py,
// paged_decode_attention_pallas (body _paged_kernel) -- the TPU kernel that
// attends a paged KV field (TLinFormer's O(N) history KV) without ever
// materialising the dense (B, max_len, KV, D) view.  Each row walks its
// own page table; slots [lo, valid_len) are attended, lo = valid_len -
// window when window > 0, else 0.  Masked-safe softmax: a row with no
// valid slot gives zeros (finite NEG_INF, +1e-30 in the denominator).
//
// Layouts: q (B, H, D); pools k, v (P + 1, page, KV, D), the last page
// being the trash page that unassigned table entries point at; page_table
// (B, pps) int32; valid_len (B,) int32; out (B, H, D) in q's type.  Float
// pools have q's type (f32 or bf16).  int8 pools (paged_decode_int8_fwd)
// come with (P + 1, page, KV, 1) float32 scale pools, dequantised inside
// the QK and PV loops (k * scale, element by element).  f32 arithmetic.
//
// Design: one block per (KV head, row) computes the G = H / KV query heads
// of the group.  Where the TPU kernel gets each page id by scalar prefetch
// and carries the online softmax across a sequential grid dimension, the
// block here loads its own page ids from the table and loops over its
// pages, from floor(lo / page) to ceil(valid_len / page) only (the Pallas
// grid walks all pps pages; pages outside the range hold no attended slot,
// so the values are the same).  Per page: warps take slots in turn, lanes
// split the head dim (element loads: a bf16 row of head_dim 36 is 72
// bytes, an int8 row 36, so 16-byte vector loads would be misaligned), a
// warp shuffle sums each dot product and the page's scores go to shared
// memory; one warp per query head updates the running max and denominator
// (online softmax); then warps accumulate p * V into per-warp registers,
// rescaled by exp(m_old - m_new), and a last cross-warp reduction through
// shared memory writes the output.  Shared memory holds one page of
// scores, so it does not grow with the context.
//
// What bounds it on an H100: bytes.  A row reads valid_len x KV x D keys
// and values once (plus the scales) and does 4 x H x D flops per slot --
// a few flops per byte, far below the ~295 flop/byte ridge.  This is the
// simple correct version: splitting the pages of a long row across blocks
// with a combine pass (flash-decoding), vector loads and TMA are later
// work.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;  // query heads per KV head

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

// T: q / out type; KT: pool element type (T, or int8_t with scale pools
// ks / vs; nullptr scales mean 1).  DPL: head-dim elements per lane.
// grid (KV, B), block kThreads.  Shared memory (floats):
//   q_s[G * D] | s_s[G * page] | red_s[kWarps * G * D] | m_s[G] | l_s[G] |
//   a_s[G]
template <typename T, typename KT, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const KT* __restrict__ pk,
                    const KT* __restrict__ pv, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ page_table,
                    const int* __restrict__ valid_len, T* __restrict__ out,
                    int H, int KV, int D, int page, int pps, float scale,
                    float softcap, int window) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* q_s = smem;
  float* s_s = q_s + G * D;
  float* red_s = s_s + G * page;
  float* m_s = red_s + kWarps * G * D;
  float* l_s = m_s + G;
  float* a_s = l_s + G;

  const int hi = max(min(valid_len[b], pps * page), 0);
  const int lo = window > 0 ? max(hi - window, 0) : 0;

  const size_t q_base = ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    q_s[i] = to_f32(q[q_base + i]) * scale;
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  float acc[kMaxG][DPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;

  const int* pt = page_table + (size_t)b * pps;
  const int p0 = lo / page;
  const int p1 = (hi + page - 1) / page;
  for (int pj = p0; pj < p1; ++pj) {
    const int pid = pt[pj];
    const int t0 = max(lo - pj * page, 0);    // attended offsets [t0, t1)
    const int t1 = min(hi - pj * page, page);
    // (pid, 0, kvh) as a row of the ((P + 1) * page * KV) vectors
    const size_t row0 = (size_t)pid * page * KV + kvh;

    // pass 1: this page's scores
    for (int t = t0 + warp; t < t1; t += kWarps) {
      const size_t row = row0 + (size_t)t * KV;
      const KT* kr = pk + row * D;
      const float sk = ks ? ks[row] : 1.f;
      float kd[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        kd[i] = d < D ? to_f32(kr[d]) * sk : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < D) s += q_s[g * D + d] * kd[i];
          }
          s = warp_sum(s);
          if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
          if (lane == 0) s_s[g * page + t] = s;
        }
      }
    }
    __syncthreads();

    // pass 2: online-softmax update, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int t = t0 + lane; t < t1; t += 32)
        mx = fmaxf(mx, s_s[g * page + t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = t0 + lane; t < t1; t += 32) {
        const float e = expf(s_s[g * page + t] - m_new);
        s_s[g * page + t] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[g] = m_new;
        l_s[g] = l_s[g] * alpha + sum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // pass 3: rescale the running p @ V, add this page's
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float alpha = a_s[g];
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
      }
    }
    for (int t = t0 + warp; t < t1; t += kWarps) {
      const size_t row = row0 + (size_t)t * KV;
      const KT* vr = pv + row * D;
      const float sv = vs ? vs[row] : 1.f;
      float vd[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        vd[i] = d < D ? to_f32(vr[d]) * sv : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float p = s_s[g * page + t];
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] += p * vd[i];
        }
      }
    }
    __syncthreads();   // the next page reuses s_s and a_s
  }

#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (g < G && d < D) red_s[(warp * G + g) * D + d] = acc[g][i];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red_s[w * G * D + i];
    out[q_base + i] = from_f32<T>(s / (l_s[i / D] + 1e-30f));
  }
}

template <typename T, typename KT, int DPL>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const float* ks, const float* vs, const void* pt,
                   const void* vl, void* out, int B, int H, int KV, int D,
                   int page, int pps, float scale, float softcap, int window,
                   size_t smem, cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  auto kernel = paged_decode_kernel<T, KT, DPL>;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  kernel<<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(pk),
      static_cast<const KT*>(pv), ks, vs, static_cast<const int*>(pt),
      static_cast<const int*>(vl), static_cast<T*>(out), H, KV, D, page, pps,
      scale, softcap, window);
  return cudaGetLastError();
}

template <typename T, typename KT>
cudaError_t launch_dpl(const void* q, const void* pk, const void* pv,
                       const float* ks, const float* vs, const void* pt,
                       const void* vl, void* out, int B, int H, int KV, int D,
                       int page, int pps, float scale, float softcap,
                       int window, size_t smem, cudaStream_t st) {
  const int dpl = (D + 31) / 32;
  if (dpl <= 1)
    return launch<T, KT, 1>(q, pk, pv, ks, vs, pt, vl, out, B, H, KV, D, page,
                            pps, scale, softcap, window, smem, st);
  if (dpl <= 2)
    return launch<T, KT, 2>(q, pk, pv, ks, vs, pt, vl, out, B, H, KV, D, page,
                            pps, scale, softcap, window, smem, st);
  if (dpl <= 4)
    return launch<T, KT, 4>(q, pk, pv, ks, vs, pt, vl, out, B, H, KV, D, page,
                            pps, scale, softcap, window, smem, st);
  return launch<T, KT, 8>(q, pk, pv, ks, vs, pt, vl, out, B, H, KV, D, page,
                          pps, scale, softcap, window, smem, st);
}

// Shared-memory bytes one launch needs (the Python wrapper computes the
// same number and raises above the 227 KB a block can have).
size_t smem_bytes(int H, int KV, int D, int page) {
  const int G = H / KV;
  return sizeof(float) * (size_t)(G * D + G * page + kWarps * G * D + 3 * G);
}

}  // namespace

extern "C" {

// Float pools: dtype 0 = float32, 1 = bfloat16 (q, pools and out).
// Returns the launch's cudaError_t.  The caller validates shapes (G <= 8,
// D <= 256, shared memory <= 227 KB); every table entry must be a page of
// the pool (the layouts only ever write pages in [0, P], P being trash).
int paged_decode_fwd(const void* q, const void* pk, const void* pv,
                     const void* page_table, const void* valid_len, void* out,
                     int B, int H, int KV, int D, int page, int pps,
                     float scale, float softcap, int window, int dtype,
                     void* stream) {
  if (B == 0 || KV == 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(H, KV, D, page);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dpl<float, float>(q, pk, pv, nullptr, nullptr,
                                         page_table, valid_len, out, B, H, KV,
                                         D, page, pps, scale, softcap, window,
                                         smem, st);
  return (int)launch_dpl<__nv_bfloat16, __nv_bfloat16>(
      q, pk, pv, nullptr, nullptr, page_table, valid_len, out, B, H, KV, D,
      page, pps, scale, softcap, window, smem, st);
}

// int8 pools with (P + 1, page, KV, 1) float32 scale pools; dtype is q's
// and out's (0 = float32, 1 = bfloat16).  Same contract as
// paged_decode_fwd.
int paged_decode_int8_fwd(const void* q, const void* pk, const void* pv,
                          const void* ks, const void* vs,
                          const void* page_table, const void* valid_len,
                          void* out, int B, int H, int KV, int D, int page,
                          int pps, float scale, float softcap, int window,
                          int dtype, void* stream) {
  if (B == 0 || KV == 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(H, KV, D, page);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  if (dtype == 0)
    return (int)launch_dpl<float, int8_t>(q, pk, pv, ksf, vsf, page_table,
                                          valid_len, out, B, H, KV, D, page,
                                          pps, scale, softcap, window, smem,
                                          st);
  return (int)launch_dpl<__nv_bfloat16, int8_t>(
      q, pk, pv, ksf, vsf, page_table, valid_len, out, B, H, KV, D, page, pps,
      scale, softcap, window, smem, st);
}

}  // extern "C"
