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
// come with (P + 1, page, KV, 1) float32 scale pools, each code times its
// vector's scale once as it is staged.  f32 arithmetic.
//
// What bounds it on an H100: bytes.  A row reads (valid_len - lo) x KV x D
// keys and values once (plus the scales) and does 4 x H x D flops per
// slot -- a few flops per byte, far below the ~295 flop/byte ridge: the
// bound is ~1 us at the history shape.  What held the first version back
// was parallelism and latency, not bandwidth: one block per (KV head, row)
// walked a whole row's pages in order (36 blocks on 132 SMs at B 3), a
// 5-level warp shuffle summed every slot's dot product, and loads were
// 2-byte elements.
//
// Design (split-KV, "flash-decoding"): the grid is (KV, B, n_split).  The
// host plans n_split from pps and page alone (paged_decode_attention.py,
// split_plan: runs of pages_per_split pages, at most 64 runs, at least 64
// slots a run) -- never from valid_len, which lives on the device.  Block
// (kvh, b, s) takes pages [s * pages_per_split, (s + 1) * pages_per_split)
// intersected with the row's floor(lo / page) .. ceil(valid_len / page); a
// block whose run holds no attended slot writes an empty partial (l = 0)
// and does nothing else.  Otherwise, per tile of up to 64 slots of a page:
// the block stages the tile's K and V rows in shared memory as f32 with
// vector loads (16, 8 or 4 bytes: a bf16 row of head_dim 36 is 72 bytes =
// 9 x 8, an int8 row 36 = 9 x 4; the widest width that divides the row and
// the pools' alignment), consecutive threads on consecutive words of a
// row; each thread then computes whole (query head, slot) dot products from
// shared memory (rows padded to D + 1 floats: no bank conflicts, no
// shuffle); one warp per query head updates the running max and sum; the
// threads, each owning (head, dim, slot-group) outputs, add p x V.  The
// block's partial (m, l, acc for the G = H / KV query heads of the group)
// goes in f32 to a workspace the wrapper allocates; the last block of a
// (row, KV head) to finish -- an atomic ticket per (row, KV head) in a
// small int32 buffer the wrapper zeroes once and keeps -- merges the
// partials with the usual rescaling, writes the output and resets its
// ticket to 0.  One launch per call.  Shared memory holds one tile (64
// slots), so it does not grow with the page or the context, and pps has
// no limit beyond the table's shape.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;      // slots staged at a time
constexpr int kMaxSplit = 64;  // runs of pages per row (split_plan)

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

// Stage n rows of a tile (row r at element offset (row0 + r * rstride) * D)
// into dst[r * (D + 1) + d] as f32, times the row's scale when sc is given.
// LT is the load unit (uint4, uint2, uint32_t or KT itself).
template <typename KT, typename LT>
__device__ __forceinline__ void stage_rows(float* dst, const KT* __restrict__ src,
                                           const float* __restrict__ sc,
                                           size_t row0, size_t rstride, int n,
                                           int D, int tid) {
  constexpr int kPer = sizeof(LT) / sizeof(KT);
  const int cpr = D / kPer;  // load units per row
  for (int i = tid; i < n * cpr; i += kThreads) {
    const int r = i / cpr;
    const int c = i - r * cpr;
    const size_t row = row0 + (size_t)r * rstride;
    const LT raw = reinterpret_cast<const LT*>(src + row * D)[c];
    const float s = sc ? sc[row] : 1.f;
    const KT* e = reinterpret_cast<const KT*>(&raw);
    float* o = dst + r * (D + 1) + c * kPer;
#pragma unroll
    for (int j = 0; j < kPer; ++j) o[j] = to_f32(e[j]) * s;
  }
}

// T: q / out type; KT: pool element type (T, or int8_t with scale pools
// ks / vs; nullptr scales mean 1); LT: the load unit.  grid (KV, B,
// n_split), block kThreads.  part: (B, KV, n_split, G, D + 2) f32 partials
// (m, l, acc); tickets: (B * KV) int32, 0 between calls.  Dynamic shared
// memory (floats):
//   q_s[G * D] | k_s[kTile * (D + 1)] | v_s[kTile * (D + 1)] |
//   s_s[G * kTile] | acc_s[SG * G * D] | m_s[G] | l_s[G] | a_s[G] |
//   w_s[kMaxSplit * G]
template <typename T, typename KT, typename LT>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const KT* __restrict__ pk,
                   const KT* __restrict__ pv, const float* __restrict__ ks,
                   const float* __restrict__ vs,
                   const int* __restrict__ page_table,
                   const int* __restrict__ valid_len, T* __restrict__ out,
                   float* __restrict__ part, int* __restrict__ tickets, int H,
                   int KV, int D, int page, int pps, int pages_per_split,
                   int n_split, float scale, float softcap, int window) {
  extern __shared__ float smem[];
  __shared__ int last_s;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int G = H / KV;
  const int GD = G * D;
  const int SG = max(1, kThreads / GD);  // slot groups of the p x V sums
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* q_s = smem;
  float* k_s = q_s + GD;
  float* v_s = k_s + kTile * (D + 1);
  float* s_s = v_s + kTile * (D + 1);
  float* acc_s = s_s + G * kTile;
  float* m_s = acc_s + SG * GD;
  float* l_s = m_s + G;
  float* a_s = l_s + G;
  float* w_s = a_s + G;

  const int hi = max(min(valid_len[b], pps * page), 0);
  const int lo = window > 0 ? max(hi - window, 0) : 0;
  const int p_begin = max(sp * pages_per_split, lo / page);
  const int p_end = min((sp + 1) * pages_per_split, (hi + page - 1) / page);
  const int pstride = G * (D + 2);
  float* my_part = part + ((size_t)(b * KV + kvh) * n_split + sp) * pstride;
  const size_t q_base = ((size_t)b * H + (size_t)kvh * G) * D;

  if (p_begin < p_end) {
    for (int i = tid; i < GD; i += kThreads)
      q_s[i] = to_f32(q[q_base + i]) * scale;
    for (int i = tid; i < SG * GD; i += kThreads) acc_s[i] = 0.f;
    if (tid < G) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.f;
    }
    const int* pt = page_table + (size_t)b * pps;
    for (int pj = p_begin; pj < p_end; ++pj) {
      const int pid = pt[pj];
      const int ta = max(lo - pj * page, 0);  // attended offsets [ta, tb)
      const int tb = min(hi - pj * page, page);
      for (int t0 = ta; t0 < tb; t0 += kTile) {
        const int n = min(kTile, tb - t0);
        // (pid, t0, kvh) as a row of the ((P + 1) * page * KV) vectors
        const size_t row0 = ((size_t)pid * page + t0) * KV + kvh;
        __syncthreads();  // the previous tile's k_s / v_s / s_s are done
        stage_rows<KT, LT>(k_s, pk, ks, row0, KV, n, D, tid);
        stage_rows<KT, LT>(v_s, pv, vs, row0, KV, n, D, tid);
        __syncthreads();
        // scores: each thread owns whole (head, slot) dot products
        for (int i = tid; i < G * n; i += kThreads) {
          const int g = i / n;
          const int r = i - g * n;
          const float* qg = q_s + g * D;
          const float* kr = k_s + r * (D + 1);
          float x = 0.f;
          for (int d = 0; d < D; ++d) x += qg[d] * kr[d];
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          s_s[g * kTile + r] = x;
        }
        __syncthreads();
        // online-softmax update, one warp per query head
        for (int g = warp; g < G; g += kWarps) {
          float mx = kNegInf;
          for (int r = lane; r < n; r += 32) mx = fmaxf(mx, s_s[g * kTile + r]);
          mx = warp_max(mx);
          const float m_old = m_s[g];
          const float m_new = fmaxf(m_old, mx);
          float sum = 0.f;
          for (int r = lane; r < n; r += 32) {
            const float e = expf(s_s[g * kTile + r] - m_new);
            s_s[g * kTile + r] = e;
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
        // p x V: thread owns (slot group, head, dim) entries of acc_s
        for (int i = tid; i < SG * GD; i += kThreads) {
          const int sg = i / GD;
          const int o = i - sg * GD;
          const int g = o / D;
          const int d = o - g * D;
          const float* pg = s_s + g * kTile;
          float x = 0.f;
          for (int r = sg; r < n; r += SG) x += pg[r] * v_s[r * (D + 1) + d];
          acc_s[i] = acc_s[i] * a_s[g] + x;
        }
      }
    }
    __syncthreads();
    for (int o = tid; o < GD; o += kThreads) {
      float x = 0.f;
      for (int sg = 0; sg < SG; ++sg) x += acc_s[sg * GD + o];
      const int g = o / D;
      my_part[g * (D + 2) + 2 + (o - g * D)] = x;
    }
    if (tid < G) {
      my_part[tid * (D + 2)] = m_s[tid];
      my_part[tid * (D + 2) + 1] = l_s[tid];
    }
  } else if (tid < G) {  // an empty partial: no attended slot in this run
    my_part[tid * (D + 2)] = kNegInf;
    my_part[tid * (D + 2) + 1] = 0.f;
  }

  // the last block of this (row, KV head) to finish merges the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int old = atomicAdd(&tickets[b * KV + kvh], 1);
    last_s = old == n_split - 1;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* row_part = part + (size_t)(b * KV + kvh) * n_split * pstride;
  // M_g: the largest m of the nonempty partials (l > 0); w = exp(m - M_g)
  if (tid < G) {
    float M = kNegInf;
    for (int s = 0; s < n_split; ++s) {
      const float* ps = row_part + (size_t)s * pstride + tid * (D + 2);
      if (__ldcg(ps + 1) > 0.f) M = fmaxf(M, __ldcg(ps));
    }
    m_s[tid] = M;
  }
  __syncthreads();
  for (int i = tid; i < n_split * G; i += kThreads) {
    const int s = i / G;
    const int g = i - s * G;
    const float* ps = row_part + (size_t)s * pstride + g * (D + 2);
    w_s[i] = __ldcg(ps + 1) > 0.f ? expf(__ldcg(ps) - m_s[g]) : 0.f;
  }
  __syncthreads();
  if (tid < G) {
    float L = 0.f;
    for (int s = 0; s < n_split; ++s)
      L += w_s[s * G + tid] * __ldcg(row_part + (size_t)s * pstride +
                                     tid * (D + 2) + 1);
    l_s[tid] = L;
  }
  __syncthreads();
  for (int o = tid; o < GD; o += kThreads) {
    const int g = o / D;
    const int d = o - g * D;
    float x = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = w_s[s * G + g];
      if (w != 0.f)
        x += w * __ldcg(row_part + (size_t)s * pstride + g * (D + 2) + 2 + d);
    }
    out[q_base + o] = from_f32<T>(x / (l_s[g] + 1e-30f));
  }
  if (tid == 0) tickets[b * KV + kvh] = 0;
}

// Shared-memory bytes one launch needs (the Python wrapper computes the
// same number and raises above the 227 KB a block can have).
size_t smem_bytes(int H, int KV, int D) {
  const int G = H / KV;
  const int SG = kThreads / (G * D) > 1 ? kThreads / (G * D) : 1;
  return sizeof(float) * (size_t)(G * D + 2 * kTile * (D + 1) + G * kTile +
                                  SG * G * D + 3 * G + kMaxSplit * G);
}

template <typename T, typename KT, typename LT>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const float* ks, const float* vs, const void* pt,
                   const void* vl, void* out, void* part, void* tickets,
                   int B, int H, int KV, int D, int page, int pps,
                   int pages_per_split, int n_split, float scale,
                   float softcap, int window, cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  const size_t smem = smem_bytes(H, KV, D);
  auto kernel = paged_split_kernel<T, KT, LT>;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  kernel<<<dim3(KV, B, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(pk),
      static_cast<const KT*>(pv), ks, vs, static_cast<const int*>(pt),
      static_cast<const int*>(vl), static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), H, KV, D, page,
      pps, pages_per_split, n_split, scale, softcap, window);
  return cudaGetLastError();
}

// The widest load unit (16, 8 or 4 bytes) that divides a pool row and the
// pools' (and scale pools') alignment; else element loads.
template <typename T, typename KT>
cudaError_t launch_vec(const void* q, const void* pk, const void* pv,
                       const float* ks, const float* vs, const void* pt,
                       const void* vl, void* out, void* part, void* tickets,
                       int B, int H, int KV, int D, int page, int pps,
                       int pages_per_split, int n_split, float scale,
                       float softcap, int window, cudaStream_t st) {
  const size_t row = (size_t)D * sizeof(KT);
  const uintptr_t al = reinterpret_cast<uintptr_t>(pk) |
                       reinterpret_cast<uintptr_t>(pv);
#define REPRO_PAGED_ARGS                                                    \
  q, pk, pv, ks, vs, pt, vl, out, part, tickets, B, H, KV, D, page, pps, \
      pages_per_split, n_split, scale, softcap, window, st
  if (row % 16 == 0 && al % 16 == 0)
    return launch<T, KT, uint4>(REPRO_PAGED_ARGS);
  if (row % 8 == 0 && al % 8 == 0)
    return launch<T, KT, uint2>(REPRO_PAGED_ARGS);
  if (row % 4 == 0 && al % 4 == 0)
    return launch<T, KT, uint32_t>(REPRO_PAGED_ARGS);
  return launch<T, KT, KT>(REPRO_PAGED_ARGS);
#undef REPRO_PAGED_ARGS
}

}  // namespace

extern "C" {

// Float pools: dtype 0 = float32, 1 = bfloat16 (q, pools and out).
// part: a (B, KV, n_split, H / KV, D + 2) float32 workspace; tickets: a
// (>= B * KV) int32 buffer of zeros, left zeroed.  The caller plans
// pages_per_split / n_split (n_split <= 64) and validates shapes (G <= 8,
// D <= 256, shared memory <= 227 KB); every table entry must be a page of
// the pool (the layouts only ever write pages in [0, P], P being trash).
// Returns the launch's cudaError_t.
int paged_decode_fwd(const void* q, const void* pk, const void* pv,
                     const void* page_table, const void* valid_len, void* out,
                     void* part, void* tickets, int B, int H, int KV, int D,
                     int page, int pps, int pages_per_split, int n_split,
                     float scale, float softcap, int window, int dtype,
                     void* stream) {
  if (B == 0 || KV == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_vec<float, float>(
        q, pk, pv, nullptr, nullptr, page_table, valid_len, out, part,
        tickets, B, H, KV, D, page, pps, pages_per_split, n_split, scale,
        softcap, window, st);
  return (int)launch_vec<__nv_bfloat16, __nv_bfloat16>(
      q, pk, pv, nullptr, nullptr, page_table, valid_len, out, part, tickets,
      B, H, KV, D, page, pps, pages_per_split, n_split, scale, softcap,
      window, st);
}

// int8 pools with (P + 1, page, KV, 1) float32 scale pools; dtype is q's
// and out's (0 = float32, 1 = bfloat16).  Same contract as
// paged_decode_fwd.
int paged_decode_int8_fwd(const void* q, const void* pk, const void* pv,
                          const void* ks, const void* vs,
                          const void* page_table, const void* valid_len,
                          void* out, void* part, void* tickets, int B, int H,
                          int KV, int D, int page, int pps,
                          int pages_per_split, int n_split, float scale,
                          float softcap, int window, int dtype,
                          void* stream) {
  if (B == 0 || KV == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  if (dtype == 0)
    return (int)launch_vec<float, int8_t>(
        q, pk, pv, ksf, vsf, page_table, valid_len, out, part, tickets, B, H,
        KV, D, page, pps, pages_per_split, n_split, scale, softcap, window,
        st);
  return (int)launch_vec<__nv_bfloat16, int8_t>(
      q, pk, pv, ksf, vsf, page_table, valid_len, out, part, tickets, B, H,
      KV, D, page, pps, pages_per_split, n_split, scale, softcap, window, st);
}

}  // extern "C"
