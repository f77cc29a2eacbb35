// K4: the Mamba-2 SSD (state-space duality) scan, for NVIDIA Hopper
// (sm_90a).  Built by repro_torch/kernels/_build.py with nvcc into a shared
// library with a plain C interface (loaded by ctypes).
//
// Replaces: src/repro/kernels/ssd_scan.py -- ssd_intra_chunk_pallas (body
// _ssd_chunk_kernel), the TPU kernel, and the inter-chunk recurrence its
// wrapper ssd_scan_pallas runs as a jax.lax.scan in XLA.  The function is
// ssd_chunked's (src/repro/layers/ssm.py), for ANY sequence length L: the
// rows are cut into chunks of Q (the model's ssm_chunk, <= 64) and the last
// chunk holds the L - (nc - 1) Q rows that are left.  That is the exact SSD
// identity on a ragged partition; no row at or past L is read or written,
// and every per-chunk quantity (the cumsum, exp(cs[q-1] - cs), the chunk
// decay) uses the chunk's own row count q.  (JAX instead halves the chunk
// until it divides L: the same function, summed in another order.)
//
// Inputs in their natural layouts: x (B, L, H, P) and b, c (B, L, N) in
// their dtype (float or bf16; rows at a given stride, so the mixer's slices
// of one conv output are read in place), dt (B, L, H) f32, a (H,) f32,
// init (B, H, P, N) f32 or null.  xdt = x * dt and da = dt * a are formed
// in f32 while staging.  All products are f32 FMAs on the CUDA cores.
//
// ssd_intra_chunk_fwd (launch 1) -- grid (chunk, head group, batch), 256
//   threads, 2 blocks an SM.  The block stages the chunk's b and c rows
//   once and computes the scores C . B^T (Q x Q) once for all its heads
//   (b and c are one group shared by the heads).  Per head: the decay mask
//   exp(cs_l - cs_s) for s <= l only (it is never evaluated above the
//   diagonal: cs decreases, so it overflows there and inf * 0 is NaN),
//   y_intra = masked scores . xdt (Q x P) and the chunk-end state
//   (xdt * exp(cs_end - cs))^T . b (P x N).  The next head's x rows and dt
//   are copied in with cp.async while the current head's products run.
//   Heads per block are chosen from the shapes so the grid fills the SMs.
//   Writes y_intra (B, L, H, P) and states (B, H, nc, P, N), f32.
// ssd_chunk_scan_fwd (launch 2) -- grid (P slice, head, batch), 128
//   threads, sequential over chunks: the block keeps its slice of the
//   running state on chip (two tiles in shared memory: the product reads
//   one while the update writes the other) and per chunk writes
//   y = y_intra + exp(cs_l) C_l . prev for l < q, then
//   prev = prev * exp(cs[q-1]) + state_n.  The next chunk's c rows (in
//   their dtype, into a second padded tile) and dt are copied in with
//   cp.async, and its state slice and y_intra rows loaded into registers,
//   while the current chunk's product runs; every warp scans the chunk's
//   dt itself, so a chunk takes one barrier.  Writes y (B, L, H, P) in x's
//   dtype and the final state (B, H, P, N) f32; under autograd also the
//   state entering each chunk, (B, H, nc, P, N) f32, which K4's backward
//   (csrc/ssd_scan_bwd.cu) reads (null when serving: no per-chunk state
//   then reaches device memory).
//
// What bounds it on an H100: at mamba2-130m's admission (H 24, P 64, N 128,
// Q 64) each launch needs about as long for its bytes as for its f32 FMAs
// (67 TFLOP/s against 3.35 TB/s: ~0.03 ms each at four 1024-token rows).
// The products run as 4 x 4 (scores, y, y_inter) and 4 x 8 (state)
// register tiles fed by 128-bit shared loads (8 loads per 64 FMAs; 3 per
// 32 for the state), rows strided at N + 4 / Q + 4 / P + 4 floats so the
// eight threads of a 128-bit load phase hit distinct banks.  Launch 2 is
// a chain of nc dependent steps (its c rows, product, y stores and state
// update), with few blocks an SM at small batch: it, not launch 1, sets
// K4's time (PERF.md).
// Runtime limits (the wrapper raises beyond): Q <= 64, P <= 64, N <= 128,
// P and N multiples of 8, rows 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;                // rows of a chunk tile (Q <= kQ)
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kLdN = kMaxN + 4;       // row stride of b, c and state tiles
constexpr int kLdQ = kQ + 4;          // row stride of the score tiles
constexpr int kLdP = kMaxP + 4;       // row stride of the xdt tile
constexpr int kIntraThreads = 256;
constexpr int kScanThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
// component i of v (i a compile-time constant after unrolling)
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 8 consecutive elements (16 bytes of bf16, 32 of float) as floats.
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 lo = ld4(p), hi = ld4(p + 4);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 4 consecutive elements as floats (shared memory, 16 or 8 bytes).
__device__ __forceinline__ float4 load4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
// cp.async of 4 elements (16 bytes of float, 8 of bf16).
__device__ __forceinline__ void cp_async_4x(float* dst, const float* src) {
  cp_async16(dst, src);
}
__device__ __forceinline__ void cp_async_4x(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src) {
  cp_async8(dst, src);
}

__device__ __forceinline__ void store4(float* p, float4 v) { st4(p, v); }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// dst[r * ld + k] = src[r * n + k] * scale[r] as f32 for r < rows and
// k < n (n % 8 == 0): rows copied in packed by cp.async, widened.
template <typename T>
__device__ __forceinline__ void widen_rows(float* dst, int ld, const T* src,
                                           int rows, int n,
                                           const float* scale) {
  const int units = n / 8;
  for (int i = threadIdx.x; i < rows * units; i += blockDim.x) {
    const int r = i / units;
    const int k = (i - r * units) * 8;
    float v[8];
    load8(src + r * n + k, v);
    const float s = scale[r];
    st4(dst + r * ld + k, make_float4(v[0] * s, v[1] * s, v[2] * s, v[3] * s));
    st4(dst + r * ld + k + 4,
        make_float4(v[4] * s, v[5] * s, v[6] * s, v[7] * s));
  }
}

// Launch 1's first staging: rows r < rows of b and c (n elements each,
// n <= kMaxN) as f32 into b_s and c_s (row stride kLdN), rows [rows, kQ)
// zero.  kIntraThreads threads; each starts all its loads before its
// stores, so the block waits for device memory once.
template <typename T>
__device__ __forceinline__ void stage_bc(float* b_s, const T* b,
                                         long long sb, float* c_s,
                                         const T* c, long long sc, int rows,
                                         int n) {
  constexpr int kPer = kQ * kMaxN / 8 / kIntraThreads;
  const int units = n / 8;
  float vb[kPer][8], vc[kPer][8];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kIntraThreads;
    const int r = i / units;
    const int k = (i - r * units) * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) vb[j][e] = vc[j][e] = 0.f;
    if (i < kQ * units && r < rows) {
      load8(b + r * sb + k, vb[j]);
      load8(c + r * sc + k, vc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kIntraThreads;
    if (i >= kQ * units) break;
    const int r = i / units;
    const int k = (i - r * units) * 8;
    st4(b_s + r * kLdN + k, make_float4(vb[j][0], vb[j][1], vb[j][2], vb[j][3]));
    st4(b_s + r * kLdN + k + 4, make_float4(vb[j][4], vb[j][5], vb[j][6], vb[j][7]));
    st4(c_s + r * kLdN + k, make_float4(vc[j][0], vc[j][1], vc[j][2], vc[j][3]));
    st4(c_s + r * kLdN + k + 4, make_float4(vc[j][4], vc[j][5], vc[j][6], vc[j][7]));
  }
}

// Launch 1's first head: x_s[r][k] = x[r][k] * dt[r * H] as f32 for r <
// rows, k < p (p <= kMaxP), rows [rows, kQ) zero; loads before stores.
template <typename T>
__device__ __forceinline__ void stage_x(float* x_s, const T* x, long long sx,
                                        const float* dt, int H, int rows,
                                        int p) {
  constexpr int kPer = kQ * kMaxP / 8 / kIntraThreads;
  const int units = p / 8;
  float v[kPer][8], d[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kIntraThreads;
    const int r = i / units;
    const int k = (i - r * units) * 8;
    d[j] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) v[j][e] = 0.f;
    if (i < kQ * units && r < rows) {
      load8(x + r * sx + k, v[j]);
      d[j] = dt[(size_t)r * H];
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kIntraThreads;
    if (i >= kQ * units) break;
    const int r = i / units;
    const int k = (i - r * units) * 8;
    const float s = d[j];
    st4(x_s + r * kLdP + k,
        make_float4(v[j][0] * s, v[j][1] * s, v[j][2] * s, v[j][3] * s));
    st4(x_s + r * kLdP + k + 4,
        make_float4(v[j][4] * s, v[j][5] * s, v[j][6] * s, v[j][7] * s));
  }
}

// cp.async of rows r < rows of n elements (n * sizeof(T) % 16 == 0) from
// src (row stride `stride` elements) to dst, packed (row stride n).
template <typename T>
__device__ __forceinline__ void async_rows(T* dst, const T* src,
                                           long long stride, int rows,
                                           int n) {
  constexpr int kPer = 16 / sizeof(T);
  const int units = n / kPer;
  for (int i = threadIdx.x; i < rows * units; i += blockDim.x) {
    const int r = i / units;
    const int k = (i - r * units) * kPer;
    cp_async16(dst + r * n + k, src + r * stride + k);
  }
}

// Every lane of a warp: the chunk's cumsum cs of dt * a over n <= 64 rows;
// lane j gets cs[j] (lo) and cs[j + 32] (hi); lanes past n hold cs[n-1].
__device__ __forceinline__ void warp_cumsum(const float* dt, float a, int n,
                                            float& lo, float& hi) {
  const int lane = threadIdx.x & 31;
  lo = lane < n ? dt[lane] * a : 0.f;
  hi = lane + 32 < n ? dt[lane + 32] * a : 0.f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float tl = __shfl_up_sync(kFull, lo, o);
    const float th = __shfl_up_sync(kFull, hi, o);
    if (lane >= o) {
      lo += tl;
      hi += th;
    }
  }
  hi += __shfl_sync(kFull, lo, 31);
}

// Entry l of a 64-entry row held as warp_cumsum holds it (lane j: entries
// j and j + 32); every lane of the warp calls it.
__device__ __forceinline__ float pair_at(float lo, float hi, int l) {
  const float a = __shfl_sync(kFull, lo, l & 31);
  const float b = __shfl_sync(kFull, hi, l & 31);
  return l < 32 ? a : b;
}

// Warp 0 of launch 1: cs (the chunk's cumsum) and w = exp(cs[n-1] - cs[l])
// for l < n (0 past) into shared memory.
__device__ __forceinline__ void chunk_cumsum(const float* dt, float a, int n,
                                             float* cs, float* w) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  float lo, hi;
  warp_cumsum(dt, a, n, lo, hi);
  cs[lane] = lo;
  cs[lane + 32] = hi;
  const float end = pair_at(lo, hi, n - 1);
  w[lane] = lane < n ? expf(end - lo) : 0.f;
  w[lane + 32] = lane + 32 < n ? expf(end - hi) : 0.f;
}

constexpr size_t intra_smem_bytes() {
  // b_s, c_s (later m_s | xraw) [kQ x kLdN]; s_s [kQ x kLdQ];
  // x_s [kQ x kLdP]; cs, w, dt of the current head, dt of the next head
  return sizeof(float) *
         (2 * kQ * kLdN + kQ * kLdQ + kQ * kLdP + 4 * kQ);
}
static_assert(kQ * kLdQ * 4 + kQ * kMaxP * 4 <= kQ * kLdN * 4,
              "m_s and the next head's raw x must fit where c_s was");

// Launch 1.  grid (nc, ceil(H / hpb), B), kIntraThreads threads.
template <typename T>
__global__ void __launch_bounds__(kIntraThreads, 2)
ssd_intra_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ bm,
                 const T* __restrict__ cm, float* __restrict__ y,
                 float* __restrict__ st, int L, int H, int P, int N, int Q,
                 int hpb, long long sxb, long long sxl, long long sbb,
                 long long sbl, long long scb, long long scl) {
  extern __shared__ __align__(16) float smem[];
  float* b_s = smem;
  float* c_s = b_s + kQ * kLdN;
  float* m_s = c_s;                                   // after the scores
  T* xraw = reinterpret_cast<T*>(c_s + kQ * kLdQ);    // after the scores
  float* s_s = c_s + kQ * kLdN;
  float* x_s = s_s + kQ * kLdQ;
  float* cs_s = x_s + kQ * kLdP;
  float* w_s = cs_s + kQ;
  float* dt_s = w_s + kQ;
  float* dtraw = dt_s + kQ;

  const int n = blockIdx.x;
  const int nc = gridDim.x;
  const int bb = blockIdx.z;
  const int h0 = blockIdx.y * hpb;
  const int h1 = min(H, h0 + hpb);
  const int row0 = n * Q;
  const int q = min(Q, L - row0);                     // this chunk's rows
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const T* xb = x + bb * sxb + row0 * sxl;            // + l * sxl + h * P
  const float* dtb = dt + ((size_t)bb * L + row0) * H;   // + l * H + h

  if (tid < kQ) dt_s[tid] = tid < q ? dtb[tid * H + h0] : 0.f;
  stage_bc(b_s, bm + bb * sbb + row0 * sbl, sbl, c_s,
           cm + bb * scb + row0 * scl, scl, q, N);
  stage_x(x_s, xb + h0 * P, sxl, dtb + h0, H, q, P);
  __syncthreads();
  chunk_cumsum(dt_s, a[h0], q, cs_s, w_s);

  // the scores, once for all heads: s[l][s] = c_l . b_s for s <= l < q,
  // else 0; rows ty + 16 i, columns tx + 16 j
  {
    float acc[4][4] = {};
    for (int k = 0; k < N; k += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = ld4(c_s + (ty + 16 * i) * kLdN + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ld4(b_s + (tx + 16 * j) * kLdN + k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j] = fmaf(at(cv[i], e), at(bv[j], e), acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tx + 16 * j;
        s_s[l * kLdQ + s] = s <= l && l < q ? acc[i][j] : 0.f;
      }
    }
  }
  __syncthreads();    // c_s is dead: m_s and the next head's x go there

  for (int h = h0; h < h1; ++h) {
    const bool more = h + 1 < h1;
    if (more) {
      async_rows(xraw, xb + (h + 1) * P, sxl, q, P);
      if (tid < q) cp_async4(dtraw + tid, dtb + tid * H + h + 1);
      cp_async_commit();
    }
    // decay-masked scores of head h; the exponential only where s <= l
    for (int i = tid; i < kQ * kQ; i += kIntraThreads) {
      const int l = i / kQ;
      const int s = i - l * kQ;
      m_s[l * kLdQ + s] = s <= l && l < q
                              ? s_s[l * kLdQ + s] * expf(cs_s[l] - cs_s[s])
                              : 0.f;
    }
    __syncthreads();

    // y_intra (q x P) = m . xdt: rows 4 ty + i, columns 4 tx + c; the
    // scores are 0 past the row's diagonal, so k stops there
    if (4 * ty < q && 4 * tx < P) {
      float acc[4][4] = {};
      const int kend = min(4 * ty + 4, (q + 3) & ~3);
      for (int k = 0; k < kend; k += 4) {
        float4 mv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv[i] = ld4(m_s + (4 * ty + i) * kLdQ + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = ld4(x_s + (k + j) * kLdP + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[i][c] = fmaf(at(mv[i], j), at(xv[j], c), acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = 4 * ty + i;
        if (l < q)
          st4(y + (((size_t)bb * L + row0 + l) * H + h) * P + 4 * tx,
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      }
    }
    __syncthreads();

    // xdt <- xdt * exp(cs_end - cs) for the state product
    for (int i = tid; i < q * (P / 4); i += kIntraThreads) {
      const int l = i / (P / 4);
      float* p = x_s + l * kLdP + 4 * (i - l * (P / 4));
      const float w = w_s[l];
      float4 v = ld4(p);
      v.x *= w; v.y *= w; v.z *= w; v.w *= w;
      st4(p, v);
    }
    __syncthreads();

    // the chunk-end state (P x N) = xdt^T . b: rows p = 4 tp + i, columns
    // m = 4 tm + c and 64 + 4 tm + c
    {
      const int tp = tid / 16;
      const int tm = tid % 16;
      if (4 * tp < P) {
        float acc[4][8] = {};
        for (int s = 0; s < q; ++s) {
          const float4 xv = ld4(x_s + s * kLdP + 4 * tp);
          const float4 b0 = ld4(b_s + s * kLdN + 4 * tm);
          const float4 b1 = ld4(b_s + s * kLdN + 64 + 4 * tm);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[i][c] = fmaf(at(xv, i), at(b0, c), acc[i][c]);
              acc[i][c + 4] = fmaf(at(xv, i), at(b1, c), acc[i][c + 4]);
            }
        }
        float* sg = st + (((size_t)bb * H + h) * nc + n) * P * N;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float* row = sg + (size_t)(4 * tp + i) * N;
          if (4 * tm < N)
            st4(row + 4 * tm,
                make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
          if (64 + 4 * tm < N)
            st4(row + 64 + 4 * tm,
                make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
        }
      }
    }

    if (more) {       // the next head's x * dt and its cumsum
      cp_async_wait_all();
      __syncthreads();
      widen_rows(x_s, kLdP, xraw, q, P, dtraw);
      chunk_cumsum(dtraw, a[h + 1], q, cs_s, w_s);
      __syncthreads();
    }
  }
}

template <typename T, int PS>
constexpr size_t scan_smem_bytes() {
  // two c tiles [kQ x kLdN] in T (the next chunk's lands in one by
  // cp.async while the product reads the other; bf16 is widened in the
  // product); two prev tiles [PS x kLdN] (the update writes one while the
  // product reads the other); two dt columns [kQ]
  return sizeof(T) * 2 * kQ * kLdN +
         sizeof(float) * (2 * PS * kLdN + 2 * kQ);
}

// Launch 2.  grid (ceil(P / PS), H, B), kScanThreads threads.  A block owns
// state rows [p0, p0 + PS) of (b, h).  Thread t is split t % KS (KS = 32 /
// PS splits of N, adjacent lanes) of tile t / KS: a 4 x 4 tile of y_inter,
// rows tr + 16 i and columns 4 tc + j.  A split takes blocks of 8 / KS
// float4 columns of N round-robin, so the eight lanes of a 128-bit load
// phase hit distinct banks; the splits' sums meet by shuffles and split s
// writes the rows i = s (mod KS) of the tile.  One barrier a chunk.
template <typename T, int PS>
__global__ void __launch_bounds__(kScanThreads)
ssd_scan_kernel(const float* __restrict__ y_intra,
                const float* __restrict__ st, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ cm,
                const float* __restrict__ init, T* __restrict__ y,
                float* __restrict__ fin, float* __restrict__ entry, int L,
                int H, int P, int N, int Q, int nc, long long scb,
                long long scl) {
  constexpr int KS = 32 / PS;
  constexpr int W = 8 / KS;                   // float4 columns a split block
  constexpr int kOwn = PS / 4;                // state float4s a thread owns
  constexpr int kRows = 4 / KS;               // tile rows a split writes
  extern __shared__ __align__(16) float smem[];
  T* c_s = reinterpret_cast<T*>(smem);
  float* pv_s = smem + 2 * kQ * kLdN * sizeof(T) / sizeof(float);
  float* dt_s = pv_s + 2 * PS * kLdN;

  const int p0 = blockIdx.x * PS;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const int np = min(PS, P - p0);             // state rows of this block
  const int tid = threadIdx.x;
  const int split = tid % KS;
  const int tr = (tid / KS) % 16;
  const int tc = tid / KS / 16;
  const bool cols = 4 * tc < np;
  const int G = N / 4;                        // float4 groups of a row
  const float ah = a[h];
  const size_t bh = (size_t)bb * H + h;
  const T* cb = cm + bb * scb;
  const float* dtb = dt + (size_t)bb * L * H + h;     // + row * H
  const float* sb = st + (bh * nc * P + p0) * N;       // + k * P * N

  // the state float4s this thread owns: e = tid + kScanThreads * j of the
  // np x N slice, at own[j] in a prev tile (-1: none)
  int own[kOwn];
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    const int e = tid + kScanThreads * j;
    const int pl = e / G;
    own[j] = e < np * G ? pl * kLdN + 4 * (e - pl * G) : -1;
  }

  // chunk k's c rows and dt by cp.async into buffer k & 1; its state
  // slice and this thread's y_intra rows into registers
  auto fetch = [&](int k, float4 (&sv)[kOwn], float4 (&yv)[kRows]) {
    const int r0 = k * Q;
    const int qk = min(Q, L - r0);
    T* tile = c_s + (k & 1) * kQ * kLdN;
    const int dr = kScanThreads / G;
    const int dg = kScanThreads - dr * G;
    for (int r = tid / G, g = tid % G; r < qk;) {
      cp_async_4x(tile + r * kLdN + 4 * g, cb + (r0 + r) * scl + 4 * g);
      r += dr;
      g += dg;
      if (g >= G) {
        g -= G;
        ++r;
      }
    }
    if (tid < qk) cp_async4(dt_s + (k & 1) * kQ + tid,
                            dtb + (size_t)(r0 + tid) * H);
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < kOwn; ++j)
      sv[j] = own[j] >= 0 ? ld4(sb + (size_t)k * P * N +
                                4 * (tid + kScanThreads * j))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int l = tr + 16 * (split + KS * i);
      yv[i] = cols && l < qk
                  ? ld4(y_intra + (((size_t)bb * L + r0 + l) * H + h) * P +
                        p0 + 4 * tc)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

#pragma unroll
  for (int j = 0; j < kOwn; ++j)
    if (own[j] >= 0)
      st4(pv_s + own[j],
          init ? ld4(init + (bh * P + p0) * N + 4 * (tid + kScanThreads * j))
               : make_float4(0.f, 0.f, 0.f, 0.f));
  // one chunk; (sv, yv) hold its registers, (sn, yn) receive the next's
  auto step = [&](int k, float4 (&sv)[kOwn], float4 (&yv)[kRows],
                  float4 (&sn)[kOwn], float4 (&yn)[kRows]) {
    const int r0 = k * Q;
    const int q = min(Q, L - r0);
    cp_async_wait_all();
    __syncthreads();
    if (k + 1 < nc) fetch(k + 1, sn, yn);
    float elo, ehi;                           // every warp scans dt itself
    warp_cumsum(dt_s + (k & 1) * kQ, ah, q, elo, ehi);
    elo = expf(elo);                          // exp(cs)
    ehi = expf(ehi);
    const T* cc = c_s + (k & 1) * kQ * kLdN;
    const float* pcur = pv_s + (k & 1) * PS * kLdN;

    // y_inter partials over this split's columns of N
    float acc[4][4] = {};
    if (cols && tr < q) {
      for (int gb = split * W; gb < G; gb += 8) {
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const int g = gb + e;
          if (g >= G) break;
          float4 cv[4], vv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[i] = load4(cc + (tr + 16 * i) * kLdN + 4 * g);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            vv[j] = ld4(pcur + (4 * tc + j) * kLdN + 4 * g);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[i][j] = fmaf(at(cv[i], c), at(vv[j], c), acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int o = 1; o < KS; o <<= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] += __shfl_xor_sync(kFull, acc[i][j], o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = tr + 16 * i;
      const float ex = pair_at(elo, ehi, l);
      if (i % KS == split && cols && l < q) {
        const float4 yi = yv[i / KS];
        store4(y + (((size_t)bb * L + r0 + l) * H + h) * P + p0 + 4 * tc,
               make_float4(fmaf(acc[i][0], ex, yi.x),
                           fmaf(acc[i][1], ex, yi.y),
                           fmaf(acc[i][2], ex, yi.z),
                           fmaf(acc[i][3], ex, yi.w)));
      }
    }

    // prev <- prev * exp(cs[q-1]) + state_n, into the other prev tile
    // (prev, the state entering chunk k, saved first where asked)
    const float dec = pair_at(elo, ehi, q - 1);
    float* pnext = pv_s + ((k + 1) & 1) * PS * kLdN;
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      if (own[j] < 0) continue;
      float4 v = ld4(pcur + own[j]);
      if (entry)
        st4(entry + ((bh * nc + k) * P + p0) * N + 4 * (tid + kScanThreads * j),
            v);
      v.x = fmaf(v.x, dec, sv[j].x);
      v.y = fmaf(v.y, dec, sv[j].y);
      v.z = fmaf(v.z, dec, sv[j].z);
      v.w = fmaf(v.w, dec, sv[j].w);
      st4(pnext + own[j], v);
    }
  };

  // two register sets in turn: the next chunk's loads stay in flight
  // through the current chunk
  float4 sa[kOwn], ya[kRows], sz[kOwn], yz[kRows];
  fetch(0, sa, ya);
  for (int k = 0; k < nc; k += 2) {
    step(k, sa, ya, sz, yz);
    if (k + 1 < nc) step(k + 1, sz, yz, sa, ya);
  }
  const float* plast = pv_s + (nc & 1) * PS * kLdN;   // written by this thread
#pragma unroll
  for (int j = 0; j < kOwn; ++j)
    if (own[j] >= 0)
      st4(fin + (bh * P + p0) * N + 4 * (tid + kScanThreads * j),
          ld4(plast + own[j]));
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!counts[dev])
    cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev] > 0 ? counts[dev] : 132;
}

// Raise a kernel's dynamic shared-memory limit above the default 48 KB
// (once per kernel instance).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) configured = true;
  return err;
}

template <typename T>
int intra_launch(const void* x, const void* dt, const void* a, const void* b,
                 const void* c, void* y_intra, void* states, int B, int L,
                 int H, int P, int N, int Q, long long sxb, long long sxl,
                 long long sbb, long long sbl, long long scb, long long scl,
                 cudaStream_t stream) {
  static bool configured = false;
  static int occupancy = 0;
  const size_t smem = intra_smem_bytes();
  cudaError_t err = allow_smem(ssd_intra_kernel<T>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  if (!occupancy) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occupancy, ssd_intra_kernel<T>, kIntraThreads, smem);
    if (err != cudaSuccess) return (int)err;
    if (occupancy < 1) return (int)cudaErrorInvalidConfiguration;
  }
  // heads per block: as many as keep every block slot of the card busy
  const int nc = (L + Q - 1) / Q;
  const long long slots = (long long)occupancy * sm_count();
  const long long work = (long long)H * B * nc;
  int hpb = (int)((work + slots - 1) / slots);
  hpb = hpb < 1 ? 1 : (hpb > H ? H : hpb);
  const int groups = (H + hpb - 1) / hpb;
  hpb = (H + groups - 1) / groups;
  ssd_intra_kernel<T><<<dim3(nc, groups, B), kIntraThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<float*>(y_intra),
      static_cast<float*>(states), L, H, P, N, Q, hpb, sxb, sxl, sbb, sbl,
      scb, scl);
  return (int)cudaGetLastError();
}

template <typename T, int PS>
int scan_launch_ps(const void* y_intra, const void* states, const void* dt,
                   const void* a, const void* c, const void* init, void* y,
                   void* fin, void* entry, int B, int L, int H, int P, int N,
                   int Q, long long scb, long long scl, cudaStream_t stream) {
  static bool configured = false;
  const size_t smem = scan_smem_bytes<T, PS>();
  const cudaError_t err = allow_smem(ssd_scan_kernel<T, PS>, smem,
                                     configured);
  if (err != cudaSuccess) return (int)err;
  const int nc = (L + Q - 1) / Q;
  ssd_scan_kernel<T, PS><<<dim3((P + PS - 1) / PS, H, B), kScanThreads, smem,
                           stream>>>(
      static_cast<const float*>(y_intra), static_cast<const float*>(states),
      static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const T*>(c), static_cast<const float*>(init),
      static_cast<T*>(y), static_cast<float*>(fin),
      static_cast<float*>(entry), L, H, P, N, Q, nc, scb, scl);
  return (int)cudaGetLastError();
}

// The slice width: the widest (fewest blocks re-reading c) whose grid
// still gives half the SMs a block: at one row of batch mamba2-130m's 24
// heads run 96 blocks of 16 rather than a full grid of 8-row slices.
template <typename T>
int scan_launch(const void* y_intra, const void* states, const void* dt,
                const void* a, const void* c, const void* init, void* y,
                void* fin, void* entry, int B, int L, int H, int P, int N,
                int Q, long long scb, long long scl, cudaStream_t stream) {
  const long long heads = (long long)H * B;
  const int half = (sm_count() + 1) / 2;
  if (P >= 32 && heads * ((P + 31) / 32) >= half)
    return scan_launch_ps<T, 32>(y_intra, states, dt, a, c, init, y, fin,
                                 entry, B, L, H, P, N, Q, scb, scl, stream);
  if (P >= 16 && heads * ((P + 15) / 16) >= half)
    return scan_launch_ps<T, 16>(y_intra, states, dt, a, c, init, y, fin,
                                 entry, B, L, H, P, N, Q, scb, scl, stream);
  return scan_launch_ps<T, 8>(y_intra, states, dt, a, c, init, y, fin, entry,
                              B, L, H, P, N, Q, scb, scl, stream);
}

}  // namespace

extern "C" {

// Launch 1.  x (B, L, H, P) with batch / row strides sxb / sxl (elements;
// heads at stride P, elements at stride 1), b / c (B, L, N) likewise, all
// of one dtype (bf16 != 0: bfloat16, else float); dt (B, L, H) and a (H,)
// float; writes y_intra (B, L, H, P) and states (B, H, nc, P, N), float,
// nc = ceil(L / Q).  Returns the launch's cudaError_t.  The caller checks
// shapes, strides and alignment and allocates the outputs.
int ssd_intra_chunk_fwd(const void* x, const void* dt, const void* a,
                        const void* b, const void* c, void* y_intra,
                        void* states, int B, int L, int H, int P, int N,
                        int Q, long long sxb, long long sxl, long long sbb,
                        long long sbl, long long scb, long long scl, int bf16,
                        void* stream) {
  if (B == 0 || H == 0 || L == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? intra_launch<__nv_bfloat16>(x, dt, a, b, c, y_intra, states,
                                            B, L, H, P, N, Q, sxb, sxl, sbb,
                                            sbl, scb, scl, s)
              : intra_launch<float>(x, dt, a, b, c, y_intra, states, B, L, H,
                                    P, N, Q, sxb, sxl, sbb, sbl, scb, scl, s);
}

// Launch 2.  y_intra, states as launch 1 writes them; dt, a, c as launch 1
// takes them; init (B, H, P, N) float or null (zeros).  Writes y (B, L, H,
// P) in c's dtype, final_state (B, H, P, N) float and, unless null, entry
// (B, H, nc, P, N) float: the state entering each chunk.  Same contract.
int ssd_chunk_scan_fwd(const void* y_intra, const void* states,
                       const void* dt, const void* a, const void* c,
                       const void* init, void* y, void* final_state,
                       void* entry, int B, int L, int H, int P, int N, int Q,
                       long long scb, long long scl, int bf16, void* stream) {
  if (B == 0 || H == 0 || L == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? scan_launch<__nv_bfloat16>(y_intra, states, dt, a, c, init, y,
                                           final_state, entry, B, L, H, P, N,
                                           Q, scb, scl, s)
              : scan_launch<float>(y_intra, states, dt, a, c, init, y,
                                   final_state, entry, B, L, H, P, N, Q, scb,
                                   scl, s);
}

}  // extern "C"
