// K4's backward: the gradient of the Mamba-2 SSD scan, for NVIDIA Hopper
// (sm_90a).  Built by repro_torch/kernels/_build.py with nvcc into a shared
// library with a plain C interface (loaded by ctypes).
//
// Replaces no TPU kernel: the JAX package differentiates its XLA
// ssd_chunked (src/repro/layers/ssm.py) with jax.value_and_grad.  It is the
// backward of K4 (csrc/ssd_scan.cu) on the same ragged tiling: chunks of Q
// rows (the model's ssm_chunk, <= 64), the last one holding the rows left.
//
// The forward, per (batch, head) and chunk n of q rows l = 0..q-1, with
// cs_l = sum_{k<=l} dt_k a the chunk's cumulative log-decay, xdt_s = x_s
// dt_s (a P vector), S_n the state entering the chunk (P x N):
//   y_l     = sum_{s<=l} (c_l . b_s) exp(cs_l - cs_s) xdt_s + e_l S_n c_l
//   S_{n+1} = e_{q-1} S_n + sum_s w_s xdt_s (x) b_s
// where e_l = exp(cs_l) and w_s = exp(cs_{q-1} - cs_s).  Given dy and the
// gradient of the final state, G_{nc-1} = dfinal, and writing G_n for the
// gradient of S_{n+1} (the state leaving chunk n):
//   reverse scan:  G_{n-1} = e_{q-1} G_n + sum_l e_l dy_l (x) c_l,
//                  dinit = the same step applied to G_0
// and within chunk n, with CB_ls = c_l . b_s, E_ls = exp(cs_l - cs_s) and
// DX_ls = dy_l . xdt_s for s <= l (0 above the diagonal), T = E o DX,
// M = CB o T, g_s = G_n b_s (P) and u_l = S_n c_l (P):
//   dxdt_s = sum_{l>=s} CB_ls E_ls dy_l + w_s g_s
//   db_s   = sum_{l>=s} T_ls c_l + w_s G_n^T xdt_s      (per head)
//   dc_l   = sum_{s<=l} T_ls b_s + e_l S_n^T dy_l       (per head)
//   dcs_l  = sum_s M_ls - sum_l' M_l'l + e_l dy_l . u_l - r_l
//            + [l = q-1] <G_n, S_{n+1}>,   r_l = w_l xdt_l . g_l,
//   <G_n, S_{n+1}> = e_{q-1} <G_n, S_n> + sum_s r_s,
//   d(da)_l = sum_{k>=l} dcs_k          (da_l = dt_l a, cs its cumsum)
//           = sum_{k>=l, s<l} M_ks + sum_{s<l} r_s + sum_{k>=l} e_k dy_k . u_k
//             + e_{q-1} <G_n, S_n>
// (the last form adds no pair of M twice with opposite signs: the first
// form, for strong decays, lost ~3e-5 of da's scale to cancellation in
// f32, where autograd through the forward loses ~4e-6), and the chain rule
// to the inputs: dx = dxdt dt, ddt = dxdt . x + a d(da), da(a) = the sum
// over batch and rows of dt d(da); db and dc summed over the H heads (b
// and c are one group shared by the heads).
//
// Three launches, in order on the caller's stream:
// ssd_bwd_state_kernel -- grid (P slice, head, batch), 128 threads,
//   sequential over the chunks from the last: the block keeps its 16-row
//   slice of G in registers, writes G_n for every chunk (f32, (B, H, nc,
//   P, N)) and dinit.  Per chunk it stages the c rows, its dy columns and
//   the cumsum in shared memory.
// ssd_bwd_chunk_kernel -- grid (chunk, head, batch), 256 threads, one
//   block an SM (~197 KB of shared memory): stages x, dy, b, c (q rows,
//   widened to f32), G_n and, later, S_n (the forward's saved chunk-entry
//   states), builds CB, E and DX (q x q), and runs the products above as
//   shared-memory loops, each thread 4 rows of one output column.  Writes
//   dx (x's dtype), ddt (f32), per-head db and dc (f32, (B, H, L, N)) and
//   per-chunk partials of da.
// ssd_bwd_reduce_kernel -- sums db and dc over the heads and da over
//   batch and chunks in a fixed order (no atomics: deterministic), writes
//   db and dc in b's dtype.
//
// What bounds it on an H100: the per-chunk products are ~8 Q x Q x (P or
// N) f32 FMA blocks per (chunk, head); mamba2-130m at batch 8 x 1024 is
// ~26 GFLOP, ~0.4 ms at 67 TFLOP/s of f32 FMAs, against ~0.05 ms to move
// its bytes: operations.  This first design is simple: scalar shared loads
// (about two per FMA, rows strided at an odd count of floats so column
// walks hit distinct banks) hold it near an eighth of the FMA rate.  The
// reverse scan is a chain of nc dependent steps, as the forward's scan.
// Runtime limits (the wrapper raises beyond): Q <= 64, P <= 64, N <= 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;                // rows of a chunk tile (Q <= kQ)
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kLdP = kMaxP + 1;       // odd row strides: a column walk of
constexpr int kLdN = kMaxN + 1;       // 32 rows hits 32 distinct banks
constexpr int kLdQ = kQ + 1;
constexpr int kPS = 16;               // G rows a state block owns
constexpr int kStateThreads = 128;
constexpr int kOwn = kPS * kMaxN / kStateThreads;
constexpr int kChunkThreads = 256;
constexpr int kReduceThreads = 256;
constexpr int kR = 4;                 // output rows a thread of a product
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Every lane of a warp: the inclusive cumsum over n <= 64 entries v_l (lane
// j holds v_j in lo and v_{j+32} in hi, zeros past n), in place.
__device__ __forceinline__ void warp_cumsum64(float& lo, float& hi) {
  const int lane = threadIdx.x & 31;
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// out(i, j, sum_{k<K} A(i, k) B(k, j)) for i < M, j < Nc: thread t takes
// column t % Nc of kR rows; every thread of the block calls it.
template <class FA, class FB, class FO>
__device__ __forceinline__ void block_mm(int M, int Nc, int K, FA A, FB B,
                                         FO out) {
  const int tasks = (M + kR - 1) / kR * Nc;
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const int j = t % Nc;
    const int i0 = t / Nc * kR;
    int ii[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) ii[r] = min(i0 + r, M - 1);
    float acc[kR] = {};
    for (int k = 0; k < K; ++k) {
      const float bv = B(k, j);
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = fmaf(A(ii[r], k), bv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (i0 + r < M) out(i0 + r, j, acc[r]);
  }
}

// out(i, j, sum_{k<K1} A1(i, k) B1(k, j) + S2(i) sum_{k<K2} A2(i, k) B2(k, j))
template <class FA1, class FB1, class FA2, class FB2, class FS2, class FO>
__device__ __forceinline__ void block_mm2(int M, int Nc, int K1, FA1 A1,
                                          FB1 B1, int K2, FA2 A2, FB2 B2,
                                          FS2 S2, FO out) {
  const int tasks = (M + kR - 1) / kR * Nc;
  for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
    const int j = t % Nc;
    const int i0 = t / Nc * kR;
    int ii[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) ii[r] = min(i0 + r, M - 1);
    float a1[kR] = {}, a2[kR] = {};
    for (int k = 0; k < K1; ++k) {
      const float bv = B1(k, j);
#pragma unroll
      for (int r = 0; r < kR; ++r) a1[r] = fmaf(A1(ii[r], k), bv, a1[r]);
    }
    for (int k = 0; k < K2; ++k) {
      const float bv = B2(k, j);
#pragma unroll
      for (int r = 0; r < kR; ++r) a2[r] = fmaf(A2(ii[r], k), bv, a2[r]);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (i0 + r < M) out(i0 + r, j, fmaf(S2(i0 + r), a2[r], a1[r]));
  }
}

// Launch 1.  grid (ceil(P / kPS), H, B), kStateThreads threads.  Thread t
// owns elements e = t + kStateThreads * j of the block's np x N slice of G.
template <typename T>
__global__ void __launch_bounds__(kStateThreads)
ssd_bwd_state_kernel(const T* __restrict__ dy, const T* __restrict__ cm,
                     const float* __restrict__ dt,
                     const float* __restrict__ a,
                     const float* __restrict__ dfin,
                     float* __restrict__ gexit, float* __restrict__ dinit,
                     int L, int H, int P, int N, int Q, int nc, long long scb,
                     long long scl) {
  __shared__ float c_s[kQ * kMaxN];
  __shared__ float dy_s[kQ * kPS];
  __shared__ float e_s[kQ];
  __shared__ float dec_s;
  const int p0 = blockIdx.x * kPS;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const int np = min(kPS, P - p0);
  const int tid = threadIdx.x;
  const size_t bh = (size_t)bb * H + h;
  const float ah = a[h];

  float acc[kOwn];
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    const int e = tid + kStateThreads * j;
    acc[j] = e < np * N && dfin ? dfin[(bh * P + p0) * N + e] : 0.f;
  }
  for (int n = nc - 1; n >= 0; --n) {
    const int r0 = n * Q;
    const int q = min(Q, L - r0);
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      const int e = tid + kStateThreads * j;
      if (e < np * N) gexit[((bh * nc + n) * P + p0) * N + e] = acc[j];
    }
    __syncthreads();                  // the last chunk's tiles are read
    for (int i = tid; i < q * N; i += kStateThreads) {
      const int l = i / N;
      c_s[i] = ldf(cm + bb * scb + (r0 + l) * scl + (i - l * N));
    }
    for (int i = tid; i < q * np; i += kStateThreads) {
      const int l = i / np;
      const int p = i - l * np;
      dy_s[l * kPS + p] = ldf(dy + (((size_t)bb * L + r0 + l) * H + h) * P +
                              p0 + p);
    }
    if (tid < 32) {
      const float* dtb = dt + ((size_t)bb * L + r0) * H + h;
      float lo = tid < q ? dtb[(size_t)tid * H] * ah : 0.f;
      float hi = tid + 32 < q ? dtb[(size_t)(tid + 32) * H] * ah : 0.f;
      warp_cumsum64(lo, hi);
      e_s[tid] = expf(lo);
      e_s[tid + 32] = expf(hi);
      const float end = __shfl_sync(kFull, (q - 1) < 32 ? lo : hi,
                                    (q - 1) & 31);
      if (tid == 0) dec_s = expf(end);
    }
    __syncthreads();
    const float dec = dec_s;
#pragma unroll
    for (int j = 0; j < kOwn; ++j) {
      const int e = tid + kStateThreads * j;
      if (e >= np * N) continue;
      const int p = e / N;
      const int m = e - p * N;
      float s = 0.f;
      for (int l = 0; l < q; ++l)
        s = fmaf(e_s[l] * dy_s[l * kPS + p], c_s[l * N + m], s);
      acc[j] = fmaf(acc[j], dec, s);
    }
  }
#pragma unroll
  for (int j = 0; j < kOwn; ++j) {
    const int e = tid + kStateThreads * j;
    if (e < np * N) dinit[(bh * P + p0) * N + e] = acc[j];
  }
}

constexpr size_t chunk_smem_floats() {
  // x, dy, u [kQ x kLdP]; b, c [kQ x kLdN]; G / S_n [kMaxP x kLdN];
  // CB, E, DX [kQ x kLdQ]; 8 vectors of kQ; 32 partial sums
  return 3 * kQ * kLdP + 2 * kQ * kLdN + kMaxP * kLdN + 3 * kQ * kLdQ +
         8 * kQ + 32;
}

// Launch 2.  grid (nc, H, B), kChunkThreads threads.
template <typename T>
__global__ void __launch_bounds__(kChunkThreads, 1)
ssd_bwd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ entry,
                     const T* __restrict__ dy,
                     const float* __restrict__ gexit, T* __restrict__ dx,
                     float* __restrict__ ddt, float* __restrict__ dbh,
                     float* __restrict__ dch, float* __restrict__ dap, int L,
                     int H, int P, int N, int Q, long long sxb,
                     long long sxl, long long sbb, long long sbl,
                     long long scb, long long scl) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;
  float* dy_s = x_s + kQ * kLdP;
  float* u_s = dy_s + kQ * kLdP;
  float* b_s = u_s + kQ * kLdP;
  float* c_s = b_s + kQ * kLdN;
  float* g_s = c_s + kQ * kLdN;         // G_n, then S_n
  float* cb_s = g_s + kMaxP * kLdN;
  float* e_s = cb_s + kQ * kLdQ;
  float* d_s = e_s + kQ * kLdQ;         // DX
  float* dt_v = d_s + kQ * kLdQ;
  float* cum = dt_v + kQ;
  float* ev = cum + kQ;                 // exp(cs_l)
  float* wv = ev + kQ;                  // exp(cs_{q-1} - cs_l)
  float* cross = wv + kQ;               // sum_{k>=l, s<l} M_ks
  float* rv = cross + kQ;               // r_l = w_l xdt_l . g_l
  float* ddt1 = rv + kQ;                // x_l . dxdt_l
  float* inter = ddt1 + kQ;             // e_l dy_l . u_l, then dt_l d(da)_l
  float* red = inter + kQ;              // 32 partial sums of <G_n, S_n>

  const int n = blockIdx.x;
  const int nc = gridDim.x;
  const int h = blockIdx.y;
  const int bb = blockIdx.z;
  const int r0 = n * Q;
  const int q = min(Q, L - r0);
  const int tid = threadIdx.x;
  const size_t bh = (size_t)bb * H + h;
  const float ah = a[h];
  const size_t sn_off = (bh * nc + n) * (size_t)P * N;

  // stage the chunk's rows (widened to f32) and G_n
  for (int i = tid; i < q * P; i += kChunkThreads) {
    const int l = i / P;
    const int p = i - l * P;
    x_s[l * kLdP + p] = ldf(x + bb * sxb + (r0 + l) * sxl + (size_t)h * P +
                            p);
    dy_s[l * kLdP + p] = ldf(dy + (((size_t)bb * L + r0 + l) * H + h) * P +
                             p);
  }
  for (int i = tid; i < q * N; i += kChunkThreads) {
    const int l = i / N;
    const int m = i - l * N;
    b_s[l * kLdN + m] = ldf(bm + bb * sbb + (r0 + l) * sbl + m);
    c_s[l * kLdN + m] = ldf(cm + bb * scb + (r0 + l) * scl + m);
  }
  for (int i = tid; i < P * N; i += kChunkThreads) {
    const int p = i / N;
    g_s[p * kLdN + (i - p * N)] = gexit[sn_off + i];
  }
  if (tid < kQ)
    dt_v[tid] = tid < q ? dt[((size_t)bb * L + r0 + tid) * H + h] : 0.f;
  __syncthreads();

  // <G_n, S_n>: partial sums, one a warp
  {
    float s = 0.f;
    for (int i = tid; i < P * N; i += kChunkThreads) {
      const int p = i / N;
      s = fmaf(g_s[p * kLdN + (i - p * N)], entry[sn_off + i], s);
    }
    s = warp_sum(s);
    if ((tid & 31) == 0) red[tid >> 5] = s;
  }
  if (tid < 32) {                       // the cumsum and its exponentials
    float lo = dt_v[tid] * ah, hi = dt_v[tid + 32] * ah;
    warp_cumsum64(lo, hi);
    const float end = __shfl_sync(kFull, (q - 1) < 32 ? lo : hi,
                                  (q - 1) & 31);
    cum[tid] = lo;
    cum[tid + 32] = hi;
    ev[tid] = expf(lo);
    ev[tid + 32] = expf(hi);
    wv[tid] = expf(end - lo);
    wv[tid + 32] = expf(end - hi);
  }
  __syncthreads();

  // CB_ls = c_l . b_s and DX_ls = dy_l . x_s dt_s (s <= l), E_ls
  block_mm(q, q, N, [&](int i, int k) { return c_s[i * kLdN + k]; },
           [&](int k, int j) { return b_s[j * kLdN + k]; },
           [&](int i, int j, float v) {
             cb_s[i * kLdQ + j] = j <= i ? v : 0.f;
           });
  block_mm(q, q, P, [&](int i, int k) { return dy_s[i * kLdP + k]; },
           [&](int k, int j) { return x_s[j * kLdP + k]; },
           [&](int i, int j, float v) {
             d_s[i * kLdQ + j] = j <= i ? v * dt_v[j] : 0.f;
           });
  for (int i = tid; i < q * q; i += kChunkThreads) {
    const int l = i / q;
    const int s = i - l * q;
    e_s[l * kLdQ + s] = s <= l ? expf(cum[l] - cum[s]) : 0.f;
  }
  // g_l = G_n b_l (q x P)
  block_mm(q, P, N, [&](int i, int k) { return b_s[i * kLdN + k]; },
           [&](int k, int j) { return g_s[j * kLdN + k]; },
           [&](int i, int j, float v) { u_s[i * kLdP + j] = v; });
  __syncthreads();

  // the pairs (k >= l, s < l) of M, and r_l
  if (tid < q) {
    const int l = tid;
    float d = 0.f;
    for (int k = l; k < q; ++k)
      for (int s = 0; s < l; ++s)
        d = fmaf(cb_s[k * kLdQ + s] * e_s[k * kLdQ + s], d_s[k * kLdQ + s],
                 d);
    float r = 0.f;
    for (int p = 0; p < P; ++p) r = fmaf(x_s[l * kLdP + p], u_s[l * kLdP + p], r);
    rv[l] = r * dt_v[l] * wv[l];
    cross[l] = d;
  }
  __syncthreads();

  // dxdt_s = sum_l CB_ls E_ls dy_l + w_s g_s, in place of g
  block_mm(q, P, q,
           [&](int i, int k) { return cb_s[k * kLdQ + i] * e_s[k * kLdQ + i]; },
           [&](int k, int j) { return dy_s[k * kLdP + j]; },
           [&](int i, int j, float v) {
             u_s[i * kLdP + j] = fmaf(wv[i], u_s[i * kLdP + j], v);
           });
  __syncthreads();

  // dx = dxdt dt; x . dxdt for ddt
  for (int i = tid; i < q * P; i += kChunkThreads) {
    const int l = i / P;
    const int p = i - l * P;
    stf(dx + (((size_t)bb * L + r0 + l) * H + h) * P + p,
        u_s[l * kLdP + p] * dt_v[l]);
  }
  if (tid < q) {
    float r = 0.f;
    for (int p = 0; p < P; ++p)
      r = fmaf(x_s[tid * kLdP + p], u_s[tid * kLdP + p], r);
    ddt1[tid] = r;
  }
  // db_s (this head) = sum_l T_ls c_l + w_s G_n^T xdt_s
  float* dbo = dbh + (bh * L + r0) * (size_t)N;
  block_mm2(q, N, q,
            [&](int i, int k) { return e_s[k * kLdQ + i] * d_s[k * kLdQ + i]; },
            [&](int k, int j) { return c_s[k * kLdN + j]; }, P,
            [&](int i, int k) { return x_s[i * kLdP + k]; },
            [&](int k, int j) { return g_s[k * kLdN + j]; },
            [&](int i) { return wv[i] * dt_v[i]; },
            [&](int i, int j, float v) { dbo[(size_t)i * N + j] = v; });
  __syncthreads();                      // G_n is read: S_n takes its place

  for (int i = tid; i < P * N; i += kChunkThreads) {
    const int p = i / N;
    g_s[p * kLdN + (i - p * N)] = entry[sn_off + i];
  }
  __syncthreads();

  // u_l = S_n c_l (q x P)
  block_mm(q, P, N, [&](int i, int k) { return c_s[i * kLdN + k]; },
           [&](int k, int j) { return g_s[j * kLdN + k]; },
           [&](int i, int j, float v) { u_s[i * kLdP + j] = v; });
  __syncthreads();
  if (tid < q) {
    float r = 0.f;
    for (int p = 0; p < P; ++p)
      r = fmaf(dy_s[tid * kLdP + p], u_s[tid * kLdP + p], r);
    inter[tid] = ev[tid] * r;
  }
  // dc_l (this head) = sum_s T_ls b_s + e_l S_n^T dy_l
  float* dco = dch + (bh * L + r0) * (size_t)N;
  block_mm2(q, N, q,
            [&](int i, int k) { return e_s[i * kLdQ + k] * d_s[i * kLdQ + k]; },
            [&](int k, int j) { return b_s[k * kLdN + j]; }, P,
            [&](int i, int k) { return dy_s[i * kLdP + k]; },
            [&](int k, int j) { return g_s[k * kLdN + j]; },
            [&](int i) { return ev[i]; },
            [&](int i, int j, float v) { dco[(size_t)i * N + j] = v; });
  __syncthreads();

  // d(da), ddt and this chunk's part of da (each sum in a fixed order)
  float dda = 0.f;
  if (tid < q) {
    const int l = tid;
    float gs = 0.f;
    for (int w = 0; w < kChunkThreads / 32; ++w) gs += red[w];
    float pre = 0.f, suf = 0.f;
    for (int s = 0; s < l; ++s) pre += rv[s];
    for (int k = q - 1; k >= l; --k) suf += inter[k];
    dda = cross[l] + fmaf(ev[q - 1], gs, pre) + suf;
    ddt[((size_t)bb * L + r0 + l) * H + h] = fmaf(ah, dda, ddt1[l]);
  }
  __syncthreads();                      // inter is read
  if (tid < q) inter[tid] = dt_v[tid] * dda;
  __syncthreads();
  if (tid == 0) {
    float part = 0.f;
    for (int l = 0; l < q; ++l) part += inter[l];
    dap[bh * nc + n] = part;
  }
}

// Launch 3.  db, dc (B, L, N) in T from the per-head f32 partials (B, H,
// L, N), each a sum over h in order; the last block: da (H,) from the
// per-chunk partials (B, H, nc), summed over batch then chunks in order.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ dbh,
                      const float* __restrict__ dch,
                      const float* __restrict__ dap, T* __restrict__ db,
                      T* __restrict__ dc, float* __restrict__ da, int B,
                      int L, int H, int N, int nc) {
  const long long per = (long long)L * N;
  const long long total = (long long)B * per;
  if (blockIdx.x == gridDim.x - 1) {
    for (int h = threadIdx.x; h < H; h += kReduceThreads) {
      float s = 0.f;
      for (int bb = 0; bb < B; ++bb)
        for (int n = 0; n < nc; ++n) s += dap[((size_t)bb * H + h) * nc + n];
      da[h] = s;
    }
    return;
  }
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= total) return;
  const long long bb = i / per;
  const long long r = i - bb * per;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    const size_t o = ((size_t)bb * H + h) * per + r;
    sb += dbh[o];
    sc += dch[o];
  }
  stf(db + i, sb);
  stf(dc + i, sc);
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
int bwd_launch(const void* x, const void* dt, const void* a, const void* b,
               const void* c, const void* entry, const void* dy,
               const void* dfinal, void* dx, void* ddt, void* da, void* db,
               void* dc, void* dinit, void* gexit, void* dbh, void* dch,
               void* dap, int B, int L, int H, int P, int N, int Q,
               long long sxb, long long sxl, long long sbb, long long sbl,
               long long scb, long long scl, cudaStream_t stream) {
  const int nc = (L + Q - 1) / Q;
  ssd_bwd_state_kernel<T><<<dim3((P + kPS - 1) / kPS, H, B), kStateThreads,
                            0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(c),
      static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(dfinal), static_cast<float*>(gexit),
      static_cast<float*>(dinit), L, H, P, N, Q, nc, scb, scl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  static bool configured = false;
  const size_t smem = chunk_smem_floats() * sizeof(float);
  err = allow_smem(ssd_bwd_chunk_kernel<T>, smem, configured);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk_kernel<T><<<dim3(nc, H, B), kChunkThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(entry),
      static_cast<const T*>(dy), static_cast<const float*>(gexit),
      static_cast<T*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dbh), static_cast<float*>(dch),
      static_cast<float*>(dap), L, H, P, N, Q, sxb, sxl, sbb, sbl, scb, scl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long total = (long long)B * L * N;
  const int blocks = (int)((total + kReduceThreads - 1) / kReduceThreads) + 1;
  ssd_bwd_reduce_kernel<T><<<blocks, kReduceThreads, 0, stream>>>(
      static_cast<const float*>(dbh), static_cast<const float*>(dch),
      static_cast<const float*>(dap), static_cast<T*>(db),
      static_cast<T*>(dc), static_cast<float*>(da), B, L, H, N, nc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The backward of K4.  x (B, L, H, P) with batch / row strides sxb / sxl
// (elements; heads at stride P, elements at stride 1), b / c (B, L, N)
// likewise, all of one dtype (bf16 != 0: bfloat16, else float); dt (B, L,
// H) and a (H,) float; entry (B, H, nc, P, N) float, the chunk-entry
// states the forward's scan saved; dy (B, L, H, P) packed in x's dtype;
// dfinal (B, H, P, N) float or null (zeros).  Writes dx (B, L, H, P) in
// x's dtype, ddt (B, L, H) and da (H,) float, db and dc (B, L, N) in b's
// dtype and dinit (B, H, P, N) float, through the float scratch gexit (B,
// H, nc, P, N), dbh and dch (B, H, L, N) and dap (B, H, nc), all packed.
// Three launches on `stream`; returns the first failing cudaError_t (0:
// all launched).  The caller checks shapes and dtypes and allocates.
int ssd_scan_bwd(const void* x, const void* dt, const void* a, const void* b,
                 const void* c, const void* entry, const void* dy,
                 const void* dfinal, void* dx, void* ddt, void* da, void* db,
                 void* dc, void* dinit, void* gexit, void* dbh, void* dch,
                 void* dap, int B, int L, int H, int P, int N, int Q,
                 long long sxb, long long sxl, long long sbb, long long sbl,
                 long long scb, long long scl, int bf16, void* stream) {
  if (B == 0 || H == 0 || L == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? bwd_launch<__nv_bfloat16>(
                    x, dt, a, b, c, entry, dy, dfinal, dx, ddt, da, db, dc,
                    dinit, gexit, dbh, dch, dap, B, L, H, P, N, Q, sxb, sxl,
                    sbb, sbl, scb, scl, s)
              : bwd_launch<float>(x, dt, a, b, c, entry, dy, dfinal, dx, ddt,
                                  da, db, dc, dinit, gexit, dbh, dch, dap, B,
                                  L, H, P, N, Q, sxb, sxl, sbb, sbl, scb, scl,
                                  s);
}

}  // extern "C"
