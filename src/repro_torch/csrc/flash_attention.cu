// K2: blocked online-softmax attention forward with per-row positions,
// for NVIDIA Hopper (sm_90a).  Built by repro_torch/kernels/_build.py with
// nvcc into a shared library with a plain C interface (loaded by ctypes).
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_fwd_pallas
// (body _flash_kernel), and on the TConst path the semantics of
// src/repro/kernels/xla_flash.py, which the JAX resync calls directly.
// Masking is positional: a key is attended iff its position is not
// INVALID_POS (int32 max / 2, a dead slot), and -- when causal -- k_pos <=
// q_pos, and -- when window > 0 -- k_pos > q_pos - window.  Scores are
// masked to NEG_INF = -2.3819763e38 (not -inf) and their probabilities
// forced to 0, so a query with no valid key (the resync's compress queries
// at negative tail positions) gives acc / (l + 1e-30) = 0.
//
// Layouts: q (B, Lq, H, D); k, v (B, Lk, KV, D), all contiguous; q_pos
// (B, Lq), k_pos (B, Lk) int32; out (B, Lq, H, D) in q's type; lse, when
// not null, (B, H, Lq) f32: each row's m + log(l + 1e-30), xla_flash._fwd's
// log-sum-exp, which the backward (flash_attention_bwd.cu) reads.  f32 and
// bf16 inputs.  Lq and Lk are arbitrary (ragged tiles are masked), the
// window is a runtime argument, and the KV head of query head h is
// h / (H / KV) (no repeat of K/V over the group).
//
// What bounds it on an H100: at tconst-41m's resync and admission shapes
// (D = 36, Lq and Lk in the hundreds) the least time is ~1 us of bytes;
// for long histories the 4 * Lq * Lk * D flops per head.  Either way the
// first version (one thread per query, scalar f32 FMAs against a broadcast
// key row, every key tile walked, ~100 blocks of 64 threads) was bound by
// its own issue rate and by too little work in flight.  This design:
//
// * bf16 on tensor cores: mma.sync.m16n8k16 (bf16 inputs, f32 sums), one
//   warp per 16 query rows.  Chosen over wgmma because at D = 36 a tile's
//   products are 3 k16 steps -- too small to fill a 64-row warpgroup
//   product's pipeline -- and because a block of 1, 2 or 4 warps lets the
//   host pick a 16-, 32- or 64-query tile so that short Lq still puts
//   enough blocks in flight.  The head dim is padded with zeros in shared
//   memory to DP, a multiple of 16 (48 for 36).  S = Q K^T in f32, scaled,
//   masked, online softmax in f32; P is rounded to bf16 for O += P V (as
//   FlashAttention-2 does) straight from the S accumulators' registers; V's
//   fragments come from ldmatrix.trans.
// * f32 stays exact f32 on the CUDA cores (no TF32: ~3 digits would break
//   the 1e-4 tolerance): 128 threads, a 32 x 32 tile, each thread a 4 x 2
//   register tile of scores and a 4 x DP/16 tile of the output.
// * Dead tiles are skipped.  Before a key tile is loaded, its positions
//   decide whether any (query, key) pair of the block can be attended:
//   some key not INVALID_POS, at or before the block's largest query
//   position (causal), after its smallest minus the window (window).  The
//   block scans the positions of 32 tiles at a time into a bit mask and
//   walks the live tiles only; a skipped tile would add p = 0, so the
//   values are exact (tile_live in kernels/flash_attention.py is the same
//   predicate, tested against position_mask).
// * K/V tiles are copied to shared memory with cp.async (16, 8 or 4 bytes;
//   a bf16 row of one KV head is 72 bytes at a stride of KV * D * 2, so 8),
//   double-buffered: the next live tile's copy overlaps this tile's
//   products.  Keys past Lk are zero-filled by the copy and masked.
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kInvalidPos = 1073741823;  // int32 max // 2
constexpr int kBK = 64;                  // keys per tile (bf16)
constexpr int kBQ32 = 32;                // queries per block (f32)
constexpr int kBK32 = 32;                // keys per tile (f32)
constexpr int kThreads32 = 128;          // threads per block (f32)

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Whether key position kp can be attended by some query of a block whose
// active query positions span [qmin, qmax].
__device__ __forceinline__ bool key_live(int kp, int qmin, int qmax,
                                         int causal, int window) {
  return kp != kInvalidPos && (!causal || kp <= qmax) &&
         (window <= 0 || kp > qmin - window);
}

__device__ __forceinline__ bool key_ok(int kp, int qp, int causal,
                                       int window) {
  return kp != kInvalidPos && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// The live-tile walk: bits of 32 tiles (tiles 32 * sc .. 32 * sc + 31) at a
// time, from the positions of their keys.  Every thread of the block calls
// next() with the same argument (it holds __syncthreads).
struct LiveTiles {
  const int* kp;  // the row's key positions
  int Lk, BK, n_tiles, qmin, qmax, causal, window;
  unsigned* red;  // one word of shared memory
  int sc = -1;
  unsigned bits = 0u;

  __device__ unsigned scan(int s) {
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;
    if (tid == 0) *red = 0u;
    __syncthreads();
    const int k0 = s * 32 * BK;
    const int k1 = min(Lk, k0 + 32 * BK);
    unsigned b = 0u;
    for (int k = k0 + tid; k < k1; k += nthr)
      if (key_live(kp[k], qmin, qmax, causal, window))
        b |= 1u << ((k - k0) / BK);
    b = __reduce_or_sync(0xffffffffu, b);
    if ((tid & 31) == 0 && b) atomicOr(red, b);
    __syncthreads();
    const unsigned r = *red;
    __syncthreads();
    return r;
  }

  // the first live tile at or after t, or n_tiles
  __device__ int next(int t) {
    while (t < n_tiles) {
      const int s = t >> 5;
      if (s != sc) {
        bits = scan(s);
        sc = s;
      }
      const unsigned m = bits >> (t & 31);
      if (m) return t + __ffs(m) - 1;
      t = (s + 1) << 5;
    }
    return n_tiles;
  }
};

// Copy rows [t0, t0 + BK) of K and V (KV head kvh of batch row b) and their
// positions into one buffer: ks / vs[r * DS + d], kps[r].  vec: bytes per
// cp.async (16, 8, 4), or 0 for synchronous element copies (a row whose
// bytes 4 does not divide).  Rows past Lk are zero-filled.
template <typename T>
__device__ __forceinline__ void copy_tile(T* ks, T* vs, int* kps,
                                          const T* __restrict__ k,
                                          const T* __restrict__ v,
                                          const int* __restrict__ kp,
                                          size_t base, size_t rstride,
                                          int t0, int Lk, int BK, int D,
                                          int DS, int vec) {
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int nvalid = min(BK, Lk - t0);
  if (vec == 0) {
    for (int i = tid; i < BK * D; i += nthr) {
      const int r = i / D;
      const int d = i - r * D;
      const bool ok = r < nvalid;
      const size_t g = base + (size_t)(t0 + r) * rstride + d;
      ks[r * DS + d] = ok ? k[g] : from_f32<T>(0.f);
      vs[r * DS + d] = ok ? v[g] : from_f32<T>(0.f);
    }
  } else {
    const int epc = vec / (int)sizeof(T);  // elements per copy
    const int cpr = D / epc;
    for (int i = tid; i < BK * cpr; i += nthr) {
      const int r = i / cpr;
      const int c = i - r * cpr;
      const bool ok = r < nvalid;
      const size_t g = base + (size_t)(ok ? t0 + r : 0) * rstride + c * epc;
      const uint32_t dk = smem_addr(ks + r * DS + c * epc);
      const uint32_t dv = smem_addr(vs + r * DS + c * epc);
      const int n = ok ? vec : 0;
      if (vec == 16) {
        cp_async<16>(dk, k + g, n);
        cp_async<16>(dv, v + g, n);
      } else if (vec == 8) {
        cp_async<8>(dk, k + g, n);
        cp_async<8>(dv, v + g, n);
      } else {
        cp_async<4>(dk, k + g, n);
        cp_async<4>(dv, v + g, n);
      }
    }
  }
  for (int r = tid; r < BK; r += nthr)
    cp_async<4>(smem_addr(kps + r), kp + (r < nvalid ? t0 + r : 0),
                r < nvalid ? 4 : 0);
}

// The block's smallest and largest active query positions.
__device__ __forceinline__ void query_span(const int* __restrict__ qp_row,
                                           int q0, int BQ, int Lq, int* span) {
  if (threadIdx.x == 0) {
    span[0] = INT_MAX;
    span[1] = INT_MIN;
  }
  __syncthreads();
  int mn = INT_MAX, mx = INT_MIN;
  for (int i = threadIdx.x; i < BQ; i += blockDim.x)
    if (q0 + i < Lq) {
      const int p = qp_row[q0 + i];
      mn = min(mn, p);
      mx = max(mx, p);
    }
  atomicMin(span, mn);
  atomicMax(span + 1, mx);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// grid (ceil(Lq / (16 * warps)), B * H), block 32 * warps.  DP: head dim
// padded to a multiple of 16; rows of shared memory DS = DP + 8 elements
// (16-byte aligned for ldmatrix, conflict-free for the 32-bit fragment
// loads).  Dynamic shared memory: q_s[BQ][DS] | k_s[2][kBK][DS] |
// v_s[2][kBK][DS] (bf16) | kp_s[2][kBK] (int).
template <int DP>
__global__ void __launch_bounds__(128)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ q_pos,
                  const int* __restrict__ k_pos,
                  __nv_bfloat16* __restrict__ out,
                  float* __restrict__ lse, int Lq, int Lk, int H, int KV,
                  int D, int causal, int window, float scale, float softcap,
                  int vec) {
  constexpr int DS = DP + 8;
  constexpr int KSTEPS = DP / 16;  // k16 steps of Q K^T
  constexpr int NT = kBK / 8;      // n8 tiles of S
  constexpr int DT = DP / 8;       // n8 tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int span[2];
  __shared__ unsigned red;
  const int warps = blockDim.x >> 5;
  const int BQ = 16 * warps;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + BQ * DS;
  __nv_bfloat16* v_s = k_s + 2 * kBK * DS;
  int* kp_s = reinterpret_cast<int*>(v_s + 2 * kBK * DS);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // thread in group

  // zero q / k / v (the pad columns stay zero), then stage Q
  {
    uint32_t* z = reinterpret_cast<uint32_t*>(smem_raw);
    const int words = (BQ + 4 * kBK) * DS / 2;
    for (int i = tid; i < words; i += blockDim.x) z[i] = 0u;
  }
  __syncthreads();
  for (int i = tid; i < BQ * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i - r * D;
    if (q0 + r < Lq)
      q_s[r * DS + d] = q[(((size_t)b * Lq + q0 + r) * H + h) * D + d];
  }
  const int* qp_row = q_pos + (size_t)b * Lq;
  query_span(qp_row, q0, BQ, Lq, span);  // holds __syncthreads

  const int r0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int r1 = r0 + 8;
  const int qp0 = r0 < Lq ? qp_row[r0] : 0;
  const int qp1 = r1 < Lq ? qp_row[r1] : 0;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const __nv_bfloat16* base = q_s + (warp * 16 + g) * DS + kk * 16 + 2 * t4;
    qa[kk][0] = lds32(base);
    qa[kk][1] = lds32(base + 8 * DS);
    qa[kk][2] = lds32(base + 8);
    qa[kk][3] = lds32(base + 8 * DS + 8);
  }
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  const int* kp_row = k_pos + (size_t)b * Lk;
  const size_t kv_base = (size_t)b * Lk * KV * D + (size_t)kvh * D;
  const size_t rstride = (size_t)KV * D;
  LiveTiles live{kp_row, Lk, kBK, (Lk + kBK - 1) / kBK, span[0], span[1],
                 causal, window, &red};
  int t = live.next(0);
  if (t < live.n_tiles)
    copy_tile(k_s, v_s, kp_s, k, v, kp_row, kv_base, rstride, t * kBK, Lk,
              kBK, D, DS, vec);
  cp_async_commit();
  int buf = 0;
  while (t < live.n_tiles) {
    const int tn = live.next(t + 1);
    if (tn < live.n_tiles)
      copy_tile(k_s + (buf ^ 1) * kBK * DS, v_s + (buf ^ 1) * kBK * DS,
                kp_s + (buf ^ 1) * kBK, k, v, kp_row, kv_base, rstride,
                tn * kBK, Lk, kBK, D, DS, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const __nv_bfloat16* kb = k_s + buf * kBK * DS;
    const __nv_bfloat16* vb = v_s + buf * kBK * DS;
    const int* kpb = kp_s + buf * kBK;
    const int t0 = t * kBK;
    // S = Q K^T
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* kr = kb + (j * 8 + g) * DS + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk)
        mma_bf16(s[j], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3],
                 lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
    }
    // scale, softcap, mask; the tile's row maxima
    unsigned okb = 0u;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j * 8 + 2 * t4 + (e & 1);
        const bool ok = t0 + key < Lk &&
                        key_ok(kpb[key], e < 2 ? qp0 : qp1, causal, window);
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[j][e] = ok ? x : kNegInf;
        okb |= (ok ? 1u : 0u) << (j * 4 + e);
        if (e < 2)
          mx0 = fmaxf(mx0, s[j][e]);
        else
          mx1 = fmaxf(mx1, s[j][e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ((okb >> (j * 4 + e)) & 1u)
                            ? expf(s[j][e] - (e < 2 ? mn0 : mn1))
                            : 0.f;
        s[j][e] = p;
        if (e < 2)
          ps0 += p;
        else
          ps1 += p;
      }
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= al0;
      acc[n][1] *= al0;
      acc[n][2] *= al1;
      acc[n][3] *= al1;
    }
    // O += P V: P from the S registers (bf16), V by ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int mi = lane >> 3;
      const __nv_bfloat16* vrow =
          vb + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * DS + (mi >> 1) * 8;
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vrow + dp * 16);
        mma_bf16(acc[2 * dp], a0, a1, a2, a3, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a0, a1, a2, a3, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
    buf ^= 1;
    t = tn;
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / (l0 + 1e-30f), inv1 = 1.f / (l1 + 1e-30f);
  if (lse != nullptr && t4 == 0) {
    if (r0 < Lq) lse[((size_t)b * H + h) * Lq + r0] = m0 + logf(l0 + 1e-30f);
    if (r1 < Lq) lse[((size_t)b * H + h) * Lq + r1] = m1 + logf(l1 + 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = n * 8 + 2 * t4 + (e & 1);
      const int r = e < 2 ? r0 : r1;
      if (d < D && r < Lq)
        out[(((size_t)b * Lq + r) * H + h) * D + d] =
            __float2bfloat16(acc[n][e] * (e < 2 ? inv0 : inv1));
    }
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, exact f32
// ---------------------------------------------------------------------------

// grid (ceil(Lq / 32), B * H), block 128.  Thread (tq, tk): tq = 2 * warp +
// lane / 16 owns queries 4 tq .. 4 tq + 3; tk = lane % 16 owns keys tk and
// tk + 16 of a tile and output dims tk + 16 j.  Rows of shared memory
// DS = DP + 1 floats (odd: conflict-free), so copies are 4 bytes.
// Dynamic shared memory (floats): q_s[32][DS] | k_s[2][32][DS] |
// v_s[2][32][DS] | p_s[32][33] | kp_s[2][32] (int).
template <int DP>
__global__ void __launch_bounds__(kThreads32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ q_pos,
                 const int* __restrict__ k_pos, float* __restrict__ out,
                 float* __restrict__ lse, int Lq, int Lk, int H, int KV,
                 int D, int causal, int window, float scale, float softcap) {
  constexpr int DS = DP + 1;
  constexpr int DJ = DP / 16;  // output dims per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int span[2];
  __shared__ unsigned red;
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* k_s = q_s + kBQ32 * DS;
  float* v_s = k_s + 2 * kBK32 * DS;
  float* p_s = v_s + 2 * kBK32 * DS;
  int* kp_s = reinterpret_cast<int*>(p_s + kBQ32 * 33);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ32;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tq = 2 * (tid >> 5) + (lane >> 4);
  const int tk = lane & 15;

  for (int i = tid; i < (kBQ32 + 4 * kBK32) * DS; i += kThreads32)
    q_s[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < kBQ32 * D; i += kThreads32) {
    const int r = i / D;
    const int d = i - r * D;
    if (q0 + r < Lq)
      q_s[r * DS + d] = q[(((size_t)b * Lq + q0 + r) * H + h) * D + d] * scale;
  }
  const int* qp_row = q_pos + (size_t)b * Lq;
  query_span(qp_row, q0, kBQ32, Lq, span);

  int qp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * tq + i;
    qp[i] = r < Lq ? qp_row[r] : 0;
  }
  float acc[4][DJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int* kp_row = k_pos + (size_t)b * Lk;
  const size_t kv_base = (size_t)b * Lk * KV * D + (size_t)kvh * D;
  const size_t rstride = (size_t)KV * D;
  LiveTiles live{kp_row, Lk, kBK32, (Lk + kBK32 - 1) / kBK32, span[0],
                 span[1], causal, window, &red};
  int t = live.next(0);
  if (t < live.n_tiles)
    copy_tile(k_s, v_s, kp_s, k, v, kp_row, kv_base, rstride, t * kBK32, Lk,
              kBK32, D, DS, 4);
  cp_async_commit();
  int buf = 0;
  float* prow = p_s + 4 * tq * 33;
  while (t < live.n_tiles) {
    const int tn = live.next(t + 1);
    if (tn < live.n_tiles)
      copy_tile(k_s + (buf ^ 1) * kBK32 * DS, v_s + (buf ^ 1) * kBK32 * DS,
                kp_s + (buf ^ 1) * kBK32, k, v, kp_row, kv_base, rstride,
                tn * kBK32, Lk, kBK32, D, DS, 4);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const float* kb = k_s + buf * kBK32 * DS;
    const float* vb = v_s + buf * kBK32 * DS;
    const int* kpb = kp_s + buf * kBK32;
    const int t0 = t * kBK32;
    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    const float* qr = q_s + 4 * tq * DS;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float k0 = kb[tk * DS + d];
      const float k1 = kb[(tk + 16) * DS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = qr[i * DS + d];
        s[i][0] += x * k0;
        s[i][1] += x * k1;
      }
    }
    float p[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[2];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = tk + 16 * j;
        ok[j] = t0 + key < Lk && key_ok(kpb[key], qp[i], causal, window);
        float x = s[i][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        s[i][j] = ok[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      const float al = expf(m[i] - mn);
      m[i] = mn;
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        p[i][j] = ok[j] ? expf(s[i][j] - mn) : 0.f;
        ps += p[i][j];
      }
      l[i] = l[i] * al + ps;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= al;
      prow[i * 33 + tk] = p[i][0];
      prow[i * 33 + tk + 16] = p[i][1];
    }
    __syncwarp();
#pragma unroll 4
    for (int key = 0; key < kBK32; ++key) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vb[key * DS + tk + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pk = prow[i * 33 + key];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += pk * vv[j];
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on; p_s reused
    buf ^= 1;
    t = tn;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, o);
    const int r = q0 + 4 * tq + i;
    if (r >= Lq) continue;
    if (lse != nullptr && tk == 0)
      lse[((size_t)b * H + h) * Lq + r] = m[i] + logf(li + 1e-30f);
    const float inv = 1.f / (li + 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tk + 16 * j;
      if (d < D) out[(((size_t)b * Lq + r) * H + h) * D + d] = acc[i][j] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

constexpr int kSms = 132;  // H100 SXM

template <typename K>
cudaError_t set_smem(K kernel, size_t smem, size_t* configured) {
  if (smem <= *configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *configured = smem;
  return err;
}

// Warps per bf16 block: the largest of 4, 2, 1 that still gives two blocks
// an SM (from the shapes alone), else 1.
int bf16_warps(int B, int Lq, int H) {
  for (int w = 4; w > 1; w >>= 1)
    if ((long long)((Lq + 16 * w - 1) / (16 * w)) * B * H >= 2 * kSms)
      return w;
  return 1;
}

// Bytes per cp.async for bf16 rows: the widest of 16, 8, 4 that divides a
// row and the alignment of k and v; 0 for element copies.
int copy_bytes(const void* k, const void* v, int D, int esize) {
  const size_t row = (size_t)D * esize;
  const uintptr_t al = reinterpret_cast<uintptr_t>(k) |
                       reinterpret_cast<uintptr_t>(v);
  for (int c = 16; c >= 4; c >>= 1)
    if (row % c == 0 && al % c == 0) return c;
  return 0;
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* qp, const void* kp, void* out, void* lse,
                        int B, int Lq, int Lk, int H, int KV, int D,
                        int causal, int window, float scale, float softcap,
                        cudaStream_t st) {
  static size_t configured = 48 * 1024;
  const int warps = bf16_warps(B, Lq, H);
  const int BQ = 16 * warps;
  const size_t smem = (size_t)(BQ + 4 * kBK) * (DP + 8) * 2 + 2 * kBK * 4;
  auto kernel = flash_bf16_kernel<DP>;
  cudaError_t err = set_smem(kernel, smem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + BQ - 1) / BQ, B * H);
  kernel<<<grid, 32 * warps, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(qp),
      static_cast<const int*>(kp), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Lq, Lk, H, KV, D, causal, window, scale,
      softcap, copy_bytes(k, v, D, 2));
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* qp, const void* kp, void* out, void* lse,
                       int B, int Lq, int Lk, int H, int KV, int D, int causal,
                       int window, float scale, float softcap,
                       cudaStream_t st) {
  static size_t configured = 48 * 1024;
  const size_t smem = (size_t)((kBQ32 + 4 * kBK32) * (DP + 1) + kBQ32 * 33) *
                          4 + 2 * kBK32 * 4;
  auto kernel = flash_f32_kernel<DP>;
  cudaError_t err = set_smem(kernel, smem, &configured);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kBQ32 - 1) / kBQ32, B * H);
  kernel<<<grid, kThreads32, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(qp),
      static_cast<const int*>(kp), static_cast<float*>(out),
      static_cast<float*>(lse), Lq, Lk, H, KV, D, causal, window, scale,
      softcap);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  lse: (B, H, Lq) f32 or null (not
// written).  Returns the launch's cudaError_t.  The caller validates shapes
// (D <= 128, H % KV == 0).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* k_pos, void* out,
                        void* lse, int B, int Lq, int Lk, int H, int KV, int D,
                        int causal, int window, float scale, float softcap,
                        int dtype, void* stream) {
  if (B == 0 || Lq == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_CASE(DPV)                                                 \
  if (D <= DPV)                                                               \
    return (int)(dtype == 0                                                   \
                     ? launch_f32<DPV>(q, k, v, q_pos, k_pos, out, lse, B,    \
                                       Lq, Lk, H, KV, D, causal, window,      \
                                       scale, softcap, st)                    \
                     : launch_bf16<DPV>(q, k, v, q_pos, k_pos, out, lse, B,   \
                                        Lq, Lk, H, KV, D, causal, window,     \
                                        scale, softcap, st));
  REPRO_FLASH_CASE(16)
  REPRO_FLASH_CASE(32)
  REPRO_FLASH_CASE(48)
  REPRO_FLASH_CASE(64)
  REPRO_FLASH_CASE(128)
#undef REPRO_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
