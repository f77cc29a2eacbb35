// K2 backward: the gradient of the blocked attention forward with per-row
// positions, for NVIDIA Hopper (sm_90a).  Built by
// repro_torch/kernels/_build.py with nvcc into a shared library with a
// plain C interface (loaded by ctypes).
//
// Replaces: src/repro/kernels/xla_flash.py, _bwd (through _flash_bwd_rule),
// which the JAX package reaches behind jax.custom_vjp from the Pallas
// forward (src/repro/kernels/ops.py, _fp_bwd) and from xla_flash's own
// forward.  From q, k, v, the positions, the forward's output o, its row
// log-sum-exp lse and the output gradient do:
//
//   delta = rowsum(do * o)
//   p     = exp(mask(cap(s)) - lse), 0 where masked   (s = scale * q . k)
//   dv    = p^T . do
//   ds    = p * (do . v^T - delta), times 1 - tanh^2 under a softcap
//   dq    = ds . k * scale,  dk = ds^T . q * scale
//
// with dk and dv summed over the G query heads of each KV head.  Masking is
// the forward's: a key is attended iff its position is not INVALID_POS and
// (causal) k_pos <= q_pos and (window > 0) k_pos > q_pos - window.
//
// Layouts: q, o, do, dq (B, Lq, H, D); k, v, dk, dv (B, Lk, KV, D), all
// contiguous, in one type (f32 or bf16); q_pos (B, Lq), k_pos (B, Lk) int32;
// lse and the delta scratch (B, H, Lq) f32.  The KV head of query head h is
// h / G.  Lq and Lk are arbitrary; D <= 128, padded with zeros in shared
// memory to DP (16, 32, 48, 64 or 128).
//
// What bounds it on an H100: the operations.  At tconst-41m's train shapes
// (D = 36, Lq and Lk 256-1024) the five products (S and dP are recomputed
// in the second pass) are 10 * D flops per head and attended pair against
// ~10 MB of inputs: in bf16 0.018 ms at the tensor cores' peak for the base
// transformer's causal 1024 (B 8).  Short of that bound, what limits a
// design is the work around the products: per score an exponential, the
// mask test and a few multiplies on the CUDA cores, the shared-memory
// loads that feed the tensor cores, and the tile copies.  Three launches,
// no atomics (two runs give bit-identical gradients):
//
// * delta: one warp per row.
// * dk/dv over (key tile, B * KV): the block holds its K/V tile and walks
//   the live query tiles and, for each, the G query heads of its KV head,
//   summing dk and dv in registers and writing them once (the sum over the
//   group needs neither atomics nor a second pass).
// * dq over (query tile, B * H): the block holds its Q/dO tile and walks
//   the live key tiles.  Both passes recompute p from lse.
//
// bf16 (bwd_dkdv_bf16_kernel, bwd_dq_bf16_kernel): FlashAttention-2's
// backward on tensor cores, mma.sync.m16n8k16 (bf16 operands, f32 sums),
// one warp per 16 rows of the block's own tile and 1, 2 or 4 warps a block
// (the most that still gives two blocks an SM).  dk/dv: S^T = K Q^T and
// dP^T = V dO^T (K, V the A operands; Q, dO B operands by ldmatrix); p^T
// and dS^T are formed in the accumulators' registers and rounded to bf16
// straight into A fragments for dV += P^T dO and dK += dS^T Q (dO, Q by
// ldmatrix.trans), over query tiles of 32 (in trial builds 64 was no
// faster on long causal rows and slower on 256-row self-attentions).  dq: S =
// Q K^T, dP = dO V^T, dQ += dS K (K by ldmatrix.trans) over key tiles of
// 64 (32 at DP 128, for registers); scale once at the end.  Only the
// products' operands are bf16 (P and dS rounded once each); every sum and
// the elementwise work stay f32, with exp2 of one FMA and, under a
// softcap, tanh from exp2 and a reciprocal (tanhf and a division per
// score dominated such a pass in trial builds).  Tiles are copied by
// cp.async into a ring of three stages, issued two tiles ahead, one
// barrier a tile (with two stages the copies, not the products, held
// the passes back).  Rows of
// shared memory are DP + 8 elements (16-byte aligned for ldmatrix,
// conflict-free).  A tile whose every pair is attended (a causal tile
// below the diagonal) skips the per-pair mask test; a block with nothing
// to attend writes zeros without staging a tile.
// f32 (bwd_dkdv_kernel<float>, bwd_dq_kernel<float>): exact f32 on the
// CUDA cores (no TF32: its ~3 digits would break the 1e-4 tolerance), 128
// threads on 32 x 32 tiles staged by scalar loads, each thread a 4 x 2
// register tile of scores and 4 rows x DP/16 dims of its gradient.
//
// Dead tiles are skipped in both, by the forward's predicate mirrored: the
// dq pass walks key tiles with some key not INVALID_POS, at or before the
// block's largest query position (causal), after its smallest minus the
// window (window); the dk/dv pass walks query tiles with some query at or
// after the smallest valid key of its tile (causal) and before its largest
// plus the window (window).  A skipped tile adds p = 0, so the values are
// exact (tile_live / query_tile_live in kernels/flash_attention.py are the
// same predicates, tested against position_mask).
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kInvalidPos = 1073741823;  // int32 max // 2
constexpr int kBT = 32;                  // rows of a query or key tile (f32)
constexpr int kThreads = 128;            // threads per tile block (f32)
constexpr int kPS = kBT + 1;             // row stride of p_s / ds_s (f32)
constexpr int kBQ16 = 32;                // queries of a dk/dv tile (bf16)
constexpr int kStages = 3;               // cp.async ring of the bf16 passes
constexpr float kLog2e = 1.4426950408889634f;

// Keys of a dq-pass tile (bf16): 32 at DP 128 keeps the scores beside the
// dQ sums in registers and three stages of K / V in shared memory.
__host__ __device__ constexpr int dq_bk(int dp) { return dp > 64 ? 32 : 64; }

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

__device__ __forceinline__ bool key_ok(int kp, int qp, int causal,
                                       int window) {
  return kp != kInvalidPos && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// The live-tile walk over one row's positions, 32 tiles of bt rows at a
// time.  keys: tiles of key positions against a block's query span [lo,
// hi]; else tiles of query positions against the valid keys' span [lo,
// hi].  A live tile is whole when every pair of it and the block is
// attended: all_in (every row of the block in range and, for a key block,
// valid), the tile within n, and whole() for each of its positions (read
// only when all_in is set, which the f32 passes never do).  Every thread
// of the block calls next() with the same argument (it holds
// __syncthreads).
struct TileWalk {
  const int* pos;
  int n, bt, n_tiles, lo, hi, causal, window, keys, all_in;
  unsigned* red;  // two words of shared memory
  int sc = -1;
  unsigned bits = 0u, whole_bits = 0u;

  __device__ bool live(int p) const {
    if (keys)
      return p != kInvalidPos && (!causal || p <= hi) &&
             (window <= 0 || p > lo - window);
    return (!causal || p >= lo) && (window <= 0 || p < hi + window);
  }

  __device__ bool whole(int p) const {
    if (keys)
      return p != kInvalidPos && (!causal || p <= lo) &&
             (window <= 0 || p > hi - window);
    return (!causal || p >= hi) && (window <= 0 || p < lo + window);
  }

  __device__ void scan(int s) {
    const int tid = threadIdx.x;
    if (tid == 0) red[0] = red[1] = 0u;
    __syncthreads();
    const int i0 = s * 32 * bt;
    const int i1 = min(n, i0 + 32 * bt);
    unsigned b = 0u, nw = 0u;
    for (int i = i0 + tid; i < i1; i += blockDim.x) {
      const int p = pos[i];
      const unsigned bit = 1u << ((i - i0) / bt);
      if (live(p)) b |= bit;
      if (all_in && !whole(p)) nw |= bit;
    }
    b = __reduce_or_sync(0xffffffffu, b);
    if ((tid & 31) == 0 && b) atomicOr(red, b);
    if (all_in) {  // uniform over the block; never set in the f32 passes
      nw = __reduce_or_sync(0xffffffffu, nw);
      if ((tid & 31) == 0 && nw) atomicOr(red + 1, nw);
    }
    __syncthreads();
    bits = red[0];
    whole_bits = ~red[1];
    __syncthreads();
  }

  // the first live tile at or after t, or n_tiles
  __device__ int next(int t) {
    while (t < n_tiles) {
      const int s = t >> 5;
      if (s != sc) {
        scan(s);
        sc = s;
      }
      const unsigned m = bits >> (t & 31);
      if (m) return t + __ffs(m) - 1;
      t = (s + 1) << 5;
    }
    return n_tiles;
  }

  // whether tile t, just returned by next(), is whole
  __device__ bool is_whole(int t) const {
    return all_in && t < n_tiles && (t + 1) * bt <= n &&
           ((whole_bits >> (t & 31)) & 1u);
  }
};

// Rows [r0, r0 + kBT) of a (B, L, NH, D) tensor at (b, head) into
// dst[r * DS + d] as f32 (times mul), zero past L and for d >= D.
template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int b, int head, int r0, int L, int NH,
                                      int D, float mul) {
  constexpr int DS = DP + 1;
  for (int i = threadIdx.x; i < kBT * DP; i += blockDim.x) {
    const int r = i / DP;
    const int d = i - r * DP;
    float x = 0.f;
    if (r0 + r < L && d < D)
      x = to_f32(src[(((size_t)b * L + r0 + r) * NH + head) * D + d]) * mul;
    dst[r * DS + d] = x;
  }
}

// delta[b, h, i] = sum_d do[b, i, h, d] * o[b, i, h, d]: one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                 float* __restrict__ delta, int rows, int Lq, int H, int D) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const size_t base = (size_t)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32)
    s += to_f32(o[base + d]) * to_f32(dO[base + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const int b = row / (Lq * H);
    const int rem = row - b * Lq * H;
    const int i = rem / H;
    const int h = rem - i * H;
    delta[((size_t)b * H + h) * Lq + i] = s;
  }
}

// p and ds of one (query, key) pair from the score s (already scaled), the
// do . v product dp, the row's lse and delta.
__device__ __forceinline__ void p_ds(float s, float dp, float lse,
                                     float delta, bool ok, float softcap,
                                     float* p, float* ds) {
  float dcap = 1.f;
  if (softcap > 0.f) {
    const float th = tanhf(s / softcap);
    s = th * softcap;
    dcap = 1.f - th * th;
  }
  const float pv = ok ? expf(s - lse) : 0.f;
  *p = pv;
  *ds = pv * (dp - delta) * dcap;
}

// dk, dv.  grid (ceil(Lk / 32), B * KV), block 128.  Thread (kr, c):
// kr = 2 * warp + lane / 16 owns keys 4 kr .. 4 kr + 3 of the tile, c =
// lane % 16 owns queries c and c + 16 of a query tile (scores) and dims
// c + 16 j (gradients).  Dynamic shared memory (floats): k_s, v_s, q_s
// (scale * q), do_s [32][DP + 1] | p_s, ds_s [32 keys][33] | lse_s, dl_s
// [32] | qp_s, kp_s [32] (int).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const int* __restrict__ q_pos,
                const int* __restrict__ k_pos, const T* __restrict__ dO,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int Lq, int Lk, int H, int KV, int D,
                int causal, int window, float scale, float softcap) {
  constexpr int DS = DP + 1;
  constexpr int DJ = DP / 16;
  extern __shared__ __align__(16) float smem[];
  __shared__ int span[2];
  __shared__ unsigned red[2];
  float* k_s = smem;
  float* v_s = k_s + kBT * DS;
  float* q_s = v_s + kBT * DS;
  float* do_s = q_s + kBT * DS;
  float* p_s = do_s + kBT * DS;
  float* ds_s = p_s + kBT * kPS;
  float* lse_s = ds_s + kBT * kPS;
  float* dl_s = lse_s + kBT;
  int* qp_s = reinterpret_cast<int*>(dl_s + kBT);
  int* kp_s = qp_s + kBT;

  const int b = blockIdx.y / KV;
  const int kvh = blockIdx.y % KV;
  const int G = H / KV;
  const int k0 = blockIdx.x * kBT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int kr = 2 * (tid >> 5) + (lane >> 4);
  const int c = lane & 15;

  stage<T, DP>(k_s, k, b, kvh, k0, Lk, KV, D, 1.f);
  stage<T, DP>(v_s, v, b, kvh, k0, Lk, KV, D, 1.f);
  if (tid == 0) {
    span[0] = INT_MAX;
    span[1] = INT_MIN;
  }
  for (int r = tid; r < kBT; r += kThreads)
    kp_s[r] = k0 + r < Lk ? k_pos[(size_t)b * Lk + k0 + r] : kInvalidPos;
  __syncthreads();
  if (tid < kBT && kp_s[tid] != kInvalidPos) {
    atomicMin(span, kp_s[tid]);
    atomicMax(span + 1, kp_s[tid]);
  }
  __syncthreads();

  float dka[4][DJ], dva[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[i][j] = dva[i][j] = 0.f;
  int kpr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) kpr[i] = kp_s[4 * kr + i];
  const int* qp_row = q_pos + (size_t)b * Lq;

  if (span[0] <= span[1]) {  // the tile holds a valid key
    for (int g = 0; g < G; ++g) {
      const int h = kvh * G + g;
      const float* lse_row = lse + ((size_t)b * H + h) * Lq;
      const float* dl_row = delta + ((size_t)b * H + h) * Lq;
      TileWalk walk{qp_row, Lq, kBT, (Lq + kBT - 1) / kBT, span[0],
                    span[1], causal, window, 0, 0, red};
      for (int t = walk.next(0); t < walk.n_tiles; t = walk.next(t + 1)) {
        const int q0 = t * kBT;
        stage<T, DP>(q_s, q, b, h, q0, Lq, H, D, scale);
        stage<T, DP>(do_s, dO, b, h, q0, Lq, H, D, 1.f);
        for (int r = tid; r < kBT; r += kThreads) {
          const bool in = q0 + r < Lq;
          lse_s[r] = in ? lse_row[q0 + r] : 0.f;
          dl_s[r] = in ? dl_row[q0 + r] : 0.f;
          qp_s[r] = in ? qp_row[q0 + r] : 0;
        }
        __syncthreads();

        float s[4][2], dp[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
        for (int d = 0; d < DP; ++d) {
          const float qa = q_s[c * DS + d], qb = q_s[(c + 16) * DS + d];
          const float oa = do_s[c * DS + d], ob = do_s[(c + 16) * DS + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float kk = k_s[(4 * kr + i) * DS + d];
            const float vv = v_s[(4 * kr + i) * DS + d];
            s[i][0] += qa * kk;
            s[i][1] += qb * kk;
            dp[i][0] += oa * vv;
            dp[i][1] += ob * vv;
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = c + 16 * j;
          const bool in = q0 + r < Lq;
          const int qp = qp_s[r];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float p, ds;
            p_ds(s[i][j], dp[i][j], lse_s[r], dl_s[r],
                 in && key_ok(kpr[i], qp, causal, window), softcap, &p, &ds);
            p_s[(4 * kr + i) * kPS + r] = p;
            ds_s[(4 * kr + i) * kPS + r] = ds;
          }
        }
        __syncwarp();
#pragma unroll 4
        for (int r = 0; r < kBT; ++r) {
          float od[DJ], qd[DJ];
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            od[j] = do_s[r * DS + c + 16 * j];
            qd[j] = q_s[r * DS + c + 16 * j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pv = p_s[(4 * kr + i) * kPS + r];
            const float dsv = ds_s[(4 * kr + i) * kPS + r];
#pragma unroll
            for (int j = 0; j < DJ; ++j) {
              dva[i][j] += pv * od[j];
              dka[i][j] += dsv * qd[j];
            }
          }
        }
        __syncthreads();  // q_s / do_s / p_s are refilled by the next tile
      }
    }
  }
  // q_s held scale * q, so dka is ds^T . q * scale already
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * kr + i;
    if (key >= Lk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = c + 16 * j;
      if (d < D) {
        const size_t gi = (((size_t)b * Lk + key) * KV + kvh) * D + d;
        dk[gi] = from_f32<T>(dka[i][j]);
        dv[gi] = from_f32<T>(dva[i][j]);
      }
    }
  }
}

// dq.  grid (ceil(Lq / 32), B * H), block 128.  Thread (qr, c): qr =
// 2 * warp + lane / 16 owns queries 4 qr .. 4 qr + 3 of the tile, c =
// lane % 16 owns keys c and c + 16 of a key tile (scores) and dims c + 16 j
// (dq).  Dynamic shared memory (floats): q_s (scale * q), do_s, k_s, v_s
// [32][DP + 1] | ds_s [32 queries][33] | kp_s [32] (int).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ q_pos,
              const int* __restrict__ k_pos, const T* __restrict__ dO,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Lq, int Lk, int H, int KV, int D,
              int causal, int window, float scale, float softcap) {
  constexpr int DS = DP + 1;
  constexpr int DJ = DP / 16;
  extern __shared__ __align__(16) float smem[];
  __shared__ int span[2];
  __shared__ unsigned red[2];
  float* q_s = smem;
  float* do_s = q_s + kBT * DS;
  float* k_s = do_s + kBT * DS;
  float* v_s = k_s + kBT * DS;
  float* ds_s = v_s + kBT * DS;
  int* kp_s = reinterpret_cast<int*>(ds_s + kBT * kPS);

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBT;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int qr = 2 * (tid >> 5) + (lane >> 4);
  const int c = lane & 15;

  stage<T, DP>(q_s, q, b, h, q0, Lq, H, D, scale);
  stage<T, DP>(do_s, dO, b, h, q0, Lq, H, D, 1.f);
  const int* qp_row = q_pos + (size_t)b * Lq;
  if (tid == 0) {
    span[0] = INT_MAX;
    span[1] = INT_MIN;
  }
  __syncthreads();
  {
    int mn = INT_MAX, mx = INT_MIN;
    for (int r = tid; r < kBT; r += kThreads)
      if (q0 + r < Lq) {
        mn = min(mn, qp_row[q0 + r]);
        mx = max(mx, qp_row[q0 + r]);
      }
    atomicMin(span, mn);
    atomicMax(span + 1, mx);
  }
  __syncthreads();

  bool in[4];
  int qp[4];
  float L[4], De[4];
  const float* lse_row = lse + ((size_t)b * H + h) * Lq;
  const float* dl_row = delta + ((size_t)b * H + h) * Lq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + 4 * qr + i;
    in[i] = r < Lq;
    qp[i] = in[i] ? qp_row[r] : 0;
    L[i] = in[i] ? lse_row[r] : 0.f;
    De[i] = in[i] ? dl_row[r] : 0.f;
  }
  float dqa[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqa[i][j] = 0.f;

  const int* kp_row = k_pos + (size_t)b * Lk;
  TileWalk walk{kp_row, Lk, kBT, (Lk + kBT - 1) / kBT, span[0],
                span[1], causal, window, 1, 0, red};
  for (int t = walk.next(0); t < walk.n_tiles; t = walk.next(t + 1)) {
    const int k0 = t * kBT;
    stage<T, DP>(k_s, k, b, kvh, k0, Lk, KV, D, 1.f);
    stage<T, DP>(v_s, v, b, kvh, k0, Lk, KV, D, 1.f);
    for (int r = tid; r < kBT; r += kThreads)
      kp_s[r] = k0 + r < Lk ? kp_row[k0 + r] : kInvalidPos;
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      const float ka = k_s[c * DS + d], kb = k_s[(c + 16) * DS + d];
      const float va = v_s[c * DS + d], vb = v_s[(c + 16) * DS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qq = q_s[(4 * qr + i) * DS + d];
        const float oo = do_s[(4 * qr + i) * DS + d];
        s[i][0] += qq * ka;
        s[i][1] += qq * kb;
        dp[i][0] += oo * va;
        dp[i][1] += oo * vb;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = c + 16 * j;
      const int kp = kp_s[key];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p, ds;
        p_ds(s[i][j], dp[i][j], L[i], De[i],
             in[i] && key_ok(kp, qp[i], causal, window), softcap, &p, &ds);
        ds_s[(4 * qr + i) * kPS + key] = ds;
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int key = 0; key < kBT; ++key) {
      float kd[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kd[j] = k_s[key * DS + c + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dsv = ds_s[(4 * qr + i) * kPS + key];
#pragma unroll
        for (int j = 0; j < DJ; ++j) dqa[i][j] += dsv * kd[j];
      }
    }
    __syncthreads();  // k_s / v_s / ds_s are refilled by the next tile
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!in[i]) continue;
    const int r = q0 + 4 * qr + i;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = c + 16 * j;
      if (d < D)
        dq[(((size_t)b * Lq + r) * H + h) * D + d] =
            from_f32<T>(dqa[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

// Rows [r0, r0 + BR) of one head of a (B, L, NH, D) bf16 tensor (row r at
// src + base + r * rstride) into dst[r * DS + d], d < D, by cp.async of
// VEC bytes.  Thread tid copies chunk tid % cpr of rows tid / cpr, + step,
// ... (step = threads / cpr): the pointers advance, with no division per
// chunk.  Rows past L are zero-filled; columns from D on are not written.
template <int VEC>
__device__ __forceinline__ void copy_rows_v(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            size_t base, size_t rstride,
                                            int r0, int BR, int L, int D,
                                            int DS) {
  constexpr int kEpc = VEC / 2;  // elements per copy
  const int cpr = D / kEpc;
  const int nvalid = min(BR, L - r0);
  const int nthr = blockDim.x;
  if (cpr > nthr) {  // a row of more chunks than threads
    for (int i = threadIdx.x; i < BR * cpr; i += nthr) {
      const int r = i / cpr;
      const int c = i - r * cpr;
      const bool ok = r < nvalid;
      cp_async<VEC>(smem_addr(dst + r * DS + c * kEpc),
                    src + base + (size_t)(ok ? r0 + r : 0) * rstride +
                        c * kEpc,
                    ok ? VEC : 0);
    }
    return;
  }
  const int step = nthr / cpr;
  const int c = threadIdx.x % cpr;
  int r = threadIdx.x / cpr;
  if (r >= step) return;
  const __nv_bfloat16* g0 = src + base + c * kEpc;  // read by no zero fill
  const __nv_bfloat16* g = g0 + (size_t)(r0 + r) * rstride;
  const size_t gstep = (size_t)step * rstride;
  uint32_t d = smem_addr(dst + r * DS + c * kEpc);
  const uint32_t dstep = step * DS * 2;
  for (; r < BR; r += step, g += gstep, d += dstep) {
    const bool ok = r < nvalid;
    cp_async<VEC>(d, ok ? g : g0, ok ? VEC : 0);
  }
}

// copy_rows_v at vec bytes (16, 8 or 4), or synchronous element copies
// when vec is 0 (a row whose bytes 4 does not divide).
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* __restrict__ src,
                                          size_t base, size_t rstride,
                                          int r0, int BR, int L, int D,
                                          int DS, int vec) {
  if (vec == 16) {
    copy_rows_v<16>(dst, src, base, rstride, r0, BR, L, D, DS);
  } else if (vec == 8) {
    copy_rows_v<8>(dst, src, base, rstride, r0, BR, L, D, DS);
  } else if (vec == 4) {
    copy_rows_v<4>(dst, src, base, rstride, r0, BR, L, D, DS);
  } else {
    const int nvalid = min(BR, L - r0);
    for (int i = threadIdx.x; i < BR * D; i += blockDim.x) {
      const int r = i / D;
      const int d = i - r * D;
      dst[r * DS + d] = r < nvalid
                            ? src[base + (size_t)(r0 + r) * rstride + d]
                            : __float2bfloat16(0.f);
    }
  }
}

// 4-byte words src[r0 .. r0 + BR) into dst by cp.async, zero from L on.
__device__ __forceinline__ void copy_words(void* dst, const void* src,
                                           int r0, int BR, int L) {
  for (int r = threadIdx.x; r < BR; r += blockDim.x) {
    const bool ok = r0 + r < L;
    cp_async<4>(smem_addr(static_cast<uint32_t*>(dst) + r),
                static_cast<const uint32_t*>(src) + (ok ? r0 + r : 0),
                ok ? 4 : 0);
  }
}

// Zero columns D .. DP - 1 of `rows` rows of DS elements (the head dim's
// pad, which the copies never write and the products read).
__device__ __forceinline__ void zero_pad(__nv_bfloat16* dst, int rows, int D,
                                         int DP, int DS) {
  const int w = DP - D;
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
    const int r = i / w;
    dst[r * DS + D + (i - r * w)] = __float2bfloat16(0.f);
  }
}

// tanh(y) = 1 - 2 / (2^(2 y log2(e)) + 1): one exp2 and one reciprocal
// in place of tanhf's slow path; its error (~1e-7 absolute) is far
// below the bf16 rounding of p and ds.
__device__ __forceinline__ float tanh_bf16(float y) {
  return 1.f - __fdividef(2.f, exp2f(2.f * kLog2e * y) + 1.f);
}

// p and ds of one pair from the unscaled score s, the do . v product dp,
// the row's lse2 = lse * log2(e) and delta: p_ds's arithmetic with exp2,
// the exponent one FMA (sl2 = scale * log2(e)), no division (cs = scale /
// softcap).  A fully masked row's lse2 is -inf: its p is never selected.
__device__ __forceinline__ void p_ds_bf16(float s, float dp, float lse2,
                                          float delta, bool ok, float sl2,
                                          float cs, float softcap, float* p,
                                          float* ds) {
  if (softcap > 0.f) {
    const float th = tanh_bf16(s * cs);
    const float pv = ok ? exp2f(fmaf(th * softcap, kLog2e, -lse2)) : 0.f;
    *p = pv;
    *ds = pv * (dp - delta) * (1.f - th * th);
  } else {
    const float pv = ok ? exp2f(fmaf(s, sl2, -lse2)) : 0.f;
    *p = pv;
    *ds = pv * (dp - delta);
  }
}

// One query tile of the dk/dv pass for this warp's 16 keys (rows warp * 16
// .. + 15 of k_s / v_s): S^T and dP^T on the tensor cores, p^T and dS^T in
// their registers, then dV += P^T dO and dK += dS^T Q.  qb / ob: the tile's
// Q and dO [kBQ16][DS]; lse_b / dl_b / qp_b its rows' lse, delta and
// positions; nq its rows in range; kp0 / kp1 the positions of this
// thread's two keys.  WHOLE: every pair is attended (no mask test).
template <int DP, bool WHOLE>
__device__ __forceinline__ void dkdv_tile(
    const __nv_bfloat16* k_s, const __nv_bfloat16* v_s,
    const __nv_bfloat16* qb, const __nv_bfloat16* ob, const float* lse_b,
    const float* dl_b, const int* qp_b, int nq, int kp0, int kp1,
    int causal, int window, float scale, float softcap,
    float (&dka)[DP / 8][4], float (&dva)[DP / 8][4]) {
  constexpr int DS = DP + 8;
  constexpr int NT = kBQ16 / 8;  // n8 tiles of S^T (queries)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t4 = lane & 3;
  const int mi = lane >> 3;  // the ldmatrix matrix this lane addresses
  const int r8 = lane & 7;
  const float sl2 = scale * kLog2e;
  const float cs = softcap > 0.f ? scale / softcap : 0.f;

  float s[NT][4], dp[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  // S^T = K Q^T, dP^T = V dO^T
  const int arow = (warp * 16 + (mi & 1) * 8 + r8) * DS + (mi >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t ka[4], va[4];
    ldsm_x4(ka, k_s + arow + kk * 16);
    ldsm_x4(va, v_s + arow + kk * 16);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      const int brow = ((j + (mi >> 1)) * 8 + r8) * DS + kk * 16 + (mi & 1) * 8;
      uint32_t qf[4], of[4];
      ldsm_x4(qf, qb + brow);
      ldsm_x4(of, ob + brow);
      mma_bf16(s[j], ka[0], ka[1], ka[2], ka[3], qf[0], qf[1]);
      mma_bf16(s[j + 1], ka[0], ka[1], ka[2], ka[3], qf[2], qf[3]);
      mma_bf16(dp[j], va[0], va[1], va[2], va[3], of[0], of[1]);
      mma_bf16(dp[j + 1], va[0], va[1], va[2], va[3], of[2], of[3]);
    }
  }
  // p^T into s, dS^T into dp: element e of tile j is key row g (+8 for
  // e >= 2), query column j * 8 + 2 t4 + (e & 1)
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = j * 8 + 2 * t4;
    const float2 ls = *reinterpret_cast<const float2*>(lse_b + c);
    const float2 dl = *reinterpret_cast<const float2*>(dl_b + c);
    const float l2[2] = {ls.x * kLog2e, ls.y * kLog2e};
    int2 qp = make_int2(0, 0);
    if (!WHOLE) qp = *reinterpret_cast<const int2*>(qp_b + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int odd = e & 1;
      bool ok = true;
      if (!WHOLE)
        ok = c + odd < nq &&
             key_ok(e < 2 ? kp0 : kp1, odd ? qp.y : qp.x, causal, window);
      p_ds_bf16(s[j][e], dp[j][e], l2[odd], odd ? dl.y : dl.x, ok, sl2, cs,
                softcap, &s[j][e], &dp[j][e]);
    }
  }
  // dV += P^T dO, dK += dS^T Q: P^T, dS^T rounded to bf16 A fragments
  // (k16 step kk: query columns 16 kk .. + 15 = tiles 2 kk, 2 kk + 1)
#pragma unroll
  for (int kk = 0; kk < kBQ16 / 16; ++kk) {
    const uint32_t pa0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    const uint32_t pa1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    const uint32_t pa2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    const uint32_t pa3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    const uint32_t da0 = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
    const uint32_t da1 = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
    const uint32_t da2 = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
    const uint32_t da3 = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    const int trow = (kk * 16 + (mi & 1) * 8 + r8) * DS + (mi >> 1) * 8;
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
      uint32_t of[4], qf[4];
      ldsm_x4_trans(of, ob + trow + n * 16);
      ldsm_x4_trans(qf, qb + trow + n * 16);
      mma_bf16(dva[2 * n], pa0, pa1, pa2, pa3, of[0], of[1]);
      mma_bf16(dva[2 * n + 1], pa0, pa1, pa2, pa3, of[2], of[3]);
      mma_bf16(dka[2 * n], da0, da1, da2, da3, qf[0], qf[1]);
      mma_bf16(dka[2 * n + 1], da0, da1, da2, da3, qf[2], qf[3]);
    }
  }
}

// dk, dv.  grid (ceil(Lk / BK), B * KV), block 32 * warps, BK = 16 *
// warps keys: warp w owns keys 16 w .. 16 w + 15 as the M rows of every
// product.  It walks items (query tile t, head g of the group): t over
// the live query tiles of kBQ16 rows, g over the G heads.  Dynamic shared
// memory: k_s, v_s [BK][DS] | q_s, do_s [kStages][kBQ16][DS] (bf16) |
// lse_s, dl_s [kStages][kBQ16] (f32) | qp_s [kStages][kBQ16], kp_s [BK]
// (int).
template <int DP>
__global__ void __launch_bounds__(128)
bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const int* __restrict__ q_pos,
                     const int* __restrict__ k_pos,
                     const __nv_bfloat16* __restrict__ dO,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Lq, int Lk, int H,
                     int KV, int D, int causal, int window, float scale,
                     float softcap, int vec) {
  constexpr int DS = DP + 8;
  constexpr int BQ = kBQ16;
  constexpr int DT = DP / 8;  // n8 tiles of dK / dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int span[2];
  __shared__ int all_valid;
  __shared__ unsigned red[2];
  const int BK = 16 * (blockDim.x >> 5);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + BK * DS;
  __nv_bfloat16* q_s = v_s + BK * DS;
  __nv_bfloat16* do_s = q_s + kStages * BQ * DS;
  float* lse_s = reinterpret_cast<float*>(do_s + kStages * BQ * DS);
  float* dl_s = lse_s + kStages * BQ;
  int* qp_s = reinterpret_cast<int*>(dl_s + kStages * BQ);
  int* kp_s = qp_s + kStages * BQ;

  const int b = blockIdx.y / KV;
  const int kvh = blockIdx.y % KV;
  const int G = H / KV;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  if (tid == 0) {
    span[0] = INT_MAX;
    span[1] = INT_MIN;
    all_valid = 1;
  }
  __syncthreads();
  for (int r = tid; r < BK; r += blockDim.x) {
    const int kp = k0 + r < Lk ? k_pos[(size_t)b * Lk + k0 + r] : kInvalidPos;
    kp_s[r] = kp;
    if (kp != kInvalidPos) {
      atomicMin(span, kp);
      atomicMax(span + 1, kp);
    } else {
      all_valid = 0;
    }
  }
  __syncthreads();

  float dka[DT][4], dva[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const int kp0 = kp_s[warp * 16 + g];
  const int kp1 = kp_s[warp * 16 + g + 8];

  if (span[0] <= span[1]) {  // the tile holds a valid key
    // the pad columns of every tile stay zero; stage K / V
    zero_pad(k_s, 2 * BK + 2 * kStages * BQ, D, DP, DS);
    const size_t kv_base = (size_t)b * Lk * KV * D + (size_t)kvh * D;
    copy_rows(k_s, k, kv_base, (size_t)KV * D, k0, BK, Lk, D, DS, vec);
    copy_rows(v_s, v, kv_base, (size_t)KV * D, k0, BK, Lk, D, DS, vec);
    cp_async_commit();
    const int* qp_row = q_pos + (size_t)b * Lq;
    const size_t qstride = (size_t)H * D;
    TileWalk walk{qp_row,  Lq,     BQ,     (Lq + BQ - 1) / BQ,
                  span[0], span[1], causal, window, 0, all_valid, red};
    const int nt = walk.n_tiles;
    struct Item {
      int t, gh;
      bool whole;
    };
    // the item after it: the next head, or the next live tile's first
    auto advance = [&](Item it) {
      if (++it.gh == G) {
        it.gh = 0;
        it.t = walk.next(it.t + 1);
        it.whole = walk.is_whole(it.t);
      }
      return it;
    };
    auto load = [&](int st, const Item& it) {
      if (it.t >= nt) return;
      const int h = kvh * G + it.gh;
      const int q0 = it.t * BQ;
      const size_t base = (size_t)b * Lq * qstride + (size_t)h * D;
      copy_rows(q_s + st * BQ * DS, q, base, qstride, q0, BQ, Lq, D, DS,
                vec);
      copy_rows(do_s + st * BQ * DS, dO, base, qstride, q0, BQ, Lq, D, DS,
                vec);
      const size_t row = ((size_t)b * H + h) * Lq;
      copy_words(lse_s + st * BQ, lse + row, q0, BQ, Lq);
      copy_words(dl_s + st * BQ, delta + row, q0, BQ, Lq);
      copy_words(qp_s + st * BQ, qp_row, q0, BQ, Lq);
    };
    // a ring of kStages (3) buffers: item i is in stage i % 3, and its
    // copy is issued two items ahead
    Item cur{walk.next(0), 0, false};
    cur.whole = walk.is_whole(cur.t);
    Item nxt = advance(cur);
    load(0, cur);
    cp_async_commit();
    load(1, nxt);
    cp_async_commit();
    int st = 0;
    while (cur.t < nt) {
      cp_async_wait<1>();  // cur (and K / V) has landed ...
      __syncthreads();     // ... for every thread; the last stage is free
      const Item after = advance(nxt);
      load(st == 0 ? 2 : st - 1, after);
      cp_async_commit();
      const int off = st * BQ;
      if (cur.whole)
        dkdv_tile<DP, true>(k_s, v_s, q_s + off * DS, do_s + off * DS,
                            lse_s + off, dl_s + off, qp_s + off, BQ, kp0,
                            kp1, causal, window, scale, softcap, dka, dva);
      else
        dkdv_tile<DP, false>(k_s, v_s, q_s + off * DS, do_s + off * DS,
                             lse_s + off, dl_s + off, qp_s + off,
                             Lq - cur.t * BQ, kp0, kp1, causal, window,
                             scale, softcap, dka, dva);
      cur = nxt;
      nxt = after;
      st = st == kStages - 1 ? 0 : st + 1;
    }
    cp_async_wait<0>();
  }
  // q_s held q unscaled: dk = scale * dS^T Q
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + warp * 16 + g + (e < 2 ? 0 : 8);
      const int d = n * 8 + 2 * t4 + (e & 1);
      if (key < Lk && d < D) {
        const size_t gi = (((size_t)b * Lk + key) * KV + kvh) * D + d;
        dk[gi] = __float2bfloat16(dka[n][e] * scale);
        dv[gi] = __float2bfloat16(dva[n][e]);
      }
    }
  }
}

// One key tile of the dq pass for this warp's 16 queries (rows warp * 16
// .. + 15 of q_s / o_s): S and dP on the tensor cores, dS in their
// registers, then dQ += dS K.  kb / vb: the tile's K and V [dq_bk(DP)][DS];
// kpb its positions; nk its keys in range.  This thread's query rows g and
// g + 8: in range in0 / in1, positions qp0 / qp1, lse * log2(e), delta.
// WHOLE: every pair is attended (no mask test).
template <int DP, bool WHOLE>
__device__ __forceinline__ void dq_tile(
    const __nv_bfloat16* q_s, const __nv_bfloat16* o_s,
    const __nv_bfloat16* kb, const __nv_bfloat16* vb, const int* kpb, int nk,
    bool in0, bool in1, int qp0, int qp1, float lse0, float lse1, float de0,
    float de1, int causal, int window, float scale, float softcap,
    float (&dqa)[DP / 8][4]) {
  constexpr int DS = DP + 8;
  constexpr int BK = dq_bk(DP);
  constexpr int NT = BK / 8;  // n8 tiles of S (keys)
  const float sl2 = scale * kLog2e;
  const float cs = softcap > 0.f ? scale / softcap : 0.f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t4 = lane & 3;
  const int mi = lane >> 3;
  const int r8 = lane & 7;

  float s[NT][4], dp[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  // S = Q K^T, dP = dO V^T
  const int arow = (warp * 16 + (mi & 1) * 8 + r8) * DS + (mi >> 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t qa[4], oa[4];
    ldsm_x4(qa, q_s + arow + kk * 16);
    ldsm_x4(oa, o_s + arow + kk * 16);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      const int brow = ((j + (mi >> 1)) * 8 + r8) * DS + kk * 16 + (mi & 1) * 8;
      uint32_t kf[4], vf[4];
      ldsm_x4(kf, kb + brow);
      ldsm_x4(vf, vb + brow);
      mma_bf16(s[j], qa[0], qa[1], qa[2], qa[3], kf[0], kf[1]);
      mma_bf16(s[j + 1], qa[0], qa[1], qa[2], qa[3], kf[2], kf[3]);
      mma_bf16(dp[j], oa[0], oa[1], oa[2], oa[3], vf[0], vf[1]);
      mma_bf16(dp[j + 1], oa[0], oa[1], oa[2], oa[3], vf[2], vf[3]);
    }
  }
  // dS into dp: element e of tile j is query row g (+8 for e >= 2), key
  // column j * 8 + 2 t4 + (e & 1)
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = j * 8 + 2 * t4;
    int2 kp = make_int2(0, 0);
    if (!WHOLE) kp = *reinterpret_cast<const int2*>(kpb + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int odd = e & 1;
      const bool lo = e < 2;
      bool ok = true;
      if (!WHOLE)
        ok = c + odd < nk && (lo ? in0 : in1) &&
             key_ok(odd ? kp.y : kp.x, lo ? qp0 : qp1, causal, window);
      float p;
      p_ds_bf16(s[j][e], dp[j][e], lo ? lse0 : lse1, lo ? de0 : de1, ok,
                sl2, cs, softcap, &p, &dp[j][e]);
    }
  }
  // dQ += dS K: dS rounded to bf16 A fragments, K by ldmatrix.trans
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a0 = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
    const uint32_t a1 = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
    const uint32_t a2 = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    const int trow = (kk * 16 + (mi & 1) * 8 + r8) * DS + (mi >> 1) * 8;
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
      uint32_t kf[4];
      ldsm_x4_trans(kf, kb + trow + n * 16);
      mma_bf16(dqa[2 * n], a0, a1, a2, a3, kf[0], kf[1]);
      mma_bf16(dqa[2 * n + 1], a0, a1, a2, a3, kf[2], kf[3]);
    }
  }
}

// dq.  grid (ceil(Lq / BQ), B * H), block 32 * warps, BQ = 16 * warps
// queries: warp w owns queries 16 w .. 16 w + 15.  Key tiles of BK =
// dq_bk(DP) rows.  Dynamic shared memory: q_s, do_s [BQ][DS] | k_s, v_s
// [kStages][BK][DS] (bf16) | kp_s [kStages][BK] (int).
template <int DP>
__global__ void __launch_bounds__(128)
bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const int* __restrict__ q_pos,
                   const int* __restrict__ k_pos,
                   const __nv_bfloat16* __restrict__ dO,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int Lq, int Lk, int H,
                   int KV, int D, int causal, int window, float scale,
                   float softcap, int vec) {
  constexpr int DS = DP + 8;
  constexpr int BK = dq_bk(DP);
  constexpr int DT = DP / 8;  // n8 tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int span[2];
  __shared__ unsigned red[2];
  const int BQ = 16 * (blockDim.x >> 5);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* do_s = q_s + BQ * DS;
  __nv_bfloat16* k_s = do_s + BQ * DS;
  __nv_bfloat16* v_s = k_s + kStages * BK * DS;
  int* kp_s = reinterpret_cast<int*>(v_s + kStages * BK * DS);

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  // the last query tiles first: under a causal mask they walk the most
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;

  if (tid == 0) {
    span[0] = INT_MAX;
    span[1] = INT_MIN;
  }
  __syncthreads();
  const int* qp_row = q_pos + (size_t)b * Lq;
  {
    int mn = INT_MAX, mx = INT_MIN;
    for (int r = tid; r < BQ; r += blockDim.x)
      if (q0 + r < Lq) {
        mn = min(mn, qp_row[q0 + r]);
        mx = max(mx, qp_row[q0 + r]);
      }
    atomicMin(span, mn);
    atomicMax(span + 1, mx);
  }
  __syncthreads();

  const float* lse_row = lse + ((size_t)b * H + h) * Lq;
  const float* dl_row = delta + ((size_t)b * H + h) * Lq;
  const int r0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int r1 = r0 + 8;
  const bool in0 = r0 < Lq, in1 = r1 < Lq;
  const int qp0 = in0 ? qp_row[r0] : 0, qp1 = in1 ? qp_row[r1] : 0;
  // lse * log2(e): -inf for a fully masked row, whose p is never selected
  const float lse0 = in0 ? lse_row[r0] * kLog2e : 0.f;
  const float lse1 = in1 ? lse_row[r1] * kLog2e : 0.f;
  const float de0 = in0 ? dl_row[r0] : 0.f, de1 = in1 ? dl_row[r1] : 0.f;
  float dqa[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;

  const int* kp_row = k_pos + (size_t)b * Lk;
  TileWalk walk{kp_row, Lk, BK, (Lk + BK - 1) / BK, span[0],
                span[1], causal, window, 1, q0 + BQ <= Lq, red};
  const int nt = walk.n_tiles;
  int t = walk.next(0);
  if (t < nt) {  // else dq is zero
    // the pad columns of every tile stay zero; stage Q / dO
    zero_pad(q_s, 2 * BQ + 2 * kStages * BK, D, DP, DS);
    const size_t qstride = (size_t)H * D;
    const size_t q_base = (size_t)b * Lq * qstride + (size_t)h * D;
    copy_rows(q_s, q, q_base, qstride, q0, BQ, Lq, D, DS, vec);
    copy_rows(do_s, dO, q_base, qstride, q0, BQ, Lq, D, DS, vec);
    const size_t kv_base = (size_t)b * Lk * KV * D + (size_t)kvh * D;
    const size_t kstride = (size_t)KV * D;
    auto load = [&](int st, int tt) {
      if (tt >= nt) return;
      copy_rows(k_s + st * BK * DS, k, kv_base, kstride, tt * BK, BK, Lk, D,
                DS, vec);
      copy_rows(v_s + st * BK * DS, v, kv_base, kstride, tt * BK, BK, Lk, D,
                DS, vec);
      copy_words(kp_s + st * BK, kp_row, tt * BK, BK, Lk);
    };
    // a ring of kStages (3) buffers: tile i of the walk is in stage i % 3,
    // and its copy is issued two tiles ahead
    bool whole = walk.is_whole(t);
    int tn = walk.next(t + 1);
    bool whole_n = walk.is_whole(tn);
    load(0, t);
    cp_async_commit();  // with Q and dO
    load(1, tn);
    cp_async_commit();
    int st = 0;
    while (t < nt) {
      cp_async_wait<1>();  // tile t has landed ...
      __syncthreads();     // ... for every thread; the last stage is free
      const int ta = walk.next(tn + 1);
      const bool whole_a = walk.is_whole(ta);
      load(st == 0 ? 2 : st - 1, ta);
      cp_async_commit();
      const int off = st * BK;
      if (whole)
        dq_tile<DP, true>(q_s, do_s, k_s + off * DS, v_s + off * DS,
                          kp_s + off, BK, in0, in1, qp0, qp1, lse0, lse1,
                          de0, de1, causal, window, scale, softcap, dqa);
      else
        dq_tile<DP, false>(q_s, do_s, k_s + off * DS, v_s + off * DS,
                           kp_s + off, Lk - t * BK, in0, in1, qp0, qp1,
                           lse0, lse1, de0, de1, causal, window, scale,
                           softcap, dqa);
      t = tn;
      whole = whole_n;
      tn = ta;
      whole_n = whole_a;
      st = st == kStages - 1 ? 0 : st + 1;
    }
    cp_async_wait<0>();
  }
#pragma unroll
  for (int n = 0; n < DT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1;
      const int d = n * 8 + 2 * t4 + (e & 1);
      if (r < Lq && d < D)
        dq[(((size_t)b * Lq + r) * H + h) * D + d] =
            __float2bfloat16(dqa[n][e] * scale);
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

// Warps per bf16 block (16 rows each) over L rows of each of n heads: the
// most of 4, 2, 1 that still gives two blocks an SM, else 1.
int bf16_warps(int L, int n) {
  for (int w = 4; w > 1; w >>= 1)
    if ((long long)((L + 16 * w - 1) / (16 * w)) * n >= 2 * kSms) return w;
  return 1;
}

// Bytes per cp.async for bf16 rows of D elements: the widest of 16, 8, 4
// that divides a row and the alignment of every tensor; 0 for element
// copies.
int copy_bytes(const void* q, const void* k, const void* v, const void* dO,
               int D) {
  const size_t row = (size_t)D * 2;
  const uintptr_t al =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dO);
  for (int c = 16; c >= 4; c >>= 1)
    if (row % c == 0 && al % c == 0) return c;
  return 0;
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int* qp, const int* kp, const float* lse,
                        const void* dO, const float* delta, void* dq,
                        void* dk, void* dv, int B, int Lq, int Lk, int H,
                        int KV, int D, int causal, int window, float scale,
                        float softcap, cudaStream_t st) {
  static size_t conf_dkdv = 48 * 1024, conf_dq = 48 * 1024;
  constexpr int DS = DP + 8;
  constexpr int BQ = kBQ16;
  constexpr int BK = dq_bk(DP);
  using bf16 = __nv_bfloat16;
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dO);
  const int vec = copy_bytes(q, k, v, dO, D);
  cudaError_t err = cudaSuccess;
  if (Lk > 0) {
    const int warps = bf16_warps(Lk, B * KV);
    const int BKd = 16 * warps;
    const size_t smem = (size_t)(2 * BKd + 2 * kStages * BQ) * DS * 2 +
                        (size_t)(3 * kStages * BQ + BKd) * 4;
    auto kernel = bwd_dkdv_bf16_kernel<DP>;
    err = set_smem(kernel, smem, &conf_dkdv);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((Lk + BKd - 1) / BKd, B * KV), 32 * warps, smem, st>>>(
        tq, tk, tv, qp, kp, tdo, lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), Lq, Lk, H, KV, D, causal, window, scale,
        softcap, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Lq > 0) {
    const int warps = bf16_warps(Lq, B * H);
    const int BQd = 16 * warps;
    const size_t smem = (size_t)(2 * BQd + 2 * kStages * BK) * DS * 2 +
                        (size_t)kStages * BK * 4;
    auto kernel = bwd_dq_bf16_kernel<DP>;
    err = set_smem(kernel, smem, &conf_dq);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((Lq + BQd - 1) / BQd, B * H), 32 * warps, smem, st>>>(
        tq, tk, tv, qp, kp, tdo, lse, delta, static_cast<bf16*>(dq), Lq, Lk,
        H, KV, D, causal, window, scale, softcap, vec);
    err = cudaGetLastError();
  }
  return err;
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int* qp, const int* kp, const float* lse,
                       const void* dO, const float* delta, void* dq,
                       void* dk, void* dv, int B, int Lq, int Lk, int H,
                       int KV, int D, int causal, int window, float scale,
                       float softcap, cudaStream_t st) {
  static size_t conf_dkdv = 48 * 1024, conf_dq = 48 * 1024;
  constexpr int DS = DP + 1;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dO);
  cudaError_t err = cudaSuccess;
  if (Lk > 0) {
    const size_t smem =
        (size_t)(4 * kBT * DS + 2 * kBT * kPS + 2 * kBT) * 4 + 2 * kBT * 4;
    auto kernel = bwd_dkdv_kernel<float, DP>;
    err = set_smem(kernel, smem, &conf_dkdv);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((Lk + kBT - 1) / kBT, B * KV), kThreads, smem, st>>>(
        tq, tk, tv, qp, kp, tdo, lse, delta, static_cast<float*>(dk),
        static_cast<float*>(dv), Lq, Lk, H, KV, D, causal, window, scale,
        softcap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Lq > 0) {
    const size_t smem = (size_t)(4 * kBT * DS + kBT * kPS) * 4 + kBT * 4;
    auto kernel = bwd_dq_kernel<float, DP>;
    err = set_smem(kernel, smem, &conf_dq);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((Lq + kBT - 1) / kBT, B * H), kThreads, smem, st>>>(
        tq, tk, tv, qp, kp, tdo, lse, delta, static_cast<float*>(dq), Lq,
        Lk, H, KV, D, causal, window, scale, softcap);
    err = cudaGetLastError();
  }
  return err;
}

// The delta launch, then dk/dv and dq in T's design.
template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* qp, const void* kp, const void* o,
                   const void* lse, const void* dO, void* delta, void* dq,
                   void* dk, void* dv, int B, int Lq, int Lk, int H, int KV,
                   int D, int causal, int window, float scale, float softcap,
                   cudaStream_t st) {
  float* fdl = static_cast<float*>(delta);
  if (Lq > 0) {
    const int rows = B * Lq * H;
    bwd_delta_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32),
                          kThreads, 0, st>>>(static_cast<const T*>(o),
                                             static_cast<const T*>(dO), fdl,
                                             rows, Lq, H, D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return (sizeof(T) == 4 ? launch_f32<DP> : launch_bf16<DP>)(
      q, k, v, static_cast<const int*>(qp), static_cast<const int*>(kp),
      static_cast<const float*>(lse), dO, fdl, dq, dk, dv, B, Lq, Lk, H, KV,
      D, causal, window, scale, softcap, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  delta: f32 scratch of B * H * Lq.
// Returns the first failed launch's cudaError_t (three launches: delta,
// dk/dv, dq).  The caller validates shapes (D <= 128, H % KV == 0).
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* k_pos, const void* o,
                        const void* lse, const void* dO, void* delta,
                        void* dq, void* dk, void* dv, int B, int Lq, int Lk,
                        int H, int KV, int D, int causal, int window,
                        float scale, float softcap, int dtype, void* stream) {
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_BWD_CASE(DPV)                                            \
  if (D <= DPV)                                                              \
    return (int)(dtype == 0                                                  \
                     ? launch<float, DPV>(q, k, v, q_pos, k_pos, o, lse, dO, \
                                          delta, dq, dk, dv, B, Lq, Lk, H,   \
                                          KV, D, causal, window, scale,      \
                                          softcap, st)                       \
                     : launch<__nv_bfloat16, DPV>(                           \
                           q, k, v, q_pos, k_pos, o, lse, dO, delta, dq, dk, \
                           dv, B, Lq, Lk, H, KV, D, causal, window, scale,   \
                           softcap, st));
  REPRO_FLASH_BWD_CASE(16)
  REPRO_FLASH_BWD_CASE(32)
  REPRO_FLASH_BWD_CASE(48)
  REPRO_FLASH_BWD_CASE(64)
  REPRO_FLASH_BWD_CASE(128)
#undef REPRO_FLASH_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
