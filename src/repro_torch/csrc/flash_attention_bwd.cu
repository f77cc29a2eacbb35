// K2 backward: the gradient of the blocked attention forward with per-row
// positions, for NVIDIA Hopper (sm_90a).  Built by
// repro_torch/kernels/_build.py with nvcc into a shared library with a
// plain C interface (loaded by ctypes).
//
// Replaces: src/repro/kernels/xla_flash.py, _bwd (through _flash_bwd_rule),
// which the JAX package reaches behind jax.custom_vjp from the Pallas
// forward (src/repro/kernels/ops.py, _fp_bwd) and from xla_flash's own
// forward.  From q, k, v, the positions, the forward's output o, its row
// log-sum-exp lse and the output gradient do, all in f32 arithmetic:
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
// What bounds it on an H100: at tconst-41m's train shapes (D = 36, Lq and
// Lk 256-1024) the 8 * Lq * Lk * D flops per head of the four products
// (five with the recomputed scores of the second pass) against ~10 MB of
// inputs: the operations, by far.  This first design keeps everything in
// exact f32 on the CUDA cores (no tensor cores, no atomics):
//
// * three launches: delta (one warp per row); dk/dv over (key tile,
//   B * KV), whose block holds its 32-key K/V tile in shared memory and
//   walks the G heads of its KV head and, for each, the live 32-query
//   tiles, summing dk and dv in registers and writing them once (so the
//   sum over the group needs no second pass); dq over (query tile, B * H),
//   which holds its Q/dO tile and walks the live key tiles.  Each pass
//   recomputes p from lse.
// * 128 threads, a 32 x 32 tile: each thread computes the scores and
//   do . v^T of 4 rows against 2 columns, puts p / ds in shared memory for
//   its half-warp, and accumulates 4 rows x DP/16 dims of its gradient.
// * dead tiles are skipped, by the forward's predicate mirrored: the dq
//   pass walks key tiles with some key not INVALID_POS, at or before the
//   block's largest query position (causal), after its smallest minus the
//   window (window); the dk/dv pass walks query tiles with some query at or
//   after the smallest valid key of its tile (causal) and before its
//   largest plus the window (window).  A skipped tile adds p = 0, so the
//   values are exact (tile_live / query_tile_live in
//   kernels/flash_attention.py are the same predicates, tested against
//   position_mask).
// The kernels are named bwd_* (chip_smoke.py's SASS check looks for tensor
// core instructions in the forward's flash_bf16_kernel entries only).
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kInvalidPos = 1073741823;  // int32 max // 2
constexpr int kBT = 32;                  // rows of a query or key tile
constexpr int kThreads = 128;            // threads per tile block
constexpr int kPS = kBT + 1;             // row stride of p_s / ds_s

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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool key_ok(int kp, int qp, int causal,
                                       int window) {
  return kp != kInvalidPos && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// The live-tile walk over one row's positions, 32 tiles at a time.  keys:
// tiles of key positions against a block's query span [lo, hi]; else tiles
// of query positions against the valid keys' span [lo, hi].  Every thread
// of the block calls next() with the same argument (it holds
// __syncthreads).
struct TileWalk {
  const int* pos;
  int n, n_tiles, lo, hi, causal, window, keys;
  unsigned* red;  // one word of shared memory
  int sc = -1;
  unsigned bits = 0u;

  __device__ bool live(int p) const {
    if (keys)
      return p != kInvalidPos && (!causal || p <= hi) &&
             (window <= 0 || p > lo - window);
    return (!causal || p >= lo) && (window <= 0 || p < hi + window);
  }

  __device__ unsigned scan(int s) {
    const int tid = threadIdx.x;
    if (tid == 0) *red = 0u;
    __syncthreads();
    const int i0 = s * 32 * kBT;
    const int i1 = min(n, i0 + 32 * kBT);
    unsigned b = 0u;
    for (int i = i0 + tid; i < i1; i += blockDim.x)
      if (live(pos[i])) b |= 1u << ((i - i0) / kBT);
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
  __shared__ unsigned red;
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
      TileWalk walk{qp_row, Lq, (Lq + kBT - 1) / kBT, span[0], span[1],
                    causal, window, 0, &red};
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
  __shared__ unsigned red;
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
  TileWalk walk{kp_row, Lk, (Lk + kBT - 1) / kBT, span[0], span[1], causal,
                window, 1, &red};
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
// launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t set_smem(K kernel, size_t smem, size_t* configured) {
  if (smem <= *configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) *configured = smem;
  return err;
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* qp, const void* kp, const void* o,
                   const void* lse, const void* dO, void* delta, void* dq,
                   void* dk, void* dv, int B, int Lq, int Lk, int H, int KV,
                   int D, int causal, int window, float scale, float softcap,
                   cudaStream_t st) {
  static size_t conf_dkdv = 48 * 1024, conf_dq = 48 * 1024;
  constexpr int DS = DP + 1;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dO);
  const int* iqp = static_cast<const int*>(qp);
  const int* ikp = static_cast<const int*>(kp);
  const float* flse = static_cast<const float*>(lse);
  float* fdl = static_cast<float*>(delta);
  cudaError_t err = cudaSuccess;
  if (Lq > 0) {
    const int rows = B * Lq * H;
    bwd_delta_kernel<T><<<(rows + kThreads / 32 - 1) / (kThreads / 32),
                          kThreads, 0, st>>>(static_cast<const T*>(o), tdo,
                                             fdl, rows, Lq, H, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Lk > 0) {
    const size_t smem =
        (size_t)(4 * kBT * DS + 2 * kBT * kPS + 2 * kBT) * 4 + 2 * kBT * 4;
    auto kernel = bwd_dkdv_kernel<T, DP>;
    err = set_smem(kernel, smem, &conf_dkdv);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((Lk + kBT - 1) / kBT, B * KV), kThreads, smem, st>>>(
        tq, tk, tv, iqp, ikp, tdo, flse, fdl, static_cast<T*>(dk),
        static_cast<T*>(dv), Lq, Lk, H, KV, D, causal, window, scale,
        softcap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Lq > 0) {
    const size_t smem = (size_t)(4 * kBT * DS + kBT * kPS) * 4 + kBT * 4;
    auto kernel = bwd_dq_kernel<T, DP>;
    err = set_smem(kernel, smem, &conf_dq);
    if (err != cudaSuccess) return err;
    kernel<<<dim3((Lq + kBT - 1) / kBT, B * H), kThreads, smem, st>>>(
        tq, tk, tv, iqp, ikp, tdo, flse, fdl, static_cast<T*>(dq), Lq, Lk,
        H, KV, D, causal, window, scale, softcap);
    err = cudaGetLastError();
  }
  return err;
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
