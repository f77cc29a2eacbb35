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
// (B, Lq), k_pos (B, Lk) int32; out (B, Lq, H, D) in q's type.  f32 and
// bf16 inputs, f32 arithmetic.  Lq and Lk are arbitrary (ragged tiles are
// masked), the window is a runtime argument, and the KV head of query head
// h is h / (H / KV) (no repeat of K/V over the group).
//
// Design: one block per (64-query tile, row, head), one thread per query
// row holding its query and accumulator in registers.  The block walks the
// key tiles in order -- the loop replaces the TPU kernel's sequential grid
// dimension and its scratch accumulator -- staging each BK-key tile of K,
// V (as f32, head dim padded to DMAX with zeros) and k_pos in shared
// memory; every thread reads the same key at a time (a broadcast).  The
// tile's scores go through shared memory, so only head-dim loops unroll.
//
// What bounds it on an H100: the least time for the work is set by the
// bytes at tconst-41m's bf16 resync shapes (compress 256 queries x max_len
// keys, restore max_len x 256, D = 36: ~1.3 us at 3.35 TB/s) and by the
// operations for much longer histories (4 * Lq * Lk * D flops per head
// against 2 bytes per element).  This kernel is far from either: it does
// scalar f32 FMAs on the CUDA cores with one thread per query and ~100
// blocks in flight, so it is bound by its own issue rate and occupancy.
// A tensor-core (wgmma / TMA) version is later work; a simple correct
// kernel comes first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kInvalidPos = 1073741823;  // int32 max // 2
constexpr int kBQ = 64;                  // query rows (threads) per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
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

// grid (ceil(Lq / kBQ), B * H), block kBQ.  DMAX >= D; BK <= 32 keys per
// tile.  Each thread keeps its scores for the tile in a shared-memory
// column (s_s[j][thread]: conflict-free), so only the head-dim loops are
// unrolled -- the key loops are not, which keeps the build short.
template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(kBQ)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos, T* __restrict__ out,
                       int Lq, int Lk, int H, int KV, int D, int causal,
                       int window, float scale, float softcap) {
  __shared__ float k_s[BK][DMAX];
  __shared__ float v_s[BK][DMAX];
  __shared__ float s_s[BK][kBQ];
  __shared__ int kp_s[BK];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kBQ + tid;
  const bool active = row < Lq;

  float qr[DMAX];
  float acc[DMAX];
  const size_t q_off = (((size_t)b * Lq + (active ? row : 0)) * H + h) * D;
#pragma unroll
  for (int d = 0; d < DMAX; ++d) {
    qr[d] = (active && d < D) ? to_f32(q[q_off + d]) * scale : 0.f;
    acc[d] = 0.f;
  }
  const int qp = active ? q_pos[(size_t)b * Lq + row] : 0;
  float m = kNegInf;
  float l = 0.f;

  for (int t0 = 0; t0 < Lk; t0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < BK * DMAX; idx += kBQ) {
      const int j = idx / DMAX;
      const int d = idx % DMAX;
      const int kr = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (kr < Lk && d < D) {
        const size_t off = (((size_t)b * Lk + kr) * KV + kvh) * D + d;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      k_s[j][d] = kx;
      v_s[j][d] = vx;
    }
    for (int j = tid; j < BK; j += kBQ) {
      const int kr = t0 + j;
      kp_s[j] = kr < Lk ? k_pos[(size_t)b * Lk + kr] : kInvalidPos;
    }
    __syncthreads();
    if (!active) continue;

    // scores of this tile (masked to NEG_INF) and their max
    unsigned ok_bits = 0u;
    float m_new = m;
#pragma unroll 1
    for (int j = 0; j < BK; ++j) {
      const int kp = kp_s[j];
      bool ok = kp != kInvalidPos;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < DMAX; ++d) x += qr[d] * k_s[j][d];
      if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
      x = ok ? x : kNegInf;
      ok_bits |= (ok ? 1u : 0u) << j;
      s_s[j][tid] = x;
      m_new = fmaxf(m_new, x);
    }
    // online-softmax update: p = exp(s - m_new) on valid keys, else 0
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int d = 0; d < DMAX; ++d) acc[d] *= alpha;
#pragma unroll 1
    for (int j = 0; j < BK; ++j) {
      const float p = ((ok_bits >> j) & 1u) ? expf(s_s[j][tid] - m_new) : 0.f;
      psum += p;
#pragma unroll
      for (int d = 0; d < DMAX; ++d) acc[d] += p * v_s[j][d];
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (active) {
#pragma unroll
    for (int d = 0; d < DMAX; ++d)
      if (d < D) out[q_off + d] = from_f32<T>(acc[d] / (l + 1e-30f));
  }
}

template <typename T, int DMAX, int BK>
void launch(const void* q, const void* k, const void* v, const void* qp,
            const void* kp, void* out, int B, int Lq, int Lk, int H, int KV,
            int D, int causal, int window, float scale, float softcap,
            cudaStream_t stream) {
  const dim3 grid((Lq + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, DMAX, BK><<<grid, kBQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(qp),
      static_cast<const int*>(kp), static_cast<T*>(out), Lq, Lk, H, KV, D,
      causal, window, scale, softcap);
}

template <typename T>
void launch_d(const void* q, const void* k, const void* v, const void* qp,
              const void* kp, void* out, int B, int Lq, int Lk, int H, int KV,
              int D, int causal, int window, float scale, float softcap,
              cudaStream_t st) {
#define REPRO_FLASH_CASE(DM, BKV)                                        \
  if (D <= DM) {                                                         \
    launch<T, DM, BKV>(q, k, v, qp, kp, out, B, Lq, Lk, H, KV, D, causal, \
                       window, scale, softcap, st);                      \
    return;                                                              \
  }
  REPRO_FLASH_CASE(16, 32)
  REPRO_FLASH_CASE(32, 32)
  REPRO_FLASH_CASE(48, 32)
  REPRO_FLASH_CASE(64, 32)
  REPRO_FLASH_CASE(128, 16)
#undef REPRO_FLASH_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
// The caller validates shapes (D <= 128, H % KV == 0).
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* q_pos, const void* k_pos, void* out,
                        int B, int Lq, int Lk, int H, int KV, int D,
                        int causal, int window, float scale, float softcap,
                        int dtype, void* stream) {
  if (B == 0 || Lq == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_d<float>(q, k, v, q_pos, k_pos, out, B, Lq, Lk, H, KV, D, causal,
                    window, scale, softcap, st);
  else
    launch_d<__nv_bfloat16>(q, k, v, q_pos, k_pos, out, B, Lq, Lk, H, KV, D,
                            causal, window, scale, softcap, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
