// K1: one-query decode attention over a constant-size KV buffer, for
// NVIDIA Hopper (sm_90a).  Built by repro_torch/kernels/_build.py with
// nvcc into a shared library with a plain C interface (loaded by ctypes).
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_pallas
// (body _decode_kernel) -- the TPU kernel of the O(1) cache-hit step
// (paper Eq. 5).  Instead of valid_len / window it takes a per-row slot
// range [lo, hi), so one kernel serves both attentions of the step: the
// generation-window self-attention ([0, gen_len + 1)) and the
// compressed-context cross-attention ([W_oh - n_valid, W_oh), the valid
// context slots being a suffix).  Slots outside the range take no part in
// the softmax; an empty range gives zeros (masked-safe softmax, +1e-30).
//
// Layouts: q (B, H, D); k, v (B, S, KV, D), all contiguous; lo, hi (B,)
// int32; out (B, H, D) in q's type.  f32 and bf16 inputs, f32 arithmetic.
//
// int8 variant (decode_attention_int8_fwd): k, v are int8 with (B, S, KV, 1)
// float32 per-vector scales, dequantised inside the QK and PV loops
// (k * scale, element by element, as the Pallas kernel does), so the
// kernel reads one byte per element; the output is computed in f32 and
// written in q's type.  It serves the int8 cache layouts.
//
// Design: one block per (KV head, row) computes the G = H / KV query heads
// of the group.  Pass 1: each warp takes slots in turn, lanes split the
// head dim (element loads: a bf16 row of head_dim 36 is 72 bytes, so
// 16-byte vector loads would be misaligned), a warp shuffle sums the dot
// product, and the scores go to shared memory.  Pass 2: one warp per
// query head takes the max and the exponentials (two-pass softmax).  The
// scores live in dynamic shared memory: above 48 KB the launch raises the
// kernel's limit with cudaFuncSetAttribute, up to the 227 KB a block can
// have (S up to ~57k slots at G = 1, D = 36); the wrapper raises beyond.
// Pass 3: warps split the slots again, accumulate p * V in registers and
// reduce across warps through shared memory.
//
// What bounds it on an H100: bytes.  Each (row, KV head) reads its S x D
// keys and values once and does 4 * G * S * D flops on them -- a few flops
// per byte, far below the ~295 flop/byte ridge.  At tconst-41m's shapes
// (S = 256, D = 36, 12 heads) a step reads ~0.44 MB of K/V per row, which
// is ~0.13 us at 3.35 TB/s; at such sizes launch latency dominates.  This
// kernel is the simple correct version: making it fast (several rows or
// layers per launch, vector loads over a padded layout) is later work.
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

// T: q / out type; KT: k / v type (T, or int8_t with scales ks / vs of
// shape (B, S, KV, 1); nullptr scales mean 1).  DPL: head-dim elements per
// lane (head_dim <= 32 * DPL).  grid (KV, B), block kThreads.  Shared
// memory (floats):  q_s[G * D] | p_s[G * S] | red_s[kWarps * G * D] | l_s[G]
template <typename T, typename KT, int DPL>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const KT* __restrict__ k,
                        const KT* __restrict__ v,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ lo_p,
                        const int* __restrict__ hi_p, T* __restrict__ out,
                        int S, int H, int KV, int D, float scale,
                        float softcap) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* q_s = smem;
  float* p_s = q_s + G * D;
  float* red_s = p_s + G * S;
  float* l_s = red_s + kWarps * G * D;

  const int lo = max(lo_p[b], 0);
  const int hi = min(hi_p[b], S);
  const int n = max(hi - lo, 0);

  const size_t q_base = ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    q_s[i] = to_f32(q[q_base + i]) * scale;
  __syncthreads();

  const size_t row_stride = (size_t)KV * D;
  // (b, lo, kvh) as a row of the (B * S * KV) vectors
  const size_t row0 = ((size_t)b * S + lo) * KV + kvh;
  const KT* kb = k + row0 * D;
  const KT* vb = v + row0 * D;

  // pass 1: scores of the slots in [lo, hi)
  for (int j = warp; j < n; j += kWarps) {
    const KT* kr = kb + (size_t)j * row_stride;
    const float sk = ks ? ks[row0 + (size_t)j * KV] : 1.f;
    float kd[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      kd[i] = d < D ? to_f32(kr[d]) * sk : 0.f;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc += q_s[g * D + d] * kd[i];
        }
        acc = warp_sum(acc);
        if (softcap > 0.f) acc = tanhf(acc / softcap) * softcap;
        if (lane == 0) p_s[g * S + j] = acc;
      }
    }
  }
  __syncthreads();

  // pass 2: softmax numerators and denominators, one warp per query head
  for (int g = warp; g < G; g += kWarps) {
    float m = kNegInf;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, p_s[g * S + j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(p_s[g * S + j] - m);
      p_s[g * S + j] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) l_s[g] = l;
  }
  __syncthreads();

  // pass 3: p @ V, slots split over warps, reduced through shared memory
  float acc[kMaxG][DPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  for (int j = warp; j < n; j += kWarps) {
    const KT* vr = vb + (size_t)j * row_stride;
    const float sv = vs ? vs[row0 + (size_t)j * KV] : 1.f;
    float vd[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      vd[i] = d < D ? to_f32(vr[d]) * sv : 0.f;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float p = p_s[g * S + j];
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[g][i] += p * vd[i];
      }
    }
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

// Launch one instantiation; above 48 KB of dynamic shared memory the
// kernel's limit is raised first (once per instantiation and size).
template <typename T, typename KT, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const void* lo,
                   const void* hi, void* out, int B, int S, int H, int KV,
                   int D, float scale, float softcap, size_t smem,
                   cudaStream_t stream) {
  static size_t configured = 48 * 1024;
  auto kernel = decode_attention_kernel<T, KT, DPL>;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = smem;
  }
  kernel<<<dim3(KV, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), ks, vs, static_cast<const int*>(lo),
      static_cast<const int*>(hi), static_cast<T*>(out), S, H, KV, D, scale,
      softcap);
  return cudaGetLastError();
}

template <typename T, typename KT>
cudaError_t launch_dpl(const void* q, const void* k, const void* v,
                       const float* ks, const float* vs, const void* lo,
                       const void* hi, void* out, int B, int S, int H, int KV,
                       int D, float scale, float softcap, size_t smem,
                       cudaStream_t st) {
  const int dpl = (D + 31) / 32;
  if (dpl <= 1)
    return launch<T, KT, 1>(q, k, v, ks, vs, lo, hi, out, B, S, H, KV, D,
                            scale, softcap, smem, st);
  if (dpl <= 2)
    return launch<T, KT, 2>(q, k, v, ks, vs, lo, hi, out, B, S, H, KV, D,
                            scale, softcap, smem, st);
  if (dpl <= 4)
    return launch<T, KT, 4>(q, k, v, ks, vs, lo, hi, out, B, S, H, KV, D,
                            scale, softcap, smem, st);
  return launch<T, KT, 8>(q, k, v, ks, vs, lo, hi, out, B, S, H, KV, D,
                          scale, softcap, smem, st);
}

// Shared-memory bytes one launch needs (the Python wrapper computes the
// same number and raises above the 227 KB a block can have).
size_t smem_bytes(int S, int H, int KV, int D) {
  const int G = H / KV;
  return sizeof(float) * (size_t)(G * D + G * S + kWarps * G * D + G);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  Returns the
// launch's cudaError_t.  The caller validates shapes (G <= 8, D <= 256,
// shared memory <= 227 KB).
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* lo, const void* hi, void* out, int B,
                         int S, int H, int KV, int D, float scale,
                         float softcap, int dtype, void* stream) {
  if (B == 0 || KV == 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(S, H, KV, D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_dpl<float, float>(q, k, v, nullptr, nullptr, lo, hi,
                                         out, B, S, H, KV, D, scale, softcap,
                                         smem, st);
  return (int)launch_dpl<__nv_bfloat16, __nv_bfloat16>(
      q, k, v, nullptr, nullptr, lo, hi, out, B, S, H, KV, D, scale, softcap,
      smem, st);
}

// int8 K / V with (B, S, KV, 1) float32 scales; dtype is q's and out's
// (0 = float32, 1 = bfloat16).  Same contract as decode_attention_fwd.
int decode_attention_int8_fwd(const void* q, const void* kq, const void* vq,
                              const void* ks, const void* vs, const void* lo,
                              const void* hi, void* out, int B, int S, int H,
                              int KV, int D, float scale, float softcap,
                              int dtype, void* stream) {
  if (B == 0 || KV == 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(S, H, KV, D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  if (dtype == 0)
    return (int)launch_dpl<float, int8_t>(q, kq, vq, ksf, vsf, lo, hi, out, B,
                                          S, H, KV, D, scale, softcap, smem,
                                          st);
  return (int)launch_dpl<__nv_bfloat16, int8_t>(q, kq, vq, ksf, vsf, lo, hi,
                                                out, B, S, H, KV, D, scale,
                                                softcap, smem, st);
}

}  // extern "C"
