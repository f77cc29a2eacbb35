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
// context slots being a suffix), and TLinFormer's history on the dense
// layout ([0, hist_len)).  Slots outside the range take no part in the
// softmax; an empty range gives zeros (masked-safe softmax, +1e-30).
//
// Layouts: q (B, H, D); k, v (B, S, KV, D), all contiguous; lo, hi (B,)
// int32; out (B, H, D) in q's type.  f32 and bf16 inputs, f32 arithmetic.
// int8 variant (decode_attention_int8_fwd): k, v are int8 with (B, S, KV, 1)
// float32 per-vector scales, each code times its vector's scale once as it
// is staged; it serves the int8 cache layouts.
//
// What bounds it on an H100: bytes.  A (row, KV head) reads its attended
// keys and values once and does 4 x G x D flops per slot -- a few flops per
// byte, far below the ~295 flop/byte ridge: at tconst-41m's hit step
// (B 2, S 256, 12 KV heads, D 36) the bound is ~0.3 us, a 16000-slot row
// ~8 us.  What held the first version back was parallelism and latency:
// one 4-warp block per (KV head, row) walked the whole row (24 blocks on
// 132 SMs at B 2), loaded 2-byte elements, summed every slot's dot product
// with a 5-level warp shuffle and kept all G x S scores in shared memory.
//
// Design (split-KV, "flash-decoding"; the machinery is split_decode.cuh,
// shared with K3): the grid is (KV, B, n_split).  The host plans n_split
// from S alone (decode_attention.py, split_plan: runs of `split` slots, at
// least 64, at most 64 runs) -- never from lo / hi, which live on the
// device.  Block (kvh, b, s) attends [s * split, (s + 1) * split)
// intersected with the row's [lo, hi), 64 slots a tile (a bf16 row of
// head_dim 36 is 72 bytes: 8-byte loads; an int8 row 4-byte ones); a block
// whose run holds no attended slot writes an empty partial and does
// nothing else.  The partials go in f32 to a workspace the wrapper
// allocates; the last block of a (row, KV head) merges them through an
// atomic ticket in an int32 buffer the wrapper zeroes once per device and
// keeps.  One launch per call.  Shared memory holds one tile, so it does
// not grow with S.
#include "split_decode.cuh"

namespace {

using namespace split_decode;

// T: q / out type; KT: k / v type (T, or int8_t with scales ks / vs of
// shape (B, S, KV, 1); nullptr scales mean 1); LT: the load unit.  grid
// (KV, B, n_split), block kThreads, dynamic shared memory smem_bytes.
// part: (B, KV, n_split, G, D + 2) f32 partials (m, l, acc); tickets:
// (B * KV) int32, 0 between calls.
template <typename T, typename KT, typename LT>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ lo_p,
                    const int* __restrict__ hi_p, T* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ tickets,
                    int S, int H, int KV, int D, int split, int n_split,
                    float scale, float softcap) {
  extern __shared__ float smem[];
  const Block bk(smem, H, KV, D);
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int lo = max(lo_p[b], 0);
  const int hi = min(hi_p[b], S);
  const int r_begin = max(sp * split, lo);  // this run's attended slots
  const int r_end = min((sp + 1) * split, hi);
  const size_t q_base = ((size_t)b * H + (size_t)kvh * bk.G) * D;
  const int pstride = bk.G * (D + 2);  // floats of one partial
  float* row_part = part + (size_t)(b * KV + kvh) * n_split * pstride;

  if (r_begin < r_end) {
    begin_run(bk, q, q_base, scale);
    for (int t0 = r_begin; t0 < r_end; t0 += kTile)
      // (b, t0, kvh) as a row of the (B * S * KV) vectors
      attend_tile<KT, LT>(bk, k, v, ks, vs, ((size_t)b * S + t0) * KV + kvh,
                          KV, min(kTile, r_end - t0), softcap);
  }
  end_run(bk, row_part + (size_t)sp * pstride, r_begin < r_end);
  merge_last(bk, row_part, tickets + b * KV + kvh, out + q_base, n_split);
}

template <typename T, typename KT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const void* lo,
                   const void* hi, void* out, void* part, void* tickets,
                   int B, int S, int H, int KV, int D, int split,
                   int n_split, float scale, float softcap,
                   cudaStream_t stream) {
  return with_load_unit<KT>(k, v, D, [&](auto unit) {
    static size_t configured = 48 * 1024;
    const size_t smem = smem_bytes(H, KV, D);
    auto kernel = decode_split_kernel<T, KT, decltype(unit)>;
    const cudaError_t err = reserve_smem(kernel, smem, configured);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(KV, B, n_split), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const KT*>(k),
        static_cast<const KT*>(v), ks, vs, static_cast<const int*>(lo),
        static_cast<const int*>(hi), static_cast<T*>(out),
        static_cast<float*>(part), static_cast<int*>(tickets), S, H, KV, D,
        split, n_split, scale, softcap);
    return cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out).  part: a
// (B, KV, n_split, H / KV, D + 2) float32 workspace; tickets: a (>= B * KV)
// int32 buffer of zeros, left zeroed.  The caller plans split / n_split
// (split_plan: n_split <= 64, n_split * split >= S) and validates shapes
// (G <= 8, D <= 256).  Returns the launch's cudaError_t.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         const void* lo, const void* hi, void* out,
                         void* part, void* tickets, int B, int S, int H,
                         int KV, int D, int split, int n_split, float scale,
                         float softcap, int dtype, void* stream) {
  if (B == 0 || KV == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float, float>(q, k, v, nullptr, nullptr, lo, hi, out,
                                     part, tickets, B, S, H, KV, D, split,
                                     n_split, scale, softcap, st);
  return (int)launch<__nv_bfloat16, __nv_bfloat16>(
      q, k, v, nullptr, nullptr, lo, hi, out, part, tickets, B, S, H, KV, D,
      split, n_split, scale, softcap, st);
}

// int8 K / V with (B, S, KV, 1) float32 scales; dtype is q's and out's
// (0 = float32, 1 = bfloat16).  Same contract as decode_attention_fwd.
int decode_attention_int8_fwd(const void* q, const void* kq, const void* vq,
                              const void* ks, const void* vs, const void* lo,
                              const void* hi, void* out, void* part,
                              void* tickets, int B, int S, int H, int KV,
                              int D, int split, int n_split, float scale,
                              float softcap, int dtype, void* stream) {
  if (B == 0 || KV == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  if (dtype == 0)
    return (int)launch<float, int8_t>(q, kq, vq, ksf, vsf, lo, hi, out, part,
                                      tickets, B, S, H, KV, D, split, n_split,
                                      scale, softcap, st);
  return (int)launch<__nv_bfloat16, int8_t>(
      q, kq, vq, ksf, vsf, lo, hi, out, part, tickets, B, S, H, KV, D, split,
      n_split, scale, softcap, st);
}

}  // extern "C"
