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
// Design (split-KV, "flash-decoding"; the machinery is split_decode.cuh,
// shared with K1): the grid is (KV, B, n_split).  The host plans n_split
// from pps and page alone (decode_attention.py, split_plan: runs of
// pages_per_split pages, at most 64 runs, at least 64 slots a run) --
// never from valid_len, which lives on the device.  Block (kvh, b, s)
// takes pages [s * pages_per_split, (s + 1) * pages_per_split) intersected
// with the row's floor(lo / page) .. ceil(valid_len / page), up to 64
// attended slots of a page a tile (a bf16 row of head_dim 36 is 72 bytes
// = 9 x 8-byte loads, an int8 row 36 = 9 x 4); a block whose run holds no
// attended slot writes an empty partial and does nothing else.  The
// partials go in f32 to a workspace the wrapper allocates; the last block
// of a (row, KV head) merges them through an atomic ticket in a small
// int32 buffer the wrapper zeroes once and keeps.  One launch per call.
// Shared memory holds one tile (64 slots), so it does not grow with the
// page or the context, and pps has no limit beyond the table's shape.
#include "split_decode.cuh"

namespace {

using namespace split_decode;

// T: q / out type; KT: pool element type (T, or int8_t with scale pools
// ks / vs; nullptr scales mean 1); LT: the load unit.  grid (KV, B,
// n_split), block kThreads, dynamic shared memory smem_bytes.  part:
// (B, KV, n_split, G, D + 2) f32 partials (m, l, acc); tickets: (B * KV)
// int32, 0 between calls.
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
  const Block bk(smem, H, KV, D);
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int hi = max(min(valid_len[b], pps * page), 0);
  const int lo = window > 0 ? max(hi - window, 0) : 0;
  const int p_begin = max(sp * pages_per_split, lo / page);
  const int p_end = min((sp + 1) * pages_per_split, (hi + page - 1) / page);
  const size_t q_base = ((size_t)b * H + (size_t)kvh * bk.G) * D;
  const int pstride = bk.G * (D + 2);  // floats of one partial
  float* row_part = part + (size_t)(b * KV + kvh) * n_split * pstride;

  if (p_begin < p_end) {
    begin_run(bk, q, q_base, scale);
    const int* pt = page_table + (size_t)b * pps;
    for (int pj = p_begin; pj < p_end; ++pj) {
      const int pid = pt[pj];
      const int ta = max(lo - pj * page, 0);  // attended offsets [ta, tb)
      const int tb = min(hi - pj * page, page);
      for (int t0 = ta; t0 < tb; t0 += kTile)
        // (pid, t0, kvh) as a row of the ((P + 1) * page * KV) vectors
        attend_tile<KT, LT>(bk, pk, pv, ks, vs,
                            ((size_t)pid * page + t0) * KV + kvh, KV,
                            min(kTile, tb - t0), softcap);
    }
  }
  end_run(bk, row_part + (size_t)sp * pstride, p_begin < p_end);
  merge_last(bk, row_part, tickets + b * KV + kvh, out + q_base, n_split);
}

template <typename T, typename KT>
cudaError_t launch(const void* q, const void* pk, const void* pv,
                   const float* ks, const float* vs, const void* pt,
                   const void* vl, void* out, void* part, void* tickets,
                   int B, int H, int KV, int D, int page, int pps,
                   int pages_per_split, int n_split, float scale,
                   float softcap, int window, cudaStream_t stream) {
  return with_load_unit<KT>(pk, pv, D, [&](auto unit) {
    static size_t configured = 48 * 1024;
    const size_t smem = smem_bytes(H, KV, D);
    auto kernel = paged_split_kernel<T, KT, decltype(unit)>;
    const cudaError_t err = reserve_smem(kernel, smem, configured);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(KV, B, n_split), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const KT*>(pk),
        static_cast<const KT*>(pv), ks, vs, static_cast<const int*>(pt),
        static_cast<const int*>(vl), static_cast<T*>(out),
        static_cast<float*>(part), static_cast<int*>(tickets), H, KV, D,
        page, pps, pages_per_split, n_split, scale, softcap, window);
    return cudaGetLastError();
  });
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
    return (int)launch<float, float>(
        q, pk, pv, nullptr, nullptr, page_table, valid_len, out, part,
        tickets, B, H, KV, D, page, pps, pages_per_split, n_split, scale,
        softcap, window, st);
  return (int)launch<__nv_bfloat16, __nv_bfloat16>(
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
    return (int)launch<float, int8_t>(
        q, pk, pv, ksf, vsf, page_table, valid_len, out, part, tickets, B, H,
        KV, D, page, pps, pages_per_split, n_split, scale, softcap, window,
        st);
  return (int)launch<__nv_bfloat16, int8_t>(
      q, pk, pv, ksf, vsf, page_table, valid_len, out, part, tickets, B, H,
      KV, D, page, pps, pages_per_split, n_split, scale, softcap, window, st);
}

}  // extern "C"
