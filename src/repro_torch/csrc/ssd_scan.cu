// K4: the Mamba-2 SSD (state-space duality) chunk kernels, for NVIDIA
// Hopper (sm_90a).  Built by repro_torch/kernels/_build.py with nvcc into a
// shared library with a plain C interface (loaded by ctypes).
//
// Replaces: src/repro/kernels/ssd_scan.py -- ssd_intra_chunk_pallas (body
// _ssd_chunk_kernel), the TPU kernel, and the inter-chunk recurrence its
// wrapper ssd_scan_pallas runs as a jax.lax.scan in XLA.  Two entries:
//
// ssd_intra_chunk_fwd -- the Pallas kernel's function, one block per
//   (batch, head, chunk): cs = cumsum(da) in shared memory; the scores
//   C . B^T (Q, Q) times exp(cs_l - cs_s) for s <= l only (the upper
//   triangle is set to 0 WITHOUT evaluating the exponential: cs decreases,
//   so exp(cs_l - cs_s) overflows for s > l, and inf * 0 would be NaN);
//   y_intra = scores . xdt (Q, P); the chunk-final state
//   xdt^T . (b * exp(cs_end - cs)) (P, N).
// ssd_chunk_scan_fwd -- the wrapper's inter-chunk part, as two launches:
//   a state pass, where each thread owns one state element (b, h, p, n)
//   and walks the chunks in order: prev_0 = init_state (zeros when null),
//   prev_{k+1} = prev_k * exp(sum(da_k)) + state_k, writing every prev_k
//   to a workspace and the last one as the final state; then an output
//   pass, one block per (batch, head, chunk), in parallel over chunks:
//   y = y_intra + exp(cs_l) * C_l . prev_k.  On the hot path this replaces
//   a host loop of nc steps (nc = L at chunk 1); only the state pass is
//   sequential, and it carries one register per thread.
//
// Layouts (all float32, contiguous): xdt (B, H, nc, Q, P); da (B, H, nc, Q);
// b, c (B, nc, Q, N) (one group, shared by the heads); y_intra, y
// (B, H, nc, Q, P); states, prevs (B, H, nc, P, N); init, final (B, H, P, N).
// Runtime sizes: Q <= 64, P <= 64, N <= 128 (the wrapper raises beyond).
// All arithmetic is f32 FMAs.
//
// What bounds it on an H100: at mamba2-130m's shapes (Q 64, P 64, N 128)
// the intra block does ~1.3 MFLOP of products on 70 KB of inputs and
// writes 48 KB -- near the ridge of f32 CUDA-core FMAs (67 TFLOP/s)
// against 3.35 TB/s; at small Q the per-chunk states (P x N f32 per chunk
// and head: 476 MB a layer for one 605-token prompt at Q = 1) dominate
// and both entries are bound by bytes.  The products run as 4 x 4 (the
// state: 8 x 4) register tiles per thread over operands in shared memory
// (rows of b, c and the scores padded by one float, so the 16 rows a
// half-warp reads sit in 16 banks), 8 loads per 16 FMAs (12 per 32); a
// tile wholly outside a small chunk is skipped.  Later work: wgmma for
// the products, and fusing the entries so the per-chunk states never
// reach device memory.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // 16 x 16 threads, one register tile each
constexpr int kSide = 16;

// Inclusive prefix sum of v[0, n), n <= 64, in place.  Every thread of the
// block calls it (between barriers); warp 0 does the work with shuffles.
__device__ __forceinline__ void cumsum64(float* v, int n) {
  if (threadIdx.x >= 32) return;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x;
  float lo = lane < n ? v[lane] : 0.f;
  float hi = lane + 32 < n ? v[lane + 32] : 0.f;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float tl = __shfl_up_sync(full, lo, o);
    const float th = __shfl_up_sync(full, hi, o);
    if (lane >= o) {
      lo += tl;
      hi += th;
    }
  }
  hi += __shfl_sync(full, lo, 31);
  if (lane < n) v[lane] = lo;
  if (lane + 32 < n) v[lane + 32] = hi;
}

// Copy rows of a contiguous (rows, n) global matrix into shared memory with
// row stride ld.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int rows, int n, int ld) {
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * n; i += kThreads) {
    const int r = i / n;
    dst[r * ld + (i - r * n)] = src[i];
  }
}

// out[i][j] (4 x 4 register tile) += sum_k a[ra[i] * lda + k] *
// b[rb[j] * ldb + k] for k < K: the tile's rows ra (of a) and rb (of b).
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a,
                                         const int (&ra)[4], int lda,
                                         const float* b, const int (&rb)[4],
                                         int ldb, int K) {
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[ra[i] * lda + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[rb[j] * ldb + k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// grid (nc, H, B), block kThreads; registers capped at 85 a thread, so
// three small blocks share an SM (at 64/64/128 the ~100 KB of shared memory
// allows two).  Dynamic shared
// memory (floats): x_s[Q * P] | b_s[Q * (N + 1)] | c_s[Q * (N + 1)] |
// sc_s[Q * (Q + 1)] | cs_s[Q] | w_s[Q]
__global__ void __launch_bounds__(kThreads, 3)
ssd_intra_chunk_kernel(const float* __restrict__ xdt,
                       const float* __restrict__ da,
                       const float* __restrict__ bm,
                       const float* __restrict__ cm, float* __restrict__ y,
                       float* __restrict__ st, int H, int nc, int Q, int P,
                       int N) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const int LD = N + 1;
  const int LQ = Q + 1;
  float* x_s = smem;
  float* b_s = x_s + Q * P;
  float* c_s = b_s + Q * LD;
  float* sc_s = c_s + Q * LD;
  float* cs_s = sc_s + Q * LQ;
  float* w_s = cs_s + Q;

  const size_t bhn = ((size_t)b * H + h) * nc + n;   // (b, h, chunk)
  const size_t bn = (size_t)b * nc + n;              // (b, chunk)
  for (int i = tid; i < Q * P; i += kThreads) x_s[i] = xdt[bhn * Q * P + i];
  load_rows(b_s, bm + bn * Q * N, Q, N, LD);
  load_rows(c_s, cm + bn * Q * N, Q, N, LD);
  if (tid < Q) cs_s[tid] = da[bhn * Q + tid];
  __syncthreads();
  cumsum64(cs_s, Q);
  __syncthreads();
  if (tid < Q) w_s[tid] = expf(cs_s[Q - 1] - cs_s[tid]);

  // the tile's rows: l = ty + 16 i (queries), s / p = tx + 16 j; rows past
  // the matrix read a valid row and their results are dropped
  int lr[4], sr[4], pr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lr[i] = min(ty + kSide * i, Q - 1);
    sr[i] = min(tx + kSide * i, Q - 1);
    pr[i] = min(tx + kSide * i, P - 1);
  }

  // decay-masked scores: s <= l only; the exponential is never evaluated
  // above the diagonal
  if (ty < Q && tx < Q) {      // else the whole tile lies outside (small Q)
    float acc[4][4] = {};
    tile_dot(acc, c_s, lr, LD, b_s, sr, LD, N);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = ty + kSide * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tx + kSide * j;
        if (l < Q && s < Q)
          sc_s[l * LQ + s] =
              s <= l ? acc[i][j] * expf(cs_s[l] - cs_s[s]) : 0.f;
      }
    }
  }
  __syncthreads();

  // b <- b * exp(cs_end - cs) for the state product (the scores are done
  // with b)
  for (int i = tid; i < Q * N; i += kThreads) {
    const int s = i / N;
    b_s[s * LD + (i - s * N)] *= w_s[s];
  }
  // y_intra (Q, P) = scores . xdt (the scores are 0 above the diagonal)
  if (ty < Q && tx < P) {
    float acc[4][4] = {};
    for (int s = 0; s < Q; ++s) {
      float sv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sc_s[lr[i] * LQ + s];
#pragma unroll
      for (int j = 0; j < 4; ++j) xv[j] = x_s[s * P + pr[j]];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
    }
    float* yg = y + bhn * Q * P;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = ty + kSide * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + kSide * j;
        if (l < Q && p < P) yg[l * P + p] = acc[i][j];
      }
    }
  }
  __syncthreads();

  // chunk-final state (P, N) = xdt^T . (b * exp(cs_end - cs)): an 8 x 4
  // tile, p = warp + 8 i, m = lane + 32 j (a warp stores 32 consecutive
  // floats of a row)
  {
    const int lane = tid % 32;
    const int warp = tid / 32;
    int rp[8], rm[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) rp[i] = min(warp + 8 * i, P - 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) rm[j] = min(lane + 32 * j, N - 1);
    float acc[8][4] = {};
    for (int s = 0; s < Q; ++s) {
      float xv[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) xv[i] = x_s[s * P + rp[i]];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[s * LD + rm[j]];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
    }
    float* sg = st + bhn * P * N;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = warp + 8 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = lane + 32 * j;
        if (p < P && m < N) sg[p * N + m] = acc[i][j];
      }
    }
  }
}

// The state pass loads the chunks kGroup at a time, the next group's loads
// in flight while the current group is folded in.
constexpr int kGroup = 4;

struct ChunkGroup {
  float st[kGroup];   // this thread's state element of each chunk
  float dlo[kGroup];  // da[lane] and da[lane + 32] of each chunk
  float dhi[kGroup];
};

__device__ __forceinline__ void load_group(ChunkGroup& g, const float* st,
                                           const float* da, size_t bh,
                                           int k0, int nc, int Q, int PN,
                                           int e, bool own) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    const int k = k0 + j;
    const bool in = k < nc;
    const float* d = da + (bh * nc + k) * Q;
    g.st[j] = own && in ? st[(bh * nc + k) * PN + e] : 0.f;
    g.dlo[j] = in && lane < Q ? d[lane] : 0.f;
    g.dhi[j] = in && lane + 32 < Q ? d[lane + 32] : 0.f;
  }
}

// The state pass: grid (ceil(P * N / kThreads), H, B).  Thread e owns state
// element e of (b, h) and walks the chunks in order; each chunk's decay
// exp(sum(da)) is summed by the warp with shuffles.
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(const float* __restrict__ st,
                      const float* __restrict__ da,
                      const float* __restrict__ init,
                      float* __restrict__ prevs, float* __restrict__ fin,
                      int H, int nc, int Q, int PN) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const bool own = e < PN;   // idle lanes still join the warp's da sums
  float prev = own && init ? init[bh * PN + e] : 0.f;
  ChunkGroup cur, nxt;
  load_group(cur, st, da, bh, 0, nc, Q, PN, e, own);
  for (int k0 = 0; k0 < nc; k0 += kGroup) {
    load_group(nxt, st, da, bh, k0 + kGroup, nc, Q, PN, e, own);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (k0 + j >= nc) break;
      float sum = cur.dlo[j] + cur.dhi[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (own) prevs[(bh * nc + k0 + j) * PN + e] = prev;
      prev = fmaf(prev, expf(sum), cur.st[j]);
    }
    cur = nxt;
  }
  if (own) fin[bh * PN + e] = prev;
}

// The output pass: grid (nc, H, B), block kThreads.  Dynamic shared memory
// (floats): c_s[Q * (N + 1)] | pv_s[P * (N + 1)] | cs_s[Q]
__global__ void __launch_bounds__(kThreads)
ssd_chunk_out_kernel(const float* __restrict__ y_intra,
                     const float* __restrict__ prevs,
                     const float* __restrict__ da,
                     const float* __restrict__ cm, float* __restrict__ y,
                     int H, int nc, int Q, int P, int N) {
  extern __shared__ float smem[];
  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % kSide;
  const int ty = tid / kSide;
  const int LD = N + 1;
  float* c_s = smem;
  float* pv_s = c_s + Q * LD;
  float* cs_s = pv_s + P * LD;

  const size_t bhn = ((size_t)b * H + h) * nc + n;
  load_rows(c_s, cm + ((size_t)b * nc + n) * Q * N, Q, N, LD);
  load_rows(pv_s, prevs + bhn * P * N, P, N, LD);
  if (tid < Q) cs_s[tid] = da[bhn * Q + tid];
  __syncthreads();
  cumsum64(cs_s, Q);
  __syncthreads();

  int lr[4], pr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lr[i] = min(ty + kSide * i, Q - 1);
    pr[i] = min(tx + kSide * i, P - 1);
  }
  if (ty >= Q || tx >= P) return;     // the whole tile lies outside
  float acc[4][4] = {};
  tile_dot(acc, c_s, lr, LD, pv_s, pr, LD, N);
  const size_t base = bhn * Q * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = ty + kSide * i;
    if (l >= Q) continue;
    const float e = expf(cs_s[l]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx + kSide * j;
      if (p < P)
        y[base + l * P + p] = y_intra[base + l * P + p] + acc[i][j] * e;
    }
  }
}

size_t intra_smem(int Q, int P, int N) {
  return sizeof(float) * ((size_t)Q * P + 2 * (size_t)Q * (N + 1) +
                          (size_t)Q * (Q + 1) + 2 * Q);
}

size_t out_smem(int Q, int P, int N) {
  return sizeof(float) * ((size_t)(Q + P) * (N + 1) + Q);
}

// Raise a kernel's dynamic shared-memory limit above the default 48 KB
// (once per kernel and size).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, size_t& configured) {
  if (smem <= configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) configured = smem;
  return err;
}

}  // namespace

extern "C" {

// Returns the launch's cudaError_t.  The caller validates shapes
// (Q <= 64, P <= 64, N <= 128) and allocates the outputs.
int ssd_intra_chunk_fwd(const void* xdt, const void* da, const void* b,
                        const void* c, void* y, void* states, int B, int H,
                        int nc, int Q, int P, int N, void* stream) {
  if (B == 0 || H == 0 || nc == 0) return (int)cudaGetLastError();
  const size_t smem = intra_smem(Q, P, N);
  static size_t configured = 48 * 1024;
  const cudaError_t err = allow_smem(ssd_intra_chunk_kernel, smem,
                                     configured);
  if (err != cudaSuccess) return (int)err;
  ssd_intra_chunk_kernel<<<dim3(nc, H, B), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(da),
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(y), static_cast<float*>(states), H, nc, Q, P, N);
  return (int)cudaGetLastError();
}

// init may be null (a zero initial state); prevs is a (B, H, nc, P, N)
// float32 workspace.  Same contract as ssd_intra_chunk_fwd.
int ssd_chunk_scan_fwd(const void* y_intra, const void* states,
                       const void* da, const void* c, const void* init,
                       void* y, void* final_state, void* prevs, int B, int H,
                       int nc, int Q, int P, int N, void* stream) {
  if (B == 0 || H == 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int PN = P * N;
  ssd_state_pass_kernel<<<dim3((PN + kThreads - 1) / kThreads, H, B),
                          kThreads, 0, st>>>(
      static_cast<const float*>(states), static_cast<const float*>(da),
      static_cast<const float*>(init), static_cast<float*>(prevs),
      static_cast<float*>(final_state), H, nc, Q, PN);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nc == 0) return (int)err;
  const size_t smem = out_smem(Q, P, N);
  static size_t configured = 48 * 1024;
  err = allow_smem(ssd_chunk_out_kernel, smem, configured);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_out_kernel<<<dim3(nc, H, B), kThreads, smem, st>>>(
      static_cast<const float*>(y_intra), static_cast<const float*>(prevs),
      static_cast<const float*>(da), static_cast<const float*>(c),
      static_cast<float*>(y), H, nc, Q, P, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
