// Mamba-2 chunked SSD (state-space dual) scan, f32.
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py::ssd.
// Inputs x (B, S, nh, hd), dt (B, S, nh), A (nh,), Bm and Cm (B, S, G, N);
// outputs y (B, S, nh, hd) and the final state (B, G, hpg, hd, N) with
// hpg = nh / G heads per group. Per chunk of L steps, for each head h of
// group g:
//   lcum[t]    = cumsum_t(dt[t] * A[h])
//   CB[t, s]   = C[t] . B[s]
//   y[t]       = sum_{s <= t} exp(lcum[t] - lcum[s]) * CB[t, s] * dt[s] x[s]
//              + exp(lcum[t]) * (C[t] . state)
//   state      = exp(lcum[L-1]) * state
//              + sum_t exp(lcum[L-1] - lcum[t]) * B[t] (x) dt[t] x[t]
// The decay is taken as the difference lcum[t] - lcum[s] on the lower
// triangle only, never as exp(lcum[t]) * exp(-lcum[s]) (which overflows),
// and nothing is evaluated above the diagonal (the reference masks before
// the exp for the same reason). Rows with dt = 0 (the padding to a chunk
// multiple) leave the state as it is.
//
// Bound on the H100: at the recurrent estimator's shape (B = 1024,
// S = 192, L = 64, nh = 4, hd = 8, G = 1, N = 8) a call moves about 67 MB
// (x and y are 25 MB each), about 20 us at 3.35 TB/s, and does about
// 0.8 GFLOP, about 12 us at 67 TFLOP/s (FP32): bytes bound it, with the
// operations close behind. Most of the operations are the lower triangle
// of the intra-chunk product.
//
// Design. The TPU kernel's grid is (B * G, chunks) with the chunk axis run
// in order and the state in VMEM scratch. Here one block owns one (b, g)
// row and loops over its chunks itself, with the state (hpg, hd, N) in
// shared memory for the whole sequence. A chunk's working set sits in
// shared memory: dt, lcum and the end decays (L x hpg each), B and C
// (L x N each), dt * x (L x hpg x hd), the lower triangle of C.B
// (L (L + 1) / 2, packed by rows, which also keeps the rows of a warp on
// distinct banks) and the state. Phases, with a barrier after each:
//   1. load dt, B, C; then dt * x and, one thread a head, the cumsum;
//      C.B on the lower triangle;
//   2. thread (t, h): y[t, h, :] in registers, the intra-chunk sum over
//      s <= t with one exp a (t, s, h), then the state term; the end
//      decay exp(lcum[L-1] - lcum[t]);
//   3. thread (h, d, n): the state update.
// Limits: the working set must fit a block's 227 KB of shared memory,
// 4 * (3 L hpg + 2 L N + L hpg hd + L (L + 1) / 2 + hpg hd N) bytes; with
// L = 256 that leaves room for hpg * hd up to about 120. Plain FP32 on the
// CUDA cores; tensor cores and bf16 inputs are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemMax = 232448;  // bytes a block may have on sm_90

struct Dims {
  int64_t seqlen;
  int nh, hd, groups, n, chunk, hpg;
};

template <int DC>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ bm,
           const float* __restrict__ cm, float* __restrict__ y,
           float* __restrict__ state_out, Dims dm) {
  extern __shared__ __align__(16) float smem[];
  const int L = dm.chunk, hpg = dm.hpg, hd = dm.hd, N = dm.n;
  const int G = dm.groups, nh = dm.nh;
  const int lh = L * hpg, hw = hpg * hd, sw = hw * N;
  float* dts = smem;             // (L, hpg) dt
  float* lc = dts + lh;          // (L, hpg) cumulative dt * A
  float* sd = lc + lh;           // (L, hpg) exp(lcum[L-1] - lcum[t])
  float* bs = sd + lh;           // (L, N)
  float* cs = bs + L * N;        // (L, N)
  float* du = cs + L * N;        // (L, hpg, hd) dt * x
  float* cb = du + L * hw;       // lower triangle of C.B, packed rows
  float* st = cb + L * (L + 1) / 2;  // (hpg, hd, N) carried state
  const int64_t bid = blockIdx.x;
  const int64_t b = bid / G;
  const int g = (int)(bid - b * G);
  const int tid = threadIdx.x;

  for (int i = tid; i < sw; i += kThreads) st[i] = 0.0f;
  const int n_chunks = (int)(dm.seqlen / L);
  for (int c = 0; c < n_chunks; ++c) {
    const int64_t row0 = b * dm.seqlen + (int64_t)c * L;  // (b, s) of t = 0
    // 1. loads, dt * x, cumsum, C.B
    for (int i = tid; i < lh; i += kThreads) {
      const int t = i / hpg, h = i - t * hpg;
      dts[i] = dt[(row0 + t) * nh + g * hpg + h];
    }
    for (int i = tid; i < L * N; i += kThreads) {
      const int t = i / N, k = i - t * N;
      const int64_t off = ((row0 + t) * G + g) * N + k;
      bs[i] = bm[off];
      cs[i] = cm[off];
    }
    __syncthreads();
    for (int i = tid; i < L * hw; i += kThreads) {
      const int t = i / hw, r = i - t * hw;
      du[i] = dts[t * hpg + r / hd] * x[((row0 + t) * nh + g * hpg) * hd + r];
    }
    if (tid < hpg) {
      const float ah = a[g * hpg + tid];
      float run = 0.0f;
      for (int t = 0; t < L; ++t) {
        run += dts[t * hpg + tid] * ah;
        lc[t * hpg + tid] = run;
      }
    }
    for (int i = tid; i < L * L; i += kThreads) {
      const int t = i / L, s = i - t * L;
      if (s > t) continue;
      float acc = 0.0f;
      for (int k = 0; k < N; ++k) acc += cs[t * N + k] * bs[s * N + k];
      cb[t * (t + 1) / 2 + s] = acc;
    }
    __syncthreads();
    // 2. outputs: thread (t, h) owns y[t, h, :]
    for (int i = tid; i < lh; i += kThreads) {
      const int t = i / hpg, h = i - t * hpg;
      const float lct = lc[i];
      const float* cbt = cb + t * (t + 1) / 2;
      const float qdecay = expf(lct);
      float* yo = y + ((row0 + t) * nh + g * hpg + h) * hd;
      for (int d0 = 0; d0 < hd; d0 += DC) {
        float acc[DC];
#pragma unroll
        for (int d = 0; d < DC; ++d) acc[d] = 0.0f;
        for (int s = 0; s <= t; ++s) {
          const float m = expf(lct - lc[s * hpg + h]) * cbt[s];
          const float* dus = du + (s * hpg + h) * hd + d0;
#pragma unroll
          for (int d = 0; d < DC; ++d)
            if (d0 + d < hd) acc[d] += m * dus[d];
        }
#pragma unroll
        for (int d = 0; d < DC; ++d) {
          if (d0 + d >= hd) break;
          const float* sp = st + (h * hd + d0 + d) * N;
          float q = 0.0f;
          for (int k = 0; k < N; ++k) q += cs[t * N + k] * sp[k];
          yo[d0 + d] = acc[d] + q * qdecay;
        }
      }
      sd[i] = expf(lc[(L - 1) * hpg + h] - lct);
    }
    __syncthreads();
    // 3. state: thread (h, d, n)
    for (int i = tid; i < sw; i += kThreads) {
      const int k = i % N, hdi = i / N, h = hdi / hd;
      float acc = 0.0f;
      for (int t = 0; t < L; ++t)
        acc += bs[t * N + k] * (du[t * hw + hdi] * sd[t * hpg + h]);
      st[i] = st[i] * expf(lc[(L - 1) * hpg + h]) + acc;
    }
    __syncthreads();
  }
  float* so = state_out + bid * sw;
  for (int i = tid; i < sw; i += kThreads) so[i] = st[i];
}

template <int DC>
int launch(const float* x, const float* dt, const float* a, const float* bm,
           const float* cm, float* y, float* state, int64_t rows, Dims dm,
           size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ssd_kernel<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ssd_kernel<DC><<<(unsigned)rows, kThreads, smem, stream>>>(
      x, dt, a, bm, cm, y, state, dm);
  return (int)cudaGetLastError();
}

// Shared-memory bytes a block needs at these sizes.
int64_t smem_bytes(int64_t hpg, int64_t hd, int64_t n, int64_t chunk) {
  return 4 * (3 * chunk * hpg + 2 * chunk * n + chunk * hpg * hd +
              chunk * (chunk + 1) / 2 + hpg * hd * n);
}

}  // namespace

extern "C" int repro_ssd_f32(const float* x, const float* dt, const float* a,
                             const float* bm, const float* cm, float* y,
                             float* state, int64_t batch, int64_t seqlen,
                             int64_t nh, int64_t hd, int64_t groups,
                             int64_t n, int64_t chunk, void* stream) {
  if (batch < 1 || seqlen < 1 || nh < 1 || hd < 1 || groups < 1 || n < 1 ||
      chunk < 1 || chunk > 256 || nh % groups || seqlen % chunk ||
      batch * groups > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int64_t smem = smem_bytes(nh / groups, hd, n, chunk);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  Dims dm{seqlen, (int)nh, (int)hd, (int)groups, (int)n, (int)chunk,
          (int)(nh / groups)};
  const int64_t rows = batch * groups;
  cudaStream_t s = (cudaStream_t)stream;
  if (hd <= 8) return launch<8>(x, dt, a, bm, cm, y, state, rows, dm, smem, s);
  if (hd <= 16)
    return launch<16>(x, dt, a, bm, cm, y, state, rows, dm, smem, s);
  return launch<32>(x, dt, a, bm, cm, y, state, rows, dm, smem, s);
}
