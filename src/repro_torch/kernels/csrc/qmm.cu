// int8 x int8 -> int32 rowwise-scaled matrix product:
//   out[m, n] = f32(sum_k xq[m, k] * wq[n, k]) * sx[m] * sw[n]
// xq (M, K) int8 activations with one f32 scale a row, wq (N, K) int8
// weights with one f32 scale an output channel (the layout of a rowwise
// quantized w.T). Integer sums are exact, so any order gives the plain
// version's int32; the two scale multiplies are written with __fmul_rn,
// in the reference's order, so nvcc contracts nothing.
//
// Replaces the TPU kernel src/repro/kernels/qmm/kernel.py::qmm.
//
// Bound on the H100: bytes on the CNN fc, the product that matters (one
// pass: M 365, N 124, K 78624): 28.7 MB of activations and 9.75 MB of
// weights read once, 11.5 us at 3.35 TB/s, against 7.1 G int8 operations,
// 3.6 us at the tensor cores' 1,979 TOP/s. The 124-wide products of the
// LSTM projection and the head are a few microseconds of launch.
//
// Design. The TPU kernel walks K in sequence with an int32 accumulator in
// VMEM. Here one block computes a 64 x 64 output tile with 256 threads,
// each thread 4 x 4 outputs spaced 16 apart, and walks its K range in
// steps of 64 bytes: both operand tiles are staged in shared memory as
// 32-bit words of four int8 values (K-major, so a thread's four A and four
// B words sit in distinct banks), zero-padded past the ragged edges of M,
// N and K, and every word pair is one __dp4a. Rows of K % 4 != 0 bytes
// (K = 15, 33) are not word aligned and are packed byte by byte. The fc's
// output is only 6 x 2 tiles, so K is split over a third grid dimension
// (the wrapper picks the count so that about 264 blocks run); each split
// writes its int32 partial sums and a second kernel adds them (exact) and
// applies the scales. dp4a runs on the CUDA cores at a fraction of the
// tensor cores' int8 rate; mma.sync / wgmma int8 tiles and a ring of
// cp.async or TMA stages are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;           // output rows and columns a block
constexpr int kStepWords = 16;      // 64 bytes of K a step
constexpr int kThreads = 256;
constexpr int kLd = kTile + 2;      // word stride of a staged K-word row

// Stages rows [r0, r0 + 64) x bytes [k0, k0 + 64) of src (rows x K int8)
// into dst[w][r], zero past `rows` and `kend`.
__device__ __forceinline__ void stage(int32_t (*dst)[kLd],
                                      const int8_t* __restrict__ src,
                                      int64_t rows, int64_t K, int64_t r0,
                                      int64_t k0, int64_t kend, bool words) {
  for (int i = threadIdx.x; i < kTile * kStepWords; i += kThreads) {
    const int r = i / kStepWords, w = i % kStepWords;
    const int64_t row = r0 + r, k = k0 + 4 * w;
    uint32_t v = 0;
    if (row < rows) {
      const int8_t* p = src + row * K + k;
      if (words) {  // K % 4 == 0: k < kend means all four bytes are in
        if (k < kend) v = (uint32_t)__ldg(reinterpret_cast<const int*>(p));
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (k + b < kend) v |= (uint32_t)(uint8_t)p[b] << (8 * b);
      }
    }
    dst[w][r] = (int32_t)v;
  }
}

__device__ __forceinline__ float scaled(int32_t acc, float sx, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
}

__global__ void __launch_bounds__(kThreads)
    qmm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
               const int8_t* __restrict__ wq, const float* __restrict__ sw,
               float* __restrict__ out, int32_t* __restrict__ part,
               int64_t M, int64_t N, int64_t K, int64_t k_per_split,
               bool words) {
  __shared__ int32_t a_s[kStepWords][kLd];
  __shared__ int32_t b_s[kStepWords][kLd];
  const int64_t n0 = (int64_t)blockIdx.x * kTile;
  const int64_t m0 = (int64_t)blockIdx.y * kTile;
  const int64_t kb = (int64_t)blockIdx.z * k_per_split;
  const int64_t ke = kb + k_per_split < K ? kb + k_per_split : K;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int32_t acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int64_t k0 = kb; k0 < ke; k0 += 4 * kStepWords) {
    stage(a_s, xq, M, K, m0, k0, ke, words);
    stage(b_s, wq, N, K, n0, k0, ke, words);
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kStepWords; ++w) {
      int32_t a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[w][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[w][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t n = n0 + tx + 16 * j;
      if (n >= N) continue;
      if (part == nullptr)
        out[m * N + n] = scaled(acc[i][j], sx[m], sw[n]);
      else
        part[((int64_t)blockIdx.z * M + m) * N + n] = acc[i][j];
    }
  }
}

__global__ void qmm_sum_splits(const int32_t* __restrict__ part,
                               const float* __restrict__ sx,
                               const float* __restrict__ sw,
                               float* __restrict__ out, int64_t M, int64_t N,
                               int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t mn = M * N;
  if (i >= mn) return;
  int32_t acc = 0;
  for (int p = 0; p < splits; ++p) acc += part[p * mn + i];
  out[i] = scaled(acc, sx[i / N], sw[i % N]);
}

}  // namespace

extern "C" int repro_qmm_s8(const int8_t* xq, const float* sx,
                            const int8_t* wq, const float* sw, float* out,
                            int32_t* part, int64_t m, int64_t n, int64_t k,
                            int64_t splits, void* stream) {
  if (m < 1 || n < 1 || k < 1 || splits < 1 || splits > 65535 ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int64_t m_tiles = (m + kTile - 1) / kTile;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  if (m_tiles > 65535 || n_tiles > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const int64_t steps = (k + 4 * kStepWords - 1) / (4 * kStepWords);
  const int64_t k_per_split =
      (steps + splits - 1) / splits * (4 * kStepWords);
  const bool words = k % 4 == 0 && (uintptr_t)xq % 4 == 0 &&
                     (uintptr_t)wq % 4 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((unsigned)n_tiles, (unsigned)m_tiles, (unsigned)splits);
  qmm_kernel<<<grid, kThreads, 0, s>>>(xq, sx, wq, sw, out,
                                       splits > 1 ? part : nullptr, m, n, k,
                                       k_per_split, words);
  if (splits > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (m * n + 255) / 256;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    qmm_sum_splits<<<(unsigned)blocks, 256, 0, s>>>(part, sx, sw, out, m, n,
                                                     (int)splits);
  }
  return (int)cudaGetLastError();
}
