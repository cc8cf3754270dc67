// Batched segment reduction (sum or max): (T, N) f32 values keyed by
// (T, N) int32 segment ids -> (T, C) per-row, per-segment reductions. Ids
// outside [0, C), negative ones included, contribute nothing; an empty
// segment gives the identity (0 for a sum, -inf for a max).
//
// Replaces the TPU kernel
// src/repro/kernels/segsum/kernel.py::segment_reduce_batched.
//
// Bound on the H100: bytes. Each element is read once (8 B: value and id)
// and compared against C segments; at the scheduler's shapes ((1, 1024) a
// period, C = 4) a call moves 8 KB and is the size of a launch.
//
// Design. The TPU kernel tiles (T, N) and accumulates a one-hot compare in
// a (block_t, C) VMEM scratch across the element tiles of a row. Here one
// block owns one row and walks it with a fixed stride: thread i reduces
// elements i, i + kThreads, ... in that order, for up to kSeg segments at
// a time held in registers (more segments take more passes over the row).
// The block then combines the per-thread partials in a fixed tree: a warp
// shuffle tree, then warp 0 over the per-warp results in shared memory.
// No atomics, so a sum is the same bit for bit from run to run; a max is
// exact in any order.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 8;  // segments reduced per pass over the row

template <bool kMax>
__device__ __forceinline__ float combine(float a, float b) {
  return kMax ? fmaxf(a, b) : a + b;
}

template <bool kMax>
__global__ void segsum_kernel(const float* __restrict__ v,
                              const int32_t* __restrict__ ids,
                              float* __restrict__ out, int64_t n, int c) {
  __shared__ float part[kWarps][kSeg];
  const float ident = kMax ? -INFINITY : 0.0f;
  const int64_t row = blockIdx.x;
  const float* vr = v + row * n;
  const int32_t* gr = ids + row * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c0 = 0; c0 < c; c0 += kSeg) {
    float acc[kSeg];
#pragma unroll
    for (int k = 0; k < kSeg; ++k) acc[k] = ident;
    for (int64_t i = threadIdx.x; i < n; i += kThreads) {
      const int g = gr[i] - c0;  // ids outside [c0, c0 + kSeg) match nothing
      const float x = vr[i];
#pragma unroll
      for (int k = 0; k < kSeg; ++k)
        if (g == k) acc[k] = combine<kMax>(acc[k], x);
    }
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
      float a = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a = combine<kMax>(a, __shfl_down_sync(0xffffffffu, a, off));
      if (lane == 0) part[warp][k] = a;
    }
    __syncthreads();
    if (threadIdx.x < kSeg && c0 + (int)threadIdx.x < c) {
      float a = part[0][threadIdx.x];
      for (int w = 1; w < kWarps; ++w)
        a = combine<kMax>(a, part[w][threadIdx.x]);
      out[row * c + c0 + threadIdx.x] = a;
    }
    __syncthreads();  // part is reused by the next pass
  }
}

}  // namespace

// op: 0 = sum, 1 = max. values, ids (t, n) row-major; out (t, c).
extern "C" int repro_segsum_f32(const float* values, const int32_t* ids,
                                float* out, int64_t t, int64_t n, int64_t c,
                                int64_t op, void* stream) {
  if (t < 1 || n < 0 || c < 1 || c > (1 << 20) || t > 0x7fffffff ||
      (op != 0 && op != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (op == 0)
    segsum_kernel<false><<<(unsigned)t, kThreads, 0, s>>>(values, ids, out,
                                                          n, (int)c);
  else
    segsum_kernel<true><<<(unsigned)t, kThreads, 0, s>>>(values, ids, out,
                                                         n, (int)c);
  return (int)cudaGetLastError();
}
