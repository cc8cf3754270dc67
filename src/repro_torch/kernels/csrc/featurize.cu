// Fused KPM featurize: normalise a raw KPM trace and cut its overlapping
// estimator windows, on the card.
//
// Replaces the TPU kernel src/repro/kernels/featurize/kernel.py::featurize.
// out[u, b, w, k] = (x[u, b + w, k] - center[k]) / scale[k] for an
// (N, L, K) f32 trace and windows b in [0, L - W + 1).
//
// Bound on the H100: bytes. It does two operations per output element and
// writes W times the bytes it reads, so the output stream at 3.35 TB/s is
// the whole cost. The TPU kernel staged the full trace axis of a row block
// in VMEM and unrolled the window copies. Here the layout does the work:
// window b of UE u is the contiguous slice x[u, b:b+W, :] of W*K floats,
// and its output out[u, b] is contiguous too, so one block copies one
// window with consecutive threads on consecutive addresses (coalesced
// loads and stores; the W-fold overlap of the loads hits L1/L2).
//
// The division is a true IEEE division (no reciprocal multiply, no fast
// math), so the result is bit-equal to the plain PyTorch version and to
// the numpy host path (channel/kpm.py::normalize_kpms).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void featurize_kernel(const float* __restrict__ x,
                                 const float* __restrict__ center,
                                 const float* __restrict__ scale,
                                 float* __restrict__ out, int64_t length,
                                 int k, int span, int64_t n_win) {
  const int64_t win = blockIdx.x;  // u * n_win + b
  const int64_t u = win / n_win;
  const float* src = x + (u * length + (win - u * n_win)) * k;
  float* dst = out + win * span;
  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    const int kk = t % k;
    dst[t] = (src[t] - center[kk]) / scale[kk];
  }
}

}  // namespace

extern "C" int repro_featurize_f32(const float* x, const float* center,
                                   const float* scale, float* out, int64_t n,
                                   int64_t length, int64_t k, int64_t window,
                                   void* stream) {
  const int64_t n_win = length - window + 1;
  const int64_t span = window * k;  // floats in one window
  if (n < 1 || k < 1 || n_win < 1 || span > (1 << 30) ||
      n * n_win > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  featurize_kernel<<<(unsigned)(n * n_win), 128, 0, (cudaStream_t)stream>>>(
      x, center, scale, out, length, (int)k, (int)span, n_win);
  return (int)cudaGetLastError();
}

// The message of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
