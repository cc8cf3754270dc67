// Fused KPM featurize: normalise a raw KPM trace and cut its overlapping
// estimator windows, on the card.
//
// Replaces the TPU kernel src/repro/kernels/featurize/kernel.py::featurize.
// out[u, b, w, k] = (x[u, b + w, k] - center[k]) / scale[k] for an
// (N, L, K) f32 trace and windows b in [0, L - W + 1).
//
// Bound on the H100: bytes. It does two operations per output element and
// writes W times the bytes it reads, so the output stream at 3.35 TB/s is
// the whole bound; at the fp32 path's (128, 45, 15) that is 3.7 MB written,
// 1.1 us, beside a launch floor of about two.
//
// Two routes; kernels/featurize::plan picks one.
//
// staged (a UE's trace of up to kStageMax values: every call of the
// repository's paths). A block a UE loads the UE's trace (every thread
// issues all of its loads before it uses one; kStageSmall a thread where
// the trace allows), normalises each value once into shared memory, then
// writes the UE's windows. Window b is the staged slice
// xn[b*K, b*K + W*K), and the UE's output is one contiguous run of
// floats, written as 16-byte stores (scalar ones at a head and tail off
// the 16-byte grid): out_flat[f] = xn[b*K + t] with b = f / (W*K),
// t = f - b*W*K, both stepped without a division. The division is
// computed once a value, not once a window that holds it (W = 30 times).
// At the path's shape 2-4 blocks a UE over ranges of its windows measured
// no faster (each range restages its windows' W - 1 extra rows), and
// lanes on consecutive 4-byte stores (no shared-memory bank conflicts) no
// faster than the 16-byte ones: what is left above a torch fill of the
// same output is the load's latency before it.
//
// generic (a trace past kStageMax values; the first version): one block of
// 128 threads copies one window, consecutive threads on consecutive
// addresses, normalising every value it writes.
//
// Both divide with a true IEEE division (no reciprocal multiply, no fast
// math), so the result is bit-equal to the plain PyTorch version and to
// the numpy host path (channel/kpm.py::normalize_kpms).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStageThreads = 256;
constexpr int kStagePer = 12;  // most trace values a thread stages
constexpr int kStageMax = kStageThreads * kStagePer;  // 3072 values, 12 KB
// the instance of traces up to 1024 values (the paths' 675): 4 a thread
constexpr int kStageSmall = 4;

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

// Block u writes the n_win windows of UE u; each thread stages kPer
// values of the UE's trace.
template <int kPer>
__global__ void __launch_bounds__(kStageThreads)
    featurize_staged(const float* __restrict__ x,
                     const float* __restrict__ center,
                     const float* __restrict__ scale,
                     float* __restrict__ out, int length, int k, int window,
                     int n_win) {
  __shared__ float xn[kStageMax];
  const int u = blockIdx.x;
  const int nel = length * k;
  const float* src = x + (int64_t)u * nel;
  // value i of the trace is channel i % k: the thread's first by one
  // division, each next kStageThreads on by adding kStageThreads % k
  const int kstep = kStageThreads % k;
  int kk = threadIdx.x % k;
  float v[kPer], c[kPer], s[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kStageThreads;
    v[j] = __ldg(src + (i < nel ? i : nel - 1));  // every load issued first
    c[j] = __ldg(center + kk);
    s[j] = __ldg(scale + kk);
    kk += kstep;
    if (kk >= k) kk -= k;
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * kStageThreads;
    if (i < nel) xn[i] = __fdiv_rn(__fsub_rn(v[j], c[j]), s[j]);
  }
  __syncthreads();
  const int span = window * k;
  // the UE's floats of out: [lo, lo + len), f counted from lo; float f
  // is xn[b * k + t], b = f / span, t = f - b * span, stepped without a
  // division
  const int64_t lo = (int64_t)u * n_win * span;
  const int len = n_win * span;
  float* dst = out + lo;
  int head = (int)((-lo) & 3);
  if (head > len) head = len;
  const int n_vec = (len - head) >> 2;
  int f = head + 4 * threadIdx.x;
  int b = f / span, t = f - b * span;
  const int fstep = 4 * kStageThreads;
  const int bstep = fstep / span, tstep = fstep - bstep * span;
  for (int q = threadIdx.x; q < n_vec; q += kStageThreads) {
    float r[4];
    int bb = b, tt = t;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r[j] = xn[bb * k + tt];
      if (++tt == span) {
        tt = 0;
        ++bb;
      }
    }
    *reinterpret_cast<float4*>(dst + f) =
        make_float4(r[0], r[1], r[2], r[3]);
    f += fstep;
    b += bstep;
    t += tstep;
    if (t >= span) {
      t -= span;
      ++b;
    }
  }
  // the scalars off the 16-byte grid: the head and the tail
  const int tail = head + 4 * n_vec;
  if ((int)threadIdx.x < head + (len - tail)) {
    const int g = (int)threadIdx.x < head ? threadIdx.x
                                          : tail + threadIdx.x - head;
    const int gb = g / span;
    dst[g] = xn[gb * k + (g - gb * span)];
  }
}

}  // namespace

// route: 0 = generic, 1 = staged (a trace of at most kStageMax values).
extern "C" int repro_featurize_f32(const float* x, const float* center,
                                   const float* scale, float* out, int64_t n,
                                   int64_t length, int64_t k, int64_t window,
                                   int64_t route, void* stream) {
  const int64_t n_win = length - window + 1;
  const int64_t span = window * k;  // floats in one window
  if (n < 1 || k < 1 || window < 1 || n_win < 1 || span > (1 << 30) ||
      n * n_win > 0x7fffffff || (route != 0 && route != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    const int64_t nel = length * k;  // the UE's trace
    if (nel > kStageMax) return (int)cudaErrorInvalidValue;
    auto kernel = nel <= kStageThreads * kStageSmall
                      ? featurize_staged<kStageSmall>
                      : featurize_staged<kStagePer>;
    kernel<<<(unsigned)n, kStageThreads, 0, s>>>(
        x, center, scale, out, (int)length, (int)k, (int)window, (int)n_win);
    return (int)cudaGetLastError();
  }
  featurize_kernel<<<(unsigned)(n * n_win), 128, 0, s>>>(
      x, center, scale, out, length, (int)k, (int)span, n_win);
  return (int)cudaGetLastError();
}

// The message of a CUDA error code, for the Python wrappers' exceptions.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
