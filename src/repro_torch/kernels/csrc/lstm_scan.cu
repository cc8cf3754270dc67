// Fused fp32 LSTM scan: the throughput estimator's temporal branch without
// its output projection. Returns the final hidden state of a T-step LSTM
// with gates i, f, g, o, one bias and +1.0 on the forget pre-activation:
//   z = x_t @ wx + h @ wh + b
//   c = sigmoid(z_f + 1) * c + sigmoid(z_i) * tanh(z_g)
//   h = sigmoid(z_o) * tanh(c)
//
// Replaces the TPU kernel src/repro/kernels/lstm/kernel.py::lstm_scan.
//
// Bound on the H100: operations. At the estimator's width (K = 15,
// H = 124, T = 30) a row costs 30 * 2 * (15 + 124) * 496 = 4.14 MFLOP of
// multiply-adds against 0.5 KB of input, far above the card's ratio of
// 67 TFLOP/s (FP32, no tensor cores) to 3.35 TB/s.
//
// Design. The TPU kernel keeps wx, wh and (h, c) in VMEM for all T steps.
// On Hopper wh alone is 124 * 496 * 4 = 246,016 B, more than the 232,448 B
// of shared memory a block may have, so that design does not carry over.
// Instead one block owns a tile of kRows batch rows and loops the T steps
// itself, with __syncthreads() between steps:
//   - thread j owns hidden unit j: it accumulates the four gate columns
//     j, H+j, 2H+j, 3H+j for all kRows rows, so the gate chain needs no
//     exchange between threads. Threads j >= H (H = 124 in a block of 128)
//     are masked;
//   - the tile's whole input (kRows x T x K, contiguous in memory) is
//     copied to shared memory once, and so is the tile's h; each thread
//     keeps its c for the kRows rows and its four columns of wx in
//     registers;
//   - wh is read through L1/L2 (it stays resident in the 50 MB L2), each
//     weight feeding kRows rows' multiply-adds, with the next four hidden
//     inputs' weights loaded while the current ones are used.
// Sums run in f32 FMAs in the reference's order: x_t @ wx and h @ wh
// separately, then (x-part + h-part) + b. The gates use expf/tanhf (no
// fast-math intrinsics). Tensor cores, TF32/bf16 weights and wgmma are
// left for later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;  // batch rows per block
constexpr int kMaxK = 16;  // input features a thread keeps wx columns for

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__global__ void lstm_scan_kernel(const float* __restrict__ x,
                                 const float* __restrict__ wx,
                                 const float* __restrict__ wh,
                                 const float* __restrict__ bias,
                                 float* __restrict__ h_out, int64_t batch,
                                 int steps, int k_in, int hidden) {
  extern __shared__ __align__(16) float smem[];
  const int gates = 4 * hidden;
  const int hs = (hidden + 3) & ~3;  // h row stride: rows stay 16 B aligned
  float* h_s = smem;                 // (kRows, hs)
  float* x_s = h_s + kRows * hs;     // (kRows, steps, k_in)
  const int64_t row0 = (int64_t)blockIdx.x * kRows;
  const int j = threadIdx.x;
  const bool live = j < hidden;

  {  // the tile's rows are contiguous: one coalesced copy, zero-padded
    const int64_t per_row = (int64_t)steps * k_in;
    const int64_t have = (batch - row0 < kRows ? batch - row0 : kRows) *
                         per_row;
    const float* src = x + row0 * per_row;
    for (int64_t i = threadIdx.x; i < kRows * per_row; i += blockDim.x)
      x_s[i] = i < have ? src[i] : 0.0f;
  }
  for (int i = threadIdx.x; i < kRows * hs; i += blockDim.x) h_s[i] = 0.0f;
  float wx_i[kMaxK], wx_f[kMaxK], wx_g[kMaxK], wx_o[kMaxK];
#pragma unroll
  for (int q = 0; q < kMaxK; ++q) {
    const bool on = live && q < k_in;
    wx_i[q] = on ? wx[q * gates + j] : 0.0f;
    wx_f[q] = on ? wx[q * gates + hidden + j] : 0.0f;
    wx_g[q] = on ? wx[q * gates + 2 * hidden + j] : 0.0f;
    wx_o[q] = on ? wx[q * gates + 3 * hidden + j] : 0.0f;
  }
  float c[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) c[r] = 0.0f;
  float b_i = 0.0f, b_f = 0.0f, b_g = 0.0f, b_o = 0.0f;
  if (live) {
    b_i = bias[j];
    b_f = bias[hidden + j];
    b_g = bias[2 * hidden + j];
    b_o = bias[3 * hidden + j];
  }
  const int k4 = hidden & ~3;
  const float* wh_j = wh + (live ? j : 0);
  __syncthreads();  // x_s and h_s ready

  for (int t = 0; t < steps; ++t) {
    float h_new[kRows];
    if (live) {
      float a_i[kRows], a_f[kRows], a_g[kRows], a_o[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        a_i[r] = 0.0f;
        a_f[r] = 0.0f;
        a_g[r] = 0.0f;
        a_o[r] = 0.0f;
      }
      // h @ wh, four hidden inputs at a time (one 16 B shared load per
      // row); the next four inputs' weights load while these are used
      float nw[16];
      if (k4 > 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float* w = wh_j + (int64_t)q * gates;
          nw[4 * q] = __ldg(w);
          nw[4 * q + 1] = __ldg(w + hidden);
          nw[4 * q + 2] = __ldg(w + 2 * hidden);
          nw[4 * q + 3] = __ldg(w + 3 * hidden);
        }
      }
      for (int k = 0; k < k4; k += 4) {
        float w[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) w[q] = nw[q];
        if (k + 4 < k4) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float* p = wh_j + (int64_t)(k + 4 + q) * gates;
            nw[4 * q] = __ldg(p);
            nw[4 * q + 1] = __ldg(p + hidden);
            nw[4 * q + 2] = __ldg(p + 2 * hidden);
            nw[4 * q + 3] = __ldg(p + 3 * hidden);
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 hv = *reinterpret_cast<const float4*>(h_s + r * hs + k);
          const float hq[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            a_i[r] = fmaf(hq[q], w[4 * q], a_i[r]);
            a_f[r] = fmaf(hq[q], w[4 * q + 1], a_f[r]);
            a_g[r] = fmaf(hq[q], w[4 * q + 2], a_g[r]);
            a_o[r] = fmaf(hq[q], w[4 * q + 3], a_o[r]);
          }
        }
      }
      for (int k = k4; k < hidden; ++k) {  // H % 4 tail
        const float* p = wh_j + (int64_t)k * gates;
        const float w0 = __ldg(p), w1 = __ldg(p + hidden);
        const float w2 = __ldg(p + 2 * hidden), w3 = __ldg(p + 3 * hidden);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hv = h_s[r * hs + k];
          a_i[r] = fmaf(hv, w0, a_i[r]);
          a_f[r] = fmaf(hv, w1, a_f[r]);
          a_g[r] = fmaf(hv, w2, a_g[r]);
          a_o[r] = fmaf(hv, w3, a_o[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* xr = x_s + ((int64_t)r * steps + t) * k_in;
        float x_i = 0.0f, x_f = 0.0f, x_g = 0.0f, x_o = 0.0f;
#pragma unroll
        for (int q = 0; q < kMaxK; ++q) {  // x_t @ wx
          if (q < k_in) {
            const float xv = xr[q];
            x_i = fmaf(xv, wx_i[q], x_i);
            x_f = fmaf(xv, wx_f[q], x_f);
            x_g = fmaf(xv, wx_g[q], x_g);
            x_o = fmaf(xv, wx_o[q], x_o);
          }
        }
        const float z_i = (x_i + a_i[r]) + b_i;
        const float z_f = (x_f + a_f[r]) + b_f;
        const float z_g = (x_g + a_g[r]) + b_g;
        const float z_o = (x_o + a_o[r]) + b_o;
        const float c_new =
            sigmoid_f(z_f + 1.0f) * c[r] + sigmoid_f(z_i) * tanhf(z_g);
        c[r] = c_new;
        h_new[r] = sigmoid_f(z_o) * tanhf(c_new);
      }
    }
    __syncthreads();  // every thread is done reading h_s
    if (live) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) h_s[r * hs + j] = h_new[r];
    }
    __syncthreads();  // h_s holds this step's h
  }
  if (live) {
    for (int r = 0; r < kRows; ++r) {
      const int64_t row = row0 + r;
      if (row < batch) h_out[row * hidden + j] = h_s[r * hs + j];
    }
  }
}

}  // namespace

extern "C" int repro_lstm_scan_f32(const float* x, const float* wx,
                                   const float* wh, const float* b,
                                   float* h_out, int64_t batch, int64_t steps,
                                   int64_t k_in, int64_t hidden,
                                   void* stream) {
  if (batch < 1 || steps < 0 || k_in < 1 || k_in > kMaxK || hidden < 1 ||
      hidden > 1024)
    return (int)cudaErrorInvalidValue;
  const int64_t hs = (hidden + 3) & ~3;
  const int64_t floats = kRows * hs + kRows * steps * k_in;
  if (floats * 4 > 232448) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)floats;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = (int)((hidden + 31) / 32 * 32);
  const int64_t blocks = (batch + kRows - 1) / kRows;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  lstm_scan_kernel<<<(unsigned)blocks, threads, smem,
                     (cudaStream_t)stream>>>(x, wx, wh, b, h_out, batch,
                                             (int)steps, (int)k_in,
                                             (int)hidden);
  return (int)cudaGetLastError();
}
