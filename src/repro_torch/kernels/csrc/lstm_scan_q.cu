// int8 serving LSTM scan: the throughput estimator's temporal branch with
// int8 weights. Returns the final hidden state of a T-step LSTM with gates
// i, f, g, o, one bias and +1.0 on the forget pre-activation, where each
// step quantizes x_t and h per row (the rowwise symmetric formula of
// quant.cu) and multiplies them, int8 x int8 -> int32, with weights
// quantized rowwise per output channel:
//   z = acc(x_t, wxq) * sx * wxs + acc(h, whq) * sh * whs + b
//   c = sigmoid(z_f + 1) * c + sigmoid(z_i) * tanh(z_g)
//   h = sigmoid(z_o) * tanh(c)
//
// Replaces the TPU kernel src/repro/kernels/lstm/kernel.py::lstm_scan_q.
//
// Bound on the H100: operations. At the estimator's width (K = 15,
// H = 124, T = 30) a row costs 30 * 2 * 496 * (15 + 124) = 4.1 M int8
// operations against 1.8 KB of f32 input, far above the card's ratio of
// 1,979 TOP/s (int8 tensor cores) to 3.35 TB/s. The 30 sequential steps
// make a simple kernel latency-bound well above that bound.
//
// Design. As in lstm_scan.cu, one block owns kRows batch rows and loops the
// T steps itself, and thread j owns hidden unit j and its four gate
// columns j, H+j, 2H+j, 3H+j, so the gate chain needs no exchange between
// threads. What int8 allows that fp32 did not: whq (4H x H = 61.5 KB at
// H = 124) fits in shared memory, where the f32 wh (246 KB) did not, so
// all weights stay on chip for the whole scan, as in the TPU kernel's VMEM:
//   - whq is staged once as 32-bit words of four codes, each gate row
//     padded to an odd number of words so that the 32 threads of a warp,
//     reading 32 different rows, hit 32 different banks;
//   - x does not depend on h, so the tile's inputs are quantized for all
//     T steps up front (codes and one scale per row and step, in shared
//     memory); each thread keeps its four gate columns of wxq (K <= 16
//     codes, four words a gate) in registers;
//   - each step, the int32 dots are __dp4a over the words of h's codes
//     (broadcast from shared memory) against the thread's whq rows; then
//     h's row amax is a max over the block (warp shuffles, then one word a
//     warp in shared memory), and each thread writes the code of its own
//     unit for every row.
// The scale, bias and gate chains are written with __fmul_rn / __fadd_rn /
// __fdiv_rn in the plain version's order, and the gates use expf/tanhf
// (no fast-math intrinsics). Tensor-core int8 (mma.sync) and more rows a
// block are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;           // batch rows per block
constexpr int kMaxK = 16;           // input features
constexpr int kXWords = kMaxK / 4;  // words of x codes a row and step

__device__ __forceinline__ float row_scale(float amax) {
  const float floor = 1e-8f;
  return __fmul_rn(amax < floor ? floor : amax, (float)(1.0 / 127.0));
}

__device__ __forceinline__ uint32_t code(float x, float scale) {
  const float v = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -128.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)__float2int_rn(v);
}

__device__ __forceinline__ float dequant(int32_t acc, float sa, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), sw);
}

__device__ __forceinline__ float sigmoid_f(float v) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
}

__global__ void lstm_scan_q_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ wxq,
    const float* __restrict__ wxs, const int8_t* __restrict__ whq,
    const float* __restrict__ whs, const float* __restrict__ bias,
    float* __restrict__ h_out, int64_t batch, int steps, int k_in,
    int hidden) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int gates = 4 * hidden;
  const int hw = (hidden + 3) / 4;  // words of one row of h's codes
  const int hwp = hw | 1;           // odd word stride of a whq row
  uint32_t* wh_s = smem;                         // (gates, hwp)
  uint32_t* hq_s = wh_s + gates * hwp;           // (kRows, hw)
  uint32_t* xq_s = hq_s + kRows * hw;            // (kRows, steps, kXWords)
  float* xs_s = reinterpret_cast<float*>(xq_s + kRows * steps * kXWords);
  float* red_s = xs_s + kRows * steps;           // (warps, kRows)
  const int j = threadIdx.x;
  const int lane = j & 31, warp = j >> 5, warps = blockDim.x >> 5;
  const bool live = j < hidden;
  const int64_t row0 = (int64_t)blockIdx.x * kRows;

  // whq -> shared memory, four codes a word, rows zero-padded
  for (int i = threadIdx.x; i < gates * hwp; i += blockDim.x) {
    const int r = i / hwp, w = i % hwp;
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = 4 * w + b;
      if (c < hidden) v |= (uint32_t)(uint8_t)whq[(int64_t)r * hidden + c]
                           << (8 * b);
    }
    wh_s[i] = v;
  }
  // the tile's inputs, quantized per row and step
  for (int i = threadIdx.x; i < kRows * steps; i += blockDim.x) {
    const int64_t row = row0 + i / steps;
    uint32_t words[kXWords] = {0u, 0u, 0u, 0u};
    float s = row_scale(0.0f);
    if (row < batch) {
      const float* xr = x + (row * steps + i % steps) * k_in;
      float m = 0.0f;
#pragma unroll
      for (int q = 0; q < kMaxK; ++q)
        if (q < k_in) m = fmaxf(m, fabsf(xr[q]));
      s = row_scale(m);
#pragma unroll
      for (int q = 0; q < kMaxK; ++q)
        if (q < k_in) words[q / 4] |= code(xr[q], s) << (8 * (q % 4));
    }
#pragma unroll
    for (int w = 0; w < kXWords; ++w) xq_s[i * kXWords + w] = words[w];
    xs_s[i] = s;
  }
  // h = 0 before the first step: all codes 0
  for (int i = threadIdx.x; i < kRows * hw; i += blockDim.x) hq_s[i] = 0u;

  // this thread's four gate columns: wxq codes, scales, bias
  uint32_t wx_w[4][kXWords];
  float wxs_g[4], whs_g[4], b_g[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const int col = g * hidden + (live ? j : 0);
#pragma unroll
    for (int w = 0; w < kXWords; ++w) {
      uint32_t v = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int q = 4 * w + b;
        if (live && q < k_in)
          v |= (uint32_t)(uint8_t)wxq[(int64_t)col * k_in + q] << (8 * b);
      }
      wx_w[g][w] = v;
    }
    wxs_g[g] = live ? wxs[col] : 0.0f;
    whs_g[g] = live ? whs[col] : 0.0f;
    b_g[g] = live ? bias[col] : 0.0f;
  }
  float c[kRows], h[kRows], sh[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    c[r] = 0.0f;
    h[r] = 0.0f;
    sh[r] = row_scale(0.0f);
  }
  const uint32_t* wh_j = wh_s + (live ? j : 0) * hwp;
  const int gate_stride = hidden * hwp;  // words from gate g's row to g+1's
  __syncthreads();  // wh_s, xq_s, xs_s and hq_s ready

  for (int t = 0; t < steps; ++t) {
    if (live) {
      int32_t acc[kRows][4];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0;
      for (int w = 0; w < hw; ++w) {  // h @ whq.T, four codes a word
        const int w0 = (int)wh_j[w];
        const int w1 = (int)wh_j[gate_stride + w];
        const int w2 = (int)wh_j[2 * gate_stride + w];
        const int w3 = (int)wh_j[3 * gate_stride + w];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int hv = (int)hq_s[r * hw + w];
          acc[r][0] = __dp4a(hv, w0, acc[r][0]);
          acc[r][1] = __dp4a(hv, w1, acc[r][1]);
          acc[r][2] = __dp4a(hv, w2, acc[r][2]);
          acc[r][3] = __dp4a(hv, w3, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const uint32_t* xw = xq_s + (r * steps + t) * kXWords;
        const float sx = xs_s[r * steps + t];
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          int32_t ax = 0;  // x_t @ wxq.T
#pragma unroll
          for (int w = 0; w < kXWords; ++w)
            ax = __dp4a((int)xw[w], (int)wx_w[g][w], ax);
          z[g] = __fadd_rn(__fadd_rn(dequant(ax, sx, wxs_g[g]),
                                     dequant(acc[r][g], sh[r], whs_g[g])),
                           b_g[g]);
        }
        c[r] = __fadd_rn(__fmul_rn(sigmoid_f(__fadd_rn(z[1], 1.0f)), c[r]),
                         __fmul_rn(sigmoid_f(z[0]), tanhf(z[2])));
        h[r] = __fmul_rn(sigmoid_f(z[3]), tanhf(c[r]));
      }
    }
    // each row's amax of the new h over the block
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float m = live ? fabsf(h[r]) : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) red_s[warp * kRows + r] = m;
    }
    __syncthreads();  // every thread is done reading hq_s; red_s complete
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float m = 0.0f;
      for (int w = 0; w < warps; ++w) m = fmaxf(m, red_s[w * kRows + r]);
      sh[r] = row_scale(m);
    }
    if (j < 4 * hw) {  // byte j of each row's codes; the padding stays 0
      uint8_t* hb = reinterpret_cast<uint8_t*>(hq_s);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        hb[r * 4 * hw + j] = live ? (uint8_t)code(h[r], sh[r]) : (uint8_t)0;
    }
    __syncthreads();  // hq_s holds this step's codes
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t row = row0 + r;
      if (row < batch) h_out[row * hidden + j] = h[r];
    }
  }
}

}  // namespace

extern "C" int repro_lstm_scan_q_s8(const float* x, const int8_t* wxq,
                                    const float* wxs, const int8_t* whq,
                                    const float* whs, const float* b,
                                    float* h_out, int64_t batch,
                                    int64_t steps, int64_t k_in,
                                    int64_t hidden, void* stream) {
  if (batch < 1 || steps < 0 || steps > 0x7fffffff || k_in < 1 ||
      k_in > kMaxK || hidden < 1 || hidden > 1024)
    return (int)cudaErrorInvalidValue;
  const int64_t hw = (hidden + 3) / 4, hwp = hw | 1;
  const int threads = (int)((hidden + 31) / 32 * 32);
  const int64_t words = 4 * hidden * hwp + kRows * hw +
                        kRows * steps * (kXWords + 1) +
                        (int64_t)(threads / 32) * kRows;
  if (words * 4 > 232448) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)words;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_scan_q_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (batch + kRows - 1) / kRows;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  lstm_scan_q_kernel<<<(unsigned)blocks, threads, smem,
                       (cudaStream_t)stream>>>(x, wxq, wxs, whq, whs, b,
                                               h_out, batch, (int)steps,
                                               (int)k_in, (int)hidden);
  return (int)cudaGetLastError();
}
