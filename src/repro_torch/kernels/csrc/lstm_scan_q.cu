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
// 1,979 TOP/s (int8 tensor cores) to 3.35 TB/s. But the 30 steps depend on
// each other, and each step's gate chain (three sigmoids and two tanh a
// unit, a division each, on the CUDA cores and the MUFU) sets the pace:
// chip_smoke.py::lstm_q_design_floor counts it.
//
// Two routes (kernels/lstm/__init__.py::lstm_route):
//
// mma (hidden <= 128, the estimator's path). One block owns kRows = 16
// batch rows (2048 rows: 128 blocks, one an SM) and loops the T steps;
// warp w owns hidden units [8 w, 8 w + 8), 16 warps at H = 124. A step's
// product h . whq^T (16 x 4H x H) is mma.sync m16n8k32 s8 x s8 -> s32, the
// x_t product m16n8k16 (K <= 16):
//   - the warp's B fragments (4 gates x 8 units x H codes, K padded to a
//     multiple of 32 with zero codes) sit in registers for the whole scan,
//     32 a lane at H = 124; so do wxq's (4 a lane);
//   - its four n tiles are the four gates of its 8 units, so that a lane's
//     accumulators hold z_i, z_f, z_g and z_o of the same (row, unit)
//     pairs, two rows x two units: the gate chain needs no exchange, and
//     16 warps an SM (four a scheduler) hide its latencies (16 units a
//     warp in 8 warps measured 1.2x slower, PERF.md);
//   - h's codes of the last step are one 16 x (32 KS + 16)-byte tile in
//     shared memory (rows padded so that ldmatrix is conflict-free), read
//     with ldmatrix.x4 a k step;
//   - after the gates, a row's amax is a quad shuffle, then one word a warp
//     and row in shared memory, read by every thread after a barrier; the
//     new codes go into the same tile (every read of it precedes that
//     barrier), and a second barrier publishes them.
// x does not depend on h, so the tile's inputs are quantized for all T
// steps up front (codes and one scale per row and step, in shared memory);
// the scales and biases of the gate columns sit in shared memory.
//
// dp4a (hidden 129-224, the first version). As in lstm_scan.cu, thread j
// owns hidden unit j and its four gate columns; whq (4H x H) sits in shared
// memory as words of four codes, each gate row padded to an odd number of
// words so that a warp's 32 rows hit 32 banks; each step the int32 dots are
// __dp4a over the words of h's codes (broadcast) against the thread's whq
// rows, and h's row amax is a max over the block.
//
// Both: int32 sums are exact in any order, and the scale, bias and gate
// chains are written with __fmul_rn / __fadd_rn / __fdiv_rn in the plain
// version's order, the gates with expf/tanhf (no fast-math intrinsics), so
// the two routes give the same bits. The mma route takes three shortcuts
// that keep them: an exact int-to-float through the bits of 1.5 * 2^23,
// the sigmoid's 1 / d as __frcp_rn (the same correctly rounded value), and
// h's codes through the row's reciprocal scale with the division next to a
// tie (code_r).
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

// x's row `row` at step t quantized: four words of codes (zero past k_in)
// and the returned scale; past the batch, zero codes and the floor's scale
__device__ __forceinline__ float quantize_x(const float* __restrict__ x,
                                            int64_t batch, int64_t row,
                                            int t, int steps, int k_in,
                                            uint32_t (&words)[kXWords]) {
#pragma unroll
  for (int w = 0; w < kXWords; ++w) words[w] = 0u;
  if (row >= batch) return row_scale(0.0f);
  const float* xr = x + (row * steps + t) * k_in;
  float m = 0.0f;
#pragma unroll
  for (int q = 0; q < kMaxK; ++q)
    if (q < k_in) m = fmaxf(m, fabsf(xr[q]));
  const float s = row_scale(m);
#pragma unroll
  for (int q = 0; q < kMaxK; ++q)
    if (q < k_in) words[q / 4] |= code(xr[q], s) << (8 * (q % 4));
  return s;
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
    uint32_t words[kXWords];
    xs_s[i] = quantize_x(x, batch, row0 + i / steps, i % steps, steps, k_in,
                         words);
#pragma unroll
    for (int w = 0; w < kXWords; ++w) xq_s[i * kXWords + w] = words[w];
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

namespace mma {

constexpr int kUpw = 8;          // hidden units a warp
constexpr int kMaxWarps = 16;    // hidden <= 128
constexpr int kThreads = 32 * kMaxWarps;

// d += a b: a 16 x 32 s8 (row), b 32 x 8 s8 (col), d 16 x 8 s32
__device__ __forceinline__ void mma_k32(int32_t (&d)[4],
                                        const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b: a 16 x 16 s8, b 16 x 8 s8
__device__ __forceinline__ void mma_k16(int32_t (&d)[4], uint32_t a0,
                                        uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// the plain version's dequantization with acc (|acc| < 2^22: at most
// 128 x 128 x 128 here) widened through the bits of 1.5 * 2^23 + acc, exact
// as __int2float_rn, on the integer and FP32 pipes instead of the
// conversion unit
__device__ __forceinline__ float dequant_s(int32_t acc, float sa, float sw) {
  const float f = __fsub_rn(__int_as_float(0x4B400000 + acc), 12582912.0f);
  return __fmul_rn(__fmul_rn(f, sa), sw);
}

// sigmoid_f's bits: RN(1 / d) is both the division and the reciprocal
__device__ __forceinline__ float sigmoid_r(float v) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-v)));
}

// code()'s bits through the row's reciprocal scale y = RN(1 / s): the
// rounding of x * y unless it lies within 2^-13 of a half-integer, where
// the division decides (the argument of quant.cu's Coder: |x / s| <= 128,
// and x * y and RN(x / s) both lie within 2^-15 of x / s)
__device__ __forceinline__ uint32_t code_r(float x, float s, float y) {
  const float q = __fmul_rn(x, y);
  const float t = __fadd_rn(q, 12582912.0f);
  if (fabsf(__fsub_rn(q, __fsub_rn(t, 12582912.0f))) < 0.5f - 0x1p-13f)
    return (uint32_t)min(max(__float_as_int(t), 0x4B400000 - 128),
                         0x4B400000 + 127) &
           0xffu;
  return code(x, s);
}

// codes k .. k + 3 of row r of w (row-major, `cols` codes a row) as one
// word, zero past the row's end
__device__ __forceinline__ uint32_t w_word(const int8_t* __restrict__ w,
                                           int cols, int r, int k) {
  uint32_t v = 0u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (k + b < cols)
      v |= (uint32_t)(uint8_t)w[(int64_t)r * cols + k + b] << (8 * b);
  return v;
}

// KS k steps of 32 cover h's codes; kUpw units a warp
template <int KS>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_scan_q_mma(const float* __restrict__ x,
                    const int8_t* __restrict__ wxq,
                    const float* __restrict__ wxs,
                    const int8_t* __restrict__ whq,
                    const float* __restrict__ whs,
                    const float* __restrict__ bias,
                    float* __restrict__ h_out, int64_t batch, int steps,
                    int k_in, int hidden) {
  constexpr int kPitch = 32 * KS + 16;  // bytes a row of h's codes
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5, units = kUpw * warps;
  unsigned char* h_s = smem;  // (kRows, kPitch)
  float* red_s = reinterpret_cast<float*>(smem + kRows * kPitch);
  float* par_s = red_s + kMaxWarps * kRows;  // (gate, wxs / whs / b, unit)
  uint32_t* xq_s = reinterpret_cast<uint32_t*>(par_s + 12 * units);
  float* xs_s = reinterpret_cast<float*>(xq_s + steps * kRows * kXWords);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int64_t row0 = (int64_t)blockIdx.x * kRows;

  // h = 0 before the first step: all codes 0, the padding past hidden too
  for (int i = tid; i < kRows * kPitch / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(h_s)[i] = 0u;
  for (int i = tid; i < 12 * units; i += blockDim.x) {
    const int u = i % units, p = (i / units) % 3, gate = i / (3 * units);
    const float* src = p == 0 ? wxs : p == 1 ? whs : bias;
    par_s[i] = u < hidden ? src[gate * hidden + u] : 0.0f;
  }
  // the tile's inputs, quantized per row and step: (step, row, word)
  for (int i = tid; i < kRows * steps; i += blockDim.x) {
    const int r = i / steps, t = i % steps;
    uint32_t words[kXWords];
    xs_s[t * kRows + r] =
        quantize_x(x, batch, row0 + r, t, steps, k_in, words);
#pragma unroll
    for (int w = 0; w < kXWords; ++w)
      xq_s[(t * kRows + r) * kXWords + w] = words[w];
  }
  // this lane's B fragments, for the whole scan: n tile `gate` holds the
  // gate's columns of units kUpw warp + (0 .. 7), the lane's column g; zero
  // codes past hidden
  uint32_t bh[4][KS][2], bx[4];
#pragma unroll
  for (int gate = 0; gate < 4; ++gate) {
    const int u = kUpw * warp + g;
    const int r = gate * hidden + u;
    const bool ok = u < hidden;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int p = 0; p < 2; ++p)
        bh[gate][ks][p] =
            ok ? w_word(whq, hidden, r, 32 * ks + 16 * p + 4 * tq) : 0u;
    bx[gate] = ok ? w_word(wxq, k_in, r, 4 * tq) : 0u;
  }
  // the lane's (row, unit) pairs: rows g and g + 8, units
  // kUpw warp + 2 tq + e, the accumulators' element 2 row + e of each
  // gate's tile
  float c[2][2], h[2][2], sh[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sh[r] = row_scale(0.0f);
#pragma unroll
    for (int e = 0; e < 2; ++e) c[r][e] = h[r][e] = 0.0f;
  }
  // ldmatrix.x4 of a k step: lane l gives row (l & 7) + 8 ((l >> 3) & 1),
  // bytes 16 (l >> 4) on, of matrix l / 8: the A fragment of m16n8k32
  const uint32_t a_addr = (uint32_t)__cvta_generic_to_shared(h_s) +
                          ((lane & 7) + 8 * ((lane >> 3) & 1)) * kPitch +
                          16 * (lane >> 4);
  const float* par_w = par_s + kUpw * warp + 2 * tq;
  __syncthreads();  // h_s, par_s, xq_s and xs_s ready

  for (int t = 0; t < steps; ++t) {
    const uint32_t* xw = xq_s + t * kRows * kXWords;
    const uint32_t ax0 = xw[g * kXWords + tq];
    const uint32_t ax1 = xw[(g + 8) * kXWords + tq];
    const float sx[2] = {xs_s[t * kRows + g], xs_s[t * kRows + g + 8]};
    uint32_t a[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldsm_x4(a[ks], a_addr + 32 * ks);
    int32_t accx[4][4], acch[4][4];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) {
#pragma unroll
      for (int i = 0; i < 4; ++i) accx[gate][i] = acch[gate][i] = 0;
      mma_k16(accx[gate], ax0, ax1, bx[gate]);  // x_t @ wxq.T
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)  // h @ whq.T
        mma_k32(acch[gate], a[ks], bh[gate][ks][0], bh[gate][ks][1]);
    }
    float m[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ci = 2 * r + e;
        float z[4];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
          const float* pw = par_w + gate * 3 * units + e;
          z[gate] = __fadd_rn(
              __fadd_rn(dequant_s(accx[gate][ci], sx[r], pw[0]),
                        dequant_s(acch[gate][ci], sh[r], pw[units])),
              pw[2 * units]);
        }
        float& cc = c[r][e];
        cc = __fadd_rn(__fmul_rn(sigmoid_r(__fadd_rn(z[1], 1.0f)), cc),
                       __fmul_rn(sigmoid_r(z[0]), tanhf(z[2])));
        const float hv = __fmul_rn(sigmoid_r(z[3]), tanhf(cc));
        h[r][e] = hv;
        m[r] = fmaxf(m[r], fabsf(hv));
      }
    // each row's amax of the new h: the quad, then a word a warp and row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
    if (tq == 0) {
      red_s[warp * kRows + g] = m[0];
      red_s[warp * kRows + g + 8] = m[1];
    }
    __syncthreads();  // partials complete; every read of h_s is done
    // the codes of the lane's units, two adjacent a store (units past
    // hidden hold h = 0: code 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mm = 0.0f;
      for (int w = 0; w < warps; ++w)
        mm = fmaxf(mm, red_s[w * kRows + g + 8 * r]);
      sh[r] = row_scale(mm);
      const float y = __frcp_rn(sh[r]);
      *reinterpret_cast<uint16_t*>(h_s + (g + 8 * r) * kPitch + kUpw * warp +
                                   2 * tq) =
          (uint16_t)(code_r(h[r][0], sh[r], y) |
                     (code_r(h[r][1], sh[r], y) << 8));
    }
    __syncthreads();  // h_s holds this step's codes
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = row0 + g + 8 * r;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int u = kUpw * warp + 2 * tq + e;
      if (row < batch && u < hidden) h_out[row * hidden + u] = h[r][e];
    }
  }
}

template <int KS>
int launch(const float* x, const int8_t* wxq, const float* wxs,
           const int8_t* whq, const float* whs, const float* b, float* h_out,
           int64_t batch, int steps, int k_in, int hidden, size_t smem,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_scan_q_mma<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (batch + kRows - 1) / kRows;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  lstm_scan_q_mma<KS><<<(unsigned)blocks, 32 * ((hidden + kUpw - 1) / kUpw),
                        smem, stream>>>(x, wxq, wxs, whq, whs, b, h_out,
                                        batch, steps, k_in, hidden);
  return (int)cudaGetLastError();
}

}  // namespace mma

}  // namespace

// The dp4a route: hidden 1-1024 (the wrapper sends it 129-224).
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

// The mma route: hidden 1-128.
extern "C" int repro_lstm_scan_q_s8_mma(const float* x, const int8_t* wxq,
                                        const float* wxs, const int8_t* whq,
                                        const float* whs, const float* b,
                                        float* h_out, int64_t batch,
                                        int64_t steps, int64_t k_in,
                                        int64_t hidden, void* stream) {
  if (batch < 1 || steps < 0 || steps > 0x7fffffff || k_in < 1 ||
      k_in > kMaxK || hidden < 1 || hidden > mma::kUpw * mma::kMaxWarps)
    return (int)cudaErrorInvalidValue;
  const int64_t ks = (hidden + 31) / 32;
  const int64_t units = mma::kUpw * ((hidden + mma::kUpw - 1) / mma::kUpw);
  const int64_t smem = kRows * (32 * ks + 16) +
                       4 * (mma::kMaxWarps * kRows + 12 * units) +
                       4 * steps * kRows * (kXWords + 1);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (ks) {
#define MMA_CASE(KS)                                                      \
  case KS:                                                                \
    return mma::launch<KS>(x, wxq, wxs, whq, whs, b, h_out, batch,        \
                           (int)steps, (int)k_in, (int)hidden, (size_t)smem, \
                           s);
    MMA_CASE(1) MMA_CASE(2) MMA_CASE(3) MMA_CASE(4)
#undef MMA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
