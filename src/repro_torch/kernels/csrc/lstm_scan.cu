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
// 67 TFLOP/s (FP32, no tensor cores) to 3.35 TB/s. The recurrence stays on
// the FP32 CUDA cores: split into bf16 pieces for the tensor cores, its 30
// dependent steps amplify the extra roundings past the kernel's tolerance
// (1e-4 relative, 1e-5 absolute, of the plain version).
//
// Both routes sum in f32 FMAs in the same order: x_t @ wx and h @ wh
// apart, each over its inputs in order, then (x-part + h-part) + b; the
// gate chain (`cell`) rounds each product and sum once, as the plain
// version's separate torch ops do, with expf/tanhf and a correctly rounded
// reciprocal (no fast-math intrinsics). So the two routes give the same
// bits where both apply.
//
// Two routes (kernels/lstm/__init__.py::lstm_scan_route):
//
// cluster (hidden <= 128, the estimator's path). The TPU kernel keeps wx,
// wh and (h, c) in VMEM for all T steps; wh alone is 124 * 496 * 4 =
// 246,016 B at H = 124, more than a block's 232,448 B of shared memory. So
// a cluster of two blocks on neighbouring SMs holds it:
//   - block c owns the hidden units [c P, c P + P), P = ceil(H / 2), and
//     their four gate columns each, so that its gate chain needs no
//     exchange; its slice of wh (123 KB at H = 124) and of wx sits in
//     shared memory for the whole scan, laid out [input][unit][gate] so
//     that one 16-byte load gives a unit's four gates;
//   - a cluster owns 32 batch rows (2048 rows: 64 clusters, 128 blocks, one
//     an SM); a block has 512 threads, 16 warps: thread i owns unit i % 64
//     of the block and rows 4 (i / 64) .. + 3, all four gates of each, 16
//     sums, so a warp's lanes share their rows;
//   - each step's h @ wh slice is a micro-tile in registers: per hidden
//     input, one 16-byte load of the lane's four rows of h (kept
//     transposed, [input][row], so one word for the whole warp) and one of
//     its unit's four weights feed 16 FMAs, the next input's loads issued
//     before them. On the H100 the product takes about 110 clocks an
//     input at 16 warps (an SM's FP32 lanes need 64): a warp's 16-byte
//     shared load appears to cost four wavefronts whether its lanes share
//     the words or not, and more sums a lane (8 rows, or 8 x 2 units at 4
//     warps) measured the same or slower, as fewer warps leave the FMA and
//     load latencies bare (PERF.md);
//   - after its gates, a block writes its units' h for the 32 rows into
//     its own next h buffer and its peer's (distributed shared memory).
//     The buffers are double-buffered, and a step ends in one cluster
//     barrier: the arrival right after the writes (release), the wait
//     before the next step's product (acquire), and between the two the
//     next step's x_t @ wx, which does not depend on h;
//   - x is streamed: at step t thread i loads feature i % 16 of row i / 16
//     of x_{t+2} and stores it into a ring of three slots after the
//     product; the slot is read in step t+1's window, after the barrier of
//     step t has published it, and rewritten in step t+3, after the
//     barrier of step t+2 that every reader has passed. The window's
//     x_t @ wx goes through the product's own registers into a per-thread
//     spot of shared memory, read back by the gates.
//
// block (hidden 129-1024, the first version). One block owns 16 batch
// rows and loops the T steps with __syncthreads() between them: thread j
// owns hidden unit j and its four gate columns for the 16 rows; the tile's
// input and h sit in shared memory; wh is read through L1/L2, each weight
// feeding 16 rows' multiply-adds.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 16;  // input features

__device__ __forceinline__ float sigmoid_f(float v) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-v)));
}

// one cell update from the pre-activations: the new h; c updated in place
__device__ __forceinline__ float cell(float z_i, float z_f, float z_g,
                                      float z_o, float& c) {
  const float cn = __fadd_rn(__fmul_rn(sigmoid_f(__fadd_rn(z_f, 1.0f)), c),
                             __fmul_rn(sigmoid_f(z_i), tanhf(z_g)));
  c = cn;
  return __fmul_rn(sigmoid_f(z_o), tanhf(cn));
}

namespace cl {  // the cluster route

constexpr int kCluster = 2;     // blocks a cluster
constexpr int kRows = 32;       // batch rows a cluster
constexpr int kUnits = 64;      // hidden units a block, padded
constexpr int kSlots = 3;       // the x_t ring
constexpr int kMaxHidden = kCluster * kUnits;
// the lane's tile: 4 rows x 1 unit, 512 threads (a sweep of 4 x 1, 8 x 1,
// 4 x 2, 8 x 2 and 16 x 1 on the H100 found it the fastest)
constexpr int kLaneRows = 4, kLaneUnits = 1;
constexpr int kThreads = (kRows / kLaneRows) * (kUnits / kLaneUnits);

// shared-memory floats: wh's and wx's slices, two h buffers, the x ring,
// and each thread's x_t @ wx of the coming step
int64_t smem_floats(int64_t hidden, int64_t k_in) {
  return (hidden + k_in) * kUnits * 4 + 2 * hidden * kRows +
         kSlots * kMaxK * kRows + kRows * kUnits * 4;
}

// acc[r][u][g] += in[r] * w[u][g] for a lane's RT rows, UT units, 4 gates
template <int RT, int UT>
__device__ __forceinline__ void tile_fma(float (&acc)[RT][UT][4],
                                         const float4 (&hv)[RT / 4],
                                         const float4 (&wv)[UT]) {
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const float4 h4 = hv[r / 4];
    const float in = r % 4 == 0 ? h4.x : r % 4 == 1 ? h4.y
                     : r % 4 == 2 ? h4.z : h4.w;
#pragma unroll
    for (int u = 0; u < UT; ++u) {
      acc[r][u][0] = fmaf(in, wv[u].x, acc[r][u][0]);
      acc[r][u][1] = fmaf(in, wv[u].y, acc[r][u][1]);
      acc[r][u][2] = fmaf(in, wv[u].z, acc[r][u][2]);
      acc[r][u][3] = fmaf(in, wv[u].w, acc[r][u][3]);
    }
  }
}

// acc = in @ w over `depth` inputs in order: in [depth][kRows] from `hp`
// (the lane's rows), w [depth][kUnits][4] from `wp` (its units' gates);
// the next input's 16-byte loads are issued before this one's FMAs (the
// load one past the end stays inside shared memory, unused)
template <int RT, int UT>
__device__ __forceinline__ void tile_product(float (&acc)[RT][UT][4],
                                             const float* hp, const float* wp,
                                             int depth) {
  constexpr int UL = kUnits / UT;
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int u = 0; u < UT; ++u)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[r][u][g] = 0.0f;
  float4 hv[RT / 4], wv[UT];
  auto load = [&](int k, float4 (&h)[RT / 4], float4 (&w)[UT]) {
#pragma unroll
    for (int r = 0; r < RT / 4; ++r)
      h[r] = *reinterpret_cast<const float4*>(hp + k * kRows + 4 * r);
#pragma unroll
    for (int u = 0; u < UT; ++u)
      w[u] = *reinterpret_cast<const float4*>(wp + (k * kUnits + UL * u) * 4);
  };
  load(0, hv, wv);
#pragma unroll 2
  for (int k = 0; k < depth; ++k) {
    float4 hn[RT / 4], wn[UT];
    load(k + 1, hn, wn);
    tile_fma<RT, UT>(acc, hv, wv);
#pragma unroll
    for (int r = 0; r < RT / 4; ++r) hv[r] = hn[r];
#pragma unroll
    for (int u = 0; u < UT; ++u) wv[u] = wn[u];
  }
}

// RT rows x UT units a lane: (kRows / RT) x (kUnits / UT) threads
template <int RT, int UT>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__((kRows / RT) * (kUnits / UT), 1)
    lstm_scan_cluster(const float* __restrict__ x,
                      const float* __restrict__ wx,
                      const float* __restrict__ wh,
                      const float* __restrict__ bias,
                      float* __restrict__ h_out, int64_t batch, int steps,
                      int k_in, int hidden) {
  constexpr int UL = kUnits / UT;              // lanes along the units
  constexpr int NT = (kRows / RT) * UL;        // threads
  constexpr int XF = kRows * kMaxK / NT;       // x values a thread loads
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                           // [hidden][kUnits][4]
  float* wx_s = w_s + hidden * kUnits * 4;     // [k_in][kUnits][4]
  float* h_s = wx_s + k_in * kUnits * 4;       // [2][hidden][kRows]
  float* x_s = h_s + 2 * hidden * kRows;       // [kSlots][kMaxK][kRows]
  // each thread's x_t @ wx of the coming step, its own float4s
  float4* xz = reinterpret_cast<float4*>(x_s + kSlots * kMaxK * kRows);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int per = (hidden + 1) / 2;
  const int u0 = rank * per;                   // the block's first unit
  const int nu = min(per, hidden - u0);        // and how many it owns
  const int gates = 4 * hidden;
  const int64_t row0 = (int64_t)(blockIdx.x / kCluster) * kRows;
  const int tid = threadIdx.x;
  const int ul = tid % UL;                     // units ul + UL u
  const int r0 = (tid / UL) * RT;              // rows r0 .. r0 + RT - 1

  // the slices of wh and wx, [input][unit][gate], zero past the block's
  // units; the global reads run along the units of a gate
  for (int i = tid; i < hidden * kUnits * 4; i += NT) {
    const int uu = i & (kUnits - 1), g = (i >> 6) & 3, k = i >> 8;
    w_s[(k * kUnits + uu) * 4 + g] =
        uu < nu ? wh[(int64_t)k * gates + g * hidden + u0 + uu] : 0.0f;
  }
  for (int i = tid; i < k_in * kUnits * 4; i += NT) {
    const int uu = i & (kUnits - 1), g = (i >> 6) & 3, q = i >> 8;
    wx_s[(q * kUnits + uu) * 4 + g] =
        uu < nu ? wx[q * gates + g * hidden + u0 + uu] : 0.0f;
  }
  for (int i = tid; i < hidden * kRows; i += NT) h_s[i] = 0.0f;
  // this thread's values of each step's x: row xr, features XF xj ..
  const int xr = tid / (kMaxK / XF), xj = tid % (kMaxK / XF);
  const bool xvalid = row0 + xr < batch;
  const float* xp =
      x + (xvalid ? (row0 + xr) * (int64_t)steps * k_in : 0) + XF * xj;
  float* xslot = x_s + XF * xj * kRows + xr;
  auto x_fetch = [&](int t, float (&v)[XF]) {
#pragma unroll
    for (int e = 0; e < XF; ++e)
      v[e] = xvalid && XF * xj + e < k_in ? __ldg(xp + (int64_t)t * k_in + e)
                                          : 0.0f;
  };
  auto x_store = [&](int t, const float (&v)[XF]) {
#pragma unroll
    for (int e = 0; e < XF; ++e)
      if (XF * xj + e < k_in)
        xslot[(t % kSlots) * kMaxK * kRows + e * kRows] = v[e];
  };
  for (int t = 0; t < 2 && t < steps; ++t) {
    float v[XF];
    x_fetch(t, v);
    x_store(t, v);
  }
  float b[UT][4];
#pragma unroll
  for (int u = 0; u < UT; ++u)
#pragma unroll
    for (int g = 0; g < 4; ++g)
      b[u][g] = ul + UL * u < nu ? bias[g * hidden + u0 + ul + UL * u] : 0.0f;
  cluster.sync();  // slices, zero h and x_0, x_1 in place; the peer runs

  float a[RT][UT][4];  // a step's h @ wh, in the window its x_t @ wx
  auto x_part = [&](int slot) {
    tile_product<RT, UT>(a, x_s + slot * kMaxK * kRows + r0, wx_s + ul * 4,
                         k_in);
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int u = 0; u < UT; ++u)
        xz[(r * UT + u) * NT + tid] =
            make_float4(a[r][u][0], a[r][u][1], a[r][u][2], a[r][u][3]);
  };
  if (steps > 0) x_part(0);
  float c[RT][UT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int u = 0; u < UT; ++u) c[r][u] = 0.0f;
  for (int t = 0; t < steps; ++t) {
    const bool xnext = t + 2 < steps;
    float xn[XF];
    if (xnext) x_fetch(t + 2, xn);
    // h @ wh, the inputs in order
    tile_product<RT, UT>(a, h_s + (t & 1) * hidden * kRows + r0,
                         w_s + ul * 4, hidden);
    // the gates; this step's h of the block's units, here and at the peer
    float* hn = h_s + ((t + 1) & 1) * hidden * kRows + (u0 + ul) * kRows + r0;
#pragma unroll
    for (int u = 0; u < UT; ++u) {
      float hv[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 xv = xz[(r * UT + u) * NT + tid];
        hv[r] = cell(__fadd_rn(__fadd_rn(xv.x, a[r][u][0]), b[u][0]),
                     __fadd_rn(__fadd_rn(xv.y, a[r][u][1]), b[u][1]),
                     __fadd_rn(__fadd_rn(xv.z, a[r][u][2]), b[u][2]),
                     __fadd_rn(__fadd_rn(xv.w, a[r][u][3]), b[u][3]),
                     c[r][u]);
      }
      if (ul + UL * u >= nu) continue;
      float* dst = hn + UL * u * kRows;
      float* peer = cluster.map_shared_rank(dst, rank ^ 1);
#pragma unroll
      for (int r = 0; r < RT; r += 4) {
        const float4 v = make_float4(hv[r], hv[r + 1], hv[r + 2], hv[r + 3]);
        *reinterpret_cast<float4*>(dst + r) = v;
        *reinterpret_cast<float4*>(peer + r) = v;
      }
    }
    if (xnext) x_store(t + 2, xn);
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    if (t + 1 < steps) x_part((t + 1) % kSlots);
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
  // the last step's h, from the buffer the last barrier published
  const float* hf = h_s + (steps & 1) * hidden * kRows;
#pragma unroll
  for (int u = 0; u < UT; ++u) {
    const int unit = ul + UL * u;
    if (unit >= nu) continue;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const int64_t row = row0 + r0 + r;
      if (row < batch)
        h_out[row * hidden + u0 + unit] = hf[(u0 + unit) * kRows + r0 + r];
    }
  }
}
}  // namespace cl

namespace blk {  // the block route

constexpr int kRows = 16;  // batch rows per block

__global__ void lstm_scan_block(const float* __restrict__ x,
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
        h_new[r] = cell(__fadd_rn(__fadd_rn(x_i, a_i[r]), b_i),
                        __fadd_rn(__fadd_rn(x_f, a_f[r]), b_f),
                        __fadd_rn(__fadd_rn(x_g, a_g[r]), b_g),
                        __fadd_rn(__fadd_rn(x_o, a_o[r]), b_o), c[r]);
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

}  // namespace blk

bool bad_args(int64_t batch, int64_t steps, int64_t k_in, int64_t hidden,
              int64_t max_hidden) {
  return batch < 1 || steps < 0 || steps > 0x7fffffff || k_in < 1 ||
         k_in > kMaxK || hidden < 1 || hidden > max_hidden;
}

}  // namespace

extern "C" int repro_lstm_scan_f32_cluster(const float* x, const float* wx,
                                           const float* wh, const float* b,
                                           float* h_out, int64_t batch,
                                           int64_t steps, int64_t k_in,
                                           int64_t hidden, void* stream) {
  if (bad_args(batch, steps, k_in, hidden, cl::kMaxHidden))
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (batch + cl::kRows - 1) / cl::kRows;
  if (tiles * cl::kCluster > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)cl::smem_floats(hidden, k_in);
  const auto kernel = cl::lstm_scan_cluster<cl::kLaneRows, cl::kLaneUnits>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(tiles * cl::kCluster), cl::kThreads, smem,
           (cudaStream_t)stream>>>(
      x, wx, wh, b, h_out, batch, (int)steps, (int)k_in, (int)hidden);
  return (int)cudaGetLastError();
}

extern "C" int repro_lstm_scan_f32(const float* x, const float* wx,
                                   const float* wh, const float* b,
                                   float* h_out, int64_t batch, int64_t steps,
                                   int64_t k_in, int64_t hidden,
                                   void* stream) {
  if (bad_args(batch, steps, k_in, hidden, 1024))
    return (int)cudaErrorInvalidValue;
  const int64_t hs = (hidden + 3) & ~3;
  const int64_t floats = blk::kRows * hs + blk::kRows * steps * k_in;
  if (floats * 4 > 232448) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)floats;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blk::lstm_scan_block, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = (int)((hidden + 31) / 32 * 32);
  const int64_t blocks = (batch + blk::kRows - 1) / blk::kRows;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  blk::lstm_scan_block<<<(unsigned)blocks, threads, smem,
                         (cudaStream_t)stream>>>(x, wx, wh, b, h_out, batch,
                                                 (int)steps, (int)k_in,
                                                 (int)hidden);
  return (int)cudaGetLastError();
}
