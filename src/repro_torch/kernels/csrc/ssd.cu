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
// row and loops over its chunks itself, with the carried state in shared
// memory for the whole sequence. Two instances of that design, chosen by
// the C entry (the route stays "fused", one launch a call):
//
// The compile-time instances (namespace fz; (hpg, hd, N) = (4, 8, 8), the
// recurrent estimator's, (4, 16, 8) and (4, 32, 16); x, B, C, y and the
// state on 16 bytes; the working set in one block's shared memory). A
// block of 4 warps, every index a division by a constant. Per chunk, with
// a barrier after each of the first two phases:
//   0. dt, B, C and x in one round trip of cp.async into one buffer: 26 KB
//      a block at the cells call, so 8 blocks (32 warps) an SM and one
//      wave of the 1024 rows, the other blocks' work covering a block's
//      loads (a second buffer, to load the next chunk during this one,
//      measured 18% slower on the H100: 5 blocks an SM);
//   1. lcum by a warp a head, one lane summing the steps in order (the
//      plain version's cumsum order: a shuffle scan of runs, in another
//      order, measured 2-3 times the plain version's 3.8e-5 error on y at
//      the cells call), the end decays exp(lcum[L-1] - lcum[t]), and
//      dt * x in place of x;
//   2. y: a slot is 32 / hpg consecutive t, and lane (o, h) of a warp owns
//      y[t, h, :] of the slot's t = o-th. Slots pair as (i, slots - 1 - i),
//      so that every warp walks the same number of (t, s) steps of the
//      triangle. For its slot a warp first writes the slot's rows of C.B
//      (s <= t only) into its own shared rows, then each lane runs s up to
//      t: one exp a (t, s, h), hd multiply-adds on dt * x[s, h, :]; below
//      the slot's first t no lane masks, and that loop is unrolled. Then
//      the state term C[t] . state * exp(lcum[t]) and y as 16-byte stores;
//   3. the state update, thread (h, d) over its N values, into the second
//      of two state buffers, so that it needs no barrier after phase 2;
//      the next chunk's first barrier publishes it.
// (A layout with four t a lane, so that one load of dt * x[s, h, :] feeds
// four exps, measured 30% slower: its lanes' four masks serialize the
// loop.)
//
// The generic instance (every other shape route() sends here): 256
// threads, runtime shapes; phases with a barrier after each:
//   1. load dt, B, C; then dt * x and, one thread a head, the cumsum;
//      C.B on the lower triangle;
//   2. thread (t, h): y[t, h, :] in registers, the intra-chunk sum over
//      s <= t with one exp a (t, s, h), then the state term; the end
//      decay exp(lcum[L-1] - lcum[t]);
//   3. thread (h, d, n): the state update.
// A chunk's working set sits in shared memory: dt, lcum and the end decays
// (L x hpg each), B and C (L x N each), dt * x (L x hpg x hd), the lower
// triangle of C.B (L (L + 1) / 2, packed by rows) and the state. Limits
// (route()): the generic working set must fit a block's 227 KB of shared
// memory, 4 * (3 L hpg + 2 L N + L hpg hd + L (L + 1) / 2 + hpg hd N)
// bytes; with L = 256 that leaves room for hpg * hd up to about 120. An
// instance takes a shape only where its own working set fits as well
// (kernels/ssd::fused_instance mirrors the choice).
//
// Both keep the order of the plain version's sums where it has one: C.B
// and the state term over n, the intra-chunk sum over s, the state update
// over t, each an FMA chain from 0; y's two terms and the state's decay
// rounded as the plain version's separate products and sums.
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



namespace fz {  // the compile-time instances

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

__host__ __device__ constexpr int64_t up4(int64_t v) { return (v + 3) & ~3; }

template <int HPG, int HD, int N>
struct Shape {
  static_assert(32 % HPG == 0 && HD % 4 == 0 && N % 4 == 0, "an instance");
  static constexpr int TS = 32 / HPG;      // t of a slot: lane (o, h)
  static constexpr int XW = HPG * HD;      // x (and y) values of a step
  static constexpr int SW = HPG * HD * N;  // state values
  // shared-memory floats at chunk L: dt | B | C | x (then dt * x), lcum
  // and the end decays, each warp's C.B rows of a slot, two states
  __host__ __device__ static constexpr int64_t floats(int64_t L) {
    return up4(L * HPG) + 2 * L * N + L * XW + 2 * up4(L * HPG) +
           kWarps * L * TS + 2 * SW;
  }
};

template <int HPG, int HD, int N>
__global__ void __launch_bounds__(kThreads)
    ssd_fused(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ a, const float* __restrict__ bm,
              const float* __restrict__ cm, float* __restrict__ y,
              float* __restrict__ state_out, int64_t seqlen, int groups,
              int L) {
  using S = Shape<HPG, HD, N>;
  constexpr int TS = S::TS, XW = S::XW, SW = S::SW;
  extern __shared__ __align__(16) float smem[];
  const int lp = (int)up4(L * HPG);
  float* dts = smem;                   // (L, HPG) dt
  float* bs = dts + lp;                // (L, N)
  float* cs = bs + L * N;              // (L, N)
  float* du = cs + L * N;              // (L, HPG, HD) x, then dt * x
  float* lc = du + L * XW;             // (L, HPG) cumulative dt * A
  float* sd = lc + lp;                 // (L, HPG) exp(lcum[L-1] - lcum[t])
  float* cbw = sd + lp;                // a warp's (L, TS) C.B rows, [s][o]
  float* st = cbw + kWarps * L * TS;   // two (HPG, HD, N) states
  const int nh = groups * HPG;
  const int64_t bid = blockIdx.x;
  const int64_t b = bid / groups;
  const int g = (int)(bid - b * groups);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int o = lane % TS, h = lane / TS;  // phase 2's lane: (t, head)
  float* cbs = cbw + warp * L * TS;
  const int n_chunks = (int)(seqlen / L);

  for (int i = tid; i < SW; i += kThreads) st[i] = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const int64_t r0 = b * seqlen + (int64_t)c * L;  // (b, s) of t = 0
    const float* sc = st + (c & 1) * SW;  // the state entering the chunk
    float* sn = st + ((c + 1) & 1) * SW;  // and leaving it
    __syncthreads();  // every thread is done with chunk c - 1's inputs

    // 0. the chunk's dt, B, C and x: one round trip of cp.async
    for (int i = tid; i < L * (XW / 4); i += kThreads) {
      const int t = i / (XW / 4), j = i - t * (XW / 4);
      cp_async16(du + t * XW + 4 * j,
                 x + ((r0 + t) * nh + g * HPG) * HD + 4 * j);
    }
    for (int i = tid; i < L * (N / 4); i += kThreads) {
      const int t = i / (N / 4), j = i - t * (N / 4);
      const int64_t off = ((r0 + t) * groups + g) * N + 4 * j;
      cp_async16(bs + t * N + 4 * j, bm + off);
      cp_async16(cs + t * N + 4 * j, cm + off);
    }
    for (int i = tid; i < L * HPG; i += kThreads) {
      const int t = i / HPG, hh = i - t * HPG;
      cp_async4(dts + i, dt + (r0 + t) * nh + g * HPG + hh);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // 1. lcum, a warp a head, summed in order by one lane as the plain
    //    version's cumsum does; the end decays; dt * x in place
    for (int hh = warp; hh < HPG; hh += kWarps) {
      if (lane == 0) {  // 16 steps' loads ahead of their dependent adds
        const float ah = a[g * HPG + hh];
        float run = 0.0f;
        for (int t0 = 0; t0 < L; t0 += 16) {
          float da[16];
#pragma unroll
          for (int j = 0; j < 16; ++j)
            da[j] = t0 + j < L ? __fmul_rn(dts[(t0 + j) * HPG + hh], ah)
                               : 0.0f;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            run = __fadd_rn(run, da[j]);
            if (t0 + j < L) lc[(t0 + j) * HPG + hh] = run;
          }
        }
      }
      __syncwarp();
      const float lend = lc[(L - 1) * HPG + hh];
      for (int t = lane; t < L; t += 32)
        sd[t * HPG + hh] = expf(lend - lc[t * HPG + hh]);
    }
    for (int i = 4 * tid; i < L * XW; i += 4 * kThreads) {
      const int t = i / XW, hh = (i - t * XW) / HD;
      const float d = dts[t * HPG + hh];
      float4 v = *reinterpret_cast<float4*>(du + i);
      v.x = __fmul_rn(d, v.x);
      v.y = __fmul_rn(d, v.y);
      v.z = __fmul_rn(d, v.z);
      v.w = __fmul_rn(d, v.w);
      *reinterpret_cast<float4*>(du + i) = v;
    }
    __syncthreads();  // lcum, end decays and dt * x in place

    // 2. y, slot by slot: slots i and slots - 1 - i on the same warp
    const int n_slots = (L + TS - 1) / TS;
    for (int p = warp; 2 * p < n_slots; p += kWarps) {
      for (int side = 0; side < 2; ++side) {
        const int sl = side ? n_slots - 1 - p : p;
        if (side && sl == p) break;
        const int t = sl * TS + o;
        const bool tv = t < L;
        const int s_end = min(sl * TS + TS, L);
        float cr[N];
        {
          const float* cp = cs + (tv ? t : 0) * N;
#pragma unroll
          for (int n = 0; n < N; n += 4) {
            const float4 v = *reinterpret_cast<const float4*>(cp + n);
            cr[n] = v.x;
            cr[n + 1] = v.y;
            cr[n + 2] = v.z;
            cr[n + 3] = v.w;
          }
        }
        for (int s = h; s < s_end; s += HPG) {
          if (s <= t) {
            const float* bp = bs + s * N;
            float acc = 0.0f;
#pragma unroll
            for (int n = 0; n < N; n += 4) {
              const float4 v = *reinterpret_cast<const float4*>(bp + n);
              acc = fmaf(cr[n], v.x, acc);
              acc = fmaf(cr[n + 1], v.y, acc);
              acc = fmaf(cr[n + 2], v.z, acc);
              acc = fmaf(cr[n + 3], v.w, acc);
            }
            cbs[s * TS + o] = acc;
          }
        }
        __syncwarp();
        const float lct = tv ? lc[t * HPG + h] : 0.0f;
        float acc[HD];
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] = 0.0f;
        auto step = [&](int s) {
          const float m = expf(lct - lc[s * HPG + h]) * cbs[s * TS + o];
          const float* dp = du + s * XW + h * HD;
#pragma unroll
          for (int d = 0; d < HD; d += 4) {
            const float4 v = *reinterpret_cast<const float4*>(dp + d);
            acc[d] = fmaf(m, v.x, acc[d]);
            acc[d + 1] = fmaf(m, v.y, acc[d + 1]);
            acc[d + 2] = fmaf(m, v.z, acc[d + 2]);
            acc[d + 3] = fmaf(m, v.w, acc[d + 3]);
          }
        };
        const int s_full = sl * TS;
#pragma unroll 4
        for (int s = 0; s < s_full; ++s) step(s);
        for (int s = s_full; s < s_end; ++s)
          if (s <= t) step(s);
        if (tv) {
          const float qd = expf(lct);
          const float* sp = sc + h * HD * N;
          float* yo = y + ((r0 + t) * nh + g * HPG + h) * HD;
#pragma unroll
          for (int d = 0; d < HD; d += 4) {
            float out[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float* sr = sp + (d + e) * N;
              float q = 0.0f;
#pragma unroll
              for (int n = 0; n < N; n += 4) {
                const float4 v = *reinterpret_cast<const float4*>(sr + n);
                q = fmaf(cr[n], v.x, q);
                q = fmaf(cr[n + 1], v.y, q);
                q = fmaf(cr[n + 2], v.z, q);
                q = fmaf(cr[n + 3], v.w, q);
              }
              out[e] = __fadd_rn(acc[d + e], __fmul_rn(q, qd));
            }
            *reinterpret_cast<float4*>(yo + d) =
                make_float4(out[0], out[1], out[2], out[3]);
          }
        }
        __syncwarp();
      }
    }
    for (int i = kThreads - 1 - tid; i < HPG * HD; i += kThreads) {
      const int hh = i / HD;
      float acc[N];
#pragma unroll
      for (int n = 0; n < N; ++n) acc[n] = 0.0f;
#pragma unroll 2
      for (int t = 0; t < L; ++t) {
        const float w = __fmul_rn(du[t * XW + i], sd[t * HPG + hh]);
        const float* bp = bs + t * N;
#pragma unroll
        for (int n = 0; n < N; n += 4) {
          const float4 v = *reinterpret_cast<const float4*>(bp + n);
          acc[n] = fmaf(v.x, w, acc[n]);
          acc[n + 1] = fmaf(v.y, w, acc[n + 1]);
          acc[n + 2] = fmaf(v.z, w, acc[n + 2]);
          acc[n + 3] = fmaf(v.w, w, acc[n + 3]);
        }
      }
      const float dec = expf(lc[(L - 1) * HPG + hh]);
#pragma unroll
      for (int n = 0; n < N; ++n)
        sn[i * N + n] = __fadd_rn(__fmul_rn(sc[i * N + n], dec), acc[n]);
    }
  }
  __syncthreads();
  const float* sf = st + (n_chunks & 1) * SW;
  float* so = state_out + bid * SW;
  for (int i = 4 * tid; i < SW; i += 4 * kThreads)
    *reinterpret_cast<float4*>(so + i) =
        *reinterpret_cast<const float4*>(sf + i);
}

template <int HPG, int HD, int N>
int launch(const float* x, const float* dt, const float* a, const float* bm,
           const float* cm, float* y, float* state, int64_t rows,
           int64_t seqlen, int groups, int chunk, cudaStream_t stream) {
  const int64_t smem = 4 * Shape<HPG, HD, N>::floats(chunk);
  if (smem > 232448) return -1;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_fused<HPG, HD, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  ssd_fused<HPG, HD, N><<<(unsigned)rows, kThreads, (size_t)smem, stream>>>(
      x, dt, a, bm, cm, y, state, seqlen, groups, chunk);
  return (int)cudaGetLastError();
}

}  // namespace fz

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
  // an instance where one fits (kernels/ssd::fused_instance mirrors this)
  const bool aligned = ((uintptr_t)x | (uintptr_t)bm | (uintptr_t)cm |
                        (uintptr_t)y | (uintptr_t)state) % 16 == 0;
  const int64_t hpg = nh / groups;
  int rc = -1;
  if (aligned && hpg == 4 && hd == 8 && n == 8)
    rc = fz::launch<4, 8, 8>(x, dt, a, bm, cm, y, state, rows, seqlen,
                             (int)groups, (int)chunk, s);
  else if (aligned && hpg == 4 && hd == 16 && n == 8)
    rc = fz::launch<4, 16, 8>(x, dt, a, bm, cm, y, state, rows, seqlen,
                              (int)groups, (int)chunk, s);
  else if (aligned && hpg == 4 && hd == 32 && n == 16)
    rc = fz::launch<4, 32, 16>(x, dt, a, bm, cm, y, state, rows, seqlen,
                               (int)groups, (int)chunk, s);
  if (rc >= 0) return rc;
  if (hd <= 8) return launch<8>(x, dt, a, bm, cm, y, state, rows, dm, smem, s);
  if (hd <= 16)
    return launch<16>(x, dt, a, bm, cm, y, state, rows, dm, smem, s);
  return launch<32>(x, dt, a, bm, cm, y, state, rows, dm, smem, s);
}

