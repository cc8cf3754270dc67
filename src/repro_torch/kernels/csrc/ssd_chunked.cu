// Mamba-2 chunked SSD (state-space dual) scan, chunk-parallel: f32 or bf16
// x, B and C, any chunk.
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py::ssd (:65) for
// every shape that the fused route (ssd.cu: one block a (b, g) row, the
// carried state in shared memory) cannot take: bf16 inputs, chunks above
// 256 steps, or a working set above a block's shared memory. The SSD LM's
// shape is all three: at mamba2-370m's widths (32 heads of 64 in one
// group, N 128, chunk 256) the carried state alone is 1 MB a (b, g) row
// and C.B over one chunk is 256 KB, and the serving batch of 4 gives the
// TPU's (B * G, chunks) grid 4 rows for 132 SMs.
//
// Function, for x (B, S, nh, hd), dt (B, S, nh) f32, A (nh,) f32, Bm and
// Cm (B, S, G, N), with hpg = nh / G heads a group and chunks of L steps
// (ssd.cu states it per chunk): y (B, S, nh, hd) in x's type, rounded
// once from its f32 sum, and the final state (B, G, hpg, hd, N) in f32.
//
// Bound on the H100, at the SSD LM's call (B 4, S 4096, nh 32, hd 64,
// G 1, N 128, L 256, bf16): about 26.7 GFLOP (the lower triangle of C.B,
// the masked intra-chunk product, the state term of y, the chunk states
// and their decays; chip_smoke.py::ssd_work), 0.40 ms at 67 TFLOP/s in
// FP32, against 149 MB of inputs and outputs, 0.044 ms at 3.35 TB/s: the
// operations bound it.
//
// Design: the chunk-state / state-passing / chunk-scan split of the SSD
// algorithm (Mamba-2, arXiv:2405.21060, section 7), in five launches on
// the caller's stream, all in plain FP32 on the CUDA cores:
//   0. chunk_cumsum, a warp a (b, chunk, head): lcum = cumsum(dt * A) over
//      the chunk, into an f32 workspace (B, nh, S);
//   1. chunk_state, a block a (b, chunk, head) and 64 x 64 tile of (d, n):
//      S_c = sum_t exp(lcum[L-1] - lcum[t]) dt[t] x[t] (x) B[t], into an
//      f32 workspace (B, chunks, nh, hd, N) (67 MB at the LM's shape);
//   2. state_passing, a thread an element of (b, head, hd, N): in chunk
//      order s[c + 1] = exp(lcum_c[L-1]) s[c] + S_c, each chunk's entry
//      state written over its S_c (loaded 8 chunks ahead), the last one
//      to the final state;
//   3. chunk_cb, a block a (b, chunk, group) and 64 x 64 tile of (t, s)
//      at or below the diagonal: C.B, computed once for all the group's
//      heads, into an f32 workspace (B, chunks, G, L, L) (17 MB);
//   4. chunk_scan, a block a (b, chunk, 64 rows of t) and (head, 64 of
//      d): y = exp(lcum[t]) (C[t] . s[c]), plus, for each 64-step tile of
//      s <= t, C.B masked and decayed (exp(lcum[t] - lcum[s]) C.B) and
//      multiplied with the head's dt x.
// Each block tile is 64 x 64 over 256 threads, 4 x 4 a thread, fed from
// shared memory 32 (or 64) steps of the sum at a time, the next slice's
// global loads in flight while one sums; the sums over N stage their
// operands transposed, a warp 4 rows x 8 columns so that its stores fall
// on 32 banks. chunk_scan serves one head a block within the register
// budget of three blocks an SM, so one block's loads and barriers overlap
// the others' sums; more heads a block, sharing the staged C, held fewer
// blocks an SM and ran slower at the LM's call.
// Numerical rules of the fused route: the decay is a difference on the
// lower triangle, never exp(lcum[t]) * exp(-lcum[s]); nothing is
// evaluated above the diagonal (a thread tile wholly above it computes no
// C.B, and chunk_scan reads none); products that the reference rounds on
// their own (dt * A, dt * x, the decays, the state recurrence) are
// rounded on their own here (__fmul_rn, __fadd_rn); no fast math; every
// sum runs in one fixed order, so a call repeats bit for bit. Tensor
// cores (wgmma on bf16 pieces) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTile = 64;      // rows and columns of a block's tile
constexpr int kK = 32;         // depth of a sum staged in shared memory
constexpr int kPad = kTile + 4;  // row stride of the transposed tiles

struct Dims {
  int64_t batch, seqlen;
  int nh, hd, groups, n, chunk, hpg, n_chunks;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// acc[i][j] += a[i] * b[j] for the thread's 4 x 4 tile, from 16-byte rows
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float* a,
                                       const float* b) {
  const float4 a4 = *reinterpret_cast<const float4*>(a);
  const float4 b4 = *reinterpret_cast<const float4*>(b);
  const float av[4] = {a4.x, a4.y, a4.z, a4.w};
  const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// 0. lcum[b, h, c L + t]: each lane sums a run of ceil(L / 32) steps, a
// shuffle scan adds the runs before it, and the lane walks its run again
__global__ void __launch_bounds__(32)
chunk_cumsum(const float* __restrict__ dt, const float* __restrict__ a,
             float* __restrict__ lcum, Dims dm) {
  const int64_t id = blockIdx.x;  // (b, c, h)
  const int h = (int)(id % dm.nh);
  const int64_t bc = id / dm.nh;
  const int c = (int)(bc % dm.n_chunks);
  const int64_t b = bc / dm.n_chunks;
  const int L = dm.chunk, lane = threadIdx.x;
  const int run = (L + 31) / 32;
  const int t0 = min(lane * run, L), t1 = min(t0 + run, L);
  const float ah = a[h];
  const float* dtr = dt + (b * dm.seqlen + (int64_t)c * L) * dm.nh + h;
  float part = 0.0f;
  for (int t = t0; t < t1; ++t)
    part = __fadd_rn(part, __fmul_rn(dtr[(int64_t)t * dm.nh], ah));
  float incl = part;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = __fadd_rn(incl, v);
  }
  float sum = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) sum = 0.0f;
  float* out = lcum + (b * dm.nh + h) * dm.seqlen + (int64_t)c * L;
  for (int t = t0; t < t1; ++t) {
    sum = __fadd_rn(sum, __fmul_rn(dtr[(int64_t)t * dm.nh], ah));
    out[t] = sum;
  }
}

// 1. S_c[d, n] = sum_t (dt[t] x[t, d] * exp(lcum[L-1] - lcum[t])) B[t, n];
// a thread stages row t0 + tid / 8 of a kK-step slice, 8 columns from
// (tid % 8) * 8 of both tiles, the next slice's raw values loading while
// this one sums
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_state(const T* __restrict__ x, const float* __restrict__ dt,
            const T* __restrict__ bm, const float* __restrict__ lcum,
            float* __restrict__ states, Dims dm) {
  static_assert(kThreads == 8 * kK, "a thread stages 8 columns of a row");
  __shared__ __align__(16) float us[kK][kTile];  // (t, d)
  __shared__ __align__(16) float bs[kK][kTile];  // (t, n)
  const int64_t id = blockIdx.x;  // (b, c, h)
  const int h = (int)(id % dm.nh);
  const int64_t bc = id / dm.nh;
  const int c = (int)(bc % dm.n_chunks);
  const int64_t b = bc / dm.n_chunks;
  const int g = h / dm.hpg;
  const int n_dtile = (dm.hd + kTile - 1) / kTile;
  const int d0 = (int)(blockIdx.y % n_dtile) * kTile;
  const int n0 = (int)(blockIdx.y / n_dtile) * kTile;
  const int L = dm.chunk, tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int tr = tid / 8, c8 = (tid % 8) * 8;
  const int64_t row0 = b * dm.seqlen + (int64_t)c * L;
  const float* lc = lcum + (b * dm.nh + h) * dm.seqlen + (int64_t)c * L;
  const float lend = lc[L - 1];
  float dtv, lct, xr[8], br[8];  // raw values of one row, 0 past L
  auto fetch = [&](int t0) {
    const int t = t0 + tr;
    const int64_t row = row0 + t;
    const bool in = t < L;
    dtv = in ? dt[row * dm.nh + h] : 0.0f;
    lct = in ? lc[t] : 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = d0 + c8 + j, n = n0 + c8 + j;
      xr[j] = (in && d < dm.hd) ? to_f32(x[(row * dm.nh + h) * dm.hd + d])
                                : 0.0f;
      br[j] = (in && n < dm.n)
                  ? to_f32(bm[(row * dm.groups + g) * dm.n + n])
                  : 0.0f;
    }
  };
  float acc[4][4] = {};
  fetch(0);
  for (int t0 = 0; t0 < L; t0 += kK) {
    const float sd = expf(__fsub_rn(lend, lct));
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      us[tr][c8 + j] = __fmul_rn(__fmul_rn(dtv, xr[j]), sd);
      bs[tr][c8 + j] = br[j];
    }
    __syncthreads();
    if (t0 + kK < L) fetch(t0 + kK);
#pragma unroll 8
    for (int k = 0; k < kK; ++k) outer4(acc, &us[k][ty * 4], &bs[k][tx * 4]);
    __syncthreads();
  }
  float* out = states + ((b * dm.n_chunks + c) * dm.nh + h) *
                            ((int64_t)dm.hd * dm.n);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (d < dm.hd && n < dm.n) out[(int64_t)d * dm.n + n] = acc[i][j];
    }
}

// 2. entry states in chunk order, in place, and the final state; the
// S_c of kBatch chunks are loaded ahead of the recurrence that needs them
__global__ void __launch_bounds__(kThreads)
state_passing(float* __restrict__ states, const float* __restrict__ lcum,
              float* __restrict__ state_out, Dims dm) {
  constexpr int kBatch = 8;
  const int64_t hdn = (int64_t)dm.hd * dm.n;
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= dm.batch * dm.nh * hdn) return;
  const int64_t e = i % hdn, bh = i / hdn;  // (b, h), then (d, n)
  const int h = (int)(bh % dm.nh);
  const int64_t b = bh / dm.nh;
  const float* lend = lcum + bh * dm.seqlen + dm.chunk - 1;
  float* p = states + (b * dm.n_chunks * dm.nh + h) * hdn + e;
  const int64_t step = dm.nh * hdn;  // from one chunk's S_c to the next
  float s = 0.0f;
  for (int c0 = 0; c0 < dm.n_chunks; c0 += kBatch) {
    float sc[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (c0 + j < dm.n_chunks) sc[j] = p[(int64_t)(c0 + j) * step];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (c0 + j >= dm.n_chunks) break;
      p[(int64_t)(c0 + j) * step] = s;
      s = __fadd_rn(
          __fmul_rn(s, expf(lend[(int64_t)(c0 + j) * dm.chunk])), sc[j]);
    }
  }
  state_out[i] = s;  // (B, G, hpg, hd, N) is (B, nh, hd, N)
}

// Element (r, k) of a 64 x kK tile that a thread stages at index i (i =
// tid + it * kThreads): a warp takes 4 rows x 8 consecutive k, so its
// transposed stores (k, r) at row stride kPad fall on 32 distinct banks.
__device__ __forceinline__ void tile_rk(int i, int& r, int& k) {
  k = (i & 7) | (((i >> 5) & 3) << 3);
  r = ((i >> 3) & 3) | ((i >> 7) << 2);
}

constexpr int kStage = kTile * kK / kThreads;  // elements a thread stages

// the thread's elements of rows [0, rows) x columns [k0, k0 + kK) of a
// row-major matrix with row stride ``ld`` and ``cols`` columns, 0 outside
template <typename T>
__device__ __forceinline__ void fetch(float (&v)[kStage], const T* base,
                                      int64_t ld, int rows, int k0,
                                      int cols) {
#pragma unroll
  for (int it = 0; it < kStage; ++it) {
    int r, k;
    tile_rk(threadIdx.x + it * kThreads, r, k);
    v[it] = (r < rows && k0 + k < cols) ? to_f32(base[r * ld + k0 + k])
                                        : 0.0f;
  }
}

// ... stored transposed: tile[k * kPad + r]
__device__ __forceinline__ void put(float* tile, const float (&v)[kStage]) {
#pragma unroll
  for (int it = 0; it < kStage; ++it) {
    int r, k;
    tile_rk(threadIdx.x + it * kThreads, r, k);
    tile[k * kPad + r] = v[it];
  }
}

// 3. C.B of each chunk, transposed, on the 64 x 64 tiles at or below the
// diagonal: cbT[b, c, g, s, t] = C[t] . B[s]; a thread tile wholly above
// the diagonal computes and stores nothing
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_cb(const T* __restrict__ bm, const T* __restrict__ cm,
         float* __restrict__ cbT, Dims dm) {
  __shared__ __align__(16) float buf[2 * kK * kPad];
  float* cT = buf;            // C (k, t)
  float* bT = buf + kK * kPad;  // B (k, s)
  const int L = dm.chunk, N = dm.n, G = dm.groups;
  const int n_ttile = (L + kTile - 1) / kTile;
  const int pairs = n_ttile * (n_ttile + 1) / 2;
  int64_t id = blockIdx.x;  // (b, c, g, tile pair)
  const int pair = (int)(id % pairs);
  id /= pairs;
  const int g = (int)(id % G);
  id /= G;
  const int c = (int)(id % dm.n_chunks);
  const int64_t b = id / dm.n_chunks;
  int tt = 0;  // pair = tt (tt + 1) / 2 + st, st <= tt
  while ((tt + 1) * (tt + 2) / 2 <= pair) ++tt;
  const int t0 = tt * kTile, s0 = (pair - tt * (tt + 1) / 2) * kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t row0 = b * dm.seqlen + (int64_t)c * L;
  const int64_t ldg = (int64_t)G * N;  // row stride of B and C
  const T* crows = cm + ((row0 + t0) * G + g) * N;
  const T* brows = bm + ((row0 + s0) * G + g) * N;
  // the thread holds s = s0 + ty * 4 + i and t = t0 + tx * 4 + j
  const bool live = s0 + ty * 4 <= t0 + tx * 4 + 3;
  float cb[4][4] = {};
  float v[kStage], w[kStage];
  fetch(v, crows, ldg, L - t0, 0, N);
  fetch(w, brows, ldg, L - s0, 0, N);
  for (int n0 = 0; n0 < N; n0 += kK) {
    put(cT, v);
    put(bT, w);
    __syncthreads();
    if (n0 + kK < N) {  // the next slice of N loads while this one sums
      fetch(v, crows, ldg, L - t0, n0 + kK, N);
      fetch(w, brows, ldg, L - s0, n0 + kK, N);
    }
    if (live) {
#pragma unroll 8
      for (int k = 0; k < kK; ++k)
        outer4(cb, bT + k * kPad + ty * 4, cT + k * kPad + tx * 4);
    }
    __syncthreads();
  }
  if (!live) return;
  float* out = cbT + (((b * dm.n_chunks + c) * G + g) * (int64_t)L) * L;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + tx * 4 + j;
      if (s < L && t < L) out[(int64_t)s * L + t] = cb[i][j];
    }
  }
}

// 4. y for 64 rows of one chunk, one head and 64 of d; three blocks an SM
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
chunk_scan(const T* __restrict__ x, const float* __restrict__ dt,
           const T* __restrict__ cm, const float* __restrict__ cbT,
           const float* __restrict__ lcum, const float* __restrict__ states,
           T* __restrict__ y, Dims dm) {
  // phases share one buffer: the state term stages C (k, t) and the state
  // (k, d), transposed; the s tiles hold the decayed C.B (s, t),
  // transposed, and dt x (s, d)
  __shared__ __align__(16) float buf[kTile * kPad + kTile * kTile];
  __shared__ float lt[kTile], ls[kTile];
  float* cT = buf;
  float* sT = buf + kK * kPad;
  float* mT = buf;
  float* du = buf + kTile * kPad;
  const int L = dm.chunk, N = dm.n, G = dm.groups, hd = dm.hd;
  const int n_ttile = (L + kTile - 1) / kTile;
  const int64_t id = blockIdx.x;  // (b, c, t tile)
  const int t0 = (int)(id % n_ttile) * kTile;
  const int64_t bc = id / n_ttile;
  const int c = (int)(bc % dm.n_chunks);
  const int64_t b = bc / dm.n_chunks;
  const int n_dtile = (hd + kTile - 1) / kTile;
  const int d0 = (int)(blockIdx.y % n_dtile) * kTile;
  const int h = (int)(blockIdx.y / n_dtile), g = h / dm.hpg;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t row0 = b * dm.seqlen + (int64_t)c * L;
  const T* crows = cm + ((row0 + t0) * G + g) * N;
  const float* lc = lcum + (b * dm.nh + h) * dm.seqlen + (int64_t)c * L;
  const float* cbc = cbT + (((b * dm.n_chunks + c) * G + g) * (int64_t)L) * L;

  for (int t = tid; t < kTile; t += kThreads)
    lt[t] = t0 + t < L ? lc[t0 + t] : 0.0f;
  float acc[4][4] = {};
  // the state term, exp(lcum[t]) (C[t] . s[c]); the first chunk's entry
  // state is zero
  if (c > 0) {
    const float* sp = states + ((b * dm.n_chunks + c) * dm.nh + h) *
                                   ((int64_t)hd * N) + (int64_t)d0 * N;
    float v[kStage], w[kStage];
    fetch(v, crows, (int64_t)G * N, L - t0, 0, N);
    fetch(w, sp, N, hd - d0, 0, N);
    for (int n0 = 0; n0 < N; n0 += kK) {
      put(cT, v);
      put(sT, w);
      __syncthreads();
      if (n0 + kK < N) {  // the next slice of N loads while this one sums
        fetch(v, crows, (int64_t)G * N, L - t0, n0 + kK, N);
        fetch(w, sp, N, hd - d0, n0 + kK, N);
      }
#pragma unroll 8
      for (int k = 0; k < kK; ++k)
        outer4(acc, cT + k * kPad + ty * 4, sT + k * kPad + tx * 4);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float q = expf(lt[ty * 4 + i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __fmul_rn(acc[i][j], q);
    }
  }
  // the intra-chunk sum over the s tiles at or below the diagonal
  for (int s0 = 0; s0 <= t0; s0 += kTile) {
    // C.B of the tile, transposed: the thread holds s = ty * 4 + i and
    // t = tx * 4 + j, and reads and evaluates nothing above the diagonal
    float cb[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + ty * 4 + i, t = t0 + tx * 4 + j;
        cb[i][j] = (s <= t && t < L) ? cbc[(int64_t)s * L + t] : 0.0f;
      }
    for (int s = tid; s < kTile; s += kThreads)
      ls[s] = s0 + s < L ? lc[s0 + s] : 0.0f;
    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int s = i / kTile, d = i % kTile;
      const int64_t row = row0 + s0 + s;
      du[i] = (s0 + s < L && d0 + d < hd)
                  ? __fmul_rn(dt[row * dm.nh + h],
                              to_f32(x[(row * dm.nh + h) * hd + d0 + d]))
                  : 0.0f;
    }
    __syncthreads();  // lt, ls
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = ty * 4 + i;
      float m[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = tx * 4 + j;
        m[j] = 0.0f;
        if (s0 + s <= t0 + t && t0 + t < L)
          m[j] = __fmul_rn(expf(__fsub_rn(lt[t], ls[s])), cb[i][j]);
      }
      *reinterpret_cast<float4*>(mT + s * kPad + tx * 4) =
          make_float4(m[0], m[1], m[2], m[3]);
    }
    __syncthreads();
#pragma unroll 8
    for (int s = 0; s < kTile; ++s)
      outer4(acc, mT + s * kPad + ty * 4, du + s * kTile + tx * 4);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + ty * 4 + i, d = d0 + tx * 4 + j;
      if (t < L && d < hd)
        store(&y[((row0 + t) * dm.nh + h) * hd + d], acc[i][j]);
    }
}

template <typename T>
int run(const void* x, const float* dt, const float* a, const void* bm,
        const void* cm, void* y, float* state, float* lcum, float* states,
        float* cbT, const Dims& dm, cudaStream_t stream) {
  const int64_t heads = dm.batch * dm.n_chunks * dm.nh;
  const int n_dtile = (dm.hd + kTile - 1) / kTile;
  const int n_ntile = (dm.n + kTile - 1) / kTile;
  const int n_ttile = (dm.chunk + kTile - 1) / kTile;
  const int64_t scan_y = (int64_t)dm.nh * n_dtile;
  const int64_t elems = dm.batch * dm.nh * (int64_t)dm.hd * dm.n;
  const int64_t scan_x = dm.batch * dm.n_chunks * n_ttile;
  const int64_t cb_x = dm.batch * dm.n_chunks * dm.groups *
                       ((int64_t)n_ttile * (n_ttile + 1) / 2);
  if (heads > 0x7fffffff || scan_x > 0x7fffffff || cb_x > 0x7fffffff ||
      (int64_t)n_dtile * n_ntile > 65535 || scan_y > 65535 ||
      (elems + kThreads - 1) / kThreads > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  chunk_cumsum<<<(unsigned)heads, 32, 0, stream>>>(dt, a, lcum, dm);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  chunk_state<T><<<dim3((unsigned)heads, (unsigned)(n_dtile * n_ntile)),
                   kThreads, 0, stream>>>(xt, dt, bt, lcum, states, dm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  state_passing<<<(unsigned)((elems + kThreads - 1) / kThreads), kThreads, 0,
                  stream>>>(states, lcum, state, dm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  chunk_cb<T><<<(unsigned)cb_x, kThreads, 0, stream>>>(bt, ct, cbT, dm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  chunk_scan<T><<<dim3((unsigned)scan_x, (unsigned)scan_y), kThreads, 0,
                  stream>>>(xt, dt, ct, cbT, lcum, states,
                            static_cast<T*>(y), dm);
  return (int)cudaGetLastError();
}

}  // namespace

// x, bm, cm and y are f32 or, with bf16 != 0, bf16; dt, a, state and the
// three workspaces f32: lcum (batch, nh, seqlen), states (batch,
// seqlen / chunk, nh, hd, n) and cbT (batch, seqlen / chunk, groups,
// chunk, chunk). Five launches on ``stream``; returns the first launch
// error.
extern "C" int repro_ssd_chunked(const void* x, const float* dt,
                                 const float* a, const void* bm,
                                 const void* cm, void* y, float* state,
                                 float* lcum, float* states, float* cbT,
                                 int64_t batch,
                                 int64_t seqlen, int64_t nh, int64_t hd,
                                 int64_t groups, int64_t n, int64_t chunk,
                                 int64_t bf16, void* stream) {
  if (batch < 1 || seqlen < 1 || nh < 1 || hd < 1 || groups < 1 || n < 1 ||
      chunk < 1 || nh % groups || seqlen % chunk || nh > 0x7fffffff ||
      hd > 0x7fffffff || n > 0x7fffffff || chunk > 0x7fffffff ||
      seqlen / chunk > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Dims dm{batch,       seqlen,   (int)nh,
                (int)hd,     (int)groups, (int)n,
                (int)chunk,  (int)(nh / groups), (int)(seqlen / chunk)};
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return run<__nv_bfloat16>(x, dt, a, bm, cm, y, state, lcum, states, cbT,
                              dm, s);
  return run<float>(x, dt, a, bm, cm, y, state, lcum, states, cbT, dm, s);
}
