// Mamba-2 chunked SSD (state-space dual) scan, chunk-parallel: bf16 x, B
// and C on the tensor cores, f32 (and bf16 shapes that cannot be tiled)
// on the CUDA cores; any chunk.
//
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py::_ssd_kernel
// (:21; its entry point ssd at :65, the pallas_call at :85) for every
// shape that the fused route (ssd.cu: one block a (b, g) row, the carried
// state in shared memory) cannot take: bf16 inputs, chunks above 256
// steps, or a working set above a block's shared memory. The SSD LM's
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
// G 1, N 128, L 256, bf16; chip_smoke.py::ssd_work): 26.3 GFLOP of
// products (the lower triangle of C.B, the masked intra-chunk product, the
// state term of y, the chunk states), 0.027 ms at 989 TFLOP/s on bf16
// tensor cores, and 0.37 GFLOP of elementwise work (differences, exps,
// dt * A, the cumsum, the decays of the recurrence), 0.006 ms at 67
// TFLOP/s FP32, against 149 MB of inputs and outputs, 0.044 ms at 3.35
// TB/s: the bytes bound it. The design's own floor is larger: its
// three-piece products come to 84 GFLOP (0.085 ms), and the chunk states
// pass through device memory (S_c in f32, written once and read once,
// then the entry states as bf16 pieces, written once and read once: 323
// MB, 0.096 ms).
//
// Design: the chunk-state / state-passing / chunk-scan split of the SSD
// algorithm (Mamba-2, arXiv:2405.21060, section 7), in launches on the
// caller's stream. Two routes, chosen statically by the wrapper from the
// dtype and the shape (route() in kernels/ssd), never as a fallback:
//
// bf16 x, B and C with hd <= 64, N <= 256, hd, N and L multiples of 16
// (namespace tc, sm_90a), four launches:
//   0. chunk_cumsum, below, which also writes dt transposed to (B, nh, S)
//      so that a head's steps are one bulk copy;
//   1. chunk_state_tc, a warpgroup a (b, chunk, head): S_c^T (N x hd) =
//      B'^T x over 32-step slabs of t that TMA brings through a ring of
//      four stages. B'[t, n] = B[t, n] (dt[t] exp(lcum[L-1] - lcum[t]))
//      is the A operand: read transposed from B's swizzled slab into
//      registers (ldmatrix), scaled and split there into three exact bf16
//      pieces (sm90.cuh::split3); x, exact in bf16, is the B operand,
//      MN-major in shared memory. No thread writes shared memory after
//      TMA, so a slab needs no barrier but its full barrier;
//   2. state_passing_pieces: the recurrence of state_passing below, each
//      chunk's entry state written as its three bf16 pieces in the
//      swizzled K-major layout of a wgmma operand (one bulk copy a head
//      for chunk_scan_tc), 16 bytes a thread and piece; chunk 0's entry
//      state is zero and not written;
//   3. chunk_scan_tc, a block a (b, chunk, 64 rows of t, group), the
//      attention-shaped scan (C plays Q, B plays K, x plays V, the masked
//      decay times dt plays the softmax): one producer warp loads the C
//      and B tiles once, and for each head its x tiles (TMA), its entry
//      state's pieces and its decays and steps (bulk copies) into rings
//      guarded by mbarriers. Two consumer warpgroups (one where shared
//      memory holds only one) compute C.B once on the s tiles at or below
//      the diagonal (wgmma, both operands exact bf16, f32 sums), keep it
//      in shared memory, and take the group's heads by turns: the state
//      term C s^T on wgmma with the state's three pieces, scaled by
//      exp(lcum[t]), then for each s tile M'[t, s] = exp(lcum[t] -
//      lcum[s]) C.B[t, s] dt[s] in registers (the exponent masked to -inf
//      above the diagonal), split into three pieces in the A-fragment
//      order and multiplied with the head's x tile on wgmma, A from
//      registers; y is rounded to bf16 once. One warpgroup's products run
//      while the other is on the CUDA cores. C.B is never written to
//      device memory and never computed per head.
// What bounds the tensor-core kernels at the LM's call is neither their
// products nor their bytes but latency: how many warpgroups an SM keeps
// busy on the chains of waits, CUDA-core work and wgmma of a tile
// (PERF.md gives the measurements).
//
// f32, and bf16 shapes that the tensor-core kernels cannot tile (the
// first chunked route, plain FP32 on the CUDA cores), five launches:
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
//      heads, into an f32 workspace (B, chunks, G, L, L);
//   4. chunk_scan, a block a (b, chunk, 64 rows of t) and (head, 64 of
//      d): y = exp(lcum[t]) (C[t] . s[c]), plus, for each 64-step tile of
//      s <= t, C.B masked and decayed (exp(lcum[t] - lcum[s]) C.B) and
//      multiplied with the head's dt x.
// Each block tile is 64 x 64 over 256 threads, 4 x 4 a thread, fed from
// shared memory 32 (or 64) steps of the sum at a time, the next slice's
// global loads in flight while one sums; the sums over N stage their
// operands transposed, a warp 4 rows x 8 columns so that its stores fall
// on 32 banks.
//
// Numerical rules: the decay is a difference on the lower triangle, never
// exp(lcum[t]) * exp(-lcum[s]); nothing is evaluated above the diagonal
// (the exponent is masked to -inf there); products that the reference
// rounds on their own (dt * A, the decays, the state recurrence) are
// rounded on their own here (__fmul_rn, __fadd_rn); no fast math; every
// sum runs in one fixed order and nothing accumulates through atomics, so
// a call repeats bit for bit. The tensor-core route folds dt into M' and
// into B' where the reference rounds dt * x first: an f32 rounding moves
// by an ulp a term. The three pieces of an f32 factor sum to it exactly
// for magnitudes above 2^-100 (sm90.cuh::split3); each piece times an
// exact bf16 operand is exact in the f32 accumulator, so the products are
// the reference's f32 products up to the order of their sums.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

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
// shuffle scan adds the runs before it, and the lane walks its run again;
// with dtT, dt is also written there transposed, (B, nh, S) as lcum
__global__ void __launch_bounds__(32)
chunk_cumsum(const float* __restrict__ dt, const float* __restrict__ a,
             float* __restrict__ lcum, float* __restrict__ dtT, Dims dm) {
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
  const int64_t row = (b * dm.nh + h) * dm.seqlen + (int64_t)c * L;
  for (int t = t0; t < t1; ++t) {
    const float v = dtr[(int64_t)t * dm.nh];
    sum = __fadd_rn(sum, __fmul_rn(v, ah));
    lcum[row + t] = sum;
    if (dtT != nullptr) dtT[row + t] = v;
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

// the CUDA-core route: five launches
template <typename T>
int run_fma(const void* x, const float* dt, const float* a, const void* bm,
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
  chunk_cumsum<<<(unsigned)heads, 32, 0, stream>>>(dt, a, lcum, nullptr,
                                                    dm);
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


// ---------------------------------------------------------------------------
// bf16 on the tensor cores: Hopper (sm_90a) wgmma, TMA and bulk copies
// ---------------------------------------------------------------------------
namespace tc {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;        // rows of t, and of s, a chunk_scan tile
constexpr int kSlab = 32;        // rows of t a chunk_state step
constexpr int kSlabStages = 4;   // chunk_state's ring of x and B slabs
constexpr int kXStages = 2;      // x tiles in flight a consumer warpgroup
constexpr int kScalStages = 2;   // heads' decays and steps in flight
constexpr int kBarsPerCons = 2 + 2 * kXStages + 2 * kScalStages;
constexpr int kXBytes = kRows * 128;  // an x tile: 64 rows x 64 columns

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// N padded to whole 128-byte rows of a swizzled tile (the TMA zero-fills
// columns past N, which add nothing to a product over N)
__host__ __device__ inline int padded_n(int n) {
  return n <= 64 ? 64 : n <= 128 ? 128 : 256;
}

// chunk_scan_tc's shared memory, in bytes from a 1024-byte-aligned base:
// the C tile; a region a s tile, which holds its B tile until C.B (f32, 64
// x 64, by thread) overwrites it; then a block a consumer warpgroup: the
// entry state's three pieces, the ring of x tiles and the ring of the
// head's decays and steps; then the mbarriers
struct ScanPlan {
  int np, n_tt, ncons, lp;  // padded N, t tiles, consumers, rows of s
  int cb_off, region, cons_off, cons_bytes, state_bytes, scal_bytes;
  int bar_off, smem;
};

inline ScanPlan scan_plan(int n, int chunk, int ncons) {
  ScanPlan p;
  p.np = padded_n(n);
  p.n_tt = (chunk + kRows - 1) / kRows;
  p.ncons = ncons;
  p.lp = p.n_tt * kRows;
  p.cb_off = p.np * 128;  // C: np / 64 boxes of 64 rows x 128 bytes
  p.region = p.np * 128 > 16384 ? p.np * 128 : 16384;
  p.cons_off = p.cb_off + p.n_tt * p.region;
  p.state_bytes = 3 * p.np * 128;           // 3 pieces of 64 (d) x np
  p.scal_bytes = (kRows + 2 * p.lp) * 4;    // lcum of t; lcum, dt of s
  p.cons_bytes = p.state_bytes + kXStages * kXBytes +
                 round_up(kScalStages * p.scal_bytes, 1024);
  p.bar_off = p.cons_off + ncons * p.cons_bytes;
  p.smem = 1024 + p.bar_off + 8 * (1 + ncons * kBarsPerCons);
  return p;
}

// chunk_state_tc's: a ring of (x, B) slabs of 32 rows, the weights w[t]
// of the chunk, the ring's mbarriers
template <int NP>
struct SlabPlan {
  static constexpr int X_BYTES = kSlab * 128;
  static constexpr int B_BYTES = NP / 64 * kSlab * 128;
  static constexpr int STAGE = X_BYTES + B_BYTES;
  static constexpr int W_OFF = kSlabStages * STAGE;
  static int smem(int chunk) {
    const int n_sub = (chunk + kSlab - 1) / kSlab;
    return 1024 + W_OFF + round_up(n_sub * kSlab * 4, 16) + 8 * kSlabStages;
  }
};

struct ScanArgs {
  const float* lcum;
  const float* dtT;  // dt transposed, (B, nh, S) as lcum
  const bf16* pieces;
  bf16* y;
  Dims dm;
  ScanPlan p;
};

// M' of one 64 x 64 tile as three bf16 pieces, in the A-fragment order of
// each k16 slice (the accumulator's columns 16 kk .. 16 kk + 15)
struct Pieces {
  uint32_t hi[4][4], mid[4][4], lo[4][4];
};

// M'[t, s] = exp(lcum[t] - lcum[s]) C.B[t, s] dt[s] for this thread's
// accumulator positions of s tile j: C.B from shared memory (by thread),
// lcum and dt of s from the head's decays and steps, the exponent masked to
// -inf above the diagonal and past the chunk, then split into pieces
__device__ __forceinline__ void mprime(Pieces& pc, const float4* cbv,
                                       const float* ls, const float* dts,
                                       float lt0, float lt1, int tg0, int sg0,
                                       int tq, bool edge, int L) {
  float m[32];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float4 v = cbv[128 * q];
    m[4 * q] = v.x;
    m[4 * q + 1] = v.y;
    m[4 * q + 2] = v.z;
    m[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int col = 8 * jj + 2 * tq;
    const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
    const float2 d2 = *reinterpret_cast<const float2*>(dts + col);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int sg = sg0 + col + e;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int tg = tg0 + 8 * i;
        const bool masked = edge && (sg > tg || tg >= L);
        const float arg =
            masked ? -INFINITY : __fsub_rn(i ? lt1 : lt0, e ? l2.y : l2.x);
        const float v = __fmul_rn(__fmul_rn(expf(arg), m[4 * jj + 2 * i + e]),
                                  e ? d2.y : d2.x);
        // shared memory past the chunk holds no decays or steps
        m[4 * jj + 2 * i + e] = masked ? 0.0f : v;
      }
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      split3(m[8 * kk + 2 * q], m[8 * kk + 2 * q + 1], pc.hi[kk][q],
             pc.mid[kk][q], pc.lo[kk][q]);
}

// acc += M' x of one tile, committed as one group: A the pieces from
// registers (the smallest first), x (s x d) MN-major in shared memory, 16
// rows of s a k16 step
__device__ __forceinline__ void start_mx(float (&acc)[32], const Pieces& pc,
                                         uint32_t xt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    RS<64>::run(acc, pc.lo[kk], sw128_desc(xt + 2048 * kk, 8192, 1024));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    RS<64>::run(acc, pc.mid[kk], sw128_desc(xt + 2048 * kk, 8192, 1024));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    RS<64>::run(acc, pc.hi[kk], sw128_desc(xt + 2048 * kk, 8192, 1024));
  wgmma_commit();
}

// 3. y for 64 rows of t of one chunk and group, every head of the group.
// Threads: the consumer warpgroups first (wgmma wants a warpgroup's warps
// aligned to 4), consumer k taking heads k, k + ncons, ..., then one
// producer warp, whose lane k feeds consumer k alone (every load is a TMA
// or bulk copy that one thread issues). NP is p.np, a template argument so
// that every product's k loop unrolls (a branch between wgmmas serializes
// them).
template <int NP>
__global__ void __launch_bounds__(288, 1)
    chunk_scan_tc(const __grid_constant__ CUtensorMap mx,
                  const __grid_constant__ CUtensorMap mb,
                  const __grid_constant__ CUtensorMap mc,
                  const __grid_constant__ ScanArgs a) {
  const ScanPlan& p = a.p;
  const Dims& dm = a.dm;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);  // the same, generic
  const int L = dm.chunk, G = dm.groups;

  // the t tiles with the most s tiles first
  const int64_t bcg = dm.batch * dm.n_chunks * G;
  const int tt = p.n_tt - 1 - (int)(blockIdx.x / bcg);
  int64_t r = blockIdx.x % bcg;
  const int g = (int)(r % G);
  r /= G;
  const int c = (int)(r % dm.n_chunks);
  const int64_t b = r / dm.n_chunks;
  const int n_s = tt + 1;  // s tiles at or below the diagonal
  const int row_c = (int)(b * dm.seqlen + (int64_t)c * L);  // of (B S)

  const uint32_t sC = base, sCB = base + p.cb_off;
  const uint32_t bar_cb = base + p.bar_off;
  // consumer k's barriers: 0 state full, 1 state empty, 2 + st x full,
  // 2 + kXStages + st x empty, then scal full and scal empty likewise
  auto bar = [&](int k, int i) {
    return bar_cb + 8 + 8 * (kBarsPerCons * k + i);
  };
  constexpr int kXFull = 2, kXEmpty = 2 + kXStages;
  constexpr int kScalFull = 2 + 2 * kXStages;
  constexpr int kScalEmpty = kScalFull + kScalStages;
  auto scal_off = [&](int k, int st) {
    return p.cons_off + k * p.cons_bytes + p.state_bytes +
           kXStages * kXBytes + st * p.scal_bytes;
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_cb, 1);
    for (int k = 0; k < p.ncons; ++k) {
      mbar_init(bar(k, 0), 1);
      mbar_init(bar(k, 1), 1);
      for (int st = 0; st < kXStages; ++st) {
        mbar_init(bar(k, kXFull + st), 1);
        mbar_init(bar(k, kXEmpty + st), 1);
      }
      for (int st = 0; st < kScalStages; ++st) {
        mbar_init(bar(k, kScalFull + st), 1);     // the producer's copies
        mbar_init(bar(k, kScalEmpty + st), 128);  // the consumer
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's index, broadcast from lane 0 so that every branch on it
  // is warp-uniform to the compiler (a wgmma under a branch it cannot
  // prove uniform is serialized); p.ncons is the producer warp's
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgi == p.ncons) {
    const int lane = tid & 31;
    if (lane == 0) {  // the C tile and the B tiles of the s tiles, once
      mbar_expect_tx(bar_cb, (uint32_t)(NP * 128 * (1 + n_s)));
      for (int cb = 0; cb < NP / 64; ++cb) {
        tma_load(sC + cb * 8192, &mc, bar_cb, 64 * cb, g, row_c + kRows * tt);
        for (int j = 0; j < n_s; ++j)
          tma_load(sCB + j * p.region + cb * 8192, &mb, bar_cb, 64 * cb, g,
                   row_c + kRows * j);
      }
    }
    if (lane < p.ncons) {
      const int k = lane;
      const uint32_t cons = base + p.cons_off + k * p.cons_bytes;
      int ss = 0, xs = 0;
      uint32_t sph = 0, xph = 0, stph = 0;
      // a head's decays and steps, three bulk copies: lcum over the t
      // tile, lcum and dt over the s tiles, each cut at the chunk's end
      // (what lies past it in shared memory is masked)
      const int nt = L - kRows * tt < kRows ? L - kRows * tt : kRows;
      const int ns = L < kRows * n_s ? L : kRows * n_s;
      auto load_scal = [&](int hl) {
        mbar_wait(bar(k, kScalEmpty + ss), sph ^ 1);
        const uint32_t dst = base + scal_off(k, ss);
        const uint32_t full = bar(k, kScalFull + ss);
        const int64_t row = ((int64_t)b * dm.nh + g * dm.hpg + hl) *
                                dm.seqlen + (int64_t)c * L;
        mbar_expect_tx(full, 4 * (nt + 2 * ns));
        bulk_load(dst, a.lcum + row + kRows * tt, 4 * nt, full);
        bulk_load(dst + 4 * kRows, a.lcum + row, 4 * ns, full);
        bulk_load(dst + 4 * (kRows + p.lp), a.dtT + row, 4 * ns, full);
        if (++ss == kScalStages) {
          ss = 0;
          sph ^= 1;
        }
      };
      // a head's entry state (three pieces); none for the first chunk,
      // whose entry state is zero
      auto load_state = [&](int hl) {
        if (c == 0) return;
        mbar_wait(bar(k, 1), stph ^ 1);
        const int h = g * dm.hpg + hl;
        mbar_expect_tx(bar(k, 0), p.state_bytes);
        bulk_load(cons,
                  a.pieces + (((int64_t)b * dm.n_chunks + c) * dm.nh + h) *
                                 (p.state_bytes / 2),
                  p.state_bytes, bar(k, 0));
        stph ^= 1;
      };
      const int lead = n_s < kXStages ? n_s : kXStages;
      for (int hl = k; hl < dm.hpg; hl += p.ncons) {
        if (hl == k) {
          load_scal(hl);
          load_state(hl);
        }
        const int h = g * dm.hpg + hl;
        for (int j = 0; j < n_s; ++j) {
          mbar_wait(bar(k, kXEmpty + xs), xph ^ 1);
          mbar_expect_tx(bar(k, kXFull + xs), kXBytes);
          tma_load(cons + p.state_bytes + xs * kXBytes, &mx,
                   bar(k, kXFull + xs), 0, h, row_c + kRows * j);
          if (++xs == kXStages) {
            xs = 0;
            xph ^= 1;
          }
          // the next head's decays and state once this head's first x
          // tiles are on their way (its state slot frees after this
          // head's state term)
          if (j == lead - 1 && hl + p.ncons < dm.hpg) {
            load_scal(hl + p.ncons);
            load_state(hl + p.ncons);
          }
        }
      }
    }
  } else {
    const int k = wgi;
    const int ltid = tid & 127, warp = ltid >> 5, lane = tid & 31;
    const int gq = lane >> 2, tq = lane & 3;  // accumulator coordinates
    const int row0 = 16 * warp + gq;  // this thread's rows: row0, row0 + 8
    const int tg0 = kRows * tt + row0;  // ... in the chunk
    const uint32_t cons = base + p.cons_off + k * p.cons_bytes;
    constexpr int ksteps = NP / 16;

    // C.B of this warpgroup's s tiles (both operands K-major, exact bf16,
    // f32 sums), each over its B tile in shared memory, by thread
    mbar_wait_warp(bar_cb, 0);
    for (int j = k; j < n_s; j += p.ncons) {
      float cb[32];
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < ksteps; ++kc) {
        const uint32_t off = (kc >> 2) * 8192 + (kc & 3) * 32;
        SS<64>::run(cb, sw128_desc(sC + off, 16, 1024),
                    sw128_desc(sCB + j * p.region + off, 16, 1024), kc > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(cb);
      float4* dst =
          reinterpret_cast<float4*>(gbase + p.cb_off + j * p.region) + ltid;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        dst[128 * q] =
            make_float4(cb[4 * q], cb[4 * q + 1], cb[4 * q + 2], cb[4 * q + 3]);
    }
    bar_sync(1, 128 * p.ncons);  // every C.B tile is in shared memory

    int ss = 0, xs = 0;
    uint32_t sph = 0, xph = 0, stph = 0;
    const bool ragged = kRows * tt + kRows > L;
    for (int hl = k; hl < dm.hpg; hl += p.ncons) {
      const int h = g * dm.hpg + hl;
      mbar_wait_warp(bar(k, kScalFull + ss), sph);
      const float* sc = reinterpret_cast<const float*>(gbase + scal_off(k, ss));
      const float lt0 = sc[row0], lt1 = sc[row0 + 8];
      const float* ls = sc + kRows;
      const float* dts = sc + kRows + p.lp;
      // y's f32 sum: the state term exp(lcum[t]) (C s^T) first, then the
      // products M' x of the s tiles accumulate onto it
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      if (c > 0) {
        // C s^T on the entry state's pieces, the smallest first, waited
        // for at once (left in flight while the first tile's M' is
        // computed, it made ptxas serialize every wgmma of the kernel)
        mbar_wait_warp(bar(k, 0), stph);
        wgmma_fence();
#pragma unroll
        for (int pc = 2; pc >= 0; --pc)
#pragma unroll
          for (int kc = 0; kc < ksteps; ++kc) {
            const uint32_t off = (kc >> 2) * 8192 + (kc & 3) * 32;
            SS<64>::run(acc, sw128_desc(sC + off, 16, 1024),
                        sw128_desc(cons + pc * NP * 128 + off, 16, 1024),
                        pc < 2 || kc > 0);
          }
        wgmma_commit();
        wgmma_wait();
        fence_regs(acc);
        if (ltid == 0) mbar_arrive(bar(k, 1));  // the state slot is free
        stph ^= 1;
        const float q0 = expf(lt0), q1 = expf(lt1);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          acc[i] = __fmul_rn(acc[i], (i & 2) ? q1 : q0);
      }
      // the s tiles in turn: M' on the CUDA cores, then its product on the
      // tensor cores (the other consumer warpgroup's M' runs meanwhile)
      for (int j = 0; j < n_s; ++j) {
        Pieces pc;
        mprime(pc,
               reinterpret_cast<const float4*>(gbase + p.cb_off +
                                               j * p.region) + ltid,
               ls + kRows * j, dts + kRows * j, lt0, lt1, tg0, kRows * j, tq,
               j == tt || ragged, L);
        mbar_wait_warp(bar(k, kXFull + xs), xph);
        start_mx(acc, pc, cons + p.state_bytes + xs * kXBytes);
        wgmma_wait();
        fence_regs(acc);
        if (ltid == 0) mbar_arrive(bar(k, kXEmpty + xs));
        if (++xs == kXStages) {
          xs = 0;
          xph ^= 1;
        }
      }
      // y rounded to bf16 once. The sums are read on every thread, ahead
      // of any branch (the compiler fences wgmma around a read of their
      // registers under a branch it cannot prove uniform); only a tile
      // that runs past the chunk stores under the row's bound
      uint32_t out[2][8];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          out[i][jj] = bits(__floats2bfloat162_rn(acc[4 * jj + 2 * i],
                                                  acc[4 * jj + 2 * i + 1]));
          asm volatile("" : "+r"(out[i][jj]));
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int tg = tg0 + 8 * i;
        bf16* yr = a.y + (((int64_t)row_c + tg) * dm.nh + h) * dm.hd + 2 * tq;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          if (8 * jj < dm.hd && (!ragged || tg < L))
            *reinterpret_cast<uint32_t*>(yr + 8 * jj) = out[i][jj];
      }
      mbar_arrive(bar(k, kScalEmpty + ss));  // every consumer thread
      if (++ss == kScalStages) {
        ss = 0;
        sph ^= 1;
      }
    }
  }
}

// slab i of x (32 rows x 64 of d) and of B (32 rows x NP) into its stage
// of chunk_state_tc's ring
template <int NP>
__device__ __forceinline__ void load_slab(const CUtensorMap* mx,
                                          const CUtensorMap* mb,
                                          uint32_t base, uint32_t bar_full,
                                          int i, int h, int g, int row_c) {
  using P = SlabPlan<NP>;
  const int st = i % kSlabStages;
  const uint32_t bar = bar_full + 8 * st, dst = base + st * P::STAGE;
  mbar_expect_tx(bar, P::STAGE);
  tma_load(dst, mx, bar, 0, h, row_c + kSlab * i);
  for (int cb = 0; cb < NP / 64; ++cb)
    tma_load(dst + P::X_BYTES + cb * kSlab * 128, mb, bar, 64 * cb, g,
             row_c + kSlab * i);
}

// four 8 x 8 b16 matrices from shared memory, transposed: lanes 8i .. 8i + 7
// give the rows of matrix i, and each thread gets, of matrix i, rows 2 tq
// and 2 tq + 1 at column g (in the A-fragment order of a wgmma)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 1. S_c^T (N x hd) = B'^T x for one (b, chunk, head), over 32-step slabs of
// t: B'[t, n] = B[t, n] w[t], w[t] = dt[t] exp(lcum[L-1] - lcum[t]), is the
// A operand, read transposed from B's swizzled slab into registers
// (ldmatrix), scaled and split into three bf16 pieces there; x (exact
// bf16, MN-major) is the B operand in shared memory; NP / 64 row blocks of
// 64 n, each its own accumulator. Nothing is written to shared memory
// after TMA, so a slab needs no barrier beyond its full barrier.
template <int NP>
__global__ void __launch_bounds__(128)
    chunk_state_tc(const __grid_constant__ CUtensorMap mx,
                   const __grid_constant__ CUtensorMap mb,
                   const float* __restrict__ dtT,
                   const float* __restrict__ lcum,
                   float* __restrict__ states, Dims dm) {
  using P = SlabPlan<NP>;
  constexpr int MB = NP / 64;  // row blocks of S_c^T
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const int L = dm.chunk, n_sub = (L + kSlab - 1) / kSlab;
  float* w = reinterpret_cast<float*>(gbase + P::W_OFF);
  const uint32_t bar_full = base + P::W_OFF + round_up(n_sub * kSlab * 4, 16);

  const int64_t id = blockIdx.x;  // (b, c, h)
  const int h = (int)(id % dm.nh);
  const int64_t bc = id / dm.nh;
  const int c = (int)(bc % dm.n_chunks);
  const int64_t b = bc / dm.n_chunks;
  const int g = h / dm.hpg;
  const int row_c = (int)(b * dm.seqlen + (int64_t)c * L);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < kSlabStages; ++st) mbar_init(bar_full + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int i = 0; i < n_sub && i < kSlabStages; ++i)
      load_slab<NP>(&mx, &mb, base, bar_full, i, h, g, row_c);
  const int64_t row = ((int64_t)b * dm.nh + h) * dm.seqlen + (int64_t)c * L;
  const float lend = lcum[row + L - 1];
  for (int t = tid; t < n_sub * kSlab; t += 128)
    w[t] = t < L ? __fmul_rn(dtT[row + t], expf(__fsub_rn(lend, lcum[row + t])))
                 : 0.0f;
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  // this lane's row of the four matrices ldmatrix reads: matrix mi = lane /
  // 8 covers t rows 8 (mi / 2) .. + 7 and n columns 16 warp + 8 (mi % 2)
  // .. + 7 of a k16 step and row block
  const int lrow = (lane & 7) + 8 * (lane >> 4);
  const int lcol = 16 * warp + 8 * ((lane >> 3) & 1);
  float acc[MB][32];
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0.0f;
  for (int i = 0; i < n_sub; ++i) {
    const int st = i % kSlabStages;
    mbar_wait_warp(bar_full + 8 * st, (i / kSlabStages) & 1);
    const uint32_t xs = base + st * P::STAGE, bs = xs + P::X_BYTES;
    const float* wi = w + kSlab * i;
    uint32_t pc[MB][kSlab / 16][3][4];  // [row block][k16][lo, mid, hi]
#pragma unroll
    for (int kk = 0; kk < kSlab / 16; ++kk) {
      const float2 w0 = *reinterpret_cast<const float2*>(wi + 16 * kk + 2 * tq);
      const float2 w8 =
          *reinterpret_cast<const float2*>(wi + 16 * kk + 8 + 2 * tq);
      const int t = 16 * kk + lrow;
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        const int col = 64 * m + lcol;  // (a multiple of 8)
        uint32_t raw4[4];
        ldsm_x4_trans(raw4, bs + (col >> 6) * (kSlab * 128) + t * 128 +
                                ((((col & 63) >> 3) ^ (t & 7)) << 4));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&raw4[q]));
          const float2 wq = q < 2 ? w0 : w8;  // t of matrices 0, 1 or 2, 3
          split3(__fmul_rn(f.x, wq.x), __fmul_rn(f.y, wq.y), pc[m][kk][2][q],
                 pc[m][kk][1][q], pc[m][kk][0][q]);
        }
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSlab / 16; ++kk) {
      const uint64_t xd = sw128_desc(xs + 2048 * kk, kSlab * 128, 1024);
#pragma unroll
      for (int m = 0; m < MB; ++m)
#pragma unroll
        for (int pp = 0; pp < 3; ++pp) RS<64>::run(acc[m], pc[m][kk][pp], xd);
    }
    wgmma_commit();
    wgmma_wait();
#pragma unroll
    for (int m = 0; m < MB; ++m) fence_regs(acc[m]);
    // the slab is done: its stage takes the slab kSlabStages on
    if (tid == 0 && i + kSlabStages < n_sub)
      load_slab<NP>(&mx, &mb, base, bar_full, i + kSlabStages, h, g, row_c);
  }
  // S_c[d, n] from S_c^T's accumulators: row n = 64 m + 16 warp + gq (+ 8),
  // column d = 8 jj + 2 tq (+ 1)
  float* out = states + ((b * dm.n_chunks + c) * dm.nh + h) *
                            ((int64_t)dm.hd * dm.n);
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = 64 * m + 16 * warp + gq + 8 * i;
      if (n >= dm.n) continue;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int d = 8 * jj + 2 * tq;
        if (d >= dm.hd) break;
        out[(int64_t)d * dm.n + n] = acc[m][4 * jj + 2 * i];
        out[(int64_t)(d + 1) * dm.n + n] = acc[m][4 * jj + 2 * i + 1];
      }
    }
}

// 2. entry states in chunk order as three bf16 pieces each (chunk_scan_tc's
// K-major, 128-byte-swizzled operand of 64 rows of d x np, zero past hd
// and N), and the final state in f32; a thread the 8 values (n0 .. n0 + 7)
// of a row d that make one 16-byte chunk of each piece, the S_c of 4
// chunks loaded ahead of the recurrence that needs them
__global__ void __launch_bounds__(256)
    state_passing_pieces(const float* __restrict__ states,
                         const float* __restrict__ lcum,
                         bf16* __restrict__ pieces,
                         float* __restrict__ state_out, Dims dm, int np) {
  constexpr int kBatch = 4;
  const int per_row = np / 8, per_head = 64 * per_row;
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= dm.batch * dm.nh * per_head) return;
  const int e = (int)(i % per_head);
  const int64_t bh = i / per_head;  // (b, h)
  const int h = (int)(bh % dm.nh);
  const int64_t b = bh / dm.nh;
  const int d = e / per_row, n0 = 8 * (e % per_row);
  const bool real = d < dm.hd && n0 < dm.n;  // N is a multiple of 16
  const int64_t hdn = (int64_t)dm.hd * dm.n;
  const float* lend = lcum + bh * dm.seqlen + dm.chunk - 1;
  const float* sp = states + (b * dm.n_chunks * dm.nh + h) * hdn +
                    (real ? (int64_t)d * dm.n + n0 : 0);
  const int64_t step = dm.nh * hdn;  // from one chunk's S_c to the next
  const int64_t piece = (int64_t)np * 8;  // one piece, in 16-byte chunks
  uint4* pp = reinterpret_cast<uint4*>(pieces) +
              (b * dm.n_chunks * dm.nh + h) * 3 * piece +
              ((n0 >> 6) * 8192 + d * 128 + ((((n0 & 63) >> 3) ^ (d & 7)) << 4)) /
                  16;
  const int64_t pstep = dm.nh * 3 * piece;  // one chunk's pieces to the next
  float s[8] = {};
  for (int c0 = 0; c0 < dm.n_chunks; c0 += kBatch) {
    float4 sc[kBatch][2];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        sc[j][q] = real && c0 + j < dm.n_chunks
                       ? reinterpret_cast<const float4*>(sp + (c0 + j) * step)[q]
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int c = c0 + j;
      if (c >= dm.n_chunks) break;
      if (c > 0) {
        uint32_t hi[4], mid[4], lo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split3(s[2 * q], s[2 * q + 1], hi[q], mid[q], lo[q]);
        uint4* dst = pp + c * pstep;
        dst[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        dst[piece] = make_uint4(mid[0], mid[1], mid[2], mid[3]);
        dst[2 * piece] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      const float dec = expf(lend[(int64_t)c * dm.chunk]);
      const float v[8] = {sc[j][0].x, sc[j][0].y, sc[j][0].z, sc[j][0].w,
                          sc[j][1].x, sc[j][1].y, sc[j][1].z, sc[j][1].w};
#pragma unroll
      for (int q = 0; q < 8; ++q) s[q] = __fadd_rn(__fmul_rn(s[q], dec), v[q]);
    }
  }
  if (real) {
    float4* out =
        reinterpret_cast<float4*>(state_out + bh * hdn + (int64_t)d * dm.n + n0);
    out[0] = make_float4(s[0], s[1], s[2], s[3]);
    out[1] = make_float4(s[4], s[5], s[6], s[7]);
  }
}

// a 3-D map over a contiguous (rows, mid, cols) bf16 tensor, read in boxes
// of 64 columns x 1 x `box_rows` rows, 128-byte swizzled; columns past
// `cols` and rows past `rows` read as zeros
int map3(CUtensorMap* map, const void* x, int64_t cols, int64_t mid,
         int64_t rows, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)mid,
                              (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)(cols * 2),
                                 (cuuint64_t)(mid * cols * 2)};
  const cuuint32_t box[3] = {64, 1, (cuuint32_t)box_rows};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NP>
int launch_state(const CUtensorMap& mx, const CUtensorMap& mb,
                 const float* dtT, const float* lcum, float* states,
                 const Dims& dm, cudaStream_t stream) {
  const int smem = SlabPlan<NP>::smem(dm.chunk);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      chunk_state_tc<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  chunk_state_tc<NP><<<(unsigned)(dm.batch * dm.n_chunks * dm.nh), 128, smem,
                       stream>>>(mx, mb, dtT, lcum, states, dm);
  return (int)cudaGetLastError();
}

template <int NP>
int launch_scan(const CUtensorMap& mx, const CUtensorMap& mb,
                const CUtensorMap& mc, const ScanArgs& args, int64_t blocks,
                cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      chunk_scan_tc<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      args.p.smem);
  if (e != cudaSuccess) return (int)e;
  chunk_scan_tc<NP><<<(unsigned)blocks, 128 * args.p.ncons + 32,
                      args.p.smem, stream>>>(mx, mb, mc, args);
  return (int)cudaGetLastError();
}

int run(const bf16* x, const float* dt, const float* a, const bf16* bm,
        const bf16* cm, bf16* y, float* state, float* lcum, float* states,
        bf16* pieces, const Dims& dm, cudaStream_t stream) {
  const int64_t rows = dm.batch * dm.seqlen;
  const int64_t heads = dm.batch * dm.n_chunks * dm.nh;
  if (dm.hd % 16 || dm.n % 16 || dm.chunk % 16 || dm.hd > 64 || dm.n > 256 ||
      rows + 512 > 0x7fffffff || heads > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  ScanPlan p = scan_plan(dm.n, dm.chunk, 2);
  if (p.smem > kSmemMax) p = scan_plan(dm.n, dm.chunk, 1);
  const int64_t scan_blocks = (int64_t)p.n_tt * dm.batch * dm.n_chunks *
                              dm.groups;
  const int64_t pair_blocks = (dm.batch * dm.nh * 8 * p.np + 255) / 256;
  if (p.smem > kSmemMax || scan_blocks > 0x7fffffff ||
      pair_blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx64, mx32, mb64, mb32, mc64;
  int e = map3(&mx64, x, dm.hd, dm.nh, rows, kRows);
  if (!e) e = map3(&mx32, x, dm.hd, dm.nh, rows, kSlab);
  if (!e) e = map3(&mb64, bm, dm.n, dm.groups, rows, kRows);
  if (!e) e = map3(&mb32, bm, dm.n, dm.groups, rows, kSlab);
  if (!e) e = map3(&mc64, cm, dm.n, dm.groups, rows, kRows);
  if (e) return e;
  float* dtT = lcum + rows * dm.nh;  // the second half of lcum's workspace
  chunk_cumsum<<<(unsigned)heads, 32, 0, stream>>>(dt, a, lcum, dtT, dm);
  cudaError_t ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  switch (p.np) {
    case 64:
      e = launch_state<64>(mx32, mb32, dtT, lcum, states, dm, stream);
      break;
    case 128:
      e = launch_state<128>(mx32, mb32, dtT, lcum, states, dm, stream);
      break;
    default:
      e = launch_state<256>(mx32, mb32, dtT, lcum, states, dm, stream);
  }
  if (e) return e;
  state_passing_pieces<<<(unsigned)pair_blocks, 256, 0, stream>>>(
      states, lcum, pieces, state, dm, p.np);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  const ScanArgs args{lcum, dtT, pieces, y, dm, p};
  switch (p.np) {
    case 64:
      return launch_scan<64>(mx64, mb64, mc64, args, scan_blocks, stream);
    case 128:
      return launch_scan<128>(mx64, mb64, mc64, args, scan_blocks, stream);
    default:
      return launch_scan<256>(mx64, mb64, mc64, args, scan_blocks, stream);
  }
}

}  // namespace tc

}  // namespace

// x, bm, cm and y are f32 (kind 0) or bf16 (kind 1: the CUDA-core kernels;
// kind 2: the tensor-core kernels); dt, a, state and the f32 workspaces
// lcum (batch, nh, seqlen; for kind 2 twice that, the second half dt
// transposed) and states (batch, seqlen / chunk, nh, hd, n).
// ``work`` is, for kinds 0 and 1, C.B in f32 (batch, seqlen / chunk,
// groups, chunk, chunk); for kind 2 the entry states' bf16 pieces (batch,
// seqlen / chunk, nh, 3 * 64 * np), np the padded N of tc::padded_n.
// Launches on ``stream`` (five, or four for kind 2); returns the first
// launch error.
extern "C" int repro_ssd_chunked(const void* x, const float* dt,
                                 const float* a, const void* bm,
                                 const void* cm, void* y, float* state,
                                 float* lcum, float* states, void* work,
                                 int64_t batch, int64_t seqlen, int64_t nh,
                                 int64_t hd, int64_t groups, int64_t n,
                                 int64_t chunk, int64_t kind, void* stream) {
  if (batch < 1 || seqlen < 1 || nh < 1 || hd < 1 || groups < 1 || n < 1 ||
      chunk < 1 || nh % groups || seqlen % chunk || nh > 0x7fffffff ||
      hd > 0x7fffffff || n > 0x7fffffff || chunk > 0x7fffffff ||
      seqlen / chunk > 0x7fffffff || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  const Dims dm{batch,       seqlen,   (int)nh,
                (int)hd,     (int)groups, (int)n,
                (int)chunk,  (int)(nh / groups), (int)(seqlen / chunk)};
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (kind == 2)
    return tc::run(static_cast<const bf16*>(x), dt, a,
                   static_cast<const bf16*>(bm), static_cast<const bf16*>(cm),
                   static_cast<bf16*>(y), state, lcum, states,
                   static_cast<bf16*>(work), dm, s);
  float* cbT = static_cast<float*>(work);
  if (kind == 1)
    return run_fma<bf16>(x, dt, a, bm, cm, y, state, lcum, states, cbT, dm,
                         s);
  return run_fma<float>(x, dt, a, bm, cm, y, state, lcum, states, cbT, dm, s);
}
