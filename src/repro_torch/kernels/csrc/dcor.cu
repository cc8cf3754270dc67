// Pairwise Euclidean distances: x (n, d) f32 -> D (n, n) f32,
//   D_ij = sqrt(max(|x_i|^2 + |x_j|^2 - 2 x_i . x_j, 0)),   D_ii = 0 exactly.
// The distance matrices of distance correlation (dCor, the privacy metric):
// n images against a flattened input or activation of d values each.
//
// Replaces the TPU kernel src/repro/kernels/dcor/kernel.py::pairwise_dists.
//
// Bound on the H100: bytes at the privacy profile's shapes. A call reads x
// once (4 n d bytes) and needs n (n + 1) d FP32 operations for the Gram
// matrix x x^T, which is symmetric: n (n + 1) / 2 dot products of d
// multiply-adds. The bytes (3.35 TB/s) take longer than those operations
// (67 TFLOP/s) by a factor 80 / (n + 1), 1.63 at n = 48. At VGG16's widest
// activation (d = 3,211,264) that is 0.184 ms against 0.113 ms for the
// operations. This kernel computes the whole Gram, twice the operations.
//
// Design. The TPU kernel walks d in 512-wide chunks on its sequential grid
// axis, carrying si + sj - 2 xi.xj in a VMEM scratch. Here blocks run in
// parallel, so d is split instead: pass 1 gives each block one contiguous
// range of d (about four blocks an SM in all) and one (i, j) tile of rows.
// The block stages 32 columns of its rows at a time in shared memory
// (float4 loads, coalesced along d) and each of its 16 x 16 threads
// accumulates a kMt x kMt register tile of x_i . x_j with FP32 FMAs (not
// TF32: that would move the f32 parity). A tile has 16 kMt rows, the
// fewest multiple of 16 that holds n up to 128 (48 rows, kMt = 3, at the
// profile's n = 48), and rows go to threads with stride 16, so every
// thread holds useful pairs. The block writes its partial Gram tile to a
// workspace of (splits, n, n) floats, whose diagonals are the partial
// squared norms. Pass 2 gives a block 32 elements (i, j) of D, one a lane,
// and its warps the splits in a fixed stride; warp 0 adds the warps' sums
// in order, forms (G_ii + G_jj) - 2 G_ij as the reference orders it, clamps
// at 0, takes the sqrt and pins the diagonal to 0. No atomics: a run gives
// the same bits every time, and since x_i . x_j and x_j . x_i round alike,
// D is symmetric bit for bit.
//
// Later work: the symmetry (half the tiles), TMA loads with a pipelined
// ring of slabs, and 3xTF32 products on wgmma with a stated tolerance.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr int kSlab = 32;          // columns staged in shared memory at once
constexpr int kPitch = kSlab + 4;  // floats a staged row: conflict-free float4

// Rows [r0, r0 + kTile) and columns [k0, k0 + kSlab) of x into s, with
// zeros for rows >= n and columns >= k_end.
template <int kTile>
__device__ __forceinline__ void stage(const float* __restrict__ x,
                                      float* __restrict__ s, int64_t n,
                                      int64_t d, int64_t r0, int64_t k0,
                                      int64_t k_end, bool vec) {
  constexpr int kQuads = kSlab / 4;
  for (int slot = threadIdx.x; slot < kTile * kQuads; slot += kThreads) {
    const int r = slot / kQuads, q = slot % kQuads;
    const int64_t row = r0 + r, k = k0 + 4 * q;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row < n && k < k_end) {
      const float* p = x + row * d + k;
      if (vec && k + 4 <= k_end) {
        v = *reinterpret_cast<const float4*>(p);
      } else {
        v.x = p[0];
        if (k + 1 < k_end) v.y = p[1];
        if (k + 2 < k_end) v.z = p[2];
        if (k + 3 < k_end) v.w = p[3];
      }
    }
    *reinterpret_cast<float4*>(s + r * kPitch + 4 * q) = v;
  }
}

// Pass 1: block (split, tile pair) writes work[split][i][j] for the rows i
// of tile ti and j of tile tj, summed over columns
// [split * chunk, min(d, (split + 1) * chunk)).
template <int kMt>
__global__ void __launch_bounds__(kThreads)
    gram_partial(const float* __restrict__ x, float* __restrict__ work,
                 int64_t n, int64_t d,
                 int64_t chunk, int tiles, bool vec) {
  constexpr int kTile = 16 * kMt;
  __shared__ __align__(16) float sa[kTile * kPitch];
  __shared__ __align__(16) float sb[kTile * kPitch];
  const int ti = blockIdx.y / tiles, tj = blockIdx.y % tiles;
  const int64_t split = blockIdx.x;
  const int64_t k_begin = split * chunk;
  const int64_t k_end = k_begin + chunk < d ? k_begin + chunk : d;
  const int64_t ri = (int64_t)ti * kTile, rj = (int64_t)tj * kTile;
  const bool same = ti == tj;  // a diagonal tile stages its rows once
  const float* sB = same ? sa : sb;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[kMt][kMt];
#pragma unroll
  for (int r = 0; r < kMt; ++r)
#pragma unroll
    for (int c = 0; c < kMt; ++c) acc[r][c] = 0.0f;
  for (int64_t k0 = k_begin; k0 < k_end; k0 += kSlab) {
    stage<kTile>(x, sa, n, d, ri, k0, k_end, vec);
    if (!same) stage<kTile>(x, sb, n, d, rj, k0, k_end, vec);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kSlab / 4; ++q) {
      float4 a[kMt], b[kMt];
#pragma unroll
      for (int r = 0; r < kMt; ++r) {
        a[r] = *reinterpret_cast<const float4*>(sa + (ty + 16 * r) * kPitch
                                                + 4 * q);
        b[r] = *reinterpret_cast<const float4*>(sB + (tx + 16 * r) * kPitch
                                                + 4 * q);
      }
#pragma unroll
      for (int r = 0; r < kMt; ++r)
#pragma unroll
        for (int c = 0; c < kMt; ++c) {
          acc[r][c] = fmaf(a[r].x, b[c].x, acc[r][c]);
          acc[r][c] = fmaf(a[r].y, b[c].y, acc[r][c]);
          acc[r][c] = fmaf(a[r].z, b[c].z, acc[r][c]);
          acc[r][c] = fmaf(a[r].w, b[c].w, acc[r][c]);
        }
    }
    __syncthreads();  // the slab is overwritten next
  }
  float* w = work + split * n * n;
#pragma unroll
  for (int r = 0; r < kMt; ++r)
#pragma unroll
    for (int c = 0; c < kMt; ++c) {
      const int64_t i = ri + ty + 16 * r, j = rj + tx + 16 * c;
      if (i < n && j < n) w[i * n + j] = acc[r][c];
    }
}

// Pass 2: D from the partial Grams. A block owns 32 consecutive elements
// of D, one a lane; warp w sums splits w, w + warps, ... in that order,
// then warp 0 adds the warps' sums in warp order. G_ii and G_jj are read
// from the partial Grams' diagonals.
__global__ void finish(const float* __restrict__ work, float* __restrict__ out,
                       int64_t n, int64_t splits) {
  __shared__ float part[3][32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int64_t idx = (int64_t)blockIdx.x * 32 + lane;
  const bool live = idx < n * n;
  const int64_t i = live ? idx / n : 0, j = live ? idx % n : 0;
  float g = 0.0f, gi = 0.0f, gj = 0.0f;
  if (live) {
#pragma unroll 4
    for (int64_t s = warp; s < splits; s += warps) {
      const float* w = work + s * n * n;
      g = __fadd_rn(g, w[idx]);
      gi = __fadd_rn(gi, w[i * (n + 1)]);
      gj = __fadd_rn(gj, w[j * (n + 1)]);
    }
  }
  part[0][warp][lane] = g;
  part[1][warp][lane] = gi;
  part[2][warp][lane] = gj;
  __syncthreads();
  if (warp != 0 || !live) return;
  for (int w = 1; w < warps; ++w) {
    g = __fadd_rn(g, part[0][w][lane]);
    gi = __fadd_rn(gi, part[1][w][lane]);
    gj = __fadd_rn(gj, part[2][w][lane]);
  }
  if (i == j) {  // the expansion cancels catastrophically here
    out[idx] = 0.0f;
    return;
  }
  const float d2 = __fsub_rn(__fadd_rn(gi, gj), __fmul_rn(2.0f, g));
  out[idx] = sqrtf(fmaxf(d2, 0.0f));
}

}  // namespace

// x (n, d) row-major; work (splits, n, n) scratch: the partial Grams;
// out (n, n). tile, the rows a tile, is a
// multiple of 16 up to 128; chunk, a multiple of 32, the columns a block
// sums; splits = ceil(d / chunk).
extern "C" int repro_pairwise_dists_f32(const float* x, float* work,
                                        float* out, int64_t n, int64_t d,
                                        int64_t tile, int64_t chunk,
                                        int64_t splits, void* stream) {
  if (n < 1 || d < 1 || chunk < kSlab || chunk % kSlab != 0 || splits < 1 ||
      splits > 0x7fffffff || (splits - 1) * chunk >= d || splits * chunk < d)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (n + tile - 1) / tile;
  if (tiles * tiles > 65535 || n * n / 32 >= 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // rows of d % 4 == 0 values stay 16-byte aligned from an aligned base
  const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0;
  const dim3 grid((unsigned)splits, (unsigned)(tiles * tiles));
  switch (tile) {
#define REPRO_GRAM(MT)                                                 \
  case 16 * MT:                                                        \
    gram_partial<MT><<<grid, kThreads, 0, s>>>(x, work, n, d, chunk,   \
                                               (int)tiles, vec);        \
    break;
    REPRO_GRAM(1) REPRO_GRAM(2) REPRO_GRAM(3) REPRO_GRAM(4)
    REPRO_GRAM(5) REPRO_GRAM(6) REPRO_GRAM(7) REPRO_GRAM(8)
#undef REPRO_GRAM
    default:
      return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (n * n + 31) / 32;
  const int warps = splits < 32 ? (int)splits : 32;
  finish<<<(unsigned)blocks, 32 * warps, 0, s>>>(work, out, n, splits);
  return (int)cudaGetLastError();
}
