// Pairwise Euclidean distances: x (n, d) f32 -> D (n, n) f32,
//   D_ij = sqrt(max(|x_i|^2 + |x_j|^2 - 2 x_i . x_j, 0)),   D_ii = 0 exactly.
// The distance matrices of distance correlation (dCor, the privacy metric):
// n images against a flattened input or activation of d values each.
//
// Replaces the TPU kernel src/repro/kernels/dcor/kernel.py::pairwise_dists
// (:49, its pallas_call at :61).
//
// Bound on the H100: bytes at the privacy profile's shapes. A call reads x
// once (4 n d bytes) and needs n (n + 1) d FP32 operations for the Gram
// matrix x x^T, which is symmetric: n (n + 1) / 2 dot products of d
// multiply-adds. The bytes (3.35 TB/s) take longer than those operations
// (67 TFLOP/s) by a factor 80 / (n + 1), 1.63 at n = 48. At VGG16's widest
// activation (d = 3,211,264) that is 0.184 ms against 0.113 ms for the
// operations, so the FMAs must run at 60% of the card's rate while x
// streams at its full rate.
//
// Design. The TPU kernel walks d in 512-wide chunks on its sequential grid
// axis, carrying si + sj - 2 xi.xj in a VMEM scratch. Two routes, chosen
// by the wrapper from the shape (never after a failure): rows of at most
// 8,192 values take the tile route (pairwise_tiles, below), where latency,
// not bytes or FMAs, sets the time; longer ones the split route.
//
// The split route. d is split across blocks, one wave of two blocks an SM,
// each over one range of
// whole 96-column slabs, and the rows are cut into 48-row tiles: a block
// owns one pair of tiles (I <= J; n = 48 is one diagonal pair) and computes
// only the pairs i <= j of its tiles. A tile's rows fall into six groups of
// eight, group a holding rows a, a + 6, ..., a + 42 (so the eight rows a
// thread reads at once are six apart and the six groups' rows sit in
// distinct shared-memory banks). A thread owns one 8 x 8 register tile
// (groups a, b: 16 reads of shared memory for 64 FMAs, against 6 for 9 in
// the first port's 3 x 3 tiles) over one column group of each slab: a
// diagonal tile pair has 21 register tiles (a <= b) x 12 column groups, an
// off-diagonal one 36 x 7, 252 of the block's 256 threads. Slabs come in by
// cp.async (16 B; each loader thread keeps one column quad and a running
// row pointer) through a ring of four stages, so later slabs load while
// the FMAs run on the current one; rows whose pitch or base is not 16-byte
// aligned take scalar loads into the same ring. FP32 FMAs, not TF32: that
// would move the f32 parity. Reading 16 bytes of shared memory for every
// 4 FMAs, the loop is held by shared-memory bandwidth about as much as by
// the FMA rate (PERF.md).
//
// The same launch finishes D, with every sum in a fixed order and no float
// atomics, so a call repeats bit for bit and D is symmetric bit for bit.
// A block adds its column groups' sums in group order into its partial
// triangle (pairs i <= j, compact()) in shared memory. The splits run in
// clusters of up to 8 consecutive ones; the cluster adds its partials in
// rank order through distributed shared memory, rank r taking the r-th
// slice of the entries (and every rank the squared norms). With one
// cluster a tile pair, each rank then forms D on its slice: (G_ii + G_jj)
// - 2 G_ij as the reference orders it, clamped at 0, its sqrt stored as
// D_ij and D_ji, the diagonal pinned to 0. With more, each rank writes its
// slice to a workspace and takes a ticket (a release/acquire atomic after
// a barrier); the last cluster to arrive adds the clusters' slices in
// cluster order first. With more than one tile pair the norms of an
// off-diagonal pair come from two others, so the final Gram goes to the
// workspace and the last rank of all forms D. Each ticket is reset to 0 by
// the block that read it last, so the tickets need no memset: one launch a
// call.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using sm90::kMaxCluster;
using sm90::ticket_add;

constexpr int R = 48;               // rows a tile
constexpr int kGroups = 6;          // row groups a tile, of 8 rows 6 apart
constexpr int kSlab = 96;           // columns a stage
constexpr int kQuads = kSlab / 4;   // float4s a staged row
constexpr int kPitch = kSlab + 4;   // floats a staged row: rows 16 B apart
                                    // in the banks (a multiple of 4 floats)
constexpr int kStages = 4;
constexpr int kThreads = 256;
constexpr int kActive = 252;        // threads that own a register tile
constexpr int kTileElems = R * R;   // floats a partial (tile-local)
constexpr int kDiagElems = R * (R + 1) / 2;  // pairs i <= j of a tile
static_assert(21 * 12 == kActive && 36 * 7 == kActive, "thread map");
static_assert(64 * kActive + kTileElems <= kStages * R * kPitch,
              "the column groups' sums and the partial fit the ring");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// index of the tile pair (I, J), I <= J, among `tiles` tiles: row-major
// over the upper triangle (blockIdx.y's order)
__device__ __forceinline__ int pair_index(int I, int J, int tiles) {
  return I * tiles - I * (I - 1) / 2 + (J - I);
}

// register tile rt of a tile pair whose rows fall into kK groups -> its
// row groups (a, b): diagonal tile pairs take a <= b in row-major order,
// others all kK^2 as (rt / kK, rt % kK)
template <int kK>
__device__ __forceinline__ void groups_of(int rt, bool diag, int& a, int& b) {
  if (!diag) {
    a = rt / kK;
    b = rt % kK;
    return;
  }
  // row a of the triangle starts at a (2 kK + 1 - a) / 2: the largest a
  // whose start is at most rt, in closed form (exact for small kK)
  constexpr float w = 2 * kK + 1;
  a = (int)((w - sqrtf(w * w - 8.0f * rt)) * 0.5f);
  b = rt - a * (2 * kK + 1 - a) / 2 + a;
}

// where tile-local pair (li, lj) sits in a partial: a diagonal tile
// pair's li <= lj row-major over the upper triangle, others all 48 x 48
__device__ __forceinline__ int compact(int li, int lj, bool diag) {
  return diag ? li * R - li * (li - 1) / 2 + (lj - li) : li * R + lj;
}

// its inverse on a diagonal tile pair
__device__ __forceinline__ void uncompact(int c, int& li, int& lj) {
  li = 0;
  while (c >= R - li) {
    c -= R - li;
    ++li;
  }
  lj = li + c;
}

// src[0] + src[stride] + ... over `count` values, added in that order,
// loaded kBatch at a time, each batch's loads issued before its adds
__device__ __forceinline__ float sum_in_order(const float* src, int count,
                                             int64_t stride) {
  constexpr int kBatch = 16;
  float acc = 0.0f;
  for (int s0 = 0; s0 < count; s0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (s0 + u < count) v[u] = __ldcg(src + (s0 + u) * stride);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (s0 + u < count) acc = s0 + u == 0 ? v[u] : __fadd_rn(acc, v[u]);
  }
  return acc;
}

// acc[ii][jj] += x_(a + 6 ii) . x_(b + 6 jj) over the column group's quads
// of one staged slab (rows a and b are offsets into the stage)
template <int kCols>
__device__ __forceinline__ void accumulate(float (&acc)[8][8],
                                           const float* __restrict__ s,
                                           int row_a, int row_b, int cg) {
#pragma unroll
  for (int qq = 0; qq < (kQuads + kCols - 1) / kCols; ++qq) {
    const int q = cg + qq * kCols;
    if (q >= kQuads) break;
    const float* pa = s + row_a * kPitch + 4 * q;
    const float* pb = s + row_b * kPitch + 4 * q;
    float4 av[8];
#pragma unroll
    for (int ii = 0; ii < 8; ++ii)
      av[ii] = *reinterpret_cast<const float4*>(pa + kGroups * ii * kPitch);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float4 bv =
          *reinterpret_cast<const float4*>(pb + kGroups * jj * kPitch);
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        acc[ii][jj] = fmaf(av[ii].x, bv.x, acc[ii][jj]);
        acc[ii][jj] = fmaf(av[ii].y, bv.y, acc[ii][jj]);
        acc[ii][jj] = fmaf(av[ii].z, bv.z, acc[ii][jj]);
        acc[ii][jj] = fmaf(av[ii].w, bv.w, acc[ii][jj]);
      }
    }
  }
}

// the column groups' sums of a block, added in group order, into its
// partial `mine` (compact()); red is [64][kActive], register e of thread t
// at red[e kActive + t]
template <int kNt, int kNcg, bool kDiag>
__device__ __forceinline__ void combine(const float* __restrict__ red,
                                        float* __restrict__ mine) {
#pragma unroll
  for (int k = 0; k < (kNt * 64 + kThreads - 1) / kThreads; ++k) {
    const int o = threadIdx.x + k * kThreads;
    if (o >= kNt * 64) break;
    const int r = o % kNt, e = o / kNt;
    float v = red[e * kActive + r];
#pragma unroll
    for (int c = 1; c < kNcg; ++c)
      v = __fadd_rn(v, red[e * kActive + c * kNt + r]);
    int ga, gb;
    groups_of<kGroups>(r, kDiag, ga, gb);
    const int li = ga + kGroups * (e >> 3), lj = gb + kGroups * (e & 7);
    if (!kDiag)
      mine[li * R + lj] = v;
    else if (ga != gb || li <= lj)  // x_i.x_j and x_j.x_i: one value
      mine[compact(min(li, lj), max(li, lj), true)] = v;
  }
}

// sum over the cluster's C ranks of their partials' entry c, in rank order
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                            float* mine, int c, int C) {
  float v[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    if (q < C) v[q] = cluster.map_shared_rank(mine, q)[c];
  float acc = v[0];
#pragma unroll
  for (int q = 1; q < kMaxCluster; ++q)
    if (q < C) acc = __fadd_rn(acc, v[q]);
  return acc;
}

// D_ij and D_ji from the Gram entry g and the squared norms
__device__ __forceinline__ void store_dist(float* __restrict__ out, int64_t n,
                                          int64_t i, int64_t j, float g,
                                          float si, float sj) {
  if (i == j) {  // the expansion cancels catastrophically here
    out[i * n + i] = 0.0f;
    return;
  }
  const float d2 = __fsub_rn(__fadd_rn(si, sj), __fmul_rn(2.0f, g));
  const float dist = sqrtf(fmaxf(d2, 0.0f));
  out[i * n + j] = dist;
  out[j * n + i] = dist;
}

// the tile pair (I, J), I <= J, of index p among `tiles` tiles
__device__ __forceinline__ void pair_of(int p, int tiles, int& I, int& J) {
  I = 0;
  J = p;
  while (J >= tiles - I) {
    J -= tiles - I;
    ++I;
  }
  J += I;
}

// grid (splits, tile pairs) in clusters of C consecutive splits of one
// pair (splits a multiple of C; trailing splits may be empty). work: the
// clusters' sums (pairs, splits / C, 48 x 48 floats, compact()), their
// squared norms (pairs, splits / C, 48), and with more than one tile pair
// the final Gram (pairs, 48 x 48); tickets: (pairs, C) then one, zero
// (and left zero).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    pairwise(const float* __restrict__ x, float* __restrict__ work,
             float* __restrict__ out, int32_t* __restrict__ tickets,
             int64_t n, int64_t d, int64_t chunk, int tiles) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int last;
  const int tid = threadIdx.x;
  const int split = blockIdx.x, splits = gridDim.x;
  const int p = blockIdx.y, pairs = gridDim.y;

  int I, J;
  pair_of(p, tiles, I, J);
  const bool diag = I == J;
  const int rows = diag ? R : 2 * R;  // staged: tile I's rows, then J's
  const int nt = diag ? 21 : 36;
  const bool active = tid < kActive;
  const int rt = tid % nt, cg = tid / nt;
  int a, b;
  groups_of<kGroups>(rt, diag, a, b);
  const int row_a = a, row_b = (diag ? 0 : R) + b;

  const int64_t k_begin = (int64_t)split * chunk;
  const int64_t k_end = k_begin + chunk < d ? k_begin + chunk : d;
  const int nslab =
      k_end > k_begin ? (int)((k_end - k_begin + kSlab - 1) / kSlab) : 0;

  // The ring's loads. Thread t < 240 owns quad q = t % 24 of the staged
  // rows r0, r0 + 10, ... (r0 = t / 24), the same in every slab: on the
  // 16-byte route a running row pointer and one cp.async a row; quads past
  // the range are zero-filled (src-size 0), and rows past n are zeroed
  // once and never loaded.
  const int q = tid % kQuads, r0 = tid / kQuads;
  const bool loader = tid < 10 * kQuads;
  // this thread's rows of tile I (rows r0 + 10u < 48) and, off the
  // diagonal, of tile J (staged rows 48 + ...): the loaded ones, below n
  const int ui = loader ? (R - 1 - r0) / 10 + 1 : 0;        // u < ui: tile I
  const int uj = loader && !diag ? (2 * R - 1 - r0) / 10 + 1 : ui;
  auto valid_rows = [&](int u0, int u1, int64_t first_row) {
    int u = u0;
    while (u < u1 && first_row + 10 * (u - u0) < n) ++u;
    return u;
  };
  const int64_t row_i = (int64_t)I * R + r0;  // tile I's row at u = 0
  // tile J's row at the first u with r0 + 10u >= 48
  const int64_t row_j = (int64_t)J * R + r0 + 10 * ui - R;
  const int vi = valid_rows(0, ui, row_i), vj = valid_rows(ui, uj, row_j);
  if (kVec && loader)  // rows past n stay zero in every stage
    for (int st = 0; st < kStages; ++st) {
      float* z = smem + st * rows * kPitch + 4 * q;
      for (int u = vi; u < ui; ++u)
        *reinterpret_cast<float4*>(z + (r0 + 10 * u) * kPitch) =
            make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int u = vj; u < uj; ++u)
        *reinterpret_cast<float4*>(z + (r0 + 10 * u) * kPitch) =
            make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  const float* src_i = x + row_i * d + 4 * q;
  const float* src_j = x + row_j * d + 4 * q;

  // slab `slab` of the block's range into ring stage `stage`
  auto load = [&](int slab, int stage) {
    float* s = smem + stage * rows * kPitch;
    const int64_t k0 = k_begin + (int64_t)slab * kSlab;
    if constexpr (kVec) {  // d % 4 == 0: a quad is all in or all out
      const int bytes = k0 + 4 * q < k_end ? 16 : 0;
      float* dst = s + r0 * kPitch + 4 * q;
      const float* src = src_i + k0;
      for (int u = 0; u < vi; ++u, src += 10 * d)
        cp_async16(dst + 10 * u * kPitch, bytes ? src : x, bytes);
      src = src_j + k0;
      for (int u = ui; u < vj; ++u, src += 10 * d)
        cp_async16(dst + 10 * u * kPitch, bytes ? src : x, bytes);
    } else {
      for (int i = tid; i < rows * kQuads; i += kThreads) {
        const int r = i / kQuads, qq = i % kQuads;
        const int64_t row =
            r < R ? (int64_t)I * R + r : (int64_t)J * R + r - R;
        const int64_t k = k0 + 4 * qq;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = row < n && k + e < k_end ? x[row * d + k + e] : 0.0f;
        *reinterpret_cast<float4*>(s + r * kPitch + 4 * qq) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int ii = 0; ii < 8; ++ii)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[ii][jj] = 0.0f;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nslab) load(s, s);
    cp_commit();
  }
  for (int it = 0; it < nslab; ++it) {
    cp_wait<kStages - 2>();  // slab it has landed (this thread's copies)
    __syncthreads();         // ... everyone's; slab it - 1 is consumed
    const int next = it + kStages - 1;
    if (next < nslab) load(next, next % kStages);
    cp_commit();
    if (active) {
      const float* s = smem + (it % kStages) * rows * kPitch;
      if (diag)
        accumulate<12>(acc, s, row_a, row_b, cg);
      else
        accumulate<7>(acc, s, row_a, row_b, cg);
    }
  }
  cp_wait<0>();
  __syncthreads();

  // the column groups' sums, in group order, into this block's partial
  float* red = smem;                 // [64][kActive]
  float* mine = smem + 64 * kActive;  // the partial, compact()
  if (active)
#pragma unroll
    for (int e = 0; e < 64; ++e) red[e * kActive + tid] = acc[e >> 3][e & 7];
  __syncthreads();
  if (diag)
    combine<21, 12, true>(red, mine);
  else
    combine<36, 7, false>(red, mine);

  // The cluster adds its C partials in shared memory, in rank order: rank
  // r takes the entries [r slice, (r + 1) slice) (and, on a diagonal pair,
  // every rank the squared norms of its rows).
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int ncl = splits / C, cid = split / C;
  const int elems = diag ? kDiagElems : kTileElems;
  const int slice = (elems + C - 1) / C;
  const int lo = rank * slice, hi = min(lo + slice, elems);
  float* g = red;         // this rank's entries of the sum (red is free)
  float* sq = red + slice;  // squared norms of tile I's rows
  cluster.sync();
  for (int c = lo + tid; c < hi; c += kThreads)
    g[c - lo] = cluster_sum(cluster, mine, c, C);
  const bool norms = diag && pairs == 1;
  if (norms)
    for (int li = tid; li < R; li += kThreads)
      sq[li] = cluster_sum(cluster, mine, compact(li, li, true), C);
  float* cpart = work + ((int64_t)p * ncl + cid) * kTileElems;
  float* cnorm = work + (int64_t)pairs * ncl * kTileElems +
                 ((int64_t)p * ncl + cid) * R;
  if (ncl > 1) {  // this rank's entries (rank 0: the norms) for the others
    for (int c = lo + tid; c < hi; c += kThreads) cpart[c] = g[c - lo];
    if (norms && rank == 0 && tid < R) {
      cnorm[tid] = sq[tid];
      __threadfence();  // released by the other ranks' tickets too
    }
  }
  cluster.sync();  // the partials are read: blocks may leave

  if (ncl > 1) {
    // the last cluster to arrive adds the clusters' sums of this rank's
    // entries (and the norms), in cluster order
    if (tid == 0) {
      int* tk = tickets + (int64_t)p * C + rank;
      last = ticket_add(tk) == ncl - 1;
      if (last) *tk = 0;  // zero again for the next launch
    }
    __syncthreads();
    if (!last) return;
    const float* c0 = work + (int64_t)p * ncl * kTileElems;
    for (int c = lo + tid; c < hi; c += kThreads)
      g[c - lo] = sum_in_order(c0 + c, ncl, kTileElems);
    if (norms)
      for (int li = tid; li < R; li += kThreads)
        sq[li] = sum_in_order(work + (int64_t)pairs * ncl * kTileElems +
                                  (int64_t)p * ncl * R + li,
                              ncl, R);
    __syncthreads();
  }

  if (pairs == 1) {  // D from this rank's entries
    for (int c = lo + tid; c < hi; c += kThreads) {
      int li, lj;
      uncompact(c, li, lj);
      if (lj < n) store_dist(out, n, li, lj, g[c - lo], sq[li], sq[lj]);
    }
    return;
  }
  // more than one tile pair: the norms of an off-diagonal pair come from
  // two others, so the final Gram goes to the workspace, and the last
  // rank of all finishes D
  float* gfin = work + (int64_t)pairs * ncl * (kTileElems + R);
  for (int c = lo + tid; c < hi; c += kThreads)
    gfin[(int64_t)p * kTileElems + c] = g[c - lo];
  __syncthreads();
  if (tid == 0) {
    int* tk = tickets + (int64_t)pairs * C;
    last = ticket_add(tk) == pairs * C - 1;
    if (last) *tk = 0;
  }
  __syncthreads();
  if (!last) return;
  float* sqn = smem;  // the squared norms of all n rows
  for (int64_t i = tid; i < n; i += kThreads) {
    const int ti = (int)(i / R), li = (int)(i % R);
    sqn[i] = __ldcg(gfin + (int64_t)pair_index(ti, ti, tiles) * kTileElems +
                    compact(li, li, true));
  }
  __syncthreads();
  for (int q = 0; q < pairs; ++q) {
    int qi, qj;
    pair_of(q, tiles, qi, qj);
    const bool dg = qi == qj;
    const float* gq = gfin + (int64_t)q * kTileElems;
    for (int c = tid; c < (dg ? kDiagElems : kTileElems); c += kThreads) {
      int li = c / R, lj = c % R;
      if (dg) uncompact(c, li, lj);
      const int64_t i = (int64_t)qi * R + li, j = (int64_t)qj * R + lj;
      if (i < n && j < n) store_dist(out, n, i, j, __ldcg(gq + c), sqn[i],
                                     sqn[j]);
    }
  }
}

// The short-row route: one block a register tile of a tile pair over all
// of d. A tile's rows fall into kK = 48 / kG groups of kG rows (group a:
// rows a, a + kK, ...); a block owns groups (a, b) (a <= b on a diagonal
// pair), its 256 threads striding the columns (coalesced), kUnroll columns
// a thread in flight. Besides x_i . x_j it sums the squared norms of its
// rows; every block does so in the same order (a thread's columns in
// order, then the same reduction), so a norm has the same bits in every
// block that holds its row. The threads' sums are added in a fixed order
// (a warp a value: each lane 8 threads' sums in order, then a shuffle
// tree) and D is formed on the tile at once: one launch, no workspace, no
// block waits for another.
constexpr int kTileG = 4;    // rows a group: 4 x 4 tiles, 78 blocks at n 48
constexpr int kUnroll = 4;   // columns a thread in flight

// the sum over the block's 256 threads of col[t], in a fixed order, at
// lane 0 of the calling warp: lane l adds threads l, l + 32, ... in
// order, then a shuffle tree
__device__ __forceinline__ float block_sum(const float* __restrict__ col,
                                          int lane) {
  float v = col[lane];
#pragma unroll
  for (int m = 1; m < kThreads / 32; ++m) v = __fadd_rn(v, col[lane + 32 * m]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

template <int kG>
__global__ void __launch_bounds__(kThreads)
    pairwise_tiles(const float* __restrict__ x, float* __restrict__ out,
                   int64_t n, int64_t d, int tiles) {
  constexpr int kK = R / kG;                     // groups a tile
  constexpr int kValues = kG * kG + 2 * kG;      // products, norms
  extern __shared__ __align__(16) float smem[];  // [kValues][kThreads]
  __shared__ float sums[kValues];
  const int tid = threadIdx.x;
  int I, J;
  pair_of(blockIdx.y, tiles, I, J);
  const bool diag = I == J;
  const int rt = blockIdx.x;
  if (rt >= (diag ? kK * (kK + 1) / 2 : kK * kK)) return;  // grid: kK^2
  int a, b;
  groups_of<kK>(rt, diag, a, b);
  const bool same = diag && a == b;  // one row group: its rows once
  const int64_t row_a = (int64_t)I * R + a, row_b = (int64_t)J * R + b;
  // rows past n read as zeros
  int va = 0, vb = 0;
  while (va < kG && row_a + kK * va < n) ++va;
  while (vb < kG && row_b + kK * vb < n) ++vb;
  const float* xa = x + row_a * d;
  const float* xb = x + row_b * d;

  float acc[kG][kG], na[kG], nb[kG];
#pragma unroll
  for (int ii = 0; ii < kG; ++ii) {
    na[ii] = nb[ii] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kG; ++jj) acc[ii][jj] = 0.0f;
  }
  for (int64_t k0 = tid; k0 < d; k0 += kThreads * kUnroll) {
    float av[kUnroll][kG], bv[kUnroll][kG];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t k = k0 + (int64_t)u * kThreads;
#pragma unroll
      for (int ii = 0; ii < kG; ++ii) {
        av[u][ii] = k < d && ii < va ? xa[kK * ii * d + k] : 0.0f;
        bv[u][ii] = !same && k < d && ii < vb ? xb[kK * ii * d + k]
                                              : av[u][ii];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int ii = 0; ii < kG; ++ii) {
        na[ii] = fmaf(av[u][ii], av[u][ii], na[ii]);
        nb[ii] = fmaf(bv[u][ii], bv[u][ii], nb[ii]);
#pragma unroll
        for (int jj = 0; jj < kG; ++jj)
          acc[ii][jj] = fmaf(av[u][ii], bv[u][jj], acc[ii][jj]);
      }
  }
#pragma unroll
  for (int e = 0; e < kG * kG; ++e)
    smem[e * kThreads + tid] = acc[e / kG][e % kG];
#pragma unroll
  for (int i = 0; i < kG; ++i) {
    smem[(kG * kG + i) * kThreads + tid] = na[i];
    smem[(kG * kG + kG + i) * kThreads + tid] = nb[i];
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int v = warp; v < kValues; v += kThreads / 32) {
    const float s = block_sum(smem + v * kThreads, lane);
    if (lane == 0) sums[v] = s;
  }
  __syncthreads();
  if (tid < kG * kG) {
    const int ii = tid / kG, jj = tid % kG;
    const int64_t i = row_a + kK * ii, j = row_b + kK * jj;
    if (ii < va && jj < vb && (!same || ii <= jj))
      store_dist(out, n, i, j, sums[tid], sums[kG * kG + ii],
                 sums[kG * kG + kG + jj]);
  }
}

}  // namespace

// x (n, d) row-major; tiles = ceil(n / 48), pairs = tiles (tiles + 1) /
// 2, ncl = splits / cluster; work: pairs ncl (48 x 48 + 48) floats, plus
// pairs 48 x 48 with more than one tile pair; tickets: pairs cluster + 1
// int32 zeros (left zero); out (n, n). chunk, a multiple of 96, the
// columns a block sums; splits, a multiple of cluster (1 to 8), with
// splits chunk >= d.
extern "C" int repro_pairwise_dists_f32(const float* x, float* work,
                                        float* out, int32_t* tickets,
                                        int64_t n, int64_t d, int64_t chunk,
                                        int64_t splits, int64_t cluster,
                                        void* stream) {
  if (n < 1 || d < 1 || chunk < kSlab || chunk % kSlab != 0 || splits < 1 ||
      splits > 0x7fffffff || splits * chunk < d || cluster < 1 ||
      cluster > kMaxCluster || splits % cluster != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (n + R - 1) / R, pairs = tiles * (tiles + 1) / 2;
  if (pairs > 65535) return (int)cudaErrorInvalidValue;
  // rows of d % 4 == 0 values stay 16-byte aligned from an aligned base
  const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0;
  const int smem = kStages * (tiles > 1 ? 2 * R : R) * kPitch * sizeof(float);
  const auto kernel = vec ? pairwise<true> : pairwise<false>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)splits, (unsigned)pairs);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, x, work, out, tickets, n, d,
                                 chunk, (int)tiles);
}

// How many clusters of `cluster` blocks the card runs at once, for n of
// one tile (two_tiles 0) or more (1); a negative CUDA error code if it
// cannot say.
extern "C" int repro_pairwise_dists_max_clusters(int64_t cluster,
                                                 int64_t two_tiles) {
  const int smem = kStages * (two_tiles ? 2 * R : R) * kPitch * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      pairwise<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int num = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&num, pairwise<true>, &cfg);
  return e == cudaSuccess ? num : -(int)e;
}

// The short-row route: x (n, d) row-major, out (n, n); one block a
// register tile of a tile pair, over all of d.
extern "C" int repro_pairwise_dists_tiles_f32(const float* x, float* out,
                                              int64_t n, int64_t d,
                                              void* stream) {
  if (n < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const int64_t tiles = (n + R - 1) / R, pairs = tiles * (tiles + 1) / 2;
  if (pairs > 65535) return (int)cudaErrorInvalidValue;
  constexpr int kK = R / kTileG;
  const int smem = (kTileG * kTileG + 2 * kTileG) * kThreads * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      pairwise_tiles<kTileG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  pairwise_tiles<kTileG><<<dim3(kK * kK, (unsigned)pairs), kThreads, smem,
                           (cudaStream_t)stream>>>(x, out, n, d, (int)tiles);
  return (int)cudaGetLastError();
}
