// int8 x int8 -> int32 rowwise-scaled matrix product:
//   out[m, n] = f32(sum_k xq[m, k] * wq[n, k]) * sx[m] * sw[n]
// xq (M, K) int8 activations with one f32 scale a row, wq (N, K) int8
// weights with one f32 scale an output channel (the layout of a rowwise
// quantized w.T). Integer sums are exact, so any order gives the plain
// version's int32; the two scale multiplies are written with __fmul_rn,
// in the reference's order, so nvcc contracts nothing.
//
// Replaces the TPU kernel src/repro/kernels/qmm/kernel.py::qmm (:45, its
// pallas_call at :65).
//
// Bound on the H100: bytes on the CNN fc, the product that matters (one
// pass: M 365, N 124, K 78624): 28.7 MB of activations and 9.75 MB of
// weights read once, 11.5 us at 3.35 TB/s, against 7.1 G int8 operations,
// 3.6 us at the tensor cores' 1,979 TOP/s. The 124-deep products of the
// LSTM projection and the head are a few microseconds of launch.
//
// Two routes, chosen by the wrapper from the shape and alignment alone
// (never after a failure):
//
// wgmma (K a multiple of 16, both bases 16-byte aligned, as TMA needs: the
// fc). A block owns a 128 x 128 output tile and a range of whole 128-byte
// k tiles: a producer warpgroup, one thread of which streams the A and B
// tiles by TMA (2-D tensor maps, 128-byte swizzle, zero fill past M, N and
// K, so N = 124 pads to 128) through a ring of four stages guarded by full
// and empty mbarriers, and two consumer warpgroups of 64 rows, each running
// wgmma m64n128k32 .s32.s8.s8 (both operands K-major, as int8 wgmma
// requires, four k32 steps a 128-byte tile) into 64 int32 registers. One N
// tile covers N = 124, so A is read once. K is split so that one wave of
// blocks fills the card, the splits of a tile in clusters of up to 8 (the
// wrapper asks the card how many clusters it runs at once). Integer sums
// are exact in any order, so the splits combine in two steps: the blocks
// of a cluster add their tiles through distributed shared memory, each
// taking a slice of rows, and the clusters of a tile add theirs with
// int32 atomics into a workspace; the last cluster to arrive (an integer
// ticket, a release/acquire atomic after a block barrier) scales those
// rows once and zeroes the workspace and its ticket for the next launch.
// A call is one launch, with no memset and 8x fewer atomics than a block
// each.
//
// dp4a (every other shape: K = 124 and odd K). A block computes a 64 x 64
// output tile over all of K with 256 threads, each 4 x 4 outputs spaced 16
// apart, in steps of 64 bytes: both operand tiles staged in shared memory
// as 32-bit words of four int8 values (K-major, so a thread's four A and
// four B words sit in distinct banks), zero-padded past the ragged edges,
// every word pair one __dp4a. Rows of K % 4 != 0 bytes are not word
// aligned and are packed byte by byte. At the 2048-row, 124-deep products
// this beats cuBLAS's int8 GEMM.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ float scaled(int32_t acc, float sx, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
}

// ---------------------------------------------------------------------------
// wgmma: the int8 tensor cores, a TMA ring
// ---------------------------------------------------------------------------
namespace tc {

using namespace sm90;

constexpr int BM = 128;        // output rows a block: two warpgroups of 64
constexpr int BN = 128;        // output columns a block
constexpr int BK = 128;        // bytes of K a tile: one swizzled 128-byte row
constexpr int kThreads = 384;  // a producer warpgroup and two consumers
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK;
constexpr int STAGE_BYTES = A_BYTES + BN * BK;
constexpr size_t kSmem = 1024 + (size_t)STAGES * STAGE_BYTES + 16 * STAGES;
constexpr int kPitch = BN + 4;  // ints a row of the block's int32 tile
static_assert(kSmem <= kSmemMax, "shared memory");
static_assert(BM * kPitch * 4 <= STAGES * STAGE_BYTES, "the tile fits the ring");

#define QMM_I8(i)                                              \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),  \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define QMM_I32(i) QMM_I8(i), QMM_I8(i + 8), QMM_I8(i + 16), QMM_I8(i + 24)

// D (64 x 128, s32) += A B^T: A (64 x 32) and B (128 x 32) K-major s8 tiles
// in shared memory
__device__ __forceinline__ void mma_s8(int32_t (&d)[64], uint64_t a,
                                       uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" WG_R64
      "}, %64, %65, p;\n}\n"
      : QMM_I32(0), QMM_I32(32)
      : "l"(a), "l"(b), "r"(1));
}

// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma
__device__ __forceinline__ void fence_regs(int32_t (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// grid (m_tiles x n_tiles, splits) in clusters of C consecutive splits of
// one tile: the tiles of one k range are adjacent, so the blocks that read
// the same B (or A) tile run together. sums and tickets (C a tile) are
// needed when there is more than one cluster a tile.
__global__ void __launch_bounds__(kThreads, 1)
    qmm_tc(const __grid_constant__ CUtensorMap ta,
           const __grid_constant__ CUtensorMap tb,
           const float* __restrict__ sx, const float* __restrict__ sw,
           float* __restrict__ out, int32_t* __restrict__ tickets,
           int32_t* __restrict__ sums, int M, int N, int m_tiles,
           int k_tiles, int per_split) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int last;
  // 128-byte swizzled tiles sit on 1024-byte boundaries: the ring of
  // (A, B) stages, then the barriers
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bar_full = base + STAGES * STAGE_BYTES;
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int tile = blockIdx.x, splits = gridDim.y;
  const int mt = tile % m_tiles, nt = tile / m_tiles;
  const int kt0 = blockIdx.y * per_split;  // past k_tiles: an empty split
  const int kt1 = min(kt0 + per_split, k_tiles);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar_full + 8 * st, 1);   // the producer's expect_tx
      mbar_init(bar_empty + 8 * st, 2);  // one arrival a consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // broadcast from lane 0, so that every branch on the warpgroup is
  // warp-uniform to the compiler (else it serializes the wgmma)
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  int32_t d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  if (wgi == 0) {
    if (tid == 0) {  // the producer: one thread keeps the ring full
      int st = 0;
      uint32_t phase = 0;
      for (int kt = kt0; kt < kt1; ++kt) {
        mbar_wait(bar_empty + 8 * st, phase ^ 1);  // round 0 passes
        const uint32_t full = bar_full + 8 * st;
        const uint32_t a = base + st * STAGE_BYTES;
        mbar_expect_tx(full, STAGE_BYTES);  // zero-filled bytes count too
        tma_load(a, &ta, full, kt * BK, mt * BM);
        tma_load(a + A_BYTES, &tb, full, kt * BK, nt * BN);
        if (++st == STAGES) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // two consumer warpgroups of 64 output rows each
    const int wg = wgi - 1;
    int st = 0;
    uint32_t phase = 0;
    for (int kt = kt0; kt < kt1; ++kt) {
      mbar_wait(bar_full + 8 * st, phase);
      const uint32_t a = base + st * STAGE_BYTES + 64 * BK * wg;
      const uint32_t b = base + st * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 32; ++kc)  // +32 bytes a k32 step
        mma_s8(d, sw128_desc(a + 32 * kc, 16, 1024),
               sw128_desc(b + 32 * kc, 16, 1024));
      wgmma_commit();
      wgmma_wait();
      fence_regs(d);
      // the warpgroup's reads of this stage are complete
      if ((tid & 127) == 0) mbar_arrive(bar_empty + 8 * st);
      if (++st == STAGES) {
        st = 0;
        phase ^= 1;
      }
    }
  }

  // Every stage is consumed: the ring now holds this block's int32 tile.
  // d[4j + 2i + e] is tile row 64 wg + 16 warp + g + 8i, column 8j + 2t + e.
  __syncthreads();
  int32_t* tile_s =
      reinterpret_cast<int32_t*>(smem_raw + (base - smem_u32(smem_raw)));
  if (wgi > 0) {
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int row0 = 64 * (wgi - 1) + 16 * ((tid >> 5) & 3) + g;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<int2*>(tile_s + (row0 + 8 * i) * kPitch + 8 * j +
                                 2 * t) =
            make_int2(d[4 * j + 2 * i], d[4 * j + 2 * i + 1]);
  }
  // The cluster's C splits add their tiles in shared memory, rank r taking
  // rows [r BM / C, (r + 1) BM / C): exact in any order. With one cluster a
  // tile the sums are final; else they go to the workspace by int32
  // atomics, and the last cluster to arrive finishes each rank's rows.
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int ncl = splits / C;
  const int rows = BM / C, r0 = rank * rows;
  const int m_rows = min(BM, M - mt * BM), n_cols = min(BN, N - nt * BN);
  cluster.sync();
  for (int o = tid; o < rows * (BN / 4); o += kThreads) {
    const int rl = r0 + o / (BN / 4), c4 = 4 * (o % (BN / 4));
    if (rl >= m_rows || c4 >= n_cols) continue;
    int4 u[kMaxCluster];  // every rank's load issued before the adds
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < C)
        u[q] = *reinterpret_cast<const int4*>(
            cluster.map_shared_rank(tile_s, q) + rl * kPitch + c4);
    int v[4] = {0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < C) {
        v[0] += u[q].x;
        v[1] += u[q].y;
        v[2] += u[q].z;
        v[3] += u[q].w;
      }
    const int64_t row = (int64_t)mt * BM + rl;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c4 + e >= n_cols) break;
      const int col = nt * BN + c4 + e;
      if (ncl == 1)
        out[row * N + col] = scaled(v[e], sx[row], sw[col]);
      else
        atomicAdd(sums + row * N + col, v[e]);
    }
  }
  cluster.sync();  // the cluster's tiles are read: blocks may leave
  if (ncl == 1) return;
  if (tid == 0) {
    int* tk = tickets + (int64_t)tile * C + rank;
    last = ticket_add(tk) == ncl - 1;
    if (last) *tk = 0;  // zero again for the next launch
  }
  __syncthreads();
  if (!last) return;
  // rows r0 .. of the tile: every load issued before the stores, which
  // zero the workspace again and write the scaled sums
  const int cnt = max(0, min(rows, m_rows - r0)) * n_cols;
  constexpr int kBatch = 8;
  for (int b = 0; b < cnt; b += kThreads * kBatch) {
    int32_t v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int o = b + u * kThreads + tid;
      if (o < cnt)
        v[u] = __ldcg(sums + ((int64_t)mt * BM + r0 + o / n_cols) * N +
                      nt * BN + o % n_cols);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int o = b + u * kThreads + tid;
      if (o >= cnt) break;
      const int64_t row = (int64_t)mt * BM + r0 + o / n_cols;
      const int col = nt * BN + o % n_cols;
      __stcg(sums + row * N + col, 0);
      out[row * N + col] = scaled(v[u], sx[row], sw[col]);
    }
  }
}

// a 2-D map over a contiguous (rows, k) int8 matrix, read in boxes of 128
// bytes x 128 rows, 128-byte swizzled; rows past `rows` and bytes past k
// read as zeros
int tensor_map(CUtensorMap* map, const int8_t* x, int64_t rows, int64_t k) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k};
  const cuuint32_t box[2] = {BK, 128};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(x), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// dp4a: 64 x 64 tiles on the CUDA cores
// ---------------------------------------------------------------------------
namespace dp4a {

constexpr int kTile = 64;           // output rows and columns a block
constexpr int kStepWords = 16;      // 64 bytes of K a step
constexpr int kThreads = 256;
constexpr int kLd = kTile + 2;      // word stride of a staged K-word row

// Stages rows [r0, r0 + 64) x bytes [k0, k0 + 64) of src (rows x K int8)
// into dst[w][r], zero past `rows` and K.
__device__ __forceinline__ void stage(int32_t (*dst)[kLd],
                                      const int8_t* __restrict__ src,
                                      int64_t rows, int64_t K, int64_t r0,
                                      int64_t k0, bool words) {
  for (int i = threadIdx.x; i < kTile * kStepWords; i += kThreads) {
    const int r = i / kStepWords, w = i % kStepWords;
    const int64_t row = r0 + r, k = k0 + 4 * w;
    uint32_t v = 0;
    if (row < rows) {
      const int8_t* p = src + row * K + k;
      if (words) {  // K % 4 == 0: k < K means all four bytes are in
        if (k < K) v = (uint32_t)__ldg(reinterpret_cast<const int*>(p));
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (k + b < K) v |= (uint32_t)(uint8_t)p[b] << (8 * b);
      }
    }
    dst[w][r] = (int32_t)v;
  }
}

__global__ void __launch_bounds__(kThreads)
    qmm_dp4a(const int8_t* __restrict__ xq, const float* __restrict__ sx,
             const int8_t* __restrict__ wq, const float* __restrict__ sw,
             float* __restrict__ out, int64_t M, int64_t N, int64_t K,
             bool words) {
  __shared__ int32_t a_s[kStepWords][kLd];
  __shared__ int32_t b_s[kStepWords][kLd];
  const int64_t n0 = (int64_t)blockIdx.x * kTile;
  const int64_t m0 = (int64_t)blockIdx.y * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  int32_t acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int64_t k0 = 0; k0 < K; k0 += 4 * kStepWords) {
    stage(a_s, xq, M, K, m0, k0, words);
    stage(b_s, wq, N, K, n0, k0, words);
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kStepWords; ++w) {
      int32_t a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[w][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[w][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t n = n0 + tx + 16 * j;
      if (n < N) out[m * N + n] = scaled(acc[i][j], sx[m], sw[n]);
    }
  }
}

}  // namespace dp4a

}  // namespace

// The tensor-core route. per_split: whole 128-byte k tiles a block;
// splits: a multiple of cluster (1 to 8), each cluster the splits of one
// tile that add their tiles in shared memory; scratch: int32 zeros, the
// tickets (cluster a tile) then the (m, n) sums, needed when splits >
// cluster and left zero again.
extern "C" int repro_qmm_s8_wgmma(const int8_t* xq, const float* sx,
                                  const int8_t* wq, const float* sw,
                                  float* out, int32_t* scratch, int64_t m,
                                  int64_t n, int64_t k, int64_t per_split,
                                  int64_t splits, int64_t cluster,
                                  void* stream) {
  using namespace tc;
  if (m < 1 || n < 1 || k < 16 || k % 16 != 0 || per_split < 1 ||
      m > 0x7fffffff || n > 0x7fffffff || k > 0x7fffffff ||
      (uintptr_t)xq % 16 != 0 || (uintptr_t)wq % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t m_tiles = (m + BM - 1) / BM, n_tiles = (n + BN - 1) / BN;
  const int64_t k_tiles = (k + BK - 1) / BK;
  if (m_tiles * n_tiles > 0x7fffffff || splits < 1 || splits > 65535 ||
      cluster < 1 || cluster > kMaxCluster || BM % cluster != 0 ||
      splits % cluster != 0 || splits * per_split < k_tiles ||
      (splits > cluster && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  int e = tensor_map(&ma, xq, m, k);
  if (!e) e = tensor_map(&mb, wq, n, k);
  if (e) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      qmm_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (a != cudaSuccess) return (int)a;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(m_tiles * n_tiles), (unsigned)splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = (unsigned)cluster;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int32_t* tickets = scratch;
  int32_t* sums =
      splits > cluster ? scratch + m_tiles * n_tiles * cluster : nullptr;
  return (int)cudaLaunchKernelEx(&cfg, qmm_tc, ma, mb, sx, sw, out, tickets,
                                 sums, (int)m, (int)n, (int)m_tiles,
                                 (int)k_tiles, (int)per_split);
}

// How many clusters of `cluster` blocks of the tensor-core route the card
// runs at once (a negative CUDA error code if it cannot say).
extern "C" int repro_qmm_max_clusters(int64_t cluster) {
  using namespace tc;
  cudaError_t e = cudaFuncSetAttribute(
      qmm_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1, (unsigned)cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = (unsigned)cluster;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int num = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&num, qmm_tc, &cfg);
  return e == cudaSuccess ? num : -(int)e;
}

// The dp4a route: any K, any alignment.
extern "C" int repro_qmm_s8_dp4a(const int8_t* xq, const float* sx,
                                 const int8_t* wq, const float* sw,
                                 float* out, int64_t m, int64_t n, int64_t k,
                                 void* stream) {
  using namespace dp4a;
  if (m < 1 || n < 1 || k < 1) return (int)cudaErrorInvalidValue;
  const int64_t m_tiles = (m + kTile - 1) / kTile;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  if (m_tiles > 65535 || n_tiles > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const bool words = k % 4 == 0 && (uintptr_t)xq % 4 == 0 &&
                     (uintptr_t)wq % 4 == 0;
  const dim3 grid((unsigned)n_tiles, (unsigned)m_tiles);
  qmm_dp4a<<<grid, kThreads, 0, (cudaStream_t)stream>>>(xq, sx, wq, sw, out,
                                                        m, n, k, words);
  return (int)cudaGetLastError();
}
