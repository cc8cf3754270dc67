// Online-softmax attention over (BH, S, dh), kv heads already broadcast to
// the q heads: for each row i of q,
//   s_j = (q_i . k_j) * scale, masked to -1e30 where j > i (causal) or
//         i - j >= window (window > 0), on absolute positions;
//   o_i = sum_j softmax(s)_j v_j,
// computed as the reference: f32 accumulators (acc, m, l) with m starting
// at -1e30, per kv tile m' = max(m, max_j s_j), p_j = exp(s_j - m'),
// corr = exp(m - m'), l = l corr + sum_j p_j, acc = acc corr + P.V, and
// o = acc / max(l, 1e-30) rounded to the input type once at the end. The
// reference casts v to f32, so P is never rounded to bf16: both products
// are f32, only the output is rounded.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention (:70, its
// pallas_call at :85).
//
// Two kernels, chosen statically by the input type (not a fallback):
// bf16 runs the Hopper kernel below; f32 runs the FMA kernel of the first
// port (namespace fp32), since f32 on the tensor cores would need q and k
// split into pieces too.
//
// Bound on the H100, at the LM path's shape (BH 128, S 4096, dh 128, bf16,
// causal): operations. The function is 5.5e11 FLOPs (the causal half of
// Q.K^T and of P.V), 0.556 ms at the dense bf16 tensor-core rate, against
// 0.54 GB of q, k, v and o (0.16 ms at 3.35 TB/s). This design runs Q.K^T
// once and P.V three times, 1.1e12 FLOPs: its own floor is 1.11 ms.
//
// Exact P. An f32 p in (0, 1] is carried as three bf16 pieces
// (sm90.cuh::split3, shared with ssd_chunked.cu), hi = bf16(p), mid =
// bf16(p - hi), lo = bf16(p - hi - mid), each difference
// exact in f32: p - hi has at most 16 significant bits and p - hi - mid at
// most 8, so lo is that difference and hi + mid + lo = p bit for bit for
// every p >= 2^-100 (scores within 69 of the row's max; below, the residue
// falls into f32's subnormals and under 5e-41 is lost against l >= 1).
// bf16 v is exact in bf16, and each piece times v is exact in the tensor
// core's f32 accumulator, so acc gets the reference's f32 P.V up to the
// order of the f32 sums, as Q.K^T does. exp is 2^(x log2 e) on the SFU
// (ex2.approx, 2 ulp), p = 0 below 2^-126.
//
// Design of the bf16 kernel (sm_90a). A block owns 128 q rows of one head:
// a producer warpgroup and two consumer warpgroups of 64 rows, with
// setmaxnreg moving registers from the first (24) to the others (240).
// One producer thread loads Q once by TMA and streams the K and V tiles
// (128 kv rows, 64 at dh 256) through a ring of 2-4 stages in shared
// memory, guarded by full and empty mbarriers; 3-D tensor maps over
// (dh, S, BH) with 128-byte swizzle zero-fill rows past S (no read of the
// next head) and dh 80's columns 80-127. Each consumer warpgroup, a tile at
// a time: S = Q K^T on wgmma m64nBKk16 (both operands K-major in shared
// memory), the masks and the online-softmax step in the accumulator's
// registers (quad shuffles for the row max and sum), P split into its
// three pieces in registers, in the A-fragment order of the next product,
// then acc += P V on wgmma m64n(dh)k16 with A from registers and V
// MN-major (transposed in the descriptor), the smallest pieces first. One
// warpgroup's products run while the other is on the CUDA cores. The q
// tiles of one head are adjacent in the grid, so its K and V stay in L2,
// and the last rows, which see the most keys, go first. Where Sq == Sk,
// tiles above the diagonal or before the window of every row of a
// warpgroup are skipped: each row keeps its own key, so a skipped tile is
// one the reference wipes (corr = exp(-1e30 - m') = 0) or adds nothing
// from. Overlapping a warpgroup's own softmax with its products (a second
// S in flight) needs more than 240 registers beside P's 96 of pieces:
// later work, with the measurements in PERF.md.
#include <cuda_bf16.h>
#include <math.h>

#include "sm90.cuh"

namespace {

constexpr float kMasked = -1e30f;  // the reference's mask value

// ---------------------------------------------------------------------------
// bf16: Hopper (sm_90a) wgmma and TMA
// ---------------------------------------------------------------------------
namespace hopper {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int BQ = 128;  // q rows a block: two consumer warpgroups of 64
constexpr int kThreads = 384;  // a producer warpgroup and two consumers

template <int DH>
struct Cfg {
  // the head dim padded to whole 128-byte rows (dh 80 -> 128: the TMA
  // zero-fills columns 80-127, and Q.K^T stops at column 80)
  static constexpr int DHP = DH == 80 ? 128 : DH;
  static constexpr int NCB = DHP / 64;             // 64-column blocks a row
  // kv rows a tile: S, P's three pieces and acc fit the consumers' 240
  // registers (64 + 96 + 64 at dh 128; 32 + 48 + 128 at dh 256)
  static constexpr int BK = DHP > 128 ? 64 : 128;
  static constexpr int KSTEPS = DH / 16;           // k16 steps of Q.K^T
  static constexpr int Q_BLK = BQ * 128;           // bytes a column block
  static constexpr int KV_BLK = BK * 128;
  static constexpr int Q_BYTES = NCB * Q_BLK;
  static constexpr int KV_BYTES = NCB * KV_BLK;    // one tile of K or of V
  // K/V stages of the ring: as many as fit, up to 4
  static constexpr int STAGES_FIT =
      (kSmemMax - 1024 - Q_BYTES - 256) / (2 * KV_BYTES);
  static constexpr int STAGES = STAGES_FIT < 4 ? STAGES_FIT : 4;
  static_assert(STAGES >= 2, "a ring of at least two stages");
  static constexpr int BAR_BYTES = 8 * (1 + 2 * STAGES);
  static constexpr size_t smem =
      1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
  static_assert(smem <= kSmemMax, "shared memory");
};

// e^x as 2^(x log2 e) on the SFU (ex2.approx: 2 ulp; results below 2^-126
// flush to 0): exp(-inf) = 0, and exp(-1e30 - m) = 0 as the reference's
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// P of a tile as three bf16 pieces, in the A-fragment order of each k16
// slice (the accumulator's columns 16kk .. 16kk + 15)
template <int BK>
struct Pieces {
  uint32_t hi[BK / 16][4], mid[BK / 16][4], lo[BK / 16][4];
};

// what the mask needs of a thread's two rows (row0, row0 + 8)
struct Rows {
  int row0, t, sk, causal, window;
  float scale;
};

// S (64 x BK) = Q K^T of one tile, committed as one group: the warpgroup's
// Q rows and a K tile, both K-major (dh contiguous) in 64-column blocks
template <int DH>
__device__ __forceinline__ void start_qk(float (&s)[Cfg<DH>::BK / 2],
                                         uint32_t q, uint32_t k) {
  using C = Cfg<DH>;
#pragma unroll
  for (int kc = 0; kc < C::KSTEPS; ++kc) {
    const uint32_t off = (kc & 3) * 32;  // 16 columns into the row
    SS<C::BK>::run(s, sw128_desc(q + (kc >> 2) * C::Q_BLK + off, 16, 1024),
                   sw128_desc(k + (kc >> 2) * C::KV_BLK + off, 16, 1024),
                   kc > 0);
  }
  wgmma_commit();
}

// acc += P V of one tile, the smallest pieces first, committed as one
// group. V (BK x dh) is MN-major (dh contiguous): 16 kv rows a k16 step,
// its 64-column blocks KV_BLK apart
template <int DH>
__device__ __forceinline__ void start_pv(float (&acc)[Cfg<DH>::DHP / 2],
                                         const Pieces<Cfg<DH>::BK>& p,
                                         uint32_t v) {
  using C = Cfg<DH>;
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
    RS<C::DHP>::run(acc, p.lo[kk], sw128_desc(v + 2048 * kk, C::KV_BLK, 1024));
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
    RS<C::DHP>::run(acc, p.mid[kk],
                    sw128_desc(v + 2048 * kk, C::KV_BLK, 1024));
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
    RS<C::DHP>::run(acc, p.hi[kk], sw128_desc(v + 2048 * kk, C::KV_BLK, 1024));
  wgmma_commit();
}

// the online-softmax step of the tile at kv row k0 on S in place (S
// becomes P): scale, mask, the row max and sum over the quad that holds a
// row, m and l, and corr = exp(m - m') for acc. s[4j + 2i + e] is row
// row0 + 8i, column k0 + 8j + 2t + e. A tile wholly inside every mask of
// the warpgroup's rows (kMask false) takes the row max on the raw scores
// (scale > 0 keeps the order, and rounding is monotone) and p =
// exp(s scale - m') from one fma. Maxima and sums run as trees of four
// partial chains a row.
template <int BK, bool kMask>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const Rows& r,
                                             int k0) {
  float mx[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx[i][c] = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e];
      if constexpr (kMask) {
        const int row = r.row0 + 8 * (e >> 1);
        const int col = k0 + 8 * j + 2 * r.t + (e & 1);
        if (col >= r.sk)
          x = -INFINITY;  // past the ragged end: p = 0
        else if ((r.causal && row < col) ||
                 (r.window > 0 && row - col >= r.window))
          x = kMasked;
        else
          x *= r.scale;
        s[4 * j + e] = x;
      }
      float& acc_mx = mx[e >> 1][(j & 1) * 2 + (e & 1)];
      acc_mx = fmaxf(acc_mx, x);
    }
  float mn[2], sum[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float v = fmaxf(fmaxf(mx[i][0], mx[i][1]), fmaxf(mx[i][2], mx[i][3]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    if constexpr (!kMask) v *= r.scale;
    mn[i] = fmaxf(m[i], v);
#pragma unroll
    for (int c = 0; c < 4; ++c) sum[i][c] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[4 * j + e];
      const float p =
          exp_approx(kMask ? x - mn[e >> 1] : fmaf(x, r.scale, -mn[e >> 1]));
      s[4 * j + e] = p;
      sum[e >> 1][(j & 1) * 2 + (e & 1)] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float v = (sum[i][0] + sum[i][1]) + (sum[i][2] + sum[i][3]);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    corr[i] = exp_approx(m[i] - mn[i]);
    l[i] = l[i] * corr[i] + v;
    m[i] = mn[i];
  }
}

// acc *= corr (row by row), then P -> its three bf16 pieces
template <int BK, int DHP>
__device__ __forceinline__ void rescale_split(float (&acc)[DHP / 2],
                                              const float (&corr)[2],
                                              const float (&s)[BK / 2],
                                              Pieces<BK>& p) {
#pragma unroll
  for (int j = 0; j < DHP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * j + e] *= corr[e >> 1];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], p.hi[kk][r],
             p.mid[kk][r], p.lo[kk][r]);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
              int sq, int sk, int causal, int window, float scale,
              int skip) {
  using C = Cfg<DH>;
  constexpr int BK = C::BK, DHP = C::DHP, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled tiles sit on 1024-byte boundaries: Q, then the ring
  // of K tiles, of V tiles, then the barriers
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = sQ + C::Q_BYTES;
  const uint32_t sV = sK + STAGES * C::KV_BYTES;
  const uint32_t bar_q = sV + STAGES * C::KV_BYTES;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * STAGES;

  const int n_q = (sq + BQ - 1) / BQ;
  // the q tiles of one head are adjacent (its K and V stay in L2 while
  // they run), the last rows, which see the most keys, first
  const int bh = blockIdx.x / n_q;
  const int qt = n_q - 1 - (int)(blockIdx.x % n_q);
  const int q0 = qt * BQ;

  int kt_lo = 0, kt_hi = (sk + BK - 1) / BK - 1;
  if (skip) {  // Sq == Sk: every row keeps its own key
    if (causal) kt_hi = min(kt_hi, (min(q0 + BQ, sq) - 1) / BK);
    if (window > 0) kt_lo = max(0, q0 - window + 1) / BK;
  }

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(bar_full + 8 * st, 1);   // the producer's expect_tx
      mbar_init(bar_empty + 8 * st, 2);  // one arrival a consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's index, broadcast from lane 0 so that the compiler
  // sees every branch on it (and on what follows from it) as warp-uniform:
  // a wgmma under a branch it cannot prove uniform is serialized
  const int wgi = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wgi == 0) {
    // the producer warpgroup: one thread keeps the ring of K/V tiles full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < C::NCB; ++cb)
        tma_load(sQ + cb * C::Q_BLK, &tq, bar_q, 64 * cb, q0, bh);
      int st = 0;
      uint32_t phase = 0;
      for (int kt = kt_lo; kt <= kt_hi; ++kt) {
        mbar_wait(bar_empty + 8 * st, phase ^ 1);  // round 0 passes
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * C::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < C::NCB; ++cb) {
          const uint32_t off = st * C::KV_BYTES + cb * C::KV_BLK;
          tma_load(sK + off, &tk, full, 64 * cb, kt * BK, bh);
          tma_load(sV + off, &tv, full, 64 * cb, kt * BK, bh);
        }
        if (++st == STAGES) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // two consumer warpgroups of 64 q rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    // this warpgroup's rows and the tiles that hold any of their keys
    const int wg = wgi - 1, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;  // accumulator coordinates
    const int rw = q0 + 64 * wg;            // the warpgroup's first row
    const int row0 = rw + 16 * warp + g;    // this thread's rows: +0, +8
    int w_lo = kt_lo, w_hi = kt_hi;
    if (skip) {
      if (causal) w_hi = min(w_hi, (min(rw + 63, sq - 1)) / BK);
      if (window > 0) w_lo = max(w_lo, max(0, rw - window + 1) / BK);
    }

    float acc[DHP / 2];
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.0f;
    float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f};
    // Q of this warpgroup: K-major, 64 rows into each 64-column block
    const uint32_t q_base = sQ + 64 * 128 * wg;
    mbar_wait(bar_q, 0);

    // Each tile of the warpgroup's rows: S = Q K^T, the softmax step, P
    // as three pieces, acc += P V; the other consumer warpgroup's products
    // run while this one is on the CUDA cores. A stage is released once
    // both warpgroups' products on it are done (tiles a warpgroup skips at
    // once).
    float s[BK / 2];  // S of a tile, then its P (f32)
    Pieces<BK> pieces;
    float corr[2];
    const Rows rows{row0, t, sk, causal, window, scale};
    int st = 0;
    uint32_t phase = 0;
    for (int kt = kt_lo; kt <= kt_hi; ++kt) {
      mbar_wait(bar_full + 8 * st, phase);
      if (kt >= w_lo && kt <= w_hi) {
        const int k0 = kt * BK;
        wgmma_fence();
        start_qk<DH>(s, q_base, sK + st * C::KV_BYTES);
        wgmma_wait();
        fence_regs(s);
        // a tile inside the causal mask, the window and the sequence for
        // every row of the warpgroup needs no mask
        if ((!causal || k0 + BK - 1 <= rw) &&
            (window <= 0 || rw + 63 - k0 < window) && k0 + BK <= sk)
          softmax_step<BK, false>(s, m, l, corr, rows, k0);
        else
          softmax_step<BK, true>(s, m, l, corr, rows, k0);
        rescale_split<BK, DHP>(acc, corr, s, pieces);
        fence_regs(acc);
        wgmma_fence();
        start_pv<DH>(acc, pieces, sV + st * C::KV_BYTES);
        wgmma_wait();
        fence_regs(acc);
      }
      // the warpgroup's reads of this stage are complete
      if ((tid & 127) == 0) mbar_arrive(bar_empty + 8 * st);
      if (++st == STAGES) {
        st = 0;
        phase ^= 1;
      }
    }

    // o = acc / max(l, 1e-30), rounded to bf16 once
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= sq) continue;
      const float den = fmaxf(l[i], 1e-30f);
      bf16* orow = o + ((int64_t)bh * sq + row) * DH + 2 * t;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] / den,
                                  acc[4 * j + 2 * i + 1] / den);
    }
  }
}

// a 3-D map over a contiguous (bh, s, dh) bf16 tensor, read in boxes of 64
// columns x `rows` rows of one head, 128-byte swizzled; rows past s and
// columns past dh read as zeros
int tensor_map(CUtensorMap* map, const bf16* x, int64_t bh, int64_t s,
               int64_t dh, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)dh, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)(dh * 2),
                                 (cuuint64_t)(s * dh * 2)};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(x), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DH>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int64_t bh,
           int64_t sq, int64_t sk, int64_t causal, int64_t window,
           float scale, cudaStream_t stream) {
  using C = Cfg<DH>;
  CUtensorMap mq, mk, mv;
  int e = tensor_map(&mq, q, bh, sq, DH, BQ);
  if (!e) e = tensor_map(&mk, k, bh, sk, DH, C::BK);
  if (!e) e = tensor_map(&mv, v, bh, sk, DH, C::BK);
  if (e) return e;
  const cudaError_t a = cudaFuncSetAttribute(
      flash_fwd<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::smem);
  if (a != cudaSuccess) return (int)a;
  const int64_t blocks = (sq + BQ - 1) / BQ * bh;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_fwd<DH><<<(unsigned)blocks, kThreads, C::smem, stream>>>(
      mq, mk, mv, o, (int)sq, (int)sk, (int)causal, (int)window, scale,
      (int)(sq == sk));
  return (int)cudaGetLastError();
}

}  // namespace hopper

// ---------------------------------------------------------------------------
// f32: the first port's kernel, on FMAs. One block of 128 threads (256 at
// dh 256) a (bh, 64-row q tile), the q tiles of the last rows first; the
// kv tiles (64 rows) staged through shared memory. Four warps compute the
// 64 x 64 scores in mma.sync's accumulator layout, mask them and do the
// online-softmax step with quad shuffles; P and each row's corr pass
// through shared memory; every thread rescales and accumulates its block
// of acc. The same exact tile skipping as the bf16 kernel.
// ---------------------------------------------------------------------------
namespace fp32 {

constexpr int BQ = 64;  // q rows a block
constexpr int BK = 64;  // kv rows a tile
constexpr int P_LD = BK + 4;  // row pitch of P in shared memory (floats)
static_assert(BQ == BK, "load_rows stages BQ rows of Q and of K");

template <int DH>
struct Cfg {
  static constexpr int NT = DH > 128 ? 256 : 128;  // threads a block
  static constexpr int NCG = 16;                   // P.V column groups
  static constexpr int NRG = NT / NCG;             // P.V row groups
  static constexpr int RT = BQ / NRG;              // acc rows a thread
  static constexpr int CT = DH / NCG;              // acc columns a thread
  // row pitch of Q and K (floats): 16 bytes over dh keeps 16-byte rows
  static constexpr int LD = DH + 4;
  static constexpr size_t smem =
      (size_t)2 * BQ * LD * sizeof(float)  // Q, K
      + (size_t)BK * DH * sizeof(float)    // V
      + (size_t)BQ * P_LD * sizeof(float)  // P
      + (size_t)2 * BQ * sizeof(float);    // corr, l
};

// rows [0, BQ) of src from row r0 of an (n, DH) matrix into dst (pitch
// `ld`), zero past row n
template <int DH>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int n, int ld) {
  using C = Cfg<DH>;
  constexpr int per_row = DH / 4;
  for (int i = threadIdx.x; i < BQ * per_row; i += C::NT) {
    const int r = i / per_row, c = (i % per_row) * 4;
    float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r0 + r < n)
      u = *reinterpret_cast<const float4*>(src + (int64_t)(r0 + r) * DH + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = u;
  }
}

template <int DH>
__global__ void __launch_bounds__(Cfg<DH>::NT)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int bh_n,
              int sq, int sk, int causal, int window, float scale,
              int skip) {
  using C = Cfg<DH>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sK = sQ + BQ * C::LD;
  float* sV = sK + BK * C::LD;
  float* sP = sV + BK * DH;
  float* sCorr = sP + BQ * P_LD;
  float* sL = sCorr + BQ;

  const int n_q = (sq + BQ - 1) / BQ;
  const int qt = n_q - 1 - (int)(blockIdx.x / bh_n);  // last rows first
  const int64_t bh = blockIdx.x % bh_n;
  const int q0 = qt * BQ;
  const float* qb = q + bh * sq * DH;
  const float* kb = k + bh * sk * DH;
  const float* vb = v + bh * sk * DH;

  int kt_lo = 0, kt_hi = (sk + BK - 1) / BK - 1;
  if (skip) {  // Sq == Sk: every row keeps its own key
    if (causal) kt_hi = min(kt_hi, (min(q0 + BQ, sq) - 1) / BK);
    if (window > 0) kt_lo = max(0, q0 - window + 1) / BK;
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
  const int r0 = 16 * warp + g, r1 = r0 + 8;  // this thread's score rows
  float m0 = kMasked, m1 = kMasked, l0 = 0.0f, l1 = 0.0f;

  const int rg = tid / C::NCG, cg = tid % C::NCG;  // P.V coordinates
  float acc[C::RT][C::CT];
#pragma unroll
  for (int i = 0; i < C::RT; ++i)
#pragma unroll
    for (int j = 0; j < C::CT; ++j) acc[i][j] = 0.0f;

  load_rows<DH>(sQ, qb, q0, sq, C::LD);

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's P.V is done with sK, sV, sP
    load_rows<DH>(sK, kb, k0, sk, C::LD);
    load_rows<DH>(sV, vb, k0, sk, DH);
    __syncthreads();

    if (warp < 4) {
      // scores of rows r0, r1 at columns 8j + 2t + {0, 1}
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        const float qa = sQ[r0 * C::LD + d], qc = sQ[r1 * C::LD + d];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float ka = sK[(8 * j + 2 * t) * C::LD + d];
          const float kc = sK[(8 * j + 2 * t + 1) * C::LD + d];
          s[j][0] += qa * ka;
          s[j][1] += qa * kc;
          s[j][2] += qc * ka;
          s[j][3] += qc * kc;
        }
      }
      // scale and mask, then the online-softmax step for rows r0, r1
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + (e < 2 ? r0 : r1);
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          float x;
          if (col >= sk) {
            x = -INFINITY;  // past the ragged end: p = 0
          } else {
            const bool ok = (!causal || row >= col) &&
                            (window <= 0 || row - col < window);
            x = ok ? s[j][e] * scale : kMasked;
          }
          s[j][e] = x;
          if (e < 2)
            mx0 = fmaxf(mx0, x);
          else
            mx1 = fmaxf(mx1, x);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p0 = expf(s[j][0] - mn0), p1 = expf(s[j][1] - mn0);
        const float p2 = expf(s[j][2] - mn1), p3 = expf(s[j][3] - mn1);
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        *reinterpret_cast<float2*>(sP + r0 * P_LD + 8 * j + 2 * t) =
            make_float2(p0, p1);
        *reinterpret_cast<float2*>(sP + r1 * P_LD + 8 * j + 2 * t) =
            make_float2(p2, p3);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
      l0 = l0 * c0 + sum0;
      l1 = l1 * c1 + sum1;
      m0 = mn0;
      m1 = mn1;
      if (t == 0) {
        sCorr[r0] = c0;
        sCorr[r1] = c1;
      }
    }
    __syncthreads();

    // acc = acc * corr + P.V on this thread's rows and columns
#pragma unroll
    for (int i = 0; i < C::RT; ++i) {
      const float cr = sCorr[rg + C::NRG * i];
#pragma unroll
      for (int j = 0; j < C::CT; ++j) acc[i][j] *= cr;
    }
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pr[C::RT];
#pragma unroll
      for (int i = 0; i < C::RT; ++i)
        pr[i] = *reinterpret_cast<const float4*>(
            sP + (rg + C::NRG * i) * P_LD + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[C::CT];
#pragma unroll
        for (int j = 0; j < C::CT; ++j)
          vv[j] = sV[(c + cc) * DH + cg + C::NCG * j];
#pragma unroll
        for (int i = 0; i < C::RT; ++i) {
          const float p = cc == 0 ? pr[i].x
                          : cc == 1 ? pr[i].y
                          : cc == 2 ? pr[i].z
                                    : pr[i].w;
#pragma unroll
          for (int j = 0; j < C::CT; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
    }
  }

  if (warp < 4 && t == 0) {
    sL[r0] = l0;
    sL[r1] = l1;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < C::RT; ++i) {
    const int r = rg + C::NRG * i;
    if (q0 + r >= sq) continue;
    const float den = fmaxf(sL[r], 1e-30f);
    float* orow = o + (bh * sq + q0 + r) * DH;
#pragma unroll
    for (int j = 0; j < C::CT; ++j) orow[cg + C::NCG * j] = acc[i][j] / den;
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, float* o,
           int64_t bh, int64_t sq, int64_t sk, int64_t causal, int64_t window,
           float scale, cudaStream_t stream) {
  using C = Cfg<DH>;
  // above 48 KB a block's shared memory must be asked for (per device)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (sq + BQ - 1) / BQ * bh;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_fwd<DH><<<(unsigned)blocks, C::NT, C::smem, stream>>>(
      q, k, v, o, (int)bh, (int)sq, (int)sk, (int)causal, (int)window, scale,
      (int)(sq == sk));
  return (int)cudaGetLastError();
}

}  // namespace fp32

// the kernel of the input type, by head dim: a static dispatch (bf16 runs
// the Hopper kernel, f32 the FMA kernel), not a fallback
template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, int64_t bh,
             int64_t sq, int64_t sk, int64_t dh, int64_t causal,
             int64_t window, float scale, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || window < 0 || sq > 0x7fffffff ||
      sk > 0x7fffffff || window > 0x7fffffff || bh > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define REPRO_ATTN_CASE(D)                                                  \
  case D:                                                                   \
    if constexpr (sizeof(T) == 2)                                           \
      return hopper::launch<D>(q, k, v, o, bh, sq, sk, causal, window,      \
                               scale, s);                                   \
    else                                                                    \
      return fp32::launch<D>(q, k, v, o, bh, sq, sk, causal, window, scale, \
                             s);
  switch (dh) {
    REPRO_ATTN_CASE(64)
    REPRO_ATTN_CASE(80)
    REPRO_ATTN_CASE(128)
    REPRO_ATTN_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_ATTN_CASE
}

}  // namespace

extern "C" int repro_flash_attention_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    __nv_bfloat16* o, int64_t bh, int64_t sq, int64_t sk, int64_t dh,
    int64_t causal, int64_t window, float scale, void* stream) {
  return dispatch(q, k, v, o, bh, sq, sk, dh, causal, window, scale, stream);
}

extern "C" int repro_flash_attention_f32(
    const float* q, const float* k, const float* v, float* o, int64_t bh,
    int64_t sq, int64_t sk, int64_t dh, int64_t causal, int64_t window,
    float scale, void* stream) {
  return dispatch(q, k, v, o, bh, sq, sk, dh, causal, window, scale, stream);
}
