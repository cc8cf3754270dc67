// Online-softmax attention over (BH, S, dh), kv heads already broadcast to
// the q heads: for each row i of q,
//   s_j = (q_i . k_j) * scale, masked to -1e30 where j > i (causal) or
//         i - j >= window (window > 0), on absolute positions;
//   o_i = sum_j softmax(s)_j v_j,
// computed as the reference: f32 accumulators (acc, m, l) with m starting
// at -1e30, per kv tile m' = max(m, max_j s_j), p_j = exp(s_j - m'),
// corr = exp(m - m'), l = l corr + sum_j p_j, acc = acc corr + P.V, and
// o = acc / max(l, 1e-30) rounded to the input type once at the end. P
// stays f32 (the reference casts v to f32 before P.V), so P.V runs on f32
// FMAs; Q.K^T of bf16 inputs runs on bf16 tensor cores (mma.sync
// m16n8k16) with f32 accumulation, which is exact in the products and
// differs from the reference only in the order of the f32 sums. f32 inputs
// take f32 FMAs for Q.K^T too.
//
// Replaces the TPU kernel
// src/repro/kernels/flash_attention/kernel.py::flash_attention.
//
// Bound on the H100: operations. At the LM path's shape (BH 128, S 4096,
// dh 128, bf16, causal) the two products are 5.5e11 FLOPs (the causal
// half, 4 Sq Sk dh / 2 a head): 0.56 ms at the dense bf16 tensor-core
// rate, against 0.54 GB of q, k, v and o (0.16 ms at 3.35 TB/s). This
// first kernel is far from that bound: half the work, P.V, runs on f32
// FMAs (67 TFLOP/s), as the reference's f32 P requires.
//
// Design. One block of 128 threads (256 for dh 256) a (bh, 64-row q tile);
// the TPU kernel's sequential kv grid axis becomes a loop inside the block
// over 64-row kv tiles, staged through shared memory (K in the input type,
// V widened to f32). The q tiles of the last rows, which see the most keys
// under the causal mask, are launched first. Each tile:
//   1. four warps compute the 64 x 64 scores in mma.sync's accumulator
//      layout (a warp 16 rows; a thread 2 rows x 16 columns), mask them,
//      and do the online-softmax step with quad shuffles for the row max
//      and sum; P (f32) and each row's corr go to shared memory;
//   2. every thread rescales and accumulates an 8 x (dh / 16) (4 x 16 at dh
//      256) block of acc: float4 loads of P rows, scalar loads of V
//      columns (16 consecutive a warp), f32 FMAs.
// Where Sq == Sk, kv tiles wholly above the diagonal (causal) or wholly
// before the window of the tile's first row are skipped: each row's own key
// lies in the tiles that remain, so a skipped tile is one the reference
// wipes (corr = exp(-1e30 - m') = 0) or adds nothing from (p = 0). Rows
// and keys past a ragged end (S < 128 and not a multiple of 64) are
// zero-filled, their scores -inf (p = 0), and not stored. wgmma, TMA, a
// pipelined ring of tiles and a bf16 P with a correction term are later
// work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;  // q rows a block
constexpr int BK = 64;  // kv rows a tile
constexpr int P_LD = BK + 4;  // row pitch of P in shared memory (floats)
constexpr float kMasked = -1e30f;  // the reference's mask value
static_assert(BQ == BK, "load_rows stages BQ rows of Q and of K");

template <typename T, int DH>
struct Cfg {
  static constexpr int NT = DH > 128 ? 256 : 128;  // threads a block
  static constexpr int NCG = 16;                   // P.V column groups
  static constexpr int NRG = NT / NCG;             // P.V row groups
  static constexpr int RT = BQ / NRG;              // acc rows a thread
  static constexpr int CT = DH / NCG;              // acc columns a thread
  // row pitch of Q and K (elements): 16 bytes over dh keeps 16-byte rows
  // and spreads the 8 rows of an mma fragment load over distinct banks
  static constexpr int LD = DH + 16 / (int)sizeof(T);
  static constexpr int EPV = 16 / (int)sizeof(T);  // elements a 16-byte load
  static constexpr size_t smem =
      (size_t)2 * BQ * LD * sizeof(T)     // Q, K
      + (size_t)BK * DH * sizeof(float)   // V (f32)
      + (size_t)BQ * P_LD * sizeof(float) // P
      + (size_t)2 * BQ * sizeof(float);   // corr, l
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// D += A (16 x 16, row-major) B (16 x 8, column-major), bf16 in, f32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [0, BQ) of src from row r0 of an (n, DH) matrix into dst (pitch LD,
// type T), zero past row n
template <typename T, int DH>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int r0,
                                          int n) {
  using C = Cfg<T, DH>;
  constexpr int per_row = DH / C::EPV;
  for (int i = threadIdx.x; i < BQ * per_row; i += C::NT) {
    const int r = i / per_row, c = (i % per_row) * C::EPV;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r0 + r < n)
      u = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * DH + c);
    *reinterpret_cast<uint4*>(dst + r * C::LD + c) = u;
  }
}

// rows [r0, r0 + BK) of v into dst as f32 (pitch DH), zero past row n
template <typename T, int DH>
__device__ __forceinline__ void load_v(float* dst, const T* src, int r0,
                                       int n) {
  using C = Cfg<T, DH>;
  constexpr int per_row = DH / C::EPV;
  for (int i = threadIdx.x; i < BK * per_row; i += C::NT) {
    const int r = i / per_row, c = (i % per_row) * C::EPV;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (r0 + r < n)
      u = *reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * DH + c);
    const T* vals = reinterpret_cast<const T*>(&u);
    float4* out = reinterpret_cast<float4*>(dst + r * DH + c);
#pragma unroll
    for (int e = 0; e < C::EPV; e += 4)
      out[e / 4] = make_float4(to_f32(vals[e]), to_f32(vals[e + 1]),
                               to_f32(vals[e + 2]), to_f32(vals[e + 3]));
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(Cfg<T, DH>::NT)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int bh_n, int sq,
              int sk, int causal, int window, float scale, int skip) {
  using C = Cfg<T, DH>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + BQ * C::LD;
  float* sV = reinterpret_cast<float*>(sK + BK * C::LD);
  float* sP = sV + BK * DH;
  float* sCorr = sP + BQ * P_LD;
  float* sL = sCorr + BQ;

  const int n_q = (sq + BQ - 1) / BQ;
  const int qt = n_q - 1 - (int)(blockIdx.x / bh_n);  // last rows first
  const int64_t bh = blockIdx.x % bh_n;
  const int q0 = qt * BQ;
  const T* qb = q + bh * sq * DH;
  const T* kb = k + bh * sk * DH;
  const T* vb = v + bh * sk * DH;

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

  load_rows<T, DH>(sQ, qb, q0, sq);

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's P.V is done with sK, sV, sP
    load_rows<T, DH>(sK, kb, k0, sk);
    load_v<T, DH>(sV, vb, k0, sk);
    __syncthreads();

    if (warp < 4) {
      // scores of rows r0, r1 at columns 8j + 2t + {0, 1}
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        const uint32_t* q32 = reinterpret_cast<const uint32_t*>(sQ);
        const uint32_t* k32 = reinterpret_cast<const uint32_t*>(sK);
        constexpr int W = C::LD / 2;  // row pitch in 32-bit words
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const int w0 = 8 * kk + t;
          const uint32_t a[4] = {q32[r0 * W + w0], q32[r1 * W + w0],
                                 q32[r0 * W + w0 + 4], q32[r1 * W + w0 + 4]};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = 8 * j + g;
            mma_bf16(s[j], a, k32[n * W + w0], k32[n * W + w0 + 4]);
          }
        }
      } else {
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
    T* orow = o + (bh * sq + q0 + r) * DH;
#pragma unroll
    for (int j = 0; j < C::CT; ++j)
      store(orow + cg + C::NCG * j, acc[i][j] / den);
  }
}

template <typename T, int DH>
int launch(const T* q, const T* k, const T* v, T* o, int64_t bh,
           int64_t sq, int64_t sk, int64_t causal, int64_t window,
           float scale, cudaStream_t stream) {
  using C = Cfg<T, DH>;
  // above 48 KB a block's shared memory must be asked for (per device)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (sq + BQ - 1) / BQ * bh;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_fwd<T, DH><<<(unsigned)blocks, C::NT, C::smem, stream>>>(
      q, k, v, o, (int)bh, (int)sq, (int)sk, (int)causal, (int)window, scale,
      (int)(sq == sk));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* q, const T* k, const T* v, T* o, int64_t bh,
             int64_t sq, int64_t sk, int64_t dh, int64_t causal,
             int64_t window, float scale, void* stream) {
  if (bh < 1 || sq < 1 || sk < 1 || window < 0 || sq > 0x7fffffff ||
      sk > 0x7fffffff || window > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dh) {
    case 64:
      return launch<T, 64>(q, k, v, o, bh, sq, sk, causal, window, scale, s);
    case 80:
      return launch<T, 80>(q, k, v, o, bh, sq, sk, causal, window, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, bh, sq, sk, causal, window, scale, s);
    case 256:
      return launch<T, 256>(q, k, v, o, bh, sq, sk, causal, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
