// Rowwise symmetric integer quantization: x (n, d) f32 or bf16 -> q (n, d)
// int8 and one f32 scale a row,
//   scale = max(amax, 1e-8) * recip,    recip = f32(1 / qmax)
//   q     = clip(round_half_even(x / scale), -qmax - 1, qmax)
// with a true IEEE division and round-half-even (rintf, as jnp.round and
// torch.round; roundf rounds half away from zero). qmax is 127 for int8
// serving and the INT8 boundary codec, 7 for the INT4 codec. The caller
// passes recip, the double 1 / qmax rounded once to f32 on the host, as the
// reference's jnp.float32(1.0 / qmax); 1.0f / qmax on the card could differ
// by an ulp. The scale's reciprocal multiply and the division are both
// load-bearing: a 1-ulp skew of the scale flips a rounding, so every
// operation is written with its _rn intrinsic and nvcc can contract
// nothing.
//
// Replaces the TPU kernel src/repro/kernels/quant/kernel.py::quantize.
//
// Bound on the H100: bytes. The least work reads each value once (4 B
// f32, 2 B bf16) and writes 1 B of code a value, against about 5
// operations a value. At one pass of the CNN fc's activations (365 x
// 78624 f32) that is 115 MB read and 29 MB written, about 43 us at
// 3.35 TB/s.
//
// Design: every route but the last reads each value from device memory
// once, holding the row on chip between its amax and its codes. The
// wrapper (kernels/quant/__init__.py::route) picks the route from the row's
// bytes, its dtype and whether the rows lie on the 16-byte grid (the base
// 16-byte aligned and d * sizeof(T) a multiple of 16):
//   - warp (rows on the grid of up to 2 KB: the VGG boundary's 64- to
//     512-channel NHWC rows, the 124-wide activations, mamba2-370m's 1024
//     bf16 boundary rows): a group of 1-32 lanes a row, several rows a
//     warp where the row is short, each lane holding up to 4 16-byte
//     vectors in registers; the amax by segmented xor shuffles inside the
//     group, the codes stored 4 (f32) or 8 (bf16) at a time from the
//     registers;
//   - warp_scalar (rows off the grid of up to 1024 values: the weights' 15-
//     value rows, VGG's 3-channel input rows, any unaligned base): the
//     same with one value a load, up to 32 a lane;
//   - block (rows on the grid of up to 128 KB: granite-8b's 4096 bf16
//     boundary rows, VGG's flat fc rows): a block a row, 4 vectors a
//     thread in registers (64-512 threads: 128 at granite's 8 KB, so 16
//     rows an SM stay in flight), up to 16 at 512 threads;
//   - cluster (rows on the grid of up to 8 slices of 208 KB: the fc's
//     78,624 f32 values, 314 KB, more than one SM holds): a cluster of 8
//     blocks of 256 threads a row (39 KB slices at the fc's rows, five
//     blocks an SM), each block's slice brought into shared memory by its
//     threads' 16-byte loads, 8 in flight a thread, the amax taken on the
//     way; the blocks push their partial amaxes into every peer's shared
//     memory (distributed shared memory) behind one cluster barrier, then
//     write codes from shared memory. A barrier arrival at the start,
//     waited on just before the push, makes sure that every peer is
//     running. (Bulk copies on an mbarrier instead of the loads, clusters
//     of 2 or 4, 512-thread blocks, persistent clusters with two to four
//     slice buffers a block, and no slab, each block reading its slice
//     twice, measured no faster, PERF.md);
//   - two_pass (longer rows, and rows off the grid past 1024 values; no
//     path of the repository takes it): a block of 512 threads a row that
//     reads the row for its amax and again for its codes, hoping for L2.
// bf16 rows are widened in registers, which is exact, so the codes are
// those of the f32 values and no f32 copy is made. The one-read routes make
// each code from the row's reciprocal scale and fall back to the division
// only next to a tie (Coder): the same bits with no reciprocal or
// conversion a value.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

namespace cg = cooperative_groups;

// route codes of the C entry points (kernels/quant/__init__.py::ROUTE_IDS)
enum Route { kWarp = 0, kWarpScalar = 1, kBlock = 2, kCluster = 3,
             kTwoPass = 4 };

constexpr int kWarpBlock = 256;  // threads a block of the warp routes
constexpr int kRowBlock = 512;   // threads a block of a row's own blocks
constexpr int kWarpVec = 4;      // 16-byte vectors a lane holds (warp)
constexpr int kBlockVec = 16;    // and a thread of the block route
constexpr int kMaxScalar = 32;   // values a lane holds (warp_scalar)
constexpr int kClusterSize = 8;     // blocks a row of the cluster route
constexpr int kClusterBlock = 256;  // threads a block of the cluster route
constexpr int kInFlight = 8;        // its loads a thread at a time
// a cluster block's slice: the shared memory beside the static arrays
constexpr int kMaxSlice = 208 * 1024;

__device__ __forceinline__ float row_scale(float amax, float recip) {
  const float floor = 1e-8f;
  return __fmul_rn(amax < floor ? floor : amax, recip);
}

// hi = qmax; the codes lie in [-hi - 1, hi]
__device__ __forceinline__ int8_t code(float x, float scale, float hi) {
  const float v = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -hi - 1.0f), hi);
  return (int8_t)__float2int_rn(v);
}

__device__ __forceinline__ uint32_t code4(float a, float b, float c, float d,
                                          float s, float hi) {
  return (uint32_t)(uint8_t)code(a, s, hi) |
         ((uint32_t)(uint8_t)code(b, s, hi) << 8) |
         ((uint32_t)(uint8_t)code(c, s, hi) << 16) |
         ((uint32_t)(uint8_t)code(d, s, hi) << 24);
}

constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;
constexpr float kTieFree = 0.5f - 0x1p-13f;

// The codes of a row through its scale's reciprocal y = RN(1 / s): the
// code of x is that of x * y unless x * y lies within 2^-13 of a
// half-integer, where the true division decides. That gives code()'s bits:
// |x / s| <= qmax (1 + 2^-22) <= 128, and x * y = (x / s)(1 + e) with
// |e| <= 2^-23, so x * y and RN(x / s) both lie within 2^-15 of x / s and
// round to the same integer unless one is that close to a half-integer.
// Rounding (half to even) and the clip go through the bits of
// 1.5 * 2^23 + x * y, whose low byte is the code; NaN takes the division.
// A multiply and four adds on the FP32 pipe in place of the division's
// reciprocal and the conversions, which run at an eighth of that rate.
struct Coder {
  float s, y, hi;
  int lo_bits, hi_bits;
};

__device__ __forceinline__ Coder coder(float s, float qmax) {
  return {s, __frcp_rn(s), qmax, kMagicBits - (int)qmax - 1,
          kMagicBits + (int)qmax};
}

__device__ __forceinline__ uint32_t code_fast(const Coder& k, float x) {
  const float q = __fmul_rn(x, k.y);
  const float t = __fadd_rn(q, kMagic);
  if (fabsf(__fsub_rn(q, __fsub_rn(t, kMagic))) < kTieFree)
    return (uint32_t)min(max(__float_as_int(t), k.lo_bits), k.hi_bits) & 0xffu;
  return (uint32_t)(uint8_t)code(x, k.s, k.hi);
}

__device__ __forceinline__ uint32_t code_fast4(const Coder& k, float a,
                                               float b, float c, float d) {
  return code_fast(k, a) | (code_fast(k, b) << 8) | (code_fast(k, c) << 16) |
         (code_fast(k, d) << 24);
}

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

// bf16 pair in a little-endian word: value 0 in the low half
__device__ __forceinline__ float bf_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

// 16 bytes of a row: 4 f32 or 8 bf16 values, their amax and their codes
// (4 or 8 bytes at code index 4 or 8 x `chunk` of the row)
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kVals = 4;
  static __device__ __forceinline__ float amax(uint4 v) {
    return fmaxf(fmaxf(fabsf(__uint_as_float(v.x)), fabsf(__uint_as_float(v.y))),
                 fmaxf(fabsf(__uint_as_float(v.z)), fabsf(__uint_as_float(v.w))));
  }
  static __device__ __forceinline__ void store(int8_t* q, int64_t chunk,
                                               uint4 v, const Coder& k) {
    reinterpret_cast<uint32_t*>(q)[chunk] =
        code_fast4(k, __uint_as_float(v.x), __uint_as_float(v.y),
                   __uint_as_float(v.z), __uint_as_float(v.w));
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kVals = 8;
  static __device__ __forceinline__ float amax(uint4 v) {
    const float a = fmaxf(fmaxf(fabsf(bf_lo(v.x)), fabsf(bf_hi(v.x))),
                          fmaxf(fabsf(bf_lo(v.y)), fabsf(bf_hi(v.y))));
    const float b = fmaxf(fmaxf(fabsf(bf_lo(v.z)), fabsf(bf_hi(v.z))),
                          fmaxf(fabsf(bf_lo(v.w)), fabsf(bf_hi(v.w))));
    return fmaxf(a, b);
  }
  static __device__ __forceinline__ void store(int8_t* q, int64_t chunk,
                                               uint4 v, const Coder& k) {
    reinterpret_cast<uint2*>(q)[chunk] =
        make_uint2(
            code_fast4(k, bf_lo(v.x), bf_hi(v.x), bf_lo(v.y), bf_hi(v.y)),
            code_fast4(k, bf_lo(v.z), bf_hi(v.z), bf_lo(v.w), bf_hi(v.w)));
  }
};

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

// the max of `m` over the block, returned to every thread: one word a warp
// in `red`, then every warp reduces those (one barrier; `red` used once)
__device__ __forceinline__ float block_max(float m, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
  return warp_max(m);
}

// warp: rows of `chunks` 16-byte vectors, a group of 2^lanes_log2 lanes a
// row, vector i * lanes + sub of the row in lane sub's v[i]
template <typename T, int V>
__global__ void __launch_bounds__(kWarpBlock)
    quant_rows_warp(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scale, int64_t n, int chunks,
                    int lanes_log2, float hi, float recip) {
  const int lanes = 1 << lanes_log2;
  const int sub = threadIdx.x & (lanes - 1);
  const int64_t row = (int64_t)blockIdx.x * (kWarpBlock >> lanes_log2) +
                      (threadIdx.x >> lanes_log2);
  const bool live = row < n;  // a dead group still takes part in shuffles
  const uint4* xr =
      reinterpret_cast<const uint4*>(x) + (live ? row : 0) * chunks;
  uint4 v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = i * lanes + sub;
    v[i] = live && c < chunks ? __ldcs(xr + c) : make_uint4(0u, 0u, 0u, 0u);
  }
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) m = fmaxf(m, Vec16<T>::amax(v[i]));
  for (int off = lanes >> 1; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (!live) return;
  const float s = row_scale(m, recip);
  const Coder k = coder(s, hi);
  int8_t* qr = q + row * chunks * Vec16<T>::kVals;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = i * lanes + sub;
    if (c < chunks) Vec16<T>::store(qr, c, v[i], k);
  }
  if (sub == 0) scale[row] = s;
}

// warp_scalar: rows of d values at any alignment, a group of 2^lanes_log2
// lanes a row, value i * lanes + sub of the row in lane sub's v[i]
template <typename T, int V>
__global__ void __launch_bounds__(kWarpBlock)
    quant_rows_warp_scalar(const T* __restrict__ x, int8_t* __restrict__ q,
                           float* __restrict__ scale, int64_t n, int d,
                           int lanes_log2, float hi, float recip) {
  const int lanes = 1 << lanes_log2;
  const int sub = threadIdx.x & (lanes - 1);
  const int64_t row = (int64_t)blockIdx.x * (kWarpBlock >> lanes_log2) +
                      (threadIdx.x >> lanes_log2);
  const bool live = row < n;
  const T* xr = x + (live ? row : 0) * d;
  float v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = i * lanes + sub;
    v[i] = live && c < d ? ld(xr, c) : 0.0f;
  }
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) m = fmaxf(m, fabsf(v[i]));
  for (int off = lanes >> 1; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (!live) return;
  const float s = row_scale(m, recip);
  const Coder k = coder(s, hi);
  int8_t* qr = q + row * d;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = i * lanes + sub;
    if (c < d) qr[c] = (int8_t)code_fast(k, v[i]);
  }
  if (sub == 0) scale[row] = s;
}

// block: one row of `chunks` 16-byte vectors a block of 64-512 threads,
// vector i * blockDim.x + tid in v[i]
template <typename T, int V>
__global__ void __launch_bounds__(kRowBlock)
    quant_row_block(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scale, int chunks, float hi,
                    float recip) {
  __shared__ float red[kRowBlock / 32];
  const int64_t row = blockIdx.x;
  const int nt = blockDim.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x) + row * chunks;
  uint4 v[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = i * nt + threadIdx.x;
    v[i] = c < chunks ? __ldcs(xr + c) : make_uint4(0u, 0u, 0u, 0u);
  }
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) m = fmaxf(m, Vec16<T>::amax(v[i]));
  const float s = row_scale(block_max(m, red), recip);
  const Coder k = coder(s, hi);
  int8_t* qr = q + row * chunks * Vec16<T>::kVals;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = i * nt + threadIdx.x;
    if (c < chunks) Vec16<T>::store(qr, c, v[i], k);
  }
  if (threadIdx.x == 0) scale[row] = s;
}

// cluster: one row of `chunks` 16-byte vectors a cluster of kClusterSize
// blocks (the cluster's blocks adjacent in x), block rank r holding
// vectors [r per, min((r + 1) per, chunks)) in shared memory
template <typename T>
__global__ void __cluster_dims__(kClusterSize, 1, 1)
    __launch_bounds__(kClusterBlock)
    quant_row_cluster(const T* __restrict__ x, int8_t* __restrict__ q,
                      float* __restrict__ scale, int chunks, int per,
                      float hi, float recip) {
  extern __shared__ __align__(16) uint4 slab[];
  __shared__ float red[kClusterBlock / 32];
  __shared__ float part[kClusterSize];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t row = blockIdx.x / kClusterSize;
  const int c0 = rank * per, cnt = max(0, min(per, chunks - c0));
  const int tid = threadIdx.x;
  // the peers' shared memory may be written only once they run: arrive
  // now, wait just before the push
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  // the slice by 16-byte loads, kInFlight a thread at a time, the amax on
  // the way
  const uint4* src = reinterpret_cast<const uint4*>(x) + row * chunks + c0;
  float m = 0.0f;
  for (int i0 = tid; i0 < cnt; i0 += kInFlight * kClusterBlock) {
    uint4 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * kClusterBlock;
      v[u] = i < cnt ? __ldcs(src + i) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int i = i0 + u * kClusterBlock;
      if (i < cnt) slab[i] = v[u];
      m = fmaxf(m, Vec16<T>::amax(v[u]));
    }
  }
  m = block_max(m, red);  // its barrier also publishes the slab
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < kClusterSize) cluster.map_shared_rank(part, tid)[rank] = m;
  cluster.sync();  // every partial pushed; no peer's memory is touched after
  float a = 0.0f;
#pragma unroll
  for (int r = 0; r < kClusterSize; ++r) a = fmaxf(a, part[r]);
  const float s = row_scale(a, recip);
  const Coder k = coder(s, hi);
  int8_t* qr = q + row * chunks * Vec16<T>::kVals;
  for (int i = tid; i < cnt; i += kClusterBlock)
    Vec16<T>::store(qr, c0 + i, slab[i], k);
  if (rank == 0 && tid == 0) scale[row] = s;
}

// two_pass: one row a block, read for its amax and read again for its
// codes (the first version's long-row kernel); `vec`: rows on the grid of
// 16-byte (f32) or 8-byte (bf16) vectors of four values
__device__ __forceinline__ float4 ld4(const float* p, int i) {
  return reinterpret_cast<const float4*>(p)[i];
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p, int i) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[i];
  return make_float4(bf_lo(u.x), bf_hi(u.x), bf_lo(u.y), bf_hi(u.y));
}

template <typename T>
__global__ void __launch_bounds__(kRowBlock)
    quant_rows_two_pass(const T* __restrict__ x, int8_t* __restrict__ q,
                        float* __restrict__ scale, int d, bool vec, float hi,
                        float recip) {
  __shared__ float red[kRowBlock / 32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  int8_t* qr = q + row * d;
  float m = 0.0f;
  if (vec) {
    for (int i = threadIdx.x; i < d / 4; i += blockDim.x) {
      const float4 v = ld4(xr, i);
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                         fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      m = fmaxf(m, fabsf(ld(xr, i)));
  }
  const float s = row_scale(block_max(m, red), recip);
  if (vec) {
    uint32_t* q4 = reinterpret_cast<uint32_t*>(qr);
    for (int i = threadIdx.x; i < d / 4; i += blockDim.x) {
      const float4 v = ld4(xr, i);
      q4[i] = code4(v.x, v.y, v.z, v.w, s, hi);
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      qr[i] = code(ld(xr, i), s, hi);
  }
  if (threadIdx.x == 0) scale[row] = s;
}

int ceil_log2(int64_t v) {
  int l = 0;
  while ((int64_t{1} << l) < v) ++l;
  return l;
}

// the warp routes' group of 2^lanes_log2 lanes a row and loads a lane (a
// power of two) for a row of `units` loads, or -1 past `most` a lane
int warp_shape(int64_t units, int most, int* lanes_log2) {
  if (units > 32 * (int64_t)most) return -1;
  *lanes_log2 = ceil_log2(units < 32 ? units : 32);
  return 1 << ceil_log2((units + 31) / 32);
}

template <typename T>
int quantize_rows(const T* x, int8_t* q, float* scale, int64_t n, int64_t d,
                  int64_t qmax, float recip, int64_t route, void* stream) {
  if (n < 1 || d < 1 || d > 0x7fffffff || qmax < 1 || qmax > 127)
    return (int)cudaErrorInvalidValue;
  const float hi = (float)qmax;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t bytes = d * (int64_t)sizeof(T);
  const bool grid16 = bytes % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                      (uintptr_t)q % 16 == 0;
  const int64_t chunks = bytes / 16;
  int lanes_log2 = 0;
  switch (route) {
    case kWarp: {
      if (!grid16) return (int)cudaErrorInvalidValue;
      const int per = warp_shape(chunks, kWarpVec, &lanes_log2);
      const int64_t blocks =
          (n + (kWarpBlock >> lanes_log2) - 1) / (kWarpBlock >> lanes_log2);
      if (per < 0 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
      const int c = (int)chunks;
      switch (per) {
#define WARP_CASE(V)                                                    \
  case V:                                                               \
    quant_rows_warp<T, V><<<(unsigned)blocks, kWarpBlock, 0, s>>>(     \
        x, q, scale, n, c, lanes_log2, hi, recip);                      \
    break;
        WARP_CASE(1) WARP_CASE(2) WARP_CASE(4)
#undef WARP_CASE
        default:
          return (int)cudaErrorInvalidValue;
      }
      break;
    }
    case kWarpScalar: {
      const int per = warp_shape(d, kMaxScalar, &lanes_log2);
      const int64_t blocks =
          (n + (kWarpBlock >> lanes_log2) - 1) / (kWarpBlock >> lanes_log2);
      if (per < 0 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
      switch (per) {
#define SCALAR_CASE(V)                                                  \
  case V:                                                               \
    quant_rows_warp_scalar<T, V><<<(unsigned)blocks, kWarpBlock, 0, s>>>( \
        x, q, scale, n, (int)d, lanes_log2, hi, recip);                 \
    break;
        SCALAR_CASE(1) SCALAR_CASE(2) SCALAR_CASE(4) SCALAR_CASE(8)
        SCALAR_CASE(16) SCALAR_CASE(32)
#undef SCALAR_CASE
        default:
          return (int)cudaErrorInvalidValue;
      }
      break;
    }
    case kBlock: {
      // 4 vectors a thread while that takes at most 512 threads
      if (!grid16 || n > 0x7fffffff || chunks > kRowBlock * kBlockVec)
        return (int)cudaErrorInvalidValue;
      const int64_t nt = std::min<int64_t>(kRowBlock,
                                           32 * ((chunks + 127) / 128));
      const int per = 1 << ceil_log2((chunks + nt - 1) / nt);
      switch (per) {
#define BLOCK_CASE(V)                                                   \
  case V:                                                               \
    quant_row_block<T, V><<<(unsigned)n, (unsigned)nt, 0, s>>>(         \
        x, q, scale, (int)chunks, hi, recip);                           \
    break;
        BLOCK_CASE(1) BLOCK_CASE(2) BLOCK_CASE(4) BLOCK_CASE(8)
        BLOCK_CASE(16)
#undef BLOCK_CASE
        default:
          return (int)cudaErrorInvalidValue;
      }
      break;
    }
    case kCluster: {
      // every block of a row's cluster holds a slice, none past kMaxSlice
      const int64_t per = (chunks + kClusterSize - 1) / kClusterSize;
      if (!grid16 || n * kClusterSize > 0x7fffffff ||
          per * 16 > kMaxSlice || per * (kClusterSize - 1) >= chunks)
        return (int)cudaErrorInvalidValue;
      const int smem = (int)(per * 16);
      const cudaError_t e = cudaFuncSetAttribute(
          quant_row_cluster<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return (int)e;
      quant_row_cluster<T><<<(unsigned)(n * kClusterSize), kClusterBlock,
                             smem, s>>>(x, q, scale, (int)chunks, (int)per,
                                        hi, recip);
      break;
    }
    case kTwoPass: {
      if (n > 0x7fffffff) return (int)cudaErrorInvalidValue;
      // rows of d % 4 == 0 values stay aligned for 4-value loads from an
      // aligned base
      const bool vec = d % 4 == 0 && (uintptr_t)x % (4 * sizeof(T)) == 0 &&
                       (uintptr_t)q % 4 == 0;
      quant_rows_two_pass<T><<<(unsigned)n, kRowBlock, 0, s>>>(
          x, q, scale, (int)d, vec, hi, recip);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// route: Route above
extern "C" int repro_quantize_rows_s8(const float* x, int8_t* q, float* scale,
                                      int64_t n, int64_t d, int64_t qmax,
                                      float recip, int64_t route,
                                      void* stream) {
  return quantize_rows(x, q, scale, n, d, qmax, recip, route, stream);
}

extern "C" int repro_quantize_rows_bf16_s8(const __nv_bfloat16* x, int8_t* q,
                                           float* scale, int64_t n, int64_t d,
                                           int64_t qmax, float recip,
                                           int64_t route, void* stream) {
  return quantize_rows(x, q, scale, n, d, qmax, recip, route, stream);
}
