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
// Bound on the H100: bytes. A row is read for its amax and read again for
// its codes; the least work reads it once (4 B a value) and writes 1 B a
// value. At one pass of the CNN fc's activations (365 x 78624) that is
// 115 MB read and 29 MB written, about 43 us at 3.35 TB/s, against about
// 5 operations a value.
//
// Design. Long rows (the fc's 78,624 values) take one block of 512
// threads each: float4 loads, an amax reduction through warp shuffles and
// shared memory, then a second pass over the row, which the block has just
// read and finds in L2, writing four codes at a time. Short rows (the
// 124-wide activations, the weights' 15- and 124-value rows, the boundary
// codec's channel rows) take one warp each, eight to a block. Fusing the
// quantization into the producer of the activations (the conv trunk, or
// qmm's load) would save the f32 round trip through device memory; that is
// later work. bf16 rows (the LM's boundary activation, (16384, 4096) at
// batch 4 x 4096 tokens) are read as bf16 and widened in registers, which
// is exact, so the codes are those of the f32 values and no f32 copy of the
// activation is made.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kShortRow = 1024;  // rows up to this many values: a warp each
constexpr int kBlockThreads = 512;
constexpr int kWarpThreads = 256;

__device__ __forceinline__ float row_scale(float amax, float recip) {
  const float floor = 1e-8f;
  return __fmul_rn(amax < floor ? floor : amax, recip);
}

// hi = qmax; the codes lie in [-hi - 1, hi]
__device__ __forceinline__ int8_t code(float x, float scale, float hi) {
  const float v = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -hi - 1.0f), hi);
  return (int8_t)__float2int_rn(v);
}

__device__ __forceinline__ float ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
// values 4i .. 4i + 3 of a row that starts 16-byte (f32) or 8-byte (bf16)
// aligned
__device__ __forceinline__ float4 ld4(const float* p, int i) {
  return reinterpret_cast<const float4*>(p)[i];
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p, int i) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[i];  // little-endian
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

template <typename T>
__global__ void quant_rows_warp(const T* __restrict__ x,
                                int8_t* __restrict__ q,
                                float* __restrict__ scale, int64_t n, int d,
                                float hi, float recip) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp leaves together
  const T* xr = x + row * d;
  float m = 0.0f;
  for (int i = lane; i < d; i += 32) m = fmaxf(m, fabsf(ld(xr, i)));
  const float s = row_scale(warp_max(m), recip);
  int8_t* qr = q + row * d;
  for (int i = lane; i < d; i += 32) qr[i] = code(ld(xr, i), s, hi);
  if (lane == 0) scale[row] = s;
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads)
    quant_rows_block(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int d, bool vec, float hi,
                     float recip) {
  __shared__ float red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
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
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.0f;
    m = warp_max(m);
    if (lane == 0) red[0] = m;
  }
  __syncthreads();
  const float s = row_scale(red[0], recip);
  if (vec) {
    char4* q4 = reinterpret_cast<char4*>(qr);
    for (int i = threadIdx.x; i < d / 4; i += blockDim.x) {
      const float4 v = ld4(xr, i);
      q4[i] = make_char4(code(v.x, s, hi), code(v.y, s, hi),
                         code(v.z, s, hi), code(v.w, s, hi));
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      qr[i] = code(ld(xr, i), s, hi);
  }
  if (threadIdx.x == 0) scale[row] = s;
}

template <typename T>
int quantize_rows(const T* x, int8_t* q, float* scale, int64_t n, int64_t d,
                  int64_t qmax, float recip, void* stream) {
  if (n < 1 || d < 1 || d > 0x7fffffff || qmax < 1 || qmax > 127)
    return (int)cudaErrorInvalidValue;
  const float hi = (float)qmax;
  cudaStream_t s = (cudaStream_t)stream;
  if (d <= kShortRow) {
    const int64_t rows_per_block = kWarpThreads / 32;
    const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    quant_rows_warp<T><<<(unsigned)blocks, kWarpThreads, 0, s>>>(
        x, q, scale, n, (int)d, hi, recip);
  } else {
    if (n > 0x7fffffff) return (int)cudaErrorInvalidValue;
    // rows of d % 4 == 0 values stay aligned for 4-value loads from an
    // aligned base
    const bool vec = d % 4 == 0 && (uintptr_t)x % (4 * sizeof(T)) == 0 &&
                     (uintptr_t)q % 4 == 0;
    quant_rows_block<T><<<(unsigned)n, kBlockThreads, 0, s>>>(
        x, q, scale, (int)d, vec, hi, recip);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_quantize_rows_s8(const float* x, int8_t* q, float* scale,
                                      int64_t n, int64_t d, int64_t qmax,
                                      float recip, void* stream) {
  return quantize_rows(x, q, scale, n, d, qmax, recip, stream);
}

extern "C" int repro_quantize_rows_bf16_s8(const __nv_bfloat16* x, int8_t* q,
                                           float* scale, int64_t n, int64_t d,
                                           int64_t qmax, float recip,
                                           void* stream) {
  return quantize_rows(x, q, scale, n, d, qmax, recip, stream);
}
