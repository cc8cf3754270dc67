// Batched segment reduction (sum or max): (T, N) f32 values keyed by
// (T, N) int32 segment ids -> (T, C) per-row, per-segment reductions. Ids
// outside [0, C), negative ones included, contribute nothing; an empty
// segment gives the identity (0 for a sum, -inf for a max).
//
// Replaces the TPU kernel
// src/repro/kernels/segsum/kernel.py::segment_reduce_batched.
//
// Bound on the H100: bytes. Each element is read once (8 B: value and id)
// and compared against C segments; at the scheduler's shapes ((1, 1024) a
// period, C = 4) a call moves 8 KB: its byte bound is 2.5 ns, and its time
// is that of a launch. So the design aims at a kernel whose time is the
// launch's and little of its own: one memory latency, a short chain after
// it, and a launch that overlaps the kernel before it.
//
// Two routes; kernels/segsum::segsum_route picks one, and the C entry
// refuses a route that does not take the shape.
//
// vec4 (C <= 8, N a multiple of 4 up to 4096, both arrays on the 16-byte
// grid: every call of the repository's paths). A compile-time instance
// for each C compares each element against C segments only. A row belongs
// to 1-16 warps (4 at N = 1024), each lane holding 2 vectors of 4 values
// and 2 of 4 ids: every lane issues its 16-byte loads (ld.global.nc.v4,
// unconditional) before it uses any, so a row costs one memory latency,
// and the compare-and-add chain after it is 8 elements long. (One warp a
// row with 8 vectors a lane was slower at the path's shape, and 8 warps of
// one vector no faster: the single warp's chain of 32 elements and its
// issue, not the memory, set its time.) Each lane reduces its values in
// element order, the warp in a fixed xor tree (every lane ends with the
// same bits: each step adds the same two values, swapped), then warp 0 of
// the row adds the warps' results in warp order from shared memory. No
// atomics: a sum is the same bit for bit from run to run (it rounds
// otherwise than the generic route: both are within rtol 1e-6 of plain at
// the paths' shapes), a max is exact in any order. Rows of a large T share
// a block.
//
// The vec4 route is launched with programmatic dependent launch (Hopper's
// cudaLaunchAttributeProgrammaticStreamSerialization): the card may start
// the grid before the kernel ahead of it in the stream has ended, and the
// kernel waits for that grid (griddepcontrol.wait) before its first global
// access. Behind a torch elementwise op, as on the scheduler's path, the
// call took about 0.0010 ms so launched and 0.0023 launched plainly on an
// H100 (PERF.md); only the first launch is kept.
//
// generic (every other shape; the first version): one block of 256 threads a
// row walks it with a fixed stride, up to kSeg segments a pass in
// registers, a warp shuffle tree, then warp 0 over the warps' results.
//
// repro_empty_launch and repro_empty_launch_pdl launch a kernel with an
// empty body (the second only waits for the grid ahead of it), plainly and
// as the vec4 route is launched: their times are the card's launch floors,
// the least any launch-sized kernel so launched can take.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 8;  // segments reduced per pass over the row

// the vec4 route
constexpr int kVecSeg = 8;        // most segments of an instance
constexpr int kVecItems = 2;      // 16-byte vectors a lane holds
constexpr int kVecMaxWarps = 16;  // warps of a row, and of a block
constexpr int kVecMaxN = 32 * kVecMaxWarps * kVecItems * 4;  // 4096

template <bool kMax>
__device__ __forceinline__ float combine(float a, float b) {
  return kMax ? fmaxf(a, b) : a + b;
}

template <bool kMax>
__global__ void segsum_kernel(const float* __restrict__ v,
                              const int32_t* __restrict__ ids,
                              float* __restrict__ out, int64_t n, int c) {
  __shared__ float part[kWarps][kSeg];
  const float ident = kMax ? -INFINITY : 0.0f;
  const int64_t row = blockIdx.x;
  const float* vr = v + row * n;
  const int32_t* gr = ids + row * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c0 = 0; c0 < c; c0 += kSeg) {
    float acc[kSeg];
#pragma unroll
    for (int k = 0; k < kSeg; ++k) acc[k] = ident;
    for (int64_t i = threadIdx.x; i < n; i += kThreads) {
      const int g = gr[i] - c0;  // ids outside [c0, c0 + kSeg) match nothing
      const float x = vr[i];
#pragma unroll
      for (int k = 0; k < kSeg; ++k)
        if (g == k) acc[k] = combine<kMax>(acc[k], x);
    }
#pragma unroll
    for (int k = 0; k < kSeg; ++k) {
      float a = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        a = combine<kMax>(a, __shfl_down_sync(0xffffffffu, a, off));
      if (lane == 0) part[warp][k] = a;
    }
    __syncthreads();
    if (threadIdx.x < kSeg && c0 + (int)threadIdx.x < c) {
      float a = part[0][threadIdx.x];
      for (int w = 1; w < kWarps; ++w)
        a = combine<kMax>(a, part[w][threadIdx.x]);
      out[row * c + c0 + threadIdx.x] = a;
    }
    __syncthreads();  // part is reused by the next pass
  }
}

template <int C, bool kMax>
__device__ __forceinline__ void take(float (&acc)[C], float x, int g) {
#pragma unroll
  for (int k = 0; k < C; ++k)
    if (g == k) acc[k] = combine<kMax>(acc[k], x);
}

// A block holds rows_per_block rows of kWpr warps each; the j-th vector of
// lane l of the row's warp w is the row's vector (j * kWpr + w) * 32 + l,
// so each load instruction of a warp reads 512 consecutive bytes. A lane
// past the row's end (or a row past T) loads the row's last vector again
// and drops it: every load is unconditional, so all of them are issued
// before the first use.
template <int C, bool kMax, int kWpr>
__global__ void __launch_bounds__(32 * kVecMaxWarps)
    segsum_vec4(const float4* __restrict__ v, const int4* __restrict__ ids,
                float* __restrict__ out, int t, int n4) {
  __shared__ float part[kVecMaxWarps][C];
  // under programmatic dependent launch the grid starts before the
  // previous kernel of the stream has ended: wait for it (and its writes)
  // before the first global access
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const float ident = kMax ? -INFINITY : 0.0f;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x / (32 * kWpr)) + warp / kWpr;
  const int w = warp % kWpr;
  const bool live = row < t;
  const int64_t base = (int64_t)(live ? row : t - 1) * n4;
  float4 x[kVecItems];
  int4 g[kVecItems];
#pragma unroll
  for (int j = 0; j < kVecItems; ++j) {
    const int i = (j * kWpr + w) * 32 + lane;
    const int64_t at = base + (i < n4 ? i : n4 - 1);
    x[j] = __ldg(v + at);
    g[j] = __ldg(ids + at);
  }
#pragma unroll
  for (int j = 0; j < kVecItems; ++j)
    if ((j * kWpr + w) * 32 + lane >= n4) g[j] = make_int4(-1, -1, -1, -1);
  float acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = ident;
#pragma unroll
  for (int j = 0; j < kVecItems; ++j) {
    take<C, kMax>(acc, x[j].x, g[j].x);
    take<C, kMax>(acc, x[j].y, g[j].y);
    take<C, kMax>(acc, x[j].z, g[j].z);
    take<C, kMax>(acc, x[j].w, g[j].w);
  }
#pragma unroll
  for (int k = 0; k < C; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[k] = combine<kMax>(acc[k],
                             __shfl_xor_sync(0xffffffffu, acc[k], off));
  if (kWpr == 1) {
    float a = ident;
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (lane == k) a = acc[k];
    if (live && lane < C) out[(int64_t)row * C + lane] = a;
    return;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < C; ++k) part[warp][k] = acc[k];
  }
  __syncthreads();
  if (live && w == 0 && lane < C) {
    float a = part[warp][lane];
#pragma unroll
    for (int i = 1; i < kWpr; ++i)
      a = combine<kMax>(a, part[warp + i][lane]);
    out[(int64_t)row * C + lane] = a;
  }
}

// kWait: the kernel waits for the previous grid as a kernel launched with
// programmatic dependent launch must; the body is otherwise empty
template <bool kWait>
__global__ void empty_kernel() {
  if (kWait) asm volatile("griddepcontrol.wait;" ::: "memory");
}

cudaLaunchAttribute pdl_attr() {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  return attr;
}

template <int C, bool kMax, int kWpr>
int launch_vec4(const float* values, const int32_t* ids, float* out, int t,
                int n4, cudaStream_t s) {
  // one row a block while the rows fill the card's 132 SMs, up to a
  // block of kVecMaxWarps warps past it
  int rows = kVecMaxWarps / kWpr;
  if (t / 132 < rows) rows = t / 132 < 1 ? 1 : t / 132;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((t + rows - 1) / rows));
  cfg.blockDim = dim3((unsigned)(32 * kWpr * rows));
  cfg.stream = s;
  cudaLaunchAttribute attr = pdl_attr();
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, segsum_vec4<C, kMax, kWpr>,
                                 reinterpret_cast<const float4*>(values),
                                 reinterpret_cast<const int4*>(ids), out, t,
                                 n4);
}

// warps a row: the fewest of 1, 2, 4, 8, 16 whose lanes hold the row
template <int C, bool kMax>
int launch_vec4_op(const float* values, const int32_t* ids, float* out,
                   int t, int n4, cudaStream_t s) {
  constexpr int kPerWarp = 32 * kVecItems;
  if (n4 <= kPerWarp)
    return launch_vec4<C, kMax, 1>(values, ids, out, t, n4, s);
  if (n4 <= 2 * kPerWarp)
    return launch_vec4<C, kMax, 2>(values, ids, out, t, n4, s);
  if (n4 <= 4 * kPerWarp)
    return launch_vec4<C, kMax, 4>(values, ids, out, t, n4, s);
  if (n4 <= 8 * kPerWarp)
    return launch_vec4<C, kMax, 8>(values, ids, out, t, n4, s);
  return launch_vec4<C, kMax, 16>(values, ids, out, t, n4, s);
}

template <int C>
int launch_vec4_c(const float* values, const int32_t* ids, float* out,
                  int t, int n, int64_t op, cudaStream_t s) {
  return op == 0 ? launch_vec4_op<C, false>(values, ids, out, t, n / 4, s)
                 : launch_vec4_op<C, true>(values, ids, out, t, n / 4, s);
}

}  // namespace

// op: 0 = sum, 1 = max; route: 0 = generic, 1 = vec4 (launched with
// programmatic dependent launch). values, ids (t, n) row-major; out (t, c).
extern "C" int repro_segsum_f32(const float* values, const int32_t* ids,
                                float* out, int64_t t, int64_t n, int64_t c,
                                int64_t op, int64_t route, void* stream) {
  if (t < 1 || n < 0 || c < 1 || c > (1 << 20) || t > 0x7fffffff ||
      (op != 0 && op != 1) || (route != 0 && route != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (c > kVecSeg || n < 1 || n > kVecMaxN || n % 4 ||
        reinterpret_cast<uintptr_t>(values) % 16 ||
        reinterpret_cast<uintptr_t>(ids) % 16)
      return (int)cudaErrorInvalidValue;
    const int ti = (int)t, ni = (int)n;
    switch (c) {
      case 1: return launch_vec4_c<1>(values, ids, out, ti, ni, op, s);
      case 2: return launch_vec4_c<2>(values, ids, out, ti, ni, op, s);
      case 3: return launch_vec4_c<3>(values, ids, out, ti, ni, op, s);
      case 4: return launch_vec4_c<4>(values, ids, out, ti, ni, op, s);
      case 5: return launch_vec4_c<5>(values, ids, out, ti, ni, op, s);
      case 6: return launch_vec4_c<6>(values, ids, out, ti, ni, op, s);
      case 7: return launch_vec4_c<7>(values, ids, out, ti, ni, op, s);
      default: return launch_vec4_c<8>(values, ids, out, ti, ni, op, s);
    }
  }
  if (op == 0)
    segsum_kernel<false><<<(unsigned)t, kThreads, 0, s>>>(values, ids, out,
                                                          n, (int)c);
  else
    segsum_kernel<true><<<(unsigned)t, kThreads, 0, s>>>(values, ids, out,
                                                         n, (int)c);
  return (int)cudaGetLastError();
}

// A kernel with an empty body, one warp: the card's launch floor.
extern "C" int repro_empty_launch(void* stream) {
  empty_kernel<false><<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The same launched as segsum's vec4 route is, with programmatic dependent
// launch, its body only the wait for the previous grid: the floor of a
// kernel so launched.
extern "C" int repro_empty_launch_pdl(void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(32);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr = pdl_attr();
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, empty_kernel<true>);
}
