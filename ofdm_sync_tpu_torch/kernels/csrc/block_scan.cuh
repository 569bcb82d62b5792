// Scans shared by the kernels.
//
// The block_* helper is called by ALL threads of the block (it contains
// __syncthreads), needs blockDim.x to be a multiple of 32 and at most 1024,
// and takes a 32-entry shared scratch array that it leaves free for reuse
// on return; the pair and map operations beside it serve warp scans written
// in the kernels (span_walk.cuh has the float64 warp scan of C and D).
// Exclusive prefixes are formed by shuffling the inclusive prefix one lane
// up, never by subtracting the own value, so a float scan adds each term
// exactly once.
#pragma once

#include <cuda_runtime.h>

namespace ofdm {

constexpr unsigned kFull = 0xffffffffu;

// ---- (sum, sum) pair in float64: kernel A's window increments (warp scan) --
__device__ __forceinline__ double2 add2(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double2 shfl_up2(double2 v, int d) {
  return make_double2(__shfl_up_sync(kFull, v.x, d), __shfl_up_sync(kFull, v.y, d));
}

// ---- affine maps s -> A*s + B in float32: the smoothing recurrence (warp scan)
// compose(l, r) applies l first, then r.
__device__ __forceinline__ float2 compose(float2 l, float2 r) {
  return make_float2(l.x * r.x, fmaf(r.x, l.y, r.y));
}

__device__ __forceinline__ float2 shfl_up_f2(float2 v, int d) {
  return make_float2(__shfl_up_sync(kFull, v.x, d), __shfl_up_sync(kFull, v.y, d));
}

// ---- int32 exclusive max / sum, with the block total ----------------------
template <bool kMax>
__device__ __forceinline__ int int_op(int a, int b) {
  return kMax ? max(a, b) : a + b;
}

template <bool kMax>
__device__ __forceinline__ int block_excl_int(int v, int ident, int* sbuf, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc = int_op<kMax>(o, inc);
  }
  int exc = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) exc = ident;
  if (lane == 31) sbuf[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int t = lane < nw ? sbuf[lane] : ident;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t = int_op<kMax>(o, t);
    }
    if (lane < nw) sbuf[lane] = t;
  }
  __syncthreads();
  const int r = warp > 0 ? int_op<kMax>(sbuf[warp - 1], exc) : exc;
  *total = sbuf[nw - 1];
  __syncthreads();
  return r;
}

}  // namespace ofdm
