// Block-wide scans shared by the kernels.
//
// Every helper is called by ALL threads of the block (it contains
// __syncthreads), needs blockDim.x to be a multiple of 32 and at most 1024,
// and takes a 32-entry shared scratch array that it leaves free for reuse
// on return.  Exclusive prefixes are formed by shuffling the inclusive
// prefix one lane up, never by subtracting the own value, so a float scan
// adds each term exactly once.
#pragma once

#include <cuda_runtime.h>

namespace ofdm {

constexpr unsigned kFull = 0xffffffffu;

// ---- (sum, sum) pair in float64: chunk-local prefix sums ------------------
__device__ __forceinline__ double2 add2(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double2 shfl_up2(double2 v, int d) {
  return make_double2(__shfl_up_sync(kFull, v.x, d), __shfl_up_sync(kFull, v.y, d));
}

__device__ __forceinline__ double2 block_excl_sum2(double2 v, double2* sbuf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  double2 inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    const double2 o = shfl_up2(inc, d);
    if (lane >= d) inc = add2(o, inc);
  }
  double2 exc = shfl_up2(inc, 1);
  if (lane == 0) exc = make_double2(0.0, 0.0);
  if (lane == 31) sbuf[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    double2 t = lane < nw ? sbuf[lane] : make_double2(0.0, 0.0);
    for (int d = 1; d < 32; d <<= 1) {
      const double2 o = shfl_up2(t, d);
      if (lane >= d) t = add2(o, t);
    }
    if (lane < nw) sbuf[lane] = t;  // inclusive warp totals
  }
  __syncthreads();
  const double2 r = warp > 0 ? add2(sbuf[warp - 1], exc) : exc;
  __syncthreads();
  return r;
}

// ---- (sum, sum, sum) triple in float64: the [A][A] prefix sums ----------
__device__ __forceinline__ double3 add3(double3 a, double3 b) {
  return make_double3(a.x + b.x, a.y + b.y, a.z + b.z);
}

__device__ __forceinline__ double3 shfl_up3(double3 v, int d) {
  return make_double3(__shfl_up_sync(kFull, v.x, d), __shfl_up_sync(kFull, v.y, d),
                      __shfl_up_sync(kFull, v.z, d));
}

// inclusive prefix of v over the block, and the block total in *total
__device__ __forceinline__ double3 block_incl_sum3(double3 v, double3* sbuf,
                                                   double3* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const double3 zero = make_double3(0.0, 0.0, 0.0);
  double3 inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    const double3 o = shfl_up3(inc, d);
    if (lane >= d) inc = add3(o, inc);
  }
  if (lane == 31) sbuf[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    double3 t = lane < nw ? sbuf[lane] : zero;
    for (int d = 1; d < 32; d <<= 1) {
      const double3 o = shfl_up3(t, d);
      if (lane >= d) t = add3(o, t);
    }
    if (lane < nw) sbuf[lane] = t;  // inclusive warp totals
  }
  __syncthreads();
  const double3 r = warp > 0 ? add3(sbuf[warp - 1], inc) : inc;
  *total = sbuf[nw - 1];
  __syncthreads();
  return r;
}

// ---- affine maps s -> A*s + B in float32: the smoothing recurrence --------
// compose(l, r) applies l first, then r.
__device__ __forceinline__ float2 compose(float2 l, float2 r) {
  return make_float2(l.x * r.x, fmaf(r.x, l.y, r.y));
}

__device__ __forceinline__ float2 shfl_up_f2(float2 v, int d) {
  return make_float2(__shfl_up_sync(kFull, v.x, d), __shfl_up_sync(kFull, v.y, d));
}

__device__ __forceinline__ float2 block_excl_affine(float2 v, float2* sbuf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const float2 ident = make_float2(1.0f, 0.0f);
  float2 inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    const float2 o = shfl_up_f2(inc, d);
    if (lane >= d) inc = compose(o, inc);
  }
  float2 exc = shfl_up_f2(inc, 1);
  if (lane == 0) exc = ident;
  if (lane == 31) sbuf[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    float2 t = lane < nw ? sbuf[lane] : ident;
    for (int d = 1; d < 32; d <<= 1) {
      const float2 o = shfl_up_f2(t, d);
      if (lane >= d) t = compose(o, t);
    }
    if (lane < nw) sbuf[lane] = t;
  }
  __syncthreads();
  const float2 r = warp > 0 ? compose(sbuf[warp - 1], exc) : exc;
  __syncthreads();
  return r;
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
