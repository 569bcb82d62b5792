// Helpers of the batched Minn-RTL receive's two kernels (minn_rx_front.cu,
// minn_rx_back.cu): the CTA's size, the copy of a run of samples into
// shared memory, a float64 sum over the CTA and complex64 arithmetic as
// PyTorch's c10::complex<float> does it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "span_walk.cuh"

namespace ofdm {
namespace rx {

// threads a CTA: one CTA a slot in both kernels
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// shared bytes that hold n samples of T copied from any T-aligned address
// as whole aligned 16-byte chunks
template <typename T>
__host__ __device__ constexpr int run_bytes(int n) {
  return (n * (int)sizeof(T) + 15) / 16 * 16 + 16;
}

// starts the copy of the n samples at src into dst (16-byte aligned) as the
// aligned 16-byte chunks that hold them; returns where sample 0 lands
template <typename T>
__device__ __forceinline__ const T* copy_run(unsigned char* dst, const T* src, int n) {
  const uintptr_t at = (uintptr_t)src, lo = at & ~(uintptr_t)15;
  const int chunks = (int)((at + (uintptr_t)n * sizeof(T) - lo + 15) / 16);
  for (int k = threadIdx.x; k < chunks; k += kThreads)
    walk::cp_async16(reinterpret_cast<int16_t*>(dst + 16 * k),
                           reinterpret_cast<const int16_t*>(lo + 16 * k));
  return reinterpret_cast<const T*>(dst + (at - lo));
}

// Sums each v[i] over the CTA in float64, in a fixed order (warp shuffles,
// then the kWarps warp totals in warp order), and leaves the totals in every
// thread's v.  Called by ALL threads; scratch holds kVals * kWarps doubles
// and is free for reuse on return.
template <int kVals>
__device__ __forceinline__ void block_sum(double (&v)[kVals], double* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kVals; ++i) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v[i] += __shfl_xor_sync(kFull, v[i], d);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kVals; ++i) scratch[i * kWarps + warp] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kVals; ++i) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += scratch[i * kWarps + w];
    v[i] = s;
  }
  __syncthreads();
}

// (a + ib)(c + id), as c10::complex<float>::operator*=
__device__ __forceinline__ float2 cmul(float2 x, float2 y) {
  return make_float2(x.x * y.x - x.y * y.y, x.x * y.y + x.y * y.x);
}

// n / d by c10::complex<float>::operator/= (numpy's scaled division: the
// smaller of |Re d| and |Im d| is divided by the larger, so no |d|^2 is
// formed), which PyTorch's CUDA division of two complex64 tensors runs
__device__ __forceinline__ float2 cdiv(float2 n, float2 d) {
  const float a = n.x, b = n.y, c = d.x, e = d.y;
  const float abs_c = fabsf(c), abs_e = fabsf(e);
  if (abs_c >= abs_e) {
    if (abs_c == 0.0f && abs_e == 0.0f) return make_float2(a / abs_c, b / abs_e);
    const float rat = e / c;
    const float scl = 1.0f / (c + e * rat);
    return make_float2((a + b * rat) * scl, (b - a * rat) * scl);
  }
  const float rat = c / e;
  const float scl = 1.0f / (e + c * rat);
  return make_float2((a * rat + b) * scl, (b * rat - a) * scl);
}

}  // namespace rx
}  // namespace ofdm
