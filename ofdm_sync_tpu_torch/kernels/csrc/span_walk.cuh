// The span walk of kernels C (aa_metric.cu) and D (zc_cfar.cu).
//
// A CTA of 256 threads walks a span of consecutive 1024-sample tiles of one
// stream in order; each thread holds 4 consecutive samples of a tile.  Rows
// load 4 samples at a time: one 16-byte (int16: 8-byte) load where the row
// is aligned, four scalar loads where it is not (a row of odd length).
// Shared-memory rings keep the delayed samples and window tails, indexed
// modulo their length: a tile writes its own 4-aligned samples (aligned
// 16-byte stores) and reads the delayed ones (16-byte loads where the delay
// keeps them aligned).  Window sums are float64 running values carried from
// tile to tile; the tile's increments are scanned with warp shuffles and one
// exchange of warp totals through shared memory.  Kernel A
// (minn_rtl_metric.cu) keeps its own copy of these pieces.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "block_scan.cuh"

namespace ofdm {
namespace walk {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // consecutive samples per thread
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
constexpr int kMinSpanTiles = 4;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

template <typename T>
struct Raw4;  // 4 consecutive samples as loaded
template <>
struct Raw4<float> {
  using type = float4;
  static __device__ __forceinline__ float4 load(const float* p) {
    if (((uintptr_t)p & 15) == 0) return __ldg(reinterpret_cast<const float4*>(p));
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
  }
  static __device__ __forceinline__ float4 f(float4 v) { return v; }
};
template <>
struct Raw4<int16_t> {
  using type = uint2;  // two registers, unpacked when converted
  static __device__ __forceinline__ uint2 load(const int16_t* p) {
    if (((uintptr_t)p & 7) == 0) return __ldg(reinterpret_cast<const uint2*>(p));
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    return make_uint2((unsigned)__ldg(q) | ((unsigned)__ldg(q + 1) << 16),
                      (unsigned)__ldg(q + 2) | ((unsigned)__ldg(q + 3) << 16));
  }
  static __device__ __forceinline__ float4 f(uint2 v) {
    return make_float4((float)(int16_t)(v.x & 0xffffu), (float)((int)v.x >> 16),
                       (float)(int16_t)(v.y & 0xffffu), (float)((int)v.y >> 16));
  }
};

__device__ __forceinline__ float get(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// the first cnt of 4 consecutive outputs; one 16-byte (4-byte) store where
// all four go to an aligned address
__device__ __forceinline__ void store4(float* p, float4 v, int cnt) {
  if (cnt >= kItems && ((uintptr_t)p & 15) == 0) {
    *reinterpret_cast<float4*>(p) = v;
    return;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (k < cnt) p[k] = get(v, k);
}

__device__ __forceinline__ void store4(uint8_t* p, uint32_t v, int cnt) {
  if (cnt >= kItems && ((uintptr_t)p & 3) == 0) {
    *reinterpret_cast<uint32_t*>(p) = v;
    return;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (k < cnt) p[k] = (uint8_t)(v >> (8 * k));
}

// Asynchronous global -> shared copies (cp.async, no registers held while
// they fly) of 4 consecutive samples: 16 bytes (float32) or 8 (int16), the
// global address aligned to that size.  A thread waits for its own copies
// only (cp_async_wait), so a thread that reads back what it copied needs no
// barrier.
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 4 ring entries from index i (wrapping at len); aligned: one 16-byte access
__device__ __forceinline__ float4 ring_ld(const float* r, int i, int len, bool aligned) {
  if (aligned) return *reinterpret_cast<const float4*>(r + i);
  float v[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) v[k] = r[i + k < len ? i + k : i + k - len];
  return make_float4(v[0], v[1], v[2], v[3]);
}

// a tile's own 4 entries: i is 4-aligned and len a multiple of 4
__device__ __forceinline__ void ring_st(float* r, int i, float4 v) {
  *reinterpret_cast<float4*>(r + i) = v;
}

__device__ __forceinline__ void ring_ld(const double* r, int i, int len, bool aligned,
                                        double (&v)[kItems]) {
  if (aligned) {
    const double2 lo = *reinterpret_cast<const double2*>(r + i);
    const double2 hi = *reinterpret_cast<const double2*>(r + i + 2);
    v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
    return;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) v[k] = r[i + k < len ? i + k : i + k - len];
}

__device__ __forceinline__ void ring_st(double* r, int i, const double (&v)[kItems]) {
  *reinterpret_cast<double2*>(r + i) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(r + i + 2) = make_double2(v[2], v[3]);
}

__device__ __forceinline__ int ring_next(int i, int len) {
  i += kTile;
  return i >= len ? i - len : i;
}

// inclusive scan of N sums over the warp, in place; exc gets the exclusive
// prefix (the inclusive one shuffled one lane up, zero at lane 0)
template <int N>
__device__ __forceinline__ void warp_scan(double (&v)[N], double (&exc)[N], int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const double o = __shfl_up_sync(kFull, v[k], d);
      if (lane >= d) v[k] = o + v[k];
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    exc[k] = __shfl_up_sync(kFull, v[k], 1);
    if (lane == 0) exc[k] = 0.0;
  }
}

// Tiles per span: the span length that takes the least time when
// batch x spans CTAs run in waves of `slots`, each span paying `halo`
// samples before it, at least kMinSpanTiles tiles per span (up to the whole
// stream).  At 512 streams and four CTAs per SM a span is a whole stream.
inline int span_tiles(int batch, int tiles, int halo, int slots) {
  batch = std::max(batch, 1);
  slots = std::max(slots, 1);
  const int most = std::max(1, std::min(tiles / kMinSpanTiles, 4 * slots / batch + 1));
  int best_t = tiles;
  double best = -1.0;
  for (int s = 1; s <= most; ++s) {
    const int st = (tiles + s - 1) / s;
    const long long ctas = (long long)batch * ((tiles + st - 1) / st);
    const double cost = (double)((ctas + slots - 1) / slots) * ((double)st * kTile + halo);
    if (best < 0.0 || cost < best) {
      best = cost;
      best_t = st;
    }
  }
  return best_t;
}

// CTA slots of a kernel on the current device at `smem` bytes of dynamic
// shared memory
template <typename K>
int cta_slots(K kernel, int smem) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, smem);
  return std::max(sms * per, 1);
}

// allow a kernel the largest dynamic shared memory (once per process and
// kernel: the caller keeps the flag)
template <typename K>
cudaError_t allow_smem(K kernel) {
  int dev = 0, optin = 0;
  cudaFuncAttributes fa{};
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)fa.sharedSizeBytes);
  return err;
}

// dynamic shared memory a CTA may take beside a kernel's small static part
inline int smem_optin() {
  static int optin = -1;
  if (optin < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return optin - 1024;
}

}  // namespace walk
}  // namespace ofdm
