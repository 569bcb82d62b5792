// Kernel E: the matched filter, a full linear convolution of planar complex
// streams with up to 2049 complex taps.
//
// Replaces (TPU): ofdm_sync_tpu/kernels/pallas_mf.py:_mf_kernel (#10,
// matched_filter_mxu).  For each complex stream s (planes 2p, 2p+1 of the
// (C, batch, L) input, batch entry b) it computes
//   y[m] = sum_{t < T} x[m - t] h[t],   m < Lout (Lout = L + T - 1 as a rule)
// with x = 0 outside [0, L), and writes the planar (C, batch, Lout) result.
//
// What bounds it on the H100: FP32 throughput.  In direct form every output costs
// 4T fused multiply-adds (8192 at T = 2048) and reads 8 bytes: it is far on
// the compute side of the roofline, so the design keeps the FMA pipes fed
// from registers and shared memory.
//
// Design.  The TPU kernel runs overlap-save blocks of 16384 samples through
// matmul DFTs on the MXU.  Here the same blocking is kept in the time domain:
// one CTA per (tile of 2048 outputs, stream) reads its 2048 input samples
// plus the T - 1 before them (zero before the stream start) and all taps into
// shared memory, and computes the tile in direct form, with no transform,
// no TF32 and no library call.  Each thread owns 8 consecutive outputs in 16
// float32 accumulators and walks the taps in groups of 8 over a 15-sample
// register window of the input, so one group costs 8 new complex loads from
// shared memory, 8 broadcast tap loads and 256 FMAs.  The input is stored
// as separate I and Q arrays with one padding word after every 8, which
// puts the threads' windows 9 words apart: conflict-free banks.  The sum
// over the taps is sequential in float32; against a complex128 reference its
// error stays far below 1e-5 of the output peak (checked on the card by
// chip_smoke.py).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                   // consecutive outputs per thread
constexpr int kTile = kThreads * kPer;    // outputs per CTA
constexpr int kMaxTaps = 2049;

// shared index of input element e: one padding word after every 8
__device__ __forceinline__ int pad8(int e) { return e + (e >> 3); }

int taps_rounded(int T) { return (T + kPer - 1) / kPer * kPer; }

int smem_floats(int T8) {
  const int nx = kTile + T8 - 1;
  return 2 * (nx + (nx >> 3) + 1) + 2 * T8;
}

__global__ void __launch_bounds__(kThreads) fir_kernel(
    const float* __restrict__ x, const float* __restrict__ taps, int batch, long long L,
    int T, int T8, long long Lout, float* __restrict__ out) {
  extern __shared__ float sm[];
  const int nx = kTile + T8 - 1;       // input samples of the tile
  const int nxp = nx + (nx >> 3) + 1;  // their padded length
  float* xr = sm;
  float* xi = sm + nxp;
  float* hr = sm + 2 * nxp;
  float* hi = hr + T8;

  const int s = blockIdx.y;
  const int pair = s / batch, b = s % batch;
  const size_t plane = (size_t)batch * (size_t)L;
  const float* xre = x + (size_t)(2 * pair) * plane + (size_t)b * (size_t)L;
  const float* xim = xre + plane;
  const long long m0 = (long long)blockIdx.x * kTile;
  const long long g0 = m0 - (T8 - 1);  // stream index of tile sample 0

  for (int e = threadIdx.x; e < nx; e += kThreads) {
    const long long g = g0 + e;
    const bool in = g >= 0 && g < L;
    xr[pad8(e)] = in ? xre[g] : 0.0f;
    xi[pad8(e)] = in ? xim[g] : 0.0f;
  }
  for (int t = threadIdx.x; t < T8; t += kThreads) {  // zero taps past T
    hr[t] = t < T ? taps[t] : 0.0f;
    hi[t] = t < T ? taps[T + t] : 0.0f;
  }
  __syncthreads();

  // y[m0 + 8 tid + i] reads tile sample 8 tid + i - t + T8 - 1 at tap t.  Tap
  // group g (taps 8g .. 8g + 7) reads the window w[0..14] = tile samples
  // base + 0 .. base + 14, base = 8 tid + T8 - 8 - 8g, at w[i - s + 7] for
  // tap 8g + s; the next group's w[8..14] is this group's w[0..6].
  float ar[kPer], ai[kPer], wr[2 * kPer - 1], wi[2 * kPer - 1];
#pragma unroll
  for (int i = 0; i < kPer; ++i) ar[i] = ai[i] = 0.0f;
  const int base0 = threadIdx.x * kPer + T8 - kPer;
#pragma unroll
  for (int j = kPer; j < 2 * kPer - 1; ++j) {
    wr[j] = xr[pad8(base0 + j)];
    wi[j] = xi[pad8(base0 + j)];
  }
  for (int g = 0; g < T8 / kPer; ++g) {
    const int base = base0 - kPer * g;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      wr[j] = xr[pad8(base + j)];
      wi[j] = xi[pad8(base + j)];
    }
#pragma unroll
    for (int s8 = 0; s8 < kPer; ++s8) {
      const float h_r = hr[kPer * g + s8], h_i = hi[kPer * g + s8];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float a = wr[i - s8 + kPer - 1], c = wi[i - s8 + kPer - 1];
        ar[i] = fmaf(a, h_r, ar[i]);
        ar[i] = fmaf(-c, h_i, ar[i]);
        ai[i] = fmaf(a, h_i, ai[i]);
        ai[i] = fmaf(c, h_r, ai[i]);
      }
    }
#pragma unroll
    for (int j = kPer; j < 2 * kPer - 1; ++j) {
      wr[j] = wr[j - kPer];
      wi[j] = wi[j - kPer];
    }
  }

  const size_t oplane = (size_t)batch * (size_t)Lout;
  float* ore = out + (size_t)(2 * pair) * oplane + (size_t)b * (size_t)Lout;
  float* oim = ore + oplane;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const long long m = m0 + (long long)threadIdx.x * kPer + i;
    if (m < Lout) {
      ore[m] = ar[i];
      oim[m] = ai[i];
    }
  }
}

}  // namespace

// x (C, batch, L) float32 planar pairs, taps (2, T) float32 [re; im] ->
// out (C, batch, Lout) float32; C even, 1 <= T <= 2049, (C/2) * batch <= 65535
extern "C" int matched_filter_f32(const void* x, const void* taps, int C, int batch,
                                  long long L, int T, long long Lout, void* out,
                                  void* stream) {
  if (C % 2 || T < 1 || T > kMaxTaps || batch < 1) return (int)cudaErrorInvalidValue;
  const int T8 = taps_rounded(T);
  const size_t smem = (size_t)smem_floats(T8) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fir_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Lout + kTile - 1) / kTile), (unsigned)(C / 2 * batch));
  fir_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)taps, batch, L, T, T8, Lout, (float*)out);
  return (int)cudaGetLastError();
}
