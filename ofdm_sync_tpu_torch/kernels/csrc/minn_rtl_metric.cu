// Kernel A of the fused Minn-RTL detector: the per-sample metric.
//
// Replaces (TPU): ofdm_sync_tpu/kernels/pallas_minn_tm.py:_tm_kernel (its
// metric half) and its lane-major twin pallas_minn.py:_detect_kernel /
// _metric_block.  The gate/event half is kernel B (gate_events.cu).
//
// Computes, for each stream b and sample n of the channel-leading input
// x[c, b, n] (C = 2 * branches planar rows, float32 or int16 ADC codes):
//   u[n] = sum_c x[c,n] * x[c,n-Q]           quarter product, all branches
//   p[n] = sum_c x[c,n]^2                    power
//   corr_positive[n] = max(sum_{2Q window} u, 0)
//   energy[n]        = sum_{3Q window} p
//   smooth[n] = (1-alpha) smooth[n-1] + alpha corr_positive[n]  (n >= 3Q-1)
//   above[n]  = n >= 3Q-1  &&  smooth * 2^frac >= energy * T
// and writes corr_positive (f32) and above (u8).
//
// What bounds it on the H100: HBM bytes.  It reads 16 B/sample (f32, two
// branches) or 8 B/sample (int16) plus the halo re-read, and writes
// 5 B/sample.
//
// Design.  The TPU kernel walks time blocks in order and carries the IQ
// history and the smoothing state between grid steps; CUDA blocks run in
// no order.  So each CTA owns one time chunk of one stream and primes
// itself from a left halo of 3Q + 255 + 1 + h samples
// (parallel/shard.py:_minn_halo_width): 3Q of delay-line reach plus the
// smoothing memory after which older terms are below 2^-45 of the result,
// the same truncation the TPU kernel's scan makes.  The window sums come
// from chunk-local float64 prefix sums in shared memory (a stream-global
// float32 prefix drifts); the smoothing IIR is a block-level affine scan
// started from zero at the head of the halo.  int16 input is converted to
// float32 before any product.  Samples past the stream end are zero and
// are never written.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 512;

template <typename T>
__global__ void __launch_bounds__(kThreads) minn_rtl_metric_kernel(
    const T* __restrict__ x, int C, int batch, long long L, int Q, int halo,
    int chunk, float alpha, int valid_from, float frac_scale, float thr,
    float* __restrict__ corr_out, uint8_t* __restrict__ above_out) {
  extern __shared__ double smem[];
  __shared__ double2 sbuf2[32];
  __shared__ float2 sbufa[32];

  const int W = halo + chunk;  // window: [w0, w0 + W)
  double* pu = smem;           // prefix sums of u, then of p
  double* pp = smem + W;
  const int b = blockIdx.y;
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long w0 = c0 - halo;
  const size_t plane = (size_t)batch * (size_t)L;
  const T* xs = x + (size_t)b * (size_t)L;

  // 1. quarter products and powers, summed over the planes in f32
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const long long n = w0 + j;
    float u = 0.0f, p = 0.0f;
    if (n >= 0 && n < L) {
      for (int c = 0; c < C; ++c) {
        const T* row = xs + (size_t)c * plane;
        const float v = (float)row[n];
        const float vd = n >= Q ? (float)row[n - Q] : 0.0f;
        u = __fadd_rn(u, __fmul_rn(v, vd));
        p = __fadd_rn(p, __fmul_rn(v, v));
      }
    }
    pu[j] = (double)u;
    pp[j] = (double)p;
  }
  __syncthreads();

  // 2. inclusive prefix sums in f64, one contiguous segment per thread
  {
    const int seg = (W + blockDim.x - 1) / blockDim.x;
    const int j0 = min(W, (int)threadIdx.x * seg);
    const int j1 = min(W, j0 + seg);
    double2 tot = make_double2(0.0, 0.0);
    for (int j = j0; j < j1; ++j) {
      tot.x += pu[j];
      tot.y += pp[j];
    }
    double2 run = ofdm::block_excl_sum2(tot, sbuf2);
    for (int j = j0; j < j1; ++j) {
      run.x += pu[j];
      run.y += pp[j];
      pu[j] = run.x;
      pp[j] = run.y;
    }
  }
  __syncthreads();

  // 3. window sums, smoothing scan over [js, W), threshold.  js = 3Q-1 is
  // the first window index whose 3Q energy window lies in the window; the
  // halo leaves >= 256 + h samples of smoothing memory before the chunk.
  const int js = 3 * Q - 1;
  const int S = W - js;
  const int seg = (S + blockDim.x - 1) / blockDim.x;
  const int k0 = js + min(S, (int)threadIdx.x * seg);
  const int k1 = js + min(S, (int)threadIdx.x * seg + seg);
  const float decay = 1.0f - alpha;
  const int Q2 = 2 * Q, Q3 = 3 * Q;

  auto metric = [&](int j, float& cp, float& e) {
    cp = fmaxf((float)(pu[j] - pu[j - Q2]), 0.0f);
    e = (float)(pp[j] - (j >= Q3 ? pp[j - Q3] : 0.0));
  };

  float2 seg_map = make_float2(1.0f, 0.0f);
  for (int j = k0; j < k1; ++j) {
    float cp, e;
    metric(j, cp, e);
    const float bv = (w0 + j >= valid_from) ? alpha * cp : 0.0f;
    seg_map = ofdm::compose(seg_map, make_float2(decay, bv));
  }
  // state entering this segment: the scan starts from 0, so it is the
  // B part of the composed map of all earlier segments
  float s = ofdm::block_excl_affine(seg_map, sbufa).y;
  const size_t out_row = (size_t)b * (size_t)L;
  for (int j = k0; j < k1; ++j) {
    float cp, e;
    metric(j, cp, e);
    const long long n = w0 + j;
    const float bv = (n >= valid_from) ? alpha * cp : 0.0f;
    s = fmaf(decay, s, bv);
    if (j >= halo && n < L) {
      corr_out[out_row + n] = cp;
      above_out[out_row + n] =
          (n >= valid_from) && (s * frac_scale >= e * thr) ? 1 : 0;
    }
  }
}

template <typename T>
int launch(const void* x, int C, int batch, long long L, int Q, int halo,
           int chunk, float alpha, int valid_from, float frac_scale, float thr,
           void* corr, void* above, void* stream) {
  const size_t smem = 2 * (size_t)(halo + chunk) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      minn_rtl_metric_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((L + chunk - 1) / chunk), (unsigned)batch);
  minn_rtl_metric_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, C, batch, L, Q, halo, chunk, alpha, valid_from, frac_scale,
      thr, (float*)corr, (uint8_t*)above);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int minn_rtl_metric_f32(const void* x, int C, int batch,
                                   long long L, int Q, int halo, int chunk,
                                   float alpha, int valid_from,
                                   float frac_scale, float thr, void* corr,
                                   void* above, void* stream) {
  return launch<float>(x, C, batch, L, Q, halo, chunk, alpha, valid_from,
                       frac_scale, thr, corr, above, stream);
}

extern "C" int minn_rtl_metric_i16(const void* x, int C, int batch,
                                   long long L, int Q, int halo, int chunk,
                                   float alpha, int valid_from,
                                   float frac_scale, float thr, void* corr,
                                   void* above, void* stream) {
  return launch<int16_t>(x, C, batch, L, Q, halo, chunk, alpha, valid_from,
                         frac_scale, thr, corr, above, stream);
}

extern "C" const char* ofdm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
