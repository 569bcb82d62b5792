// Kernel C of the fused [A][A] detector: the per-sample metric.
//
// Replaces (TPU): ofdm_sync_tpu/kernels/pallas_aa.py:_aa_metric_kernel
// (metric mode, aa_metric_planar_pallas) and the metric half of
// pallas_aa.py:_aa_kernel (detect mode, aa_detect_fused_pallas), both built
// on pallas_aa.py:_aa_metric_rows.  The gate/event half of _aa_kernel is
// kernel B (gate_events.cu) with peak capture.
//
// Computes, for each stream b and sample n of the channel-leading input
// x[c, b, n] (C = 2 * branches planar rows [b0_i, b0_q, b1_i, ...], float32
// or int16 ADC codes), with lag L and x[k] = 0 for k < 0 (the zero-filled
// RTL delay line):
//   pre[k] = sum_b i[k] i[k-L] + q[k] q[k-L]     (0 for k < L)
//   pim[k] = sum_b q[k] i[k-L] - i[k] q[k-L]
//   pw[k]  = sum_b i[k]^2 + q[k]^2
//   P_re[n], P_im[n], R[n] = sums of pre, pim, pw over k in [n-L+1, n]
// Metric mode writes (P_re, P_im, R).  Detect mode writes P_re, P_im and
//   track = P_re^2 + P_im^2
//   M     = n >= L && R > 1e-6 L ? min(track / max(R, 1e-12)^2, 1) : 0
//   above = n >= L && M >= threshold
// (pallas_aa.py:302-313).  Any output pointer may be null: not written.
// Primed mode (pallas_aa.py:_aa_kernel's base_index / shard_init): x[k] for
// k < 0 reads the right-aligned history hist[c, b, Hh + k] (zero before it
// or without one), and validity compares the global index: base + n >= L.
// The metric has no IIR, so the history alone primes a chunk.
//
// Two CTAs of 512 threads share an SM (__launch_bounds__(512, 2), at most
// 64 registers a thread; the history loads alone took it past 64, and an
// H100 SM down to one CTA and a slower kernel).
//
// What bounds it on the H100: HBM bytes.  It reads 16 B/sample (f32, two
// branches) or 8 B/sample (int16), plus the lag-L re-read (mostly from L2)
// and the halo, and writes 12 B/sample (metric) or 17 B/sample (detect).
//
// Design.  The TPU kernel walks time blocks in order with a 2L IQ history
// in VMEM; CUDA blocks run in no order.  The metric has no IIR, so one CTA
// per (time chunk, stream) is exactly independent given a left halo of
// 2L - 1 IQ samples: the chunk's first window reaches back L - 1 products,
// each reading x[k - L].  Per tile of blockDim products the block computes
// the three per-sample sums in float64 (the products of float32 values are
// exact there, so FMA contraction cannot change them), scans them, and
// stores chunk-local float64 prefix sums in shared memory; each window sum
// is one difference of two prefixes, rounded once to float32.  With
// integer-valued input every step is exact and kernel C equals the plain
// version (kernels/streaming.py:aa_metric_planar) bit for bit.  track and M
// use __fmul_rn / __fadd_rn / __fdiv_rn: one IEEE rounding per operation,
// as PyTorch rounds them, never a fused multiply-add.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 512;

struct Primed {
  const float* hist;  // (C, batch, hist_len) right-aligned, or null
  int hist_len;
  long long base;     // global index of sample 0
};

struct Outputs {
  float* pre;
  float* pim;
  float* r;
  float* track;
  float* m;
  uint8_t* above;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) aa_metric_kernel(
    const T* __restrict__ x, int C, int batch, long long L, int lag, int chunk,
    float noise_floor, float thr, Outputs out, Primed pr) {
  extern __shared__ double smem[];
  __shared__ double3 sbuf[32];

  // pref[0] = 0, pref[j] = sum of the products k0 .. k0 + j - 1
  const int W = lag + chunk;
  double* pre_p = smem;
  double* pim_p = smem + W;
  double* pw_p = smem + 2 * W;
  const int b = blockIdx.y;
  const long long c0 = (long long)blockIdx.x * chunk;
  const long long k0 = c0 - lag + 1;
  const size_t plane = (size_t)batch * (size_t)L;
  const T* xs = x + (size_t)b * (size_t)L;
  const float* hs = pr.hist ? pr.hist + (size_t)b * (size_t)pr.hist_len : nullptr;
  const size_t hplane = (size_t)batch * (size_t)pr.hist_len;

  // sample k of row c: the stream, the history before it, zero elsewhere
  auto ld = [&](int c, long long k) -> double {
    if (k >= 0) return k < L ? (double)xs[(size_t)c * plane + (size_t)k] : 0.0;
    if (hs && k >= -(long long)pr.hist_len)
      return (double)hs[(size_t)c * hplane + (size_t)(pr.hist_len + k)];
    return 0.0;
  };

  if (threadIdx.x == 0) pre_p[0] = pim_p[0] = pw_p[0] = 0.0;
  double3 carry = make_double3(0.0, 0.0, 0.0);
  const int nprod = W - 1;
  // the CTAs whose products and lag-L reads lie inside the stream (all but
  // the first and the last) load without bounds checks
  const bool interior = k0 - lag >= 0 && k0 + nprod <= L;
  for (int t0 = 0; t0 < nprod; t0 += blockDim.x) {
    const int e = t0 + threadIdx.x;
    const long long k = k0 + e;
    double3 u = make_double3(0.0, 0.0, 0.0);
    if (e < nprod && k < L) {
      for (int c = 0; c + 1 < C; c += 2) {
        double i, q, id, qd;
        if (interior) {
          const T* ri = xs + (size_t)c * plane;
          const T* rq = ri + plane;
          i = (double)ri[k];
          q = (double)rq[k];
          id = (double)ri[k - lag];
          qd = (double)rq[k - lag];
        } else {
          i = ld(c, k);
          q = ld(c + 1, k);
          id = ld(c, k - lag);
          qd = ld(c + 1, k - lag);
        }
        u.x += i * id + q * qd;
        u.y += q * id - i * qd;
        u.z += i * i + q * q;
      }
    }
    double3 tot;
    const double3 inc = ofdm::add3(carry, ofdm::block_incl_sum3(u, sbuf, &tot));
    if (e < nprod) {
      pre_p[e + 1] = inc.x;
      pim_p[e + 1] = inc.y;
      pw_p[e + 1] = inc.z;
    }
    carry = ofdm::add3(carry, tot);
  }
  __syncthreads();

  const size_t row = (size_t)b * (size_t)L;
  for (int i = threadIdx.x; i < chunk; i += blockDim.x) {
    const long long n = c0 + i;
    if (n >= L) break;
    const size_t o = row + (size_t)n;
    const float p_re = (float)(pre_p[i + lag] - pre_p[i]);
    const float p_im = (float)(pim_p[i + lag] - pim_p[i]);
    if (out.pre) out.pre[o] = p_re;
    if (out.pim) out.pim[o] = p_im;
    if (!(out.r || out.m)) continue;
    const float r = (float)(pw_p[i + lag] - pw_p[i]);
    if (out.r) out.r[o] = r;
    if (out.m) {
      const float track = __fadd_rn(__fmul_rn(p_re, p_re), __fmul_rn(p_im, p_im));
      const bool valid = pr.base + n >= lag;
      float m = 0.0f;
      if (valid && r > noise_floor) {
        const float rc = fmaxf(r, 1e-12f);
        m = fminf(__fdiv_rn(track, __fmul_rn(rc, rc)), 1.0f);
      }
      out.track[o] = track;
      out.m[o] = m;
      out.above[o] = valid && m >= thr ? 1 : 0;
    }
  }
}

template <typename T>
int launch(const void* x, int C, int batch, long long L, int lag, int chunk,
           float noise_floor, float thr, Outputs out, Primed pr, void* stream) {
  const size_t smem = 3 * (size_t)(lag + chunk) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      aa_metric_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((L + chunk - 1) / chunk), (unsigned)batch);
  aa_metric_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, C, batch, L, lag, chunk, noise_floor, thr, out, pr);
  return (int)cudaGetLastError();
}

}  // namespace

// x (C, batch, L) float32 (is_i16 = 0) or int16; hist (C, batch, hist_len)
// float32 or null, base the global index of sample 0 (primed mode); pre,
// pim, r, track, m, above: (batch, L) outputs, null pointers are skipped
// (metric mode: track = m = above = null; detect mode: r = null).
extern "C" int aa_metric(int is_i16, const void* x, const void* hist, int C, int batch,
                         long long L, int lag, int chunk, int hist_len, long long base,
                         float noise_floor, float thr, void* pre, void* pim, void* r,
                         void* track, void* m, void* above, void* stream) {
  const Outputs out{(float*)pre, (float*)pim, (float*)r, (float*)track, (float*)m,
                    (uint8_t*)above};
  const Primed pr{(const float*)hist, hist ? hist_len : 0, base};
  return is_i16 ? launch<int16_t>(x, C, batch, L, lag, chunk, noise_floor, thr, out, pr,
                                  stream)
                : launch<float>(x, C, batch, L, lag, chunk, noise_floor, thr, out, pr, stream);
}
