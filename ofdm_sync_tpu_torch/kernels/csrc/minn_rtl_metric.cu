// Kernel A of the fused Minn-RTL detector: the per-sample metric.
//
// Replaces (TPU): ofdm_sync_tpu/kernels/pallas_minn_tm.py:_tm_kernel (its
// metric half), pallas_minn.py:_detect_kernel / _metric_block (#2, with its
// base_index / shard_init / emit_state modes), pallas_minn.py:_minn_kernel
// (#3, the full metric) and pallas_minn.py:_corr_energy_kernel (#4).  The
// gate/event half is kernel B (gate_events.cu).
//
// Computes, for each stream b and sample n of the channel-leading input
// x[c, b, n] (C = 2 * branches planar rows, float32 or int16 ADC codes):
//   u[n] = sum_c x[c,n] * x[c,n-Q]           quarter product, all branches
//   p[n] = sum_c x[c,n]^2                    power
//   corr_positive[n] = max(sum_{2Q window} u, 0)
//   energy[n]        = sum_{3Q window} p
//   smooth[n] = (1-alpha) smooth[n-1] + alpha corr_positive[n] [base+n >= 3Q-1]
//   above[n]  = base+n >= 3Q-1  &&  smooth * 2^frac >= energy * T
// Samples before n = 0 read the right-aligned history hist[c, b, Hh + n]
// (n >= -Hh; zero before it or without a history), and smooth[-1] is
// carry_in[b] (zero without one).  base is the global index of sample 0.
// Modes, by which outputs are given (a null pointer is not written):
//   corr/above (#1, #2):  corr, above
//   full metric (#3):     corr, smooth, energy, above
//   corr/energy (#4):     corr, energy; no IIR (scan = 0), halo 3Q
// and carry_out[b] = smooth[L-1] where given (emit_state).
//
// Two CTAs of 512 threads share an SM (__launch_bounds__(512, 2): at most
// 64 registers a thread; with more, an H100 SM held one CTA and every mode
// ran slower).
//
// What bounds it on the H100: HBM bytes.  It reads 16 B/sample (f32, two
// branches) or 8 B/sample (int16) plus the halo re-read, and writes
// 5 B/sample (corr/above), 13 (full) or 8 (corr/energy).
//
// Design.  The TPU kernel walks time blocks in order and carries the IQ
// history and the smoothing state between grid steps; CUDA blocks run in
// no order.  So each CTA owns one time chunk of one stream and primes
// itself from a left halo of 3Q + 255 + 1 samples
// (parallel/shard.py:_minn_halo_width without its gate tail): 3Q of
// delay-line reach plus the smoothing memory after which older terms are
// below 2^-45 of the result, the same truncation the TPU kernel's scan
// makes.  The window sums come from chunk-local float64 prefix sums in
// shared memory (a stream-global float32 prefix drifts); the smoothing IIR
// is a block-level affine scan over one contiguous segment per thread: a
// first pass keeps each sample's step in shared memory, a second turns it
// into the smooth value there, and a last pass writes every output with
// consecutive threads on consecutive samples (strided writes from the
// segments slowed the full metric on the H100).  The scan's state entering
// sample 0 is carry_in:
// the map at n = -1 is the constant carry_in and the maps before it are
// identities, so the CTAs whose halo reaches before sample 0 start from the
// carried register and the others from zero at the head of their halo, as
// before.  int16 input is converted to float32 before any product.  Samples
// past the stream end are zero and are never written.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 512;

struct Args {
  const void* x;          // (C, batch, L) float32 or int16
  const float* hist;      // (C, batch, hist_len) right-aligned, or null
  const float* carry_in;  // (batch,) smoothing register before sample 0, or null
  int C, batch, Q, halo, chunk, hist_len, scan;
  long long L, base, valid_from;
  float alpha, frac_scale, thr;
  float* corr;            // (batch, L) outputs; null: not written
  float* smooth;
  float* energy;
  uint8_t* above;
  float* carry_out;       // (batch,) smooth[L-1], or null
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) minn_rtl_metric_kernel(Args a) {
  extern __shared__ double smem[];
  __shared__ double2 sbuf2[32];
  __shared__ float2 sbufa[32];

  const int W = a.halo + a.chunk;  // window: [w0, w0 + W)
  double* pu = smem;               // prefix sums of u, then of p
  double* pp = smem + W;
  // scan modes: per scanned sample the step's b value, then the smooth value
  float* ss = (float*)(smem + 2 * W);
  const int b = blockIdx.y;
  const long long c0 = (long long)blockIdx.x * a.chunk;
  const long long w0 = c0 - a.halo;
  const size_t plane = (size_t)a.batch * (size_t)a.L;
  const T* xs = (const T*)a.x + (size_t)b * (size_t)a.L;
  const float* hs = a.hist ? a.hist + (size_t)b * (size_t)a.hist_len : nullptr;
  const size_t hplane = (size_t)a.batch * (size_t)a.hist_len;

  // sample n of row c: the stream, the history before it, zero elsewhere
  auto ld = [&](int c, long long n) -> float {
    if (n >= 0) return n < a.L ? (float)xs[(size_t)c * plane + (size_t)n] : 0.0f;
    if (hs && n >= -(long long)a.hist_len)
      return hs[(size_t)c * hplane + (size_t)(a.hist_len + n)];
    return 0.0f;
  };

  // 1. quarter products and powers, summed over the planes in f32; the
  // CTAs whose window and its Q-delayed reads lie inside the stream (all
  // but the first and the last) load without bounds checks
  if (w0 - a.Q >= 0 && w0 + W <= a.L) {
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      const long long n = w0 + j;
      float u = 0.0f, p = 0.0f;
      for (int c = 0; c < a.C; ++c) {
        const T* row = xs + (size_t)c * plane;
        const float v = (float)row[n];
        const float vd = (float)row[n - a.Q];
        u = __fadd_rn(u, __fmul_rn(v, vd));
        p = __fadd_rn(p, __fmul_rn(v, v));
      }
      pu[j] = (double)u;
      pp[j] = (double)p;
    }
  } else {
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
      const long long n = w0 + j;
      float u = 0.0f, p = 0.0f;
      if (n < a.L) {
        for (int c = 0; c < a.C; ++c) {
          const float v = ld(c, n);
          const float vd = ld(c, n - a.Q);
          u = __fadd_rn(u, __fmul_rn(v, vd));
          p = __fadd_rn(p, __fmul_rn(v, v));
        }
      }
      pu[j] = (double)u;
      pp[j] = (double)p;
    }
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
  // halo leaves >= 256 samples of smoothing memory before the chunk.
  const int Q2 = 2 * a.Q, Q3 = 3 * a.Q;
  const size_t out_row = (size_t)b * (size_t)a.L;
  auto metric = [&](int j, float& cp, float& e) {
    cp = fmaxf((float)(pu[j] - pu[j - Q2]), 0.0f);
    e = (float)(pp[j] - (j >= Q3 ? pp[j - Q3] : 0.0));
  };

  if (!a.scan) {  // corr/energy: no IIR, every output stands alone
    for (int j = a.halo + threadIdx.x; j < W; j += blockDim.x) {
      const long long n = w0 + j;
      if (n >= a.L) break;
      float cp, e;
      metric(j, cp, e);
      if (a.corr) a.corr[out_row + n] = cp;
      if (a.energy) a.energy[out_row + n] = e;
    }
    return;
  }

  const int js = Q3 - 1;
  const int S = W - js;
  const int seg = (S + blockDim.x - 1) / blockDim.x;
  const int k0 = js + min(S, (int)threadIdx.x * seg);
  const int k1 = js + min(S, (int)threadIdx.x * seg + seg);
  const float decay = 1.0f - a.alpha;
  const float carry0 = a.carry_in ? a.carry_in[b] : 0.0f;

  // the affine map of sample n: identity before -1, the carried register
  // at -1, the smoothing step from 0 on
  auto step = [&](long long n, float cp) -> float2 {
    if (n < -1) return make_float2(1.0f, 0.0f);
    if (n == -1) return make_float2(0.0f, carry0);
    return make_float2(decay, (a.base + n >= a.valid_from) ? a.alpha * cp : 0.0f);
  };

  float2 seg_map = make_float2(1.0f, 0.0f);
  for (int j = k0; j < k1; ++j) {
    float cp, e;
    metric(j, cp, e);
    const float2 m = step(w0 + j, cp);
    ss[j - js] = m.y;
    seg_map = ofdm::compose(seg_map, m);
  }
  // state entering this segment: the scan starts from 0, so it is the
  // B part of the composed map of all earlier segments
  float s = ofdm::block_excl_affine(seg_map, sbufa).y;
  for (int j = k0; j < k1; ++j) {
    const long long n = w0 + j;
    s = fmaf(n < -1 ? 1.0f : n == -1 ? 0.0f : decay, s, ss[j - js]);
    ss[j - js] = s;
  }
  __syncthreads();

  // 4. outputs, consecutive threads on consecutive samples
  for (int i = threadIdx.x; i < a.chunk; i += blockDim.x) {
    const long long n = c0 + i;
    if (n >= a.L) break;
    float cp, e;
    metric(a.halo + i, cp, e);
    const float sm = ss[a.halo + i - js];
    if (a.corr) a.corr[out_row + n] = cp;
    if (a.smooth) a.smooth[out_row + n] = sm;
    if (a.energy) a.energy[out_row + n] = e;
    if (a.above)
      a.above[out_row + n] =
          (a.base + n >= a.valid_from) && (sm * a.frac_scale >= e * a.thr) ? 1 : 0;
    if (a.carry_out && n == a.L - 1) a.carry_out[b] = sm;
  }
}

template <typename T>
int launch(const Args& a, void* stream) {
  const size_t smem = 2 * (size_t)(a.halo + a.chunk) * sizeof(double) +
                      (a.scan ? (size_t)(a.halo + a.chunk - 3 * a.Q + 1) * sizeof(float) : 0);
  cudaError_t err = cudaFuncSetAttribute(
      minn_rtl_metric_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((a.L + a.chunk - 1) / a.chunk), (unsigned)a.batch);
  minn_rtl_metric_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_any(int is_i16, const void* x, const void* hist, const void* carry_in,
               int C, int batch, long long L, int Q, int halo, int chunk,
               int hist_len, int scan, long long base, float alpha,
               long long valid_from, float frac_scale, float thr, void* corr,
               void* smooth, void* energy, void* above, void* carry_out,
               void* stream) {
  Args a{};
  a.x = x;
  a.hist = (const float*)hist;
  a.carry_in = (const float*)carry_in;
  a.C = C;
  a.batch = batch;
  a.Q = Q;
  a.halo = halo;
  a.chunk = chunk;
  a.hist_len = hist ? hist_len : 0;
  a.scan = scan;
  a.L = L;
  a.base = base;
  a.valid_from = valid_from;
  a.alpha = alpha;
  a.frac_scale = frac_scale;
  a.thr = thr;
  a.corr = (float*)corr;
  a.smooth = (float*)smooth;
  a.energy = (float*)energy;
  a.above = (uint8_t*)above;
  a.carry_out = (float*)carry_out;
  return is_i16 ? launch<int16_t>(a, stream) : launch<float>(a, stream);
}

}  // namespace

// x (C, batch, L) float32 (is_i16 = 0) or int16; hist (C, batch, hist_len)
// float32 or null; carry_in (batch,) float32 or null; outputs (batch, L)
// and carry_out (batch,), each null when not wanted.  scan = 0 runs the
// corr/energy mode (no IIR; smooth, above and carry_out must be null).
extern "C" int minn_rtl_metric(int is_i16, const void* x, const void* hist,
                               const void* carry_in, int C, int batch,
                               long long L, int Q, int halo, int chunk,
                               int hist_len, int scan, long long base,
                               float alpha, long long valid_from,
                               float frac_scale, float thr, void* corr,
                               void* smooth, void* energy, void* above,
                               void* carry_out, void* stream) {
  if (!scan && (smooth || above || carry_out)) return (int)cudaErrorInvalidValue;
  return launch_any(is_i16, x, hist, carry_in, C, batch, L, Q, halo, chunk,
                    hist_len, scan, base, alpha, valid_from, frac_scale, thr,
                    corr, smooth, energy, above, carry_out, stream);
}

extern "C" const char* ofdm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
