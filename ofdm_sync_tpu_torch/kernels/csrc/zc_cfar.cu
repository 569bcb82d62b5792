// Kernel D of the fused Zadoff-Chu CFAR detector: the CFAR gate input.
//
// Replaces (TPU): ofdm_sync_tpu/kernels/pallas_zc.py:_zc_kernel (#7,
// zc_cfar_detect_pallas) in magnitude mode, and pallas_zc.py:_zc_iq_kernel
// (#8, zc_iq_cfar_detect_pallas) and pallas_zc_tm.py:_zc_iq_tm_kernel (#9,
// zc_iq_cfar_detect_tm, float32 or int16 IQ) in IQ mode.  Their gate/event
// half is kernel B (gate_events.cu), launched with valid_from = W.
//
// Magnitude mode reads corr_mag (batch, L) and writes
//   above[n] = n >= W && mag[n] * 2^frac >= local[n] * T && mag[n] >= min
// with local[n] the sum of mag over the W-window ending at n (samples
// before 0 read as zero).  Primed magnitude mode (pallas_zc.py:_zc_kernel's
// base_index / shard_init): magnitudes before 0 read the right-aligned
// history hist[b, Hh + n] (zero before it), and validity compares the
// global index, base + n >= W.  IQ mode first forms mag (pallas_zc.py:203-224):
// for each branch b, from the planar matched-filter rows mf[2b], mf[2b+1]
// (2*BR, batch, Lc) and the planar IQ rows (2*BR, batch, L_iq),
//   E_b[n] = sum of i*i + q*q over k in [n-R+1, n], zero for k >= L_iq
//            (the 'full'-convolution alignment of sliding_energy_full)
//   inv_b  = 1 / (ref_norm * sqrt(max(E_b, 1e-12)))
//   re = sum_b mf[2b] * inv_b,  im = sum_b mf[2b+1] * inv_b  (branch order)
//   mag = sqrt(re*re + im*im)
// and writes mag (the track of the events) and above.
//
// What bounds it on the H100: HBM bytes.  IQ mode reads 16 B/sample of mf
// (two branches) plus 16 B (float32) or 8 B (int16) of IQ, and writes 5
// B/sample; magnitude mode reads 4 B and writes 1 B per sample.
//
// Design.  The TPU kernels walk time blocks in order with the energy and
// magnitude histories in VMEM; CUDA blocks run in no order.  Nothing here
// is recursive, so one CTA per (chunk of 16384 outputs, stream) is exactly
// independent given a left halo: W - 1 magnitudes for the local sums and,
// in IQ mode, R - 1 more IQ samples for the first of those energies (4094
// samples at R = W = 2048, 25% extra reads at this chunk length; a
// 4096-sample chunk would double them).  The CTA walks its range in tiles
// of blockDim samples.  Per tile it forms the branch powers in float64 (a
// product of two float32 values is exact there, so FMA contraction cannot
// change it), scans them into chunk-local float64 prefix sums kept in a
// shared-memory ring of the last R + blockDim values, and takes each window
// sum as one difference of two prefixes, rounded once to float32.  The
// magnitude then gets the same treatment over W for the local sums.  The
// normalization, branch sum and magnitude use __fmul_rn / __fadd_rn /
// __fsqrt_rn / __fdiv_rn: one IEEE rounding per operation, as PyTorch rounds
// them in the plain version (kernels/streaming.py:zc_iq_planar), never a
// fused multiply-add.  On integer-valued IQ every energy is exact, so mag
// equals the plain version bit for bit; the local sums are sums of
// non-integers taken from another starting point than the plain version's
// stream-wide prefix, so an above bit can differ where mag * 2^frac and
// local * T meet within a rounding.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxBranches = 4;

struct Params {
  const float* mag_in;  // magnitude mode: (batch, L)
  const float* hist;    // magnitude mode: (batch, hist_len) right-aligned, or null
  int hist_len;
  long long base;       // global index of sample 0
  const float* mf;      // IQ mode: (2*BR, batch, L) matched-filter planes
  const void* iq;       // IQ mode: (2*BR, batch, L_iq) float32 or int16
  long long L;          // outputs per stream: L (magnitude mode) or Lc
  long long L_iq;
  int batch;
  int chunk;
  int ref_len;          // R
  int window;           // W
  int ring_e;           // ring lengths, powers of two >= R (W) + blockDim
  int ring_m;
  float ref_norm, scale, thr, min_mag;
  float* mag_out;       // IQ mode: (batch, L)
  uint8_t* above;       // (batch, L)
};

// BR = 0: magnitude mode; BR >= 1: IQ mode with BR branches of IQ type T
template <int BR, typename T>
__global__ void __launch_bounds__(kThreads) zc_cfar_kernel(Params p) {
  constexpr int NE = BR > 0 ? BR : 1;
  extern __shared__ double smem[];
  __shared__ ofdm::DVec<NE> sbuf_e[32];
  __shared__ ofdm::DVec<1> sbuf_m[32];

  const int b = blockIdx.y;
  const long long c0 = (long long)blockIdx.x * p.chunk;
  const long long c_end = min(c0 + (long long)p.chunk, p.L);
  const long long m0 = c0 - (p.window - 1);                // first magnitude read
  const long long s0 = BR > 0 ? m0 - (p.ref_len - 1) : m0;  // first sample visited
  const long long mask_m = p.ring_m - 1, mask_e = p.ring_e - 1;
  double* ring_m = smem;          // magnitude prefix at sample j: ring_m[j & mask_m]
  double* ring_e = smem + p.ring_m;  // branch k's energy prefix: ring_e[k * ring_e + ...]
  const size_t row = (size_t)b * (size_t)p.L;
  const size_t plane_mf = (size_t)p.batch * (size_t)p.L;
  const size_t plane_iq = (size_t)p.batch * (size_t)p.L_iq;

  ofdm::DVec<NE> carry_e;
#pragma unroll
  for (int k = 0; k < NE; ++k) carry_e.v[k] = 0.0;
  double carry_m = 0.0;

  // every thread runs the same number of tiles: the scans hold barriers
  for (long long t0 = s0; t0 < c_end; t0 += blockDim.x) {
    const long long j = t0 + threadIdx.x;
    float mag = 0.0f;
    if constexpr (BR > 0) {
      const T* iq = (const T*)p.iq;
      ofdm::DVec<BR> pw;
#pragma unroll
      for (int k = 0; k < BR; ++k) {
        pw.v[k] = 0.0;
        if (j >= 0 && j < p.L_iq && j < c_end) {
          const T* ri = iq + (size_t)(2 * k) * plane_iq + (size_t)b * (size_t)p.L_iq;
          const double i = (double)ri[j], q = (double)ri[plane_iq + j];
          pw.v[k] = i * i + q * q;
        }
      }
      ofdm::DVec<BR> tot;
      ofdm::DVec<BR> inc = ofdm::block_incl_sum_n<BR>(pw, sbuf_e, &tot);
#pragma unroll
      for (int k = 0; k < BR; ++k) {
        inc.v[k] = carry_e.v[k] + inc.v[k];
        carry_e.v[k] = carry_e.v[k] + tot.v[k];
        ring_e[(size_t)k * p.ring_e + (size_t)(j & mask_e)] = inc.v[k];
      }
      __syncthreads();
      if (j >= m0 && j >= 0 && j < c_end) {
        float re = 0.0f, im = 0.0f;
#pragma unroll
        for (int k = 0; k < BR; ++k) {
          const long long jo = j - p.ref_len;
          const double old =
              jo >= s0 ? ring_e[(size_t)k * p.ring_e + (size_t)(jo & mask_e)] : 0.0;
          const float e = (float)(inc.v[k] - old);
          const float denom = __fmul_rn(p.ref_norm, __fsqrt_rn(fmaxf(e, 1e-12f)));
          const float inv = __fdiv_rn(1.0f, denom);
          const float* mr = p.mf + (size_t)(2 * k) * plane_mf + row + (size_t)j;
          const float tr = __fmul_rn(mr[0], inv), ti = __fmul_rn(mr[plane_mf], inv);
          re = k == 0 ? tr : __fadd_rn(re, tr);
          im = k == 0 ? ti : __fadd_rn(im, ti);
        }
        mag = __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
      }
    } else {
      if (j >= 0 && j < c_end) {
        mag = p.mag_in[row + (size_t)j];
      } else if (j < 0 && p.hist && j >= -(long long)p.hist_len) {
        mag = p.hist[(size_t)b * (size_t)p.hist_len + (size_t)(p.hist_len + j)];
      }
    }

    ofdm::DVec<1> mv, mtot;
    mv.v[0] = (double)mag;
    const double minc = carry_m + ofdm::block_incl_sum_n<1>(mv, sbuf_m, &mtot).v[0];
    carry_m = carry_m + mtot.v[0];
    ring_m[j & mask_m] = minc;
    __syncthreads();
    if (j >= c0 && j < c_end) {
      const long long jo = j - p.window;
      const double old = jo >= s0 ? ring_m[jo & mask_m] : 0.0;
      const float local = (float)(minc - old);
      const bool a = p.base + j >= p.window &&
                     __fmul_rn(mag, p.scale) >= __fmul_rn(local, p.thr) &&
                     mag >= p.min_mag;
      p.above[row + (size_t)j] = a ? 1 : 0;
      if constexpr (BR > 0) p.mag_out[row + (size_t)j] = mag;
    }
  }
}

int ring_len(int n) {
  int r = 1;
  while (r < n + kThreads) r <<= 1;
  return r;
}

template <int BR, typename T>
int launch(Params p, void* stream) {
  p.ring_m = ring_len(p.window);
  p.ring_e = BR > 0 ? ring_len(p.ref_len) : 0;
  const size_t smem = ((size_t)p.ring_m + (size_t)BR * (size_t)p.ring_e) * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      zc_cfar_kernel<BR, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((p.L + p.chunk - 1) / p.chunk), (unsigned)p.batch);
  zc_cfar_kernel<BR, T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_iq(int branches, const Params& p, void* stream) {
  switch (branches) {
    case 1: return launch<1, T>(p, stream);
    case 2: return launch<2, T>(p, stream);
    case 3: return launch<3, T>(p, stream);
    case 4: return launch<4, T>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

Params iq_params(const void* mf, const void* iq, int batch, long long Lc, long long L_iq,
                 int chunk, int R, int W, float ref_norm, float scale, float thr,
                 float min_mag, void* mag, void* above) {
  Params p{};
  p.mf = (const float*)mf;
  p.iq = iq;
  p.L = Lc;
  p.L_iq = L_iq;
  p.batch = batch;
  p.chunk = chunk;
  p.ref_len = R;
  p.window = W;
  p.ref_norm = ref_norm;
  p.scale = scale;
  p.thr = thr;
  p.min_mag = min_mag;
  p.mag_out = (float*)mag;
  p.above = (uint8_t*)above;
  return p;
}

}  // namespace

// corr_mag (batch, L) float32 -> above (batch, L) uint8; hist (batch,
// hist_len) float32 or null and base: the primed mode
extern "C" int zc_cfar_mag_f32(const void* mag, const void* hist, int batch, long long L,
                               int chunk, int W, int hist_len, long long base, float scale,
                               float thr, float min_mag, void* above, void* stream) {
  Params p{};
  p.mag_in = (const float*)mag;
  p.hist = (const float*)hist;
  p.hist_len = hist ? hist_len : 0;
  p.base = base;
  p.L = L;
  p.batch = batch;
  p.chunk = chunk;
  p.window = W;
  p.scale = scale;
  p.thr = thr;
  p.min_mag = min_mag;
  p.above = (uint8_t*)above;
  return launch<0, float>(p, stream);
}

// mf (C, batch, Lc) float32, iq (C, batch, L_iq) -> mag (batch, Lc) float32,
// above (batch, Lc) uint8; C = 2 * branches, 1 <= branches <= 4
extern "C" int zc_cfar_iq_f32(const void* mf, const void* iq, int C, int batch, long long Lc,
                              long long L_iq, int chunk, int R, int W, float ref_norm,
                              float scale, float thr, float min_mag, void* mag, void* above,
                              void* stream) {
  if (C % 2 || C / 2 > kMaxBranches) return (int)cudaErrorInvalidValue;
  return launch_iq<float>(C / 2, iq_params(mf, iq, batch, Lc, L_iq, chunk, R, W, ref_norm,
                                           scale, thr, min_mag, mag, above), stream);
}

extern "C" int zc_cfar_iq_i16(const void* mf, const void* iq, int C, int batch, long long Lc,
                              long long L_iq, int chunk, int R, int W, float ref_norm,
                              float scale, float thr, float min_mag, void* mag, void* above,
                              void* stream) {
  if (C % 2 || C / 2 > kMaxBranches) return (int)cudaErrorInvalidValue;
  return launch_iq<int16_t>(C / 2, iq_params(mf, iq, batch, Lc, L_iq, chunk, R, W, ref_norm,
                                             scale, thr, min_mag, mag, above), stream);
}
