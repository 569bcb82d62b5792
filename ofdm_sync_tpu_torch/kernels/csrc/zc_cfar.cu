// Kernel D of the fused Zadoff-Chu CFAR detector: the CFAR gate input.
//
// Replaces (TPU): ofdm_sync_tpu/kernels/pallas_zc.py:_zc_kernel (#7,
// zc_cfar_detect_pallas) in magnitude mode, and pallas_zc.py:_zc_iq_kernel
// (#8, zc_iq_cfar_detect_pallas) and pallas_zc_tm.py:_zc_iq_tm_kernel (#9,
// zc_iq_cfar_detect_tm, float32 or int16 IQ, with its shard mode) in IQ
// mode.  Their gate/event half is kernel B (gate_events.cu), launched with
// valid_from = W.
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
// and writes mag (the track of the events) and above.  Primed IQ mode (the
// shard mode of pallas_zc_tm.py:134-200): samples n < 0 of mf and IQ read
// the right-aligned halos mf_hist / iq_hist (C, batch, Hh), zero before
// them; the halo goes through the same datapath, validity compares global
// indices, and gate_init[b] = [la, la >= 0] with la the largest global index
// base + n, -h <= n < 0, whose CFAR decision is true (-1 for none): kernel
// B's carried gate, primed as the TPU kernel primes its own.
//
// What bounds it on the H100, as measured at 512 x 262,144 (x 2 branches),
// R = W = 2048 (PERF.md).  IQ mode reads 16 B/sample of mf (two branches)
// plus 16 B (float32) or 8 B (int16) of IQ and writes 5 B/sample: float32
// moves 2.58 TB/s (77% of 3.35), int16 22% fewer bytes in only 3% less
// time, so the instructions per sample (a square root and a division per
// branch, two float64 scans) bound it next to HBM.  Magnitude mode reads 4
// B and writes 1 B per sample at 1.58 TB/s: the per-tile chain (a float64
// warp scan and a barrier per 1024 samples, four CTAs per SM) bounds it;
// three tiles of loads in flight instead of one made it no faster.
//
// Design (the span walk of span_walk.cuh, as kernels A and C).  The TPU
// kernels walk time blocks in order with the energy and magnitude histories
// in VMEM.  Here each CTA walks a span of consecutive 1024-sample tiles of
// one stream in order, starting R - 1 + W - 1 samples before the span (W -
// 1 in magnitude mode; the whole history at the stream's head): nothing is
// recursive, so from that halo on every output is exact.  Per tile each
// thread forms its 4 samples' branch powers in float64 (a product of two
// float32 values is exact there, so FMA contraction cannot change it) into
// a float64 ring of the last R + 1024 powers per branch, scans the energy
// increments p[n] - p[n-R] with warp shuffles and adds them to the running
// float64 energies carried from the tile before; then the normalization,
// branch sum and magnitude with __fmul_rn / __fadd_rn / __fsqrt_rn /
// __fdiv_rn: one IEEE rounding per operation, as PyTorch rounds them in the
// plain version (kernels/streaming.py:zc_iq_planar), never a fused
// multiply-add.  The magnitudes go to a float32 ring of the last W + 1024,
// and a second warp scan carries the local sum the same way.  On
// integer-valued IQ every energy is exact, so mag equals the plain version
// bit for bit; the local sums are sums of non-integers in another order
// than the plain version's stream-wide prefix, so an above bit can differ
// where mag * 2^frac and local * T meet within a rounding.  Loads of the
// next tile (IQ and mf) are in flight while the current one is scanned;
// rows of odd length (Lc = L + R - 1) load and store as four scalars.  An
// SM holds four CTAs of 256 threads in magnitude mode, three with one or
// two branches, two beyond (no spills).
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "span_walk.cuh"

namespace {

using namespace ofdm::walk;

constexpr int kMaxBranches = 4;
// CTAs per SM: 4 in magnitude mode, 3 with one or two branches, 2 beyond
constexpr int min_blocks(int BR) { return BR == 0 ? 4 : BR <= 2 ? 3 : 2; }

struct Params {
  const float* mag_in;  // magnitude mode: (batch, L)
  const float* hist;    // right-aligned, or null: magnitude mode (batch, hist_len),
                        // primed IQ mode the mf halo (C, batch, hist_len)
  const void* iq_hist;  // primed IQ mode: the IQ halo (C, batch, hist_len)
  const float* mf;      // IQ mode: (2*BR, batch, L) matched-filter planes
  const void* iq;       // IQ mode: (2*BR, batch, L_iq) float32 or int16
  int L;                // outputs per stream: L (magnitude mode) or Lc
  int L_iq, batch, hist_len, base;
  int R, W;             // ref_len, corr_window
  int h;                // primed IQ mode: the gate's hysteresis
  int spans, span;      // spans per stream, samples per span
  int halo;             // samples walked before each span (4-aligned)
  int hist_r;           // round4(hist_len): the walk's earliest start
  int e_ring, m_ring;   // power and magnitude ring lengths: round4(R), round4(W) + kTile
  float ref_norm, scale, thr, min_mag;
  float* mag_out;       // IQ mode: (batch, L)
  uint8_t* above;       // (batch, L)
  int* gate_init;       // primed IQ mode: (batch, 2), or null
};

// BR = 0: magnitude mode; BR >= 1: IQ mode with BR branches of IQ type T
template <int BR, typename T>
__global__ void __launch_bounds__(kThreads, min_blocks(BR)) zc_cfar_kernel(const Params p) {
  constexpr int NE = BR > 0 ? BR : 1;
  constexpr int kC = 2 * NE;
  extern __shared__ double2 smem2[];
  double* er = reinterpret_cast<double*>(smem2);          // BR power rings of p.e_ring
  float* mr = reinterpret_cast<float*>(er + BR * p.e_ring);  // magnitudes, p.m_ring
  __shared__ double s_esum[2][kWarps][NE];
  __shared__ double s_lsum[2][kWarps];
  __shared__ double s_ewin[2][NE];
  __shared__ double s_lwin[2];
  __shared__ int s_la;

  using R4 = Raw4<T>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / p.spans, sp = blockIdx.x % p.spans;
  const int L = p.L;
  const int s0 = sp * p.span, s1 = min(s0 + p.span, L);
  // the span that primes the gate walks the whole halo, as the plain
  // version over [halo; shard] does
  const bool gate = p.gate_init && sp == 0;
  const int w0 = gate ? -p.hist_r : max(s0 - p.halo, -p.hist_r);
  // energies are exact from e_from on: everywhere when the walk starts at
  // the history's start (nothing before it), else R - 1 samples in
  const int e_from = w0 <= -p.hist_r ? INT_MIN : w0 + p.R - 1;
  const size_t row = (size_t)b * (size_t)L;
  const size_t plane = (size_t)p.batch * (size_t)L;
  const size_t plane_iq = (size_t)p.batch * (size_t)p.L_iq;
  const size_t hplane = (size_t)p.batch * (size_t)p.hist_len;
  const float* xs = BR > 0 ? p.mf + row : p.mag_in + row;
  const T* iqs = (const T*)p.iq + (size_t)b * (size_t)p.L_iq;
  const float* hs = p.hist ? p.hist + (size_t)b * (size_t)p.hist_len : nullptr;
  const T* his = p.iq_hist ? (const T*)p.iq_hist + (size_t)b * (size_t)p.hist_len : nullptr;
  const bool aR = (p.R & 3) == 0, aW = (p.W & 3) == 0;  // ring reads at R, W aligned

  // sample n of mf plane c (magnitude mode: the magnitudes) and of IQ plane
  // c: the stream, the history before it, zero elsewhere
  auto ld_x = [&](int c, int n) -> float {
    if (n >= 0) return n < L ? xs[(size_t)c * plane + (size_t)n] : 0.0f;
    if (hs && n >= -p.hist_len) return hs[(size_t)c * hplane + (size_t)(p.hist_len + n)];
    return 0.0f;
  };
  auto ld_iq = [&](int c, int n) -> float {
    if (n >= 0) return n < p.L_iq ? (float)iqs[(size_t)c * plane_iq + (size_t)n] : 0.0f;
    if (his && n >= -p.hist_len) return (float)his[(size_t)c * hplane + (size_t)(p.hist_len + n)];
    return 0.0f;
  };
  auto fast = [](int n0, int len) { return n0 >= 0 && n0 + kItems <= len; };

  for (int i = tid; i < BR * p.e_ring; i += kThreads) er[i] = 0.0;
  for (int i = tid; i < p.m_ring; i += kThreads) mr[i] = 0.0f;
  if (tid < NE) s_ewin[0][tid] = 0.0;
  if (tid == 0) {
    s_lwin[0] = 0.0;
    s_la = -1;
  }
  __syncthreads();

  // ring indices of this thread's samples n0..n0+3 and of their delays
  int ie_w = round4(p.R) + kItems * tid;  // p[n0]
  int ie_d = ie_w - p.R;                  // p[n0 - R]
  int im_w = round4(p.W) + kItems * tid;  // mag[n0]
  int im_d = im_w - p.W;                  // mag[n0 - W]

  // the next tile's loads in flight while this one is scanned
  typename R4::type ni[kC];
  float4 nx[kC];
  const int first = w0 + kItems * tid;
  bool fi = BR > 0 && fast(first, p.L_iq), fx = fast(first, L);
  if (fi) {
#pragma unroll
    for (int c = 0; c < kC; ++c) ni[c] = R4::load(iqs + c * plane_iq + first);
  }
  if (fx) {
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (BR > 0 || c == 0) nx[c] = Raw4<float>::load(xs + c * plane + first);
  }

  int parity = 0;
  for (int t0 = w0; t0 < s1; t0 += kTile, parity ^= 1) {
    const int n0 = t0 + kItems * tid;
    const bool more = t0 + kTile < s1;
    float mag[kItems];
    if constexpr (BR > 0) {
      // 1. the branch powers into their rings, the next tile's IQ loads started
#pragma unroll
      for (int k = 0; k < BR; ++k) {
        const float4 vi = fi ? R4::f(ni[2 * k]) : make_float4(ld_iq(2 * k, n0),
            ld_iq(2 * k, n0 + 1), ld_iq(2 * k, n0 + 2), ld_iq(2 * k, n0 + 3));
        const float4 vq = fi ? R4::f(ni[2 * k + 1]) : make_float4(ld_iq(2 * k + 1, n0),
            ld_iq(2 * k + 1, n0 + 1), ld_iq(2 * k + 1, n0 + 2), ld_iq(2 * k + 1, n0 + 3));
        double pw[kItems];
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const double i = get(vi, j), q = get(vq, j);
          pw[j] = i * i + q * q;
        }
        ring_st(er + k * p.e_ring, ie_w, pw);
      }
      fi = more && fast(n0 + kTile, p.L_iq);
      if (fi) {
#pragma unroll
        for (int c = 0; c < kC; ++c) ni[c] = R4::load(iqs + c * plane_iq + n0 + kTile);
      }
      __syncthreads();

      // 2. the energies: increments p[n] - p[n-R] scanned over the tile,
      // added to the energies before it (the thread's own prefix is formed
      // from the ring before the scan and again after it, not held across)
      auto increments = [&](int k, double (&de)[kItems]) {
        double old[kItems];
        ring_ld(er + k * p.e_ring, ie_w, p.e_ring, true, de);
        ring_ld(er + k * p.e_ring, ie_d, p.e_ring, aR, old);
#pragma unroll
        for (int j = 0; j < kItems; ++j) de[j] = (de[j] - old[j]) + (j ? de[j - 1] : 0.0);
      };
      double inc[BR], exc[BR];
#pragma unroll
      for (int k = 0; k < BR; ++k) {
        double de[kItems];
        increments(k, de);
        inc[k] = de[kItems - 1];
      }
      warp_scan<BR>(inc, exc, lane);
      if (lane == 31)
        for (int k = 0; k < BR; ++k) s_esum[parity][warp][k] = inc[k];
      __syncthreads();
      float re[kItems], im[kItems];
#pragma unroll
      for (int k = 0; k < BR; ++k) {
        double o = exc[k];
#pragma unroll
        for (int v = 0; v < kWarps - 1; ++v)
          if (v < warp) o += s_esum[parity][v][k];
        const double before = s_ewin[parity][k];
        double de[kItems];
        increments(k, de);
        if (tid == kThreads - 1) s_ewin[parity ^ 1][k] = before + (o + de[kItems - 1]);
        // 3. normalization and the branch sums, op for op as the plain version
        const float4 mre = fx ? nx[2 * k] : make_float4(ld_x(2 * k, n0), ld_x(2 * k, n0 + 1),
                                                        ld_x(2 * k, n0 + 2), ld_x(2 * k, n0 + 3));
        const float4 mim = fx ? nx[2 * k + 1] : make_float4(ld_x(2 * k + 1, n0),
            ld_x(2 * k + 1, n0 + 1), ld_x(2 * k + 1, n0 + 2), ld_x(2 * k + 1, n0 + 3));
#pragma unroll
        for (int j = 0; j < kItems; ++j) {
          const float e = (float)(before + (o + de[j]));
          const float denom = __fmul_rn(p.ref_norm, __fsqrt_rn(fmaxf(e, 1e-12f)));
          const float inv = __fdiv_rn(1.0f, denom);
          const float tr = __fmul_rn(get(mre, j), inv), ti = __fmul_rn(get(mim, j), inv);
          re[j] = k == 0 ? tr : __fadd_rn(re[j], tr);
          im[j] = k == 0 ? ti : __fadd_rn(im[j], ti);
        }
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        mag[j] = __fsqrt_rn(__fadd_rn(__fmul_rn(re[j], re[j]), __fmul_rn(im[j], im[j])));
        if (n0 + j < e_from) mag[j] = 0.0f;  // a partial energy: never summed
      }
      fx = more && fast(n0 + kTile, L);
      if (fx) {
#pragma unroll
        for (int c = 0; c < kC; ++c) nx[c] = Raw4<float>::load(xs + c * plane + n0 + kTile);
      }
    } else {
      const float4 v = fx ? nx[0] : make_float4(ld_x(0, n0), ld_x(0, n0 + 1), ld_x(0, n0 + 2),
                                                ld_x(0, n0 + 3));
#pragma unroll
      for (int j = 0; j < kItems; ++j) mag[j] = get(v, j);
      fx = more && fast(n0 + kTile, L);
      if (fx) nx[0] = Raw4<float>::load(xs + n0 + kTile);
    }

    // 4. the local sums: magnitudes into their ring, increments mag[n] -
    // mag[n-W] scanned over the tile, added to the local sum before it
    ring_st(mr, im_w, make_float4(mag[0], mag[1], mag[2], mag[3]));
    if (p.W < kTile) __syncthreads();  // else the tails read below are older tiles'
    const float4 mo = ring_ld(mr, im_d, p.m_ring, aW);
    double dl[kItems], linc[1], lexc[1];
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      dl[j] = ((double)mag[j] - (double)get(mo, j)) + (j ? dl[j - 1] : 0.0);
    linc[0] = dl[kItems - 1];
    warp_scan<1>(linc, lexc, lane);
    if (lane == 31) s_lsum[parity][warp] = linc[0];
    __syncthreads();
    double lo = lexc[0];
#pragma unroll
    for (int v = 0; v < kWarps - 1; ++v)
      if (v < warp) lo += s_lsum[parity][v];
    const double lbefore = s_lwin[parity];
    if (tid == kThreads - 1) s_lwin[parity ^ 1] = lbefore + (lo + dl[kItems - 1]);
    uint32_t ab = 0u;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int n = n0 + j;
      const float local = (float)(lbefore + (lo + dl[j]));
      const bool a = p.base + n >= p.W && __fmul_rn(mag[j], p.scale) >= __fmul_rn(local, p.thr) &&
                     mag[j] >= p.min_mag;
      if (a) ab |= 1u << (8 * j);
      if (gate && a && n < 0 && n >= -p.h && n >= -p.hist_len) atomicMax(&s_la, p.base + n);
    }
    if (n0 >= s0 && n0 < s1) {
      store4(p.above + row + n0, ab, s1 - n0);
      if constexpr (BR > 0)
        store4(p.mag_out + row + n0, make_float4(mag[0], mag[1], mag[2], mag[3]), s1 - n0);
    }
    if constexpr (BR > 0) {
      ie_w = ring_next(ie_w, p.e_ring);
      ie_d = ring_next(ie_d, p.e_ring);
    }
    im_w = ring_next(im_w, p.m_ring);
    im_d = ring_next(im_d, p.m_ring);
  }
  if (gate) {
    __syncthreads();
    if (tid == 0) {
      p.gate_init[2 * b] = s_la;
      p.gate_init[2 * b + 1] = s_la >= 0 ? 1 : 0;
    }
  }
}

template <int BR, typename T>
int launch(Params& p, void* stream) {
  static bool attr = false;
  static int slots_smem = -1, slots = 0;
  auto kernel = zc_cfar_kernel<BR, T>;
  const int smem = BR * p.e_ring * (int)sizeof(double) + p.m_ring * (int)sizeof(float);
  if (smem > smem_optin()) return (int)cudaErrorInvalidValue;
  if (!attr) {  // once per process: allow the largest dynamic shared memory
    const cudaError_t err = allow_smem(kernel);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  if (smem != slots_smem) {
    slots = cta_slots(kernel, smem);
    slots_smem = smem;
  }
  // one tile at least: a primed call with no sample still walks its halo
  const int tiles = std::max(1, (p.L + kTile - 1) / kTile);
  const int st = span_tiles(p.batch, tiles, p.halo, slots);
  p.spans = (tiles + st - 1) / st;
  p.span = st * kTile;
  kernel<<<(unsigned)p.batch * (unsigned)p.spans, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_iq(int branches, Params& p, void* stream) {
  switch (branches) {
    case 1: return launch<1, T>(p, stream);
    case 2: return launch<2, T>(p, stream);
    case 3: return launch<3, T>(p, stream);
    case 4: return launch<4, T>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

Params common(int batch, long long L, int W, int hist_len, long long base, float scale, float thr,
              float min_mag, void* above) {
  Params p{};
  p.L = (int)L;
  p.batch = batch;
  p.hist_len = hist_len;
  p.hist_r = round4(hist_len);
  p.base = (int)base;
  p.W = W;
  p.m_ring = round4(W) + kTile;
  p.scale = scale;
  p.thr = thr;
  p.min_mag = min_mag;
  p.above = (uint8_t*)above;
  return p;
}

}  // namespace

// corr_mag (batch, L) float32 -> above (batch, L) uint8; hist (batch,
// hist_len) float32 or null and base: the primed mode.  The caller keeps
// base + L below 2^31 - 2^13.
extern "C" int zc_cfar_mag_f32(const void* mag, const void* hist, int batch, long long L, int W,
                               int hist_len, long long base, float scale, float thr,
                               float min_mag, void* above, void* stream) {
  if (W < 1) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || L <= 0) return (int)cudaSuccess;
  Params p = common(batch, L, W, hist ? hist_len : 0, base, scale, thr, min_mag, above);
  p.mag_in = (const float*)mag;
  p.hist = (const float*)hist;
  p.halo = round4(W - 1);
  return launch<0, float>(p, stream);
}

// mf (C, batch, Lc) float32, iq (C, batch, L_iq) float32 (is_i16 = 0) or
// int16 -> mag (batch, Lc) float32, above (batch, Lc) uint8; C = 2 *
// branches, 1 <= branches <= 4.  Primed: mf_hist (C, batch, hist_len)
// float32 and iq_hist (C, batch, hist_len) of the IQ type, base the global
// index of sample 0, and gate_init (batch, 2) int32 written from the halo's
// last h samples (null: not written).
extern "C" int zc_cfar_iq(int is_i16, const void* mf, const void* iq, const void* mf_hist,
                          const void* iq_hist, int C, int batch, long long Lc, long long L_iq,
                          int R, int W, int hist_len, long long base, int h, float ref_norm,
                          float scale, float thr, float min_mag, void* mag, void* above,
                          void* gate_init, void* stream) {
  if (C < 2 || C % 2 || C / 2 > kMaxBranches || R < 1 || W < 1 || (iq_hist && !mf_hist))
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || (Lc <= 0 && !gate_init)) return (int)cudaSuccess;
  Params p = common(batch, Lc, W, mf_hist ? hist_len : 0, base, scale, thr, min_mag, above);
  p.mf = (const float*)mf;
  p.iq = iq;
  p.hist = (const float*)mf_hist;
  p.iq_hist = iq_hist;
  p.L_iq = (int)L_iq;
  p.R = R;
  p.h = h;
  p.halo = round4(R - 1 + W - 1);
  p.e_ring = round4(R) + kTile;
  p.ref_norm = ref_norm;
  p.mag_out = (float*)mag;
  p.gate_init = (int*)gate_init;
  return is_i16 ? launch_iq<int16_t>(C / 2, p, stream) : launch_iq<float>(C / 2, p, stream);
}
