// Kernel A of the fused Minn-RTL detector: the per-sample metric.
//
// Replaces (TPU): ofdm_sync_tpu/kernels/pallas_minn_tm.py:_tm_kernel (its
// metric half), pallas_minn.py:_detect_kernel / _metric_block (#2, with its
// base_index / shard_init / emit_state modes), pallas_minn.py:_minn_kernel
// (#3, the full metric) and pallas_minn.py:_corr_energy_kernel (#4).  The
// gate/event half is kernel B (gate_events.cu).
//
// Computes, for each stream b and sample n of the channel-leading input
// x[c, b, n] (C = 2 * branches planar rows, float32 or int16 ADC codes, at
// x + c * x_plane + b * x_row + n: a contiguous tensor or a strided view,
// such as the block subrange x[..., a:b] of a shard, read in place):
//   u[n] = sum_c x[c,n] * x[c,n-Q]           quarter product, all branches
//   p[n] = sum_c x[c,n]^2                    power
//   corr_positive[n] = max(sum_{2Q window} u, 0)
//   energy[n]        = sum_{3Q window} p
//   smooth[n] = (1-alpha) smooth[n-1] + alpha corr_positive[n] [base+n >= 3Q-1]
//   above[n]  = base+n >= 3Q-1  &&  smooth * 2^frac >= energy * T
// Samples before n = 0 read the right-aligned history hist[c, b, Hh + n]
// (n >= -Hh; zero before it or without a history), and smooth[-1] is
// carry_in[b] (zero without one).  base is the global index of sample 0.
// The strided view is the counterpart of the TPU kernel's in_block_stride /
// in_block_offset (pallas_minn_tm.py:269-309), which runs the kernel on a
// block subrange of a buffer without copying it.  Rows whose start is not
// 16-byte (int16: 8-byte) aligned load through the scalar path.
// Modes, by which outputs are given (a null pointer is not written):
//   corr/above (#1, #2):  corr, above
//   full metric (#3):     corr, smooth, energy, above
//   corr/energy (#4):     corr, energy; no IIR (scan = 0)
// and carry_out[b] = smooth[L-1] where given (emit_state).
//
// What bounds it on the H100: at least HBM bytes.  It reads 16 B/sample
// (f32, two branches) or 8 B/sample (int16) and writes 5 B/sample
// (corr/above), 13 (full) or 8 (corr/energy).  As built, int16 (half the
// input bytes) is barely faster than f32, so the instructions it issues
// per sample (two warp scans, the ring traffic, three block barriers per
// tile, four where 2Q < 1024) bound it before HBM does (PERF.md).
//
// Design.  The TPU kernel walks time blocks in order and carries the IQ
// history and the smoothing state between grid steps.  Here each CTA walks
// a span of consecutive 1024-sample tiles of one stream in order and
// carries, exactly, what the next tile needs: the last Q samples of every
// plane and the last 3Q quarter products and powers (shared-memory rings),
// the 2Q and 3Q window sums (float64 registers: a running window over
// integer-valued input is exact) and the smoothing register.  A span primes
// once from a left halo of 3Q + 255 + 1 samples (parallel/shard.py:
// _minn_halo_width without its gate tail): 3Q of delay-line reach plus the
// smoothing memory after which older terms weigh less than 2^-45, the same
// truncation the TPU kernel's scan makes; the span at the stream's head
// primes from the history and carry_in instead (the map at n = -1 is the
// constant carry_in, identities before it), exactly.  The span count makes
// batch x spans one wave of CTAs, so at 512 streams a span is a whole
// stream and its 3Q head costs 0.6%.
// Per tile, each thread holds 4 consecutive samples: its 16-byte (int16:
// 8-byte) loads of the next tile are in flight while the current tile is
// scanned, x[n - Q] and the window tails come from the rings with 16-byte
// shared loads, the window increments are scanned in float64 and the
// smoothing maps in float32 (warp shuffles, one exchange of warp totals
// through shared memory each), and outputs leave as 16-byte (4-byte for above) stores, so
// consecutive threads write consecutive samples.  An SM holds four CTAs of
// 256 threads (64 registers a thread, no spills; at Q = 512 each CTA's
// rings take 45 KB).  int16 input is converted to float32 before any
// product.  Samples past the stream end are zero and are never written.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // consecutive samples per thread
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
// CTAs per SM: 4 (at most 64 registers a thread) up to two branches, 3 beyond
constexpr int min_blocks(int planes) { return planes > 4 ? 3 : 4; }
constexpr int kMinSpanTiles = 16;

struct Args {
  const void* x;          // (C, batch, L) float32 or int16, strides x_plane, x_row
  long long x_plane, x_row;
  const float* hist;      // (C, batch, hist_len) right-aligned, or null
  const float* carry_in;  // (batch,) smoothing register before sample 0, or null
  int C, batch, L, Q, halo, hist_len, scan, base, valid_from;
  int spans, span;        // spans per stream, samples per span
  int ring, ring_up;      // x ring (>= Q + kTile) and u/p ring (>= 3Q + kTile) lengths
  int vin;                // every input row starts 16-byte (int16: 8-byte) aligned: vector loads
  int vec;                // L % 4 == 0: vector stores of the (batch, L) outputs
  float alpha, frac_scale, thr;
  float* corr;            // (batch, L) outputs; null: not written
  float* smooth;
  float* energy;
  uint8_t* above;
  float* carry_out;       // (batch,) smooth[L-1], or null
};

template <typename T>
struct Raw4;  // 4 consecutive samples as loaded
template <>
struct Raw4<float> {
  using type = float4;
  static __device__ __forceinline__ float4 f(float4 v) { return v; }
};
template <>
struct Raw4<int16_t> {
  using type = uint2;  // two registers, unpacked when converted
  static __device__ __forceinline__ float4 f(uint2 v) {
    return make_float4((float)(int16_t)(v.x & 0xffffu), (float)((int)v.x >> 16),
                       (float)(int16_t)(v.y & 0xffffu), (float)((int)v.y >> 16));
  }
};

__device__ __forceinline__ float get(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// 4 ring entries from index i (wrapping at len); aligned: one 16-byte access
__device__ __forceinline__ float4 ring_ld(const float* r, int i, int len, bool aligned) {
  if (aligned) return *reinterpret_cast<const float4*>(r + i);
  float v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = r[i + k < len ? i + k : i + k - len];
  return make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void ring_st(float* r, int i, int len, bool aligned, float4 v) {
  if (aligned) {
    *reinterpret_cast<float4*>(r + i) = v;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) r[i + k < len ? i + k : i + k - len] = get(v, k);
}

__device__ __forceinline__ int ring_next(int i, int len) {
  i += kTile;
  return i >= len ? i - len : i;
}

template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, min_blocks(kC)) minn_rtl_metric_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* xr = reinterpret_cast<float*>(smem4);  // C planes of a.ring samples
  float* ur = xr + a.C * a.ring;                // quarter products, a.ring_up
  float* pr = ur + a.ring_up;                   // powers, a.ring_up
  __shared__ double2 s_wsum[kWarps];
  __shared__ float2 s_wmap[kWarps];
  __shared__ float s_reg[2];
  __shared__ double2 s_win[2];

  using R4 = Raw4<T>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / a.spans, sp = blockIdx.x % a.spans;
  const int Q = a.Q, L = a.L;
  const int s0 = sp * a.span, s1 = min(s0 + a.span, L);
  const int h3 = (3 * Q + 3) & ~3;
  // walk start: the halo before the span, or the history at the stream's head
  const int w0 = a.scan ? max(s0 - a.halo, -h3) : s0 - h3;
  const int js = w0 + 3 * Q - 1;  // first sample whose 3Q window lies after w0
  const size_t plane = (size_t)a.x_plane;
  const T* xs = (const T*)a.x + (size_t)b * (size_t)a.x_row;
  const float* hs = a.hist ? a.hist + (size_t)b * (size_t)a.hist_len : nullptr;
  const size_t hplane = (size_t)a.batch * (size_t)a.hist_len;
  const bool qa = (Q & 3) == 0;  // ring accesses at a Q offset are 16-byte aligned
  const float decay = 1.0f - a.alpha;
  const float carry0 = a.carry_in ? a.carry_in[b] : 0.0f;

  // sample n of plane c: the stream, the history before it, zero elsewhere
  auto ld = [&](int c, int n) -> float {
    if (n >= 0) return n < L ? (float)xs[(size_t)c * plane + (size_t)n] : 0.0f;
    if (hs && n >= -a.hist_len) return hs[(size_t)c * hplane + (size_t)(a.hist_len + n)];
    return 0.0f;
  };
  auto fast = [&](int n0) { return a.vin && n0 >= 0 && n0 + kItems <= L; };

  // prologue: x[w0 - Q, w0) into the ring, the u/p rings zero (the window
  // sums start from zero at w0)
  for (int i = tid; i < Q; i += kThreads)
    for (int c = 0; c < a.C; ++c) xr[c * a.ring + i] = ld(c, w0 - Q + i);
  for (int i = tid; i < a.ring_up; i += kThreads) {
    ur[i] = 0.0f;
    pr[i] = 0.0f;
  }
  if (tid == 0) {
    s_reg[0] = 0.0f;
    s_win[0] = make_double2(0.0, 0.0);
  }

  // ring indices of this thread's samples n0..n0+3 and of their delays
  int ix_w = Q + kItems * tid;      // x[n0]
  int ix_d = kItems * tid;          // x[n0 - Q]
  int iu_w = 3 * Q + kItems * tid;  // u[n0], p[n0]
  int iu_2 = Q + kItems * tid;      // u[n0 - 2Q]
  int iu_3 = kItems * tid;          // p[n0 - 3Q]

  // the next tile's loads in flight while this one is scanned
  typename R4::type nx[kC];
  bool nf = fast(w0 + kItems * tid);
  if (nf) {
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (c < a.C)
        nx[c] = __ldg(reinterpret_cast<const typename R4::type*>(xs + c * plane + w0 +
                                                                 kItems * tid));
  }

  int parity = 0;
  for (int t0 = w0; t0 < s1; t0 += kTile, parity ^= 1) {
    const int n0 = t0 + kItems * tid;
    // 1. this tile's samples into the ring, the next tile's loads issued
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (c >= a.C) break;
      const float4 v = nf ? R4::f(nx[c])
                          : make_float4(ld(c, n0), ld(c, n0 + 1), ld(c, n0 + 2), ld(c, n0 + 3));
      ring_st(xr + c * a.ring, ix_w, a.ring, qa, v);
    }
    nf = t0 + kTile < s1 && fast(n0 + kTile);
    if (nf) {
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (c < a.C)
          nx[c] = __ldg(reinterpret_cast<const typename R4::type*>(xs + c * plane + n0 + kTile));
    }
    __syncthreads();

    // 2. quarter products and powers, summed over the planes in f32
    float u[kItems] = {0.0f, 0.0f, 0.0f, 0.0f}, pw[kItems] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (c >= a.C) break;
      const float4 v = ring_ld(xr + c * a.ring, ix_w, a.ring, qa);
      const float4 vd = ring_ld(xr + c * a.ring, ix_d, a.ring, true);
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        u[k] = __fadd_rn(u[k], __fmul_rn(get(v, k), get(vd, k)));
        pw[k] = __fadd_rn(pw[k], __fmul_rn(get(v, k), get(v, k)));
      }
    }
    ring_st(ur, iu_w, a.ring_up, qa, make_float4(u[0], u[1], u[2], u[3]));
    ring_st(pr, iu_w, a.ring_up, qa, make_float4(pw[0], pw[1], pw[2], pw[3]));
    if (2 * Q < kTile) __syncthreads();  // else the tails read below are older tiles'

    // 3. window sums: float64 increments, scanned over the tile
    const float4 u2 = ring_ld(ur, iu_2, a.ring_up, qa);
    const float4 p3 = ring_ld(pr, iu_3, a.ring_up, true);
    double du[kItems], dp[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      du[k] = (double)u[k] - (double)get(u2, k);
      dp[k] = (double)pw[k] - (double)get(p3, k);
      if (k) {
        du[k] += du[k - 1];
        dp[k] += dp[k - 1];
      }
    }
    double2 inc = make_double2(du[kItems - 1], dp[kItems - 1]);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double2 o = ofdm::shfl_up2(inc, d);
      if (lane >= d) inc = ofdm::add2(o, inc);
    }
    double2 exc = ofdm::shfl_up2(inc, 1);
    if (lane == 0) exc = make_double2(0.0, 0.0);
    if (lane == 31) s_wsum[warp] = inc;
    __syncthreads();
    double2 before = make_double2(0.0, 0.0);
#pragma unroll
    for (int w = 0; w < kWarps - 1; ++w)
      if (w < warp) before = ofdm::add2(before, s_wsum[w]);
    const double2 w23 = s_win[parity];  // the window sums before the tile
    const double o2 = before.x + exc.x, o3 = before.y + exc.y;
    float cp[kItems], e[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      cp[k] = fmaxf((float)(w23.x + (o2 + du[k])), 0.0f);
      e[k] = (float)(w23.y + (o3 + dp[k]));
    }
    if (tid == kThreads - 1)  // the sums after the tile, for the next one
      s_win[parity ^ 1] = make_double2(w23.x + (o2 + du[kItems - 1]),
                                       w23.y + (o3 + dp[kItems - 1]));
    const bool out = n0 >= s0 && n0 < s1;  // n0 is 4-aligned, like s0
    const bool vout = out && a.vec && n0 + kItems <= s1;
    const size_t row = (size_t)b * (size_t)L;

    if (!a.scan) {  // corr/energy: no IIR, every output stands alone
      if (vout) {
        if (a.corr) *reinterpret_cast<float4*>(a.corr + row + n0) = make_float4(cp[0], cp[1], cp[2], cp[3]);
        if (a.energy) *reinterpret_cast<float4*>(a.energy + row + n0) = make_float4(e[0], e[1], e[2], e[3]);
      } else if (out) {
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          if (n0 + k >= s1) break;
          if (a.corr) a.corr[row + n0 + k] = cp[k];
          if (a.energy) a.energy[row + n0 + k] = e[k];
        }
      }
    } else {
      // 4. the smoothing recurrence: affine maps composed over the tile
      // from the register entering it; identity before js and before
      // n = -1, the carried register at -1
      float2 m[kItems];
      float2 seg = make_float2(1.0f, 0.0f);
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int n = n0 + k;
        if (n < js || n < -1)
          m[k] = make_float2(1.0f, 0.0f);
        else if (n == -1)
          m[k] = make_float2(0.0f, carry0);
        else
          m[k] = make_float2(decay, a.base + n >= a.valid_from ? a.alpha * cp[k] : 0.0f);
        seg = ofdm::compose(seg, m[k]);
      }
      float2 minc = seg;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float2 o = ofdm::shfl_up_f2(minc, d);
        if (lane >= d) minc = ofdm::compose(o, minc);
      }
      float2 mexc = ofdm::shfl_up_f2(minc, 1);
      if (lane == 0) mexc = make_float2(1.0f, 0.0f);
      if (lane == 31) s_wmap[warp] = minc;
      __syncthreads();
      float s = s_reg[parity];
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (w < warp) s = fmaf(s_wmap[w].x, s, s_wmap[w].y);
      s = fmaf(mexc.x, s, mexc.y);
      float sm[kItems];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        s = fmaf(m[k].x, s, m[k].y);
        sm[k] = s;
      }
      if (tid == kThreads - 1) s_reg[parity ^ 1] = s;  // the register after the tile
      uint32_t ab = 0u;
#pragma unroll
      for (int k = 0; k < kItems; ++k)
        if (a.base + n0 + k >= a.valid_from &&
            __fmul_rn(sm[k], a.frac_scale) >= __fmul_rn(e[k], a.thr))
          ab |= 1u << (8 * k);
      if (vout) {
        if (a.corr) *reinterpret_cast<float4*>(a.corr + row + n0) = make_float4(cp[0], cp[1], cp[2], cp[3]);
        if (a.smooth) *reinterpret_cast<float4*>(a.smooth + row + n0) = make_float4(sm[0], sm[1], sm[2], sm[3]);
        if (a.energy) *reinterpret_cast<float4*>(a.energy + row + n0) = make_float4(e[0], e[1], e[2], e[3]);
        if (a.above) *reinterpret_cast<uint32_t*>(a.above + row + n0) = ab;
      } else if (out) {
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          if (n0 + k >= s1) break;
          if (a.corr) a.corr[row + n0 + k] = cp[k];
          if (a.smooth) a.smooth[row + n0 + k] = sm[k];
          if (a.energy) a.energy[row + n0 + k] = e[k];
          if (a.above) a.above[row + n0 + k] = (uint8_t)(ab >> (8 * k));
        }
      }
      if (a.carry_out && out) {
#pragma unroll
        for (int k = 0; k < kItems; ++k)
          if (n0 + k == L - 1) a.carry_out[b] = sm[k];
      }
    }
    ix_w = ring_next(ix_w, a.ring);
    ix_d = ring_next(ix_d, a.ring);
    iu_w = ring_next(iu_w, a.ring_up);
    iu_2 = ring_next(iu_2, a.ring_up);
    iu_3 = ring_next(iu_3, a.ring_up);
  }
}

// spans per stream: batch x spans fills the card with one wave of CTAs,
// each span at least kMinSpanTiles long
template <typename T, int kC>
int launch(Args& a, void* stream) {
  static bool attr = false;
  static int slots_smem = -1, slots = 0;
  auto kernel = minn_rtl_metric_kernel<T, kC>;
  const int smem = (a.C * a.ring + 2 * a.ring_up) * (int)sizeof(float);
  if (!attr) {  // once per process: allow the largest dynamic shared memory
    int dev = 0, optin = 0;
    cudaFuncAttributes fa{};
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin - (int)fa.sharedSizeBytes);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  if (smem != slots_smem) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, smem);
    slots = std::max(sms * per, 1);
    slots_smem = smem;
  }
  const int tiles = (a.L + kTile - 1) / kTile;
  int S = std::max(1, std::min(slots / std::max(a.batch, 1), tiles / kMinSpanTiles));
  const int span_tiles = (tiles + S - 1) / S;
  a.spans = (tiles + span_tiles - 1) / span_tiles;
  a.span = span_tiles * kTile;
  const unsigned grid = (unsigned)a.batch * (unsigned)a.spans;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_planes(Args& a, void* stream) {
  if (a.C <= 4) return launch<T, 4>(a, stream);
  if (a.C <= 8) return launch<T, 8>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (C, batch, L) float32 (is_i16 = 0) or int16, C <= 8, element (c, b, n)
// at x + c * x_plane + b * x_row + n (contiguous: x_plane = batch * L,
// x_row = L); hist (C, batch,
// hist_len) float32 or null; carry_in (batch,) float32 or null; outputs
// (batch, L) and carry_out (batch,), each null when not wanted.  scan = 0
// runs the corr/energy mode (no IIR; smooth, above and carry_out must be
// null).  halo: samples of smoothing warm-up and delay line before each
// span (ignored when scan = 0).  The caller keeps base + L below 2^31 and
// (C * (Q + 1024) + 2 * (3Q + 1024)) * 4 bytes within 227 KB.
extern "C" int minn_rtl_metric(int is_i16, const void* x, const void* hist,
                               const void* carry_in, int C, int batch, long long L,
                               long long x_plane, long long x_row, int Q,
                               int halo, int hist_len, int scan, long long base, float alpha,
                               long long valid_from, float frac_scale, float thr, void* corr,
                               void* smooth, void* energy, void* above, void* carry_out,
                               void* stream) {
  if (!scan && (smooth || above || carry_out)) return (int)cudaErrorInvalidValue;
  if (C < 1 || C > 8 || Q < 1 || x_plane < 0 || x_row < 0) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || L <= 0) return (int)cudaSuccess;
  Args a{};
  a.x = x;
  a.x_plane = x_plane;
  a.x_row = x_row;
  a.hist = (const float*)hist;
  a.carry_in = (const float*)carry_in;
  a.C = C;
  a.batch = batch;
  a.L = (int)L;
  a.Q = Q;
  a.halo = (halo + 3) & ~3;
  a.hist_len = hist ? hist_len : 0;
  a.scan = scan;
  a.base = (int)base;
  a.valid_from = (int)valid_from;
  a.ring = ((Q + kTile + 3) & ~3);
  a.ring_up = ((3 * Q + kTile + 3) & ~3);
  a.vin = ((uintptr_t)x % (is_i16 ? 8 : 16) == 0) && x_plane % 4 == 0 && x_row % 4 == 0;
  a.vec = L % 4 == 0;
  a.alpha = alpha;
  a.frac_scale = frac_scale;
  a.thr = thr;
  a.corr = (float*)corr;
  a.smooth = (float*)smooth;
  a.energy = (float*)energy;
  a.above = (uint8_t*)above;
  a.carry_out = (float*)carry_out;
  return is_i16 ? launch_planes<int16_t>(a, stream) : launch_planes<float>(a, stream);
}

extern "C" const char* ofdm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
