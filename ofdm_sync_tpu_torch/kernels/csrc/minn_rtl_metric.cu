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
// 16-byte (int16 on the float path: 8-byte) aligned load through the scalar
// path.
// Modes, by which outputs are given (a null pointer is not written):
//   corr/above (#1, #2):  corr, above
//   full metric (#3):     corr, smooth, energy, above
//   corr/energy (#4):     corr, energy; no IIR (scan = 0)
// and carry_out[b] = smooth[L-1] where given (emit_state).
//
// Two paths, chosen per launch by what the input shows (the wrapper picks):
// int16 codes of up to two branches without a history take the exact
// integer path (minn_rtl_metric_kernel<int16_t, 4, true>) where its rings fit
// in shared memory; float32 input, and every launch with a history (a float
// history need not hold integers), take the float path (float32 products,
// float64 window sums).  corr and energy come out
// bit-identical on both, since both round the same exact integer window
// sums once to float32; smooth may differ in its last bits (another
// grouping of the register's scan), so above only on the threshold's knife
// edge.
//
// What bounds it on the H100: at least HBM bytes.  It reads 16 B/sample
// (f32, two branches) or 8 B/sample (int16) and writes 5 B/sample
// (corr/above), 13 (full) or 8 (corr/energy).  Both paths issue too many
// instructions per sample to reach them.  The float path on int16 was only
// 1% faster than on f32: its two warp scans, its ring traffic, three block
// barriers per tile (four where 2Q < 1024) and ten type conversions a
// sample on int16 (four int16 -> float32, four float32 -> float64, two
// float64 -> float32; Hopper converts 16 a clock an SM) bound it.  The exact
// path converts twice a sample (corr and energy, int64 -> float32), takes 8
// samples a thread and forms its products with integer multiply-adds; its
// issue rate at 16 warps an SM bounds it (PERF.md gives the times and the
// SASS mix).
//
// Design.  The TPU kernel walks time blocks in order and carries the IQ
// history and the smoothing state between grid steps.  Here each CTA walks
// a span of consecutive tiles of one stream in order and carries, exactly,
// what the next tile needs: the delay line and the products in shared-memory
// rings, the 2Q and 3Q window sums (exact: float64 on the float path, int64
// on the exact one) and the smoothing register.  A span primes once from a
// left halo of 3Q + 255 + 1 samples (parallel/shard.py:_minn_halo_width
// without its gate tail): 3Q of delay-line reach plus the smoothing memory
// after which older terms weigh less than 2^-45, the same truncation the TPU
// kernel's scan makes; the span at the stream's head primes from the history
// and carry_in instead (the map at n = -1 is the constant carry_in,
// identities before it), exactly.  The span count makes batch x spans one
// wave of CTAs where the card holds that many (at 512 streams a span is a
// whole stream).  Per tile, each thread holds consecutive samples: its
// 16-byte (float path on int16: 8-byte) loads of the next tile are in flight
// while the current tile is scanned, the window increments are scanned (warp
// shuffles, one exchange of warp totals through shared memory), then the
// smoothing maps in float32 (likewise), and outputs leave as 16-byte (above:
// 4- or 8-byte) stores.  Samples past the stream end are zero and are never
// written.
//
// The float path: 4 samples a thread, CTAs of 256 threads (tiles of 1024);
// x[n - Q] and the window tails come from the rings (the last Q samples of
// every plane and the last 3Q quarter products and powers); int16 input is
// converted to float32 before any product, the products are summed over the
// planes in float32, the increments scanned in float64.  An SM holds four
// CTAs (64 registers a thread, no spills; at Q = 512 each CTA's rings take
// 45 KB), three beyond two branches.
//
// The exact path: 8 samples a thread, CTAs of 128 threads (tiles of 1024),
// four to an SM (at most 128 registers a thread), so that 512 streams are one
// wave and, at Q = 512, u[n - 2Q] is never the tile's own (no barrier
// between the product rings' stores and loads; one where 2Q < 1024).  The
// delay line holds the codes as int16 (3Q + a tile deep); per plane a thread
// unpacks x[n] (in registers since its load) and x[n - Q] (one 16-byte
// shared load) from their 16-bit halves and forms u[n], p[n] with integer
// multiply-adds into int32 rings, from which u[n - 2Q] and p[n - 3Q] return
// (two 16-byte loads each where Q % 8 == 0).  In a steady tile (every sample
// past js, 0 and valid_from) the smoothing maps are (1 - alpha, alpha cp)
// without per-sample tests.  With more than one float output, each warp's
// stores pass through shared memory, so that each writes 512 consecutive
// bytes (the modes that move the most bytes).
// Exactness: where every code a tile reads (x[t0 - 3Q, t0 + 1024)) lies in
// [-2^k, 2^k) with C 4^k <= 2^24 (k = 11: +-2048), every float32 product and
// plane sum of the float path is an exact integer below 2^24, so integer
// arithmetic gives the same values; the increments fit int32 within a
// thread (below 2^28) and are scanned and carried in int64.  The check is
// one block-wide flag a tile (w ^ (w << 1) of each code pair, taken by
// __syncthreads_or at the barrier after the tile's store), with the last
// failing tile carried for the 3Q look-back.  A tile that fails it forms the
// four plane sums in float32 exactly as the float path does (each an
// integer-valued float), converts them exactly to int64, and leaves u[n],
// p[n] in the rings for later tiles (exact where their codes are in range,
// the only entries an exact tile reads); its window sums equal the float
// path's too, and it counts in a.failed where given.  The walk starts Q
// (rounded up to 8) before the float path's, with the rings zero, so the
// delay line needs no mask: the window sums are the true ones from js on.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;  // consecutive samples per thread (float path)
constexpr int kTile = kThreads * kItems;
constexpr int kWarps = kThreads / 32;
// the exact path: consecutive samples per thread, threads (warps) per CTA
constexpr int kXItems = 8;
constexpr int kXThreads = 128;
constexpr int kXWarps = kXThreads / 32;
constexpr int kXTile = kXThreads * kXItems;
// CTAs per SM: the float path 4 (at most 64 registers a thread) up to two
// branches, 3 beyond; the exact path 4 (at most 128)
constexpr int min_blocks(int planes, bool exact) { return exact ? 4 : planes > 4 ? 3 : 4; }
constexpr int block_threads(bool exact) { return exact ? kXThreads : kThreads; }
constexpr int kMinSpanTiles = 16;

struct Args {
  const void* x;          // (C, batch, L) float32 or int16, strides x_plane, x_row
  long long x_plane, x_row;
  const float* hist;      // (C, batch, hist_len) right-aligned, or null
  const float* carry_in;  // (batch,) smoothing register before sample 0, or null
  int C, batch, L, Q, halo, hist_len, scan, base, valid_from;
  int spans, span;        // spans per stream, samples per span
  int ring, ring_up;      // x ring (>= Q + kTile) and u/p ring (>= 3Q + kTile) lengths;
                          // the exact path: one length for its three rings (>= 3Q + kXTile)
  int vin;                // every input row starts 16-byte (int16: 8-byte) aligned: vector loads
  int vec;                // L % 4 == 0: vector stores of the (batch, L) outputs
  float alpha, frac_scale, thr;
  float* corr;            // (batch, L) outputs; null: not written
  float* smooth;
  float* energy;
  uint8_t* above;
  float* carry_out;       // (batch,) smooth[L-1], or null
  // the exact path only
  int vec8;               // L % 8 == 0: one 8-byte store of a thread's above bytes
  int stage;              // more than one float output: stores staged per warp
  uint32_t range_mask;    // a code pair w leaves the exact range iff (w ^ (w << 1)) & range_mask
  unsigned int* failed;   // += tiles walked on the float route, or null
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


// ---- the float path (float32, and every launch with a history) -----------

template <typename T, int kC>
__device__ __forceinline__ void float_walk(const Args& a) {
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


// ---- the exact int16 path --------------------------------------------------

// The span a CTA of the exact path walks: stream b, outputs [s0, s1), the
// walk's start w0 (the halo before the span, or the history at the stream's
// head) and js, the first sample whose 3Q window lies after w0.
struct Span {
  int b, s0, s1, w0, js;
};

__device__ __forceinline__ Span exact_span(const Args& a) {
  Span s;
  s.b = blockIdx.x / a.spans;
  const int sp = blockIdx.x % a.spans;
  s.s0 = sp * a.span;
  s.s1 = min(s.s0 + a.span, a.L);
  const int h3 = (3 * a.Q + kXItems - 1) / kXItems * kXItems;
  s.w0 = a.scan ? max(s.s0 - a.halo, -h3) : s.s0 - h3;
  s.js = s.w0 + 3 * a.Q - 1;
  return s;
}

// kXItems int16 codes in sample order, two to a 32-bit word
struct Codes {
  uint32_t w[kXItems / 2];
  __device__ __forceinline__ int at(int k) const {  // code k, sign-extended
    return (k & 1) ? (int)w[k >> 1] >> 16 : (int)(int16_t)(w[k >> 1] & 0xffffu);
  }
  __device__ __forceinline__ void set(uint4 v) {
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  }
  __device__ __forceinline__ uint4 vec() const { return make_uint4(w[0], w[1], w[2], w[3]); }
};

__device__ __forceinline__ uint32_t pair16(int16_t lo, int16_t hi) {
  return (uint32_t)(uint16_t)lo | (uint32_t)(uint16_t)hi << 16;
}

// codes i .. i + 7 of a ring (wrapping at len); aligned: one 16-byte load
__device__ __forceinline__ Codes ring_codes(const int16_t* r, int i, int len, bool aligned) {
  Codes v;
  if (aligned) {
    v.set(*reinterpret_cast<const uint4*>(r + i));
    return v;
  }
#pragma unroll
  for (int k = 0; k < kXItems; k += 2) {
    const int j = i + k < len ? i + k : i + k - len;
    const int j1 = i + k + 1 < len ? i + k + 1 : i + k + 1 - len;
    v.w[k >> 1] = pair16(r[j], r[j1]);
  }
  return v;
}

// entries i .. i + 7 of an int32 ring (wrapping at len, a multiple of 8);
// aligned (i % 8 == 0): two 16-byte loads
__device__ __forceinline__ void ring_ints(const int* r, int i, int len, bool aligned,
                                          int (&v)[kXItems]) {
  if (aligned) {
#pragma unroll
    for (int j = 0; j < kXItems; j += 4) {
      const int4 q = *reinterpret_cast<const int4*>(r + i + j);
      v[j] = q.x;
      v[j + 1] = q.y;
      v[j + 2] = q.z;
      v[j + 3] = q.w;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kXItems; ++k) v[k] = r[i + k < len ? i + k : i + k - len];
}

__device__ __forceinline__ void ints_st(int* r, int i, const int (&v)[kXItems]) {
#pragma unroll
  for (int j = 0; j < kXItems; j += 4)
    *reinterpret_cast<int4*>(r + i + j) = make_int4(v[j], v[j + 1], v[j + 2], v[j + 3]);
}

__device__ __forceinline__ int ring_next(int i, int len, int tile) {
  i += tile;
  return i >= len ? i - len : i;
}

__device__ __forceinline__ longlong2 add_ll2(longlong2 x, longlong2 y) {
  return make_longlong2(x.x + y.x, x.y + y.y);
}

__device__ __forceinline__ longlong2 shfl_up_ll2(longlong2 v, int d) {
  return make_longlong2(__shfl_up_sync(ofdm::kFull, v.x, d), __shfl_up_sync(ofdm::kFull, v.y, d));
}

// One output row's values of this thread's samples n0 .. n0 + 7.  Staged
// (wst, the warp's buffer of 256 floats): through shared memory, so that each
// of the warp's two stores writes 512 consecutive bytes; the warp's 256
// samples (from wbase) must then all be outputs of a row with L % 4 == 0.
// Else 16-byte stores where vout, single ones where out.
__device__ __forceinline__ void put_row(float* dst, const float (&v)[kXItems], float* wst,
                                       int wbase, int n0, bool vout, bool out, int s1) {
  const int lane = threadIdx.x & 31;
  if (wst) {
    *reinterpret_cast<float4*>(wst + kXItems * lane) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(wst + kXItems * lane + 4) = make_float4(v[4], v[5], v[6], v[7]);
    __syncwarp();
    const float4 q0 = *reinterpret_cast<const float4*>(wst + 4 * lane);
    const float4 q1 = *reinterpret_cast<const float4*>(wst + 128 + 4 * lane);
    *reinterpret_cast<float4*>(dst + wbase + 4 * lane) = q0;
    *reinterpret_cast<float4*>(dst + wbase + 128 + 4 * lane) = q1;
    __syncwarp();
  } else if (vout) {
    *reinterpret_cast<float4*>(dst + n0) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(dst + n0 + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else if (out) {
#pragma unroll
    for (int k = 0; k < kXItems; ++k)
      if (n0 + k < s1) dst[n0 + k] = v[k];
  }
}

// Whether a tile's samples are all outputs of the smoothing recurrence with
// a valid above: past js, -1 and valid_from (block-uniform).
__device__ __forceinline__ bool steady_tile(const Args& a, const Span& sp, int t0) {
  return t0 >= max(sp.js, 0) && a.base + t0 >= a.valid_from;
}

// The smoothing map of sample n: s -> m.x s + m.y; identity before js and
// before n = -1, the carried register at -1, (1 - alpha, alpha cp) after
// (alpha cp only from valid_from on).
__device__ __forceinline__ float2 smooth_map(const Args& a, const Span& sp, int n, float cpk,
                                             float carry0) {
  const float decay = 1.0f - a.alpha;
  const bool id = n < sp.js || n < -1, at = n == -1;
  const float bk = a.base + n >= a.valid_from ? a.alpha * cpk : 0.0f;
  return make_float2(id ? 1.0f : at ? 0.0f : decay, id ? 0.0f : at ? carry0 : bk);
}

// The tile's outputs from its corr_positive cp and energy e.  corr/energy
// mode: stored as they are.  Else the smoothing recurrence: the maps
// composed over the tile from the register entering it (s_reg[parity]),
// then smooth, above and the stores; the register after the tile into
// s_reg[parity ^ 1].  Called by all threads of the block (a barrier inside).
__device__ __forceinline__ void tile_outputs(const Args& a, const Span& sp, int t0,
                                             const float (&cp)[kXItems],
                                             const float (&e)[kXItems], float carry0,
                                             float2* s_wmap, float* s_reg, int parity,
                                             float* stage) {
  constexpr int kI = kXItems;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n0 = t0 + kI * tid;
  const int s1 = sp.s1;
  const size_t row = (size_t)sp.b * (size_t)a.L;
  const bool out = n0 >= sp.s0 && n0 < s1;  // n0 is 8-aligned, like s0
  const bool vout = out && a.vec && n0 + kI <= s1;
  const int wbase = t0 + 32 * kI * warp;  // the warp's first sample
  float* wst = a.stage && a.vec && wbase >= sp.s0 && wbase + 32 * kI <= s1
                   ? stage + 32 * kI * warp
                   : nullptr;
  if (!a.scan) {  // corr/energy: no IIR, every output stands alone
    if (a.corr) put_row(a.corr + row, cp, wst, wbase, n0, vout, out, s1);
    if (a.energy) put_row(a.energy + row, e, wst, wbase, n0, vout, out, s1);
    return;
  }
  const bool steady = steady_tile(a, sp, t0);
  float2 m[kI];
  if (steady) {
#pragma unroll
    for (int k = 0; k < kI; ++k) m[k] = make_float2(1.0f - a.alpha, a.alpha * cp[k]);
  } else {
#pragma unroll
    for (int k = 0; k < kI; ++k) m[k] = smooth_map(a, sp, n0 + k, cp[k], carry0);
  }
  float2 minc = make_float2(1.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < kI; ++k) minc = ofdm::compose(minc, m[k]);
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
  for (int w = 0; w < kXWarps; ++w)
    if (w < warp) s = fmaf(s_wmap[w].x, s, s_wmap[w].y);
  s = fmaf(mexc.x, s, mexc.y);
  float sm[kI];
  uint32_t ab[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < kI; ++k) {
    s = fmaf(m[k].x, s, m[k].y);
    sm[k] = s;
    if ((steady || a.base + n0 + k >= a.valid_from) &&
        __fmul_rn(s, a.frac_scale) >= __fmul_rn(e[k], a.thr))
      ab[k >> 2] |= 1u << (8 * (k & 3));
  }
  if (tid == kXThreads - 1) s_reg[parity ^ 1] = s;  // the register after the tile
  if (a.corr) put_row(a.corr + row, cp, wst, wbase, n0, vout, out, s1);
  if (a.smooth) put_row(a.smooth + row, sm, wst, wbase, n0, vout, out, s1);
  if (a.energy) put_row(a.energy + row, e, wst, wbase, n0, vout, out, s1);
  if (a.above) {
    if (vout && a.vec8) {
      *reinterpret_cast<uint2*>(a.above + row + n0) = make_uint2(ab[0], ab[1]);
    } else if (vout) {
      *reinterpret_cast<uint32_t*>(a.above + row + n0) = ab[0];
      *reinterpret_cast<uint32_t*>(a.above + row + n0 + 4) = ab[1];
    } else if (out) {
#pragma unroll
      for (int k = 0; k < kI; ++k)
        if (n0 + k < s1) a.above[row + n0 + k] = (uint8_t)(ab[k >> 2] >> (8 * (k & 3)));
    }
  }
  if (a.carry_out && out) {
#pragma unroll
    for (int k = 0; k < kI; ++k)
      if (n0 + k == a.L - 1) a.carry_out[sp.b] = sm[k];
  }
}

template <int kC>
__device__ __forceinline__ void exact_walk(const Args& a) {
  constexpr int kI = kXItems, kT = kXTile;
  extern __shared__ float4 smem4[];
  const int R = a.ring;
  int16_t* xr = reinterpret_cast<int16_t*>(smem4);  // C planes of R codes
  int* ur = reinterpret_cast<int*>(xr + a.C * R);   // quarter products, R
  int* pr = ur + R;                                 // powers, R
  float* stage = reinterpret_cast<float*>(pr + R);  // 256 floats a warp, where a.stage
  __shared__ longlong2 s_wsum[kXWarps];
  __shared__ float2 s_wmap[kXWarps];
  __shared__ float s_reg[2];
  __shared__ longlong2 s_win[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Span sp = exact_span(a);
  const int Q = a.Q, L = a.L, s1 = sp.s1;
  const int wx = sp.w0 - (Q + kI - 1) / kI * kI;  // the walk's start; x is zero before it
  const size_t plane = (size_t)a.x_plane;
  const int16_t* xs = (const int16_t*)a.x + (size_t)sp.b * (size_t)a.x_row;
  const bool qa = Q % kI == 0;  // ring reads at a Q, 2Q or 3Q offset are 16-byte aligned
  const float carry0 = a.carry_in ? a.carry_in[sp.b] : 0.0f;

  auto ld = [&](int c, int n) -> int16_t {
    return n >= 0 && n < L ? xs[(size_t)c * plane + (size_t)n] : (int16_t)0;
  };
  auto fast = [&](int n0) { return a.vin && n0 >= 0 && n0 + kI <= L; };
  auto wrap = [&](int i) { return i >= R ? i - R : i; };

  // prologue: the rings zero (the x ring past the first tile's slots, which
  // its own stores fill)
  for (int i = kT + kI * tid; i < R; i += kI * kXThreads)
    for (int c = 0; c < a.C; ++c) *reinterpret_cast<uint4*>(xr + c * R + i) = make_uint4(0, 0, 0, 0);
  for (int i = 4 * tid; i < 2 * R; i += 4 * kXThreads)
    *reinterpret_cast<int4*>(ur + i) = make_int4(0, 0, 0, 0);
  if (tid == 0) {
    s_reg[0] = 0.0f;
    s_win[0] = make_longlong2(0, 0);
  }

  // ring slots of this thread's samples n0 .. n0 + 7 and of their delays
  int iw = kI * tid;
  int i1 = iw - Q, i2 = iw - 2 * Q, i3 = iw - 3 * Q;
  i1 += i1 < 0 ? R : 0;
  i2 += i2 < 0 ? R : 0;
  i3 += i3 < 0 ? R : 0;

  // the next tile's loads in flight while this one is scanned
  const int16_t* xg = xs + (wx + kI * tid);
  Codes nx[kC];
  bool nf = fast(wx + kI * tid);
  if (nf) {
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (c < a.C) nx[c].set(__ldg(reinterpret_cast<const uint4*>(xg + c * plane)));
  }

  int last_bad = INT_MIN;  // the last sample of the last tile with a code out of range
  unsigned int failed = 0;
  int parity = 0;
  for (int t0 = wx; t0 < s1; t0 += kT, parity ^= 1) {
    const int n0 = t0 + kI * tid;
    xg += kT;
    // 1. this tile's codes into the ring and checked, the next tile's loads issued
    Codes x0[kC];
    if (nf) {
#pragma unroll
      for (int c = 0; c < kC; ++c) x0[c] = nx[c];
    } else {
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (c >= a.C) break;
#pragma unroll
        for (int k = 0; k < kI; k += 2) x0[c].w[k >> 1] = pair16(ld(c, n0 + k), ld(c, n0 + k + 1));
      }
    }
    uint32_t bits = 0;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (c >= a.C) break;
#pragma unroll
      for (int j = 0; j < kI / 2; ++j) bits |= x0[c].w[j] ^ (x0[c].w[j] << 1);
      *reinterpret_cast<uint4*>(xr + c * R + iw) = x0[c].vec();
    }
    nf = t0 + kT < s1 && fast(n0 + kT);
    if (nf) {
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (c < a.C) nx[c].set(__ldg(reinterpret_cast<const uint4*>(xg + c * plane)));
    }
    if (__syncthreads_or((bits & a.range_mask) != 0)) last_bad = t0 + kT - 1;
    const bool exact = last_bad < t0 - 3 * Q;  // every code the tile's sums read is in range

    // the float route's increments of sample n0 + k, and its u[n], p[n]: the
    // four plane sums in float32 as the float path forms them, each an
    // integer, made int64
    auto float_incr = [&](int k, long long& d2, long long& d3, float& uk, float& pk) {
      float u = 0.0f, pw = 0.0f, u2 = 0.0f, p3 = 0.0f;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (c >= a.C) break;
        const int16_t* r = xr + c * R;
        const float v0 = (float)x0[c].at(k), v1 = (float)r[wrap(i1 + k)];
        const float v2 = (float)r[wrap(i2 + k)], v3 = (float)r[wrap(i3 + k)];
        u = __fadd_rn(u, __fmul_rn(v0, v1));
        pw = __fadd_rn(pw, __fmul_rn(v0, v0));
        u2 = __fadd_rn(u2, __fmul_rn(v2, v3));
        p3 = __fadd_rn(p3, __fmul_rn(v3, v3));
      }
      d2 = (long long)u - (long long)u2;
      d3 = (long long)pw - (long long)p3;
      uk = u;
      pk = pw;
    };

    // 2. the window increments u[n] - u[n-2Q], p[n] - p[n-3Q], summed along
    // the thread's samples (exact tiles: int32, below 2^28 in magnitude);
    // u[n] and p[n] into their rings
    int du[kI], dp[kI];
    longlong2 tot = make_longlong2(0, 0);
    if (exact) {
#pragma unroll
      for (int k = 0; k < kI; ++k) du[k] = dp[k] = 0;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (c >= a.C) break;
        const Codes x1 = ring_codes(xr + c * R, i1, R, qa);
#pragma unroll
        for (int k = 0; k < kI; ++k) {
          const int v0 = x0[c].at(k);
          du[k] += v0 * x1.at(k);
          dp[k] += v0 * v0;
        }
      }
      ints_st(ur, iw, du);
      ints_st(pr, iw, dp);
      if (2 * Q < kT) __syncthreads();  // else the tails read below are older tiles'
      int u2[kI], p3[kI];
      ring_ints(ur, i2, R, qa, u2);
      ring_ints(pr, i3, R, qa, p3);
#pragma unroll
      for (int k = 0; k < kI; ++k) {
        du[k] -= u2[k];
        dp[k] -= p3[k];
        if (k) {
          du[k] += du[k - 1];
          dp[k] += dp[k - 1];
        }
      }
      tot = make_longlong2(du[kI - 1], dp[kI - 1]);
    } else {
      int uk[kI], pk[kI];
#pragma unroll
      for (int k = 0; k < kI; ++k) {
        long long d2, d3;
        float u, pw;
        float_incr(k, d2, d3, u, pw);
        tot = add_ll2(tot, make_longlong2(d2, d3));
        uk[k] = (int)u;  // exact where the codes it reads are in range; else never read
        pk[k] = (int)pw;
      }
      ints_st(ur, iw, uk);
      ints_st(pr, iw, pk);
      failed += tid == 0;
    }

    // 3. the window sums: the thread totals scanned over the tile in int64
    longlong2 inc = tot;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const longlong2 o = shfl_up_ll2(inc, d);
      if (lane >= d) inc = add_ll2(o, inc);
    }
    longlong2 exc = shfl_up_ll2(inc, 1);
    if (lane == 0) exc = make_longlong2(0, 0);
    if (lane == 31) s_wsum[warp] = inc;
    __syncthreads();
    longlong2 before = s_win[parity];  // the window sums before the tile
#pragma unroll
    for (int w = 0; w < kXWarps - 1; ++w)
      if (w < warp) before = add_ll2(before, s_wsum[w]);
    const long long o2 = before.x + exc.x, o3 = before.y + exc.y;
    float cp[kI], e[kI];
    long long w2, w3;  // the sums at the thread's last sample
    if (exact) {
#pragma unroll
      for (int k = 0; k < kI; ++k) {
        cp[k] = fmaxf((float)(o2 + du[k]), 0.0f);
        e[k] = (float)(o3 + dp[k]);
      }
      w2 = o2 + du[kI - 1];
      w3 = o3 + dp[kI - 1];
    } else {  // the increments formed again from the ring
      w2 = o2;
      w3 = o3;
#pragma unroll
      for (int k = 0; k < kI; ++k) {
        long long d2, d3;
        float u, pw;
        float_incr(k, d2, d3, u, pw);
        w2 += d2;
        w3 += d3;
        cp[k] = fmaxf((float)w2, 0.0f);
        e[k] = (float)w3;
      }
    }
    if (tid == kXThreads - 1) s_win[parity ^ 1] = make_longlong2(w2, w3);

    // 4. the outputs, through the smoothing recurrence where it runs
    tile_outputs(a, sp, t0, cp, e, carry0, s_wmap, s_reg, parity, stage);
    // a float-route tile read the x ring after the scan's barrier: in the
    // corr/energy mode (no barrier since) the next tile must not store yet
    if (!exact && !a.scan) __syncthreads();
    iw = ring_next(iw, R, kT);
    i1 = ring_next(i1, R, kT);
    i2 = ring_next(i2, R, kT);
    i3 = ring_next(i3, R, kT);
  }
  if (a.failed && failed) atomicAdd(a.failed, failed);
}

template <typename T, int kC, bool kExact>
__global__ void __launch_bounds__(block_threads(kExact), min_blocks(kC, kExact))
    minn_rtl_metric_kernel(const Args a) {
  if constexpr (kExact)
    exact_walk<kC>(a);
  else
    float_walk<T, kC>(a);
}

// spans per stream: batch x spans fills the card with one wave of CTAs,
// each span at least kMinSpanTiles long
template <typename T, int kC, bool kExact>
int launch(Args& a, void* stream) {
  static bool attr = false;
  static int slots_smem = -1, slots = 0;
  auto kernel = minn_rtl_metric_kernel<T, kC, kExact>;
  constexpr int tile = kExact ? kXTile : kTile;
  const int smem = kExact ? a.C * a.ring * (int)sizeof(int16_t) + 2 * a.ring * (int)sizeof(int) +
                                (a.stage ? kXTile * (int)sizeof(float) : 0)
                          : (a.C * a.ring + 2 * a.ring_up) * (int)sizeof(float);
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
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, block_threads(kExact), smem);
    slots = std::max(sms * per, 1);
    slots_smem = smem;
  }
  const int tiles = (a.L + tile - 1) / tile;
  int S = std::max(1, std::min(slots / std::max(a.batch, 1), tiles / kMinSpanTiles));
  const int span_tiles = (tiles + S - 1) / S;
  a.spans = (tiles + span_tiles - 1) / span_tiles;
  a.span = span_tiles * tile;
  const unsigned grid = (unsigned)a.batch * (unsigned)a.spans;
  kernel<<<grid, block_threads(kExact), smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_planes(Args& a, void* stream) {
  if (a.C <= 4) return launch<T, 4, false>(a, stream);
  if (a.C <= 8) return launch<T, 8, false>(a, stream);
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
// span (ignored when scan = 0).  exact: the exact integer path, for int16
// codes of up to two branches (C <= 4) without a history only; its shared
// memory, (C * 2 + 8) * (3Q +
// 1024 rounded up to 8) bytes and 4 KB more with more than one float output,
// must fit.  failed_tiles (one unsigned int) or null: the exact path adds
// the tiles it walked on the float route.  The caller keeps base + L below
// 2^31 and (C * (Q + 1024) + 2 * (3Q + 1024)) * 4 bytes within 227 KB.
extern "C" int minn_rtl_metric(int is_i16, int exact, const void* x, const void* hist,
                               const void* carry_in, int C, int batch, long long L,
                               long long x_plane, long long x_row, int Q,
                               int halo, int hist_len, int scan, long long base, float alpha,
                               long long valid_from, float frac_scale, float thr, void* corr,
                               void* smooth, void* energy, void* above, void* carry_out,
                               void* failed_tiles, void* stream) {
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
  a.hist_len = hist ? hist_len : 0;
  a.scan = scan;
  a.base = (int)base;
  a.valid_from = (int)valid_from;
  a.vec = L % 4 == 0;
  a.alpha = alpha;
  a.frac_scale = frac_scale;
  a.thr = thr;
  a.corr = (float*)corr;
  a.smooth = (float*)smooth;
  a.energy = (float*)energy;
  a.above = (uint8_t*)above;
  a.carry_out = (float*)carry_out;
  if (exact) {
    if (!is_i16 || hist || C > 4) return (int)cudaErrorInvalidValue;
    // codes in [-2^k, 2^k) with C 4^k <= 2^24: the float path's float32
    // products and plane sums are exact; out of it, bits k+1 .. 15 of
    // w ^ (w << 1) differ from zero in a half
    int k = 15;
    while (k > 0 && ((long long)C << (2 * k)) > (1LL << 24)) --k;
    const uint32_t half = 0xffffu & ~((2u << k) - 1u);
    a.range_mask = half | half << 16;
    a.failed = (unsigned int*)failed_tiles;
    a.halo = (halo + kXItems - 1) / kXItems * kXItems;
    a.ring = (3 * Q + kXTile + kXItems - 1) / kXItems * kXItems;
    a.stage = (corr != nullptr) + (smooth != nullptr) + (energy != nullptr) > 1;
    a.vec8 = L % 8 == 0;
    a.vin = ((uintptr_t)x % 16 == 0) && x_plane % kXItems == 0 && x_row % kXItems == 0;
    return launch<int16_t, 4, true>(a, stream);
  }
  a.halo = (halo + 3) & ~3;
  a.ring = ((Q + kTile + 3) & ~3);
  a.ring_up = ((3 * Q + kTile + 3) & ~3);
  a.vin = ((uintptr_t)x % (is_i16 ? 8 : 16) == 0) && x_plane % 4 == 0 && x_row % 4 == 0;
  return is_i16 ? launch_planes<int16_t>(a, stream) : launch_planes<float>(a, stream);
}

extern "C" const char* ofdm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
