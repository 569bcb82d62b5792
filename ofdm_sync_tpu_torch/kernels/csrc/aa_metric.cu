// Kernel C of the fused [A][A] detector: the per-sample metric, and its
// peak capture.
//
// Replaces (TPU): ofdm_sync_tpu/kernels/pallas_aa.py:_aa_metric_kernel
// (metric mode, aa_metric_planar_pallas) and the metric half of
// pallas_aa.py:_aa_kernel (detect mode, aa_detect_fused_pallas), both built
// on pallas_aa.py:_aa_metric_rows.  The gate/event half of _aa_kernel is
// kernel B (gate_events.cu), with peak capture or, on int16 codes without a
// history, followed by this file's peak capture (below).
//
// Computes, for each stream b and sample n of the channel-leading input
// x[c, b, n] (C = 2 * branches planar rows [b0_i, b0_q, b1_i, ...], float32
// or int16 ADC codes), with lag L and x[k] = 0 for k < 0 (the zero-filled
// RTL delay line):
//   pre[k] = sum_b i[k] i[k-L] + q[k] q[k-L]     (0 for k < L)
//   pim[k] = sum_b q[k] i[k-L] - i[k] q[k-L]
//   pw[k]  = sum_b i[k]^2 + q[k]^2
//   P_re[n], P_im[n], R[n] = sums of pre, pim, pw over k in [n-L+1, n]
// Metric mode writes (P_re, P_im, R).  Detect mode forms
//   track = P_re^2 + P_im^2
//   M     = n >= L && R > 1e-6 L ? min(track / max(R, 1e-12)^2, 1) : 0
//   above = n >= L && M >= threshold
// (pallas_aa.py:302-313) and writes track and above, and P_re, P_im and M
// where their pointers are given (any output pointer may be null: not
// written).  Primed mode (pallas_aa.py:_aa_kernel's base_index /
// shard_init): x[k] for k < 0 reads the right-aligned history hist[c, b,
// Hh + k] (zero before it or without one), and validity compares the
// global index: base + n >= L.  The metric has no IIR, so the history alone
// primes a chunk.
//
// Two paths, chosen per launch by what the input shows (the wrapper picks,
// aa_fused.exact_route): int16 codes of up to two branches without a
// history take the exact integer path (aa_metric_exact_kernel) where its
// ring fits in shared memory; float32 input, every launch with a history,
// and more than two branches take the float path (aa_metric_kernel<T, kC>,
// float64 window sums).  Every output comes out bit-identical on both,
// since both round the same exact integer window sums once to float32 and
// form track and M with the same helper.
//
// What bounds it on the H100: its instructions a sample, not HBM.  It reads
// 16 B/sample (f32, two branches) or 8 B/sample (int16) and writes 12
// B/sample (metric), 17 B/sample (detect with P and M) or 5 B/sample
// (detect, the gate input alone: track and above).  Measured at 512 x
// 262,144 x 2, L = 512 on int16 codes, the gate input alone (PERF.md):
// the float path 1.36-1.40 ms, its float64 chain (12 float64 products a
// sample, ~19 conversions, the float64 scan of three window increments) the
// bulk of it; the exact path ~0.91 ms against 0.52 ms for its 13 B/sample,
// three conversions a sample, its time spread over the integer increments,
// the int64 scan (~9% in a variant without it), M's IEEE division (~10%)
// and the other work of the outputs.
//
// Peak capture (aa_peak_capture_kernel).  On int16 codes without a history
// every product and window sum above is an exact integer (at most C/2 x 2 x
// 32768^2 x L < 2^53, the wrapper checks the bound), which kernel C carries
// exactly (int64 on the exact path, float64 on the float path) and rounds
// once to float32.  So the channels that the detector returns at each
// event's peak, P_re, P_im and M, need not be written for every sample:
// after kernel B has found the peaks from track and above, one warp a table
// slot sums the 2L codes before its peak in int64, rounds each sum to
// float32 through float64 as kernel C does, and forms track and M with
// kernel C's own roundings and guards -- the same bits as kernel C's
// outputs read at the peak.
//
// Design (the span walk of span_walk.cuh, as kernel A's).  The TPU kernel
// walks time blocks in order with a 2L IQ history in VMEM.  Here each CTA
// walks a span of consecutive 1024-sample tiles of one stream in order,
// starting about 2L samples before the span (the history at the stream's
// head): the metric has no IIR, so from that halo on every window sum is
// exact.  The last 2L + 1024 samples and more of every plane stay in a
// shared ring (each input sample is read from HBM once; the samples before
// the walk's start read as zero), and the three window sums are running
// values carried from tile to tile: per sample the increment u[n] - u[n-L]
// of each is formed from x[n], x[n-L] and x[n-2L] in factored form
// (x[n-L] (x[n] - x[n-2L]) and the like: half the products), and the
// tile's increments are scanned with warp shuffles and one exchange of warp
// totals through shared memory.  With integer-valued input every product
// and sum is exact, so kernel C equals the plain version
// (kernels/streaming.py:aa_metric_planar) bit for bit.  track and M use
// __fmul_rn / __fadd_rn / __fdiv_rn (aa_track_m): one IEEE rounding per
// operation, as PyTorch rounds them, never a fused multiply-add.  Outputs
// leave as 16-byte stores (4-byte for above) where the row is aligned.
//
// The float path: 4 samples a thread, CTAs of 256 threads.  Increments in
// float64, window sums float64.  The next tile's samples fly from HBM into
// a shared staging buffer (cp.async, 16 bytes a thread and plane; 8 for
// int16) while the current tile is computed, so no register holds them;
// rows that are not aligned to the copy, and the history, load at the
// tile's start instead.  The span count makes batch x spans fill whole
// waves of CTAs.  An SM holds three CTAs with two branches (80 registers a
// thread, no spills; 48 KB of ring and staging at L = 512), two beyond: at
// 64 registers (four CTAs) ptxas spilled, and two CTAs were slower than
// three (PERF.md has the variants measured).  Where the rings do not fit a
// CTA (more than two branches at a long lag), the same walk reads x[n-L]
// and x[n-2L] back from global memory instead.
//
// The exact path: 8 samples a thread, CTAs of 128 threads (tiles of 1024),
// four to an SM (at most 128 registers a thread), so that 512 streams are
// one wave with a span a stream, as kernel A's exact path.  The ring holds
// the codes as int16, round8(2L) + 3 tiles a plane (32 KB at L = 512 and
// two branches): a tile's look-back, the tile, the next one, and one tile
// more, so that the next tile's codes never land where a slower thread's
// wide route (below) may still read.  A thread's 8 codes a plane fly from
// HBM straight into their ring slots (cp.async, 16 bytes) while the tile
// before them is computed, and are waited for before that tile's barrier,
// which publishes them; so a tile needs no barrier of its own before it
// reads x[n-L] (one barrier a tile where no tile takes the wide route).
// Rows that are not 16-byte aligned, or of a length that is not a multiple
// of 8, load with scalar loads instead.  A warp whose 256 samples are all
// outputs writes each float row through shared memory (put_row, as kernel
// A's exact path), 512 consecutive bytes a store: with a thread's 32 bytes
// stored straight, the path was 3% slower than the float path in metric
// mode and 20% slower in full detect mode (PERF.md).  Per branch and sample a thread
// unpacks the six codes from their 16-bit halves and forms the three
// factored increments with integer multiply-adds, summed over the branches
// and along its 8 samples in int32; the thread totals are scanned over the
// warp in int64, the warp totals exchanged once, and the window sums carried
// in int64; each sum is converted once, int64 -> float32 (three conversions
// a sample), which rounds as the exact sum held in float64 and converted.
// Exactness: where every code a tile's increments read (x[t0 - 2L, t0 +
// 1024)) lies in [-2^11, 2^11), each factored increment of a branch is below
// 2^24 in magnitude (two terms, each a code times a sum or difference of two
// codes, at most 2^11 x 2^12; the power's (x - x[n-L])(x + x[n-L]) at most
// 2^22 each), the two branches' below 2^25, and a thread's 8 below 2^28:
// int32 holds them.  The
// window sums reach ~2^33 at L = 512, hence int64.  The check is one
// block-wide flag a tile (w ^ (w << 1) of each code pair, taken by
// __syncthreads_or at the tile's barrier), with the last failing tile
// carried for the 2L look-back.  A tile that fails it takes the wide route:
// its increments formed again from the ring with int64 products (exact for
// any int16 code), scanned at a second barrier, and added sample by sample;
// it counts in a.failed where given.  At 12-bit codes (the [A][A] FPGA's ADC)
// no tile fails.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "span_walk.cuh"

namespace {

using namespace ofdm::walk;

// CTAs per SM: 3 (at most 80 registers a thread) with one or two branches,
// 2 beyond
constexpr int min_blocks(int kC) { return kC == 4 ? 3 : 2; }

struct Args {
  const void* x;        // (C, batch, L) float32 or int16
  const float* hist;    // (C, batch, hist_len) right-aligned, or null
  int C, batch, L, lag, hist_len, base;
  int spans, span;      // spans per stream, samples per span
  int halo;             // samples walked before each span: round4(2 lag)
                        // (the exact path: round8(2 lag))
  int ring;             // x ring length per plane: halo + kTile (exact: + 3 kXTile)
  float noise_floor, thr;
  float* pre;           // (batch, L) outputs; null: not written
  float* pim;
  float* r;
  float* track;
  float* m;
  uint8_t* above;
  // the exact path only
  int vin;               // rows start 16-byte aligned, L % 8 == 0: 16-byte copies of codes
  unsigned int* failed;  // += tiles walked on the wide route, or null
};

// the tracked |P|^2 (into tr) and M of detect mode at one sample, one IEEE
// rounding per operation; kernel C and the peak capture both form them here,
// so the capture gives kernel C's bits
__device__ __forceinline__ float aa_track_m(float p_re, float p_im, float r, bool valid,
                                            float noise_floor, float& tr) {
  tr = __fadd_rn(__fmul_rn(p_re, p_re), __fmul_rn(p_im, p_im));
  if (valid && r > noise_floor) {
    const float rc = fmaxf(r, 1e-12f);
    return fminf(__fdiv_rn(tr, __fmul_rn(rc, rc)), 1.0f);
  }
  return 0.0f;
}

// kC = 4 or 8: the planes live in shared rings; kC = 0: no ring, the
// delayed samples come from global memory
template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, min_blocks(kC)) aa_metric_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* xr = reinterpret_cast<float*>(smem4);  // C planes of a.ring samples
  T* stage = reinterpret_cast<T*>(xr + a.C * a.ring);  // C planes of the next tile
  __shared__ double s_wsum[2][kWarps][3];
  __shared__ double s_win[2][3];

  using R4 = Raw4<T>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / a.spans, sp = blockIdx.x % a.spans;
  const int L = a.L, lag = a.lag;
  const int s0 = sp * a.span, s1 = min(s0 + a.span, L);
  // x reads as zero before w0: every window sum from w0 + 2 lag - 1 <= s0 on
  // is exact, and at the stream's head the zeros are the history's own
  const int w0 = s0 - a.halo;
  const size_t plane = (size_t)a.batch * (size_t)L;
  const T* xs = (const T*)a.x + (size_t)b * (size_t)L;
  const float* hs = a.hist ? a.hist + (size_t)b * (size_t)a.hist_len : nullptr;
  const size_t hplane = (size_t)a.batch * (size_t)a.hist_len;
  const bool a1 = (lag & 3) == 0, a2 = (lag & 1) == 0;  // ring reads at lag, 2 lag aligned
  const bool detect = a.track != nullptr;

  // sample n of plane c: the stream, the history before it, zero elsewhere
  auto ld = [&](int c, int n) -> float {
    if (n >= 0) return n < L ? (float)xs[(size_t)c * plane + (size_t)n] : 0.0f;
    if (hs && n >= -a.hist_len) return hs[(size_t)c * hplane + (size_t)(a.hist_len + n)];
    return 0.0f;
  };
  auto ld4 = [&](int c, int n) {
    return make_float4(ld(c, n), ld(c, n + 1), ld(c, n + 2), ld(c, n + 3));
  };
  auto fast = [&](int n0) { return n0 >= 0 && n0 + kItems <= L; };

  if constexpr (kC > 0) {
    for (int i = tid; i < a.halo; i += kThreads)
      for (int c = 0; c < a.C; ++c) xr[c * a.ring + i] = 0.0f;
  }
  if (tid < 3) s_win[0][tid] = 0.0;

  // ring indices of this thread's samples n0..n0+3 and of their delays
  int ix_w = a.halo + kItems * tid;            // x[n0]
  int ix_1 = a.halo - lag + kItems * tid;      // x[n0 - lag]
  int ix_2 = a.halo - 2 * lag + kItems * tid;  // x[n0 - 2 lag]

  // the next tile's samples in flight while this one is computed: a plane
  // row's 4 samples are staged where they lie in the stream and their row
  // is aligned to the copy
  auto stageable = [&](int n0) {
    if (kC == 0 || !fast(n0)) return false;
    for (int c = 0; c < a.C; ++c)
      if ((uintptr_t)(xs + c * plane + n0) % sizeof(typename R4::type)) return false;
    return true;
  };
  auto stage_tile = [&](int n0) {
    for (int c = 0; c < a.C; ++c)
      cp_async4(stage + c * kTile + kItems * tid, xs + c * plane + n0);
    cp_async_commit();
  };
  bool staged = stageable(w0 + kItems * tid);
  if (staged) stage_tile(w0 + kItems * tid);

  int parity = 0;
  for (int t0 = w0; t0 < s1; t0 += kTile, parity ^= 1) {
    const int n0 = t0 + kItems * tid;
    if constexpr (kC > 0) {
      // 1. this tile's samples into the ring (from the staging buffer, or
      // loaded now), the next tile's copies started
      if (staged) cp_async_wait();
      const bool now = !staged && fast(n0);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (c >= a.C) break;
        ring_st(xr + c * a.ring, ix_w,
                staged ? R4::f(*reinterpret_cast<const typename R4::type*>(
                             stage + c * kTile + kItems * tid))
                : now  ? R4::f(R4::load(xs + c * plane + n0))
                       : ld4(c, n0));
      }
      staged = t0 + kTile < s1 && stageable(n0 + kTile);
      if (staged) stage_tile(n0 + kTile);
      __syncthreads();
    }

    // 2. the increments pre[n] - pre[n-L] (and pim, pw) in float64, from
    // x[n], x[n-L] and x[n-2L], summed over the branches
    double d[3][kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) d[0][k] = d[1][k] = d[2][k] = 0.0;
    auto add = [&](float4 vi, float4 vq, float4 di, float4 dq, float4 ei, float4 eq) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const double i = get(vi, k), q = get(vq, k), id = get(di, k), qd = get(dq, k);
        const double ie = get(ei, k), qe = get(eq, k);
        d[0][k] += id * (i - ie) + qd * (q - qe);
        d[1][k] += id * (q + qe) - qd * (i + ie);
        d[2][k] += (i - id) * (i + id) + (q - qd) * (q + qd);
      }
    };
    if constexpr (kC > 0) {
#pragma unroll 1
      for (int c = 0; c < a.C; c += 2) {
        const float* ri = xr + c * a.ring;
        const float* rq = ri + a.ring;
        add(ring_ld(ri, ix_w, a.ring, true), ring_ld(rq, ix_w, a.ring, true),
            ring_ld(ri, ix_1, a.ring, a1), ring_ld(rq, ix_1, a.ring, a1),
            ring_ld(ri, ix_2, a.ring, a2), ring_ld(rq, ix_2, a.ring, a2));
      }
    } else {
      // the samples before w0 read as zero, as from the ring
      auto ldw = [&](int c, int n) {
        return make_float4(n < w0 ? 0.0f : ld(c, n), n + 1 < w0 ? 0.0f : ld(c, n + 1),
                           n + 2 < w0 ? 0.0f : ld(c, n + 2), n + 3 < w0 ? 0.0f : ld(c, n + 3));
      };
      for (int c = 0; c < a.C; c += 2)
        add(ldw(c, n0), ldw(c + 1, n0), ldw(c, n0 - lag), ldw(c + 1, n0 - lag),
            ldw(c, n0 - 2 * lag), ldw(c + 1, n0 - 2 * lag));
    }

    // 3. the window sums: the increments scanned over the tile, added to
    // the sums before it
    double inc[3], exc[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int k = 1; k < kItems; ++k) d[j][k] += d[j][k - 1];
      inc[j] = d[j][kItems - 1];
    }
    warp_scan<3>(inc, exc, lane);
    if (lane == 31)
      for (int j = 0; j < 3; ++j) s_wsum[parity][warp][j] = inc[j];
    __syncthreads();
    float w[3][kItems];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      double o = exc[j];
#pragma unroll
      for (int v = 0; v < kWarps - 1; ++v)
        if (v < warp) o += s_wsum[parity][v][j];
      const double before = s_win[parity][j];
#pragma unroll
      for (int k = 0; k < kItems; ++k) w[j][k] = (float)(before + (o + d[j][k]));
      if (tid == kThreads - 1) s_win[parity ^ 1][j] = before + (o + d[j][kItems - 1]);
    }

    // 4. outputs of the span's samples, consecutive threads on consecutive
    // samples
    if (n0 >= s0 && n0 < s1) {
      const size_t o = (size_t)b * (size_t)L + (size_t)n0;
      const int cnt = s1 - n0;
      auto f4 = [](const float (&v)[kItems]) { return make_float4(v[0], v[1], v[2], v[3]); };
      if (a.pre) store4(a.pre + o, f4(w[0]), cnt);
      if (a.pim) store4(a.pim + o, f4(w[1]), cnt);
      if (a.r) store4(a.r + o, f4(w[2]), cnt);
      if (detect) {
        float tr[kItems], m[kItems];
        uint32_t ab = 0u;
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
          const bool valid = a.base + n0 + k >= lag;
          m[k] = aa_track_m(w[0][k], w[1][k], w[2][k], valid, a.noise_floor, tr[k]);
          if (valid && m[k] >= a.thr) ab |= 1u << (8 * k);
        }
        store4(a.track + o, f4(tr), cnt);
        if (a.m) store4(a.m + o, f4(m), cnt);
        store4(a.above + o, ab, cnt);
      }
    }
    if constexpr (kC > 0) {
      ix_w = ring_next(ix_w, a.ring);
      ix_1 = ring_next(ix_1, a.ring);
      ix_2 = ring_next(ix_2, a.ring);
    }
  }
}

template <typename T, int kC>
int launch(Args& a, void* stream) {
  static bool attr = false;
  static int slots_smem = -1, slots = 0;
  auto kernel = aa_metric_kernel<T, kC>;
  const int smem = kC > 0 ? a.C * (a.ring * (int)sizeof(float) + kTile * (int)sizeof(T)) : 0;
  if (!attr) {  // once per process: allow the largest dynamic shared memory
    const cudaError_t err = allow_smem(kernel);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  if (smem != slots_smem) {
    slots = cta_slots(kernel, smem);
    slots_smem = smem;
  }
  const int tiles = (a.L + kTile - 1) / kTile;
  const int st = span_tiles(a.batch, tiles, a.halo, slots);
  a.spans = (tiles + st - 1) / st;
  a.span = st * kTile;
  kernel<<<(unsigned)a.batch * (unsigned)a.spans, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ---- the exact int16 path --------------------------------------------------

// 8 samples a thread, CTAs of 128 threads (tiles of 1024), four to an SM
// (at most 128 registers a thread)
constexpr int kXItems = kCodes;
constexpr int kXThreads = 128;
constexpr int kXWarps = kXThreads / 32;
constexpr int kXTile = kXThreads * kXItems;
constexpr int kXMinBlocks = 4;
constexpr int kXMinSpanTiles = 16;

// codes out of [-2^11, 2^11): bits 12 .. 15 of either half of w ^ (w << 1)
// (a code pair w) differ from zero
constexpr uint32_t kRangeMask = 0xf000f000u;

// One CTA walks a span of one stream from its halo (from sample 0 at the
// stream's head: no history, so the zeros before it are the stream's own).
__global__ void __launch_bounds__(kXThreads, kXMinBlocks) aa_metric_exact_kernel(const Args a) {
  constexpr int kI = kXItems, kT = kXTile;
  extern __shared__ float4 smem4[];
  int16_t* xr = reinterpret_cast<int16_t*>(smem4);  // C planes of a.ring codes
  float* stage = reinterpret_cast<float*>(xr + a.C * a.ring);  // 256 floats a warp
  __shared__ long long s_wsum[2][kXWarps][3];
  __shared__ long long s_wide[kXWarps][3];
  __shared__ long long s_win[2][3];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / a.spans, sp = blockIdx.x % a.spans;
  const int L = a.L, lag = a.lag, R = a.ring;
  const int s0 = sp * a.span, s1 = min(s0 + a.span, L);
  const int w0 = s0 > 0 ? s0 - a.halo : 0;  // the codes before w0 read as zero
  const size_t plane = (size_t)a.batch * (size_t)L;
  const int16_t* xs = (const int16_t*)a.x + (size_t)b * (size_t)L;
  const bool la = lag % kI == 0;  // ring reads at lag and 2 lag are 16-byte aligned
  const bool detect = a.track != nullptr;

  // prologue: the ring past the first two tiles' slots zero (the look-back
  // of the first tiles; those slots fill from the stream), the first tile's
  // codes in
  for (int i = 2 * kT + kI * tid; i < R; i += kI * kXThreads)
    for (int c = 0; c < a.C; ++c)
      *reinterpret_cast<uint4*>(xr + c * R + i) = make_uint4(0, 0, 0, 0);
  if (tid < 3) s_win[0][tid] = 0;

  // ring slots of this thread's samples n0 .. n0 + 7 and of their delays
  int iw = kI * tid;
  int i1 = iw - lag, i2 = iw - 2 * lag;
  i1 += i1 < 0 ? R : 0;
  i2 += i2 < 0 ? R : 0;

  auto ld = [&](int c, int n) -> int16_t {
    return n >= 0 && n < L ? xs[(size_t)c * plane + (size_t)n] : (int16_t)0;
  };
  // this thread's 8 codes a plane of samples n0 .. n0 + 7 into ring slot
  // `slot`: flown from HBM (cp.async, waited for before the next barrier)
  // where they lie in the stream and the rows allow 16-byte copies, else
  // loaded now
  auto fill = [&](int n0, int slot) {
    if (a.vin && n0 >= 0 && n0 + kI <= L) {
      for (int c = 0; c < a.C; ++c) cp_async16(xr + c * R + slot, xs + c * plane + n0);
      cp_async_commit();
      return;
    }
    for (int c = 0; c < a.C; ++c) {
      Codes v;
#pragma unroll
      for (int k = 0; k < kI; k += 2) v.w[k >> 1] = pair16(ld(c, n0 + k), ld(c, n0 + k + 1));
      *reinterpret_cast<uint4*>(xr + c * R + slot) = v.vec();
    }
  };
  fill(w0 + kI * tid, iw);
  cp_async_wait();
  __syncthreads();  // the zeros and the first tile's codes

  // the wide route's increments of sample n0 + k, added to dd: int64
  // products of the codes in the ring (exact for any int16 code)
  auto wide_incr = [&](int k, long long (&dd)[3]) {
    const int j1 = i1 + k < R ? i1 + k : i1 + k - R;
    const int j2 = i2 + k < R ? i2 + k : i2 + k - R;
    for (int c = 0; c < a.C; c += 2) {
      const int16_t* ri = xr + c * R;
      const int16_t* rq = ri + R;
      const long long i = ri[iw + k], q = rq[iw + k], id = ri[j1], qd = rq[j1];
      const long long ie = ri[j2], qe = rq[j2];
      dd[0] += id * (i - ie) + qd * (q - qe);
      dd[1] += id * (q + qe) - qd * (i + ie);
      dd[2] += (i - id) * (i + id) + (q - qd) * (q + qd);
    }
  };

  int last_bad = INT_MIN;  // the last sample of the last tile with a code out of range
  unsigned int failed = 0;
  int parity = 0;
  for (int t0 = w0; t0 < s1; t0 += kT, parity ^= 1) {
    const int n0 = t0 + kI * tid;
    // 1. the next tile's codes on their way into the ring (this tile's were
    // published by the last barrier)
    const int iw_next = ring_next(iw, R, kT);
    if (t0 + kT < s1) fill(n0 + kT, iw_next);

    // 2. the increments u[n] - u[n - lag] of the three window sums, factored
    // (x[n - lag] (x[n] - x[n - 2 lag]) and the like), summed over the
    // branches and along the thread's samples in int32; exact where every
    // code they read lies in [-2^11, 2^11), which the range bits check
    int d[3][kI];
#pragma unroll
    for (int k = 0; k < kI; ++k) d[0][k] = d[1][k] = d[2][k] = 0;
    uint32_t bits = 0;
#pragma unroll
    for (int c = 0; c < 4; c += 2) {
      if (c >= a.C) break;
      const int16_t* ri = xr + c * R;
      const int16_t* rq = ri + R;
      const Codes xi = ring_codes(ri, iw, R, true), xq = ring_codes(rq, iw, R, true);
      const Codes di = ring_codes(ri, i1, R, la), dq = ring_codes(rq, i1, R, la);
      const Codes ei = ring_codes(ri, i2, R, la), eq = ring_codes(rq, i2, R, la);
#pragma unroll
      for (int j = 0; j < kI / 2; ++j)
        bits |= (xi.w[j] ^ (xi.w[j] << 1)) | (xq.w[j] ^ (xq.w[j] << 1));
#pragma unroll
      for (int k = 0; k < kI; ++k) {
        const int i = xi.at(k), q = xq.at(k), id = di.at(k), qd = dq.at(k);
        const int ie = ei.at(k), qe = eq.at(k);
        d[0][k] += id * (i - ie) + qd * (q - qe);
        d[1][k] += id * (q + qe) - qd * (i + ie);
        d[2][k] += (i - id) * (i + id) + (q - qd) * (q + qd);
      }
    }
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 1; k < kI; ++k) d[j][k] += d[j][k - 1];

    // 3. the window sums: the thread totals scanned over the tile in int64,
    // added to the sums before it; the block's range flag at the barrier
    long long inc[3], exc[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) inc[j] = d[j][kI - 1];
    warp_scan<3>(inc, exc, lane);
    if (lane == 31)
      for (int j = 0; j < 3; ++j) s_wsum[parity][warp][j] = inc[j];
    cp_async_wait();  // the next tile's codes, published by the barrier
    if (__syncthreads_or((bits & kRangeMask) != 0)) last_bad = t0 + kT - 1;
    // every code the tile's increments read (x[t0 - 2 lag, t0 + 1024)) in range
    const bool exact = last_bad < t0 - 2 * lag;
    float w[3][kI];
    long long last[3];  // the window sums at the thread's last sample
    if (exact) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        long long o = s_win[parity][j] + exc[j];
#pragma unroll
        for (int v = 0; v < kXWarps - 1; ++v)
          if (v < warp) o += s_wsum[parity][v][j];
#pragma unroll
        for (int k = 0; k < kI; ++k) w[j][k] = (float)(o + d[j][k]);
        last[j] = o + d[j][kI - 1];
      }
    } else {
      // the wide route: the thread totals in int64, scanned, then each
      // sample's increments formed again and added in turn
      long long tot[3] = {0, 0, 0};
      for (int k = 0; k < kI; ++k) wide_incr(k, tot);
      warp_scan<3>(tot, exc, lane);
      if (lane == 31)
        for (int j = 0; j < 3; ++j) s_wide[warp][j] = tot[j];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        last[j] = s_win[parity][j] + exc[j];
        for (int v = 0; v < warp; ++v) last[j] += s_wide[v][j];
      }
#pragma unroll
      for (int k = 0; k < kI; ++k) {
        wide_incr(k, last);
#pragma unroll
        for (int j = 0; j < 3; ++j) w[j][k] = (float)last[j];
      }
      failed += tid == 0;
    }
    if (tid == kXThreads - 1)
      for (int j = 0; j < 3; ++j) s_win[parity ^ 1][j] = last[j];

    // 4. outputs of the span's samples, consecutive threads on consecutive
    // samples; a warp whose 256 samples are all outputs writes each float row
    // through shared memory, 512 consecutive bytes a store (put_row)
    if (n0 >= s0 && n0 < s1) {
      const size_t row = (size_t)b * (size_t)L;
      const bool vout = (L & 3) == 0 && n0 + kI <= s1;
      const int wbase = t0 + 32 * kI * warp;  // the warp's first sample
      float* wst = (L & 3) == 0 && wbase >= s0 && wbase + 32 * kI <= s1
                       ? stage + 32 * kI * warp
                       : nullptr;
      if (a.pre) put_row(a.pre + row, w[0], wst, wbase, n0, vout, true, s1);
      if (a.pim) put_row(a.pim + row, w[1], wst, wbase, n0, vout, true, s1);
      if (a.r) put_row(a.r + row, w[2], wst, wbase, n0, vout, true, s1);
      if (detect) {
        float tr[kI], m[kI];
        uint32_t ab[2] = {0u, 0u};
#pragma unroll
        for (int k = 0; k < kI; ++k) {
          const bool valid = a.base + n0 + k >= lag;
          m[k] = aa_track_m(w[0][k], w[1][k], w[2][k], valid, a.noise_floor, tr[k]);
          if (valid && m[k] >= a.thr) ab[k >> 2] |= 1u << (8 * (k & 3));
        }
        put_row(a.track + row, tr, wst, wbase, n0, vout, true, s1);
        if (a.m) put_row(a.m + row, m, wst, wbase, n0, vout, true, s1);
#pragma unroll
        for (int h = 0; h < kI; h += 4) store4(a.above + row + n0 + h, ab[h >> 2], s1 - n0 - h);
      }
    }
    iw = iw_next;
    i1 = ring_next(i1, R, kT);
    i2 = ring_next(i2, R, kT);
  }
  if (a.failed && failed) atomicAdd(a.failed, failed);
}

// spans per stream: batch x spans fills the card with one wave of CTAs,
// each span at least kXMinSpanTiles long
int launch_exact(Args& a, void* stream) {
  static bool attr = false;
  static int slots_smem = -1, slots = 0;
  const int smem = a.C * a.ring * (int)sizeof(int16_t) + kXTile * (int)sizeof(float);
  if (!attr) {  // once per process: allow the largest dynamic shared memory
    const cudaError_t err = allow_smem(aa_metric_exact_kernel);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  if (smem != slots_smem) {
    slots = cta_slots(aa_metric_exact_kernel, smem, kXThreads);
    slots_smem = smem;
  }
  const int tiles = (a.L + kXTile - 1) / kXTile;
  const int S = std::max(1, std::min(slots / std::max(a.batch, 1), tiles / kXMinSpanTiles));
  const int st = (tiles + S - 1) / S;
  a.spans = (tiles + st - 1) / st;
  a.span = st * kXTile;
  aa_metric_exact_kernel<<<(unsigned)a.batch * (unsigned)a.spans, kXThreads, smem,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_planes(Args& a, void* stream) {
  const bool fits = a.C * (a.ring * (int)sizeof(float) + kTile * (int)sizeof(T)) <= smem_optin();
  if (fits && a.C <= 4) return launch<T, 4>(a, stream);
  if (fits && a.C <= 8) return launch<T, 8>(a, stream);
  return launch<T, 0>(a, stream);
}

// the 3 channels of slot (b, s) at its peak: P_re, P_im and M (kernel C's
// detect mode at that sample, see the top of the file), zero where the
// peak lies outside the call
struct CapArgs {
  const int16_t* x;  // (C, batch, L) int16 codes, no history
  const int* pidx;   // (batch, E) global peak index of each slot (B's table)
  float* cap;        // (batch, 3, E)
  int C, batch, L, lag, E, base;
  float noise_floor;
};

constexpr int kCapWarps = 8;  // slots a CTA, one warp each

__global__ void __launch_bounds__(32 * kCapWarps) aa_peak_capture_kernel(const CapArgs a) {
  const int lane = threadIdx.x & 31;
  const long long slot = (long long)blockIdx.x * kCapWarps + (threadIdx.x >> 5);
  if (slot >= (long long)a.batch * a.E) return;
  const int b = (int)(slot / a.E), s = (int)(slot % a.E);
  float* out = a.cap + (size_t)b * 3 * a.E + s;
  // B writes peak index 0 to a slot without a gate and an index outside the
  // call to one whose gate tracked no sample here; sample 0's window holds
  // no lagged product (x[k] = 0 for k < 0) and M is 0 below L, so an empty
  // slot reads 0 from either branch
  const long long n = (long long)a.pidx[slot] - a.base;
  if (n < 0 || n >= a.L) {
    if (lane == 0) out[0] = out[a.E] = out[2 * a.E] = 0.0f;
    return;
  }
  const size_t plane = (size_t)a.batch * (size_t)a.L;
  const int16_t* xs = a.x + (size_t)b * (size_t)a.L;
  long long pre = 0, pim = 0, pw = 0;
  const int n0 = (int)n - a.lag + 1;
  for (int k = max(n0, 0) + lane; k <= (int)n; k += 32) {
    const int kd = k - a.lag;
    for (int c = 0; c < a.C; c += 2) {
      const int i = xs[(size_t)c * plane + k], q = xs[(size_t)(c + 1) * plane + k];
      const int id = kd >= 0 ? xs[(size_t)c * plane + kd] : 0;
      const int qd = kd >= 0 ? xs[(size_t)(c + 1) * plane + kd] : 0;
      // each product fits int32 (|.| <= 2^30), their sums need int64
      pre += (long long)(i * id) + (long long)(q * qd);
      pim += (long long)(q * id) - (long long)(i * qd);
      pw += (long long)(i * i) + (long long)(q * q);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    pre += __shfl_xor_sync(0xffffffffu, pre, d);
    pim += __shfl_xor_sync(0xffffffffu, pim, d);
    pw += __shfl_xor_sync(0xffffffffu, pw, d);
  }
  if (lane != 0) return;
  // kernel C's roundings: the exact sum through float64 to float32, then
  // one IEEE rounding per operation
  const float p_re = (float)(double)pre, p_im = (float)(double)pim, r = (float)(double)pw;
  float tr;
  const float m = aa_track_m(p_re, p_im, r, (long long)a.base + n >= a.lag, a.noise_floor, tr);
  out[0] = p_re;
  out[a.E] = p_im;
  out[2 * a.E] = m;
}

}  // namespace

// x (C, batch, L) float32 (is_i16 = 0) or int16; hist (C, batch, hist_len)
// float32 or null, base the global index of sample 0 (primed mode); pre,
// pim, r, track, m, above: (batch, L) outputs, null pointers are skipped.
// track given: detect mode, which needs above too (pre, pim and m each given
// or null; all three null: the gate input alone, for aa_peak_capture);
// track null: metric mode, m and above null too.  exact: the exact integer
// path, for int16 codes of up to two branches (C <= 4) without a history
// only; its ring, C x (round8(2 lag) + 3072) x 2 bytes, and 4 KB of store
// staging must fit.
// failed_tiles (one unsigned int) or null: the exact path adds the tiles it
// walked on its wide route.  The caller keeps base + L below 2^31 - 2^13.
extern "C" int aa_metric(int is_i16, int exact, const void* x, const void* hist, int C,
                         int batch, long long L, int lag, int hist_len, long long base,
                         float noise_floor, float thr, void* pre, void* pim, void* r,
                         void* track, void* m, void* above, void* failed_tiles,
                         void* stream) {
  if (C < 2 || C % 2 || lag < 1) return (int)cudaErrorInvalidValue;
  if (track ? !above : m || above) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || L <= 0) return (int)cudaSuccess;
  Args a{};
  a.x = x;
  a.hist = (const float*)hist;
  a.C = C;
  a.batch = batch;
  a.L = (int)L;
  a.lag = lag;
  a.hist_len = hist ? hist_len : 0;
  a.base = (int)base;
  a.halo = round4(2 * lag);
  a.ring = a.halo + kTile;
  a.noise_floor = noise_floor;
  a.thr = thr;
  a.pre = (float*)pre;
  a.pim = (float*)pim;
  a.r = (float*)r;
  a.track = (float*)track;
  a.m = (float*)m;
  a.above = (uint8_t*)above;
  if (exact) {
    if (!is_i16 || hist || C > 4) return (int)cudaErrorInvalidValue;
    a.halo = (2 * lag + kXItems - 1) / kXItems * kXItems;
    a.ring = a.halo + 3 * kXTile;
    if (C * a.ring * (int)sizeof(int16_t) + kXTile * (int)sizeof(float) > smem_optin())
      return (int)cudaErrorInvalidValue;
    a.vin = (uintptr_t)x % 16 == 0 && L % kXItems == 0;
    a.failed = (unsigned int*)failed_tiles;
    return launch_exact(a, stream);
  }
  return is_i16 ? launch_planes<int16_t>(a, stream) : launch_planes<float>(a, stream);
}

// The peak capture: x (C, batch, L) int16 codes without a history, pidx
// (batch, E) int32 global peak indices (kernel B's table), base the global
// index of sample 0, noise_floor and lag as given to aa_metric -> cap
// (batch, 3, E) float32 [P_re, P_im, M] at each slot's peak, zero where the
// peak lies outside [base, base + L).  The caller keeps C x lag x 2^31
// below 2^52, so that every window sum is exact.
extern "C" int aa_peak_capture(const void* x, const void* pidx, int C, int batch, long long L,
                               int lag, int E, long long base, float noise_floor, void* cap,
                               void* stream) {
  if (C < 2 || C % 2 || lag < 1 || E < 1) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  CapArgs a{};
  a.x = (const int16_t*)x;
  a.pidx = (const int*)pidx;
  a.cap = (float*)cap;
  a.C = C;
  a.batch = batch;
  a.L = (int)L;
  a.lag = lag;
  a.E = E;
  a.base = (int)base;
  a.noise_floor = noise_floor;
  const long long slots = (long long)batch * E;
  const unsigned grid = (unsigned)((slots + kCapWarps - 1) / kCapWarps);
  aa_peak_capture_kernel<<<grid, 32 * kCapWarps, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
