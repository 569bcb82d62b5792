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
// What bounds it on the H100: HBM bytes.  It reads 16 B/sample (f32, two
// branches) or 8 B/sample (int16) and writes 12 B/sample (metric) or 17
// B/sample (detect).  Measured at 512 x 262,144 x 2, L = 512 (PERF.md):
// every mode moves 2.35-2.47 TB/s (74% of 3.35), and int16 is faster than
// f32 by about its bytes; per sample it also runs 12 float64 products,
// their conversions and the float64 scan of three window increments, which
// bounded the variants that held fewer CTAs per SM.
//
// Design (the span walk of span_walk.cuh, as kernel A's).  The TPU kernel
// walks time blocks in order with a 2L IQ history in VMEM.  Here each CTA
// walks a span of consecutive 1024-sample tiles of one stream in order,
// starting round4(2L) samples before the span (the history at the stream's
// head): the metric has no IIR, so from that halo on every window sum is
// exact.  The last 2L + 1024 samples of every plane stay in a shared ring
// (each input sample is read from HBM once; the samples before the walk's
// start read as zero), and the three window sums are float64 running values
// carried from tile to tile: per sample the increment u[n] - u[n-L] of each
// is formed in float64 from x[n], x[n-L] and x[n-2L] in factored form
// (x[n-L] (x[n] - x[n-2L]) and the like: half the products), and the
// tile's increments are scanned with warp shuffles and one exchange of warp
// totals through shared memory.  With integer-valued input every product
// and sum is exact, so kernel C equals the plain version
// (kernels/streaming.py:aa_metric_planar) bit for bit.  track and M use
// __fmul_rn / __fadd_rn / __fdiv_rn: one IEEE rounding per operation, as
// PyTorch rounds them, never a fused multiply-add.  The next tile's samples
// fly from HBM into a shared staging buffer (cp.async, 16 bytes a thread
// and plane; 8 for int16) while the current tile is computed, so no
// register holds them; rows that are not aligned to the copy, and the
// history, load at the tile's start instead.  Outputs leave as 16-byte
// stores (4-byte for above) where the row is aligned.  The span count makes
// batch x spans fill whole waves of CTAs.  An SM holds three CTAs of 256
// threads with two branches (80 registers a thread, no spills; 48 KB of
// ring and staging at L = 512), two beyond: at 64 registers (four CTAs)
// ptxas spilled, and two CTAs were slower than three (PERF.md has the
// variants measured).  Where the rings do not fit a CTA (more than two
// branches at a long lag), the same walk reads x[n-L] and x[n-2L] back
// from global memory instead.
#include <cuda_runtime.h>
#include <stdint.h>

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
  int ring;             // x ring length per plane: halo + kTile
  float noise_floor, thr;
  float* pre;           // (batch, L) outputs; null: not written
  float* pim;
  float* r;
  float* track;
  float* m;
  uint8_t* above;
};

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
  const bool detect = a.m != nullptr;

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
          tr[k] = __fadd_rn(__fmul_rn(w[0][k], w[0][k]), __fmul_rn(w[1][k], w[1][k]));
          const bool valid = a.base + n0 + k >= lag;
          m[k] = 0.0f;
          if (valid && w[2][k] > a.noise_floor) {
            const float rc = fmaxf(w[2][k], 1e-12f);
            m[k] = fminf(__fdiv_rn(tr[k], __fmul_rn(rc, rc)), 1.0f);
          }
          if (valid && m[k] >= a.thr) ab |= 1u << (8 * k);
        }
        store4(a.track + o, f4(tr), cnt);
        store4(a.m + o, f4(m), cnt);
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

template <typename T>
int launch_planes(Args& a, void* stream) {
  const bool fits = a.C * (a.ring * (int)sizeof(float) + kTile * (int)sizeof(T)) <= smem_optin();
  if (fits && a.C <= 4) return launch<T, 4>(a, stream);
  if (fits && a.C <= 8) return launch<T, 8>(a, stream);
  return launch<T, 0>(a, stream);
}

}  // namespace

// x (C, batch, L) float32 (is_i16 = 0) or int16; hist (C, batch, hist_len)
// float32 or null, base the global index of sample 0 (primed mode); pre,
// pim, r, track, m, above: (batch, L) outputs, null pointers are skipped
// (metric mode: track = m = above = null; detect mode: r = null, track, m
// and above all given).  The caller keeps base + L below 2^31 - 2^13.
extern "C" int aa_metric(int is_i16, const void* x, const void* hist, int C, int batch,
                         long long L, int lag, int hist_len, long long base,
                         float noise_floor, float thr, void* pre, void* pim, void* r,
                         void* track, void* m, void* above, void* stream) {
  if (C < 2 || C % 2 || lag < 1 || (m && !(track && above))) return (int)cudaErrorInvalidValue;
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
  return is_i16 ? launch_planes<int16_t>(a, stream) : launch_planes<float>(a, stream);
}
