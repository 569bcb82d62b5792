// Kernel F: one step of the Minn-RTL streaming receiver in one launch.
//
// Replaces (TPU): ofdm_sync_tpu/kernels/pallas_minn.py:403 _detect_kernel in
// its streaming mode (base_index, shard_init, emit_state), as
// ofdm_sync_tpu/kernels/streaming_chunked.py:358-433
// minn_rtl_fused_stream_step runs it: one compiled program per chunk that
// holds the gate-carry rule, the kernel and the history roll.  Kernels A
// (minn_rtl_metric.cu, primed) and B (gate_events.cu, carried) compute the
// same function in two launches with corr and above in HBM between them;
// the sharded path still composes them so.
//
// Computes, for each stream b of the chunk x[c, b, n] (C = 2 * branches
// planar rows, float32 or int16 ADC codes, element (c, b, n) at x + c *
// x_plane + b * x_row + n, 0 <= n < L), with the carried state hist (C,
// batch, H) float32 right-aligned, carry_in (batch,) and gate_in (batch, 2)
// = [last-above global index, cluster count], and base the global index of
// sample 0:
//   1. the gate carried into the chunk: it continues iff la >= 0 and
//      base - la <= h, as [la, 1], else [-1, 0] (streaming_chunked.py:
//      397-399);
//   2. kernel A's primed metric over [hist | x]: corr_positive and above,
//      the smoothing register from carry_in, valid from 3Q - 1
//      (minn_rtl_metric.cu, the span at a stream's head);
//   3. kernel B's carried gate events against Lg, the step's open-ended
//      horizon (every slot that exists is valid: emit_unclosed), tie
//      "last" or "first", E <= 128 slots (gate_events.cu);
//   4. the outputs: the table, carry_out (the register at sample L - 1),
//      gate_out (the gate after sample L - 1) and hist_out, the last H
//      samples of [hist | x] as float32 (streaming_chunked.py:423-426).
//
// What bounds it on the H100: launch latency and one CTA's serial walk, not
// bytes or operations.  A block of 4096 samples x 2 branches moves ~0.1 MB
// (64 KB of float32 chunk, 24 KB of history in and out), 0.03 us at
// 3.35 TB/s; one CTA walks the chunk's ceil((3Q + L) / 1024) tiles in
// order (six at 4096 samples and Q = 512), each a chain of block barriers.
// The design does the whole step in one launch: the gate rule, the metric,
// the gate walk and the history roll; corr and above never leave the
// registers of the thread that computed them (the gate walk's scans go
// through shared memory), and every output lives in one allocation the
// wrapper makes.
//
// Design.  One CTA of 256 threads per stream walks its chunk tile by tile
// in order, as kernel A walks the span at a stream's head: the walk starts
// 3Q samples into the history, the delay line and the quarter products and
// powers sit in shared-memory rings, the 2Q and 3Q window sums in float64
// registers (exact on integer-valued input), the smoothing register is
// composed over each tile as affine maps, in A's arithmetic and order (the
// ring, load and launch helpers are span_walk.cuh's).  Each thread holds 4
// consecutive samples; for each tile that holds an above sample or that an
// open gate reaches it then runs kernel B's tile walk (gate_slots.cuh: a
// block max-scan of the last above, a sum-scan of the cluster starts, each
// thread's gated samples folded into the slots in shared memory).  After
// the last tile the slots give the table; a peak's value comes back from
// its key (corr_positive is never -0.0).  A batch of streams is a grid of
// CTAs; three CTAs fit an SM (at most 80 registers a thread), two with
// more than two branches.  At batch 1 the step is latency-bound by design:
// one SM walks the chunk, and a split of the walk over a thread-block
// cluster is later work.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "block_scan.cuh"
#include "gate_slots.cuh"
#include "span_walk.cuh"

namespace {

namespace walk = ofdm::walk;
using walk::kItems;
using walk::kThreads;
using walk::kTile;
using walk::kWarps;

constexpr int kMaxEvents = 128;
// CTAs per SM: 3 (at most 80 registers a thread) up to two branches, 2 beyond
constexpr int min_blocks(int planes) { return planes > 4 ? 2 : 3; }

struct Args {
  const void* x;  // (C, batch, L) float32 or int16, strides x_plane, x_row
  long long x_plane, x_row;
  const float* hist;      // (C, batch, H) right-aligned
  const float* carry_in;  // (batch,)
  const int* gate_in;     // (batch, 2)
  int C, batch, L, Q, H, base, valid_from, h, E, tie_last;
  long long Lg, track_end;  // close horizon; end of peak tracking (global)
  int ring, ring_up;        // x ring (>= Q + kTile) and u/p ring (>= 3Q + kTile) lengths
  float alpha, frac_scale, thr;
  // outputs: the table (batch, E) and (batch,), carry_out (batch,),
  // gate_out (batch, 2), hist_out (C, batch, H)
  uint8_t *valid, *closed, *overflow;
  int *start, *close, *pidx, *count;
  float* pval;
  float* carry_out;
  int* gate_out;
  float* hist_out;
};

template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, min_blocks(kC)) minn_rtl_step_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* xr = reinterpret_cast<float*>(smem4);  // C planes of a.ring samples
  float* ur = xr + a.C * a.ring;                // quarter products, a.ring_up
  float* pr = ur + a.ring_up;                   // powers, a.ring_up
  __shared__ double2 s_wsum[kWarps];
  __shared__ float2 s_wmap[kWarps];
  __shared__ float s_reg[2];
  __shared__ double2 s_win[2];
  __shared__ int s_start[kMaxEvents], s_last[kMaxEvents];
  __shared__ unsigned long long s_key[kMaxEvents];
  __shared__ int s_scan[32];

  using R4 = walk::Raw4<T>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const int Q = a.Q, L = a.L, H = a.H;
  const int q4 = walk::round4(Q), h3 = walk::round4(3 * Q);
  const int w0 = -h3;             // the walk starts 3Q samples into the history
  const int js = w0 + 3 * Q - 1;  // first sample whose 3Q window lies after w0
  const size_t plane = (size_t)a.x_plane;
  const T* xs = (const T*)a.x + (size_t)b * (size_t)a.x_row;
  const size_t hplane = (size_t)a.batch * (size_t)H;
  const float* hs = a.hist + (size_t)b * (size_t)H;
  const float decay = 1.0f - a.alpha;
  const float carry0 = a.carry_in[b];
  const bool tie_last = a.tie_last != 0;
  const ofdm::Slots sl{s_start, s_last, s_key};

  // sample n of plane c: the chunk, the history before it, zero elsewhere
  auto ld = [&](int c, int n) -> float {
    if (n >= 0) return n < L ? (float)xs[(size_t)c * plane + (size_t)n] : 0.0f;
    if (n >= -H) return hs[(size_t)c * hplane + (size_t)(H + n)];
    return 0.0f;
  };
  auto fast = [&](int n0) { return n0 >= 0 && n0 + kItems <= L; };

  // 1. the gate carried into the chunk
  const int la_in = a.gate_in[2 * b];
  const bool cont = la_in >= 0 && (long long)a.base - la_in <= a.h;
  ofdm::Gate g{cont ? la_in : -1, cont ? 1 : 0};

  // prologue: x[w0 - Q, w0) into the ring (sample n sits at n - w0 + q4),
  // the u/p rings zero (the window sums start from zero at w0; sample n at
  // n - w0 + h3), the slots empty
  for (int i = tid; i < Q; i += kThreads)
    for (int c = 0; c < a.C; ++c) xr[c * a.ring + q4 - Q + i] = ld(c, w0 - Q + i);
  for (int i = tid; i < a.ring_up; i += kThreads) {
    ur[i] = 0.0f;
    pr[i] = 0.0f;
  }
  for (int s = tid; s < a.E; s += kThreads) {
    s_start[s] = ofdm::kNoStart;
    s_last[s] = -1;
    s_key[s] = 0ull;
  }
  if (tid == 0) {
    s_reg[0] = 0.0f;
    s_win[0] = make_double2(0.0, 0.0);
  }

  // ring indices of this thread's samples n0..n0+3 and of their delays
  int ix_w = q4 + kItems * tid;          // x[n0]
  int ix_d = q4 - Q + kItems * tid;      // x[n0 - Q]
  int iu_w = h3 + kItems * tid;          // u[n0], p[n0]
  int iu_2 = h3 - 2 * Q + kItems * tid;  // u[n0 - 2Q]
  int iu_3 = h3 - 3 * Q + kItems * tid;  // p[n0 - 3Q]
  const bool al_d = ((q4 - Q) & 3) == 0, al_2 = ((h3 - 2 * Q) & 3) == 0,
             al_3 = ((h3 - 3 * Q) & 3) == 0;

  // the next tile's loads in flight while this one is scanned
  typename R4::type nx[kC];
  bool nf = fast(w0 + kItems * tid);
  if (nf) {
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (c < a.C) nx[c] = R4::load(xs + c * plane + w0 + kItems * tid);
  }

  int parity = 0;
  for (int t0 = w0; t0 < L; t0 += kTile, parity ^= 1) {
    const int n0 = t0 + kItems * tid;
    // 2a. this tile's samples into the ring, the next tile's loads issued
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (c >= a.C) break;
      const float4 v = nf ? R4::f(nx[c])
                          : make_float4(ld(c, n0), ld(c, n0 + 1), ld(c, n0 + 2), ld(c, n0 + 3));
      walk::ring_st(xr + c * a.ring, ix_w, v);
    }
    nf = t0 + kTile < L && fast(n0 + kTile);
    if (nf) {
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (c < a.C) nx[c] = R4::load(xs + c * plane + n0 + kTile);
    }
    __syncthreads();

    // 2b. quarter products and powers, summed over the planes in f32
    float u[kItems] = {0.0f, 0.0f, 0.0f, 0.0f}, pw[kItems] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (c >= a.C) break;
      const float4 v = walk::ring_ld(xr + c * a.ring, ix_w, a.ring, true);
      const float4 vd = walk::ring_ld(xr + c * a.ring, ix_d, a.ring, al_d);
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        u[k] = __fadd_rn(u[k], __fmul_rn(walk::get(v, k), walk::get(vd, k)));
        pw[k] = __fadd_rn(pw[k], __fmul_rn(walk::get(v, k), walk::get(v, k)));
      }
    }
    walk::ring_st(ur, iu_w, make_float4(u[0], u[1], u[2], u[3]));
    walk::ring_st(pr, iu_w, make_float4(pw[0], pw[1], pw[2], pw[3]));
    if (2 * Q < kTile) __syncthreads();  // else the tails read below are older tiles'

    // 2c. window sums: float64 increments, scanned over the tile
    const float4 u2 = walk::ring_ld(ur, iu_2, a.ring_up, al_2);
    const float4 p3 = walk::ring_ld(pr, iu_3, a.ring_up, al_3);
    double du[kItems], dp[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      du[k] = (double)u[k] - (double)walk::get(u2, k);
      dp[k] = (double)pw[k] - (double)walk::get(p3, k);
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

    // 2d. the smoothing recurrence: affine maps composed over the tile from
    // the register entering it; identity before js and before n = -1, the
    // carried register at -1
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
    unsigned bits = 0u;  // bit k: sample n0 + k is an above sample of the gate
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      s = fmaf(m[k].x, s, m[k].y);
      const int n = n0 + k;
      if (n >= 0 && n < L && a.base + n >= a.valid_from && (long long)a.base + n < a.Lg &&
          __fmul_rn(s, a.frac_scale) >= __fmul_rn(e[k], a.thr))
        bits |= 1u << k;
      if (n == L - 1) a.carry_out[b] = s;  // (L = 0: sample -1, the carried register)
    }
    if (tid == kThreads - 1) s_reg[parity ^ 1] = s;  // the register after the tile

    // 3. kernel B's walk of the tile's samples in [0, L), where one is an
    // above sample or the gate is open at the first
    if (t0 + kTile > 0) {
      const bool any = __syncthreads_or(bits != 0u);
      if (any || (g.la >= 0 && a.base + max(t0, 0) - g.la <= a.h)) {
        const int gn0 = a.base + n0;
        const ofdm::TileGate t = ofdm::tile_gate<kItems>(bits, any, gn0, g, a.h, s_scan);
        ofdm::fold_tile<kItems>(sl, cp, bits, gn0, t, a.base, a.track_end, a.h, a.E, tie_last,
                                g);
      }
    }
    ix_w = walk::ring_next(ix_w, a.ring);
    ix_d = walk::ring_next(ix_d, a.ring);
    iu_w = walk::ring_next(iu_w, a.ring_up);
    iu_2 = walk::ring_next(iu_2, a.ring_up);
    iu_3 = walk::ring_next(iu_3, a.ring_up);
  }
  __syncthreads();

  // 4. the table from the slots (kernel B's for a lone span), the state out
  const int nexist = L > 0 ? min(g.cnt, a.E) : 0;
  bool exists = false;
  if (tid < a.E) {
    const int s = tid;
    const size_t o = (size_t)b * a.E + s;
    exists = s < nexist;
    const long long close_raw = (long long)s_last[s] + a.h;
    const unsigned long long key = s_key[s];
    a.valid[o] = exists;
    a.closed[o] = exists && close_raw <= a.Lg - 1;
    a.start[o] = exists ? s_start[s] : 0;
    a.close[o] = exists ? (int)min(max(close_raw, 0LL), a.Lg - 1) : 0;
    a.pidx[o] = !exists ? 0 : key ? ofdm::key_index(key, tie_last) : tie_last ? -1 : ofdm::kNoStart;
    a.pval[o] = !exists ? 0.0f : key ? ofdm::key_value(key) : -CUDART_INF_F;
  }
  const int count = __syncthreads_count(exists);
  if (tid == 0) {
    a.count[b] = count;
    a.overflow[b] = L > 0 && g.cnt > a.E;
    a.gate_out[2 * b] = g.la;
    a.gate_out[2 * b + 1] = g.cnt;
  }
  // the new history: the last H samples of [hist | x]
  for (int i = tid; i < a.C * H; i += kThreads) {
    const int c = i / H, j = i - c * H;
    a.hist_out[(size_t)c * hplane + (size_t)b * H + j] = ld(c, L - H + j);
  }
}

template <typename T, int kC>
int launch(Args& a, void* stream) {
  static bool attr = false;
  auto kernel = minn_rtl_step_kernel<T, kC>;
  if (!attr) {  // once per process: allow the largest dynamic shared memory
    const cudaError_t err = walk::allow_smem(kernel);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const int smem = (a.C * a.ring + 2 * a.ring_up) * (int)sizeof(float);
  kernel<<<(unsigned)a.batch, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_planes(Args& a, void* stream) {
  if (a.C <= 4) return launch<T, 4>(a, stream);
  if (a.C <= 8) return launch<T, 8>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One stream step.  x (C, batch, L) float32 (is_i16 = 0) or int16 codes,
// C <= 8, element (c, b, n) at x + c * x_plane + b * x_row + n; hist (C,
// batch, hist_len) float32, carry_in (batch,) float32, gate_in (batch, 2)
// int32; base the global index of sample 0, Lg the close horizon; h >= 1,
// 1 <= E <= 128, tie_last 1 for "last".  Outputs: valid, closed (batch, E)
// uint8, start, close, pidx (batch, E) int32, pval (batch, E) float32, count
// (batch,) int32, overflow (batch,) uint8, carry_out (batch,) float32,
// gate_out (batch, 2) int32, hist_out (C, batch, hist_len) float32.  The
// caller keeps base + L and Lg below 2^31 and (C * (Q + 1024) + 2 * (3Q +
// 1024)) * 4 bytes within 227 KB.
extern "C" int minn_rtl_step(int is_i16, const void* x, long long x_plane, long long x_row,
                             const void* hist, int hist_len, const void* carry_in,
                             const void* gate_in, int C, int batch, long long L, int Q,
                             long long base, float alpha, long long valid_from, float frac_scale,
                             float thr, int h, int E, int tie_last, long long Lg, void* valid,
                             void* closed, void* start, void* close, void* pidx, void* pval,
                             void* count, void* overflow, void* carry_out, void* gate_out,
                             void* hist_out, void* stream) {
  if (C < 1 || C > 8 || Q < 1 || h < 1 || E < 1 || E > kMaxEvents || hist_len < 0 || L < 0 ||
      x_plane < 0 || x_row < 0 || !hist || !carry_in || !gate_in)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  Args a{};
  a.x = x;
  a.x_plane = x_plane;
  a.x_row = x_row;
  a.hist = (const float*)hist;
  a.carry_in = (const float*)carry_in;
  a.gate_in = (const int*)gate_in;
  a.C = C;
  a.batch = batch;
  a.L = (int)L;
  a.Q = Q;
  a.H = hist_len;
  a.base = (int)base;
  a.valid_from = (int)valid_from;
  a.h = h;
  a.E = E;
  a.tie_last = tie_last;
  a.Lg = Lg;
  a.track_end = std::min(Lg, base + L);
  a.ring = walk::round4(Q) + kTile;
  a.ring_up = walk::round4(3 * Q) + kTile;
  a.alpha = alpha;
  a.frac_scale = frac_scale;
  a.thr = thr;
  a.valid = (uint8_t*)valid;
  a.closed = (uint8_t*)closed;
  a.overflow = (uint8_t*)overflow;
  a.start = (int*)start;
  a.close = (int*)close;
  a.pidx = (int*)pidx;
  a.count = (int*)count;
  a.pval = (float*)pval;
  a.carry_out = (float*)carry_out;
  a.gate_out = (int*)gate_out;
  a.hist_out = (float*)hist_out;
  return is_i16 ? launch_planes<int16_t>(a, stream) : launch_planes<float>(a, stream);
}
