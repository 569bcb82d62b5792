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
// in order: the Minn-RTL metric walk of minn_walk.cuh, the one kernel A's
// float path walks, over the span at a stream's head, from 3Q samples into
// the history to the chunk's end.  Its sink, per tile, forms the above bits
// and runs kernel B's tile walk where a tile holds an above sample or an
// open gate reaches it (gate_slots.cuh: a block max-scan of the last above,
// a sum-scan of the cluster starts, each thread's gated samples folded into
// the slots in shared memory).  After the last tile the slots give the
// table; a peak's value comes back from its key (corr_positive is never
// -0.0).  A batch of streams is a grid of CTAs; three CTAs fit an SM (at
// most 80 registers a thread), two with more than two branches.  At batch
// 1 the step is latency-bound by design: one SM walks the chunk, and a
// split of the walk over a thread-block cluster is later work.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "block_scan.cuh"
#include "gate_slots.cuh"
#include "minn_walk.cuh"

namespace {

namespace walk = ofdm::walk;
using walk::kItems;
using walk::kThreads;
using walk::kTile;

constexpr int kMaxEvents = 128;
// CTAs per SM: 3 (at most 80 registers a thread) up to two branches, 2 beyond
constexpr int min_blocks(int planes) { return planes > 4 ? 2 : 3; }

struct Args {
  const void* x;  // (C, batch, L) float32 or int16, strides x_plane, x_row
  long long x_plane, x_row;
  const float* hist;      // (C, batch, hist_len) right-aligned
  const float* carry_in;  // (batch,)
  const int* gate_in;     // (batch, 2)
  int C, batch, L, Q, hist_len, base, valid_from, h, E, tie_last;
  long long Lg, track_end;  // close horizon; end of peak tracking (global)
  int ring, ring_up;        // x and u/p ring lengths (minn_walk.cuh)
  int vin;                  // every row starts 16-byte (int16: 8-byte) aligned: vector loads
  float alpha, frac_scale, thr;
  // outputs: the table (batch, E) and (batch,), carry_out (batch,),
  // gate_out (batch, 2), hist_out (C, batch, hist_len)
  uint8_t *valid, *closed, *overflow;
  int *start, *close, *pidx, *count;
  float* pval;
  float* carry_out;
  int* gate_out;
  float* hist_out;
};

template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, min_blocks(kC)) minn_rtl_step_kernel(const Args a) {
  __shared__ int s_start[kMaxEvents], s_last[kMaxEvents];
  __shared__ unsigned long long s_key[kMaxEvents];
  __shared__ int s_scan[32];

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int L = a.L, H = a.hist_len;
  const bool tie_last = a.tie_last != 0;
  const ofdm::Slots sl{s_start, s_last, s_key};

  // 1. the gate carried into the chunk, the slots empty
  const int la_in = a.gate_in[2 * b];
  const bool cont = la_in >= 0 && (long long)a.base - la_in <= a.h;
  ofdm::Gate g{cont ? la_in : -1, cont ? 1 : 0};
  for (int s = tid; s < a.E; s += kThreads) {
    s_start[s] = ofdm::kNoStart;
    s_last[s] = -1;
    s_key[s] = 0ull;
  }

  // 2. the metric walked from 3Q samples into the history; per tile the
  // above bits of samples in [0, L), carry_out, and 3. kernel B's walk of
  // the tile where one is an above sample or the gate is open at the first
  auto sink = [&](int t0, int n0, const float (&cp)[kItems], const float (&e)[kItems],
                  const float* sm) {
    unsigned bits = 0u;  // bit k: sample n0 + k is an above sample of the gate
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int n = n0 + k;
      if (n >= 0 && n < L && a.base + n >= a.valid_from && (long long)a.base + n < a.Lg &&
          __fmul_rn(sm[k], a.frac_scale) >= __fmul_rn(e[k], a.thr))
        bits |= 1u << k;
      if (n == L - 1) a.carry_out[b] = sm[k];  // (L = 0: sample -1, the carried register)
    }
    if (t0 + kTile > 0) {
      const bool any = __syncthreads_or(bits != 0u);
      if (any || (g.la >= 0 && a.base + max(t0, 0) - g.la <= a.h)) {
        const int gn0 = a.base + n0;
        const ofdm::TileGate t = ofdm::tile_gate<kItems>(bits, any, gn0, g, a.h, s_scan);
        ofdm::fold_tile<kItems>(sl, cp, bits, gn0, t, a.base, a.track_end, a.h, a.E, tie_last,
                                g);
      }
    }
  };
  walk::minn_walk<T, kC, true>(a, b, -walk::round4(3 * a.Q), L, sink);
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
  const T* xs = (const T*)a.x + (size_t)b * (size_t)a.x_row;
  const size_t hplane = (size_t)a.batch * (size_t)H;
  for (int i = tid; i < a.C * H; i += kThreads) {
    const int c = i / H, j = i - c * H, n = L - H + j;  // -H <= n < L
    a.hist_out[(size_t)c * hplane + (size_t)b * H + j] =
        n >= 0 ? (float)xs[(size_t)c * (size_t)a.x_plane + (size_t)n]
               : a.hist[(size_t)c * hplane + (size_t)b * H + (size_t)(H + n)];
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
  a.hist_len = hist_len;
  a.base = (int)base;
  a.valid_from = (int)valid_from;
  a.h = h;
  a.E = E;
  a.tie_last = tie_last;
  a.Lg = Lg;
  a.track_end = std::min(Lg, base + L);
  a.ring = walk::round4(Q) + kTile;
  a.vin = ((uintptr_t)x % (is_i16 ? 8 : 16) == 0) && x_plane % 4 == 0 && x_row % 4 == 0;
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
