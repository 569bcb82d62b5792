// Kernel B of the fused detectors: gate / hysteresis / peak events.
//
// Replaces (TPU): the event machinery that ofdm_sync_tpu/kernels/
// pallas_minn_tm.py:_tm_kernel runs on every grid step
// (pallas_tm_common.py:event_update / event_finalize, and the lane-major
// pallas_common.py:event_update / event_finalize of pallas_minn.py:
// _detect_kernel), and the event half of pallas_aa.py:_aa_kernel, which
// also captures side channels (P_re, P_im, M) at each slot's peak
// (pallas_common.py:event_update `extras`, event_finalize lines 418-419).
// Semantics are those of ops/detect.py:extract_gate_events:
// a gate opens at an above sample and closes at the h-th consecutive below
// sample; gates are clusters of above runs with gaps <= h; the peak is the
// (value, index) argmax of the tracked value over [gate_start, close] with
// tie rule "last" (latest maximum) or "first"; at most E <= 128 slots are
// recorded, `count` counts valid slots and `overflow` says more gates
// occurred than E.
//
// Carried-state modes (pallas_minn.py:_detect_kernel and its AA / ZC twins
// with base_index / stream_len_global / shard_init / emit_state): sample n
// of the call has the global index base + n, and every index in the table
// is global; Lg (stream_len_global, else L) replaces L in the close rule
// (closed iff last_above + h <= Lg - 1, close clipped to [0, Lg - 1],
// pallas_common.py:404-415) and masks above samples at or past it; peaks
// are tracked below min(Lg, base + L) (pallas_minn.py:529-530).  gate_init
// (batch, 2) int32 = [last-above global index, cluster count] primes the
// gate state (pallas_minn.py:479-497), so a carried gate continues in its
// cluster's slot and new ones count on from it; gate_out (batch, 2) =
// [last-above, cluster count] is the state after the last sample
// (pallas_common.py:379-389), the carry of the next chunk.
//
// What bounds it on the H100: HBM bytes.  It reads 1 B/sample of `above`
// and 4 B of `track` (and each captured channel) only at gated samples;
// the table is small.
//
// Design: span-parallel.  The gate state entering any sample is the pair
// (last-above index, cluster count).  A span's effect on that pair depends
// only on its first above index, its last above index and its number of
// cluster starts counted from inside the span (gaps > h), and these
// effects compose associatively.  So each stream is cut into spans of
// whole 4096-sample tiles, one CTA each:
//   1. gate_summary_kernel reads its span's `above` with 16-byte loads, the
//      next kGroup tiles in flight while kGroup are scanned, and writes the
//      span's summary (first, last, starts, and a mask of the tiles that
//      hold an above sample);
//   2. gate_events_kernel composes the summaries of the spans before its
//      own (a block scan of the pair, offset by gate_init) into the pair
//      entering its span, walks only the tiles that hold an above sample or
//      that an open gate reaches (so a gate that ends in the next span, or
//      an h larger than a span, is tracked there), and merges each cluster
//      it saw into the stream's slot table in global memory: start by
//      atomicMin, last above by atomicMax, the peak by one 64-bit atomicMax
//      on a key (order-preserving value bits, index) -- index for tie
//      "last", INT_MAX - index for "first"; -0.0 is keyed as +0.0, since
//      the float compare holds them equal.  The CTA that finishes last
//      writes the table (the Lg rule, the count, overflow, gate_out and the
//      captured channels at the peak index).
// Where batch alone fills the card, or a stream is short, each stream is
// one span: gate_events_kernel alone walks it from gate_init, with the
// slots in shared memory, the next kWalkGroup tiles in flight while
// kWalkGroup are walked.  A tile without a nonzero byte costs one
// __syncthreads_or.  In a tile that holds an above sample a block max-scan
// gives the last above before every sample and a sum-scan the cluster id;
// each thread reads its 16 track values together where one may be gated,
// folds its gated samples into one aggregate per cluster, and a warp whose
// lanes all hold the same cluster merges them before one shared atomic per
// field (the tile walk and the slots: gate_slots.cuh, which kernel F's
// stream step shares).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

#include "block_scan.cuh"
#include "gate_slots.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // one 16-byte load of `above` per thread and tile
constexpr int kTile = kThreads * kItems;
constexpr int kGroup = 4;          // tiles loaded together by the summary kernel
constexpr int kWalkGroup = 2;      // ... and by the walk kernel (registers for walk_tile)
constexpr int kMinBlocks = 4;      // CTAs per SM: at most 64 registers a thread
constexpr int kMaxSpanTiles = 32;  // the summary's tile mask
constexpr int kMinSpanTiles = 4;   // a shorter span costs more than it saves
constexpr int kMaxEvents = 128;
constexpr int kI32Max = 0x7fffffff;
constexpr int kMaxExtras = 3;

struct Params {
  const uint8_t* above;  // (batch, L) bool
  const float* track;    // (batch, L)
  int L, valid_from, h, E, tie_last, emit_unclosed;
  int vec;  // 16-byte rows: vector loads of above and track
  // carried state: global index of sample 0, global length of the close
  // rule, end of peak tracking, (batch, 2) gate carry in / out or null
  int base;
  long long Lg, track_end;
  const int* gate_init;
  int* gate_out;
  // the table (batch, E) and per stream (batch,)
  uint8_t *valid, *closed, *overflow;
  int *start, *close, *pidx, *count;
  float* pval;
  // up to kMaxExtras (batch, L) channels read at each slot's peak into
  // cap[(b * n_extra + k) * E + slot]
  const float* extra[kMaxExtras];
  int n_extra;
  float* cap;
  // the span-parallel mode: S spans of `span` samples per stream
  int S, span;
  int4* sums;                   // (batch, S): first, last, starts, tile mask
  int *g_start, *g_last;        // (batch, E) merged slots
  unsigned long long* g_key;    // (batch, E)
  int* done;                    // (batch,) spans finished
};

using ofdm::Gate;
using ofdm::key_index;
using ofdm::last_bit_index;
using ofdm::Slots;

// the 16 bytes of `above` at local index lb: one vector load inside the
// stream, byte loads (zero past L) at its ragged end
__device__ __forceinline__ uint4 load_above(const uint8_t* ab, int lb, const Params& p) {
  if (p.vec && lb + kItems <= p.L) return __ldg(reinterpret_cast<const uint4*>(ab + lb));
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (lb + k < p.L && ab[lb + k]) w[k >> 2] |= 1u << (8 * (k & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bit k: sample n0 + k (global) is an above sample of the gate
__device__ __forceinline__ unsigned above_bits(uint4 v, int n0, const Params& p) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned bits = 0u;
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if ((w[k >> 2] >> (8 * (k & 3))) & 0xffu) bits |= 1u << k;
  if (n0 < p.valid_from || (long long)n0 + kItems > p.Lg) {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (n0 + k < p.valid_from || (long long)n0 + k >= p.Lg) bits &= ~(1u << k);
  }
  return bits;
}

// the G tiles from local index g0 (zero at and past l1)
template <int G>
__device__ __forceinline__ void load_group(uint4 (&r)[G], const uint8_t* ab, int g0, int l1,
                                           const Params& p) {
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int lb = g0 + j * kTile + kItems * threadIdx.x;
    r[j] = lb < l1 ? load_above(ab, lb, p) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// any nonzero byte: a superset of the above samples (before the masks)
__device__ __forceinline__ bool any_byte(uint4 v) { return (v.x | v.y | v.z | v.w) != 0u; }

// ---- 1. span summaries ------------------------------------------------------

__global__ void __launch_bounds__(kThreads, kMinBlocks) gate_summary_kernel(const Params p) {
  __shared__ int s_scan[32];
  __shared__ int s_first, s_starts;
  const int tid = threadIdx.x, lane = tid & 31;
  const int b = blockIdx.x / p.S, sp = blockIdx.x % p.S;
  if (sp == 0) {  // the stream's merged slots start empty
    for (int s = tid; s < p.E; s += kThreads) {
      const size_t o = (size_t)b * p.E + s;
      p.g_start[o] = kI32Max;
      p.g_last[o] = -1;
      p.g_key[o] = 0ull;
    }
    if (tid == 0) p.done[b] = 0;
  }
  if (tid == 0) {
    s_first = kI32Max;
    s_starts = 0;
  }
  __syncthreads();
  const uint8_t* ab = p.above + (size_t)b * p.L;
  const int l0 = sp * p.span, l1 = min(l0 + p.span, p.L);
  int run_la = -1, starts = 0, first = kI32Max;
  unsigned tiles = 0u;
  uint4 cur[kGroup], nxt[kGroup];
  load_group(nxt, ab, l0, l1, p);
  for (int g0 = l0; g0 < l1; g0 += kGroup * kTile) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) cur[j] = nxt[j];
    if (g0 + kGroup * kTile < l1) load_group(nxt, ab, g0 + kGroup * kTile, l1, p);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (!__syncthreads_or(any_byte(cur[j]))) continue;
      const int n0 = p.base + g0 + j * kTile + kItems * tid;
      const unsigned bits = above_bits(cur[j], n0, p);
      tiles |= 1u << ((g0 - l0) / kTile + j);
      int tile_max;
      int prev = max(run_la,
                     ofdm::block_excl_int<true>(last_bit_index(bits, n0), -1, s_scan, &tile_max));
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (!(bits >> k & 1u)) continue;
        const int n = n0 + k;
        if (prev < 0 || n - prev > p.h) ++starts;
        first = min(first, n);
        prev = n;
      }
      run_la = max(run_la, tile_max);
    }
  }
  const int wf = __reduce_min_sync(ofdm::kFull, first);
  const int ws = __reduce_add_sync(ofdm::kFull, starts);
  if (lane == 0) {
    atomicMin(&s_first, wf);
    atomicAdd(&s_starts, ws);
  }
  __syncthreads();
  if (tid == 0)
    p.sums[blockIdx.x] =
        make_int4(s_first == kI32Max ? -1 : s_first, run_la, s_starts, (int)tiles);
}

// ---- 2. the walk, the merge, the table -------------------------------------

// one tile that holds an above sample (any) or that an open gate reaches:
// fold each gated sample into its cluster's slot and advance the gate
__device__ __forceinline__ void walk_tile(const Params& p, const float* tb, int lb, unsigned bits,
                                          bool any, Gate& g, int* s_scan, const Slots& sl) {
  const int n0 = p.base + lb;
  const ofdm::TileGate t = ofdm::tile_gate<kItems>(bits, any, n0, g, p.h, s_scan);
  // the thread's track values, loaded together where a sample may be gated
  // (an above sample among them, or the gate open at the first)
  float tv[kItems];
  if ((bits || (t.la0 >= 0 && n0 - t.la0 <= p.h)) && n0 < p.track_end) {
    if (p.vec && lb + kItems <= p.L) {
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(tb + lb) + q);
        tv[4 * q] = v.x;
        tv[4 * q + 1] = v.y;
        tv[4 * q + 2] = v.z;
        tv[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kItems; ++k) tv[k] = lb + k < p.L ? tb[lb + k] : 0.0f;
    }
  }
  ofdm::fold_tile<kItems>(sl, tv, bits, n0, t, p.base, p.track_end, p.h, p.E, p.tie_last != 0,
                          g);
}

// the table of stream b from its slots and the gate state after its end
__device__ void write_table(const Params& p, int b, Gate total, const int* st, const int* la,
                            const unsigned long long* ky) {
  const int tid = threadIdx.x;
  const bool tie_last = p.tie_last != 0;
  const int nexist = p.L > 0 ? min(total.cnt, p.E) : 0;
  bool valid = false;
  if (tid < p.E) {
    const int s = tid;
    const size_t o = (size_t)b * p.E + s;
    const bool exists = s < nexist;
    const long long close_raw = (long long)la[s] + p.h;
    const bool closed = exists && close_raw <= p.Lg - 1;
    valid = exists && (closed || p.emit_unclosed);
    int pidx = tie_last ? -1 : kI32Max;
    float pval = -CUDART_INF_F;
    if (ky[s]) {
      pidx = key_index(ky[s], tie_last);
      pval = p.track[(size_t)b * p.L + (pidx - p.base)];  // the value itself, -0.0 kept
    }
    p.valid[o] = valid;
    p.closed[o] = closed;
    p.start[o] = exists ? st[s] : 0;
    p.close[o] = exists ? (int)min(max(close_raw, 0LL), p.Lg - 1) : 0;
    p.pidx[o] = exists ? pidx : 0;
    p.pval[o] = exists ? pval : 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxExtras; ++k) {  // constant k: no local-memory array
      if (k >= p.n_extra) break;
      const long long lp = (long long)pidx - p.base;  // local index
      p.cap[((size_t)b * p.n_extra + k) * p.E + s] =
          exists && lp >= 0 && lp < p.L ? p.extra[k][(size_t)b * p.L + lp] : 0.0f;
    }
  }
  const int count = __syncthreads_count(valid);
  if (tid == 0) {
    p.count[b] = count;
    p.overflow[b] = p.L > 0 && total.cnt > p.E;
    if (p.gate_out) {
      p.gate_out[2 * b] = total.la;
      p.gate_out[2 * b + 1] = total.cnt;
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) gate_events_kernel(const Params p) {
  __shared__ int s_start[kMaxEvents], s_last[kMaxEvents];
  __shared__ unsigned long long s_key[kMaxEvents];
  __shared__ int s_scan[32];
  __shared__ int s_in[3];
  __shared__ int s_is_last;
  const int tid = threadIdx.x;
  const int S = p.S;
  const int b = blockIdx.x / S, sp = blockIdx.x % S;
  const Slots sl{s_start, s_last, s_key};
  for (int s = tid; s < p.E; s += kThreads) {
    s_start[s] = kI32Max;
    s_last[s] = -1;
    s_key[s] = 0ull;
  }
  Gate g{p.gate_init ? p.gate_init[2 * b] : -1, p.gate_init ? p.gate_init[2 * b + 1] : 0};
  Gate total = g;
  unsigned mask = ~0u;
  if (S > 1) {
    // the pair entering each span: the summaries composed in stream order
    const int4* sums = p.sums + (size_t)b * S;
    for (int j0 = 0; j0 < S; j0 += kThreads) {
      const int j = j0 + tid;
      const int4 sm = j < S ? sums[j] : make_int4(-1, -1, 0, 0);
      int tmax, tinc;
      const int la_ex = max(total.la, ofdm::block_excl_int<true>(sm.y, -1, s_scan, &tmax));
      const int inc = sm.x < 0 ? 0 : sm.z - 1 + ((la_ex < 0 || sm.x - la_ex > p.h) ? 1 : 0);
      const int cnt_ex = total.cnt + ofdm::block_excl_int<false>(inc, 0, s_scan, &tinc);
      if (j == sp) {
        s_in[0] = la_ex;
        s_in[1] = cnt_ex;
        s_in[2] = sm.w;
      }
      total.la = max(total.la, tmax);
      total.cnt += tinc;
    }
  }
  __syncthreads();
  if (S > 1) {
    g = Gate{s_in[0], s_in[1]};
    mask = (unsigned)s_in[2];
  }

  const uint8_t* ab = p.above + (size_t)b * p.L;
  const float* tb = p.track + (size_t)b * p.L;
  const int l0 = sp * p.span, l1 = min(l0 + p.span, p.L);
  // a group is walked where it holds an above sample (every group of a
  // lone span) or the gate is open at its start; the next group's loads are
  // in flight while this one is walked, where it is already known to be
  // wanted (the gate only reaches further while a group is walked)
  auto wanted = [&](int g0) {
    return S == 1 || ((mask >> ((g0 - l0) / kTile)) & ((1u << kWalkGroup) - 1u)) ||
           (g.la >= 0 && p.base + g0 - g.la <= p.h);
  };
  uint4 cur[kWalkGroup], nxt[kWalkGroup];
  bool have = wanted(l0);
  if (have) load_group(nxt, ab, l0, l1, p);
  for (int g0 = l0; g0 < l1; g0 += kWalkGroup * kTile) {
    if (!have && !wanted(g0)) continue;  // quiet, gate shut
    if (have) {
#pragma unroll
      for (int j = 0; j < kWalkGroup; ++j) cur[j] = nxt[j];
    } else {
      load_group(cur, ab, g0, l1, p);
    }
    const int gn = g0 + kWalkGroup * kTile;
    have = gn < l1 && wanted(gn);
    if (have) load_group(nxt, ab, gn, l1, p);
#pragma unroll
    for (int j = 0; j < kWalkGroup; ++j) {
      const int tile0 = g0 + j * kTile;
      if (tile0 >= l1) break;
      const bool any = __syncthreads_or(any_byte(cur[j]));
      if (!any && !(g.la >= 0 && p.base + tile0 - g.la <= p.h)) continue;
      const int lb = tile0 + kItems * tid;
      walk_tile(p, tb, lb, above_bits(cur[j], p.base + lb, p), any, g, s_scan, sl);
    }
  }
  __syncthreads();
  if (S == 1) {
    write_table(p, b, g, s_start, s_last, s_key);
    return;
  }

  // merge this span's slots into the stream's; the last span writes the table
  for (int s = tid; s < p.E; s += kThreads) {
    const Slots gl{p.g_start + (size_t)b * p.E, p.g_last + (size_t)b * p.E,
                   p.g_key + (size_t)b * p.E};
    if (s_start[s] != kI32Max) atomicMin(&gl.start[s], s_start[s]);
    if (s_last[s] >= 0) atomicMax(&gl.last[s], s_last[s]);
    if (s_key[s]) atomicMax(&gl.key[s], s_key[s]);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_is_last = atomicAdd(&p.done[b], 1) == S - 1;
  __syncthreads();
  if (!s_is_last) return;
  __threadfence();
  for (int s = tid; s < p.E; s += kThreads) {
    const size_t o = (size_t)b * p.E + s;
    s_start[s] = __ldcg(&p.g_start[o]);
    s_last[s] = __ldcg(&p.g_last[o]);
    s_key[s] = __ldcg(&p.g_key[o]);
  }
  __syncthreads();
  write_table(p, b, total, s_start, s_last, s_key);
}

// spans per stream: one where batch alone fills the card or the stream is
// short, else enough for one wave, each span at least kMinSpanTiles and at
// most kMaxSpanTiles tiles long
int choose_spans(int batch, int L, int cap) {
  static int slots = 0;
  if (!slots) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, gate_events_kernel, kThreads, 0);
    slots = std::max(sms * per, 1);
  }
  const int tiles = (L + kTile - 1) / kTile;
  int S = std::min({std::max(slots / std::max(batch, 1), 1), tiles / kMinSpanTiles, cap});
  if (S <= 1) return 1;
  S = std::max(S, (tiles + kMaxSpanTiles - 1) / kMaxSpanTiles);
  if (S > cap) return 1;
  const int span_tiles = (tiles + S - 1) / S;
  return (tiles + span_tiles - 1) / span_tiles;
}

}  // namespace

// above (batch, L) bool, track (batch, L) float32 -> the table (valid,
// closed (batch, E) uint8; start, close, pidx (batch, E) int32; pval
// (batch, E) float32; count (batch,) int32; overflow (batch,) uint8).
// ex0..ex2: optional (batch, L) float channels captured at the peaks into
// cap (batch, n_extra, E); n_extra = 0 captures nothing.  base, Lg,
// gate_init, gate_out: the carried-state mode (see the top of the file);
// base = 0, Lg = L and two null pointers give the plain mode.  scratch:
// span_cap * 16 + E * 16 + 4 bytes per stream, 16-byte aligned, with
// span_cap >= ceil(L / 4096); the kernels initialise it.  The caller keeps
// base + L and Lg below 2^31.
extern "C" int gate_events_f32(const void* above, const void* track, int batch, long long L,
                               int valid_from, int h, int E, int tie_last, int emit_unclosed,
                               void* valid, void* closed, void* start, void* close, void* pidx,
                               void* pval, void* count, void* overflow, const void* ex0,
                               const void* ex1, const void* ex2, int n_extra, void* cap,
                               int base, long long Lg, const void* gate_init, void* gate_out,
                               void* scratch, int span_cap, void* stream) {
  if (E < 1 || E > kMaxEvents) return (int)cudaErrorInvalidValue;
  if (n_extra < 0 || n_extra > kMaxExtras) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  Params p{};
  p.above = (const uint8_t*)above;
  p.track = (const float*)track;
  p.L = (int)L;
  p.valid_from = valid_from;
  p.h = h;
  p.E = E;
  p.tie_last = tie_last;
  p.emit_unclosed = emit_unclosed;
  p.vec = (L % 16 == 0) && ((uintptr_t)above % 16 == 0) && ((uintptr_t)track % 16 == 0);
  p.base = base;
  p.Lg = Lg;
  p.track_end = std::min(Lg, (long long)base + L);
  p.gate_init = (const int*)gate_init;
  p.gate_out = (int*)gate_out;
  p.valid = (uint8_t*)valid;
  p.closed = (uint8_t*)closed;
  p.overflow = (uint8_t*)overflow;
  p.start = (int*)start;
  p.close = (int*)close;
  p.pidx = (int*)pidx;
  p.count = (int*)count;
  p.pval = (float*)pval;
  p.extra[0] = (const float*)ex0;
  p.extra[1] = (const float*)ex1;
  p.extra[2] = (const float*)ex2;
  p.n_extra = n_extra;
  p.cap = (float*)cap;
  p.S = choose_spans(batch, p.L, span_cap);
  const int tiles = std::max((p.L + kTile - 1) / kTile, 1);
  p.span = ((tiles + p.S - 1) / p.S) * kTile;
  char* scr = (char*)scratch;
  p.sums = (int4*)scr;
  scr += (size_t)batch * span_cap * sizeof(int4);
  p.g_key = (unsigned long long*)scr;
  scr += (size_t)batch * E * sizeof(unsigned long long);
  p.g_start = (int*)scr;
  scr += (size_t)batch * E * sizeof(int);
  p.g_last = (int*)scr;
  scr += (size_t)batch * E * sizeof(int);
  p.done = (int*)scr;
  const unsigned grid = (unsigned)batch * (unsigned)p.S;
  if (p.S > 1)
    gate_summary_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  gate_events_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
