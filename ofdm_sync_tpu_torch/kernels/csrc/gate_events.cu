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
// What bounds it on the H100: per-stream latency.  The gate state of a
// sample depends on every earlier sample of its stream, so one CTA walks
// one stream in order; it reads 1 B/sample of `above` and the 4 B/sample
// track only in tiles that hold an above sample or an open gate.
//
// Design.  The TPU grid's sequential carry (last-above index, cluster count
// and the per-slot table, kept in VMEM scratch) becomes a loop over tiles
// inside the CTA with that state in shared memory.  Per tile: one
// __syncthreads_or decides whether the tile is quiet (skipped); otherwise a
// block max-scan of above indices gives the last above before every
// sample, a block sum-scan of new-cluster flags gives the cluster id, and
// each slot that occurs in the tile gets one block reduction of its start,
// last above and one (value, index) argmax, merged into the slot.  Peak
// capture: the TPU kernel copies the side channels whenever a slot's peak
// moves, so they always hold the values at the final peak index; here one
// gather at that index when the table is written gives the same values.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kMaxEvents = 128;
constexpr int kI32Max = 0x7fffffff;
constexpr int kMaxExtras = 3;

// up to kMaxExtras (batch, L) float channels read at each slot's peak into
// cap[(b * n + k) * E + slot]
struct Extras {
  const float* src[kMaxExtras];
  int n;
  float* cap;
};

// does (v2, i2) beat (v1, i1)?  one argmax for value and index together
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2,
                                      bool tie_last) {
  if (v2 > v1) return true;
  if (v2 == v1) return tie_last ? i2 > i1 : i2 < i1;
  return false;
}

__global__ void __launch_bounds__(kThreads) gate_events_kernel(
    const uint8_t* __restrict__ above, const float* __restrict__ track,
    long long L, int valid_from, int h, int E, int tie_last, int emit_unclosed,
    uint8_t* __restrict__ valid_out, uint8_t* __restrict__ closed_out,
    int* __restrict__ start_out, int* __restrict__ close_out,
    int* __restrict__ pidx_out, float* __restrict__ pval_out,
    int* __restrict__ count_out, uint8_t* __restrict__ overflow_out,
    Extras extras) {
  __shared__ int s_start[kMaxEvents], s_last[kMaxEvents], s_pidx[kMaxEvents];
  __shared__ float s_pval[kMaxEvents];
  __shared__ int s_carry_la, s_carry_cnt, s_cmin, s_cmax, s_count;
  __shared__ int s_scan[32];
  __shared__ int w_start[32], w_last[32], w_idx[32];
  __shared__ float w_val[32];

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const bool last = tie_last != 0;
  const uint8_t* ab = above + (size_t)b * (size_t)L;
  const float* tb = track + (size_t)b * (size_t)L;

  for (int s = threadIdx.x; s < E; s += blockDim.x) {
    s_start[s] = kI32Max;
    s_last[s] = -1;
    s_pidx[s] = last ? -1 : kI32Max;
    s_pval[s] = -CUDART_INF_F;
  }
  if (threadIdx.x == 0) {
    s_carry_la = -1;
    s_carry_cnt = 0;
    s_count = 0;
  }
  __syncthreads();

  for (long long t0 = 0; t0 < L; t0 += kTile) {
    const int base = (int)(t0 + (long long)threadIdx.x * kItems);
    unsigned abits = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int n = base + k;
      if (n < L && n >= valid_from && ab[n]) abits |= 1u << k;
    }
    const bool any = __syncthreads_or(abits != 0);
    const int carry_la = s_carry_la, carry_cnt = s_carry_cnt;
    const bool open = carry_la >= 0 && t0 - carry_la <= h;
    if (!any && !open) continue;  // quiet tile: no gate can change
    if (threadIdx.x == 0) {
      s_cmin = kI32Max;
      s_cmax = 0;
    }

    // last above before this thread's items, and the tile's last above
    int tmax = -1;
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (abits >> k & 1u) tmax = base + k;
    int tile_max;
    const int la0 =
        max(carry_la, ofdm::block_excl_int<true>(tmax, -1, s_scan, &tile_max));

    // new clusters: an above sample with no gate open before it
    unsigned newbits = 0;
    int nnew = 0, prev = la0;
    int la_k[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int n = base + k;
      if (abits >> k & 1u) {
        if (prev < 0 || n - prev > h) {
          newbits |= 1u << k;
          ++nnew;
        }
        prev = n;
      }
      la_k[k] = prev;
    }
    int tile_new;
    int cid = carry_cnt + ofdm::block_excl_int<false>(nnew, 0, s_scan, &tile_new);
    int cid_k[kItems];
    unsigned gatebits = 0;
    int cmin = kI32Max, cmax = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int n = base + k;
      if (newbits >> k & 1u) ++cid;
      cid_k[k] = cid;
      if (la_k[k] >= 0 && n - la_k[k] <= h && cid >= 1 && n < L) {
        gatebits |= 1u << k;
        cmin = min(cmin, cid);
        cmax = max(cmax, cid);
      }
    }
    if (gatebits) {
      atomicMin(&s_cmin, cmin);
      atomicMax(&s_cmax, cmax);
    }
    __syncthreads();
    const int lo = max(s_cmin, 1), hi = min(s_cmax, E);

    float tv[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      tv[k] = (gatebits >> k & 1u) ? tb[base + k] : 0.0f;

    for (int c = lo; c <= hi; ++c) {
      int bstart = kI32Max, blast = -1, bidx = last ? -1 : kI32Max;
      float bval = -CUDART_INF_F;
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        if (!(gatebits >> k & 1u) || cid_k[k] != c) continue;
        const int n = base + k;
        bstart = min(bstart, n);
        if (abits >> k & 1u) blast = n;
        if (better(bval, bidx, tv[k], n, last)) {
          bval = tv[k];
          bidx = n;
        }
      }
      for (int d = 16; d > 0; d >>= 1) {
        const int os = __shfl_down_sync(ofdm::kFull, bstart, d);
        const int ol = __shfl_down_sync(ofdm::kFull, blast, d);
        const float ov = __shfl_down_sync(ofdm::kFull, bval, d);
        const int oi = __shfl_down_sync(ofdm::kFull, bidx, d);
        bstart = min(bstart, os);
        blast = max(blast, ol);
        if (better(bval, bidx, ov, oi, last)) {
          bval = ov;
          bidx = oi;
        }
      }
      if (lane == 0) {
        w_start[warp] = bstart;
        w_last[warp] = blast;
        w_val[warp] = bval;
        w_idx[warp] = bidx;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        for (int w = 1; w < nw; ++w) {
          bstart = min(bstart, w_start[w]);
          blast = max(blast, w_last[w]);
          if (better(bval, bidx, w_val[w], w_idx[w], last)) {
            bval = w_val[w];
            bidx = w_idx[w];
          }
        }
        const int s = c - 1;
        s_start[s] = min(s_start[s], bstart);
        s_last[s] = max(s_last[s], blast);
        // later tiles come later in the stream: they win ties for "last"
        const float cur = s_pval[s];
        const bool take = last ? (bval > cur || (bval == cur && bval > -CUDART_INF_F))
                               : bval > cur;
        s_pval[s] = fmaxf(cur, bval);
        if (take) s_pidx[s] = bidx;
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      s_carry_la = max(carry_la, tile_max);
      s_carry_cnt = carry_cnt + tile_new;
    }
  }
  __syncthreads();

  const int total = s_carry_cnt;
  const int nexist = min(total, E);
  for (int s = threadIdx.x; s < E; s += blockDim.x) {
    const size_t o = (size_t)b * E + s;
    const bool exists = s < nexist;
    const long long close_raw = (long long)s_last[s] + h;
    const bool closed = exists && close_raw <= L - 1;
    const bool valid = exists && (closed || emit_unclosed);
    valid_out[o] = valid;
    closed_out[o] = closed;
    start_out[o] = exists ? s_start[s] : 0;
    close_out[o] = exists ? (int)min(max(close_raw, 0LL), L - 1) : 0;
    pidx_out[o] = exists ? s_pidx[s] : 0;
    pval_out[o] = exists ? s_pval[s] : 0.0f;
#pragma unroll
    for (int k = 0; k < kMaxExtras; ++k) {  // constant k: no local-memory array
      if (k >= extras.n) break;
      const int p = s_pidx[s];
      extras.cap[((size_t)b * extras.n + k) * E + s] =
          exists && p >= 0 && p < L ? extras.src[k][(size_t)b * (size_t)L + p] : 0.0f;
    }
    if (valid) atomicAdd(&s_count, 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    count_out[b] = s_count;
    overflow_out[b] = total > E;
  }
}

}  // namespace

// ex0..ex2: optional (batch, L) float channels captured at the peaks into
// cap (batch, n_extra, E); n_extra = 0 captures nothing.
extern "C" int gate_events_f32(const void* above, const void* track, int batch,
                               long long L, int valid_from, int h, int E,
                               int tie_last, int emit_unclosed, void* valid,
                               void* closed, void* start, void* close,
                               void* pidx, void* pval, void* count,
                               void* overflow, const void* ex0, const void* ex1,
                               const void* ex2, int n_extra, void* cap,
                               void* stream) {
  if (E < 1 || E > kMaxEvents) return (int)cudaErrorInvalidValue;
  if (n_extra < 0 || n_extra > kMaxExtras) return (int)cudaErrorInvalidValue;
  const Extras extras{{(const float*)ex0, (const float*)ex1, (const float*)ex2},
                      n_extra, (float*)cap};
  gate_events_kernel<<<batch, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)above, (const float*)track, L, valid_from, h, E,
      tie_last, emit_unclosed, (uint8_t*)valid, (uint8_t*)closed, (int*)start,
      (int*)close, (int*)pidx, (float*)pval, (int*)count, (uint8_t*)overflow,
      extras);
  return (int)cudaGetLastError();
}
