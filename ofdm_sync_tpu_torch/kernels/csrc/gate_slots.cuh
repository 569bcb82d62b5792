// The gate walk shared by kernel B (gate_events.cu) and kernel F
// (minn_rtl_step.cu): one tile of a stream, each thread holding kItems
// consecutive samples, folded into the stream's event slots.
//
// The gate state entering a sample is the pair (last-above global index,
// clusters so far); an above sample starts a cluster where the gap to the
// last above exceeds h, and a sample is gated while it lies within h of
// the last above.  Each slot holds one cluster: its first gated sample
// (atomicMin), its last above sample (atomicMax) and its peak as one
// 64-bit key (order-preserving value bits, index) merged by atomicMax --
// index for tie "last", INT_MAX - index for "first"; -0.0 is keyed as
// +0.0, since the float compare holds them equal.  Clusters past E own no
// slot.  All threads of the block call tile_gate (it holds block scans,
// see block_scan.cuh).
#pragma once

#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace ofdm {

constexpr int kNoStart = 0x7fffffff;

struct Gate {
  int la, cnt;
};

__device__ __forceinline__ unsigned long long peak_key(float v, int n, bool tie_last) {
  unsigned u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;  // -0.0 -> +0.0
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  const unsigned i = tie_last ? (unsigned)n : (unsigned)(kNoStart - n);
  return ((unsigned long long)ord << 32) | i;
}

__device__ __forceinline__ int key_index(unsigned long long key, bool tie_last) {
  const int i = (int)(unsigned)(key & 0xffffffffull);
  return tie_last ? i : kNoStart - i;
}

// the value a key was made from (a -0.0 comes back as +0.0)
__device__ __forceinline__ float key_value(unsigned long long key) {
  const unsigned ord = (unsigned)(key >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

__device__ __forceinline__ int last_bit_index(unsigned bits, int n0) {
  return bits ? n0 + 31 - __clz(bits) : -1;
}

struct Slots {
  int* start;
  int* last;
  unsigned long long* key;
};

__device__ __forceinline__ void flush(const Slots& sl, int c, int E, int start, int last,
                                      unsigned long long key) {
  if (c < 1 || c > E) return;  // clusters past E own no slot
  const int s = c - 1;
  if (start != kNoStart) atomicMin(&sl.start[s], start);
  if (last >= 0) atomicMax(&sl.last[s], last);
  if (key) atomicMax(&sl.key[s], key);
}

// the gate state at a thread's first sample, and the tile's totals
struct TileGate {
  int la0, cid, tile_max, tile_new;
};

// bits: bit k set where global sample n0 + k is an above sample of the
// gate.  any: some thread of the block has a bit set (else no scan).
template <int kItems>
__device__ __forceinline__ TileGate tile_gate(unsigned bits, bool any, int n0, const Gate& g,
                                              int h, int* s_scan) {
  TileGate t{g.la, g.cnt, -1, 0};
  if (any) {
    t.la0 = max(g.la, block_excl_int<true>(last_bit_index(bits, n0), -1, s_scan, &t.tile_max));
    int nnew = 0, prev = t.la0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (!(bits >> k & 1u)) continue;
      if (prev < 0 || n0 + k - prev > h) ++nnew;
      prev = n0 + k;
    }
    t.cid = g.cnt + block_excl_int<false>(nnew, 0, s_scan, &t.tile_new);
  }
  return t;
}

// fold the thread's gated samples (global index in [lo, hi)) into one
// aggregate per cluster met, in sample order; the last aggregate of each
// lane is merged over the warp when every lane that holds one holds the
// same cluster.  tv[k] is read only at gated samples.  Then the gate state
// after the tile.
template <int kItems>
__device__ __forceinline__ void fold_tile(const Slots& sl, const float (&tv)[kItems],
                                          unsigned bits, int n0, const TileGate& t, int lo,
                                          long long hi, int h, int E, bool tie_last, Gate& g) {
  int cid = t.cid, cur = 0, a_start = kNoStart, a_last = -1, prev = t.la0;
  unsigned long long a_key = 0ull;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int n = n0 + k;
    const bool is_above = bits >> k & 1u;
    if (is_above) {
      if (prev < 0 || n - prev > h) ++cid;
      prev = n;
    }
    if (prev >= 0 && n - prev <= h && cid >= 1 && n >= lo && n < hi) {
      if (cid != cur) {
        if (cur) flush(sl, cur, E, a_start, a_last, a_key);
        cur = cid;
        a_start = n;
        a_last = -1;
        a_key = 0ull;
      }
      if (is_above) a_last = n;
      a_key = max(a_key, peak_key(tv[k], n, tie_last));
    }
  }
  const int cref = __reduce_max_sync(kFull, cur);
  if (__all_sync(kFull, cur == 0 || cur == cref)) {
    if (cref) {
      const int ws = __reduce_min_sync(kFull, a_start);
      const int wl = __reduce_max_sync(kFull, a_last);
      unsigned long long wk = a_key;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) wk = max(wk, __shfl_xor_sync(kFull, wk, d));
      if ((threadIdx.x & 31) == 0) flush(sl, cref, E, ws, wl, wk);
    }
  } else if (cur) {
    flush(sl, cur, E, a_start, a_last, a_key);
  }
  g.la = max(g.la, t.tile_max);
  g.cnt += t.tile_new;
}

}  // namespace ofdm
