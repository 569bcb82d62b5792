// The Minn-RTL metric walk of kernel A's float path (minn_rtl_metric.cu)
// and kernel F (minn_rtl_step.cu): one CTA of 256 threads walks one stream
// from sample w0 to w1 in tiles of 1024, each thread holding 4 consecutive
// samples, and hands each tile's metric to the caller's sink.
//
// Per tile, with the next tile's loads in flight (one 16-byte load, int16:
// 8-byte, of 4 samples a plane where vin says every row is so aligned; the
// scalar path elsewhere, and at the stream's edges):
//   u[n] = sum_c x[c,n] * x[c,n-Q]    float32 products, summed over the planes
//   p[n] = sum_c x[c,n]^2              in float32 (int16 codes converted first)
//   cp[n] = max(sum_{2Q window} u, 0), e[n] = sum_{3Q window} p: float64
//       running sums, the tile's increments scanned with warp shuffles and
//       one exchange of warp totals through shared memory, rounded once
//   sm[n] = (1-alpha) sm[n-1] + alpha cp[n] [base+n >= valid_from], with
//       kScan: affine maps composed over the tile from the register entering
//       it; identities before js (the first sample whose 3Q window lies
//       after w0) and before n = -1, the constant carry_in at n = -1
// Samples before n = 0 read the right-aligned history (zero before it or
// without one), samples past L are zero.  The window sums and the register
// start from zero at w0 with the u/p rings zero, so a walk from 3Q before
// the first output (or from a halo before it, where the smoothing memory
// has decayed) gives them exactly.
//
// Rings in dynamic shared memory: C planes of x (round4(Q) + 1024 samples,
// sample n at n - w0 + round4(Q)), then u and p (round4(3Q) + 1024 each,
// sample n at n - w0 + round4(3Q)), indexed modulo their length; a tile's
// own stores are 16-byte aligned, the delayed reads x[n-Q], u[n-2Q] and
// p[n-3Q] where their offsets are multiples of 4.
//
// Block barriers a tile: after the ring stores, after the product stores
// where 2Q < 1024 (else the tails read are older tiles'), after the window
// scan, and with kScan after the map scan.  Every thread calls the sink on
// every tile, after those barriers, as sink(t0, n0, cp, e, sm): t0 the
// tile's first sample, n0 the thread's first, cp and e its 4 samples' metric
// and sm their registers (null without kScan).  The sink may hold block
// barriers of its own.
//
// The launch's arguments `a` give: x (C, batch, L) float32 or int16 at x +
// c * x_plane + b * x_row + n, hist (C, batch, hist_len) float32 or null,
// carry_in (batch,) or null, C, batch, L, Q, ring, ring_up (the ring
// lengths above), vin, alpha, base and valid_from.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"
#include "span_walk.cuh"

namespace ofdm {
namespace walk {

template <typename T, int kC, bool kScan, typename Args, typename Sink>
__device__ __forceinline__ void minn_walk(const Args& a, int b, int w0, int w1, Sink&& sink) {
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
  const int Q = a.Q, L = a.L;
  const int q4 = round4(Q), h3 = round4(3 * Q);
  const int js = w0 + 3 * Q - 1;  // first sample whose 3Q window lies after w0
  const size_t plane = (size_t)a.x_plane;
  const T* xs = (const T*)a.x + (size_t)b * (size_t)a.x_row;
  const float* hs = a.hist ? a.hist + (size_t)b * (size_t)a.hist_len : nullptr;
  const size_t hplane = (size_t)a.batch * (size_t)a.hist_len;
  const float decay = 1.0f - a.alpha;
  const float carry0 = a.carry_in ? a.carry_in[b] : 0.0f;

  // sample n of plane c: the stream, the history before it, zero elsewhere
  auto ld = [&](int c, int n) -> float {
    if (n >= 0) return n < L ? (float)xs[(size_t)c * plane + (size_t)n] : 0.0f;
    if (hs && n >= -a.hist_len) return hs[(size_t)c * hplane + (size_t)(a.hist_len + n)];
    return 0.0f;
  };
  auto fast = [&](int n0) { return a.vin && n0 >= 0 && n0 + kItems <= L; };

  // prologue: x[w0 - Q, w0) into the ring, the u/p rings zero
  for (int i = tid; i < Q; i += kThreads)
    for (int c = 0; c < a.C; ++c) xr[c * a.ring + q4 - Q + i] = ld(c, w0 - Q + i);
  for (int i = tid; i < a.ring_up; i += kThreads) {
    ur[i] = 0.0f;
    pr[i] = 0.0f;
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
      if (c < a.C)
        nx[c] = __ldg(reinterpret_cast<const typename R4::type*>(xs + c * plane + w0 +
                                                                 kItems * tid));
  }

  int parity = 0;
  for (int t0 = w0; t0 < w1; t0 += kTile, parity ^= 1) {
    const int n0 = t0 + kItems * tid;
    // 1. this tile's samples into the ring, the next tile's loads issued
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (c >= a.C) break;
      const float4 v = nf ? R4::f(nx[c])
                          : make_float4(ld(c, n0), ld(c, n0 + 1), ld(c, n0 + 2), ld(c, n0 + 3));
      ring_st(xr + c * a.ring, ix_w, v);
    }
    nf = t0 + kTile < w1 && fast(n0 + kTile);
    if (nf) {
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (c < a.C)
          nx[c] = __ldg(reinterpret_cast<const typename R4::type*>(xs + c * plane + n0 +
                                                                   kTile));
    }
    __syncthreads();

    // 2. quarter products and powers, summed over the planes in f32
    float u[kItems] = {0.0f, 0.0f, 0.0f, 0.0f}, pw[kItems] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      if (c >= a.C) break;
      const float4 v = ring_ld(xr + c * a.ring, ix_w, a.ring, true);
      const float4 vd = ring_ld(xr + c * a.ring, ix_d, a.ring, al_d);
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        u[k] = __fadd_rn(u[k], __fmul_rn(get(v, k), get(vd, k)));
        pw[k] = __fadd_rn(pw[k], __fmul_rn(get(v, k), get(v, k)));
      }
    }
    ring_st(ur, iu_w, make_float4(u[0], u[1], u[2], u[3]));
    ring_st(pr, iu_w, make_float4(pw[0], pw[1], pw[2], pw[3]));
    if (2 * Q < kTile) __syncthreads();  // else the tails read below are older tiles'

    // 3. window sums: float64 increments, scanned over the tile
    const float4 u2 = ring_ld(ur, iu_2, a.ring_up, al_2);
    const float4 p3 = ring_ld(pr, iu_3, a.ring_up, al_3);
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
      const double2 o = shfl_up2(inc, d);
      if (lane >= d) inc = add2(o, inc);
    }
    double2 exc = shfl_up2(inc, 1);
    if (lane == 0) exc = make_double2(0.0, 0.0);
    if (lane == 31) s_wsum[warp] = inc;
    __syncthreads();
    double2 before = make_double2(0.0, 0.0);
#pragma unroll
    for (int w = 0; w < kWarps - 1; ++w)
      if (w < warp) before = add2(before, s_wsum[w]);
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

    // 4. the smoothing recurrence: affine maps composed over the tile
    float sm[kItems];
    if constexpr (kScan) {
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
        seg = compose(seg, m[k]);
      }
      float2 minc = seg;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float2 o = shfl_up_f2(minc, d);
        if (lane >= d) minc = compose(o, minc);
      }
      float2 mexc = shfl_up_f2(minc, 1);
      if (lane == 0) mexc = make_float2(1.0f, 0.0f);
      if (lane == 31) s_wmap[warp] = minc;
      __syncthreads();
      float s = s_reg[parity];
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (w < warp) s = fmaf(s_wmap[w].x, s, s_wmap[w].y);
      s = fmaf(mexc.x, s, mexc.y);
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        s = fmaf(m[k].x, s, m[k].y);
        sm[k] = s;
      }
      if (tid == kThreads - 1) s_reg[parity ^ 1] = s;  // the register after the tile
    }
    sink(t0, n0, cp, e, kScan ? sm : nullptr);

    ix_w = ring_next(ix_w, a.ring);
    ix_d = ring_next(ix_d, a.ring);
    iu_w = ring_next(iu_w, a.ring_up);
    iu_2 = ring_next(iu_2, a.ring_up);
    iu_3 = ring_next(iu_3, a.ring_up);
  }
}

}  // namespace walk
}  // namespace ofdm
