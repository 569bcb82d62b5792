// Kernel E: the matched filter, a full linear convolution of planar complex
// streams with up to 2049 complex taps, as an overlap-save FFT convolution
// fused in one kernel.
//
// Replaces (TPU): ofdm_sync_tpu/kernels/pallas_mf.py:137 _mf_kernel (#10,
// matched_filter_mxu).  For each complex stream s (planes 2p, 2p+1 of the
// (C, batch, L) input, batch entry b) it computes
//   y[m] = sum_{t < T} x[m - t] h[t],   m < Lout (Lout = L + T - 1 as a rule)
// with x = 0 outside [0, L), and writes the planar (C, batch, Lout) result,
// exactly 0 for m >= L + T - 1.
//
// What bounds it on the H100: its instruction issue.  Its bytes (each
// 8192-point block read once, 6144 outputs of it written once: 361 + 270 MB
// at 64 x 262,144 x 2 streams, 0.19 ms at 3.35 TB/s) and its instructions
// (2,344 SASS instructions a thread a block, 1,676 of them FP32: ~0.2 ms of
// issue on 132 SMs at full rate) are close; the transforms need 128
// registers a thread, so one 512-thread CTA runs a SM, and its 16 warps
// issue at about half the rate.  The design keeps every transform in
// registers and shared memory in FP32, with one HBM read of each block and
// one HBM write of its valid outputs.  The TPU kernel ran its DFTs as MXU
// matmuls because its FFT lowering does not reach the matrix unit; here a
// radix-16 FFT in FP32 needs no matrix unit and stays within 3e-7 of the
// output peak, where a TF32 or BF16 DFT stage would add error (the three
// precision modes of the wrapper all run this kernel).
//
// Design.  Block k of a stream covers outputs [kV, kV + V), V = 8192 - 2048:
// it reads the 8192 input samples [kV - 2048, kV + V) from HBM (zero outside
// the stream), so the fixed 2048-sample discard covers every T <= 2049 and
// no state crosses blocks; every block is independent, and a CTA walks `nb`
// blocks of one stream in order.  512 threads hold 16 points each.  The
// forward FFT is decimation in frequency (natural order in, digit-reversed
// out): three radix-16 passes in registers with twiddles from a float32
// table (computed in float64 on the host; at most two products on top of a
// table value), exchanged through padded shared memory (n + n/16: no bank
// conflict in any pass; passes 2 and 3 exchange within a warp), then a
// radix-2 pass across neighbouring lanes by warp shuffles.  The pointwise
// product with the taps spectrum H (FFT of the taps, / 8192, computed by
// the wrapper in complex128 and stored in the order the passes leave the
// points in: slot k of thread t at 512 k + t) is taken in registers, and the
// inverse runs the same passes transposed (decimation in time, conjugate
// twiddles), so neither transform needs a reorder pass and the passes need
// four exchanges through shared memory in all.  Discarded outputs are the
// first 2048 of the block: whole register slots, never stored.
#include <cuda_runtime.h>

namespace {

constexpr int kF = 8192;              // block transform size
constexpr int kThreads = kF / 16;     // 16 points a thread
constexpr int kDiscard = 2048;        // overlap of consecutive blocks
constexpr int kValid = kF - kDiscard;  // outputs a block
constexpr int kMaxTaps = kDiscard + 1;
constexpr int kSmem = (kF + kF / 16) * 8;  // one padded buffer of float2

__device__ __forceinline__ float2 operator+(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 operator-(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
// a * b, and a * conj(b)
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 cmulc(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, a.y * b.y), fmaf(a.y, b.x, -a.x * b.y));
}
template <bool kConj>
__device__ __forceinline__ float2 tmul(float2 a, float2 w) {
  return kConj ? cmulc(a, w) : cmul(a, w);
}
// a * (S i): S = -1 forward, +1 inverse
template <int S>
__device__ __forceinline__ float2 mul_si(float2 a) {
  return S < 0 ? make_float2(a.y, -a.x) : make_float2(-a.y, a.x);
}

// in place: (a, b, c, d) <- DFT4 with W4 = S i
template <int S>
__device__ __forceinline__ void dft4(float2& a, float2& b, float2& c, float2& d) {
  const float2 s0 = a + c, s1 = b + d, d0 = a - c, d1 = mul_si<S>(b - d);
  a = s0 + s1;
  b = d0 + d1;
  c = s0 - s1;
  d = d0 - d1;
}

// W16^e, e in 1..9, with the sign S of the exponent
template <int S>
__device__ __forceinline__ float2 w16(int e) {
  constexpr float c1 = 0.92387953251128675613f, s1 = 0.38268343236508977173f;
  constexpr float r2 = 0.70710678118654752440f;
  switch (e) {
    case 1: return make_float2(c1, S * s1);
    case 2: return make_float2(r2, S * r2);
    case 3: return make_float2(s1, S * c1);
    case 6: return make_float2(-r2, S * r2);
    default: return make_float2(-c1, -S * s1);  // e = 9
  }
}

template <typename T>
__device__ __forceinline__ void swap2(T& a, T& b) {
  const T t = a;
  a = b;
  b = t;
}

// v <- DFT16(v) with W16 = exp(S 2 pi i / 16), natural order in and out:
// n = c + 4d -> DFT4 over d, twiddle W16^(c k2), DFT4 over c, then the 4 x 4
// transpose of the register names
template <int S>
__device__ __forceinline__ void dft16(float2 (&v)[16]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) dft4<S>(v[c], v[c + 4], v[c + 8], v[c + 12]);
#pragma unroll
  for (int c = 1; c < 4; ++c) {
#pragma unroll
    for (int k2 = 1; k2 < 4; ++k2) {
      if (c * k2 == 4)
        v[c + 4 * k2] = mul_si<S>(v[c + 4 * k2]);
      else
        v[c + 4 * k2] = cmul(v[c + 4 * k2], w16<S>(c * k2));
    }
  }
#pragma unroll
  for (int k2 = 0; k2 < 4; ++k2) dft4<S>(v[4 * k2], v[4 * k2 + 1], v[4 * k2 + 2], v[4 * k2 + 3]);
  swap2(v[1], v[4]);
  swap2(v[2], v[8]);
  swap2(v[3], v[12]);
  swap2(v[6], v[9]);
  swap2(v[7], v[13]);
  swap2(v[11], v[14]);
}

// a compiler barrier for memory: no load moves across it, so the twiddle
// and spectrum loads are not issued early, where their registers would
// take the transform past 128 a thread (and spill)
__device__ __forceinline__ void fence() { asm volatile("" ::: "memory"); }

// v[k] <- v[k] W^(b k) (conjugated for the inverse), W = exp(-2 pi i / 8192),
// from the table tw[e] = W^e (e < 4096; 8b < 4096 in every pass)
template <bool kConj>
__device__ __forceinline__ void twiddle(float2 (&v)[16], const float2* __restrict__ tw, int b) {
  fence();
  const float2 w1 = __ldg(tw + b), w2 = __ldg(tw + 2 * b);
  const float2 w4 = __ldg(tw + 4 * b);
  const float2 w3 = cmul(w1, w2);
  v[1] = tmul<kConj>(v[1], w1);
  v[2] = tmul<kConj>(v[2], w2);
  v[3] = tmul<kConj>(v[3], w3);
  v[4] = tmul<kConj>(v[4], w4);
  v[5] = tmul<kConj>(v[5], cmul(w4, w1));
  v[6] = tmul<kConj>(v[6], cmul(w4, w2));
  v[7] = tmul<kConj>(v[7], cmul(w4, w3));
  fence();
  const float2 w8 = __ldg(tw + 8 * b);
  v[8] = tmul<kConj>(v[8], w8);
  v[9] = tmul<kConj>(v[9], cmul(w8, w1));
  v[10] = tmul<kConj>(v[10], cmul(w8, w2));
  v[11] = tmul<kConj>(v[11], cmul(w8, w3));
  const float2 w12 = cmul(w8, w4);
  v[12] = tmul<kConj>(v[12], w12);
  v[13] = tmul<kConj>(v[13], cmul(w12, w1));
  v[14] = tmul<kConj>(v[14], cmul(w12, w2));
  v[15] = tmul<kConj>(v[15], cmul(w12, w3));
}

// the radix-2 DFT over the lane's lowest bit (the digit of weight 1): the
// lower lane keeps x0 + x1, the upper x0 - x1; the inverse is the same
// butterfly (it is its own transpose)
__device__ __forceinline__ void cross(float2 (&v)[16], bool up) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    float2 o;
    o.x = __shfl_xor_sync(0xffffffffu, v[k].x, 1);
    o.y = __shfl_xor_sync(0xffffffffu, v[k].y, 1);
    v[k] = up ? o - v[k] : v[k] + o;
  }
}

__device__ __forceinline__ int pad(int n) { return n + (n >> 4); }

// the points base + kStride k at their padded places: in every pass base's
// residue mod 16 plus that of kStride k stays below 16, so the offsets from
// pad(base) are constants
template <int kStride>
__device__ __forceinline__ void store16(float2* sm, int base, const float2 (&v)[16]) {
  float2* p = sm + pad(base);
#pragma unroll
  for (int k = 0; k < 16; ++k) p[kStride * k + ((kStride * k) >> 4)] = v[k];
}
template <int kStride>
__device__ __forceinline__ void load16(const float2* sm, int base, float2 (&v)[16]) {
  const float2* p = sm + pad(base);
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = p[kStride * k + ((kStride * k) >> 4)];
}

// x, opaque to the compiler: what is computed or loaded from it is computed
// or loaded again for every block, not hoisted out of the block loop, where
// it would stay live across the transforms and spill (the twiddles and the
// spectrum, ~120 values a thread; the stream and the pass indices, read
// again from blockIdx / threadIdx)
template <typename T>
__device__ __forceinline__ T opaque(T x) {
  if constexpr (sizeof(T) == 8)
    asm volatile("" : "+l"(x));
  else
    asm volatile("" : "+r"(x));
  return x;
}

struct Args {
  const float* x;        // (C, batch, L) planar pairs
  const float2* spec;    // (8192) taps spectrum / 8192, slot-major: [512 k + t]
  const float2* tw;      // (4096) W^e
  float* out;            // (C, batch, Lout)
  long long L, Lz, Lout; // Lz = L + T - 1: zero from here on
  int batch, nblk, cps, nb;  // blocks a stream, CTAs a stream, blocks a CTA
};

__global__ void __launch_bounds__(kThreads, 1) mf_ols_kernel(const Args a) {
  constexpr int TH = kThreads;
  extern __shared__ float2 sm[];
  const int t = threadIdx.x;
  const int j0 = (int)(blockIdx.x % (unsigned)a.cps) * a.nb;
  const int jend = min(j0 + a.nb, a.nblk);
  for (int j = j0; j < jend; ++j) {
    const unsigned si = opaque((unsigned)blockIdx.x) / (unsigned)a.cps;
    const unsigned pair = si / (unsigned)a.batch, b = si % (unsigned)a.batch;
    const size_t plane = (size_t)a.batch * (size_t)a.L, oplane = (size_t)a.batch * (size_t)a.Lout;
    const long long m0 = (long long)j * kValid;  // the block's first output
    float* yr = a.out + (size_t)(2 * pair) * oplane + (size_t)b * (size_t)a.Lout + m0;
    float* yi = yr + oplane;
    if (m0 >= a.Lz) {  // past L + T - 1: zeros only
      const int n = (int)min((long long)kValid, a.Lout - m0);
      for (int i = t; i < n; i += TH) yr[i] = yi[i] = 0.0f;
      continue;
    }
    const long long g0 = m0 - kDiscard;  // stream index of block sample 0
    const int lo = (int)max(0LL, -g0), hi = (int)min((long long)kF, max(0LL, a.L - g0));
    const float* xr = a.x + (size_t)(2 * pair) * plane + (size_t)b * (size_t)a.L + g0;
    const float* xi = xr + plane;
    const float2* tw = opaque(a.tw);
    const float2* spec = opaque(a.spec);
    // each pass's group of 16 points (thread t = d3 + 2 (d1 + 16 d0)):
    // pass 1 t + 512 k; pass 2 c2 + 512 d0 + 32 k; pass 3 d3 + 32 d1 +
    // 512 d0 + 2 k.  Passes 2 and 3 share d0 = t / 32, the warp.
    const int tt = opaque((int)threadIdx.x);
    const int c2 = tt % 32, d3 = tt % 2;
    const int p2 = c2 + TH * (tt / 32);
    const int p3 = d3 + 32 * ((tt / 2) % 16) + TH * (tt / 32);
    float2 v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int i = t + TH * k;
      const bool in = i >= lo && i < hi;
      v[k] = make_float2(in ? xr[i] : 0.0f, in ? xi[i] : 0.0f);
    }
    // forward: passes 1-3 over the digits of weight 512, 32, 2, then the lanes
    dft16<-1>(v);
    twiddle<false>(v, tw, t);
    store16<TH>(sm, t, v);
    __syncthreads();
    load16<32>(sm, p2, v);
    dft16<-1>(v);
    twiddle<false>(v, tw, 16 * c2);
    store16<32>(sm, p2, v);
    __syncwarp();
    load16<2>(sm, p3, v);
    dft16<-1>(v);
    twiddle<false>(v, tw, 256 * d3);
    cross(v, d3);
#pragma unroll
    for (int k = 0; k < 16; ++k) {  // four loads in flight at most
      if (k % 4 == 0) fence();
      v[k] = cmul(v[k], spec[k * TH + t]);
    }
    // inverse: the same passes transposed, in reverse order
    cross(v, d3);
    twiddle<true>(v, tw, 256 * d3);
    dft16<1>(v);
    store16<2>(sm, p3, v);
    __syncwarp();
    load16<32>(sm, p2, v);
    twiddle<true>(v, tw, 16 * c2);
    dft16<1>(v);
    store16<32>(sm, p2, v);
    __syncthreads();
    load16<TH>(sm, t, v);
    twiddle<true>(v, tw, t);
    dft16<1>(v);
    // block sample i = t + 512 k >= 2048 is output m0 + i - 2048
    const int oh = (int)min((long long)kF, a.Lout - m0 + kDiscard);
    const int zh = (int)min((long long)kF, a.Lz - m0 + kDiscard);
#pragma unroll
    for (int k = kDiscard / TH; k < 16; ++k) {
      const int i = t + TH * k;
      if (i < oh) {
        yr[i - kDiscard] = i < zh ? v[k].x : 0.0f;
        yi[i - kDiscard] = i < zh ? v[k].y : 0.0f;
      }
    }
  }
}

}  // namespace

// x (C, batch, L) float32 planar pairs, spec (8192, 2) float32 taps spectrum
// / 8192 in the kernel's order, tw (4096, 2) float32 W^e -> out (C, batch,
// Lout) float32; C even, 1 <= T <= 2049, nb >= 1
extern "C" int matched_filter_f32(const void* x, const void* spec, const void* tw, int C,
                                  int batch, long long L, int T, long long Lout, int nb,
                                  void* out, void* stream) {
  if (C < 2 || C % 2 || batch < 1 || L < 0 || Lout < 1 || T < 1 || T > kMaxTaps || nb < 1)
    return (int)cudaErrorInvalidValue;
  const long long nblk = (Lout + kValid - 1) / kValid, cps = (nblk + nb - 1) / nb;
  const long long grid = (long long)(C / 2) * batch * cps;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {  // once per process
    const cudaError_t err =
        cudaFuncSetAttribute(mf_ols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const Args a{(const float*)x, (const float2*)spec, (const float2*)tw, (float*)out,
               L, L + T - 1, Lout, batch, (int)nblk, (int)cps, nb};
  mf_ols_kernel<<<(unsigned)grid, kThreads, kSmem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
