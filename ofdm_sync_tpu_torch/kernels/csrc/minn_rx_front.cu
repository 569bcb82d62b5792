// Kernel G, the batched Minn-RTL receive's slot front end: frame
// re-emission, the CP CFO, the CFO tone, its rotation and the antenna mean,
// for every slot of a batch's event tables in one launch.
//
// Replaces (TPU): none.  The JAX package demodulates a frame in plain XLA
// ops (ofdm_sync_tpu/pipelines/fused_rx.py), as the port's plain body does
// (pipelines/fused_rx.py:receive_minn_rtl_frames_plain); this kernel and
// kernel H (minn_rx_back.cu) were added because that body, ~100 PyTorch
// launches a call, ran the frame sweep's receive at ~45x its bytes' bound
// (PERF.md).  The FFT between the two kernels stays torch.fft.fft.
//
// For slot k < K of stream b, with a (batch, E) event table:
//   valid = table.valid[b, k] && k < table.count[b]
//   s     = clip(peak_idx[b, k] + offset, 0, L - frame_len)
//   w[n]  = the codes of each branch at s + pilot_cp + n (the pilot's CP at 0)
//   P     = sum_branches sum_{u < cp} w[u] conj(w[u + N])
//   cfo   = -angle(P) fs / (2 pi N)
//   comb[sym, j] = mean_branches w[n] exp(-j 2 pi cfo (pilot_cp + n) / fs),
//          n = cp + j (pilot, sym 0) or 2 cp + N + j (data, sym 1), j < N
// (pipelines/fused_rx.py: frame_slots, slot_windows, cfo_from_cp_windows,
// cfo_tone and the mean).  It writes start and valid, the CFO, and comb
// (batch, K, 2, N) complex64; a slot that is not valid gets start 0 and
// CFO 0 and its comb is not written (kernel H never reads it), as the plain
// body zeroes the outputs of such a slot.
//
// Precision, that of the configuration (complex64): P summed in float64
// (each product of int16 codes exact), cfo by atan2f; the tone's phase
// formed in float64 as cfo x 2 pi / fs x the frame-local index, reduced
// by 2 pi in float64 and rounded once to float32 (within ~2e-7 rad, at
// least as exact as cfo_tone's digit split), then sincosf at full
// precision; the rotation and the mean in float32.
//
// What bounds it on the H100: bytes.  A slot reads the pilot's CP, the
// pilot and the data symbol of each plane once (4,608 samples x 4 int16
// planes: 36,864 B; the data symbol's CP is never read) and writes 2 x N
// complex64 (32 KB); 8,192 slots of the frame sweep move ~570 MB, ~0.17 ms
// at 3.35 TB/s.  The plain body made ~20 passes over these samples, with two
// index kernels.
//
// Design: one CTA of 256 threads a slot.  The CTA copies its slot's codes
// from HBM into shared memory with cp.async (16 bytes a copy, no registers
// held while they fly): each plane's pilot run (its CP, then the pilot) and
// its data run, each as the 16-byte-aligned chunks that hold it, the pilot
// runs first and the data runs behind them.  Once the pilot runs have
// landed, thread t forms the CP products of samples u = t + 256 m (the
// lag-N partner of CP sample u is pilot sample N - cp + u, read from the
// same copy, never again from HBM), the CTA reduces P, every thread forms
// the CFO from the totals, turns and averages the pilot's samples j = t +
// 256 m and stores them; then the same for the data symbol, whose copies
// flew meanwhile.  ~37 KB of shared memory a CTA (int16, two branches) and
// 64 registers a thread hold four CTAs an SM, so one CTA's copies overlap
// another's arithmetic.  A first version that held every code in registers
// (116 a thread, two CTAs an SM) took ~0.30 ms a batch of the frame sweep
// against ~0.20 ms for this one (PERF.md).  Codes with a stride along time,
// or runs larger than the shared memory a CTA may take (N = 4,096 in float32
// at four branches, say), are read in place from HBM by the same arithmetic
// instead (no copy).  Any N and CP >= 0; int16 or float32 codes, one to four
// branches (template), any strides.
#include <cuda_runtime.h>

#include <cstdint>

#include "minn_rx.cuh"

namespace {

using ofdm::rx::copy_run;
using ofdm::rx::kThreads;
using ofdm::rx::run_bytes;

constexpr double kTwoPi = 6.283185307179586;

struct FrontArgs {
  const void* x;         // (C, batch, L) codes
  long long sc, sb, st;  // x's strides in samples: plane, stream, time
  const int* peak_idx;   // (batch, E)
  const bool* tvalid;    // (batch, E)
  const int* count;      // (batch,)
  int batch, K, E, N, cp, pilot_cp, frame_len;
  int run_a, run_b;      // shared bytes a plane of the pilot's run (its CP and itself) and the
                         // data's; 0: the runs are read in place
  long long L, offset;   // offset: the frame's first sample less the peak's
  double fs;
  float fs_f, two_pi_n;  // fs and 2 pi N in float32, for the CFO as cfo_from_P forms it
  int* starts;           // (batch, K)
  bool* valid;           // (batch, K)
  float* cfo;            // (batch, K)
  float2* comb;          // (batch, K, 2, N)
};

// turns one symbol's samples of every plane by the tone and stores their
// mean over the branches: sym[c][j * st] is plane c's sample j, at the
// frame-local index n0 + j
template <typename T, int kC>
__device__ __forceinline__ void rotate_store(const T* const (&sym)[kC], long long st, int N,
                                             int n0, double rate, float2* out) {
  constexpr float kBranches = kC / 2;
#pragma unroll 4
  for (int j = threadIdx.x; j < N; j += kThreads) {
    double ph = rate * (double)(n0 + j);
    ph -= kTwoPi * rint(ph * (1.0 / kTwoPi));
    float sn, cs;
    sincosf((float)ph, &sn, &cs);
    const long long at = j * st;
    float re = 0.0f, im = 0.0f;
#pragma unroll
    for (int c = 0; c < kC; c += 2) {
      const float i = (float)sym[c][at], q = (float)sym[c + 1][at];
      re += i * cs - q * sn;
      im += i * sn + q * cs;
    }
    out[j] = make_float2(re / kBranches, im / kBranches);
  }
}

template <typename T, int kC>
__global__ void __launch_bounds__(kThreads, kC <= 4 ? 4 : 2)
    minn_rx_front_kernel(const FrontArgs a) {
  extern __shared__ __align__(16) unsigned char runs[];
  __shared__ double scratch[2 * ofdm::rx::kWarps];
  const int slot = blockIdx.x;
  const int b = slot / a.K, k = slot - b * a.K;
  const long long e = (long long)b * a.E + k;
  const bool ok = a.tvalid[e] && k < a.count[b];
  const long long s = min(max((long long)a.peak_idx[e] + a.offset, 0LL), a.L - a.frame_len);
  if (threadIdx.x == 0) {
    a.starts[slot] = ok ? (int)s : 0;
    a.valid[slot] = ok;
    if (!ok) a.cfo[slot] = 0.0f;
  }
  if (!ok) return;  // the same for the whole CTA

  // plane c's pilot run (CP, then the pilot) and data run: in shared memory,
  // or in place
  const int N = a.N, cp = a.cp;
  const bool staged = a.run_a > 0;
  const long long st = staged ? 1 : a.st;
  const T* w = (const T*)a.x + b * a.sb + (s + a.pilot_cp) * a.st;
  const T* pil[kC];
  const T* dat[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    pil[c] = w + c * a.sc;
    dat[c] = pil[c] + (2LL * cp + N) * a.st;
  }
  if (staged) {
#pragma unroll
    for (int c = 0; c < kC; ++c) pil[c] = copy_run(runs + c * a.run_a, pil[c], cp + N);
    ofdm::walk::cp_async_commit();
#pragma unroll
    for (int c = 0; c < kC; ++c) dat[c] = copy_run(runs + kC * a.run_a + c * a.run_b, dat[c], N);
    ofdm::walk::cp_async_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this thread's pilot copies
    __syncthreads();
  }

  double P[2] = {0.0, 0.0};
  for (int u = threadIdx.x; u < cp; u += kThreads) {
    const long long at = u * st, lag = (long long)(u + N) * st;
#pragma unroll
    for (int c = 0; c < kC; c += 2) {
      const double i = pil[c][at], q = pil[c + 1][at];        // CP sample u
      const double pi = pil[c][lag], pq = pil[c + 1][lag];    // its lag-N partner
      P[0] += i * pi + q * pq;  // w[u] conj(w[u + N])
      P[1] += q * pi - i * pq;
    }
  }
  ofdm::rx::block_sum<2>(P, scratch);
  const float cfo = (-atan2f((float)P[1], (float)P[0]) * a.fs_f) / a.two_pi_n;
  if (threadIdx.x == 0) a.cfo[slot] = cfo;
  const double rate = ((double)(-cfo) * kTwoPi) / a.fs;  // the tone's radians a sample
  float2* out = a.comb + (size_t)slot * 2 * N;
  const T* pilot[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) pilot[c] = pil[c] + cp * st;
  rotate_store<T, kC>(pilot, st, N, a.pilot_cp + cp, rate, out);
  if (staged) {
    ofdm::walk::cp_async_wait();  // this thread's data copies
    __syncthreads();
  }
  rotate_store<T, kC>(dat, st, N, a.pilot_cp + 2 * cp + N, rate, out + N);
}

template <typename T, int kC>
cudaError_t launch(FrontArgs a, cudaStream_t stream) {
  if (a.st == 1) {  // stage the runs where they fit
    a.run_a = run_bytes<T>(a.cp + a.N);
    a.run_b = run_bytes<T>(a.N);
    if ((long long)kC * (a.run_a + a.run_b) > ofdm::walk::smem_optin()) a.run_a = a.run_b = 0;
  }
  const int smem = kC * (a.run_a + a.run_b);
  static bool allowed = false;
  if (smem > 48 * 1024 && !allowed) {  // once per process and instantiation
    const cudaError_t err = ofdm::walk::allow_smem(minn_rx_front_kernel<T, kC>);
    if (err != cudaSuccess) return err;
    allowed = true;
  }
  minn_rx_front_kernel<T, kC><<<a.batch * a.K, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_planes(const FrontArgs& a, int C, cudaStream_t s) {
  switch (C) {
    case 2: return launch<T, 2>(a, s);
    case 4: return launch<T, 4>(a, s);
    case 6: return launch<T, 6>(a, s);
    default: return launch<T, 8>(a, s);
  }
}

}  // namespace

// x (C, batch, L) int16 (is_i16 = 1) or float32 codes, C = 2, 4, 6 or 8
// planes (planar channel-leading), with strides s_plane, s_row and s_time
// in samples; peak_idx (batch, E) int32, tvalid (batch, E) bool and count
// (batch,) int32: the event table, contiguous; the first K <= E slots of
// each row are received.  The frame opens at peak_idx + offset, clipped to
// [0, L - frame_len], frame_len = pilot_cp + 2 (n_fft + cp); n_fft >= 1,
// cp >= 0.  Outputs: starts (batch, K) int32, valid (batch, K) bool, cfo
// (batch, K) float32, comb (batch, K, 2, n_fft) complex64.
extern "C" int minn_rx_front(int is_i16, const void* x, int C, int batch, long long L,
                             long long s_plane, long long s_row, long long s_time,
                             const void* peak_idx, const void* tvalid, const void* count,
                             int E, int K, int n_fft, int cp, int pilot_cp, long long offset,
                             double fs, void* starts, void* valid, void* cfo, void* comb,
                             void* stream) {
  const long long frame_len = pilot_cp + 2LL * (n_fft + cp);
  if (n_fft < 1 || cp < 0 || pilot_cp < 0 || C < 2 || C > 8 || C % 2 || K < 1 || K > E ||
      frame_len > L || frame_len >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  FrontArgs a{};
  a.x = x;
  a.sc = s_plane;
  a.sb = s_row;
  a.st = s_time;
  a.peak_idx = (const int*)peak_idx;
  a.tvalid = (const bool*)tvalid;
  a.count = (const int*)count;
  a.batch = batch;
  a.K = K;
  a.E = E;
  a.N = n_fft;
  a.cp = cp;
  a.pilot_cp = pilot_cp;
  a.frame_len = (int)frame_len;
  a.L = L;
  a.offset = offset;
  a.fs = fs;
  a.fs_f = (float)fs;
  a.two_pi_n = (float)(kTwoPi * n_fft);
  a.starts = (int*)starts;
  a.valid = (bool*)valid;
  a.cfo = (float*)cfo;
  a.comb = (float2*)comb;
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_i16 ? launch_planes<int16_t>(a, C, s) : launch_planes<float>(a, C, s));
}
