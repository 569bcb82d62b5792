// Kernel H, the batched Minn-RTL receive's bin back end: the LS channel
// estimate on the pilot, the equalization of the data symbol, its LS gain
// alignment and its EVM, for every slot of a batch in one launch, on the
// spectra that torch.fft.fft made of kernel G's output (minn_rx_front.cu).
//
// Replaces (TPU): none, as kernel G (its header says why both were added).
//
// For each valid slot, over the used bins u < A (bin N - A/2 + u for
// u < A/2, else u - A/2 + 1: the active band without DC, unshifted), with
// y_p, y_d the pilot's and the data symbol's bins and X_p, X_d the known
// values:
//   h   = y_p / (X_p + 1e-9)                  (ops/estimate.ls_channel_estimate)
//   eq0 = y_d / (h + 1e-9)                    (ops/estimate.equalize)
//   g   = sum conj(eq0) X_d / (sum |eq0|^2 + 1e-12),  eq = g eq0
//                                             (ops/estimate.align_complex_gain)
//   evm = sqrt(mean |eq - X_d|^2 / mean |X_d|^2), evm_db = 20 log10(evm + 1e-12)
// and writes eq (slots, A) complex64, gain, evm and evm_db; a slot that is
// not valid gets zeros in each, as the plain body gives it.
//
// Precision, that of the configuration (complex64): each division is
// c10::complex<float>'s scaled division (minn_rx.cuh: cdiv), as PyTorch
// divides complex64 tensors on the card; the sums in float64 over the CTA;
// sqrtf and log10f at full precision.
//
// What bounds it on the H100: bytes.  A slot reads its 2 x A used bins
// (19.2 KB at A = 1,200) and writes its A equalized bins (9.6 KB); the
// known values (19.2 KB) are the same for every slot and stay in L2.
//
// Design: one CTA of 256 threads a slot.  The CTA copies the slot's four
// runs of used bins (each symbol's [N - A/2, N) and [1, A/2]) into shared
// memory with cp.async (16 bytes a copy, no registers held while they
// fly), then thread t takes bins u = t + 256 m: it forms h and eq0 and
// keeps eq0 in the shared copy, over the data bin it came from, while the
// CTA sums the gain's two dot products and the data's power; every thread
// forms g from the totals, scales and stores its bins, and the CTA sums
// the error power.  Runs larger than the shared memory a CTA may take (A
// beyond ~14,000 bins) are read in place from HBM instead, and eq0 is kept
// in eq until it is scaled.  Any N and even A <= N.
#include <cuda_runtime.h>

#include "minn_rx.cuh"

namespace {

using ofdm::rx::cdiv;
using ofdm::rx::cmul;
using ofdm::rx::copy_run;
using ofdm::rx::kThreads;
using ofdm::rx::run_bytes;

struct BackArgs {
  const float2* bins;   // (slots, 2, N): the pilot's and the data symbol's spectra
  const bool* valid;    // (slots,)
  const float2* pilot;  // (A,)
  const float2* data;   // (A,)
  int N, A;
  int run;              // shared bytes of a run of A / 2 bins; 0: the runs are read in place
  float2* eq;           // (slots, A)
  float* evm_rms;       // (slots,)
  float* evm_db;        // (slots,)
  float2* gain;         // (slots,)
};

__global__ void __launch_bounds__(kThreads) minn_rx_back_kernel(const BackArgs a) {
  extern __shared__ __align__(16) unsigned char runs[];
  __shared__ double scratch[4 * ofdm::rx::kWarps];
  const int slot = blockIdx.x;
  float2* eq = a.eq + (size_t)slot * a.A;
  if (!a.valid[slot]) {  // the same for the whole CTA
    for (int u = threadIdx.x; u < a.A; u += kThreads) eq[u] = make_float2(0.0f, 0.0f);
    if (threadIdx.x == 0) {
      a.evm_rms[slot] = a.evm_db[slot] = 0.0f;
      a.gain[slot] = make_float2(0.0f, 0.0f);
    }
    return;
  }
  const float2* yp = a.bins + (size_t)slot * 2 * a.N;
  const float2* yd = yp + a.N;
  const int half = a.A / 2;
  // the used bins of each symbol, the negative frequencies, then the
  // positive; eq0 of bin u is kept at keep_neg[u] or keep_pos[u - half]
  const float2* p_neg = yp + a.N - half;
  const float2* p_pos = yp + 1;
  const float2* d_neg = yd + a.N - half;
  const float2* d_pos = yd + 1;
  float2* keep_neg = eq;
  float2* keep_pos = eq + half;
  if (a.run) {
    p_neg = copy_run(runs, p_neg, half);
    p_pos = copy_run(runs + a.run, p_pos, half);
    d_neg = copy_run(runs + 2 * a.run, d_neg, half);
    d_pos = copy_run(runs + 3 * a.run, d_pos, half);
    keep_neg = const_cast<float2*>(d_neg);
    keep_pos = const_cast<float2*>(d_pos);
    ofdm::walk::cp_async_commit();
    ofdm::walk::cp_async_wait();
    __syncthreads();
  }
  double s[4] = {0.0, 0.0, 0.0, 0.0};  // conj(eq0) X_d (re, im), |eq0|^2, |X_d|^2
  for (int u = threadIdx.x; u < a.A; u += kThreads) {
    const bool neg = u < half;
    float2 xp = __ldg(a.pilot + u);
    xp.x += 1e-9f;
    float2 h = cdiv(neg ? p_neg[u] : p_pos[u - half], xp);
    h.x += 1e-9f;
    const float2 e = cdiv(neg ? d_neg[u] : d_pos[u - half], h), r = __ldg(a.data + u);
    (neg ? keep_neg[u] : keep_pos[u - half]) = e;
    s[0] += e.x * r.x + e.y * r.y;
    s[1] += e.x * r.y - e.y * r.x;
    s[2] += e.x * e.x + e.y * e.y;
    s[3] += r.x * r.x + r.y * r.y;
  }
  ofdm::rx::block_sum<4>(s, scratch);
  const float2 g = cdiv(make_float2((float)s[0], (float)s[1]),
                        make_float2((float)s[2] + 1e-12f, 0.0f));
  double err[1] = {0.0};
  for (int u = threadIdx.x; u < a.A; u += kThreads) {
    const float2 v = cmul(u < half ? keep_neg[u] : keep_pos[u - half], g), r = __ldg(a.data + u);
    eq[u] = v;
    const float dr = v.x - r.x, di = v.y - r.y;
    err[0] += dr * dr + di * di;
  }
  ofdm::rx::block_sum<1>(err, scratch);
  if (threadIdx.x == 0) {
    const float evm = sqrtf(((float)err[0] / (float)a.A) / ((float)s[3] / (float)a.A));
    a.evm_rms[slot] = evm;
    a.evm_db[slot] = 20.0f * log10f(evm + 1e-12f);
    a.gain[slot] = g;
  }
}

}  // namespace

// bins (slots, 2, n_fft) complex64 (each slot's pilot and data spectra),
// valid (slots,) bool, pilot and data (A,) complex64 (the known values of
// the used bins, in order), all contiguous; A even, 0 <= A <= n_fft.
// Outputs: eq (slots, A) complex64, evm_rms and evm_db (slots,) float32,
// gain (slots,) complex64.
extern "C" int minn_rx_back(const void* bins, const void* valid, const void* pilot,
                            const void* data, int slots, int n_fft, int A, void* eq,
                            void* evm_rms, void* evm_db, void* gain, void* stream) {
  if (A < 0 || A % 2 || A > n_fft) return (int)cudaErrorInvalidValue;
  if (slots <= 0) return (int)cudaSuccess;
  BackArgs a{};
  a.bins = (const float2*)bins;
  a.valid = (const bool*)valid;
  a.pilot = (const float2*)pilot;
  a.data = (const float2*)data;
  a.N = n_fft;
  a.A = A;
  a.eq = (float2*)eq;
  a.evm_rms = (float*)evm_rms;
  a.evm_db = (float*)evm_db;
  a.gain = (float2*)gain;
  a.run = run_bytes<float2>(A / 2);
  if (4LL * a.run > ofdm::walk::smem_optin()) a.run = 0;
  static bool allowed = false;
  if (4 * a.run > 48 * 1024 && !allowed) {  // once per process
    const cudaError_t err = ofdm::walk::allow_smem(minn_rx_back_kernel);
    if (err != cudaSuccess) return err;
    allowed = true;
  }
  minn_rx_back_kernel<<<slots, kThreads, 4 * a.run, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
