"""The work each kernel must do, and the least time the card could take
for it: one count of bytes and operations under every bound the port
reports (`bench`, `bench_scaling`, `chip_smoke.py`).

A bound is the larger of two times: the bytes a call must move (each input
read once, each output written once) over the card's memory rate, and the
operations it does over the card's peak rate for their type.  Where the
work depends on the data (kernel B reads the track only inside a gate),
the count is what the given data needs, not the most it could.
"""

from __future__ import annotations

import torch

#: H100 SXM data-sheet peaks at 700 W (HBM3, FP32 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of bytes over
    the HBM rate and flops over the FP32 rate, and which one it is."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def bound_sum(works) -> tuple[float, str]:
    """The bound of kernels run one after another: the sum of each one's
    bound, named by the largest term."""
    terms = [bound(*w) for w in works]
    return sum(t for t, _ in terms), max(terms)[1]


def a_work(batch, L, C, itemsize, out_bytes, hist_len=0, scan=True):
    """Kernel A: each input sample read once (and the history), each output
    written once; ~4C + 12 flops per sample (2C products, 2C sums, window
    differences, smoothing step, threshold)."""
    nbytes = batch * L * (C * itemsize + out_bytes) + C * batch * hist_len * 4 + 8 * batch
    return nbytes, batch * L * (4 * C + (12 if scan else 6))


def b_work(above, gated, E=8, n_extra=0):
    """Kernel B: above read once, track (and the captured channels) read
    only at the gated samples this run's data has, the table written once."""
    batch, L = above.shape
    nbytes = (batch * L + 4 * int(gated) * (1 + n_extra) + batch * E * (2 + 16 + 4 * n_extra)
              + 8 * batch)
    return nbytes, 2 * batch * L + 10 * int(gated)


def f_work(batch, L, C, itemsize, hist_len, gated, E=8):
    """Kernel F, one Minn-RTL stream step: the chunk and the history read
    once, the new history, the table and the state (register, gate carry)
    written once; kernel A's flops per sample and kernel B's (corr and
    above stay on the chip, so no byte of them is counted)."""
    nbytes = (batch * L * C * itemsize + 2 * C * batch * hist_len * 4
              + batch * E * 18 + 2 * batch * (4 + 8) + 8 * batch)
    return nbytes, batch * L * (4 * C + 12) + 2 * batch * L + 10 * int(gated)


def c_work(batch, L, C, itemsize, out_bytes, hist_len=0):
    """Kernel C: each sample read once, each output written once; per
    sample per branch 12 flops of products and sums, ~10 more for the
    windows, track and M."""
    nbytes = batch * L * (C * itemsize + out_bytes) + C * batch * hist_len * 4
    return nbytes, batch * L * (6 * C + 10)


def cap_work(slots, valid, L, C):
    """The [A][A] peak capture (`aa_peak_capture`): each slot's peak index
    read and its three float32 channels written once, and for each of the
    ``valid`` slots with a peak the 2L int16 codes of each of C planes
    before it read once; per code 6 operations (C/2 branches x 6 products
    and 6 sums a sample), a few more a slot for M."""
    return slots * (4 + 12) + valid * 2 * L * C * 2, valid * (6 * C * L + 10)


def d_mag_work(batch, L, hist_len=0):
    """Kernel D in magnitude mode: the magnitude read once, above written
    once; 8 flops per sample."""
    return batch * L * (4 + 1) + batch * hist_len * 4, batch * L * 8


def d_iq_work(batch, Lc, L_iq, C, itemsize, hist_len=0):
    """Kernel D in IQ mode: mf and IQ (and the halos) read once, mag and
    above (and the gate carry) written once; per output 4C + 12 flops."""
    nbytes = batch * (Lc * (C * 4 + 5) + L_iq * C * itemsize)
    if hist_len:
        nbytes += batch * (hist_len * C * (4 + itemsize) + 8)
    return nbytes, batch * (Lc + hist_len) * (4 * C + 12)


def e_work(x, T, out_len):
    """Kernel E's function, a full convolution, at the least work it needs
    (not the direct form's 8T flops per output): its bytes, and the flops of
    the cheaper of two FFT convolutions of the outputs that are not zero
    (the first L + T - 1): one transform pair per stream over N = the next
    power of two, or overlap-save over F-point blocks of F - 2048 outputs
    (kernel E's geometry).  5 n log2 n flops per complex n-point transform,
    6n per complex product, one transform of the taps."""
    from ofdm_sync_tpu_torch.kernels.matched_filter import DISCARD, FFT_SIZE

    C, batch, L = x.shape
    streams = (C // 2) * batch
    lz = min(out_len, L + T - 1)

    def conv(n, blocks):
        fft = 5.0 * n * (n.bit_length() - 1)
        return streams * blocks * (2 * fft + 6.0 * n) + fft

    flops = min(conv(1 << (lz - 1).bit_length(), 1),
                conv(FFT_SIZE, -(-lz // (FFT_SIZE - DISCARD))))
    return x.numel() * 4 + C * batch * out_len * 4 + 8 * T, flops


def sliding_dft_work(branches, L, bins, offsets):
    """The sliding-DFT ZC-frequency metric (`ops.metrics.zc_freq_metric_sliding`):
    the complex64 stream read once and one float32 metric per offset
    written; per bin, branch and sample a complex modulation (6 flops) and
    a running-sum step (2), per bin, branch and offset a product with the
    template and a magnitude (~10)."""
    nbytes = branches * L * 8 + offsets * 4
    return nbytes, bins * branches * (8 * L + 10 * offsets)


def gated_samples(above: torch.Tensor, hysteresis: int) -> int:
    """Samples inside a gate (where kernel B reads the track)."""
    from ofdm_sync_tpu_torch.ops.detect import gate_open_mask

    return int(gate_open_mask(above, hysteresis).sum())
