"""The work each stage of a cell must do, and the least time the card
could take for it: the benchmark's own frozen copy of the port's
`utils/roofline.py` counts, with kernel E's geometry and the gate rule
fixed here so that nothing of the program enters the yardstick.

A bound is the larger of two times: the bytes a stage must move (each input
read once, each output written once) over the card's memory rate, and its
flops over the card's FP32 rate.  Where the work depends on the data
(kernel B reads the track only inside a gate), the count is what the given
data needs: the gated samples of the inputs the cell runs.

A stage's share is held to the work of its function (`minn_detect_work`,
`zc_detect_work`, `e_work`, `f_work`): what goes in and what comes out of
the call, and never what one set of kernels passes between them (kernel A's
corr and above, kernel D's mag and above), so the share stays valid when a
later build fuses or splits the kernels.  `a_work`, `b_work` and
`d_iq_work` count single kernels, for tables of kernels.
"""

from __future__ import annotations

import torch

#: H100 SXM data-sheet peaks at 700 W (HBM3; FP32 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: kernel E's overlap-save geometry: FFT_SIZE-point blocks that keep
#: FFT_SIZE - DISCARD outputs each
FFT_SIZE, DISCARD = 8192, 2048


def bound_s(nbytes: float, flops: float) -> float:
    """The least time (s) the card could take for (bytes, flops)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


def a_work(batch, L, C, itemsize, out_bytes, hist_len=0, scan=True):
    """Kernel A: each input sample read once (and the history), each output
    written once; ~4C + 12 flops per sample."""
    nbytes = batch * L * (C * itemsize + out_bytes) + C * batch * hist_len * 4 + 8 * batch
    return nbytes, batch * L * (4 * C + (12 if scan else 6))


def b_work(batch, L, gated, E=8, n_extra=0):
    """Kernel B: above read once, the track read at the gated samples, the
    table written once."""
    nbytes = (batch * L + 4 * int(gated) * (1 + n_extra) + batch * E * (2 + 16 + 4 * n_extra)
              + 8 * batch)
    return nbytes, 2 * batch * L + 10 * int(gated)


def table_bytes(batch, E):
    """An event table written once: valid and closed (1 byte each),
    gate_start, gate_close, peak_idx and peak_value (4 each) an event, and
    the count and overflow a stream (as `b_work` counts them)."""
    return batch * E * (2 + 16) + 8 * batch


def minn_detect_work(batch, L, C, itemsize, gated, E=8):
    """Minn-RTL batch detection, the function: the codes read once and the
    event table written once (the metric and the above track stay inside
    it); kernel A's flops a sample and kernel B's."""
    nbytes = batch * L * C * itemsize + table_bytes(batch, E)
    return nbytes, batch * L * (4 * C + 12) + 2 * batch * L + 10 * int(gated)


def zc_detect_work(batch, Lc, L_iq, C, itemsize, gated, E=16):
    """ZC CFAR detection from IQ, the function: the matched filter's output
    (float32) and the IQ read once and the event table written once (the
    magnitude and the above track stay inside it); kernel D's flops per
    output and kernel B's."""
    nbytes = batch * (Lc * C * 4 + L_iq * C * itemsize) + table_bytes(batch, E)
    return nbytes, batch * Lc * (4 * C + 12) + 2 * batch * Lc + 10 * int(gated)


def f_work(batch, L, C, itemsize, hist_len, gated, E=8):
    """Kernel F, one Minn-RTL stream step: the chunk and the history read
    once, the new history, the table and the state written once; kernel
    A's flops per sample and kernel B's."""
    nbytes = (batch * L * C * itemsize + 2 * C * batch * hist_len * 4
              + batch * E * 18 + 2 * batch * (4 + 8) + 8 * batch)
    return nbytes, batch * L * (4 * C + 12) + 2 * batch * L + 10 * int(gated)


def d_iq_work(batch, Lc, L_iq, C, itemsize, hist_len=0):
    """Kernel D in IQ mode: mf and IQ read once, mag and above written once;
    per output 4C + 12 flops."""
    nbytes = batch * (Lc * (C * 4 + 5) + L_iq * C * itemsize)
    if hist_len:
        nbytes += batch * (hist_len * C * (4 + itemsize) + 8)
    return nbytes, batch * (Lc + hist_len) * (4 * C + 12)


def e_work(C, batch, L, T, out_len):
    """The matched filter's function, a full convolution, at the least work
    it needs: its bytes (float32 in and out, the taps), and the flops of the
    cheaper of one transform pair a stream over the next power of two and
    overlap-save over FFT_SIZE-point blocks; 5 n log2 n flops a complex
    n-point transform, 6n a complex product, one transform of the taps."""
    streams = (C // 2) * batch
    lz = min(out_len, L + T - 1)

    def conv(n, blocks):
        fft = 5.0 * n * (n.bit_length() - 1)
        return streams * blocks * (2 * fft + 6.0 * n) + fft

    flops = min(conv(1 << (lz - 1).bit_length(), 1),
                conv(FFT_SIZE, -(-lz // (FFT_SIZE - DISCARD))))
    return C * batch * L * 4 + C * batch * out_len * 4 + 8 * T, flops


def gated_samples(above: torch.Tensor, hysteresis: int, valid_from: int = 0) -> int:
    """Samples inside a gate: at most max(h, 1) samples after an above
    sample at or past ``valid_from`` (where kernel B reads the track)."""
    n = above.shape[-1]
    h = max(int(hysteresis), 1)
    idx = torch.arange(n, dtype=torch.int64, device=above.device)
    last = torch.cummax(torch.where(above.bool() & (idx >= valid_from), idx, -1), dim=-1).values
    return int(((last >= 0) & (idx - last <= h)).sum())
