"""The work of the Minn-RTL batched receive's function, counted as
`counts.py` counts the detection's (each input read once, each output
written once, whatever kernels or library calls carry it), for
`counts.bound_s`."""

from __future__ import annotations

import math

#: bytes a slot writes: start (int32), valid (1), CFO, EVM rms and dB
#: (float32 each), the gain (complex64)
SLOT_OUT_BYTES = 4 + 1 + 4 + 4 + 4 + 8
#: flops a used bin: the LS estimate and the equalization (a complex
#: division each, ~11), the gain's two dot products (8 each) and its
#: product (6), the EVM's error and power (~5)
BIN_FLOPS = 2 * 11 + 2 * 8 + 6 + 5


def rx_demod_work(batch, K, C, itemsize, n_fft, cp_len, num_active, E):
    """(bytes, flops) of one receive call over ``batch`` streams of ``K``
    slots and ``C`` code planes.

    Bytes: each slot's pilot CP through its data symbol, 2 (N + CP) samples
    of C codes, read once; the table's peak_idx and valid (E slots) and
    count read once; the slot outputs and the equalized data bins (complex64)
    written once.  Flops a slot: the CP's lag-N products and sum (8 a
    complex pair of each of the C / 2 branches), the rotation and the
    antenna mean on the 2N symbol samples of each branch (6 + 2), two N-point
    FFTs at 5 N log2 N, and `BIN_FLOPS` on each used bin.

    Every slot is counted, those that hold no frame too: the function works
    under a mask and computes each slot.  About 0.5% of slots in the frame
    sweep are empty, since ~99.6% of preambles are detected at its SNRs."""
    slots = batch * K
    branches = C // 2
    nbytes = (slots * 2 * (n_fft + cp_len) * C * itemsize + batch * (E * 5 + 4)
              + slots * (SLOT_OUT_BYTES + num_active * 8))
    per_slot = (8 * branches * cp_len + 8 * branches * 2 * n_fft
                + 2 * 5 * n_fft * math.log2(n_fft) + BIN_FLOPS * num_active)
    return nbytes, slots * per_slot
