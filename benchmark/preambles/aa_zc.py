"""Preamble kind ``aa_zc``: the [A][A] preamble of the 10 MHz system, a
Zadoff-Chu sequence on every K-th FFT bin inside the active band, K = 2 N /
length, so that the first ``length`` samples of the symbol are two equal
halves (sync_aa.py:160-235).  The bins are counted from DC at N / 2 in the
unshifted spectrum, DC itself skipped; root 25, or 23 where 25 divides the
number of bins used; the symbol is the IFFT times sqrt(N), cut to
``length`` samples and scaled to unit power."""

from __future__ import annotations

import numpy as np

from benchmark.preambles import unit_power


def template(config: dict) -> np.ndarray:
    n_fft, num_active = config["system"]["n_fft"], config["system"]["num_active"]
    length = config["preamble"]["length"]
    K = 2 * n_fft // length
    dc, half = n_fft // 2, num_active // 2
    off = np.arange(-half, half + 1)
    bins = dc + off[(off != 0) & ((dc + off) % K == 0)]
    used = bins.shape[0]
    root = 23 if used % 25 == 0 else 25
    n = np.arange(used)
    spectrum = np.zeros(n_fft, dtype=np.complex128)
    spectrum[bins] = np.exp(-1j * np.pi * root * n * (n + 1) / used)
    return unit_power(np.fft.ifft(spectrum)[:length] * np.sqrt(n_fft))
