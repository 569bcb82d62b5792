"""Preamble builders, one file a kind: ``<kind>.py`` holds
``template(config) -> np.ndarray`` (complex128), the preamble that a
configuration whose ``preamble.kind`` names it plants in its streams.  The
helpers here follow the upstream recipes (core.py:13-20)."""

from __future__ import annotations

import numpy as np


def centered(width: int) -> np.ndarray:
    """Subcarrier indices symmetric around DC, bin 0 skipped (core.py:13-20)."""
    half = width // 2
    return np.concatenate((np.arange(-half, 0), np.arange(1, half + 1)))


def allocate(n_fft: int, idx: np.ndarray, values: np.ndarray) -> np.ndarray:
    spectrum = np.zeros(n_fft, dtype=np.complex128)
    spectrum[(n_fft // 2 + idx) % n_fft] = values
    return spectrum


def unit_power(x: np.ndarray) -> np.ndarray:
    return x / np.sqrt(np.mean(np.abs(x) ** 2))
