"""Preamble kind ``pss``: the LTE-like PSS without CP, a Zadoff-Chu
sequence of ``length`` and ``root`` on the centered subcarriers of one
``n_fft``-point symbol, unit power (zc.py:30-46, zc_v2.py:170-185)."""

from __future__ import annotations

import numpy as np

from benchmark.preambles import allocate, centered, unit_power


def template(config: dict) -> np.ndarray:
    p, n_fft = config["preamble"], config["system"]["n_fft"]
    n = np.arange(p["length"])
    zc = np.exp(-1j * np.pi * p["root"] * n * (n + 1) / p["length"])
    return unit_power(np.fft.ifft(np.fft.ifftshift(allocate(n_fft, centered(p["length"]), zc))))
