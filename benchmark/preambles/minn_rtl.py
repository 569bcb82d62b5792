"""Preamble kind ``minn_rtl``: [-A, +A, +A, -A, -A] with the qpsk_freq
base sequence A: QPSK on every fourth active subcarrier (phases from
``default_rng(seq_seed)``), the first Q samples of its IFFT
(minn_rtl.py:829-844)."""

from __future__ import annotations

import numpy as np

from benchmark.preambles import allocate, centered, unit_power


def template(config: dict) -> np.ndarray:
    quarter_len = config["detector"]["quarter_len"]
    n_fft, num_active = config["system"]["n_fft"], config["system"]["num_active"]
    rng = np.random.default_rng(config["preamble"]["seq_seed"])
    active = centered(num_active)
    quarter = active[active % 4 == 0]
    phases = rng.choice([0, 1, 2, 3], size=quarter.shape[0])
    values = np.exp(1j * np.pi / 4 * (2 * phases + 1))
    A = unit_power(np.fft.ifft(np.fft.ifftshift(allocate(n_fft, quarter, values)))[:quarter_len])
    return unit_power(np.concatenate([-A, A, A, -A, -A]))
