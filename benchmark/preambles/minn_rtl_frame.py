"""Preamble kind ``minn_rtl_frame``: the whole Minn-RTL frame of the
upstream link simulation (minn_rtl.py:884-889), [preamble | pilot | data]:
the ``minn_rtl`` preamble [-A, +A, +A, -A, -A] (5Q samples), then a pilot
and a data symbol, each QPSK on the ``num_active`` centered subcarriers
(bin 0 skipped) of an N-point symbol, scaled to unit power and led by its
CP (core.py:145-176).  Both symbols are drawn from
``default_rng(symbols_seed)``, pilot first, as upstream's
``build_random_qpsk_symbol`` draws them: m = integers(0, 4), re = 2 (m & 1)
- 1, im = 2 ((m >> 1) & 1) - 1, over sqrt(2)."""

from __future__ import annotations

import numpy as np

from benchmark.preambles import allocate, centered, minn_rtl, unit_power


def _qpsk_symbol(rng: np.random.Generator, n_fft: int, num_active: int, cp_len: int):
    """(time samples with the CP, the used values) of one QPSK symbol."""
    m = rng.integers(0, 4, size=num_active)
    values = (((m & 1) * 2 - 1) + 1j * (((m >> 1) & 1) * 2 - 1)) / np.sqrt(2.0)
    td = unit_power(np.fft.ifft(np.fft.ifftshift(allocate(n_fft, centered(num_active), values))))
    return np.concatenate([td[n_fft - cp_len:], td]), values


def _parts(config: dict):
    sys = config["system"]
    rng = np.random.default_rng(config["preamble"]["symbols_seed"])
    return [_qpsk_symbol(rng, sys["n_fft"], sys["num_active"], sys["cp_len"]) for _ in range(2)]


def symbols(config: dict) -> tuple[np.ndarray, np.ndarray]:
    """The used values (complex128, ``num_active``) of the pilot and the
    data symbol, which the receiver knows."""
    (_, pilot), (_, data) = _parts(config)
    return pilot, data


def template(config: dict) -> np.ndarray:
    (pilot, _), (data, _) = _parts(config)
    return np.concatenate([minn_rtl.template(config), pilot, data])
