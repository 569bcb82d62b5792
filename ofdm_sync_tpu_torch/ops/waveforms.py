"""Preamble / OFDM symbol construction used by the Minn-RTL and [A][A]
receive chains (port of the NumPy builders of `ofdm_sync_tpu.ops.waveforms`).

Stimulus is built on the host in NumPy float64 with the reference's exact
RNG call order, so a seed gives the same frames as the JAX package and the
reference scripts.  `ofdm_fft_used` runs on the tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ofdm_sync_tpu_torch.params import SYS_30M72, SYS_AA_10M, SystemParams


# ---------------------------------------------------------------------------
# Subcarrier plumbing (reference core.py:13-47)
# ---------------------------------------------------------------------------

def centered_subcarrier_indices(width: int, spacing: int = 1) -> np.ndarray:
    """Symmetric subcarrier indices around DC, skipping bin 0."""
    half = width // 2
    idx = np.concatenate((np.arange(-half, 0), np.arange(1, half + 1)))
    return idx * spacing if spacing != 1 else idx


def allocate_subcarriers(n_fft: int, indices: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Place values into a centered spectrum via ``(dc + idx) % n_fft``."""
    if indices.shape[0] != values.shape[0]:
        raise ValueError("Subcarrier index and value arrays must have the same length.")
    spectrum = np.zeros(n_fft, dtype=np.complex128)
    spectrum[(n_fft // 2 + indices) % n_fft] = values
    return spectrum


def spectrum_to_time_domain(spectrum: np.ndarray, normalize: bool = True) -> np.ndarray:
    """Centered spectrum -> unit-power time waveform (ifft of ifftshift)."""
    td = np.fft.ifft(np.fft.ifftshift(spectrum))
    if normalize:
        power = np.mean(np.abs(td) ** 2)
        if power > 0:
            td = td / np.sqrt(power)
    return td


def add_cyclic_prefix(symbol: np.ndarray, cp_len: int) -> np.ndarray:
    if cp_len <= 0:
        return symbol
    return np.concatenate((symbol[-cp_len:], symbol))


def papr_db(x: np.ndarray) -> float:
    """Peak-to-average power ratio in dB (reference sync_aa.py:230-233)."""
    p = np.abs(x) ** 2
    return float(10 * np.log10(np.max(p) / np.mean(p)))


# ---------------------------------------------------------------------------
# Random constellations (reference core.py:145-168)
# ---------------------------------------------------------------------------

def _qpsk_values(rng: np.random.Generator, size: int) -> np.ndarray:
    """QPSK draw matching reference core.py:145-150 exactly."""
    m = rng.integers(0, 4, size=size)
    re = (m & 1) * 2 - 1
    im = ((m >> 1) & 1) * 2 - 1
    return ((re + 1j * im) / np.sqrt(2.0)).astype(np.complex128)


def build_random_qpsk_symbol(
    rng: np.random.Generator, sys: SystemParams = SYS_30M72, include_cp: bool = True
) -> tuple[np.ndarray, np.ndarray]:
    """Full-band QPSK pilot/data symbol; returns (time_domain, used_values)."""
    idx = centered_subcarrier_indices(sys.num_active)
    vals = _qpsk_values(rng, idx.shape[0])
    symbol = spectrum_to_time_domain(allocate_subcarriers(sys.n_fft, idx, vals))
    if include_cp:
        symbol = add_cyclic_prefix(symbol, sys.cp_len)
    return symbol, vals


def ofdm_fft_used(symbol_time_no_cp: torch.Tensor, sys: SystemParams = SYS_30M72) -> torch.Tensor:
    """FFT a CP-stripped OFDM symbol and take the centered used bins
    (reference core.py:171-176), on the tensor's device."""
    spectrum = torch.fft.fftshift(torch.fft.fft(symbol_time_no_cp, n=sys.n_fft))
    idx = (sys.n_fft // 2 + centered_subcarrier_indices(sys.num_active)) % sys.n_fft
    return spectrum[torch.as_tensor(idx, device=spectrum.device)]


# ---------------------------------------------------------------------------
# Minn-RTL 5-segment preamble family (reference minn_rtl.py:231-429)
# ---------------------------------------------------------------------------

def generate_zadoff_chu(root: int, length: int, even_form: bool = False) -> np.ndarray:
    """Zadoff-Chu sequence; ``even_form`` uses n^2 for even lengths."""
    n = np.arange(length)
    if even_form and length % 2 == 0:
        return np.exp(-1j * np.pi * root * n * n / length)
    return np.exp(-1j * np.pi * root * n * (n + 1) / length)


def generate_base_sequence(
    seq_type: str,
    length: int,
    rng: np.random.Generator | None = None,
    sys: SystemParams = SYS_30M72,
) -> np.ndarray:
    """Unit-power base sequence A of the 5-segment Minn-RTL preamble."""
    Q = length
    if seq_type in ("bpsk_freq", "qpsk_freq", "zc_freq"):
        all_idx = centered_subcarrier_indices(sys.num_active)
        quarter_idx = all_idx[(all_idx % 4) == 0]
        if seq_type == "bpsk_freq":
            if rng is None:
                raise ValueError("rng required for bpsk_freq")
            vals = rng.choice([-1.0, 1.0], size=quarter_idx.shape[0])
        elif seq_type == "qpsk_freq":
            if rng is None:
                raise ValueError("rng required for qpsk_freq")
            phases = rng.choice([0, 1, 2, 3], size=quarter_idx.shape[0])
            vals = np.exp(1j * np.pi / 4 * (2 * phases + 1))
        else:
            k = np.arange(quarter_idx.shape[0])
            vals = np.exp(-1j * np.pi * 7 * k * k / quarter_idx.shape[0])
        td = np.fft.ifft(np.fft.ifftshift(allocate_subcarriers(sys.n_fft, quarter_idx, vals)))
        A = td[:Q]
    elif seq_type == "zc_time":
        A = generate_zadoff_chu(7, Q, even_form=True)
    elif seq_type == "chirp":
        n = np.arange(Q)
        A = np.exp(1j * np.pi * n * n / Q)
    elif seq_type == "gold":
        bits = np.zeros(Q, dtype=int)
        state1, state2 = 0b1010101010, 0b1100110011
        for i in range(Q):
            bits[i] = ((state1 >> 9) & 1) ^ ((state2 >> 9) & 1)
            state1 = ((state1 << 1) | ((state1 >> 9) ^ (state1 >> 6)) & 1) & 0x3FF
            state2 = (
                (state2 << 1)
                | ((state2 >> 9) ^ (state2 >> 8) ^ (state2 >> 5) ^ (state2 >> 3)) & 1
            ) & 0x3FF
        A = 2.0 * bits - 1.0 + 0j
    elif seq_type == "const":
        A = np.ones(Q, dtype=complex)
    elif seq_type == "random_phase":
        if rng is None:
            raise ValueError("rng required for random_phase")
        A = np.exp(1j * rng.uniform(0, 2 * np.pi, Q))
    else:
        raise ValueError(f"Unknown sequence type: {seq_type}")
    power = np.mean(np.abs(A) ** 2)
    return A / np.sqrt(power) if power > 0 else A


def build_minn_rtl_preamble(
    seq_type: str = "qpsk_freq",
    rng: np.random.Generator | None = None,
    Q: int | None = None,
    sys: SystemParams = SYS_30M72,
) -> np.ndarray:
    """5-segment preamble ``[-A | +A | +A | -A | -A]`` of length 5Q."""
    if Q is None:
        Q = sys.n_fft // 4
    A = generate_base_sequence(seq_type, Q, rng, sys)
    preamble = np.concatenate([-A, +A, +A, -A, -A])
    power = np.mean(np.abs(preamble) ** 2)
    return preamble / np.sqrt(power) if power > 0 else preamble


def assemble_frame(*symbols: np.ndarray, pre_pad: int = 0, post_pad: int = 0) -> np.ndarray:
    """Concatenate symbols with optional zero guards."""
    parts = []
    if pre_pad > 0:
        parts.append(np.zeros(pre_pad, dtype=complex))
    parts.extend(symbols)
    if post_pad > 0:
        parts.append(np.zeros(post_pad, dtype=complex))
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# [A][A] preamble of the 10 MHz AA system (reference sync_aa.py:160-257)
# ---------------------------------------------------------------------------

AA_PREAMBLE_LENGTHS = (1024, 512, 256)


def build_aa_preamble(
    total_length: int = 1024, sys: SystemParams = SYS_AA_10M
) -> tuple[np.ndarray, np.ndarray, float]:
    """[A][A] preamble: ZC on every Kth FFT bin inside the active band,
    K = 2N / total.  Returns (time preamble, frequency sequence, PAPR dB)."""
    if total_length not in AA_PREAMBLE_LENGTHS:
        raise ValueError(f"total_length must be one of {AA_PREAMBLE_LENGTHS}")
    K = 2 * sys.n_fft // total_length
    dc_bin = sys.n_fft // 2
    half_active = sys.num_active // 2
    used_bins = np.array([
        dc_bin + off for off in range(-half_active, half_active + 1)
        if off != 0 and (dc_bin + off) % K == 0
    ])
    num_sc = len(used_bins)
    root = 25 if num_sc % 25 != 0 else 23
    n = np.arange(num_sc)
    zc_seq = np.exp(-1j * np.pi * root * n * (n + 1) / num_sc)
    spectrum = np.zeros(sys.n_fft, dtype=complex)
    spectrum[used_bins] = zc_seq
    preamble = (np.fft.ifft(spectrum) * np.sqrt(sys.n_fft))[:total_length]
    preamble = preamble / np.sqrt(np.mean(np.abs(preamble) ** 2))
    return preamble, zc_seq, papr_db(preamble)


def build_aa_qpsk_symbol(
    rng: np.random.Generator, sys: SystemParams = SYS_AA_10M
) -> tuple[np.ndarray, np.ndarray]:
    """Random QPSK pilot/data symbol of the AA system with its CP; returns
    (time_domain, used_values) (reference sync_aa.py:238-257)."""
    idx = centered_subcarrier_indices(sys.num_active)
    phases = rng.integers(0, 4, size=len(idx))
    qpsk = np.exp(1j * np.pi / 4 * (2 * phases + 1)) / np.sqrt(2)
    symbol = np.fft.ifft(np.fft.ifftshift(allocate_subcarriers(sys.n_fft, idx, qpsk)))
    symbol = symbol * np.sqrt(sys.n_fft)
    symbol = symbol / np.sqrt(np.mean(np.abs(symbol) ** 2))
    return np.concatenate([symbol[-sys.cp_len:], symbol]), qpsk
