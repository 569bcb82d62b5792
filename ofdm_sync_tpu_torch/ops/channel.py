"""Channel emulation: measured-CIR FIR, AWGN, CFO (port of the parts of
`ofdm_sync_tpu.ops.channel` the Minn-RTL receive chain uses).

The FIR and CFO run in PyTorch on the signal's device; the noise comes
from the host NumPy Generator with the reference's exact draw order, so a
seed gives the same noise as the JAX package.
"""

from __future__ import annotations

import math
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

import ofdm_sync_tpu

#: the measured CIR bank is shared with the JAX package, read in place
_DATA_DIR = Path(ofdm_sync_tpu.__file__).resolve().parent / "data"

@lru_cache(maxsize=None)
def load_measured_cir(name: str) -> np.ndarray:
    """The (n_rx, taps) complex CIR bank of a measured profile."""
    path = _DATA_DIR / "channels.npz"
    if not path.exists():
        raise FileNotFoundError(f"{path} missing")
    with np.load(path) as z:
        if name not in z:
            raise ValueError(f"Unknown channel profile '{name}'")
        return z[name]


def compute_channel_peak_offset(cir) -> int:
    """Strongest-path index of an (n_rx, taps) CIR (reference core.py:113-120)."""
    if cir is None:
        return 0
    agg = np.sum(np.abs(np.asarray(cir)) ** 2, axis=0)
    return int(np.argmax(agg)) if np.any(agg) else 0


def _next_fast_len(n: int) -> int:
    return 1 << (n - 1).bit_length()


def fft_convolve_full(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Full linear convolution along the last axis via one FFT;
    ``x`` (..., L) with ``taps`` (..., T) -> (..., L+T-1)."""
    L, T = x.shape[-1], taps.shape[-1]
    n = _next_fast_len(L + T - 1)
    X = torch.fft.fft(x, n=n, dim=-1)
    H = torch.fft.fft(taps, n=n, dim=-1)
    return torch.fft.ifft(X * H, dim=-1)[..., : L + T - 1]


def apply_cir(signal, cir, device=None) -> torch.Tensor:
    """Convolve a 1-D signal with an (n_rx, taps) CIR bank -> (n_rx, L+T-1)
    complex64 on ``device``."""
    sig = torch.as_tensor(np.asarray(signal), device=device).to(torch.complex64)[None, :]
    taps = torch.as_tensor(np.asarray(cir), device=device).to(torch.complex64)
    return fft_convolve_full(sig, taps)


def awgn_noise_host(signal: np.ndarray, snr_db: float, rng: np.random.Generator) -> np.ndarray:
    """Complex AWGN drawn from the host Generator in the reference's order
    (real then imag over the full shape; reference channel.py:51-77)."""
    signal = np.asarray(signal)
    snr_linear = 10 ** (snr_db / 10)
    if signal.ndim == 1:
        p = np.mean(np.abs(signal) ** 2)
        if p == 0:
            # consumes no draws, unlike an all-zero row of a 2-D input: both
            # mirror the reference's draw order exactly
            return np.zeros_like(signal)
        std = np.sqrt(p / snr_linear / 2)
        return std * (rng.standard_normal(signal.shape) + 1j * rng.standard_normal(signal.shape))
    if signal.ndim != 2:
        raise ValueError("Signal must be 1D or 2D array")
    p = np.mean(np.abs(signal) ** 2, axis=1, keepdims=True)
    std = np.sqrt(p / snr_linear / 2)
    noise = std * (rng.standard_normal(signal.shape) + 1j * rng.standard_normal(signal.shape))
    noise[p.squeeze(axis=1) == 0] = 0
    return noise


def apply_channel(signal: np.ndarray, snr_db: float, rng: np.random.Generator,
                  cir: np.ndarray | None = None, device=None) -> np.ndarray:
    """Optional measured-CIR FIR (on ``device``) then host AWGN; returns
    (branches, L) complex128 on the host."""
    signal = np.asarray(signal)
    if cir is None:
        faded = signal[np.newaxis, :]
    else:
        cir = np.asarray(cir)
        if cir.ndim == 1:
            cir = cir[np.newaxis, :]
        faded = apply_cir(signal, cir, device).cpu().numpy()
    return faded + awgn_noise_host(faded, snr_db, rng)


def apply_cfo(samples: torch.Tensor, cfo_hz: float, fs_hz: float) -> torch.Tensor:
    """Multiply by ``exp(j 2 pi f n / fs)``, the same tone on every branch.

    The sample index is split into 12-bit digits whose phase coefficients
    are reduced mod 2*pi in float64 on the host, so the float32 phase stays
    accurate (~1e-3 rad) for any stream length; a float32 ``arange`` would
    collapse past 2^24 samples."""
    x = samples
    L = x.shape[-1]
    if L == 0:
        return x
    two_pi = 2.0 * math.pi
    a = two_pi * float(cfo_hz) / float(fs_hz)
    idx = torch.arange(L, dtype=torch.int32, device=x.device)
    ph = torch.zeros(L, dtype=torch.float32, device=x.device)
    two_pi_f = torch.tensor(two_pi, dtype=torch.float32, device=x.device)
    for shift in range(0, max(int(L - 1).bit_length(), 1), 12):
        digit = ((idx >> shift) & 0xFFF).to(torch.float32)
        c = torch.tensor(math.fmod(a * float(1 << shift), two_pi), dtype=torch.float32,
                         device=x.device)
        ph = ph + torch.remainder(digit * c, two_pi_f)
    tone = torch.complex(torch.cos(ph), torch.sin(ph))
    return x * tone
