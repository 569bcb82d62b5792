"""Channel emulation: measured-CIR FIR, AWGN, CFO, 12-bit ADC (port of the
parts of `ofdm_sync_tpu.ops.channel` the Minn-RTL and [A][A] receive chains
use).

The FIR, CFO and ADC run in PyTorch on the signal's device.  Noise comes
from the host NumPy Generator with the reference's exact draw order, so a
seed gives the same noise as the JAX package; the batched grid sweep draws
its noise from an explicit `torch.Generator` instead (`awgn_noise_device`).
"""

from __future__ import annotations

import math
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

#: the port's copy of the measured CIR bank (byte for byte the JAX package's)
_DATA_DIR = Path(__file__).resolve().parent.parent / "data"

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


def parse_cir_csv(path: Path) -> np.ndarray:
    """Parse a raw CIR CSV (columns: delay, then (real, imag) per RX
    channel) into an (n_rx, taps) complex array: NaN taps dropped per
    channel, each zero-padded to the longest (reference channel.py:15-48)."""
    data = np.genfromtxt(path, delimiter=",", skip_header=1)
    if data.ndim == 1:
        data = data[np.newaxis, :]
    cirs = []
    for chan in range((data.shape[1] - 1) // 2):
        real, imag = data[:, 1 + 2 * chan], data[:, 2 + 2 * chan]
        mask = np.isfinite(real) & np.isfinite(imag)
        cirs.append((real[mask] + 1j * imag[mask]).astype(np.complex128))
    if not cirs:
        raise ValueError(f"'{path}' contains no CIR taps")
    out = np.zeros((len(cirs), max(c.shape[0] for c in cirs)), dtype=np.complex128)
    for i, c in enumerate(cirs):
        out[i, : c.shape[0]] = c
    return out


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


def fft_convolve_full_ols(x: torch.Tensor, taps: torch.Tensor, block: int = 16384) -> torch.Tensor:
    """Overlap-save full convolution: batched ``block``-point FFTs in place
    of one monolithic (L+T-1)-point transform, the same output up to float
    rounding.  ``taps`` must be 1-D (the matched-filter case); the
    monolithic form takes per-branch banks."""
    if taps.ndim != 1:
        raise ValueError("overlap-save form expects 1-D taps")
    L, T = x.shape[-1], taps.shape[-1]
    if block < 2 * T:
        raise ValueError(f"block {block} too small for {T} taps")
    lead = x.shape[:-1]
    step = block - T + 1
    n_out = L + T - 1
    nblk = -(-n_out // step)
    pad = torch.nn.functional.pad(x.reshape(-1, L), (T - 1, nblk * step - L))
    idx = (torch.arange(nblk, device=x.device)[:, None] * step
           + torch.arange(block, device=x.device)[None, :])
    Y = torch.fft.ifft(torch.fft.fft(pad[:, idx], dim=-1) * torch.fft.fft(taps, n=block), dim=-1)
    y = Y[..., T - 1:].reshape(-1, nblk * step)[:, :n_out]
    return y.reshape(*lead, n_out)


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


def apply_channel_multi_antenna(
    tx: np.ndarray,
    snr_db: float,
    rng: np.random.Generator,
    channel_name: str | None = None,
    num_rx_antennas: int = 2,
    device=None,
) -> tuple[np.ndarray, np.ndarray | None, int]:
    """Per-antenna measured CIR (FIR on ``device``) and per-antenna
    independent host noise, drawn real then imag per antenna (reference
    sync_aa.py:577-634).  Returns (rx (antennas, L) on the host, cir or
    None, channel peak offset)."""
    if channel_name is None:
        p = np.mean(np.abs(tx) ** 2)
        std = np.sqrt(p / (10 ** (snr_db / 10)) / 2)
        rx = np.zeros((num_rx_antennas, len(tx)), dtype=complex)
        for ant in range(num_rx_antennas):
            rx[ant] = tx + std * (
                rng.standard_normal(len(tx)) + 1j * rng.standard_normal(len(tx)))
        return rx, None, 0
    cir_bank = load_measured_cir(channel_name)
    if cir_bank.shape[0] >= num_rx_antennas:
        cir = cir_bank[:num_rx_antennas].copy()
    else:
        cir = np.tile(cir_bank, (num_rx_antennas // cir_bank.shape[0] + 1, 1))[
            :num_rx_antennas]
    faded = apply_cir(tx, cir, device).cpu().numpy()  # complex64, as the JAX FIR
    rx = np.zeros_like(faded)
    for ant in range(num_rx_antennas):
        p = np.mean(np.abs(faded[ant]) ** 2)
        std = np.sqrt(p / (10 ** (snr_db / 10)) / 2)
        rx[ant] = faded[ant] + std * (
            rng.standard_normal(faded.shape[1]) + 1j * rng.standard_normal(faded.shape[1]))
    return rx, cir, compute_channel_peak_offset(cir)


def awgn_noise_device(signal: torch.Tensor, snr_db, generator: torch.Generator) -> torch.Tensor:
    """Complex64 AWGN with per-branch power matching, drawn from an explicit
    ``torch.Generator`` (real plane, then imag plane) on the generator's
    device and moved to the signal's device, so one seed gives the same
    noise on any device.  signal: complex (branches, L) or (L,); snr_db: a
    float or a tensor of shape (...), which gives noise of shape
    (..., branches, L) -- one draw per SNR config.  The JAX package draws
    from `jax.random` keys instead: the two agree in distribution only."""
    x = signal if signal.ndim >= 2 else signal.unsqueeze(0)
    snr = torch.as_tensor(snr_db, dtype=torch.float32, device=x.device)
    snr = snr.reshape(snr.shape + (1, 1))
    p = (x.abs() ** 2).mean(dim=-1, keepdim=True)
    std = torch.sqrt(p / 10.0 ** (snr / 10.0) / 2)   # (..., branches, 1)
    shape = std.shape[:-1] + x.shape[-1:]
    nr = torch.randn(shape, generator=generator, device=generator.device)
    ni = torch.randn(shape, generator=generator, device=generator.device)
    noise = std * torch.complex(nr, ni).to(x.device)
    noise = torch.where(p > 0, noise, torch.zeros((), dtype=noise.dtype, device=x.device))
    return noise if signal.ndim >= 2 else noise[..., 0, :]


def apply_cfo(samples: torch.Tensor, cfo_hz: float, fs_hz: float) -> torch.Tensor:
    """Multiply by ``exp(j 2 pi f n / fs)``, the same tone on every branch.

    The sample index is split into 12-bit digits whose phase coefficients
    are reduced mod 2*pi in float64, so the float32 phase stays accurate
    (~1e-3 rad) for any stream length; a float32 ``arange`` would collapse
    past 2^24 samples."""
    x = samples
    L = x.shape[-1]
    if L == 0:
        return x
    cfo = torch.as_tensor(cfo_hz, dtype=torch.float64, device=x.device)
    return x * cfo_tone(torch.arange(L, dtype=torch.int32, device=x.device), L, cfo, fs_hz)


def cfo_tone(idx: torch.Tensor, span: int, cfo_hz: torch.Tensor, fs_hz: float) -> torch.Tensor:
    """``exp(j 2 pi f n / fs)`` at the sample indices ``idx`` (int32 (n,),
    every index below ``span``), complex64 on idx's device, by `apply_cfo`'s
    digit split.  ``cfo_hz``: a float tensor of CFOs (shape S, 0-d for one),
    which gives an (S..., n) tone and reads nothing back to the host: each
    CFO's digit coefficients are reduced in float64 on its device."""
    two_pi = 2.0 * math.pi
    dev = idx.device
    a = (cfo_hz.to(torch.float64) * two_pi / float(fs_hz)).unsqueeze(-1)
    ph = torch.zeros(tuple(cfo_hz.shape) + (idx.shape[-1],), dtype=torch.float32, device=dev)
    two_pi_f = torch.full((), two_pi, dtype=torch.float32, device=dev)
    for shift in range(0, max(int(span - 1).bit_length(), 1), 12):
        digit = ((idx >> shift) & 0xFFF).to(torch.float32)
        coef = torch.fmod(a * float(1 << shift), two_pi).to(torch.float32)
        ph = ph + torch.remainder(digit * coef, two_pi_f)
    return torch.complex(torch.cos(ph), torch.sin(ph))


def quantize_adc(samples: torch.Tensor, full_scale, bits: int = 12) -> torch.Tensor:
    """Mid-tread signed quantizer with clipping, I and Q independently
    (reference sync_aa.py:263-315).  ``full_scale``: a float, or a tensor
    that broadcasts against ``samples``."""
    levels = 2 ** (bits - 1)

    def q(v):
        v = (v / full_scale).clamp(-1.0, 1.0 - 1.0 / levels)
        return torch.round(v * levels) / levels * full_scale

    return torch.complex(q(samples.real), q(samples.imag))


def compute_clipping_stats(samples: np.ndarray, full_scale: float, bits: int = 12) -> dict:
    """Clip fractions + effective bits, on the host (reference
    sync_aa.py:294-315)."""
    samples = np.asarray(samples)
    real_hit = np.abs(samples.real) >= full_scale
    imag_hit = np.abs(samples.imag) >= full_scale
    signal_rms = np.sqrt(np.mean(np.abs(samples) ** 2))
    effective_bits = bits + np.log2(signal_rms / full_scale) if full_scale > 0 else 0
    return {
        "real_clip_pct": 100 * (np.sum(real_hit) / samples.size),
        "imag_clip_pct": 100 * (np.sum(imag_hit) / samples.size),
        "total_clip_pct": 100 * (np.sum(real_hit | imag_hit) / samples.size),
        "effective_bits": max(0, effective_bits),
        "signal_rms": signal_rms,
        "full_scale": full_scale,
    }


def quantize_int(samples: np.ndarray, width: int) -> tuple[np.ndarray, np.ndarray, float]:
    """Auto-scaled integer quantization of the RTL testbench (reference
    ref/test_minn_preamble_detector.py:150-161), on the host: the largest
    magnitude maps to 2^(width-1) - 2.  Returns (int32 I, int32 Q, scale)."""
    min_val = -(1 << (width - 1))
    max_val = (1 << (width - 1)) - 1
    max_mag = np.max(np.abs(samples))
    scale = 1.0 if max_mag == 0 else (max_val - 1) / max_mag
    scaled = samples * scale
    re = np.clip(np.round(scaled.real), min_val, max_val).astype(np.int32)
    im = np.clip(np.round(scaled.imag), min_val, max_val).astype(np.int32)
    return re, im, scale
