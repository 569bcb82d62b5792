"""CP-based CFO, LS channel estimate, equalization, EVM and the residual
timing from the pilot's phase slope (port of the parts of
`ofdm_sync_tpu.ops.estimate` the ported receive chains use; reference
core.py:179-370, 443-469).  Complex64 tensors, on their own device."""

from __future__ import annotations

import math

import torch

from ofdm_sync_tpu_torch.ops.waveforms import centered_subcarrier_indices

_EPS = 1e-12


def _as2d(x: torch.Tensor) -> torch.Tensor:
    return x.unsqueeze(0) if x.ndim == 1 else x


def cfo_from_P(P: torch.Tensor, n_fft: int, fs_hz: float) -> torch.Tensor:
    """``cfo = -angle(P) * fs / (2 pi N)`` (reference core.py:194-196)."""
    return -torch.angle(P) * fs_hz / (2 * math.pi * n_fft)


def estimate_cfo_from_cp(rx: torch.Tensor, start: int, n_fft: int, cp_len: int,
                         fs_hz: float) -> torch.Tensor:
    """Single-window CP CFO estimate (reference core.py:179-196)."""
    x = _as2d(rx)
    a = x[:, start: start + cp_len]
    b = x[:, start + n_fft: start + n_fft + cp_len]
    return cfo_from_P((a * b.conj()).sum(), n_fft, fs_hz)


def ls_channel_estimate(y_used: torch.Tensor, x_used: torch.Tensor,
                        eps: float = 1e-9) -> torch.Tensor:
    return y_used / (x_used + eps)


def equalize(y_used: torch.Tensor, h_est: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return y_used / (h_est + eps)


def align_complex_gain(x: torch.Tensor, ref: torch.Tensor, eps: float = _EPS):
    """LS complex gain g minimizing ||g x - ref||^2 (reference core.py:357-362);
    returns (g * x, g)."""
    g = torch.vdot(x, ref) / (torch.vdot(x, x) + eps)
    return x * g, g


def evm_rms_db(x: torch.Tensor, ref: torch.Tensor):
    """(evm_rms, evm_db), normalized to the reference RMS."""
    err = x - ref
    evm_rms = torch.sqrt((err.abs() ** 2).mean() / (ref.abs() ** 2).mean())
    return evm_rms, 20 * torch.log10(evm_rms + _EPS)


def unwrap(phase: torch.Tensor) -> torch.Tensor:
    """`numpy.unwrap` along the last axis (discontinuity pi, period 2 pi)."""
    dd = phase.diff(dim=-1)
    ddmod = torch.remainder(dd + math.pi, 2 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0), math.pi, ddmod)
    correct = torch.where(dd.abs() < math.pi, 0.0, ddmod - dd)
    return torch.cat([phase[..., :1], phase[..., 1:] + correct.cumsum(dim=-1)], dim=-1)


def estimate_timing_offset_from_phase_slope(h_used: torch.Tensor, n_fft: int,
                                            num_active: int):
    """Linear fit of the unwrapped angle(H(k)) over the used subcarriers
    (reference core.py:443-469); returns (slope rad/bin, timing offset
    ``-slope N / (2 pi)`` in samples), float32 tensors."""
    k = torch.as_tensor(centered_subcarrier_indices(num_active), dtype=torch.float32,
                        device=h_used.device)
    phi = unwrap(torch.angle(h_used))
    k0 = k - k.mean()
    phi0 = phi - phi.mean()
    slope = (k0 * phi0).sum() / ((k0 * k0).sum() + _EPS)
    return slope, -slope * n_fft / (2.0 * math.pi)
