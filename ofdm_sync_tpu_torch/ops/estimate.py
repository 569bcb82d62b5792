"""CP-based CFO (four variants), LS channel estimate, equalization, EVM,
the residual timing from the pilot's phase slope and the CIR rebuilt from
an LS estimate (port of `ofdm_sync_tpu.ops.estimate`; reference
core.py:179-469, minn.py:208-219).  Complex64 tensors, on their own device.

The reference's per-offset loops over CP correlations all reduce to one
primitive, `cp_correlation_profile`: the branch-summed lag-N product and a
windowed sum, computed once for every offset."""

from __future__ import annotations

import math

import torch

from ofdm_sync_tpu_torch.ops.waveforms import centered_subcarrier_indices
from ofdm_sync_tpu_torch.ops.windows import sliding_sum_valid

_EPS = 1e-12


def _as2d(x: torch.Tensor) -> torch.Tensor:
    return x.unsqueeze(0) if x.ndim == 1 else x


def cp_correlation_profile(rx: torch.Tensor, n_fft: int, win: int) -> torch.Tensor:
    """``P(d) = sum_b sum_{n<win} rx[b, d+n] conj(rx[b, d+n_fft+n])`` for
    every d (reference core.py:190-193 at all offsets at once)."""
    x = _as2d(rx)
    return sliding_sum_valid((x[:, :-n_fft] * x[:, n_fft:].conj()).sum(dim=0), win)


def cfo_from_P(P: torch.Tensor, n_fft: int, fs_hz: float) -> torch.Tensor:
    """``cfo = -angle(P) * fs / (2 pi N)`` (reference core.py:194-196)."""
    return -torch.angle(P) * fs_hz / (2 * math.pi * n_fft)


def estimate_cfo_from_cp(rx: torch.Tensor, start: int, n_fft: int, cp_len: int,
                         fs_hz: float) -> torch.Tensor:
    """Single-window CP CFO estimate (reference core.py:179-196).  Each
    window's start is clamped into the stream, as JAX's `dynamic_slice`
    clamps it."""
    x = _as2d(rx)

    def window(at: int) -> torch.Tensor:
        at = min(max(at, 0), max(x.shape[1] - cp_len, 0))
        return x[:, at: at + cp_len]

    a, b = window(start), window(start + n_fft)
    return cfo_from_P((a * b.conj()).sum(), n_fft, fs_hz)


def cfo_from_cp_windows(win: torch.Tensor, n_fft: int, cp_len: int,
                        fs_hz: float) -> torch.Tensor:
    """The CP CFO of windows that each start at their CP (reference
    core.py:179-196): ``win (branches, ..., >= n_fft + cp_len)`` complex ->
    ``(...)``, the lag-N products of the CP summed over the CP and the
    branches."""
    P = (win[..., :cp_len] * win[..., n_fft: n_fft + cp_len].conj()).sum(dim=(0, -1))
    return cfo_from_P(P, n_fft, fs_hz)


def _span_bounds(L: int, cp_start_est: int, n_fft: int, win: int, span: int):
    """[d_lo, d_hi) search bounds; d_hi is exclusive and capped at
    L - (n_fft + win), so the last valid offset is never searched: the
    reference's own loop bound (reference core.py:221-226, 331-333), which
    parity depends on."""
    return max(0, cp_start_est - span), min(L - (n_fft + win), cp_start_est + span)


def estimate_cfo_from_cp_robust(rx: torch.Tensor, cp_start_est: int, n_fft: int,
                                cp_len: int, fs_hz: float, span: int | None = None,
                                win_len: int | None = None) -> torch.Tensor:
    """P(d) with a short window, summed over d in +-span around the
    estimate (reference core.py:199-231)."""
    x = _as2d(rx)
    span = cp_len // 2 if span is None else int(max(0, span))
    win = cp_len // 2 if win_len is None else int(max(1, win_len))
    d_lo, d_hi = _span_bounds(x.shape[1], cp_start_est, n_fft, win, span)
    if d_hi <= d_lo:
        return estimate_cfo_from_cp(x, cp_start_est, n_fft, min(cp_len, win), fs_hz)
    P = cp_correlation_profile(x, n_fft, win)
    return cfo_from_P(P[d_lo:d_hi].sum(), n_fft, fs_hz)


def estimate_cfo_from_cp_peak_with_index(rx: torch.Tensor, cp_start_est: int, n_fft: int,
                                         cp_len: int, fs_hz: float,
                                         span: int | None = None):
    """The CP offset maximizing |P(d)| within +-span of the estimate;
    returns (cfo, best offset) (reference core.py:271-303)."""
    x = _as2d(rx)
    span = cp_len // 2 if span is None else int(max(0, span))
    d_lo, d_hi = _span_bounds(x.shape[1], cp_start_est, n_fft, cp_len, span)
    if d_hi <= d_lo:
        return (estimate_cfo_from_cp(x, cp_start_est, n_fft, cp_len, fs_hz),
                torch.tensor(cp_start_est, device=x.device))
    P = cp_correlation_profile(x, n_fft, cp_len)[d_lo:d_hi]
    best = torch.argmax(P.abs())
    return cfo_from_P(P[best], n_fft, fs_hz), d_lo + best


def estimate_cfo_from_cp_peak(rx: torch.Tensor, cp_start_est: int, n_fft: int, cp_len: int,
                              fs_hz: float, span: int | None = None) -> torch.Tensor:
    """`estimate_cfo_from_cp_peak_with_index` without the index (reference
    core.py:234-268)."""
    return estimate_cfo_from_cp_peak_with_index(rx, cp_start_est, n_fft, cp_len, fs_hz,
                                                span)[0]


def find_cp_start_via_corr(rx: torch.Tensor, est_start: int, n_fft: int, cp_len: int,
                           search_half: int = 1024) -> int:
    """Refine the CP start to the offset maximizing |P(d)| within
    +-search_half (reference core.py:306-336)."""
    x = _as2d(rx)
    lo = max(0, est_start - search_half)
    hi = min(x.shape[1] - (n_fft + cp_len), est_start + search_half)
    if hi <= lo:
        return est_start
    P = cp_correlation_profile(x, n_fft, cp_len)[lo:hi]
    return int(lo + torch.argmax(P.abs()))


def ls_channel_estimate(y_used: torch.Tensor, x_used: torch.Tensor,
                        eps: float = 1e-9) -> torch.Tensor:
    return y_used / (x_used + eps)


def equalize(y_used: torch.Tensor, h_est: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return y_used / (h_est + eps)


def align_complex_gain(x: torch.Tensor, ref: torch.Tensor, eps: float = _EPS):
    """LS complex gain g minimizing ||g x - ref||^2 along the last axis
    (reference core.py:357-362), one g per row of a batch; returns (g * x,
    g)."""
    g = torch.linalg.vecdot(x, ref) / (torch.linalg.vecdot(x, x) + eps)
    return x * g.unsqueeze(-1), g


def remove_common_phase(x: torch.Tensor, ref: torch.Tensor | None = None):
    """De-rotate by the common phase error (reference core.py:348-354);
    returns (x rotated, the phase)."""
    if ref is None:
        cpe = torch.angle(x.mean())
    else:
        cpe = torch.angle(torch.vdot(ref, x) / (torch.vdot(ref, ref) + _EPS))
    return x * torch.exp(-1j * cpe), cpe


def evm_rms_db(x: torch.Tensor, ref: torch.Tensor):
    """(evm_rms, evm_db) along the last axis, one a row of a batch,
    normalized to the reference RMS."""
    err = x - ref
    evm_rms = torch.sqrt((err.abs() ** 2).mean(dim=-1) / (ref.abs() ** 2).mean(dim=-1))
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


def reconstruct_cir_from_ls(h_used: torch.Tensor, n_fft: int, num_active: int) -> torch.Tensor:
    """A time-domain CIR from a per-subcarrier LS estimate (reference
    minn.py:208-219): the used bins placed in a centered spectrum, then an
    inverse FFT; complex64 on the estimate's device."""
    idx = (n_fft // 2 + centered_subcarrier_indices(num_active)) % n_fft
    spectrum = torch.zeros(n_fft, dtype=torch.complex64, device=h_used.device)
    spectrum[torch.as_tensor(idx, device=h_used.device)] = h_used.to(torch.complex64)
    return torch.fft.ifft(torch.fft.ifftshift(spectrum))
